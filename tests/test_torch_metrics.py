"""focr_tpu_torch's utils/metrics.py against focr_tpu's: write_metrics byte
for byte, MetricsRun, and metrics_run's torch.profiler trace (CPU activity
here; CUDA activity is asked for only when the run's device is a card)."""

import json
import os

import pytest
import torch

from focr_tpu.utils import metrics as jmetrics
from focr_tpu_torch.utils import metrics as tmetrics

FIELD_SETS = [
    dict(tool="focr", pages=2, decoded_pages=1, lines=3,
         errors=[{"page": "bad.png", "error": "ValueError: x"}], decode_seconds=0.25,
         pages_per_sec=4.0),
    dict(tool="ncc", pages=1, decoded_pages=1, lines=0, hits=0, errors=[],
         search_seconds=1e-9, engine="device"),
    dict(b=1, a=[3, 2, 1], z=None, unicode="é→", nested={"y": 1, "x": 2}),
    dict(),
]


@pytest.mark.parametrize("fields", FIELD_SETS, ids=["focr", "ncc", "sorted", "empty"])
def test_write_metrics_file_bytes_equal_focr_tpus(fields, tmp_path):
    jmetrics.write_metrics(str(tmp_path / "j.json"), **fields)
    tmetrics.write_metrics(str(tmp_path / "t.json"), **fields)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "t.json").read_text()) == fields


@pytest.mark.parametrize("fields", FIELD_SETS, ids=["focr", "ncc", "sorted", "empty"])
def test_write_metrics_dash_goes_to_stderr(fields, capsys):
    jmetrics.write_metrics("-", **fields)
    want = capsys.readouterr()
    tmetrics.write_metrics("-", **fields)
    got = capsys.readouterr()
    assert got.out == want.out == ""  # stdout stays data-only
    assert got.err == want.err and json.loads(got.err) == fields


def test_metrics_run_times_the_region():
    with tmetrics.metrics_run() as run:
        assert run.seconds == 0.0
        torch.arange(10).sum()
    assert run.seconds > 0.0
    # focr_tpu's never-written ``extra`` is left out
    assert set(vars(run)) == {"seconds"} < set(vars(jmetrics.MetricsRun()))


def test_metrics_run_keeps_the_time_when_the_region_raises():
    with pytest.raises(KeyError):
        with tmetrics.metrics_run() as run:
            raise KeyError("x")
    assert run.seconds > 0.0


@pytest.mark.parametrize("existing", [True, False], ids=["dir-exists", "dir-made"])
def test_metrics_run_writes_a_chrome_trace(existing, tmp_path):
    d = tmp_path / "trace"
    if existing:
        d.mkdir()
    with tmetrics.metrics_run(str(d)) as run:
        with torch.profiler.record_function("focr_test_span"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert run.seconds > 0.0
    assert os.listdir(d) == [tmetrics.TRACE_NAME]
    events = json.loads((d / tmetrics.TRACE_NAME).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "focr_test_span" in names and any("mm" in (n or "") for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)  # no card, no CUDA activity


def test_metrics_run_without_a_dir_traces_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with tmetrics.metrics_run(None):
        torch.zeros(2)
    assert os.listdir(tmp_path) == []


def test_span_records_nothing_without_a_profiler(tmp_path):
    """With no profiler running a span is the one shared null context: no
    record_function is entered, so a trace started later holds nothing of
    it."""
    a, b = tmetrics.span("focr_test_early"), tmetrics.span("focr_test_other")
    assert a is b and not isinstance(a, torch.profiler.record_function)
    with a:
        torch.zeros(2)
    with tmetrics.profiling(str(tmp_path)):
        torch.zeros(2)
    events = json.loads((tmp_path / tmetrics.TRACE_NAME).read_text())["traceEvents"]
    assert not any(e.get("cat") == "user_annotation" for e in events)


def test_span_records_on_a_worker_thread_started_before_the_profiler(tmp_path):
    """The guard's flag reads True on a thread that was running before the
    trace began (the C-level one does not), so its spans are recorded; a
    torch that drops the module flag records every span and still passes,
    one whose flag stays False on such a thread fails here."""
    import threading

    go = threading.Event()
    seen = {}

    def worker():
        go.wait()
        seen["span"] = tmetrics.span("focr_test_worker")
        with seen["span"]:
            torch.ones(8).sum()

    t = threading.Thread(target=worker)
    t.start()
    try:
        with tmetrics.profiling(str(tmp_path)):
            with tmetrics.span("focr_test_main"):
                torch.ones(8).sum()
            go.set()
            t.join(timeout=60)
    finally:
        go.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert isinstance(seen["span"], torch.profiler.record_function)
    events = json.loads((tmp_path / tmetrics.TRACE_NAME).read_text())["traceEvents"]
    spans = {e["name"]: e["tid"] for e in events if e.get("cat") == "user_annotation"}
    assert set(spans) == {"focr_test_main", "focr_test_worker"}
    assert spans["focr_test_main"] != spans["focr_test_worker"]


def test_counters_add_from_threads_and_reset():
    """More threads than cores, switching as often as the interpreter can:
    a lost update would show in the sum."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    tmetrics.reset_counters("a", "b")
    assert tmetrics.COUNTERS == {"a": 0, "b": 0}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(32) as ex:
            list(ex.map(lambda i: [tmetrics.count("a", i) for _ in range(1000)], range(32)))
    finally:
        sys.setswitchinterval(interval)
    tmetrics.count("c", 5)
    assert tmetrics.COUNTERS == {"a": 1000 * sum(range(32)), "b": 0, "c": 5}
    tmetrics.reset_counters()
    assert tmetrics.COUNTERS == {}


def test_new_modules_import_without_jax_or_focr_tpu():
    """utils/cache.py, utils/metrics.py and io/overlays.py import where jax
    cannot be imported, and none of them imports focr_tpu."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import focr_tpu_torch.utils.cache, focr_tpu_torch.utils.metrics\n"
        "import focr_tpu_torch.io.overlays, focr_tpu_torch.cli.focr, focr_tpu_torch.cli.ncc\n"
        "bad = [m for m in sys.modules if m == 'focr_tpu' or m.startswith('focr_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
