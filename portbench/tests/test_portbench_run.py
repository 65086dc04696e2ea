"""A run of the harness on the CPU (the kernels' plain versions, a small
traffic), past the look for a chip: the result's form, and `correct` coming
out false when the timed path is broken underneath."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
import portbench_cells

SMALL = {
    "focr-b64-mono13.doc64": {"pages_per_call": 2, "pool_pages": 4},
    "ncc-b64-mono13.sparse64": {"pages_per_call": 2, "pool_pages": 2,
                                "inked": {"always": [0, 1], "random": 0}},
}
TOP = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, seconds=0.5, trace=False, seed=2**31 + 3):
    cell = portbench_cells.load_cell(name)
    cell.traffic = {**cell.traffic, **SMALL[name]}
    return cell, harness.run_cell(cell, seed, seconds, trace, "cpu", log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
def test_result_form(trace):
    cell, res = _run("focr-b64-mono13.doc64", trace=trace)
    assert list(res) == TOP + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    # a CPU run has no device time: the kernel's roofline finds nothing to read
    assert set(res["metrics"]) <= names and all(
        set(v) == {"value", "unit"} for v in res["metrics"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == names
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


def _half_of_the_pages(main):
    def broken(argv):
        i = argv.index("-i")
        j = next(k for k in range(i + 1, len(argv)) if argv[k].startswith("-"))
        keep = argv[i + 1 : j][: max(1, (j - i - 1) // 2)]
        return main(argv[: i + 1] + keep + argv[j:])
    return broken


def _stale(main):
    first = {}

    def broken(argv):
        if "out" not in first:
            import contextlib
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(argv)
            first["out"] = buf.getvalue()
            sys.stdout.write(first["out"])
            return rc
        sys.stdout.write(first["out"])  # the state it was given, unchanged
        return 0
    return broken


def _altered(name, monkeypatch):
    if name.startswith("focr"):
        from focr_tpu_torch.models import focr

        assemble = focr.GridDecoder._assemble

        def broken(self, *a):
            out = assemble(self, *a)
            ln = out[0][0]
            out[0][0] = type(ln)(text=("A" if ln.text[0] != "A" else "B") + ln.text[1:], y=ln.y)
            return out
        monkeypatch.setattr(focr.GridDecoder, "_assemble", broken)
    else:
        from focr_tpu_torch.models import post

        text = post.process_hits_text

        def broken(*a):
            out = text(*a)
            return [("A" if out[0][:1] != "A" else "B") + out[0][1:]] + out[1:] if out else out
        monkeypatch.setattr(post, "process_hits_text", broken)


@pytest.mark.parametrize("fault", ["half_of_the_batch", "stale_answer", "altered_answer"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from portbench.drivers import focr, ncc

    driver = focr if name.startswith("focr") else ncc
    if fault == "half_of_the_batch":
        monkeypatch.setattr(driver, "main", _half_of_the_pages(driver.main))
    elif fault == "stale_answer":
        monkeypatch.setattr(driver, "main", _stale(driver.main))
    else:
        _altered(name, monkeypatch)
    _, res = _run(name, seconds=0.3)
    assert res["correct"] is False
    assert res["checks"]["calls_wrong"]["value"] > 0


def test_a_lower_precision_underneath_is_not_correct(monkeypatch):
    """ncc's similarities rounded through float16 before post-processing: the
    text may not move, the recorded hits do."""
    import numpy as np

    from focr_tpu_torch.models import ncc

    make = ncc.NccMatcher._make_struct

    def broken(self, parts):
        hs = make(self, parts)
        return type(hs)(needle_id=hs.needle_id, x=hs.x, y=hs.y,
                        sim=hs.sim.astype(np.float16).astype(np.float32), matcher=hs.matcher)
    monkeypatch.setattr(ncc.NccMatcher, "_make_struct", broken)
    _, res = _run("ncc-b64-mono13.sparse64", seconds=0.3)
    assert res["correct"] is False
    assert res["checks"]["hits_wrong"]["value"] > 0


def test_a_sound_run_compares_the_recorded_hits():
    _, res = _run("ncc-b64-mono13.sparse64", seconds=0.3, seed=2**31 + 5)
    assert res["correct"] is True and res["checks"]["hits_wrong"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("name,variant", [(n, "guarantee") for n in sorted(SMALL)]
                         + [("ncc-b64-mono13.sparse64", "precision")])
def test_the_control_is_not_correct(name, variant):
    from portbench.control import control_checks

    cell = portbench_cells.load_cell(name)
    cell.traffic = {**cell.traffic, **SMALL[name]}
    for seed in (1, 2, 3):
        checks = control_checks(cell, seed, 2, variant, "cpu")
        assert any(c["value"] > c["limit"] for c in checks.values())
        if variant == "precision":
            assert checks["hits_wrong"]["value"] > 0


def test_run_exits_without_a_card_and_prints_nothing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "focr-b64-mono13.doc64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_a_trace_that_drops_kernels_gives_no_result(monkeypatch):
    from portbench.drivers import focr

    ticks = iter(range(10**6))
    monkeypatch.setattr(focr, "launches", lambda: {k: next(ticks) for k in focr.KERNELS})
    with pytest.raises(RuntimeError, match="held every kernel"):
        _run("focr-b64-mono13.doc64", trace=True)
