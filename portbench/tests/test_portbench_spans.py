"""The readers of the program's focr spans and counters, in a traced run of
the harness on the CPU (the kernels' plain versions, a small traffic): each
reads a value in every cell its entry lists, and nothing in a trace without
the program's spans."""

import json
import os

import pytest

from portbench import harness
from portbench.lib import spans as S

SMALL = {"focr-b64-mono13.doc64": {"pages_per_call": 2, "pool_pages": 4},
         "focr-b64-mono13.page1": {"pool_pages": 2}}
READERS = ["focr_bank_load_ms_per_call", "focr_decoder_build_ms_per_call",
           "focr_page_read_ms_per_page", "focr_bucket_ms_per_page", "focr_crop_ms_per_page",
           "focr_upload_ms_per_page", "focr_fetch_wait_ms_per_page",
           "focr_assemble_ms_per_page", "focr_upload_gb_per_s", "focr_bank_load_mb_per_s"]


def _traced(name, monkeypatch):
    """A traced CPU run of ``name``, with the Trace it read kept."""
    from portbench.lib import trace as T

    kept = []

    class Keeping(T.Trace):
        def __init__(self, path):
            super().__init__(path)
            kept.append(self)

    monkeypatch.setattr(T, "Trace", Keeping)
    cell = harness.load_cell(name)
    cell.traffic = {**cell.traffic, **SMALL[name]}
    res = harness.run_cell(cell, 2**31 + 11, 0.5, True, "cpu", log=lambda m: None)
    return cell, res, kept[-1]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_every_focr_span_reader_reads_a_value(name, monkeypatch):
    cell, res, trace = _traced(name, monkeypatch)
    assert res["correct"] is True
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    listed = [r for r in READERS if name in entries[r]["workloads"]]
    assert listed == [r for r in READERS if r != "focr_bucket_ms_per_page"
                      or name.endswith(".doc64")]
    for r in listed:
        assert res["metrics"][r]["value"] > 0, r
        assert res["metrics"][r]["unit"] == entries[r]["unit"]
    # the call's stages hold most of it: what the card waits on has a name
    top = ("focr_bank_open", "focr_page_read", "focr_decoder_build", "focr_bucket", "focr_crop",
           "focr_upload", "focr_launch", "focr_fetch", "focr_assemble", "focr_print")
    calls = [s for s in trace.spans if s.name == "portbench_call"]
    inner = S.seconds(trace, *top)
    assert 0.5 * sum(c.dur for c in calls) / 1e6 < inner < sum(c.dur for c in calls) / 1e6


def test_the_readers_find_nothing_without_the_programs_spans():
    """A program that predates the spans and counters: every reader gives
    None and none raises."""
    import importlib
    from types import SimpleNamespace

    from portbench.lib.trace import Event

    trace = SimpleNamespace(spans=[Event("portbench_call", 0.0, 1e5, "user_annotation")],
                            t0=0.0, t1=1e5)
    ctx = SimpleNamespace(trace=trace, calls=[{"doc": [0, 1], "metrics": {"decode_seconds": 0.1}}])
    for r in READERS:
        assert importlib.import_module(f"portbench.metrics.{r}").read(ctx) is None, r


def test_self_time_leaves_out_the_spans_inside():
    from types import SimpleNamespace

    from portbench.lib.trace import Event

    spans = [Event("focr_decoder_build", 10.0, 100.0), Event("focr_bank_height_load", 20.0, 30.0),
             Event("focr_bank_height_load", 60.0, 20.0), Event("inner", 65.0, 5.0)]
    trace = SimpleNamespace(spans=spans, t0=0.0, t1=1e3)
    assert S.self_seconds(trace, "focr_decoder_build") == pytest.approx(50e-6)
    assert S.seconds(trace, "focr_bank_height_load") == pytest.approx(50e-6)
