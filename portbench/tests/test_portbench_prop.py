"""The focr-prop-sans13 configuration and its cell: the manifest's entries,
a short run of the harness on the CPU (K5's plain version, a small traffic)
that is correct and whose prop span readers read values, the controls that
are not, and K5's yardstick on the canonical shapes."""

import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness
from portbench.lib import roofline as R
from portbench.lib.prop_roofline import k5_work
from portbench.lib.trace import Event
from portbench.reference.focr_prop import PropBankFile

CELL = "focr-prop-sans13.doc64"
SMALL = {"pages_per_call": 2, "pool_pages": 4}
READERS = ["focr_prop_strips_ms_per_page", "focr_prop_fetch_wait_ms_per_page",
           "focr_prop_text_ms_per_page", "focr_prop_upload_gb_per_s"]


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _cell():
    cell = harness.load_cell(CELL)
    cell.traffic = {**cell.traffic, **SMALL}
    return cell


def test_the_cell_and_its_configuration(manifest):
    entry = next(c for c in manifest["configs"] if c["name"] == "focr-prop-sans13")
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/focr-prop-sans13.json"
    wl = next(w for w in manifest["workloads"] if w["name"] == CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("focr-prop-sans13", "doc64", 1)
    cell = harness.load_cell(CELL, manifest)
    assert {m["name"] for m in cell.end_to_end} == {"pages_per_s", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["k5_prop_roofline"] + READERS
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "pages_per_s"
        assert m["layer"] == ("K5 prop scan" if m["name"] == "k5_prop_roofline"
                              else "focr prop decoder")
    cfg = cell.config
    assert (cfg["tool"], cfg["reference"], cfg["reduced"], cfg["glyphs"]) == (
        "focr_prop", "focr_prop", [], len(cfg["alphabet"]))
    assert cfg["argv"][cfg["argv"].index("-a") + 1] == cfg["alphabet"]
    # the frozen copy is the fixture it names, byte for byte
    import hashlib

    with open(cell.bank, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == cfg["data_copy"]["sha256"]
    bank = PropBankFile(cell.bank)
    assert bank.alphabet == cfg["alphabet"] and bank.n_steps(12, 608) == 170


@pytest.mark.parametrize("trace", [False, True])
def test_a_short_cpu_run_is_correct(trace):
    cell = _cell()
    res = harness.run_cell(cell, 2**31 + 23, 0.3, trace, "cpu", log=lambda m: None)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] == 0 for c in res["checks"].values())
    if trace:
        # a CPU run has no device time: K5's roofline finds nothing to read
        assert set(res["metrics"]) == set(READERS)
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert set(res["metrics"]) == {"pages_per_s", "setup_s"}


@pytest.mark.parametrize("variant", ["guarantee", "precision"])
def test_the_control_is_not_correct(variant):
    from portbench.control import control_checks

    cell = _cell()
    for seed in (1, 2, 3):
        checks = control_checks(cell, seed, 2, variant, "cpu")
        assert checks["calls_wrong"]["value"] > 0 and checks["lines_wrong"]["value"] > 0


def test_k5_bound_on_the_canonical_shapes():
    """The kernel table's bound (PERF.md §6): a 16-page batch of the prop
    corpus with every row scanned, 800 of crop height 12 and 16 of 3; and
    the cell's batch, its 768 inked lines alone."""
    bank = PropBankFile(harness.load_cell(CELL).bank)
    steps = 85 * 800  # the steps hardly matter: the bytes bound it
    table = sum(R.bound_ms(*k5_work(L, h, 608, 67, 19, bank.n_steps(h, 608), steps))[0]
                for L, h in ((800, 12), (16, 3))) / 16
    assert round(table, 5) == 0.00015
    ops, nbytes = k5_work(768, 12, 608, 67, 19, 170, 768 * 85)
    assert R.bound_ms(ops, nbytes)[1] == "bytes"
    assert round(R.bound_ms(ops, nbytes)[0] / 16, 5) == 0.00013


def test_the_roofline_reader_counts_the_traced_calls_work():
    """Two calls of 20 pages: batches of 16 and 4, each a launch on its
    pages' rows of height 12, at the steps the reference's records give."""
    cell = harness.load_cell(CELL)
    rows = {i: {"rows": [[39 + 15 * r, 12, 80 + i] for r in range(48)]} for i in range(20)}
    kernels = [Event("focr_prop_scan_kernel(unsigned char const*, int)", 10.0 * k, 5.0, "kernel")
               for k in range(4)]
    trace = SimpleNamespace(kernels=lambda pattern: [e for e in kernels
                                                     if pattern in e.name])
    ctx = SimpleNamespace(cell=cell, trace=trace, ref_stats=rows,
                          pool=np.zeros((20, 792, 662), np.uint8),
                          calls=[{"doc": np.arange(20)}, {"doc": np.arange(20)[::-1]}])
    got = importlib.import_module("portbench.metrics.k5_prop_roofline").read(ctx)
    want = 0.0
    for doc in (range(20), range(19, -1, -1)):
        doc = list(doc)
        for s in (0, 16):
            part = doc[s : s + 16]
            steps = sum(48 * (80 + i) for i in part)
            want += R.bound_ms(*k5_work(48 * len(part), 12, 608, 67, 19, 170, steps))[0]
    assert got == pytest.approx(100 * want / (4 * 5.0 / 1e3))


def test_the_readers_find_nothing_without_the_programs_spans():
    """The parent's program: no prop spans, and strip_bytes_uploaded 0 on
    this path; no K5 kernel in a trace: every reader gives None."""
    trace = SimpleNamespace(spans=[Event("portbench_call", 0.0, 1e5, "user_annotation")],
                            t0=0.0, t1=1e5, kernels=lambda pattern: [])
    ctx = SimpleNamespace(trace=trace, cell=harness.load_cell(CELL),
                          calls=[{"doc": [0, 1], "metrics": {"counters": {
                              "strip_bytes_uploaded": 0}}}])
    for r in ["k5_prop_roofline"] + READERS:
        assert importlib.import_module(f"portbench.metrics.{r}").read(ctx) is None, r
