"""The ncc-b64-mono13 configuration and its cell: the manifest's entries, a
short run of the harness on the CPU (the kernels' plain versions, a small
traffic) that is correct and whose span and counter readers read values,
the readers on a program that predates them, and K2's yardstick on the
canonical wave."""

import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness
from portbench.lib import roofline as R
from portbench.lib.ncc_compact_roofline import group_rows, k2_work, mask_shape
from portbench.lib.trace import Event

CELL = "ncc-b64-mono13.doc64"
SMALL = {"pages_per_call": 2, "pool_pages": 3, "inked": {"always": [0, 1], "random": 0}}
KERNEL_READERS = ["k1_sweep_roofline", "k3_replay_roofline", "k2_compact_roofline"]
HOST_READERS = ["ncc_dispatch_ms_per_page", "ncc_collect_ms_per_page",
                "ncc_page_read_ms_per_page", "ncc_bank_load_ms_per_call",
                "ncc_matcher_build_ms_per_call", "ncc_post_ms_per_page"]
LAYERS = {"k1_sweep_roofline": "K1 NCC sweep", "k3_replay_roofline": "K3 exact replay",
          "ncc_dispatch_ms_per_page": "ncc wave pipeline",
          "ncc_collect_ms_per_page": "ncc wave pipeline",
          "ncc_page_read_ms_per_page": "ncc bank load, page reads and CLI",
          "ncc_bank_load_ms_per_call": "ncc bank load, page reads and CLI",
          "ncc_matcher_build_ms_per_call": "ncc bank load, page reads and CLI",
          "ncc_post_ms_per_page": "ncc post", "k2_compact_roofline": "K2 compaction"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_cell_and_its_configuration(manifest):
    entry = next(c for c in manifest["configs"] if c["name"] == "ncc-b64-mono13")
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/ncc-b64-mono13.json"
    assert [w["name"] for w in manifest["workloads"] if w["config"] == "ncc-b64-mono13"] == [CELL]
    wl = next(w for w in manifest["workloads"] if w["name"] == CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("ncc-b64-mono13", "doc64", 1)
    cell = harness.load_cell(CELL, manifest)
    assert {m["name"] for m in cell.end_to_end} == {"pages_per_s", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == list(LAYERS)
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "pages_per_s"
        assert m["layer"] == LAYERS[m["name"]]
        assert m["source"] == ("device_trace" if m["name"] in KERNEL_READERS else
                               "program_counter" if m["name"] == "ncc_post_ms_per_page" else
                               "program_span")
    cfg = cell.config
    assert (cfg["tool"], cfg["reference"], cfg["reduced"]) == ("ncc", "ncc", [])
    assert cfg["needles"]["count"] == 296 and cell.traffic["inked"] == "all"


@pytest.mark.parametrize("trace", [False, True])
def test_a_short_cpu_run_is_correct(trace):
    cell = harness.load_cell(CELL)
    cell.traffic = {**cell.traffic, **SMALL}
    res = harness.run_cell(cell, 2**31 + 29, 0.3, trace, "cpu", log=lambda m: None)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["checks"]) == {"calls_wrong", "lines_wrong", "calls_failed", "hits_wrong"}
    if trace:
        # a CPU run has no device time: the kernels' rooflines find nothing to read
        assert set(res["metrics"]) == set(HOST_READERS)
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert set(res["metrics"]) == {"pages_per_s", "setup_s"}


def test_the_readers_find_nothing_without_the_programs_spans():
    """A program that predates the spans and counters: no ncc span, no
    counters in --metrics-json, no kernel in the trace; every reader gives
    None and none raises."""
    trace = SimpleNamespace(spans=[Event("portbench_call", 0.0, 1e5, "user_annotation")],
                            t0=0.0, t1=1e5, kernels=lambda pattern: [],
                            span_seconds=lambda name: 0.0)
    ctx = SimpleNamespace(trace=trace, cell=harness.load_cell(CELL),
                          calls=[{"doc": [0, 1], "metrics": {"search_seconds": 0.1}}])
    for r in LAYERS:
        assert importlib.import_module(f"portbench.metrics.{r}").read(ctx) is None, r


def test_k2_bound_on_the_canonical_wave():
    """The kernel table's K2 bound (PERF.md §6) on the fixture's first 8
    pages, crop 766 x 626: 0.00062 ms/page from the rows and candidates of
    K1's own mask (its plain version), 0.00060 from the plain reference's
    hits, which the reader counts."""
    assert mask_shape(766, 626, 13, 8) == (754, 20)
    groups = [(74, 8), (222, 9)]
    k1 = {8: (27371, 57501), 9: (80995, 171081)}
    ref = {8: (25596, 54978), 9: (75214, 162895)}
    for counts, want in ((k1, 0.00062), (ref, 0.00060)):
        ms = sum(R.bound_ms(*k2_work(8, 766, 626, T, 13, nw, *counts[nw]))[0]
                 for T, nw in groups) / 8
        assert round(ms, 5) == want
    assert R.bound_ms(*k2_work(8, 766, 626, 74, 13, 8, *k1[8]))[1] == "bytes"


def test_group_rows_counts_distinct_needle_rows():
    hits = (np.array([3, 3, 3, 5, 9]), np.array([1, 4, 2, 1, 1]), np.array([7, 7, 8, 7, 7]),
            np.ones(5, np.float32))
    assert group_rows(hits, [3, 5]) == (3, 4)
    assert group_rows(hits, [1]) == (0, 0)


def test_the_k2_reader_counts_the_traced_calls_work():
    """Two calls of 10 pages: waves of 8 and 2, each a count and an emit
    launch a size group, at the rows and hits the reference's records give."""
    cell = harness.load_cell(CELL)
    from portbench.reference.ncc import NeedleFile

    groups = NeedleFile(cell.bank).groups
    ids = {nw: g for (_, nw), g in groups.items()}
    pool = np.full((10, 792, 662), 255, np.uint8)
    pool[:, 100:110, 200:300] = 0
    stats = {}
    for i in range(10):
        nid = np.array([ids[8][0], ids[8][0], ids[9][1], ids[9][2]])
        stats[i] = {"hits": (nid, np.arange(4), np.array([120, 121, 120, 120 + i % 2]),
                             np.ones(4, np.float32))}
    kernels = [Event(f"{name}(int*)", 10.0 * k, 4.0, "kernel")
               for k, name in enumerate(["focr_ncc_count_kernel", "focr_ncc_emit_kernel"] * 8)]
    trace = SimpleNamespace(kernels=lambda pattern: [e for e in kernels if pattern in e.name])
    ctx = SimpleNamespace(cell=cell, trace=trace, ref_stats=stats, pool=pool,
                          calls=[{"doc": np.arange(10)}, {"doc": np.arange(10)[::-1]}])
    got = importlib.import_module("portbench.metrics.k2_compact_roofline").read(ctx)
    want = 0.0
    for doc in (list(range(10)), list(range(9, -1, -1))):
        for s, B, Hc, Wc in R.ncc_waves(pool[doc], list(groups)):
            for (nh, nw), g in groups.items():
                rows = sum(group_rows(stats[i]["hits"], g)[0] for i in doc[s : s + B])
                cands = sum(group_rows(stats[i]["hits"], g)[1] for i in doc[s : s + B])
                want += R.bound_ms(*k2_work(B, Hc, Wc, len(g), nh, nw, rows, cands))[0]
    assert want > 0
    assert got == pytest.approx(100 * want / (16 * 4.0 / 1e3))
