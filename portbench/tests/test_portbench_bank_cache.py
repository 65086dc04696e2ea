"""The reader of focr's bank cache counters: the share of crop heights read
from their raw copies, 100 in a traced CPU run of each focr cell (its
warm-up call writes the copies), and nothing where the program has no such
counters."""

import importlib
import json
import os
from types import SimpleNamespace

import pytest

from portbench import harness

READER = "focr_bank_cache_hit_pct"
SMALL = {"focr-b64-mono13.doc64": {"pages_per_call": 2, "pool_pages": 4},
         "focr-b64-mono13.page1": {"pool_pages": 2}}


def _read(*counters):
    ctx = SimpleNamespace(trace=None, calls=[{"doc": [0], "metrics": {"counters": c}}
                                             for c in counters])
    return importlib.import_module(f"portbench.metrics.{READER}").read(ctx)


def test_the_share_of_hits_over_the_traced_calls():
    assert _read({"bank_cache_hits": 2, "bank_cache_misses": 0},
                 {"bank_cache_hits": 1, "bank_cache_misses": 1}) == pytest.approx(75.0)
    assert _read({"bank_cache_hits": 0, "bank_cache_misses": 2}) == 0.0
    assert _read({"bank_cache_hits": 0, "bank_cache_misses": 0}) is None
    # a program that predates the counters
    assert _read({"bank_bytes_loaded": 5}) is None
    assert _read({"bank_cache_hits": 2, "bank_cache_misses": 0}, {}) is None


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_traced_run_reads_every_height_from_the_cache(name, tmp_path, monkeypatch):
    monkeypatch.setenv("FOCR_TPU_CACHE_DIR", str(tmp_path / "banks"))
    monkeypatch.delenv("FOCR_TPU_NO_BANK_CACHE", raising=False)
    cell = harness.load_cell(name)
    cell.traffic = {**cell.traffic, **SMALL[name]}
    res = harness.run_cell(cell, 2**31 + 13, 0.5, True, "cpu", log=lambda m: None)
    assert res["correct"] is True
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        entry = next(m for m in json.load(f)["per_layer"] if m["name"] == READER)
    assert name in entry["workloads"]
    assert res["metrics"][READER] == {"value": 100.0, "unit": "%"}
