"""Cells that BENCHMARK.json leaves out for now (PERF.md §7), added to its
manifest for the tests, so that their configuration, driver, reference and
check stay tested on the CPU until a benchmark adds them."""

import json
import os

from portbench import harness

CONFIGS = [
    {"name": "ncc-b64-mono13",
     "source": "https://github.com/aconz2/font-ocr README.md:44-58 (ncc -t 13 --x-bits 2, default thresholds)",
     "file": "portbench/configs/ncc-b64-mono13.json", "reduced": [],
     "why": "the ncc binary on the same pages: 296 needles in two size groups, K1, K2, K3, collect and post"},
]
WORKLOADS = [
    {"name": "ncc-b64-mono13.doc64", "config": "ncc-b64-mono13", "traffic": "doc64", "chips": 1,
     "why": "64 dense pages a call, eight waves of 8 in the three-stage pipeline"},
    {"name": "ncc-b64-mono13.sparse64", "config": "ncc-b64-mono13", "traffic": "sparse64", "chips": 1,
     "why": "64 pages a call, 6 of 48 lines inked"},
]


def manifest() -> dict:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"] += CONFIGS
    m["workloads"] += WORKLOADS
    return m


def load_cell(name: str):
    return harness.load_cell(name, manifest())
