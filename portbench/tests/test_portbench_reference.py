"""The plain references against the lines the fixtures hold, and the
yardstick's bounds on the canonical shapes (PERF.md's kernel table)."""

import json

import numpy as np
import pytest

from portbench import harness
from portbench.lib import roofline as R
from portbench.reference import focr_grid, ncc
import portbench_cells


def _fixture(name):
    cell = portbench_cells.load_cell(name)
    with np.load(cell.bank) as z:
        return cell, z["pages"], json.loads(str(z["lines"]))


def test_focr_reference_decodes_the_fixture_pages():
    cell, pages, golden = _fixture("focr-b64-mono13.doc64")
    got, _ = focr_grid.expected_lines(pages, cell.bank, cell.config)
    assert got == [[text for text, _ in page] for page in golden]


def test_ncc_reference_decodes_the_golden_pages():
    cell, pages, golden = _fixture("ncc-b64-mono13.doc64")
    got, stats = ncc.expected_lines(pages[: len(golden)], cell.bank, cell.config, "cpu")
    assert got == golden
    # the hits K3 has to replay: ~27k a page (PERF.md §4), none capped
    for st in stats:
        hits = sum(g["hits"] for g in st["groups"])
        assert 26000 < hits < 28500 and all(g["hits"] == g["kept"] for g in st["groups"])


@pytest.mark.parametrize("variant", ["guarantee"])
@pytest.mark.parametrize("name", ["focr-b64-mono13.doc64", "ncc-b64-mono13.doc64"])
def test_the_control_changes_the_lines(name, variant):
    cell, pages, golden = _fixture(name)
    n = len(golden)
    ref = cell.reference
    want, _ = ref.expected_lines(pages[:n], cell.bank, cell.config, "cpu")
    got, _ = ref.expected_lines(pages[:n], cell.bank, cell.config, "cpu", variant=variant)
    assert all(g != w for g, w in zip(got, want))


def test_bounds_on_the_canonical_shapes():
    # K1: the canonical ncc wave (the fixture's first 8 pages), both size groups
    with np.load(portbench_cells.load_cell("ncc-b64-mono13.doc64").bank) as z:
        wave = z["pages"][:8]
    groups = [(74, 13, 8), (222, 13, 9)]
    crop = R.ink_crop(wave, [(nh, nw) for _, nh, nw in groups])
    assert crop == (766, 626)
    k1 = sum(R.bound_ms(*R.k1_work(8, *crop, T, nh, nw))[0] for T, nh, nw in groups) / 8
    assert round(k1, 4) == 0.0159
    # K3: 27 234 hits a page, split between the groups as on the golden pages
    hits = {8: 6912, 9: 20322}
    k3 = sum(R.bound_ms(*R.k3_work(8, *crop, T, nh, nw, 8 * hits[nw], 8 * hits[nw]))[0]
             for T, nh, nw in groups) / 8
    assert round(k3, 5) == 0.00042
    # K4: a batch of 16 pages, 50 rows of height 12 and one of 3, 78 cells x 67 glyphs
    k4 = sum(R.bound_ms(*R.k4_work(16, rows, h, 608, 78, 67, 9))[0]
             for rows, h in ((50, 12), (1, 3))) / 16
    assert round(k4, 5) == 0.00013
    assert R.bound_ms(1, 0) == (1 / R.INT8_OPS_PER_S * 1e3, "operations")
    assert R.bound_ms(0, 1)[1] == "bytes"


def test_a_white_wave_has_no_crop():
    assert R.ink_crop(np.full((2, 100, 80), 255, np.uint8), [(13, 8)]) is None
