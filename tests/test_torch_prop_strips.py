"""The proportional decoder's strip assembly (models/focr.py::inked_strips:
a strided view of each row group's strips on the pages, the ink test on the
un-inverted pixels, one gather of the inked strips, inverted in place) held
against the formula it replaced, written out here: invert the batch, stack
every row's strip, keep the strips whose maximum is above 0. The inked
indices and strips byte for byte, and the whole decode_batch on the CPU (K5's
plain version), on grids that reach the view's edges."""

import json
import os

import numpy as np
import pytest
import torch

from focr_tpu_torch.cli.focr import main as torch_main
from focr_tpu_torch.fonts.bank import load_grid_bank
from focr_tpu_torch.models import focr as tfocr
from focr_tpu_torch.models import focr_prop as tprop
from focr_tpu_torch.models.types import DecodeOptions, RenderOptions
from focr_tpu_torch.utils.metrics import COUNTERS, reset_counters
from portbench.lib.pages import write_pool

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_prop_golden.npz")
with open(os.path.join(REPO, "portbench", "configs", "focr-prop-sans13.json")) as f:
    CONFIG = json.load(f)
GRID = CONFIG["grid"]  # x 45, y 39, width 608, line height 12, advance 15
X0, CW = GRID["x"], GRID["width"]
ROWS = 7  # grid rows a test page keeps: fast on K5's plain version


@pytest.fixture(scope="module")
def fixture():
    banks, _ = load_grid_bank(FIXTURE)
    with np.load(FIXTURE) as z:
        pages = z["pages"]
    return banks, pages


def _dopts(advance=GRID["line_advance"]):
    return DecodeOptions(x_start=X0, y_start=GRID["y"], width=CW,
                         line_height=GRID["line_height"], line_advance=advance)


def _white(B, H, W=662):
    return np.full((B, H, W), 255, np.uint8)


def _case(name, source):
    """(pages, decode options) of each case, from the fixture's renders."""
    top = GRID["y"] + ROWS * GRID["line_advance"]  # the kept rows end here, full height
    if name == "last-row":  # one pixel a shade off white on a strip's last row
        pages = _white(2, top)
        pages[1, GRID["y"] + 2 * GRID["line_advance"] + GRID["line_height"] - 1, X0 + 300] = 254
        return pages, _dopts()
    if name in ("left-of-x0", "right-of-crop"):  # a black column just outside the crop
        pages = _white(2, top)
        pages[:, :, X0 - 1 if name == "left-of-x0" else X0 + CW] = 0
        return pages, _dopts()
    if name == "partial-bottom":  # the last row 5 px high, holding its line's top
        return source[:2, : top + 5].copy(), _dopts()
    if name == "overlap":  # advance 8 < line height 12: each pixel in two strips
        return source[:2, :top].copy(), _dopts(advance=8)
    if name == "narrow":  # 400 px wide: crop_w clamped to 355
        return source[:2, :top, :400].copy(), _dopts()
    if name == "batch-1":
        return source[3:4, :top].copy(), _dopts()
    if name == "all-white":
        return _white(3, top), _dopts()
    raise AssertionError(name)


CASES = ["last-row", "left-of-x0", "right-of-crop", "partial-bottom", "overlap", "narrow",
         "batch-1", "all-white"]


def _old_strips(pages, grp, x0, crop_w):
    """The replaced formula: the batch inverted, every row stacked, max > 0."""
    inv = np.subtract(255, pages, dtype=np.uint8)
    ch = grp.crop_h
    strips = np.stack([inv[:, y : y + ch, x0 : x0 + crop_w] for y in grp.ys],
                      axis=1).reshape(-1, ch, crop_w)
    inked = np.flatnonzero(strips.reshape(len(strips), -1).max(axis=1) > 0)
    return inked, strips[inked]


def _decoder(fixture, pages, dopts):
    banks, _ = fixture
    dec = tfocr.GridDecoder(None, CONFIG["alphabet"], dopts, RenderOptions(size=13.0),
                            pages.shape[1:], "cpu", banks=banks)
    assert dec.prop_groups
    return dec


def _lines(got):
    return [[(ln.text, ln.y) for ln in page] for page in got]


@pytest.mark.parametrize("name", CASES)
def test_inked_strips_are_the_old_formulas(fixture, name):
    """Per row group: the same page-major indices and the same inverted
    strips, byte for byte, contiguous; the white count is the rest."""
    pages, dopts = _case(name, fixture[1])
    dec = _decoder(fixture, pages, dopts)
    reset_counters()
    total = 0
    for grp, _ in dec.prop_groups:
        want_idx, want = _old_strips(pages, grp, dec.x0, dec.crop_w)
        got_idx, got = tfocr.inked_strips(pages, grp, dec.x0, dec.crop_w)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        assert got.shape == want.shape == (len(want_idx), grp.crop_h, dec.crop_w)
        assert np.array_equal(got_idx, want_idx)
        assert got.tobytes() == want.tobytes()
        total += len(pages) * len(grp.ys) - len(want_idx)
    assert COUNTERS["prop_strips_white"] == total
    inked = {"last-row": 1, "left-of-x0": 0, "right-of-crop": 0, "all-white": 0}
    if name in inked:
        assert sum(len(pages) * len(g.ys) for g, _ in dec.prop_groups) - total == inked[name]
    if name == "partial-bottom":
        assert [g.crop_h for g, _ in dec.prop_groups] == [12, 5]
    if name == "narrow":
        assert dec.crop_w == 400 - X0


@pytest.mark.parametrize("name", CASES)
def test_decode_batch_is_the_old_formulas(fixture, name, monkeypatch, capsys, tmp_path):
    """decode_batch's lines with the new assembly and with the old formula
    put in its place are the same; an all-white batch launches nothing, and
    the CLI prints nothing for it."""
    pages, dopts = _case(name, fixture[1])
    dec = _decoder(fixture, pages, dopts)
    if name == "all-white":
        def refuse(*_a, **_k):
            raise AssertionError("K5 launched on an all-white batch")

        monkeypatch.setattr(tprop, "prop_scan", refuse)
        reset_counters()
        assert dec.decode_batch(pages) == [[] for _ in pages]
        assert COUNTERS.get("prop_lines_scanned", 0) == 0
        paths = write_pool(pages, str(tmp_path))
        argv = ["-i", *paths, *CONFIG["argv"], "--grid-bank", FIXTURE, "--device", "cpu"]
        assert torch_main(argv) == 0
        assert capsys.readouterr().out == ""
        return
    got = _lines(dec.decode_batch(pages))
    with monkeypatch.context() as m:
        m.setattr(tfocr, "inked_strips", _old_strips)
        want = _lines(dec.decode_batch(pages))
    assert got == want
    if name == "last-row":
        assert [len(page) for page in got] == [0, 1]
    elif name in ("left-of-x0", "right-of-crop"):
        assert got == [[], []]
    else:  # the fixture's lines start on the grid's rows: every kept row is inked
        assert all(len(page) >= ROWS for page in got)


@pytest.mark.parametrize("x,ys,crop_h,width", [
    (-1, (0, 15), 12, CW), (0, (-20, -5), 12, CW),  # before the page's left or top edge
    (0, (76, 88), 13, CW), (60, (0, 15), 12, CW),  # past its bottom or right edge
    (0, (0, 15, 40), 12, CW),  # rows not evenly spaced
], ids=["left", "top", "bottom", "right", "uneven"])
def test_a_grid_off_the_page_is_refused(fixture, x, ys, crop_h, width):
    """A strided view must stay inside the pages: a grid that leaves the
    100 x 662 page, or whose rows are not evenly spaced, is refused, not read
    around the page's edge."""
    pages = fixture[1][:1, :100]
    with pytest.raises(ValueError, match="not an even grid inside a 100x662 page"):
        tfocr.inked_strips(pages, tfocr._RowGroup(crop_h=crop_h, ys=ys), x, width)
    # the same grid one step inside the page is read
    tfocr.inked_strips(pages, tfocr._RowGroup(crop_h=12, ys=(0, 15)), 54, CW)
