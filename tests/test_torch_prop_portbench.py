"""The proportional focr path as the benchmark's focr-prop-sans13 cell runs
it, on the CPU (K5's plain version): the benchmark's plain reference
(portbench/reference/focr_prop.py) against focr_tpu's lines in the fixture,
the CLI's stdout against that reference on seeded pool pages, the prop
decoder's counters in --metrics-json, and its spans: one a batch or a row
group, never one a line."""

import json
import os

import numpy as np
import pytest
import torch

from focr_tpu_torch.cli.focr import main as torch_main
from focr_tpu_torch.fonts.bank import load_grid_bank
from focr_tpu_torch.models import focr as tfocr
from focr_tpu_torch.models.types import DecodeOptions, RenderOptions
from focr_tpu_torch.parallel import mesh as tmesh
from focr_tpu_torch.utils.metrics import COUNTERS, TRACE_NAME, reset_counters
from portbench.lib import pages as P
from portbench.reference import focr_prop

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_prop_golden.npz")
with open(os.path.join(REPO, "portbench", "configs", "focr-prop-sans13.json")) as f:
    CONFIG = json.load(f)
GRID = CONFIG["grid"]
N_POOL = 4
PROP_SPANS = ("focr_prop_strips", "focr_prop_upload", "focr_prop_launch", "focr_prop_fetch",
              "focr_prop_text")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """Four dense pool pages drawn from the fixture's line renders as the
    benchmark draws them, as PGM files, with the reference's lines and
    per-page records."""
    with np.load(FIXTURE) as z:
        source = z["pages"]
    pages = P.make_pool(source, CONFIG["bands"], {"pool_pages": N_POOL, "inked": "all"},
                        2**31 + 17)
    paths = P.write_pool(pages, str(tmp_path_factory.mktemp("prop_pool")))
    want, stats = focr_prop.expected_lines(pages, FIXTURE, CONFIG, "cpu")
    return pages, paths, want, stats


def _argv(paths, *extra):
    return ["-i", *paths, *CONFIG["argv"], "--grid-bank", FIXTURE, "--device", "cpu", *extra]


def test_reference_reproduces_the_fixtures_lines():
    """focr_tpu's lines for its 16 prop corpus pages, text for text."""
    with np.load(FIXTURE) as z:
        pages, golden = z["pages"], json.loads(str(z["lines"]))
    got, stats = focr_prop.expected_lines(pages, FIXTURE, CONFIG, "cpu")
    assert got == [[text for text, _ in page] for page in golden]
    assert [[r[0] for r in s["rows"]] for s in stats] == [[y for _, y in p] for p in golden]
    # every line's steps are its glyphs, one a step
    assert all(r[2] == len(t) for s, p in zip(stats, got) for r, t in zip(s["rows"], p))


@pytest.mark.parametrize("mode", ["batch", "single"])
def test_cli_prints_the_references_lines(pool, capsys, mode):
    """The CLI's stdout is the reference's lines, byte for byte: four pages
    in two batches of 2, and one page alone (the single-image path)."""
    pages, paths, want, _ = pool
    if mode == "batch":
        argv, expect = _argv(paths, "--batch-size", "2"), want
    else:
        argv, expect = _argv(paths[2:3]), want[2:3]
    assert torch_main(argv) == 0
    out = capsys.readouterr().out
    assert out == "".join(ln + "\n" for page in expect for ln in page)
    assert sum(map(len, expect)) == 48 * len(expect)


def _grid_rows(height):
    """The scan grid's rows on a page of ``height``: full and partial."""
    return len(range(GRID["y"], height, GRID["line_advance"]))


def test_metrics_json_counts_the_prop_scan(pool, tmp_path):
    """prop_lines_scanned: the inked rows; prop_steps: the reference's steps
    summed; strip_bytes_uploaded: those rows' strips, crop_h x crop_w each;
    prop_strips_white: the rest of the grid's rows, 3 a page (two white rows
    of height 12 and the bottom row of height 3)."""
    pages, paths, _, stats = pool
    mpath = tmp_path / "m.json"
    assert torch_main(_argv(paths, "--metrics-json", str(mpath))) == 0
    got = json.loads(mpath.read_text())["counters"]
    rows = [r for s in stats for r in s["rows"]]
    assert got["prop_lines_scanned"] == len(rows) == 48 * N_POOL
    assert got["prop_steps"] == sum(r[2] for r in rows)
    assert got["strip_bytes_uploaded"] == sum(h * GRID["width"] for _, h, _ in rows)
    assert got["prop_strips_white"] == 3 * N_POOL


@pytest.mark.parametrize("batch", [1, 3, N_POOL])
def test_white_and_scanned_strips_cover_the_grid(pool, tmp_path, batch):
    """Every row of the grid on every page is either sent to K5 or dropped
    by the ink test, whatever the batching."""
    pages, paths, _, _ = pool
    mpath = tmp_path / "m.json"
    argv = _argv(paths, "--batch-size", str(batch), "--metrics-json", str(mpath))
    assert torch_main(argv) == 0
    got = json.loads(mpath.read_text())["counters"]
    assert got["prop_strips_white"] + got["prop_lines_scanned"] == (
        N_POOL * _grid_rows(pages.shape[1]))


def test_prop_spans_open_once_a_batch_or_row_group(pool, capsys, tmp_path):
    """Under --profile: strips and text once a batch; upload, launch and fetch
    once a batch's row group that holds ink (here one of the two); all on
    the call's one thread, and the lines' ids unchanged."""
    pages, paths, want, _ = pool
    argv = _argv(paths, "--batch-size", "2", "--profile", str(tmp_path / "trace"))
    assert torch_main(argv) == 0
    assert capsys.readouterr().out == "".join(ln + "\n" for page in want for ln in page)
    events = json.loads((tmp_path / "trace" / TRACE_NAME).read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    by_name = {n: sum(e["name"] == n for e in spans) for n in PROP_SPANS}
    batches = N_POOL // 2
    assert by_name == dict.fromkeys(PROP_SPANS, batches)
    assert len({e["tid"] for e in spans if e["name"] in PROP_SPANS}) == 1
    assert len(spans) < 48  # fewer than the lines of one page


def test_prop_mesh_path_has_the_same_spans_and_counts(pool):
    """Lines dealt over two cpu slots: the same ids, the same counters (the
    white strips dropped included), and the same spans as one slot, each
    still once a batch's inked row group."""
    pages, _, want, _ = pool
    banks, _ = load_grid_bank(FIXTURE)
    dopts = DecodeOptions(x_start=GRID["x"], y_start=GRID["y"], width=GRID["width"],
                          line_height=GRID["line_height"], line_advance=GRID["line_advance"])
    args = (None, CONFIG["alphabet"], dopts, RenderOptions(size=13.0), pages.shape[1:], "cpu")
    runs = []
    for mesh in (None, tmesh.page_mesh(["cpu"] * 2, 1)):
        dec = tfocr.GridDecoder(*args, banks=banks, mesh=mesh)
        assert dec.prop_groups and (mesh is None) == (dec.prop_groups[0][1].mesh is None)
        reset_counters()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = dec.decode_batch(pages)
        names = [e.name for e in prof.events() if e.name in PROP_SPANS]
        runs.append(([[ln.text for ln in p] for p in got], dict(COUNTERS),
                     {n: names.count(n) for n in PROP_SPANS}))
    assert runs[0] == runs[1]
    assert runs[0][0] == want and runs[0][2] == dict.fromkeys(PROP_SPANS, 1)
    assert runs[0][1]["prop_lines_scanned"] == 48 * N_POOL
    assert runs[0][1]["prop_strips_white"] == 3 * N_POOL
