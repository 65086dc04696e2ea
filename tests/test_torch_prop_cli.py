"""The focr CLI with a proportional font: focr_tpu_torch's (--device cpu, K5's
plain version) against focr_tpu's on the same PGM pages, stdout byte for
byte, with the glyphs rendered by FreeType and from a saved proportional bank
set (--grid-bank); a mismatched bank exits 2."""

import numpy as np
import pytest
import torch

from focr_tpu.cli.focr import main as jax_main
from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models.types import DecodeOptions, RenderOptions
from focr_tpu_torch.cli.focr import main as torch_main
from focr_tpu_torch.fonts.bank import build_prop_bank, grid_bank_settings, save_grid_bank
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.io.images import save_gray
from focr_tpu_torch.models.types import RenderOptions as TRenderOptions

torch.set_num_threads(2)

ALPHA = "AWijm01.:| "
GRID = dict(x_start=4, y_start=5, line_height=12, line_advance=15, width=120)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, sans_font_path):
    """Two DejaVu Sans pages of one shape, one of another (its bottom row is
    cut to 4 pixels) and a noise page, as PGM files; the grid's flags and a
    saved proportional bank set for crop heights 1..12."""
    face = Face(sans_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(**GRID)
    d = tmp_path_factory.mktemp("torch_prop_cli")
    imgs = {
        "a": synthesize_page(face, ["AWij01", "m.:|Wi"], dopts, ropts, ALPHA, (50, 130)),
        "b": synthesize_page(face, ["W0", "", "jim|"], dopts, ropts, ALPHA, (50, 130),
                             blank_rows={1}),
        "c": synthesize_page(face, ["iiii", "mWmW", "1.0"], dopts, ropts, ALPHA, (54, 128)),
        "noise": np.random.default_rng(9).integers(0, 256, (40, 100), dtype=np.uint8),
    }
    paths = {}
    for name, img in imgs.items():
        paths[name] = str(d / f"{name}.pgm")
        save_gray(paths[name], img)
    flags = ["-f", sans_font_path, "-a", ALPHA, "-t", "11", "-x", "4", "-y", "5",
             "-w", "120", "--line-height", "12", "--line-advance", "15"]
    tface, tr = TFace(sans_font_path), TRenderOptions(size=11.0)
    bank = str(d / "prop.npz")
    save_grid_bank(bank, [build_prop_bank(tface, ALPHA, tr, h) for h in range(1, 13)],
                   grid_bank_settings(sans_font_path, ALPHA, tr, 120, "prop"))
    return paths, flags, bank


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize(
    "pages,extra",
    [(["a"], []), (["noise"], []), (["a", "b", "c"], []),
     (["c", "noise", "a"], ["--batch-size", "1"])],
    ids=["single", "single-noise", "several", "mixed-shapes-batch1"],
)
@pytest.mark.parametrize("bank", [False, True], ids=["rendered", "saved-bank"])
def test_stdout_matches_focr_tpu(setup, capsys, pages, extra, bank):
    paths, flags, bank_path = setup
    argv = ["-i", *(paths[p] for p in pages), *flags, *extra]
    rc_j, want, _ = _run(jax_main, argv, capsys)
    if bank:  # the font is only named: a missing file is fine with a bank
        argv[argv.index("-f") + 1] = "/nowhere/DejaVuSans.ttf"
        argv += ["--grid-bank", bank_path]
    rc_t, got, err = _run(torch_main, [*argv, "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert got == want and want
    assert not [ln for ln in err.splitlines() if ln.startswith("ERROR ")]


@pytest.mark.parametrize("change", ["size", "alphabet", "font", "line-height", "kerning"])
def test_prop_bank_settings_mismatch_exits_2(setup, capsys, change):
    paths, flags, bank = setup
    argv = ["-i", paths["a"], *flags, "--device", "cpu", "--grid-bank", bank]
    if change == "size":
        argv[argv.index("-t") + 1] = "12"
    elif change == "alphabet":
        argv[argv.index("-a") + 1] = "AWij"
    elif change == "font":
        argv[argv.index("-f") + 1] = "/fonts/DejaVuSansMono.ttf"
    elif change == "line-height":
        argv[argv.index("--line-height") + 1] = "13"
    else:
        argv += ["-k", "1.1"]
    rc, out, err = _run(torch_main, argv, capsys)
    assert rc == 2 and out == "" and "focr: error:" in err
