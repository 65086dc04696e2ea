"""focr_tpu_torch's focr CLI (--device cpu) against focr_tpu's, on the same
PGM pages: stdout byte for byte, the same `ERROR <path>: ...` stderr lines,
and the port's own flags (--grid-bank, --device)."""

import numpy as np
import pytest
import torch

from focr_tpu.cli.focr import main as jax_main
from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions
from focr_tpu_torch.cli.focr import main as torch_main
from focr_tpu_torch.fonts.bank import build_grid_bank, grid_bank_settings, save_grid_bank
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.io.images import save_gray
from focr_tpu_torch.models.types import RenderOptions as TRenderOptions
from tests.test_focr_oracle import width_for_cells

torch.set_num_threads(2)

GRID = dict(x_start=5, y_start=6, line_height=12, line_advance=15)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, mono_font_path):
    """Two synthesized pages of one shape, one of another shape and a noise
    page, as PGM files; the grid's flags."""
    face = Face(mono_font_path)
    ropts = RenderOptions(size=13.0)
    width = width_for_cells(face, ropts, 6)
    dopts = DecodeOptions(width=width, **GRID)
    d = tmp_path_factory.mktemp("torch_focr")
    imgs = {
        "a": synthesize_page(face, ["Abc123", "> =xyz"], dopts, ropts, FOCR_DEFAULT_ALPHABET,
                             (60, 80)),
        "b": synthesize_page(face, ["Q+/90z", "", "hello="], dopts, ropts,
                             FOCR_DEFAULT_ALPHABET, (67, 80), blank_rows={1}),
        "c": synthesize_page(face, ["WORLD0"], dopts, ropts, FOCR_DEFAULT_ALPHABET, (60, 80)),
        "noise": np.random.default_rng(5).integers(0, 256, (50, 70), dtype=np.uint8),
    }
    paths = {}
    for name, img in imgs.items():
        paths[name] = str(d / f"{name}.pgm")
        save_gray(paths[name], img)
    flags = ["-f", mono_font_path, "-t", "13", "-x", str(GRID["x_start"]),
             "-y", str(GRID["y_start"]), "-w", str(width),
             "--line-height", "12", "--line-advance", "15"]
    return paths, flags, d


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _errors(err):
    return [ln for ln in err.splitlines() if ln.startswith("ERROR ")]


@pytest.mark.parametrize(
    "pages,extra",
    [
        (["a"], []),
        (["noise"], []),
        (["a", "b", "c"], []),
        (["b", "noise", "a", "c"], ["--batch-size", "1"]),
        (["a", "b"], ["-a", "AAbc123> =xyzQ+/90hello"]),
        (["c"], ["-k", "1.05", "--hinting"]),
    ],
    ids=["single", "single-noise", "several", "mixed-shapes-batch1", "dup-alphabet",
         "kern-hint"],
)
def test_stdout_matches_focr_tpu(setup, capsys, pages, extra):
    paths, flags, _ = setup
    argv = ["-i", *(paths[p] for p in pages), *flags, *extra]
    rc_j, want, _ = _run(jax_main, argv, capsys)
    rc_t, got, err = _run(torch_main, [*argv, "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert got == want and want
    assert not _errors(err)


def test_duplicate_alphabet_takes_first(setup, capsys):
    """With every character duplicated, the first copy wins every tie: the
    output is the undoubled alphabet's."""
    paths, flags, _ = setup
    argv = ["-i", paths["a"], paths["noise"], *flags, "--device", "cpu"]
    rc, want, _ = _run(torch_main, [*argv, "-a", "Abc123> =xyzq"], capsys)
    rc2, got, _ = _run(torch_main, [*argv, "-a", "Abc123> =xyzq" * 2], capsys)
    assert rc == rc2 == 0 and got == want


@pytest.mark.parametrize("n_pages", [1, 3])
def test_grid_bank_matches_rendered(setup, capsys, mono_font_path, n_pages):
    """--grid-bank (no FreeType needed) gives focr_tpu's stdout."""
    paths, flags, d = setup
    width = int(flags[flags.index("-w") + 1])
    tface, tr = TFace(mono_font_path), TRenderOptions(size=13.0)
    bank = str(d / "grid.npz")
    save_grid_bank(
        bank, [build_grid_bank(tface, FOCR_DEFAULT_ALPHABET, tr, width, h) for h in range(1, 13)],
        grid_bank_settings(mono_font_path, FOCR_DEFAULT_ALPHABET, tr, width),
    )
    argv = ["-i", *[paths[p] for p in ("a", "b", "noise")][:n_pages], *flags]
    _, want, _ = _run(jax_main, argv, capsys)
    rc, got, _ = _run(torch_main, [*argv, "--device", "cpu", "--grid-bank", bank], capsys)
    assert rc == 0 and got == want
    # the font is only named: a missing file is fine with a bank
    argv[argv.index(mono_font_path)] = "/nowhere/DejaVuSansMono.ttf"
    rc, got, _ = _run(torch_main, [*argv, "--device", "cpu", "--grid-bank", bank], capsys)
    assert rc == 0 and got == want


@pytest.mark.parametrize("change", ["size", "alphabet", "width", "font", "line-height"])
def test_grid_bank_settings_mismatch_exits_2(setup, capsys, mono_font_path, change):
    paths, flags, d = setup
    width = int(flags[flags.index("-w") + 1])
    tface, tr = TFace(mono_font_path), TRenderOptions(size=13.0)
    bank = str(d / "grid-small.npz")
    save_grid_bank(
        bank, [build_grid_bank(tface, "Abc", tr, width, h) for h in range(1, 13)],
        grid_bank_settings(mono_font_path, "Abc", tr, width),
    )
    argv = ["-i", paths["a"], *flags, "-a", "Abc", "--device", "cpu", "--grid-bank", bank]
    if change == "size":
        argv[argv.index("-t") + 1] = "12"
    elif change == "alphabet":
        argv[argv.index("-a") + 1] = "Abd"
    elif change == "width":
        argv[argv.index("-w") + 1] = str(width + 1)
    elif change == "font":
        argv[argv.index("-f") + 1] = "/fonts/Other.ttf"
    else:
        argv[argv.index("--line-height") + 1] = "13"
    rc, out, err = _run(torch_main, argv, capsys)
    assert rc == 2 and out == "" and "focr: error:" in err


@pytest.mark.parametrize("order", ["bad-first", "bad-middle"])
def test_unreadable_page_isolated_like_focr_tpu(setup, capsys, order):
    paths, flags, d = setup
    bad = d / "bad.png"
    bad.write_bytes(b"not an image")
    imgs = [str(bad), paths["a"], paths["b"]] if order == "bad-first" else \
        [paths["a"], str(bad), paths["c"]]
    argv = ["-i", *imgs, *flags]
    rc_j, want, err_j = _run(jax_main, argv, capsys)
    rc_t, got, err_t = _run(torch_main, [*argv, "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0 and got == want and want
    assert _errors(err_t) == _errors(err_j) and len(_errors(err_t)) == 1
    with pytest.raises(Exception) as exc:
        jax_main([*argv, "--strict"])
    with pytest.raises(type(exc.value)):
        torch_main([*argv, "--strict", "--device", "cpu"])


def test_cuda_without_a_card_exits_2(setup, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    paths, flags, _ = setup
    rc, out, err = _run(torch_main, ["-i", paths["a"], *flags], capsys)
    assert rc == 2 and out == "" and "CUDA" in err
