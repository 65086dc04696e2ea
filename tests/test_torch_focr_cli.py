"""focr_tpu_torch's focr CLI (--device cpu) against focr_tpu's, on the same
PGM pages: stdout byte for byte, the same `ERROR <path>: ...` stderr lines,
and the port's own flags (--grid-bank, --device)."""

import re

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


# --- the flags ported last: --test, --verify, --profile, --metrics-json,
# --mesh, --glyph-shards --------------------------------------------------


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_parser_takes_every_flag_of_focr_tpus():
    from focr_tpu.cli.focr import build_parser as jax_parser
    from focr_tpu_torch.cli.focr import build_parser as torch_parser

    ours, theirs = _options(torch_parser()), _options(jax_parser())
    assert theirs <= ours
    assert ours - theirs == {"--device", "--grid-bank"}
    # --mesh and --glyph-shards build a mesh now: none is "accepted and unused"
    for action in torch_parser()._actions:
        if {"--mesh", "--glyph-shards"} & set(action.option_strings):
            assert "accepted" not in action.help and "unused" not in action.help


@pytest.mark.parametrize("extra,want", [([], ("cpu", 1)), (["--glyph-shards", "4"], ("cpu", 4)),
                                        (["--mesh", "auto", "--glyph-shards", "2"], ("cpu", 2)),
                                        (["--mesh", "off", "--glyph-shards", "2"], None)],
                         ids=["default", "glyph-shards", "both", "off"])
def test_mesh_flags_reach_auto_mesh(setup, capsys, monkeypatch, extra, want):
    """--mesh auto (the default) calls auto_mesh with the device and
    --glyph-shards; --mesh off never does."""
    from focr_tpu_torch.parallel import mesh as mesh_mod

    paths, flags, _ = setup
    calls = []

    def auto_mesh(device, glyph_shards=1):
        calls.append((str(device), glyph_shards))
        return None

    monkeypatch.setattr(mesh_mod, "auto_mesh", auto_mesh)
    rc, out, _ = _run(torch_main, ["-i", paths["a"], paths["c"], *flags, "--device", "cpu",
                                   *extra], capsys)
    assert rc == 0 and out and calls == ([want] if want else [])


def _png(path):
    from PIL import Image

    with Image.open(path) as im:
        return im.mode, np.asarray(im).copy()


@pytest.mark.parametrize("pages", [["a"], ["a", "b", "noise"]], ids=["single", "several"])
def test_verify_matches_focr_tpu(setup, capsys, tmp_path, pages):
    """--verify: the same `path mse` stderr lines, the same overlay pixels in
    the PNGs, the same stdout (a single image is then not streamed)."""
    paths, flags, _ = setup
    jd, td = tmp_path / "j", tmp_path / "t"
    jd.mkdir(), td.mkdir()
    argv = ["-i", *(paths[p] for p in pages), *flags]
    rc_j, want, err_j = _run(jax_main, [*argv, "--verify", str(jd)], capsys)
    rc_t, got, err_t = _run(torch_main, [*argv, "--verify", str(td), "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0 and got == want and want
    assert err_t == err_j and len(err_t.splitlines()) == len(pages)
    assert all(re.fullmatch(r".+\.pgm \d+\.\d{6}", ln) for ln in err_t.splitlines())
    names = sorted(p.name for p in jd.iterdir())
    assert sorted(p.name for p in td.iterdir()) == names == sorted(f"{p}.png" for p in pages)
    for name in names:
        (mode_t, px_t), (mode_j, px_j) = _png(td / name), _png(jd / name)
        assert mode_t == mode_j == "RGB" and np.array_equal(px_t, px_j)


def test_verify_skips_an_unreadable_page_like_focr_tpu(setup, capsys, tmp_path):
    paths, flags, d = setup
    bad = d / "bad2.png"
    bad.write_bytes(b"not an image")
    jd, td = tmp_path / "j", tmp_path / "t"
    jd.mkdir(), td.mkdir()
    argv = ["-i", paths["a"], str(bad), paths["c"], *flags]
    _, want, err_j = _run(jax_main, [*argv, "--verify", str(jd)], capsys)
    _, got, err_t = _run(torch_main, [*argv, "--verify", str(td), "--device", "cpu"], capsys)
    assert got == want and err_t == err_j
    assert sorted(p.name for p in td.iterdir()) == sorted(p.name for p in jd.iterdir()) == [
        "a.png", "c.png"]


def test_verify_needs_a_directory(setup, tmp_path):
    paths, flags, _ = setup
    argv = ["-i", paths["a"], *flags, "--verify", str(tmp_path / "missing")]
    with pytest.raises(AssertionError, match="--verify should be a dir"):
        jax_main(argv)
    with pytest.raises(AssertionError, match="--verify should be a dir"):
        torch_main([*argv, "--device", "cpu"])


@pytest.mark.parametrize("page,extra", [("a", []), ("noise", []), ("b", ["-a", "AB"])],
                         ids=["text", "noise", "short-alphabet"])
def test_test_mode_matches_focr_tpu(setup, capsys, tmp_path, page, extra):
    """--test PREFIX: the two RGBA PNGs decode to focr_tpu's pixels; nothing
    on stdout; no device is needed (no --device cpu here)."""
    paths, flags, _ = setup
    argv = ["-i", paths[page], *flags, *extra]
    rc_j, out_j, _ = _run(jax_main, [*argv, "--test", str(tmp_path / "j")], capsys)
    rc_t, out_t, _ = _run(torch_main, [*argv, "--test", str(tmp_path / "t")], capsys)
    assert rc_j == rc_t == 0 and out_t == out_j == ""
    for kind in ("rect", "text"):
        (mode_t, px_t), (mode_j, px_j) = (_png(tmp_path / f"t-{kind}.png"),
                                          _png(tmp_path / f"j-{kind}.png"))
        assert mode_t == mode_j == "RGBA" and np.array_equal(px_t, px_j)


@pytest.mark.parametrize("mode", ["verify", "test"])
def test_overlays_without_freetype_raise_as_face_does(setup, capsys, tmp_path, monkeypatch,
                                                      mono_font_path, mode):
    """With --grid-bank and no FreeType, --verify and --test raise what Face
    raises: no quiet skip."""
    from focr_tpu_torch.fonts import ft

    paths, flags, d = setup
    width = int(flags[flags.index("-w") + 1])
    tface, tr = TFace(mono_font_path), TRenderOptions(size=13.0)
    bank = str(d / "grid-verify.npz")
    save_grid_bank(
        bank, [build_grid_bank(tface, FOCR_DEFAULT_ALPHABET, tr, width, h) for h in range(1, 13)],
        grid_bank_settings(mono_font_path, FOCR_DEFAULT_ALPHABET, tr, width),
    )

    def no_library():
        raise OSError("libfreetype not found")

    monkeypatch.setattr(ft, "_ft", None)
    monkeypatch.setattr(ft, "_load_library", no_library)
    with pytest.raises(OSError, match="libfreetype not found"):
        ft.Face(mono_font_path)
    argv = ["-i", paths["a"], paths["c"], *flags, "--device", "cpu", "--grid-bank", bank]
    rc, out, _ = _run(torch_main, argv, capsys)  # the decode itself needs no FreeType
    assert rc == 0 and out
    extra = ["--verify", str(tmp_path)] if mode == "verify" else ["--test", str(tmp_path / "p")]
    with pytest.raises(OSError, match="libfreetype not found"):
        torch_main([*argv, *extra])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("pages", [["a"], ["a", "b", "c"], ["bad", "a"], ["noise", "bad", "b"]],
                         ids=["single", "several", "bad-first", "bad-middle"])
def test_metrics_json_matches_focr_tpu(setup, capsys, tmp_path, pages):
    """--metrics-json: focr_tpu's keys, and its counts for the same argv."""
    import json

    paths, flags, d = setup
    bad = d / "bad3.png"
    bad.write_bytes(b"not an image")
    argv = ["-i", *(str(bad) if p == "bad" else paths[p] for p in pages), *flags]
    _, want_out, _ = _run(jax_main, [*argv, "--metrics-json", str(tmp_path / "j.json")], capsys)
    _, got_out, _ = _run(torch_main, [*argv, "--device", "cpu", "--metrics-json",
                                      str(tmp_path / "t.json")], capsys)
    assert got_out == want_out
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert set(want) == {"tool", "pages", "decoded_pages", "lines", "errors", "decode_seconds",
                         "pages_per_sec"}
    assert set(got) == set(want) | {"counters"}
    assert set(got["counters"]) == {"bank_bytes_loaded", "strip_bytes_uploaded",
                                    "bank_cache_hits", "bank_cache_misses",
                                    "prop_lines_scanned", "prop_steps", "prop_strips_white",
                                    "pages_mapped", "pages_decoded"}
    # fonts, no saved set: nothing is read from the bank cache's raw copies
    assert got["counters"]["bank_cache_hits"] == got["counters"]["bank_cache_misses"] == 0
    # every readable page is a raw 8-bit PGM, mapped; the bad one is read, and fails
    assert got["counters"]["pages_mapped"] == len([p for p in pages if p != "bad"])
    assert got["counters"]["pages_decoded"] == 0
    for k in ("tool", "pages", "decoded_pages", "lines", "errors"):
        assert got[k] == want[k], k
    assert got["decode_seconds"] > 0 and got["pages_per_sec"] == pytest.approx(
        got["decoded_pages"] / got["decode_seconds"])
    # one line, keys sorted, as focr_tpu writes it
    text = (tmp_path / "t.json").read_text()
    assert text.endswith("\n") and text.count("\n") == 1 and list(got) == sorted(got)


def test_metrics_json_dash_goes_to_stderr(setup, capsys):
    import json

    paths, flags, _ = setup
    argv = ["-i", paths["a"], paths["b"], *flags, "--device", "cpu"]
    _, want, _ = _run(torch_main, argv, capsys)
    rc, out, err = _run(torch_main, [*argv, "--metrics-json", "-"], capsys)
    assert rc == 0 and out == want
    assert json.loads(err.splitlines()[-1])["decoded_pages"] == 2


@pytest.fixture(scope="module")
def grid_bank(setup, mono_font_path):
    """A saved grid bank set for the grid's flags, crop heights 1..12."""
    paths, flags, d = setup
    width = int(flags[flags.index("-w") + 1])
    tface, tr = TFace(mono_font_path), TRenderOptions(size=13.0)
    bank = str(d / "grid-spans.npz")
    save_grid_bank(
        bank, [build_grid_bank(tface, FOCR_DEFAULT_ALPHABET, tr, width, h) for h in range(1, 13)],
        grid_bank_settings(mono_font_path, FOCR_DEFAULT_ALPHABET, tr, width),
    )
    return bank


SPANS = ["focr_bank_open", "focr_bank_height_load", "focr_page_read", "focr_decoder_build",
         "focr_bucket", "focr_crop", "focr_upload", "focr_launch", "focr_fetch", "focr_assemble",
         "focr_print"]


@pytest.mark.parametrize("pages", [["a"], ["a", "b"]], ids=["streamed", "batched"])
def test_profile_writes_a_trace_and_keeps_stdout(setup, grid_bank, capsys, tmp_path, pages):
    """--profile traces the whole call: every stage's span (the streamed path
    has no bucketing), each height's load inside a decoder's build on the
    same thread, and the spans on one thread."""
    import json

    from focr_tpu_torch.utils.metrics import TRACE_NAME

    paths, flags, _ = setup
    argv = ["-i", *(paths[p] for p in pages), *flags, "--device", "cpu", "--grid-bank", grid_bank]
    _, want, _ = _run(torch_main, argv, capsys)
    rc, out, _ = _run(torch_main, [*argv, "--profile", str(tmp_path / "trace")], capsys)
    assert rc == 0 and out == want
    events = json.loads((tmp_path / "trace" / TRACE_NAME).read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in spans}
    assert names == set(SPANS) - ({"focr_bucket"} if len(pages) == 1 else set())
    assert len({e["tid"] for e in spans}) == 1
    builds = [e for e in spans if e["name"] == "focr_decoder_build"]
    loads = [e for e in spans if e["name"] == "focr_bank_height_load"]
    # crop heights 12 and 9 on page a, 12 and 1 on page b: each loaded once, by the
    # first decoder that asks
    assert len(builds) == len(pages) and len(loads) == 1 + len(pages)
    for e in loads:
        assert any(b["ts"] <= e["ts"] and e["ts"] + e["dur"] <= b["ts"] + b["dur"]
                   for b in builds)
    # a call opens a span a stage, a batch or a chunk, a height: not one a line or a page
    assert len(spans) <= 60


@pytest.mark.parametrize("pages,extra", [(["a"], []), (["a", "b", "c"], []),
                                         (["b", "a", "c", "noise"], ["--batch-size", "1"])],
                         ids=["streamed", "batched", "batch1"])
def test_metrics_json_counts_the_exact_bytes(setup, grid_bank, tmp_path, monkeypatch, pages,
                                            extra):
    """--metrics-json's counters: the bank arrays of each crop height loaded,
    every strip uploaded (pages × rows × crop_h × crop_w), and each height's
    load as a miss of the bank cache, then, in the next call, as a hit."""
    import json

    from focr_tpu_torch.io.images import load_gray

    monkeypatch.setenv("FOCR_TPU_CACHE_DIR", str(tmp_path / "banks"))
    paths, flags, _ = setup
    mpath = tmp_path / "m.json"
    argv = ["-i", *(paths[p] for p in pages), *flags, *extra, "--device", "cpu",
            "--grid-bank", grid_bank, "--metrics-json", str(mpath)]
    assert torch_main(argv) == 0
    got = json.loads(mpath.read_text())["counters"]
    assert torch_main(argv) == 0
    again = json.loads(mpath.read_text())["counters"]
    x0, y0, w = (int(flags[flags.index(f) + 1]) for f in ("-x", "-y", "-w"))
    heights, strips = set(), 0
    for p in pages:
        H, W = load_gray(paths[p]).shape
        crop_w = max(min(w, W - x0), 0)
        for y in range(y0, H, GRID["line_advance"]):
            heights.add(min(GRID["line_height"], H - y))
            strips += min(GRID["line_height"], H - y) * crop_w
    with np.load(grid_bank) as z:
        bank = sum(z[f"grid_h{h}_{k}"].nbytes for h in heights
                   for k in ("templates", "tsq", "wx0", "positions"))
    assert got == {"bank_bytes_loaded": bank, "strip_bytes_uploaded": strips,
                   "bank_cache_hits": 0, "bank_cache_misses": len(heights),
                   "prop_lines_scanned": 0, "prop_steps": 0, "prop_strips_white": 0,
                   "pages_mapped": len(pages), "pages_decoded": 0}
    assert again == {**got, "bank_cache_hits": len(heights), "bank_cache_misses": 0}
    assert strips > 0 and bank > 0


def test_a_fresh_process_reads_the_heights_from_the_bank_cache(setup, grid_bank, tmp_path):
    """Two runs of the CLI, each in a process of its own, over one cache
    directory: the same stdout, and the second run reads every crop height
    the first one decompressed from its raw copy."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "FOCR_TPU_CACHE_DIR": str(tmp_path / "banks"), "PYTHONPATH": repo}
    env.pop("FOCR_TPU_NO_BANK_CACHE", None)
    paths, flags, _ = setup
    runs = []
    for i in range(2):
        mpath = tmp_path / f"m{i}.json"
        proc = subprocess.run(
            [sys.executable, "-m", "focr_tpu_torch.cli.focr", "-i", paths["a"], paths["b"],
             *flags, "--device", "cpu", "--grid-bank", grid_bank, "--metrics-json", str(mpath)],
            cwd=repo, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs.append((proc.stdout, json.loads(mpath.read_text())["counters"]))
    (out0, c0), (out1, c1) = runs
    assert out0 == out1 and out0.strip()
    # pages a and b: crop heights 12, 9 and 1
    assert (c0["bank_cache_hits"], c0["bank_cache_misses"]) == (0, 3)
    assert (c1["bank_cache_hits"], c1["bank_cache_misses"]) == (3, 0)
    assert c0["bank_bytes_loaded"] == c1["bank_bytes_loaded"] > 0


@pytest.mark.parametrize("extra", [["--mesh", "auto"], ["--mesh", "off"], ["--glyph-shards", "1"],
                                   ["--mesh", "auto", "--glyph-shards", "2"]],
                         ids=["mesh-auto", "mesh-off", "glyph-shards", "both"])
def test_mesh_flags_are_accepted_and_do_nothing_on_one_device(setup, capsys, extra):
    paths, flags, _ = setup
    argv = ["-i", paths["a"], paths["b"], *flags, "--device", "cpu"]
    _, want, _ = _run(torch_main, argv, capsys)
    rc, out, err = _run(torch_main, [*argv, *extra], capsys)
    assert rc == 0 and out == want and err == ""


@pytest.mark.parametrize("cards,mesh,said", [(1, "auto", False), (4, "auto", True),
                                             (4, "off", False)])
def test_more_cards_than_one_is_said_once(setup, capsys, monkeypatch, cards, mesh, said):
    """With several cards visible --mesh auto builds the mesh over them (a
    run used to take one card and say so on stderr; ``said`` is now whether a
    mesh reaches the decoder), --mesh off and one card build none, and
    nothing is said on stderr either way."""
    from focr_tpu_torch.models import focr as focr_model
    from focr_tpu_torch.parallel import mesh as mesh_mod

    paths, flags, _ = setup
    seen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mesh_mod, "mesh_devices", lambda dev: [f"cpu:{i}" for i in range(cards)])
    real = focr_model.decode_pages

    def recording(*args, mesh=None, **kw):
        seen.append(mesh)
        return real(*args, mesh=mesh, **kw)

    monkeypatch.setattr(focr_model, "decode_pages", recording)
    argv = ["-i", paths["a"], paths["b"], *flags, "--device", "cpu"]
    rc, out, err = _run(torch_main, [*argv, "--mesh", mesh, "--glyph-shards", "2"], capsys)
    assert rc == 0 and out and err == ""
    assert len(seen) == 1 and (seen[0] is not None) == said
    if said:
        assert seen[0].shape == {"pages": cards // 2, "glyphs": 2}
        assert [str(s.device) for s in seen[0].slots] == [f"cpu:{i}" for i in range(cards)]
    rc, want, _ = _run(torch_main, [*argv, "--mesh", "off"], capsys)
    assert out == want
