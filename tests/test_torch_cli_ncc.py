"""focr_tpu_torch's ncc CLI (--device cpu, and --engine native) against
focr_tpu's, on the same pages: stdout byte for byte for the text, --csv and
--raw outputs."""

import re

import numpy as np
import pytest
import torch

from focr_tpu.cli.ncc import main as jax_main
from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models.ncc import NccMatcher
from focr_tpu.models.types import DecodeOptions, RenderOptions
from focr_tpu_torch.cli.ncc import main as torch_main
from focr_tpu_torch.fonts.bank import bank_settings, build_needles, save_needle_bank
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.io.images import save_gray
from focr_tpu_torch.models.types import BoxSize, RenderOptions as TRenderOptions

torch.set_num_threads(2)

ALPHA = "ABCXYZ01="


@pytest.fixture(scope="module")
def pages(tmp_path_factory, mono_font_path):
    """A stamped page (tests/test_cli_ncc.py's) and a small rendered text
    page, as PGM files."""
    face = Face(mono_font_path)
    m = NccMatcher(face, "ABCXYZ", RenderOptions(size=13.0), threshold=0.8)
    by_letter = {nd.letter: nd for nd in m.needles}
    stamped = np.full((90, 120), 255, dtype=np.uint8)
    for text, y in zip(["XABC", "ZYCA"], (10, 40)):
        for ci, ch in enumerate(text):
            nd = by_letter[ch]
            nh, nw = nd.pixels.shape
            region = stamped[y : y + nh, 8 + ci * 9 : 8 + ci * 9 + nw]
            np.minimum(region, 255 - nd.pixels, out=region)
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=12, line_advance=15, width=150)
    text = synthesize_page(
        face, ["AB=01XYZ", "ZZ10=CBA", "0X1Y=A"], dopts, RenderOptions(size=13.0),
        ALPHA, (70, 120),
    )
    d = tmp_path_factory.mktemp("torch_ncc")
    paths = []
    for name, img in (("stamped", stamped), ("text", text)):
        p = d / f"{name}.pgm"
        save_gray(str(p), img)
        paths.append(str(p))
    return paths


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize(
    "extra", [[], ["--csv"], ["--x-bits", "1", "--csv"], ["--threshold", "0.6"]],
    ids=["text", "csv", "csv-xbits", "threshold"],
)
def test_cli_stdout_matches_focr_tpu(pages, mono_font_path, capsys, extra):
    argv = ["-i", *pages, "-f", mono_font_path, "-t", "13", "-a", ALPHA, *extra]
    rc_j, out_j, _ = _run(jax_main, argv, capsys)
    rc_t, out_t, _ = _run(torch_main, [*argv, "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert out_t == out_j
    assert out_t.strip()


@pytest.mark.parametrize("page", [0, 1])
def test_cli_raw_matches_focr_tpu(pages, mono_font_path, capsys, page):
    argv = ["-i", pages[page], "-f", mono_font_path, "-t", "13", "-a", ALPHA, "--raw"]
    _, out_j, _ = _run(jax_main, argv, capsys)
    rc, out_t, _ = _run(torch_main, [*argv, "--device", "cpu"], capsys)
    assert rc == 0 and out_t == out_j
    assert all(len(r.split(",")) == 11 for r in out_t.splitlines())


@pytest.mark.parametrize("mode", ["text", "csv", "raw", "verbose"])
def test_cli_engine_native_matches_focr_tpu(pages, mono_font_path, capsys, mode):
    """--engine native (the C++ host search; --device is not needed) prints
    focr_tpu's --engine native stdout byte for byte."""
    base = ["-f", mono_font_path, "-t", "13", "-a", ALPHA, "--engine", "native"]
    argv = {
        "text": ["-i", *pages, *base],
        "csv": ["-i", *pages, *base, "--csv"],
        "raw": ["-i", pages[1], *base, "--raw"],
        "verbose": ["-i", *pages, *base, "-v"],
    }[mode]
    rc_j, out_j, _ = _run(jax_main, argv, capsys)
    rc_t, out_t, err_t = _run(torch_main, argv, capsys)
    assert rc_j == rc_t == 0
    assert out_t == out_j and out_t.strip()
    assert ("[native group" in err_t) == (mode == "verbose")


def test_cli_rust_and_verbose_keep_stdout(pages, mono_font_path, capsys):
    """--rust (the oracle) prints the same lines; -v adds diagnostics on
    stderr only."""
    argv = ["-i", *pages, "-f", mono_font_path, "-t", "13", "-a", ALPHA, "--device", "cpu"]
    _, plain, err = _run(torch_main, argv, capsys)
    assert err == ""
    _, rust, _ = _run(torch_main, [*argv, "--rust"], capsys)
    _, verbose, verr = _run(torch_main, [*argv, "-v"], capsys)
    assert rust == verbose == plain
    assert "needle size" in verr and "hits:" in verr


def test_cli_without_cuda_fails_clearly(pages, mono_font_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(torch_main, ["-i", pages[0], "-f", mono_font_path, "-t", "13"], capsys)
    assert rc != 0 and out == ""
    assert "CUDA" in err and "--device cpu" in err


def test_cli_needle_bank(pages, mono_font_path, tmp_path, capsys):
    """A saved needle bank stands in for FreeType rendering: same stdout; a
    bank rendered under other settings is refused."""
    ropts = TRenderOptions(size=13.0)
    needles = build_needles(TFace(mono_font_path), ALPHA, ropts, BoxSize.ALPHABET, 0, 0)
    bank = str(tmp_path / "bank.npz")
    save_needle_bank(
        bank, needles,
        bank_settings(mono_font_path, ALPHA, ropts, BoxSize.ALPHABET, 0, 0, (0, 0)),
    )
    argv = ["-i", *pages, "-f", mono_font_path, "-t", "13", "-a", ALPHA, "--device", "cpu"]
    _, want, _ = _run(torch_main, argv, capsys)
    rc, got, _ = _run(torch_main, [*argv, "--needle-bank", bank], capsys)
    assert rc == 0 and got == want
    rc, out, err = _run(torch_main, [*argv, "--needle-bank", bank, "--x-bits", "1"], capsys)
    assert rc != 0 and out == "" and "rendered with" in err


def test_cli_unreadable_page_isolated(pages, mono_font_path, tmp_path, capsys):
    bad = tmp_path / "bad.pgm"
    bad.write_bytes(b"P5\n10 10\n255\n\x00")  # truncated
    argv = ["-i", str(bad), pages[0], "-f", mono_font_path, "-t", "13", "-a", ALPHA,
            "--device", "cpu"]
    rc, out, err = _run(torch_main, argv, capsys)
    _, want, _ = _run(torch_main, argv[:1] + argv[2:], capsys)
    assert rc == 0 and out == want and "ERROR" in err
    with pytest.raises(ValueError):
        torch_main([*argv, "--strict"])


# --- the flags ported last: --verbose-sync, --device-kernel, --wire, --mesh,
# --profile, --metrics-json -------------------------------------------------


def test_parser_takes_every_flag_of_focr_tpus():
    from focr_tpu.cli.ncc import build_parser as jax_parser
    from focr_tpu_torch.cli.ncc import build_parser as torch_parser

    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    ours, theirs = options(torch_parser()), options(jax_parser())
    assert theirs <= ours
    assert ours - theirs == {"--device", "--needle-bank"}
    # --mesh builds a mesh now; --device-kernel and --wire stay unused
    unused = {a.option_strings[0] for a in torch_parser()._actions
              if a.help and "unused" in a.help}
    assert unused == {"--device-kernel", "--wire"}


@pytest.mark.parametrize("extra,calls", [([], 1), (["--mesh", "auto", "--csv"], 1),
                                         (["--mesh", "off"], 0), (["--engine", "native"], 0),
                                         (["--rust"], 0)],
                         ids=["default", "auto", "off", "native", "rust"])
def test_mesh_flag_reaches_auto_mesh(pages, mono_font_path, capsys, monkeypatch, extra, calls):
    """--mesh auto (the default) asks auto_mesh for a mesh on the device
    engine's device and hands it, with the pages, to get_hits_many_sharded;
    --mesh off and the host engines never ask."""
    from focr_tpu_torch.models.ncc import NccMatcher as TNccMatcher
    from focr_tpu_torch.parallel import mesh as mesh_mod

    asked, sharded = [], []
    mesh = mesh_mod.page_mesh(["cpu"] * 3)
    monkeypatch.setattr(mesh_mod, "auto_mesh", lambda device: asked.append(str(device)) or mesh)
    real = TNccMatcher.get_hits_many_sharded

    def recording(self, pgs, m, **kw):
        sharded.append((len(pgs), m))
        return real(self, pgs, m, **kw)

    monkeypatch.setattr(TNccMatcher, "get_hits_many_sharded", recording)
    argv = ["-i", *pages, "-f", mono_font_path, "-t", "13", "-a", ALPHA, "--device", "cpu"]
    others = [e for e in extra if e not in ("--mesh", "auto", "off")]
    _, want, _ = _run(torch_main, [*argv, "--mesh", "off", *others], capsys)
    asked.clear(), sharded.clear()
    rc, out, _ = _run(torch_main, [*argv, *extra], capsys)
    assert rc == 0 and out == want and out
    assert asked == ["cpu"] * calls
    # the two pages differ in shape: one bucket, one sharded call, each
    assert sharded == [(1, mesh)] * (2 * calls)


@pytest.mark.parametrize("extra", [[], ["--csv"], ["--engine", "native"], ["--rust"]],
                         ids=["text", "csv", "native", "rust"])
def test_metrics_json_matches_focr_tpu(pages, mono_font_path, capsys, tmp_path, extra):
    """--metrics-json: focr_tpu's keys, and its counts for the same argv, with
    an unreadable page among the pages."""
    import json

    bad = tmp_path / "bad.pgm"
    bad.write_bytes(b"P5\n10 10\n255\n\x00")
    argv = ["-i", pages[0], str(bad), pages[1], "-f", mono_font_path, "-t", "13", "-a", ALPHA,
            *extra]
    _, want_out, _ = _run(jax_main, [*argv, "--metrics-json", str(tmp_path / "j.json")], capsys)
    _, got_out, _ = _run(torch_main, [*argv, "--device", "cpu", "--metrics-json",
                                      str(tmp_path / "t.json")], capsys)
    assert got_out == want_out and got_out
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert set(want) == {"tool", "pages", "decoded_pages", "lines", "hits", "errors",
                         "search_seconds", "engine"}
    assert set(got) == set(want) | {"counters"}
    assert set(got["counters"]) == {"ncc_candidates", "ncc_hits", "ncc_host_waits", "ncc_post_ns",
                                    "ncc_post_native", "pages_mapped", "pages_decoded"}
    # the device engine posts each readable page in one host-library call
    # (text and --csv); the other engines post objects
    device = "--engine" not in extra and "--rust" not in extra
    assert got["counters"]["ncc_post_native"] == (2 if device else 0)
    # both readable pages are raw 8-bit PGMs, mapped; the bad one is read, and fails
    assert (got["counters"]["pages_mapped"], got["counters"]["pages_decoded"]) == (2, 0)
    for k in ("tool", "pages", "decoded_pages", "lines", "hits", "engine"):
        assert got[k] == want[k], k
    assert got["pages"] == 3 and got["decoded_pages"] == 2 and got["hits"] > 0
    assert [e["page"] for e in got["errors"]] == [e["page"] for e in want["errors"]] == [str(bad)]
    assert got["search_seconds"] > 0


def test_post_native_counts_every_page(pages, mono_font_path, capsys, tmp_path):
    """A multi-page text run: focr_tpu's stdout, and --metrics-json's
    ncc_post_native counts every page posted, each in one host-library call."""
    import json

    argv = ["-i", *pages, *pages, pages[1], "-f", mono_font_path, "-t", "13", "-a", ALPHA]
    _, want_out, _ = _run(jax_main, argv, capsys)
    rc, got_out, _ = _run(torch_main, [*argv, "--device", "cpu", "--metrics-json",
                                       str(tmp_path / "m.json")], capsys)
    assert rc == 0 and got_out == want_out and got_out
    counters = json.loads((tmp_path / "m.json").read_text())["counters"]
    assert counters["ncc_post_native"] == 5 and counters["ncc_post_ns"] > 0


def _masked(err: str) -> str:
    """stderr with the numbers masked (times differ run to run) and the word
    before "group" dropped: it names the engine's kernel, focr_tpu's "pallas"
    or nothing, the port's device."""
    err = re.sub(r"^\[(\w+ )?group ", "[group ", err, flags=re.M)
    return re.sub(r"\d+(\.\d+)?(e-?\d+)?", "N", err)


@pytest.mark.parametrize("mode", ["text", "raw"])
def test_verbose_sync_stderr_matches_focr_tpu(pages, mono_font_path, capsys, mode):
    """--verbose-sync: per-page fenced dispatch; stdout and, numbers masked,
    stderr equal focr_tpu's, with the measured label on every group line."""
    base = ["-f", mono_font_path, "-t", "13", "-a", ALPHA, "--verbose-sync"]
    argv = ["-i", *pages, *base] if mode == "text" else ["-i", pages[1], *base, "--raw"]
    rc_j, out_j, err_j = _run(jax_main, argv, capsys)
    rc_t, out_t, err_t = _run(torch_main, [*argv, "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0 and out_t == out_j and out_t
    assert _masked(err_t) == _masked(err_j)
    groups = [ln for ln in err_t.splitlines() if " group " in ln and ln.startswith("[")]
    assert groups and all("measured wall time, split evenly" in ln for ln in groups)
    assert "estimated" not in err_t


def test_verbose_without_sync_prints_the_estimate(pages, mono_font_path, capsys):
    argv = ["-i", *pages, "-f", mono_font_path, "-t", "13", "-a", ALPHA, "-v"]
    _, out_j, err_j = _run(jax_main, argv, capsys)
    _, out_t, err_t = _run(torch_main, [*argv, "--device", "cpu"], capsys)
    assert out_t == out_j and _masked(err_t) == _masked(err_j)
    assert "estimated: page span attributed evenly" in err_t and "measured" not in err_t


@pytest.mark.parametrize(
    "extra",
    [["--device-kernel", "pallas"], ["--device-kernel", "xla", "--wire", "delta"],
     ["--wire", "pos"], ["--mesh", "off"], ["--device-kernel", "auto", "--wire", "pos", "--mesh",
                                            "auto"]],
    ids=["pallas", "xla-delta", "pos", "mesh-off", "all"],
)
def test_compatibility_flags_change_nothing(pages, mono_font_path, capsys, extra):
    argv = ["-i", *pages, "-f", mono_font_path, "-t", "13", "-a", ALPHA, "--device", "cpu"]
    _, want, _ = _run(torch_main, argv, capsys)
    rc, out, err = _run(torch_main, [*argv, *extra], capsys)
    assert rc == 0 and out == want and err == ""
    rc_j, out_j, _ = _run(jax_main, [*argv[:-2], *extra], capsys)
    assert rc_j == 0 and out_j == want


def test_profile_writes_a_trace_with_the_stage_spans(pages, mono_font_path, capsys, tmp_path):
    import json

    from focr_tpu_torch.utils.metrics import TRACE_NAME

    argv = ["-i", *pages, "-f", mono_font_path, "-t", "13", "-a", ALPHA, "--device", "cpu"]
    _, want, _ = _run(torch_main, argv, capsys)
    rc, out, _ = _run(torch_main, [*argv, "--profile", str(tmp_path / "tr")], capsys)
    assert rc == 0 and out == want
    events = json.loads((tmp_path / "tr" / TRACE_NAME).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"focr_ncc_dispatch_wave", "focr_ncc_collect_wave"} <= names


def test_verbose_with_a_needle_bank_and_no_freetype(pages, mono_font_path, tmp_path, capsys,
                                                   monkeypatch):
    """A saved bank holds no font metrics: -v then says that it leaves the
    dump out, and prints the rest; --raw still needs the font."""
    from focr_tpu_torch.fonts import ft

    ropts = TRenderOptions(size=13.0)
    needles = build_needles(TFace(mono_font_path), ALPHA, ropts, BoxSize.ALPHABET, 0, 0)
    bank = str(tmp_path / "bank.npz")
    save_needle_bank(
        bank, needles, bank_settings(mono_font_path, ALPHA, ropts, BoxSize.ALPHABET, 0, 0, (0, 0)))
    argv = ["-i", *pages, "-f", mono_font_path, "-t", "13", "-a", ALPHA, "--device", "cpu",
            "--needle-bank", bank]
    _, want, _ = _run(torch_main, argv, capsys)
    _, _, err_ft = _run(torch_main, [*argv, "--verbose-sync"], capsys)
    assert "units_per_em" in err_ft

    def no_library():
        raise OSError("libfreetype not found")

    monkeypatch.setattr(ft, "_ft", None)
    monkeypatch.setattr(ft, "_load_library", no_library)
    rc, out, err = _run(torch_main, [*argv, "--verbose-sync"], capsys)
    assert rc == 0 and out == want
    assert "ncc: font metrics not shown: libfreetype not found" in err
    assert "units_per_em" not in err and "measured wall time, split evenly" in err
    with pytest.raises(OSError, match="libfreetype not found"):
        torch_main(["-i", pages[0], *argv[3:], "--raw"])
