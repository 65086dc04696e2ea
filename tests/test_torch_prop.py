"""focr_tpu_torch's proportional focr decoder on the CPU (K5's plain PyTorch
version) against focr_tpu's, exactly: the 64-phase bank byte for byte and its
.npz round trip, the scan's ids against focr_tpu's jitted make_prop_forward,
GridDecoder lines against focr_tpu's and the oracle, the golden prop corpus,
and the bounds both packages refuse."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focr_tpu.fonts import bank as jbank
from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import random_text_lines, synthesize_page
from focr_tpu.models import focr as jfocr
from focr_tpu.models import focr_prop as jprop
from focr_tpu.models.types import DecodeOptions, RenderOptions
from focr_tpu.oracle import focr_oracle as joracle
from focr_tpu_torch.fonts import bank as tbank
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.models import focr as tfocr
from focr_tpu_torch.models import focr_prop as tprop
from focr_tpu_torch.models.types import (
    DecodeOptions as TDecodeOptions, RenderOptions as TRenderOptions,
)
from focr_tpu_torch.ops import prop_kernels
from focr_tpu_torch.oracle import focr_oracle as toracle

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_prop_golden.npz")
ALPHA = "AWijm01.:| "  # tests/test_focr_prop.py's: a wide advance spread
# bench.py's prop alphabet (:225): 67 glyphs, 'B' at 0 and 4, 'A' at 1 and 3
CORPUS_ALPHA = "> =ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/".replace(
    " ", "A").replace(">", "B")
FIELDS = ("templates", "colsq_cum", "advances")


@pytest.fixture(scope="module")
def faces(sans_font_path):
    return Face(sans_font_path), TFace(sans_font_path)


def key(pages):
    return [[(ln.text, ln.y) for ln in lines] for lines in pages]


def _same_bank(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.alphabet, a.base, a.crop_h) == (b.alphabet, b.base, b.crop_h)
    assert np.float32(a.ox) == np.float32(b.ox) and np.float32(a.oy) == np.float32(b.oy)


def _carry(jb):
    return tbank.prop_bank_from_arrays(
        jb.alphabet, jb.templates, jb.colsq_cum, jb.advances, jb.base, jb.ox, jb.oy, jb.crop_h)


_BANKS: dict = {}


def _jbank(face, alphabet, size, crop_h):
    k = (alphabet, size, crop_h)
    if k not in _BANKS:
        _BANKS[k] = jbank.build_prop_bank(face, alphabet, RenderOptions(size=size), crop_h)
    return _BANKS[k]


@pytest.mark.parametrize(
    "alphabet,size,crop_h",
    [(ALPHA, 12.0, 16), (CORPUS_ALPHA, 13.0, 12), (CORPUS_ALPHA, 13.0, 3)],
    ids=["small-12", "canonical-h12", "canonical-h3"],
)
def test_prop_bank_matches_focr_tpu(faces, alphabet, size, crop_h):
    got = tbank.build_prop_bank(faces[1], alphabet, TRenderOptions(size=size), crop_h)
    want = _jbank(faces[0], alphabet, size, crop_h)
    _same_bank(got, want)
    _same_bank(_carry(want), got)
    assert got.templates.shape[:2] == (len(alphabet), tbank.PROP_PHASES)


def test_prop_bank_file_roundtrip(faces, tmp_path):
    """A proportional bank set saves and loads through the focr bank file,
    with its kind in the settings; a mismatched bank is refused."""
    tr = TRenderOptions(size=12.0)
    banks = [_carry(_jbank(faces[0], ALPHA, 12.0, h)) for h in (16, 5)]
    settings = tbank.grid_bank_settings("/fonts/DejaVuSans.ttf", ALPHA, tr, 150, "prop")
    assert settings["kind"] == "prop" and "crop_w" not in settings
    path = str(tmp_path / "prop.npz")
    tbank.save_grid_bank(path, banks, settings)
    loaded, saved = tbank.load_grid_bank(path)
    assert saved == settings and sorted(loaded) == [5, 16]
    for b in banks:
        assert isinstance(loaded[b.crop_h], tbank.PropBank)
        _same_bank(loaded[b.crop_h], b)
    with pytest.raises(ValueError, match="settings"):
        tbank.save_grid_bank(path, banks, {**settings, "kind": "grid", "crop_w": 150})
    with pytest.raises(ValueError, match="settings"):
        tbank.save_grid_bank(path, banks, {**settings, "alphabet": "AW"})


def test_golden_fixture_is_focr_tpus(faces):
    """The committed prop golden: bench.py's prop corpus, focr_tpu's banks
    and a line per text row of every page."""
    loaded, settings = tbank.load_grid_bank(FIXTURE)
    assert settings == tbank.grid_bank_settings(
        "DejaVuSans.ttf", CORPUS_ALPHA, TRenderOptions(size=13.0), 608, "prop")
    assert sorted(loaded) == list(range(1, 13))
    for h in (3, 12):
        _same_bank(loaded[h], _jbank(faces[0], CORPUS_ALPHA, 13.0, h))
    with np.load(FIXTURE, allow_pickle=False) as z:
        pages, truths = z["pages"], json.loads(str(z["truths"]))
        lines = json.loads(str(z["lines"]))
    assert pages.shape == (16, 792, 662) and pages.dtype == np.uint8
    rng = np.random.default_rng(21)
    assert truths[0] == random_text_lines(rng, CORPUS_ALPHA, 48, 60)
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    assert np.array_equal(pages[1], synthesize_page(
        faces[0], truths[1], dopts, RenderOptions(size=13.0), CORPUS_ALPHA, (792, 662)))
    assert len(lines) == 16 and all(len(p) == 48 for p in lines)


def _text_strips(face, alphabet, size, crop_h, width, texts):
    """Inverted line strips of synthesized text, cropped as the decoder does."""
    adv = crop_h + 3
    dopts = DecodeOptions(x_start=4, y_start=3, line_height=crop_h, line_advance=adv,
                          width=width)
    page = synthesize_page(face, texts, dopts, RenderOptions(size=size), alphabet,
                           (3 + adv * len(texts) + 4, width + 8))
    inv = 255 - page.astype(np.int32)
    return np.stack([inv[3 + adv * i : 3 + adv * i + crop_h, 4 : 4 + width]
                     for i in range(len(texts))]).astype(np.uint8)


def _scan_case(face, case):
    """(focr_tpu bank, inverted strips [L, crop_h, crop_w])."""
    rng = np.random.default_rng(len(case))
    if case == "random-text":
        texts = ["".join(rng.choice(list(ALPHA.strip()), size=12)) for _ in range(4)]
        return _jbank(face, ALPHA, 12.0, 16), _text_strips(face, ALPHA, 12.0, 16, 150, texts)
    if case == "edge-clip-33":
        strips = _text_strips(face, ALPHA, 12.0, 16, 33, ["WWmW", "ij.5"])
        return _jbank(face, ALPHA, 12.0, 16), strips
    if case == "duplicated-chars":
        texts = ["".join(rng.choice(list(CORPUS_ALPHA), size=14)) for _ in range(3)]
        strips = _text_strips(face, CORPUS_ALPHA, 13.0, 12, 120, texts)
        return _jbank(face, CORPUS_ALPHA, 13.0, 12), strips
    if case == "noise":
        return _jbank(face, ALPHA, 12.0, 16), rng.integers(0, 256, (5, 16, 70), dtype=np.uint8)
    assert case == "all-white"
    return _jbank(face, ALPHA, 12.0, 16), np.zeros((3, 16, 60), np.uint8)


@pytest.mark.parametrize(
    "case", ["random-text", "edge-clip-33", "duplicated-chars", "noise", "all-white"])
def test_prop_scan_reference_matches_make_prop_forward(faces, case):
    """K5's plain version: every id of every step equals focr_tpu's jitted
    scan, END_ID past each line's end."""
    jb, strips = _scan_case(faces[0], case)
    crop_w = strips.shape[2]
    n_steps = jprop.max_steps(jb, crop_w)
    buf, _ = jax.jit(jprop.make_prop_forward(jb, crop_w, n_steps))(jnp.asarray(strips))
    want = np.asarray(buf).T  # [L, n_chunks * 16]
    assert (want[:, n_steps:] == prop_kernels.END_ID).all()
    tb = _carry(jb)
    prop_kernels.reset_launches()
    got = prop_kernels.prop_scan(
        torch.from_numpy(strips), torch.from_numpy(tb.templates),
        torch.from_numpy(tb.colsq_cum), torch.from_numpy(tb.advances), tb.base,
        float(tb.ox), n_steps,
    )
    assert prop_kernels.LAUNCHES == {"prop_scan": 0}
    assert got.dtype == torch.uint8 and got.shape == (len(strips), n_steps)
    np.testing.assert_array_equal(got.numpy(), want[:, :n_steps])
    assert (got.numpy() != prop_kernels.END_ID).any(axis=1).all()
    if case == "duplicated-chars":  # 'A' and 'B' are glyphs 2 and 3 and again 4 and 5...
        used = set(got.numpy().ravel().tolist())
        assert CORPUS_ALPHA.index("A") in used and 3 not in used
    texts = tprop.PropDecoder(tb, crop_w, torch.device("cpu")).decode_lines(strips)
    assert texts == jprop.PropDecoder(jb, crop_w).decode_lines(strips)


def _prop_pages(face):
    """tests/test_focr_prop.py's pages: (dopts kwargs, pages [B, H, W])."""
    ropts = RenderOptions(size=12.0)
    d = dict(x_start=4, y_start=5, line_height=16, line_advance=19, width=150)
    rng = np.random.default_rng(3)
    pages = []
    for i in range(3):
        lines = ["".join(rng.choice(list(ALPHA.strip()), size=8)) for _ in range(3)]
        pages.append(synthesize_page(face, lines, DecodeOptions(**d), ropts, ALPHA, (70, 170),
                                     blank_rows={1} if i == 1 else None))
    return d, np.stack(pages)


def _edge_pages(face):
    d = dict(x_start=2, y_start=3, line_height=16, line_advance=18, width=33)
    return d, synthesize_page(face, ["WWmW", "ij.5"], DecodeOptions(**d),
                              RenderOptions(size=12.0), ALPHA, (45, 40))[None]


def _wide_pages(face):
    d = dict(x_start=4, y_start=5, line_height=16, line_advance=19, width=120)
    return d, synthesize_page(face, ["Wi0m1j"], DecodeOptions(**d), RenderOptions(size=12.0),
                              ALPHA, (40, 140))[None]


NON_ASCII = "AWéiü.€"


def _non_ascii_pages(face):
    d = dict(x_start=3, y_start=4, line_height=16, line_advance=19, width=110)
    return d, synthesize_page(face, ["éWü€i", "€.Aé"], DecodeOptions(**d),
                              RenderOptions(size=12.0), NON_ASCII, (48, 120))[None]


@pytest.mark.parametrize("case", ["pages", "edge-clip-33", "one-line", "non-ascii"])
def test_grid_decoder_matches_focr_tpu_and_oracle(faces, case):
    d, pages = {"pages": _prop_pages, "edge-clip-33": _edge_pages,
                "one-line": _wide_pages, "non-ascii": _non_ascii_pages}[case](faces[0])
    alpha = NON_ASCII if case == "non-ascii" else ALPHA
    jd, jr = DecodeOptions(**d), RenderOptions(size=12.0)
    td, tr = TDecodeOptions(**d), TRenderOptions(size=12.0)
    dec = tfocr.GridDecoder(faces[1], alpha, td, tr, pages.shape[1:], "cpu")
    assert not dec.monospace and dec.prop_groups and not dec.groups
    got = dec.decode_batch(pages)
    want = jfocr.GridDecoder(faces[0], alpha, jd, jr, pages.shape[1:]).decode_batch(pages)
    assert key(got) == key(want)
    assert key(got) == key([toracle.decode_image(p, faces[1], alpha, td, tr) for p in pages])
    assert key(got) == key([joracle.decode_image(p, faces[0], alpha, jd, jr) for p in pages])
    assert key(tfocr.decode_pages(list(pages), faces[1], alpha, td, tr, "cpu")) == key(got)
    assert key([list(tfocr.decode_single_stream(dec, pages[0]))]) == key(got[:1])
    assert all(len(p) for p in got)


def test_golden_pages_decode_to_focr_tpus_lines(monkeypatch):
    """The 16 prop corpus pages, with the fixture's saved bank set and no
    font, decode to focr_tpu's lines through the device path; the oracle is
    never called."""
    banks, settings = tbank.load_grid_bank(FIXTURE)
    with np.load(FIXTURE, allow_pickle=False) as z:
        pages, golden = z["pages"], json.loads(str(z["lines"]))

    def no_oracle(*a, **k):
        raise AssertionError("the oracle was called")

    monkeypatch.setattr(toracle, "decode_image", no_oracle)
    d = TDecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    dec = tfocr.GridDecoder(None, settings["alphabet"], d, TRenderOptions(size=13.0),
                            pages.shape[1:], "cpu", banks=banks)
    assert [(g.crop_h, len(g.ys)) for g, _ in dec.prop_groups] == [(12, 50), (3, 1)]
    got = [[[ln.text, ln.y] for ln in p] for p in dec.decode_batch(pages)]
    assert got == golden
    with pytest.raises(ValueError, match="no bank"):
        tfocr.GridDecoder(None, settings["alphabet"], d, TRenderOptions(size=13.0),
                          (792, 662), "cpu", banks={12: banks[12]})


def test_device_path_never_calls_the_oracle(faces, monkeypatch):
    """With the oracle replaced by a function that raises, a proportional
    page still decodes (to focr_tpu's lines), by batch and streamed."""
    d, pages = _prop_pages(faces[0])
    want = jfocr.GridDecoder(faces[0], ALPHA, DecodeOptions(**d), RenderOptions(size=12.0),
                             pages.shape[1:]).decode_batch(pages)

    def no_oracle(*a, **k):
        raise AssertionError("the oracle was called")

    monkeypatch.setattr(toracle, "decode_image", no_oracle)
    monkeypatch.setattr(toracle, "decode_line", no_oracle)
    got = tfocr.decode_pages(list(pages), faces[1], ALPHA, TDecodeOptions(**d),
                             TRenderOptions(size=12.0), "cpu")
    assert key(got) == key(want)
    dec = tfocr.GridDecoder(faces[1], ALPHA, TDecodeOptions(**d), TRenderOptions(size=12.0),
                            pages.shape[1:], "cpu")
    assert key([list(tfocr.decode_single_stream(dec, pages[2]))]) == key(want[2:])


def test_non_positive_advance_routes_to_oracle(faces, monkeypatch):
    """A zero-advance glyph (a combining accent) would never end the scan:
    both packages leave the device path and call the oracle."""
    alpha = "AẂ"
    d = dict(x_start=2, y_start=2, line_height=14, line_advance=16, width=40)
    jdec = jfocr.GridDecoder(faces[0], alpha, DecodeOptions(**d), RenderOptions(size=12.0),
                             (20, 50))
    tdec = tfocr.GridDecoder(faces[1], alpha, TDecodeOptions(**d), TRenderOptions(size=12.0),
                             (20, 50), "cpu")
    assert not jdec.monospace and not jdec.prop_groups
    assert not tdec.monospace and not tdec.prop_groups
    calls = []
    monkeypatch.setattr(toracle, "decode_image", lambda *a: calls.append(a) or [])
    assert tdec.decode_batch(np.full((2, 20, 50), 255, np.uint8)) == [[], []]
    assert len(calls) == 2
    bank = _carry(jbank.build_prop_bank(faces[0], alpha, RenderOptions(size=12.0), 14))
    with pytest.raises(ValueError, match="non-positive"):
        tprop.PropDecoder(bank, 40, torch.device("cpu"))
    with pytest.raises(ValueError, match="non-positive"):
        jprop.PropDecoder(bank, 40)
    with pytest.raises(ValueError, match="font"):
        tfocr.GridDecoder(None, alpha, TDecodeOptions(**d), TRenderOptions(size=12.0), (20, 50),
                          "cpu", banks={h: bank for h in range(1, 15)})


@pytest.mark.parametrize("bound", ["glyphs", "window"])
def test_bank_bounds_refused_like_focr_tpu(bound):
    """focr_tpu asserts G < 255 (u8 ids) and 3·K·65025 < 2³¹ (int32 score);
    the port refuses the same banks."""
    G, h, wbank = (255, 2, 3) if bound == "glyphs" else (2, 11, 1001)
    ok = (254, 2, 3) if bound == "glyphs" else (2, 11, 1000)
    for (g, hh, ww), bad in (((G, h, wbank), True), (ok, False)):
        bank = tbank.prop_bank_from_arrays(
            "x" * g, np.zeros((g, 64, hh, ww), np.uint8), np.zeros((g, 64, ww + 1), np.int32),
            np.ones(g, np.float32), 2, 0.0, 0.0, hh)
        if bad:
            with pytest.raises(AssertionError):
                jprop.make_prop_forward(bank, 20, 21)
            with pytest.raises(ValueError, match="exceed"):
                tprop.PropDecoder(bank, 20, torch.device("cpu"))
        else:
            jprop.make_prop_forward(bank, 20, 21)
            tprop.PropDecoder(bank, 20, torch.device("cpu"))


@pytest.mark.parametrize("bad", ["phases", "height", "colsq", "advances", "empty"])
def test_prop_scan_rejects_bad_shapes(bad):
    strips = torch.zeros((2, 4, 30), dtype=torch.uint8)
    t = torch.zeros((3, 64, 4, 7), dtype=torch.uint8)
    cc = torch.zeros((3, 64, 8), dtype=torch.int32)
    adv = torch.ones(3)
    if bad == "phases":
        t, cc = t[:, :32], cc[:, :32]
    elif bad == "height":
        strips = strips[:, :3]
    elif bad == "colsq":
        cc = cc[..., :7]
    elif bad == "advances":
        adv = adv[:2]
    else:
        t, cc, adv = t[:0], cc[:0], adv[:0]
    with pytest.raises(ValueError):
        prop_kernels.prop_scan(strips, t, cc, adv, 2, 0.0, 10)
