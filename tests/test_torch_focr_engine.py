"""focr_tpu_torch's GridDecoder (device="cpu": K4's plain PyTorch version)
against focr_tpu's GridDecoder and the NumPy oracle, on the CPU, exactly:
equal (text, y) lines on the cases of tests/test_focr_engine.py, the
streamed single-page path, the proportional device path and the golden
pages."""

import gc
import json
import os
import weakref

import numpy as np
import pytest
import torch

from focr_tpu.fonts.bank import build_grid_bank as jbuild_grid_bank
from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models import focr as jfocr
from focr_tpu.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions
from focr_tpu.oracle import focr_oracle
from focr_tpu_torch.fonts.bank import load_grid_bank
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.models import focr as tfocr
from focr_tpu_torch.models.types import (
    DecodeOptions as TDecodeOptions, RenderOptions as TRenderOptions,
)
from focr_tpu_torch.ops import ssd_kernels
from tests.test_focr_oracle import width_for_cells

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_focr_golden.npz")
ALPHABET = FOCR_DEFAULT_ALPHABET


@pytest.fixture(scope="module")
def faces(mono_font_path):
    return Face(mono_font_path), TFace(mono_font_path)


def key(pages):
    return [[(ln.text, ln.y) for ln in lines] for lines in pages]


def _opts(size=13.0, **d):
    return (DecodeOptions(**d), RenderOptions(size=size),
            TDecodeOptions(**d), TRenderOptions(size=size))


def _synth_pages(faces):
    d = dict(x_start=7, y_start=5, line_height=12, line_advance=15,
             width=width_for_cells(faces[0], RenderOptions(size=13.0), 6))
    jd, jr, _, _ = _opts(**d)
    rng = np.random.default_rng(0)
    return d, [
        synthesize_page(faces[0], ["".join(rng.choice(list(ALPHABET), size=6)) for _ in range(3)],
                        jd, jr, ALPHABET, (64, 80), blank_rows={1})
        for _ in range(3)
    ]


def _noise_pages(_faces):
    rng = np.random.default_rng(1)
    pages = [rng.integers(0, 256, size=(50, 44), dtype=np.uint8) for _ in range(2)]
    pages.append(np.clip(rng.integers(250, 260, size=(50, 44)), 0, 255).astype(np.uint8))
    return dict(x_start=3, y_start=2, line_height=12, line_advance=15, width=30), pages


def _partial_pages(_faces):
    # rows at y=3,18,33,48; H=55 -> the last row's crop height is 7
    rng = np.random.default_rng(2)
    return (dict(x_start=2, y_start=3, line_height=12, line_advance=15, width=40),
            [rng.integers(0, 256, size=(55, 50), dtype=np.uint8) for _ in range(2)])


def _zero_width_pages(_faces):
    return (dict(x_start=100, y_start=0, line_height=12, line_advance=15, width=40),
            [np.zeros((40, 50), dtype=np.uint8)])


def _empty_grid_pages(_faces):
    return (dict(x_start=0, y_start=60, line_height=12, line_advance=15, width=40),
            [np.zeros((40, 50), dtype=np.uint8)])


ENGINE_CASES = {
    "synthetic-blank-row": _synth_pages,
    "noise": _noise_pages,
    "partial-bottom-row": _partial_pages,
    "zero-width-crop": _zero_width_pages,
    "empty-row-grid": _empty_grid_pages,
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_decode_batch_matches_focr_tpu_and_oracle(faces, case):
    d, pages = ENGINE_CASES[case](faces)
    jd, jr, td, tr = _opts(**d)
    want = jfocr.GridDecoder(faces[0], ALPHABET, jd, jr, pages[0].shape).decode_batch(
        np.stack(pages))
    dec = tfocr.GridDecoder(faces[1], ALPHABET, td, tr, pages[0].shape, "cpu")
    got = dec.decode_batch(np.stack(pages))
    assert key(got) == key(want)
    assert key(got) == key([focr_oracle.decode_image(p, faces[0], ALPHABET, jd, jr)
                            for p in pages])
    if case in ("noise", "partial-bottom-row", "synthetic-blank-row"):
        assert all(len(lines) for lines in got)
    if case == "partial-bottom-row":
        assert [g.crop_h for g, _ in dec.groups] == [12, 7]
    if case in ("zero-width-crop", "empty-row-grid"):
        assert got == [[]] and not dec.groups


def test_decode_pages_multi_shape(faces):
    d = dict(x_start=4, y_start=4, line_height=12, line_advance=15,
             width=width_for_cells(faces[0], RenderOptions(size=13.0), 5))
    jd, jr, td, tr = _opts(**d)
    pages = [
        synthesize_page(faces[0], [w], jd, jr, ALPHABET, s)
        for w, s in (("Hello", (40, 60)), ("world", (55, 70)), ("again", (40, 60)))
    ]
    want = jfocr.decode_pages(pages, faces[0], ALPHABET, jd, jr)
    got = tfocr.decode_pages(pages, faces[1], ALPHABET, td, tr, "cpu", batch_size=1)
    assert key(got) == key(want)
    assert [[ln.text for ln in p] for p in got] == [["Hello"], ["world"], ["again"]]


def test_decode_pages_keeps_no_decoder(faces, monkeypatch):
    """decode_pages builds a decoder for each page shape of the call and
    holds none of them, their device banks included, once it returns."""
    d = dict(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    _, _, td, tr = _opts(size=11.0, **d)
    page = synthesize_page(faces[0], ["AB01"], DecodeOptions(**d), RenderOptions(size=11.0),
                           "AB01ab", (64, 128))
    built = []
    init = tfocr.GridDecoder.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        built.append(weakref.ref(self))

    monkeypatch.setattr(tfocr.GridDecoder, "__init__", spy)
    a = tfocr.decode_pages([page], faces[1], "AB01ab", td, tr, "cpu")
    gc.collect()
    assert len(built) == 1 and built[0]() is None
    assert a[0][0].text.startswith("AB01") and a[0][0].y == 6
    b = tfocr.decode_pages([page], faces[1], "AB01ab", td, tr, "cpu")
    gc.collect()
    assert len(built) == 2 and built[1]() is None and key(a) == key(b)


@pytest.mark.parametrize("rows_per_chunk,n_rows", [(2, 8), (1, 24), (16, 8)])
def test_single_stream_matches_decode_batch(faces, rows_per_chunk, n_rows):
    """decode_single_stream: lines identical to decode_batch's, including the
    partial bottom row and a blank row, and yielded chunk by chunk."""
    d = dict(x_start=2, y_start=3, line_height=12, line_advance=15,
             width=width_for_cells(faces[0], RenderOptions(size=13.0), 5))
    jd, jr, td, tr = _opts(**d)
    rng = np.random.default_rng(7 + n_rows)
    lines = ["".join(rng.choice(list(ALPHABET), size=5)) for _ in range(n_rows)]
    page = synthesize_page(faces[0], lines, jd, jr, ALPHABET, (n_rows * 15 + 10, 70),
                           blank_rows={3})
    dec = tfocr.GridDecoder(faces[1], ALPHABET, td, tr, page.shape, "cpu")
    want = dec.decode_batch(page[None])[0]
    assert key([want]) == key(jfocr.GridDecoder(faces[0], ALPHABET, jd, jr, page.shape)
                              .decode_batch(page[None]))
    calls = []
    fwd0 = dec.groups[0][1]
    orig = fwd0.forward
    fwd0.forward = lambda s: calls.append(s.shape[1]) or orig(s)
    it = tfocr.decode_single_stream(dec, page, rows_per_chunk=rows_per_chunk)
    first = next(it)
    n_calls_at_first = len(calls)
    got = [first, *it]
    assert key([got]) == key([want])
    assert n_calls_at_first == 1 and len(calls) == -(-len(dec.groups[0][0].ys) // rows_per_chunk)


def test_make_grid_forward_matches_focr_tpu(faces):
    d, pages = _partial_pages(faces)
    jd, jr, td, tr = _opts(**d)
    arr = np.stack(pages)
    for grp in tfocr._row_groups(td, arr.shape[1]):
        jb = jbuild_grid_bank(faces[0], ALPHABET, jr, 40, grp.crop_h)
        want = jfocr.make_grid_forward(jb, grp.ys, 2)(arr)
        dec = tfocr.GridDecoder(faces[1], ALPHABET, td, tr, arr.shape[1:], "cpu")
        bank = dec.banks[[g.crop_h for g, _ in dec.groups].index(grp.crop_h)]
        ids, white = tfocr.make_grid_forward(bank, grp.ys, 2, "cpu")(arr)
        assert np.array_equal(ids.numpy(), np.asarray(want[0]).astype(np.int32))
        assert np.array_equal(white.numpy(), np.asarray(want[1]))


def test_proportional_alphabet_takes_device_path(sans_font_path):
    """A DejaVu Sans alphabet is not monospace: the port decodes it with its
    proportional device decoder (K5's plain version here), as focr_tpu does;
    the lines agree, by batch and streamed."""
    alpha = "AWijm01.:| "
    jf, tf = Face(sans_font_path), TFace(sans_font_path)
    d = dict(x_start=4, y_start=5, line_height=16, line_advance=19, width=150)
    jd, jr, td, tr = _opts(size=12.0, **d)
    rng = np.random.default_rng(3)
    pages = np.stack([
        synthesize_page(jf, ["".join(rng.choice(list(alpha.strip()), size=8)) for _ in range(3)],
                        jd, jr, alpha, (70, 170), blank_rows={1})
        for _ in range(2)
    ])
    jdec = jfocr.GridDecoder(jf, alpha, jd, jr, pages.shape[1:])
    assert jdec.prop_groups, "focr_tpu should take its proportional device path"
    tdec = tfocr.GridDecoder(tf, alpha, td, tr, pages.shape[1:], "cpu")
    assert not tdec.monospace and not tdec.groups
    assert [(g.crop_h, g.ys) for g, _ in tdec.prop_groups] == [
        (g.crop_h, g.ys) for g, _ in jdec.prop_groups]
    ssd_kernels.reset_launches()
    got = tdec.decode_batch(pages)
    assert key(got) == key(jdec.decode_batch(pages))
    assert all(len(p) == 3 for p in got)
    assert key([list(tfocr.decode_single_stream(tdec, pages[0]))]) == key(got[:1])
    assert ssd_kernels.LAUNCHES == {"ssd_argmin": 0, "ssd_argmin_partial": 0,
                                    "ssd_combine": 0, "ssd_combine_fold": 0}


def test_saved_bank_set_decodes_without_a_face():
    """With the golden's saved bank set and no font, the decoder reproduces
    focr_tpu's lines for all 16 corpus pages; a page whose crop width the
    set lacks is refused."""
    banks, settings = load_grid_bank(FIXTURE)
    with np.load(FIXTURE, allow_pickle=False) as z:
        pages, golden = z["pages"], json.loads(str(z["lines"]))
    d = TDecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    tr = TRenderOptions(size=13.0)
    dec = tfocr.GridDecoder(None, settings["alphabet"], d, tr, pages.shape[1:], "cpu",
                            banks=banks)
    assert [(g.crop_h, len(g.ys)) for g, _ in dec.groups] == [(12, 50), (3, 1)]
    got = [[[ln.text, ln.y] for ln in p] for p in dec.decode_batch(pages)]
    assert got == golden
    streamed = [[ln.text, ln.y] for ln in tfocr.decode_single_stream(dec, pages[3])]
    assert streamed == golden[3]
    with pytest.raises(ValueError, match="no bank"):
        tfocr.GridDecoder(None, settings["alphabet"], d, tr, (792, 600), "cpu", banks=banks)


def test_golden_pages_from_rendered_banks(faces):
    """The port's own banks (rendered here) decode the golden pages to
    focr_tpu's lines too."""
    with np.load(FIXTURE, allow_pickle=False) as z:
        pages, golden = z["pages"][:2], json.loads(str(z["lines"]))[:2]
    d = TDecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    got = tfocr.decode_pages(list(pages), faces[1], ALPHABET, d, TRenderOptions(size=13.0), "cpu")
    assert [[[ln.text, ln.y] for ln in p] for p in got] == golden


def test_cuda_device_without_a_card_raises(faces):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfocr.GridDecoder(faces[1], "AB", TDecodeOptions(width=10, line_height=12,
                                                          line_advance=15),
                          TRenderOptions(size=13.0), (30, 30), "cuda")
