"""focr_tpu_torch's io/overlays.py and its RGB/RGBA PNG writers against
focr_tpu's, on the CPU: overlay arrays byte for byte, red_blue_mse as f32,
on a rendered page and on grids at the page's edges; the PNGs read back with
Pillow equal focr_tpu's."""

import numpy as np
import pytest
from PIL import Image

from focr_tpu.fonts.ft import Face
from focr_tpu.io import images as jimages
from focr_tpu.io import overlays as jov
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models.types import DecodedLine, DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.io import images as timages
from focr_tpu_torch.io import overlays as tov
from focr_tpu_torch.models.types import (
    DecodedLine as TDecodedLine, DecodeOptions as TDecodeOptions, RenderOptions as TRenderOptions,
)

GRID = dict(x_start=5, y_start=6, line_height=12, line_advance=15, width=60)


@pytest.fixture(scope="module")
def faces(mono_font_path):
    return Face(mono_font_path), TFace(mono_font_path)


@pytest.fixture(scope="module")
def page(faces):
    return synthesize_page(faces[0], ["Abc123", "", "> =xyz", "hello="], DecodeOptions(**GRID),
                           RenderOptions(size=13.0), FOCR_DEFAULT_ALPHABET, (70, 80),
                           blank_rows={1})


def _noise(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _same(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# grids at the page's edges: a rect past the bottom, x + w = W, x + w > W,
# a grid that starts on the last row, one wider than the page
EDGE_GRIDS = {
    "inside": dict(GRID),
    "rect-past-bottom": dict(x_start=5, y_start=50, line_height=12, line_advance=15, width=60),
    "x-plus-w-is-W": dict(x_start=20, y_start=6, line_height=12, line_advance=15, width=60),
    "x-plus-w-past-W": dict(x_start=30, y_start=6, line_height=12, line_advance=15, width=60),
    "last-row": dict(x_start=0, y_start=69, line_height=12, line_advance=15, width=79),
    "touching-rows": dict(x_start=1, y_start=0, line_height=10, line_advance=10, width=78),
    "wider-than-page": dict(x_start=0, y_start=3, line_height=7, line_advance=9, width=200),
}


@pytest.mark.parametrize("grid", list(EDGE_GRIDS))
@pytest.mark.parametrize("img", ["page", "noise"])
def test_draw_test_rectangles_matches(page, grid, img):
    src = page if img == "page" else _noise((70, 80), 1)
    want = jov.draw_test_rectangles(src, DecodeOptions(**EDGE_GRIDS[grid]))
    got = tov.draw_test_rectangles(src, TDecodeOptions(**EDGE_GRIDS[grid]))
    _same(got, want)
    assert got.shape == (70, 80, 4)


@pytest.mark.parametrize(
    "text,shape",
    [(FOCR_DEFAULT_ALPHABET, (70, 80)), ("AB", (70, 80)), ("Wide text here", (9, 30)), ("", (20, 20))],
    ids=["alphabet-clipped", "short", "page-smaller-than-text", "empty"],
)
def test_draw_test_text_matches(faces, page, text, shape):
    src = page if shape == page.shape else _noise(shape, 2)
    want = jov.draw_test_text(faces[0], text, src, RenderOptions(size=13.0))
    got = tov.draw_test_text(faces[1], text, src, TRenderOptions(size=13.0))
    _same(got, want)


VERIFY_LINES = {
    "decoded": [("Abc123", 6), ("> =xyz", 36), ("hello=", 51)],
    "wrong-text": [("Xbc12", 6), ("hello=", 36)],
    "past-the-edges": [("WWWWWWWWWWWWWW", 60), ("A", -3), ("B", 69)],
    "none": [],
}


@pytest.mark.parametrize("lines", list(VERIFY_LINES))
@pytest.mark.parametrize("x_start", [5, 70])
def test_draw_verify_and_mse_match(faces, page, lines, x_start):
    grid = {**GRID, "x_start": x_start}
    want = jov.draw_verify(page, [DecodedLine(text=t, y=y) for t, y in VERIFY_LINES[lines]],
                           faces[0], DecodeOptions(**grid), RenderOptions(size=13.0))
    got = tov.draw_verify(page, [TDecodedLine(text=t, y=y) for t, y in VERIFY_LINES[lines]],
                          faces[1], TDecodeOptions(**grid), TRenderOptions(size=13.0))
    _same(got, want)
    a, b = tov.red_blue_mse(got), jov.red_blue_mse(want)
    assert np.float32(a).tobytes() == np.float32(b).tobytes()
    assert a > 0.0 or not VERIFY_LINES[lines]


@pytest.mark.parametrize("seed", range(4))
def test_red_blue_mse_matches_on_noise(seed):
    """The i64 sum and the f32 divide, on arrays whose sum passes 2^24 (where
    an f32 sum would round)."""
    rgb = _noise((97, 131, 3), seed)
    a, b = tov.red_blue_mse(rgb), jov.red_blue_mse(rgb)
    assert isinstance(a, float) and np.float32(a).tobytes() == np.float32(b).tobytes()
    r, bl = rgb[..., 0].astype(np.int64), rgb[..., 2].astype(np.int64)
    assert a == float(np.float32(int(((r - bl) ** 2).sum())) / np.float32(97 * 131))


@pytest.mark.parametrize("src", [(255, 0, 0, 128), (10, 200, 30, 255), (1, 2, 3, 0), (0, 0, 0, 77)])
def test_blend_rgba_matches(src):
    dst = _noise((6, 7, 4), 3)
    dst[0, 0, 3] = 0  # a fully transparent destination pixel
    a, b = dst.copy(), dst.copy()
    tov._blend_rgba(a, src)
    jov._blend_rgba(b, src)
    _same(a, b)


@pytest.mark.parametrize("kind,shape", [("rgb", (13, 17, 3)), ("rgba", (13, 17, 4)),
                                        ("rgb", (1, 1, 3)), ("rgba", (40, 3, 4))])
def test_save_rgb_rgba_png_reads_back_as_focr_tpus(kind, shape, tmp_path):
    """The port's own PNG writer (colour types 2 and 6) and focr_tpu's Pillow
    writer give files that decode to the same pixels and mode."""
    img = _noise(shape, 4)
    tp, jp = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    getattr(timages, f"save_{kind}")(tp, img)
    getattr(jimages, f"save_{kind}")(jp, img)
    with Image.open(tp) as t, Image.open(jp) as j:
        assert t.mode == j.mode == kind.upper()
        assert np.array_equal(np.asarray(t), np.asarray(j))
        assert np.array_equal(np.asarray(t), img)
    # and the port's own reader takes it (RGB(A) -> luma, alpha dropped)
    assert np.array_equal(timages.load_gray(tp), jimages.load_gray(jp))


@pytest.mark.parametrize("kind,shape", [("rgb", (4, 4)), ("rgb", (4, 4, 4)), ("rgba", (4, 4, 3))])
def test_save_rgb_rgba_refuse_other_shapes(kind, shape, tmp_path):
    with pytest.raises(ValueError):
        getattr(timages, f"save_{kind}")(str(tmp_path / "x.png"), np.zeros(shape, np.uint8))
