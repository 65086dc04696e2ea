"""The ncc needle bank: every (offset, letter) glyph rendered once at startup.

The needle half of focr_tpu/fonts/bank.py (:307-454), minus its disk cache
(the canonical 296-needle bank renders in well under a second). The focr grid
and proportional banks come with their slices.

A bank can also be saved to and loaded from an .npz file
(save_needle_bank / load_needle_bank), so a machine without FreeType can run
the matcher on needles rendered elsewhere.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from focr_tpu_torch.fonts.ft import Canvas, Face, RectF
from focr_tpu_torch.models.types import BoxSize, RenderOptions


@dataclass(frozen=True)
class Needle:
    letter: str
    offset: tuple[float, float]  # the subpixel grid offset (pre-correction)
    corrected_offset: tuple[float, float]
    pixels: np.ndarray  # [n_h, n_w] u8
    s_n: int
    s2_n: int


def offsets_grid(x_bits: int, y_bits: int) -> list[tuple[float, float]]:
    """2^x_bits × 2^y_bits subpixel offsets, x-major (ncc.rs:563-573)."""
    xs = 2**x_bits
    ys = 2**y_bits
    return [(x / xs, y / ys) for x in range(xs) for y in range(ys)]


def _box_for_offset(
    face: Face,
    alphabet: str,
    ropts: RenderOptions,
    box_size: BoxSize,
    offset: tuple[float, float],
) -> tuple[float, tuple[int, int] | None]:
    """(y_offset, canvas (w, h) or None for per-char boxes) — ncc.rs:588-628."""
    m = face.metrics
    to_px = np.float32(1.0) / np.float32(m.units_per_em) * np.float32(ropts.size)
    if box_size is BoxSize.FONT:
        bbox = m.bounding_box.scale(float(to_px)).round_out()
        y_offset = float(np.ceil(np.float32(m.ascent) * to_px))
        return y_offset, (bbox.width, bbox.height)
    if box_size is BoxSize.ALPHABET:
        y_offset = 0.0
        bbox = RectF()
        for c in alphabet:
            gid = face.glyph_for_char(c)
            tb = face.typographic_bounds(gid).scale(float(to_px))
            bearing_y = tb.y0 + tb.height  # glyph_bounds.origin().y() + height
            y_offset = max(y_offset, float(np.ceil(np.float32(bearing_y))))
            rb = face.raster_bounds(gid, ropts.size, offset, ropts.hinting)
            bbox = bbox.union_rect(rb.to_f32())
        out = bbox.round_out()
        return y_offset, (out.width, out.height)
    return 0.0, None


def render_needle(
    face: Face,
    letter: str,
    corrected_offset: tuple[float, float],
    ropts: RenderOptions,
    canvas_size: tuple[int, int] | None,
    padding: tuple[int, int],
) -> np.ndarray:
    """The ncc glyph renderer (ncc.rs:143-196): canvas = box (+2*padding) for
    fixed boxes (origin (0,0)) or tight raster bounds for per-char boxes
    (origin -raster_bounds.origin())."""
    gid = face.glyph_for_char(letter)
    if canvas_size is not None:
        size = (canvas_size[0] + 2 * padding[0], canvas_size[1] + 2 * padding[1])
        origin = (0.0, 0.0)
    else:
        rb = face.raster_bounds(gid, ropts.size, corrected_offset, ropts.hinting)
        size = (rb.width + 2 * padding[0], rb.height + 2 * padding[1])
        origin = (-float(rb.x0), -float(rb.y0))
    canvas = Canvas(size[0], size[1])
    face.rasterize_glyph(
        canvas,
        gid,
        ropts.size,
        (
            origin[0] + padding[0] + corrected_offset[0],
            origin[1] + padding[1] + corrected_offset[1],
        ),
        ropts.hinting,
    )
    return canvas.pixels


def _needle(letter, offset, corrected, px) -> Needle:
    p64 = px.astype(np.int64)
    return Needle(
        letter=letter,
        offset=offset,
        corrected_offset=corrected,
        pixels=px,
        s_n=int(p64.sum()),
        s2_n=int((p64 * p64).sum()),
    )


def build_needles(
    face: Face,
    alphabet: str,
    ropts: RenderOptions,
    box_size: BoxSize,
    x_bits: int,
    y_bits: int,
    padding: tuple[int, int] = (0, 0),
) -> list[Needle]:
    """All (offset × letter) needles in reference iteration order
    (offsets outer, letters inner — ncc.rs:587-655)."""
    needles: list[Needle] = []
    for offset in offsets_grid(x_bits, y_bits):
        y_off, canvas_size = _box_for_offset(face, alphabet, ropts, box_size, offset)
        corrected = (offset[0], offset[1] + y_off)
        for letter in alphabet:
            px = render_needle(face, letter, corrected, ropts, canvas_size, padding)
            needles.append(_needle(letter, offset, corrected, px))
    return needles


def bank_settings(
    font_path: str,
    alphabet: str,
    ropts: RenderOptions,
    box_size: BoxSize,
    x_bits: int,
    y_bits: int,
    padding: tuple[int, int],
) -> dict:
    """Everything a needle bank depends on, as saved beside it: a loaded bank
    is used only under the settings it was rendered with."""
    return {
        "font": os.path.basename(font_path),
        "size": float(ropts.size),
        "hinting": [bool(ropts.hinting.full), float(ropts.hinting.size)],
        "alphabet": alphabet,
        "box": box_size.value,
        "x_bits": int(x_bits),
        "y_bits": int(y_bits),
        "padding": [int(padding[0]), int(padding[1])],
    }


def needle_bank_arrays(needles: list[Needle], settings: dict) -> dict[str, np.ndarray]:
    """The .npz fields of a saved bank (see load_needle_bank)."""
    return {
        "bank_settings": np.array(json.dumps(settings, sort_keys=True)),
        "letters": np.array([nd.letter for nd in needles]),
        "offsets": np.array([nd.offset for nd in needles], dtype=np.float64),
        "corrected": np.array([nd.corrected_offset for nd in needles], dtype=np.float64),
        "shapes": np.array([nd.pixels.shape for nd in needles], dtype=np.int32),
        "pixels": np.concatenate([nd.pixels.ravel() for nd in needles]),
    }


def save_needle_bank(path: str, needles: list[Needle], settings: dict) -> None:
    np.savez_compressed(path, **needle_bank_arrays(needles, settings))


def load_needle_bank(path: str) -> tuple[list[Needle], dict]:
    """(needles in reference order, the settings they were rendered with)."""
    with np.load(path, allow_pickle=False) as z:
        settings = json.loads(str(z["bank_settings"]))
        letters, offsets, corrected = z["letters"], z["offsets"], z["corrected"]
        shapes, blob = z["shapes"], z["pixels"]
    needles = []
    off = 0
    for i, (h, w) in enumerate(shapes.tolist()):
        px = blob[off : off + h * w].reshape(h, w).copy()
        off += h * w
        needles.append(
            _needle(
                str(letters[i]),
                (float(offsets[i, 0]), float(offsets[i, 1])),
                (float(corrected[i, 0]), float(corrected[i, 1])),
                px,
            )
        )
    return needles, settings
