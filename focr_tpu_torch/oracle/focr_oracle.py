"""Bit-exact NumPy re-implementation of the focr SSD decoder.

The counterpart of focr_tpu/oracle/focr_oracle.py: a slow, obviously correct
implementation of `decode_line`/`decode_image` (reference src/main.rs:112-239)
with every numeric quirk preserved:

  * reference inversion ``255 - x``                    (main.rs:150)
  * i64 SSD over the WHOLE line canvas                 (main.rs:109, 510-516)
  * first-minimum tie-break (Rust ``min_by_key``)      (main.rs:159-172)
  * f32 cursor arithmetic ``pos += advance/upem*size*kern_x`` (main.rs:176-178)
  * all-white row skip, zero-height stop, empty-text stop     (main.rs:205-215)

The grid and proportional decoders (models/focr.py, models/focr_prop.py) are
tested against it; it decodes only an alphabet with a non-positive advance,
which would never end the device scan, as in focr_tpu.
"""

from __future__ import annotations

import numpy as np

from focr_tpu_torch.fonts.ft import Canvas, Face, RectF
from focr_tpu_torch.models.types import DecodedLine, DecodeOptions, RenderOptions


def advance_px(face: Face, gid: int, opts: RenderOptions) -> np.float32:
    """Per-glyph cursor advance in px, in f32 arithmetic (main.rs:51-53, 176-178)."""
    upem = np.float32(face.metrics.units_per_em)
    return (
        np.float32(face.advance(gid))
        / upem
        * np.float32(opts.size)
        * np.float32(opts.kern_x)
    )


def alphabet_origin(face: Face, alphabet: str, opts: RenderOptions) -> tuple[np.float32, np.float32]:
    """-bbox.origin() where bbox is the union of alphabet raster bounds
    at the default transform (main.rs:131-147). The fold starts from the
    zero rect, so (0,0) is always inside the union."""
    bbox = RectF()
    for ch in alphabet:
        gid = face.glyph_for_char(ch)
        bbox = bbox.union_rect(face.raster_bounds(gid, opts.size, (0.0, 0.0), opts.hinting).to_f32())
    return (np.float32(-bbox.x0), np.float32(-bbox.y0))


def render_string(face: Face, text: str, opts: RenderOptions) -> Canvas:
    """The whole-string renderer (main.rs:40-85), used by the verify/test overlays.

    Canvas size is bounds.round() (round-to-nearest, NOT round_out);
    glyphs are drawn translated by the *unrounded* -bounds.origin().
    """
    upem = np.float32(face.metrics.units_per_em)
    glyph_pos: list[tuple[int, np.float32, np.float32]] = []
    pos_x = np.float32(0.0)
    pos_y = np.float32(0.0)
    for ch in text:
        gid = face.glyph_for_char(ch)
        glyph_pos.append((gid, pos_x, pos_y))
        pos_x = pos_x + np.float32(face.advance(gid)) / upem * np.float32(opts.size) * np.float32(
            opts.kern_x
        )

    bounds = RectF()
    for gid, px, py in glyph_pos:
        rb = face.raster_bounds(gid, opts.size, (float(px), float(py)), opts.hinting)
        bounds = bounds.union_rect(rb.to_f32())

    size = bounds.round()
    canvas = Canvas(size.width, size.height)
    # compose translations in f32 explicitly (font-kit's Transform2F adds are
    # f32; relying on NEP-50 weak promotion would silently become f64 — and
    # a different 1/64-px quantization — under numpy 1.x)
    ox, oy = np.float32(-bounds.x0), np.float32(-bounds.y0)
    for gid, px, py in glyph_pos:
        face.rasterize_glyph(
            canvas, gid, opts.size,
            (float(ox + np.float32(px)), float(oy + np.float32(py))),
            opts.hinting,
        )
    return canvas


def sum_of_squares(xs: np.ndarray, ys: np.ndarray) -> int:
    """i64 SSD over u8 buffers (main.rs:510-516)."""
    d = xs.astype(np.int64) - ys.astype(np.int64)
    return int((d * d).sum())


def decode_line(
    reference: np.ndarray, face: Face, alphabet: str, opts: RenderOptions
) -> str:
    """Greedy per-line decode, exact reference semantics (main.rs:112-181)."""
    h, w = reference.shape
    canvas = Canvas(w, h)
    char_gids = [(c, face.glyph_for_char(c)) for c in alphabet]
    ox, oy = alphabet_origin(face, alphabet, opts)
    ref_inv = (255 - reference.astype(np.int32)).astype(np.uint8)

    out: list[str] = []
    pos_x = np.float32(0.0)
    while pos_x < np.float32(w):
        best_c, best_gid, best_score = None, None, None
        for c, gid in char_gids:
            canvas.fill(0)
            face.rasterize_glyph(
                canvas, gid, opts.size, (float(ox + pos_x), float(oy)), opts.hinting
            )
            score = sum_of_squares(ref_inv.ravel(), canvas.pixels.ravel())
            # Rust min_by_key keeps the FIRST minimum (strict <)
            if best_score is None or score < best_score:
                best_c, best_gid, best_score = c, gid, score
        out.append(best_c)
        pos_x = pos_x + advance_px(face, best_gid, opts)
    return "".join(out)


def decode_image(
    img: np.ndarray,
    face: Face,
    alphabet: str,
    dopts: DecodeOptions,
    ropts: RenderOptions,
) -> list[DecodedLine]:
    """Row loop with crop clamp / white skip / empty stop (main.rs:183-218)."""
    H, W = img.shape
    lines: list[DecodedLine] = []
    i = 0
    while True:
        y = dopts.y_start + i * dopts.line_advance
        i += 1
        # image crate crop_imm clamps the crop rect to the image.
        x0 = min(dopts.x_start, W)
        y0 = min(y, H)
        cw = min(dopts.width, W - x0)
        ch = min(dopts.line_height, H - y0)
        crop = img[y0 : y0 + ch, x0 : x0 + cw]
        if crop.shape[0] == 0:
            break
        if (crop == 255).all():
            continue  # whitespace line (main.rs:208-211)
        text = decode_line(crop, face, alphabet, ropts)
        if text == "":
            break
        lines.append(DecodedLine(text=text, y=y))
    return lines
