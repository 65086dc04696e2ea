"""Synthetic page generation for golden tests and benchmarks.

The reference ships no test corpus; SURVEY.md §4 prescribes synthesizing pages
by rendering known text with FreeType so ground truth is controlled. Pages are
rendered with the SAME alignment the focr decoder assumes: glyph baselines at
``alphabet_origin`` within each scan rectangle, cursors advanced with the f32
arithmetic of main.rs:176-178 — so a correct decoder recovers the text exactly.
"""

from __future__ import annotations

import numpy as np

from focr_tpu_torch.fonts.ft import Canvas, Face
from focr_tpu_torch.models.types import DecodeOptions, RenderOptions
from focr_tpu_torch.oracle.focr_oracle import advance_px, alphabet_origin


def synthesize_page(
    face: Face,
    lines: list[str],
    dopts: DecodeOptions,
    ropts: RenderOptions,
    alphabet: str,
    page_shape: tuple[int, int],
    blank_rows: set[int] | None = None,
) -> np.ndarray:
    """Render ``lines`` of text onto a white page at the focr scan grid.

    Line i is drawn in the scan rectangle at y = y_start + row*line_advance,
    where ``row`` skips any indices in ``blank_rows`` (to exercise the
    all-white row skip, main.rs:208-211).
    """
    H, W = page_shape
    canvas = Canvas(W, H)  # white-on-black work canvas (ink = high values)
    ox, oy = alphabet_origin(face, alphabet, ropts)
    blank_rows = blank_rows or set()

    row = 0
    for text in lines:
        while row in blank_rows:
            row += 1
        y = dopts.y_start + row * dopts.line_advance
        row += 1
        pos_x = np.float32(0.0)
        for ch in text:
            gid = face.glyph_for_char(ch)
            face.rasterize_glyph(
                canvas,
                gid,
                ropts.size,
                (float(dopts.x_start + ox + pos_x), float(y + oy)),
                ropts.hinting,
            )
            pos_x = pos_x + advance_px(face, gid, ropts)
    return (255 - canvas.pixels.astype(np.int32)).astype(np.uint8)


def random_text_lines(
    rng: np.random.Generator, alphabet: str, n_lines: int, n_chars: int
) -> list[str]:
    chars = list(alphabet)
    return [
        "".join(rng.choice(chars, size=n_chars)) for _ in range(n_lines)
    ]
