"""The two f32 glyph-geometry helpers of focr_tpu/oracle/focr_oracle.py that
the needle bank and the page synthesizer need (the focr decoder oracle itself
is ported with the focr slice)."""

from __future__ import annotations

import numpy as np

from focr_tpu_torch.fonts.ft import Face, RectF
from focr_tpu_torch.models.types import RenderOptions


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
