"""Regenerate tests/fixtures/torch_prop_golden.npz (run from the repo root).

The golden for the PyTorch port's proportional focr slice, made by the
reference package (focr_tpu, on the CPU) from bench.py's prop corpus
(bench.py:196-257: DejaVu Sans 13, bench.ALPHABET with ' ' -> 'A' and
'>' -> 'B' — 67 glyphs, 65 distinct characters, so 'A' and 'B' tie exactly
at every cursor position — grid -x 45 -y 39 -w 608 --line-height 12
--line-advance 15, 792x662 pages of 48 lines x 60 characters, text from seed
21):

  pages     u8 [16, 792, 662] — the corpus' 16 pages
  truths    JSON: the text lines each page was rendered from
  lines     JSON: focr_tpu's GridDecoder lines, [[text, y], ...] per page
            (its proportional device decoder; page 0 is checked against
            focr_tpu's oracle here, as bench.py does)
  and a saved proportional bank set (fonts/bank.py::load_grid_bank reads
  the file): focr_tpu's build_prop_bank for crop heights 1..12

Machines without FreeType (or Pillow) can run the port on it. The members are
LZMA-compressed (np.load reads them). Regenerate only after a deliberate
change to the corpus or the font layer.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.gen_torch_focr_golden import savez_lzma  # noqa: E402

FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
ALPHABET = "> =ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
PROP_ALPHABET = ALPHABET.replace(" ", "A").replace(">", "B")  # bench.py:225
N_PAGES = 16
SHAPE = (792, 662)


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from focr_tpu.fonts.bank import build_prop_bank
    from focr_tpu.fonts.ft import Face
    from focr_tpu.io.synth import random_text_lines, synthesize_page
    from focr_tpu.models.focr import GridDecoder
    from focr_tpu.models.types import DecodeOptions, RenderOptions
    from focr_tpu.oracle import focr_oracle
    from focr_tpu_torch.fonts.bank import grid_bank_arrays, grid_bank_settings, prop_bank_from_arrays

    face = Face(FONT)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    rng = np.random.default_rng(21)
    truths = [random_text_lines(rng, PROP_ALPHABET, 48, 60) for _ in range(N_PAGES)]
    pages = np.stack([
        synthesize_page(face, t, dopts, ropts, PROP_ALPHABET, SHAPE) for t in truths
    ])
    dec = GridDecoder(face, PROP_ALPHABET, dopts, ropts, SHAPE)
    assert dec.prop_groups, "focr_tpu should take its proportional device path"
    decoded = dec.decode_batch(pages)
    oracle = focr_oracle.decode_image(pages[0], face, PROP_ALPHABET, dopts, ropts)
    assert [(ln.text, ln.y) for ln in decoded[0]] == [(ln.text, ln.y) for ln in oracle]
    lines = [[[ln.text, ln.y] for ln in page] for page in decoded]
    banks = []
    for h in range(1, dopts.line_height + 1):
        b = build_prop_bank(face, PROP_ALPHABET, ropts, h)
        banks.append(prop_bank_from_arrays(
            b.alphabet, b.templates, b.colsq_cum, b.advances, b.base, b.ox, b.oy, b.crop_h))
    settings = grid_bank_settings(FONT, PROP_ALPHABET, ropts, dopts.width, "prop")
    out = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_prop_golden.npz"
    )
    savez_lzma(
        out,
        pages=pages,
        truths=np.array(json.dumps(truths)),
        lines=np.array(json.dumps(lines)),
        **grid_bank_arrays(banks, settings),
    )
    print(f"wrote {out}: {os.path.getsize(out)} bytes", file=sys.stderr)


if __name__ == "__main__":
    main()
