"""Regenerate tests/fixtures/torch_focr_golden.npz (run from the repo root).

The golden for the PyTorch port's focr slice, made by the reference package
(focr_tpu, on the CPU) from bench.py's focr corpus (bench.py:59-93: DejaVu
Sans Mono 13, the 67-glyph default alphabet, grid -x 45 -y 39 -w 608
--line-height 12 --line-advance 15, 792x662 pages of 48 lines x 77
characters, text from seed 42):

  pages     u8 [16, 792, 662] — the corpus' first 16 pages
  truths    JSON: the text lines each page was rendered from
  lines     JSON: focr_tpu's GridDecoder lines, [[text, y], ...] per page
  and a saved grid bank (fonts/bank.py::load_grid_bank reads the file):
  focr_tpu's build_grid_bank for crop heights 1..12 at crop width 608

Machines without FreeType (or Pillow) can run the port on it. The members are
LZMA-compressed (np.load reads them): deflate, as np.savez_compressed uses,
makes the file twice as large. Regenerate only after a deliberate change to
the corpus or the font layer.
"""

from __future__ import annotations

import json
import os
import sys
import zipfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
N_PAGES = 16
SHAPE = (792, 662)


def savez_lzma(path: str, **arrays: np.ndarray) -> None:
    """np.savez with LZMA-compressed members."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_LZMA) as zf:
        for name, a in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(a), allow_pickle=False)


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from focr_tpu.fonts.bank import build_grid_bank
    from focr_tpu.fonts.ft import Face
    from focr_tpu.io.synth import random_text_lines, synthesize_page
    from focr_tpu.models.focr import GridDecoder
    from focr_tpu.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions
    from focr_tpu_torch.fonts.bank import grid_bank_arrays, grid_bank_settings

    face = Face(FONT)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    rng = np.random.default_rng(42)
    text_alpha = FOCR_DEFAULT_ALPHABET.replace(" ", "A").replace(">", "B")
    truths = [random_text_lines(rng, text_alpha, 48, 77) for _ in range(N_PAGES)]
    pages = np.stack([
        synthesize_page(face, t, dopts, ropts, FOCR_DEFAULT_ALPHABET, SHAPE) for t in truths
    ])
    dec = GridDecoder(face, FOCR_DEFAULT_ALPHABET, dopts, ropts, SHAPE)
    lines = [[[ln.text, ln.y] for ln in page] for page in dec.decode_batch(pages)]
    banks = [
        build_grid_bank(face, FOCR_DEFAULT_ALPHABET, ropts, dopts.width, h)
        for h in range(1, dopts.line_height + 1)
    ]
    settings = grid_bank_settings(FONT, FOCR_DEFAULT_ALPHABET, ropts, dopts.width)
    out = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_focr_golden.npz"
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
