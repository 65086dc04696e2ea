"""Regenerate tests/fixtures/torch_ncc_golden.npz (run from the repo root).

The golden for the PyTorch port's ncc slice, made by the reference package
(focr_tpu, on the CPU) from bench.py's dense ncc corpus (bench.py:260-316:
DejaVu Sans Mono 13, the 74-letter default alphabet, --x-bits 2, 792x662
letter pages of 48 lines x 77 characters, text from seed 7):

  pages     u8 [16, 792, 662] — the corpus' first 16 pages
  truths    JSON: the text lines each page was rendered from
  lines     JSON: focr_tpu's process_hits_text(..., 0.95, 5) lines for the
            first two pages (the reference output the port must reproduce)
  g{k}_bank, g{k}_s_n, g{k}_s2_n, g{k}_ids — each needle-size group as
            focr_tpu's _group_needles builds it
  and a saved needle bank (fonts/bank.py::load_needle_bank reads the file)

Machines without FreeType (or Pillow) can run the port on it. Regenerate only
after a deliberate change to the corpus or the font layer.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
N_PAGES = 16
N_EXPECTED = 2  # pages with recorded reference lines (~25 s each on a CPU)


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from focr_tpu.fonts.ft import Face
    from focr_tpu.io.synth import random_text_lines, synthesize_page
    from focr_tpu.models.ncc import NccMatcher
    from focr_tpu.models.post import process_hits_text
    from focr_tpu.models.types import BoxSize, DecodeOptions, NCC_DEFAULT_ALPHABET, RenderOptions
    from focr_tpu_torch.fonts.bank import bank_settings, needle_bank_arrays

    face = Face(FONT)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    rng = np.random.default_rng(7)
    truths = [random_text_lines(rng, NCC_DEFAULT_ALPHABET, 48, 77) for _ in range(N_PAGES)]
    pages = np.stack([
        synthesize_page(face, t, dopts, ropts, NCC_DEFAULT_ALPHABET, (792, 662))
        for t in truths
    ])
    matcher = NccMatcher(face, NCC_DEFAULT_ALPHABET, ropts, x_bits=2)
    lines = matcher.get_hits_many(
        list(pages[:N_EXPECTED]), struct=True,
        post=lambda hs: process_hits_text(hs, 0.95, 5),
    )
    settings = bank_settings(
        FONT, NCC_DEFAULT_ALPHABET, ropts, BoxSize.ALPHABET, 2, 0, (0, 0)
    )
    arrays = needle_bank_arrays(matcher.needles, settings)
    for k, g in enumerate(matcher.groups):
        arrays[f"g{k}_bank"] = g.bank
        arrays[f"g{k}_s_n"] = g.s_n
        arrays[f"g{k}_s2_n"] = g.s2_n
        arrays[f"g{k}_ids"] = np.array(g.needle_ids, dtype=np.int32)
    out = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_ncc_golden.npz"
    )
    np.savez_compressed(
        out,
        pages=pages,
        truths=np.array(json.dumps(truths)),
        lines=np.array(json.dumps(lines)),
        n_groups=np.array(len(matcher.groups)),
        **arrays,
    )
    print(f"wrote {out}: {os.path.getsize(out)} bytes", file=sys.stderr)


if __name__ == "__main__":
    main()
