"""Plain NumPy reference of `focr` on a monospace grid: the lines the CLI must
print for a page, worked out again from the page and the saved bank file.

Semantics (frozen; copied from focr_tpu/models/focr.py and
focr_tpu/oracle/focr_oracle.py::decode_image, which follow the Rust
original's main.rs:87-239):

  * line rows at y = y_start + i * line_advance while y < H; a row's crop
    height is min(line_height, H - y), and a row of height <= 0 ends the scan;
  * the strip is page[y : y + h, x0 : x0 + crop_w] with x0 = min(x_start, W)
    and crop_w = max(min(width, W - x0), 0), inverted (255 - p);
  * an all-white strip prints nothing (main.rs:208-211);
  * every cell c of the bank for height h scores every glyph g with the
    exact integer metric tsq[c, g] - 2 * sum(window * template[c, g]), the
    window being the strip's columns [wx0[c], wx0[c] + win_w) (zero past the
    strip); the FIRST minimum wins (Rust min_by_key, main.rs:159);
  * the line is the glyphs' characters, one a cell, in cell order.

The products run in float64, exact for integers below 2**53 (a window's sum
is at most win_h * win_w * 255**2). The bank file is the input the CLI is
given (``--grid-bank``); nothing the program derived from it is read.

Two controls, neither the reference: ``variant="precision"`` keeps only the
top 4 bits of every pixel and template value (int4 for the u8 data);
``variant="guarantee"`` prints the all-white rows too.
"""

from __future__ import annotations

import json

import numpy as np


class GridBankFile:
    """The saved grid bank set, one bank a crop height, read from its .npz."""

    def __init__(self, path: str):
        self._z = np.load(path, allow_pickle=False)
        self.settings = json.loads(str(self._z["grid_bank_settings"]))
        self.alphabet = self.settings["alphabet"]
        self._banks: dict[int, tuple] = {}

    def bank(self, h: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(templates [C, G, h, win_w] f64, tsq [C, G] i64, wx0 [C] i64)."""
        if h not in self._banks:
            z = self._z
            self._banks[h] = (
                z[f"grid_h{h}_templates"].astype(np.float64),
                z[f"grid_h{h}_tsq"].astype(np.int64),
                z[f"grid_h{h}_wx0"].astype(np.int64),
            )
        return self._banks[h]


def decode_page(page: np.ndarray, bank: GridBankFile, grid: dict,
                control_bits: int = 8, white_rows: bool = False) -> list[str]:
    """The text lines `focr` prints for one u8 page [H, W]."""
    H, W = page.shape
    x0 = min(grid["x"], W)
    crop_w = max(min(grid["width"], W - x0), 0)
    codes = np.array([ord(c) for c in bank.alphabet])
    drop = 8 - control_bits
    lines = []
    i = 0
    while True:
        y = grid["y"] + i * grid["line_advance"]
        i += 1
        h = min(grid["line_height"], H - min(y, H))
        if h <= 0:
            break
        inv = 255 - page[y : y + h, x0 : x0 + crop_w].astype(np.int64)
        if crop_w == 0 or not (inv.any() or white_rows):
            continue
        templates, tsq, wx0 = bank.bank(h)
        C, G, _, win_w = templates.shape
        if drop:
            inv = (inv >> drop) << drop
            templates = np.floor(templates / 2**drop) * 2**drop
            tsq = (templates.astype(np.int64) ** 2).sum(axis=(2, 3))
        padded = np.zeros((h, crop_w + win_w), np.float64)
        padded[:, :crop_w] = inv
        cols = wx0[:, None] + np.arange(win_w)[None, :]  # [C, win_w]
        wins = padded[:, cols].transpose(1, 0, 2).reshape(C, 1, h * win_w)  # [C, 1, n]
        corr = np.matmul(wins, templates.reshape(C, G, h * win_w).transpose(0, 2, 1))[:, 0]
        metric = tsq - 2 * corr.astype(np.int64)  # [C, G]
        ids = metric.argmin(axis=1)  # the first minimum
        lines.append("".join(map(chr, codes[ids])))
    return lines


def expected_lines(pages: np.ndarray, bank_path: str, config: dict, device=None,
                   variant: str | None = None) -> tuple[list[list[str]], list[dict]]:
    """Every page's lines, and a per-page record for the per-layer readers
    (empty: the focr readers count from the pages' shapes alone)."""
    bank = GridBankFile(bank_path)
    bits = 4 if variant == "precision" else 8
    return ([decode_page(p, bank, config["grid"], bits, variant == "guarantee") for p in pages],
            [{} for _ in pages])
