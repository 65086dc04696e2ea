"""Plain PyTorch reference of `focr` on a proportional font: the lines the CLI
must print for a page, worked out again from the page and the saved bank file.

Semantics (frozen; after the Rust original's greedy cursor decode,
main.rs:112-181 and 183-218, as focr_tpu/oracle/focr_oracle.py restates it):

  * line rows and crops as in reference/focr_grid.py: y = y_start + i *
    line_advance while the row's crop height min(line_height, H - y) > 0,
    the strip page[y : y + h, x0 : x0 + crop_w] inverted (255 - p);
  * an all-white strip prints nothing (main.rs:208-211);
  * a line starts with pos = 0 (f32) and steps while pos < crop_w: the
    cursor s = ox + pos in f32, t64 = floor(s * 64 + 0.5) (FreeType's 26.6
    rounding), the window column k = t64 >> 6 and the phase p = t64 & 63;
  * the window is the strip's columns [k - base, k - base + wbank), and
    each glyph g scores the plain sum of squared differences between the
    window and its template at phase p over the window's columns that lie
    inside the strip (the original compares the whole line canvas, whose
    other pixels add the same to every glyph's score);
  * the FIRST glyph of least score wins (Rust min_by_key, main.rs:159), and
    pos += advance[g] in f32;
  * the line is the chosen glyphs' characters in step order.

The squared differences are summed in float64, exact for these integers (a
score is at most h * wbank * 255**2). The bank file is the input the CLI is
given (``--grid-bank``): its templates at every phase, its advances, the
alphabet's origin and the canvas margin. Its column prefix sums are not
read. Every active line of every page takes its step at once, so a run's
reference is a few hundred small steps on the card.

Two controls, neither the reference: ``variant="precision"`` runs the
cursor in float16; ``variant="guarantee"`` prints the all-white rows too.
"""

from __future__ import annotations

import json

import numpy as np
import torch

CHUNK = 512  # lines scored at once: [CHUNK, G, h, wbank] float64 at a time


class PropBankFile:
    """The saved proportional bank set, one bank a crop height, read from its
    .npz."""

    def __init__(self, path: str):
        self._z = np.load(path, allow_pickle=False)
        self.settings = json.loads(str(self._z["grid_bank_settings"]))
        if self.settings["kind"] != "prop":
            raise ValueError(f"{path} is not a proportional bank set")
        self.alphabet = self.settings["alphabet"]
        self._banks: dict[int, tuple] = {}

    def bank(self, h: int) -> tuple[np.ndarray, np.ndarray, int, np.float32]:
        """(templates [G, 64, h, wbank] u8, advances [G] f32, base, ox f32)."""
        if h not in self._banks:
            z = self._z
            self._banks[h] = (
                z[f"prop_h{h}_templates"], z[f"prop_h{h}_advances"].astype(np.float32),
                int(z[f"prop_h{h}_base"][0]), np.float32(z[f"prop_h{h}_origin"][0]),
            )
        return self._banks[h]

    def n_steps(self, h: int, crop_w: int) -> int:
        """The steps a line's ids hold at most, as the program sizes them:
        ceil(crop_w / least advance) + 1."""
        return int(np.ceil(crop_w / float(self.bank(h)[1].min()))) + 1


def scan(strips: torch.Tensor, templates: torch.Tensor, advances: np.ndarray, base: int,
         ox: np.float32, cursor: torch.dtype = torch.float32) -> tuple[list[list[int]], list[int]]:
    """The greedy decode of every line at once: strips [L, h, crop_w] float64
    (inverted), templates [G, 64, h, wbank] float64 on the same device ->
    each line's glyph ids and its number of steps."""
    L, h, crop_w = strips.shape
    G, _, _, wbank = templates.shape
    dev = strips.device
    adv = torch.from_numpy(advances).to(dev, cursor)
    ox_t, w_t = torch.tensor(float(ox), dtype=cursor, device=dev), float(crop_w)
    c64 = torch.tensor(64.0, dtype=cursor, device=dev)
    half = torch.tensor(0.5, dtype=cursor, device=dev)
    cols = torch.arange(wbank, device=dev)
    glyph = torch.arange(G, device=dev)
    pos = torch.zeros(L, dtype=cursor, device=dev)
    ids: list[list[int]] = [[] for _ in range(L)]
    active = torch.arange(L, device=dev)
    while len(active):
        s = ox_t + pos[active]
        t64 = torch.floor(s * c64 + half).to(torch.int64)
        k, p = t64 >> 6, t64 & 63
        x = k[:, None] - base + cols  # [A, wbank] strip columns of the window
        inside = (x >= 0) & (x < crop_w)
        chosen = []
        for a in range(0, len(active), CHUNK):
            sl = slice(a, a + CHUNK)
            lines = active[sl]
            xs = x[sl].clamp(0, crop_w - 1)
            win = strips[lines[:, None, None], torch.arange(h, device=dev)[None, :, None],
                         xs[:, None, :]]  # [A, h, wbank]
            diff = win[:, None] - templates[:, p[sl]].permute(1, 0, 2, 3)  # [A, G, h, wbank]
            ssd = (diff * diff * inside[sl, None, None, :]).sum(dim=(2, 3))  # [A, G]
            least = ssd.min(dim=1, keepdim=True).values
            chosen.append(torch.where(ssd == least, glyph, G).min(dim=1).values)
        g = torch.cat(chosen)
        pos[active] = pos[active] + adv[g]
        for line, gi in zip(active.tolist(), g.tolist()):
            ids[line].append(gi)
        active = active[pos[active] < w_t]
    return ids, [len(r) for r in ids]


def expected_lines(pages: np.ndarray, bank_path: str, config: dict, device=None,
                   variant: str | None = None) -> tuple[list[list[str]], list[dict]]:
    """Every page's lines, and a per-page record for the per-layer readers:
    ``rows``, a [y, crop height, steps] for each row decoded."""
    dev = torch.device(device or "cpu")
    bank = PropBankFile(bank_path)
    grid = config["grid"]
    cursor = torch.float16 if variant == "precision" else torch.float32
    N, H, W = pages.shape
    x0 = min(grid["x"], W)
    crop_w = max(min(grid["width"], W - x0), 0)
    rows: dict[int, list[tuple[int, int]]] = {}  # crop height -> (page, y) of each row decoded
    i = 0
    while crop_w:
        y = grid["y"] + i * grid["line_advance"]
        i += 1
        h = min(grid["line_height"], H - min(y, H))
        if h <= 0:
            break
        inked = (pages[:, y : y + h, x0 : x0 + crop_w] != 255).any(axis=(1, 2))
        for n in range(N):
            if inked[n] or variant == "guarantee":
                rows.setdefault(h, []).append((n, y))
    decoded: dict[tuple[int, int], tuple[str, int, int]] = {}
    for h, at in rows.items():
        templates, advances, base, ox = bank.bank(h)
        strips = np.stack([255 - pages[n, y : y + h, x0 : x0 + crop_w].astype(np.int64)
                           for n, y in at])
        ids, steps = scan(torch.from_numpy(strips).to(dev, torch.float64),
                          torch.from_numpy(templates).to(dev, torch.float64),
                          advances, base, ox, cursor)
        for key, line, n in zip(at, ids, steps):
            decoded[key] = ("".join(bank.alphabet[g] for g in line), h, n)
    lines: list[list[str]] = [[] for _ in range(N)]
    stats: list[dict] = [{"rows": []} for _ in range(N)]
    for (n, y), (text, h, steps) in sorted(decoded.items()):
        lines[n].append(text)
        stats[n]["rows"].append([y, h, steps])
    return lines, stats
