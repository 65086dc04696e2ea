"""Plain reference of `ncc`: the lines the CLI must print for a page, worked
out again from the page and the saved needle bank file, in plain PyTorch
(float64, on the card in the benchmark, on the CPU in its tests) and NumPy.

Semantics (frozen; copied from focr_tpu/oracle/ncc_direct.py::direct_search,
focr_tpu/models/ncc.py::exact_similarities and focr_tpu/models/post.py, which
follow the Rust original's ncc.rs:128-786 and ncc.cpp:48-251):

  * the page is inverted (255 - p); every needle of the bank, in the bank's
    order, is tried at every window (x, y) with 1 <= x <= W - nw and
    1 <= y <= H - nh; a needle as wide or as tall as the page finds nothing;
  * a window's statistics are exact integers: acc = sum(window * needle),
    sp = sum(window), s2p = sum(window**2); the similarity is the reference
    C kernel's scalar-tail formula in float64, each operation rounded once:
        rnorm_n = 1 / sqrt(s2_n - s_n * s_n / n)
        rnorm_p = 1 / sqrt(s2p - sp * sp / n)
        num     = acc - (s_n * sp) * (1 / n)
        sim     = num * (rnorm_n * rnorm_p)
    and a window is a hit iff sim != +inf and sim > f64(f32(threshold));
  * a needle keeps its first MAX_MATCHES hits in row-major scan order;
  * post-processing (README.md:48-52): keep the rows y that hold a hit with
    f32(sim) >= f32(anchor_threshold); stable-sort the kept hits by (y, x);
    cut each row into runs anchored at their first hit (x - x_first <=
    overlap); the LAST hit of greatest f32 similarity wins its run; a row
    prints the winners' letters.

The window sums run as float64 matrix products and sums, exact for integers
below 2**53. Divisions are by tensors, never by a Python number (PyTorch
multiplies by the reciprocal then), so every operation is IEEE's own.

Two controls, neither the reference: ``variant="precision"`` computes the
similarity in float32; ``variant="guarantee"`` leaves out the anchor filter,
so rows with no anchor hit print too.
"""

from __future__ import annotations

import json

import numpy as np
import torch

MAX_MATCHES = 1024  # ncc.cpp:222-229
DEFAULTS = {"threshold": 0.8, "anchor_threshold": 0.95, "overlap": 5}  # ncc.rs CLI defaults


class NeedleFile:
    """The saved needle bank: letters and pixels in the bank's order."""

    def __init__(self, path: str):
        with np.load(path, allow_pickle=False) as z:
            self.settings = json.loads(str(z["bank_settings"]))
            self.letters = [str(c) for c in z["letters"]]
            shapes, blob = z["shapes"], z["pixels"]
        self.pixels = []
        off = 0
        for h, w in shapes.tolist():
            self.pixels.append(blob[off : off + h * w].reshape(h, w))
            off += h * w
        # needles of one shape, in bank order within the group
        self.groups: dict[tuple[int, int], list[int]] = {}
        for i, px in enumerate(self.pixels):
            self.groups.setdefault(px.shape, []).append(i)


def _similarity(acc, sp, s2p, s_n, s2_n, n: int, dtype):
    """The scalar-tail formula, operation by operation, in ``dtype``."""
    acc, sp, s2p = acc.to(dtype), sp.to(dtype), s2p.to(dtype)
    s_n, s2_n = s_n.to(dtype), s2_n.to(dtype)
    n_recip = torch.ones((), dtype=dtype, device=sp.device) / torch.full(
        (), n, dtype=dtype, device=sp.device)
    rnorm_n = torch.ones_like(s_n) / torch.sqrt(s2_n - s_n * s_n / torch.full_like(s_n, n))
    rnorm_p = torch.ones_like(sp) / torch.sqrt(s2p - sp * sp / torch.full_like(sp, n))
    num = acc - (s_n[None, :] * sp[:, None]) * n_recip
    return num * (rnorm_n[None, :] * rnorm_p[:, None])


def page_hits(page: np.ndarray, nf: NeedleFile, threshold: float, device,
              control: bool = False, rows_a_block: int = 64):
    """Every hit of every needle on one u8 page [H, W]: (needle id, x, y,
    f32 similarity) arrays in bank order, each needle's in scan order, and
    per size group (nh, nw, needles, hits before the cap, hits kept)."""
    H, W = page.shape
    dtype = torch.float32 if control else torch.float64
    thr = float(np.float32(threshold))
    inv = torch.from_numpy(255 - page.astype(np.int64)).to(device, torch.float64)
    parts, groups = [], []
    for (nh, nw), ids in nf.groups.items():
        if nh >= H or nw >= W:
            continue
        n = nh * nw
        bank = torch.from_numpy(np.stack([nf.pixels[i].reshape(-1) for i in ids])).to(
            device, torch.float64)  # [T, n]
        s_n, s2_n = bank.sum(1), (bank * bank).sum(1)
        Y, X = H - nh + 1, W - nw + 1
        found = []
        for y0 in range(0, Y, rows_a_block):
            rb = min(rows_a_block, Y - y0)
            rows = inv[y0 : y0 + rb + nh - 1][None, None]
            win = torch.nn.functional.unfold(rows, (nh, nw))[0].T  # [rb * X, n]
            acc = win @ bank.T
            sp, s2p = win.sum(1), (win * win).sum(1)
            sim = _similarity(acc, sp, s2p, s_n, s2_n, n, dtype)  # [rb * X, T]
            emit = (sim != float("inf")) & (sim > thr)
            emit = emit.view(rb, X, -1)
            emit[:, 0] = False  # x = 0 is outside the scan (ncc.cpp:98)
            if y0 == 0:
                emit[0] = False  # so is y = 0 (ncc.rs:279)
            r, x, t = emit.nonzero(as_tuple=True)
            found.append((torch.stack([t, r + y0, x]).cpu().numpy(),
                          sim.view(rb, X, -1)[r, x, t].to(torch.float32).cpu().numpy()))
        tyx = np.concatenate([f[0] for f in found], axis=1)
        sims = np.concatenate([f[1] for f in found])
        order = np.lexsort((tyx[2], tyx[1], tyx[0]))  # needle, then scan order
        t, y, x, sims = tyx[0][order], tyx[1][order], tyx[2][order], sims[order]
        starts = np.searchsorted(t, np.arange(len(ids)))
        rank = np.arange(len(t)) - starts[t]
        keep = rank < MAX_MATCHES
        gids = np.asarray(ids)[t[keep]]
        parts.append((gids, x[keep], y[keep], sims[keep]))
        groups.append({"nh": nh, "nw": nw, "needles": len(ids), "hits": int(len(t)),
                       "kept": int(keep.sum())})
    if parts:
        nid = np.concatenate([p[0] for p in parts])
        order = np.argsort(nid, kind="stable")  # bank order across the groups
        hits = tuple(np.concatenate([p[k] for p in parts])[order] for k in range(4))
    else:
        hits = (np.zeros(0, np.int64),) * 3 + (np.zeros(0, np.float32),)
    return hits, groups


def post_lines(hits, letters: list[str], anchor_threshold: float, overlap: int,
               anchors: bool = True) -> list[str]:
    """README.md:48-52's three steps on one page's hits."""
    nid, x, y, sim = hits
    anchor = np.float32(anchor_threshold)
    keep = np.isin(y, np.unique(y[sim >= anchor])) if anchors else np.ones(len(y), bool)
    nid, x, y, sim = nid[keep], x[keep], y[keep], sim[keep]
    order = np.lexsort((x, y))  # stable: by y, then x, then engine order
    nid, x, y, sim = nid[order], x[order], y[order], sim[order]
    lines = []
    bounds = np.flatnonzero(np.diff(y)) + 1
    for a, b in zip(np.r_[0, bounds], np.r_[bounds, len(y)]):
        xs, ss = x[a:b], sim[a:b]
        text = []
        i = 0
        while i < len(xs):
            j = int(np.searchsorted(xs, xs[i] + overlap, side="right"))
            run = ss[i:j]
            win = i + len(run) - 1 - int(np.argmax(run[::-1]))  # the last maximum
            text.append(letters[nid[a + win]])
            i = j
        lines.append("".join(text))
    return lines


def expected_lines(pages: np.ndarray, bank_path: str, config: dict, device="cuda",
                   variant: str | None = None) -> tuple[list[list[str]], list[dict]]:
    """Every page's lines, and per page its size groups' hit counts (the K3
    reader counts the replay's work from them) and its hits (``page_hits``'s
    arrays, which the check holds the program's to)."""
    nf = NeedleFile(bank_path)
    opts = {**DEFAULTS, **config.get("ncc", {})}
    lines, stats = [], []
    for page in pages:
        hits, groups = page_hits(page, nf, opts["threshold"], device, variant == "precision",
                                 256 if str(device).startswith("cuda") else 64)
        lines.append(post_lines(hits, nf.letters, opts["anchor_threshold"], opts["overlap"],
                                anchors=variant != "guarantee"))
        stats.append({"groups": groups, "hits": hits})
    return lines, stats
