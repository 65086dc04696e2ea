"""A NumPy model of K5's walk (csrc/focr_prop.cu), held against the plain
version prop_scan_reference, exactly.

The card kernel cannot run here, so what it computes with lanes over pixels
is modelled lane by lane: the host's re-layout of the templates into 4-byte
words (template_words: rows padded to ceil(wbank/4) words, each (phase,
glyph) padded to a multiple of 32 words), the window built in the same word
layout with 0 off the canvas and in the row padding, each lane's __dp4a
partial sums for the 32 glyphs of its warp's group, the reduce-scatter of
xor-shuffles that leaves lane l with glyph g0+l's dot, the (score, g)
first-minimum reductions inside a warp and across the warps of a line, and
the f32 cursor. A layout or reduction fault changes the ids.
"""

import os

import numpy as np
import pytest
import torch

from focr_tpu_torch.ops import prop_kernels as P

LANE = np.arange(32)
INT_MAX = 2**31 - 1
PROP_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                            "torch_prop_golden.npz")


def _dp4a(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Σ of the 4 byte products of two uint32 word arrays."""
    sh = 8 * np.arange(4, dtype=np.uint64)
    ab = (a.astype(np.uint64)[..., None] >> sh) & 0xFF
    bb = (b.astype(np.uint64)[..., None] >> sh) & 0xFF
    return (ab * bb).sum(-1).astype(np.int64)


def _reduce_scatter(v: np.ndarray) -> np.ndarray:
    """v [lane, j] of partial sums -> lane l's sum over lanes for item l, by
    the kernel's xor-shuffle halving (d = 16, 8, 4, 2, 1)."""
    v = v.copy()
    for d in (16, 8, 4, 2, 1):
        up = (LANE & d) != 0
        new = v.copy()
        for j in range(d):
            send = np.where(up, v[:, j], v[:, j + d])
            keep = np.where(up, v[:, j + d], v[:, j])
            new[:, j] = keep + send[LANE ^ d]
        v = new
    return v[:, 0]


def _first_min(s: np.ndarray, g: np.ndarray) -> tuple[int, int]:
    """The kernel's (score, g) xor-shuffle reduction over 32 lanes."""
    s, g = s.copy(), g.copy()
    for d in (16, 8, 4, 2, 1):
        os_, og = s[LANE ^ d], g[LANE ^ d]
        take = (os_ < s) | ((os_ == s) & (og < g))
        s, g = np.where(take, os_, s), np.where(take, og, g)
    assert (s == s[0]).all() and (g == g[0]).all()
    return int(s[0]), int(g[0])


def model_scan(strips, templates, colsq, adv, base, ox, n_steps):
    """csrc/focr_prop.cu's walk in NumPy: ids u8 [L, n_steps]."""
    L, h, crop_w = strips.shape
    G, _, _, wbank = templates.shape
    tw = P.template_words(torch.from_numpy(templates)).numpy().view(np.uint32)
    kwp = tw.shape[2]
    wb4 = -(-wbank // 4)
    kw = h * wb4
    assert kwp % 32 == 0 and kwp >= kw
    nwarps = min(-(-G // 32), 4)
    ids = np.full((L, n_steps), P.END_ID, np.uint8)
    f32 = np.float32
    for line in range(L):
        pos = f32(0.0)
        for step in range(n_steps):
            if not pos < f32(crop_w):
                break
            sx = f32(ox) + pos
            t64 = int(np.floor(sx * f32(64.0) + f32(0.5)))
            k, p = t64 >> 6, t64 & 63
            tlo, thi = min(max(base - k, 0), wbank), min(max(crop_w - k + base, 0), wbank)
            x0 = k - base
            # the window words, word m by thread m
            m = np.arange(kwp)
            y = m // wb4
            win = np.zeros(kwp, np.uint64)
            for j in range(4):
                c = 4 * (m - y * wb4) + j
                ok = (m < kw) & (c < wbank) & (c >= tlo) & (c < thi)
                px = strips[line, np.minimum(y, h - 1), np.clip(x0 + c, 0, crop_w - 1)]
                win |= np.where(ok, px, 0).astype(np.uint64) << np.uint64(8 * j)
            cands = []
            for warp in range(nwarps):
                best_s = np.full(32, INT_MAX, np.int64)
                best_g = np.full(32, G, np.int64)
                for g0 in range(32 * warp, G, 32 * nwarps):
                    gn = min(32, G - g0)
                    part = np.zeros((32, 32), np.int64)  # [lane, glyph j]
                    for c in range(0, kwp, 32):
                        wv = win[c + LANE]
                        for j in range(gn):
                            part[:, j] += _dp4a(wv, tw[p, g0 + j, c + LANE])
                    acc = _reduce_scatter(part)
                    g = g0 + LANE
                    gc = np.minimum(g, G - 1)
                    score = (colsq[gc, p, thi].astype(np.int64) - colsq[gc, p, tlo]) - 2 * acc
                    assert (np.abs(score) < 2**31).all()
                    take = (g < G) & (score < best_s)
                    best_s, best_g = np.where(take, score, best_s), np.where(take, g, best_g)
                cands.append(_first_min(best_s, best_g))
            bs, bg = cands[0]
            for s_, g_ in cands[1:]:
                if s_ < bs or (s_ == bs and g_ < bg):
                    bs, bg = s_, g_
            ids[line, step] = bg
            pos = f32(pos + adv[bg])
    return ids


def _synthetic(G, h, wbank, L, crop_w, seed):
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 256, (G, P.PHASES, h, wbank)).astype(np.uint8)
    templates[templates < 150] = 0
    if G > 2:
        templates[G - 1] = templates[1]  # a duplicated glyph: exact ties
    sq = (templates.astype(np.int64) ** 2).sum(axis=2)  # [G, 64, wbank]
    colsq = np.zeros((G, P.PHASES, wbank + 1), np.int32)
    colsq[..., 1:] = np.cumsum(sq, axis=-1)
    adv = rng.uniform(2.5, 9.0, G).astype(np.float32)
    strips = rng.integers(0, 256, (L, h, crop_w)).astype(np.uint8)
    strips[0] = 0  # a white line
    return strips, templates, colsq, adv, 3, 0.4


def _fixture(h, L, crop_w):
    from focr_tpu_torch.fonts.bank import load_grid_bank

    bank = load_grid_bank(PROP_FIXTURE)[0][h]
    with np.load(PROP_FIXTURE, allow_pickle=False) as z:
        page = 255 - z["pages"][0]
    strips = np.stack([page[39 + 15 * i : 39 + 15 * i + h, 45 : 45 + crop_w] for i in range(L)])
    return (np.ascontiguousarray(strips), bank.templates, bank.colsq_cum, bank.advances,
            bank.base, float(bank.ox))


def _check(strips, templates, colsq, adv, base, ox, n_steps):
    ids = model_scan(strips, templates, colsq, adv, base, ox, n_steps)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (strips, templates, colsq, adv)]
    ids_r = P.prop_scan_reference(*args, base, ox, n_steps).numpy()
    np.testing.assert_array_equal(ids, ids_r)
    return ids


@pytest.mark.parametrize("G,h,wbank,crop_w", [
    (1, 4, 7, 40),      # one glyph
    (33, 5, 9, 60),     # one glyph past a 32-glyph group
    (67, 3, 19, 50),    # the corpus' alphabet size; wbank not a multiple of 4
    (130, 2, 6, 30),    # 5 groups on 4 warps: a warp takes two
    (40, 6, 8, 7),      # a strip narrower than the window: it hangs past both ends
])
def test_scan_walk_matches_plain_version(G, h, wbank, crop_w):
    strips, templates, colsq, adv, base, ox = _synthetic(G, h, wbank, 3, crop_w, seed=G * h)
    ids = _check(strips, templates, colsq, adv, base, ox, n_steps=crop_w)
    assert (ids[1:] != P.END_ID).any()


@pytest.mark.parametrize("h", [12, 3])
def test_scan_walk_on_the_corpus_bank(h):
    """The prop corpus' bank (67 glyphs, 'A' and 'B' twice: exact ties) on
    the first page's lines, cut to 120 columns."""
    from focr_tpu_torch.fonts.bank import load_grid_bank
    from focr_tpu_torch.models.focr_prop import max_steps

    strips, templates, colsq, adv, base, ox = _fixture(h, 3, 120)
    n_steps = max_steps(load_grid_bank(PROP_FIXTURE)[0][h], 120)
    ids = _check(strips, templates, colsq, adv, base, ox, n_steps)
    assert (ids != P.END_ID).sum() > 10


@pytest.mark.parametrize("G,h,wbank", [(67, 12, 19), (67, 3, 19), (1, 1, 1), (33, 5, 8)])
def test_template_words(G, h, wbank):
    """Byte j of word (p, g, m) is template column 4q + j of row y, (y, q) =
    divmod(m, ceil(wbank/4)); 0 past wbank, past the last row and in the
    padding to a multiple of 32 words; every template byte appears once."""
    rng = np.random.default_rng(G + h)
    templates = rng.integers(1, 256, (G, P.PHASES, h, wbank)).astype(np.uint8)
    tw = P.template_words(torch.from_numpy(templates)).numpy().view(np.uint32)
    wb4 = -(-wbank // 4)
    assert tw.shape == (P.PHASES, G, -(-h * wb4 // 32) * 32)
    by = (tw[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF  # [64, G, kwp, 4]
    want = np.zeros_like(by)
    for y in range(h):
        for c in range(wbank):
            want[:, :, y * wb4 + c // 4, c % 4] = templates[:, :, y, c].T
    np.testing.assert_array_equal(by, want)
    assert int((by != 0).sum()) == templates.size
