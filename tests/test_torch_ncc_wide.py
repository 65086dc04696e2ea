"""The ncc sweep's wide tier (focr_tpu's XLA tier: needles with n·65025 >= 2²⁴,
or thr−ε <= 0) on the CPU, against focr_tpu: the port's NccMatcher hits equal
focr_tpu's hit for hit (x, y, w, h, f32 similarity bytes, scan order), and at
the ops level the port's candidate set holds every window that focr_tpu's
ncc_candidates + exact replay accepts."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models import ncc as jax_ncc
from focr_tpu.models.types import BoxSize, DecodeOptions, NCC_DEFAULT_ALPHABET, RenderOptions
from focr_tpu.ops import ncc as jax_ncc_ops
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.models import ncc as torch_ncc
from focr_tpu_torch.models.types import BoxSize as TBoxSize, RenderOptions as TRenderOptions
from focr_tpu_torch.ops import ncc_kernels
from focr_tpu_torch.ops.ncc import word_stride

torch.set_num_threads(2)

ALPHA = "AB01ab"


@pytest.fixture(scope="module")
def faces(mono_font_path):
    return Face(mono_font_path), TFace(mono_font_path)


def key(hits):
    return [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hits]


def _page(faces, size, lines, shape, alphabet):
    dopts = DecodeOptions(x_start=6, y_start=5, line_height=size + 4, line_advance=size + 8,
                          width=shape[1] - 12)
    return synthesize_page(faces[0], lines, dopts, RenderOptions(size=size), alphabet, shape)


@pytest.mark.parametrize(
    "size,threshold,x_bits,alphabet",
    [(20.0, 0.8, 0, NCC_DEFAULT_ALPHABET), (24.0, 0.8, 1, NCC_DEFAULT_ALPHABET),
     (13.0, 0.0005, 0, ALPHA), (20.0, -0.3, 0, ALPHA)],
    ids=["t20", "t24-xbits1", "thr-below-eps", "t20-negative-thr"],
)
def test_matcher_matches_focr_tpu(faces, size, threshold, x_bits, alphabet):
    """-t 20 and -t 24 DejaVu Sans Mono needles (21x13 and 25x15 for the
    default alphabet: n·65025 >= 2²⁴) and thresholds at or below ε: the
    port's NccMatcher equals focr_tpu's (its XLA tier) and, with needles no
    wider than 16, the oracle."""
    page = _page(faces, size, ["AB01", "ba10"], (90, 150), alphabet)
    kw = dict(x_bits=x_bits, threshold=threshold)
    jm = jax_ncc.NccMatcher(faces[0], alphabet, RenderOptions(size=size),
                            box_size=BoxSize.ALPHABET, **kw)
    tm = torch_ncc.NccMatcher(faces[1], alphabet, TRenderOptions(size=size),
                              box_size=TBoxSize.ALPHABET, device="cpu", **kw)
    assert all(ncc_kernels.sweep_tier(g.nh * g.nw, threshold) == "wide" for g in tm.groups)
    if size == 20.0 and alphabet == NCC_DEFAULT_ALPHABET:
        assert {(g.nh, g.nw) for g in tm.groups} == {(21, 13)}
    got = tm.get_hits(page)
    assert len(got) > 0
    assert key(got) == key(jm.get_hits(page))
    if max(g.nw for g in tm.groups) <= 16:
        assert key(got) == key(tm.get_hits_oracle(page))


def _planted(seed, nh, nw, H=72, W=120, T=3):
    """tests/test_wide_needles.py:43-54's pages: noise with three planted
    copies of each needle."""
    rng = np.random.default_rng(seed)
    page = rng.integers(150, 256, (H, W), dtype=np.uint8)
    needles = rng.integers(0, 140, (T, nh, nw), dtype=np.uint8)
    for t in range(T):
        for (x, y) in [(3 + 11 * t, 5), (40, 20 + 9 * t), (70, 50)]:
            page[y : y + nh, x : x + nw] = 255 - needles[t]
    return page, needles


@pytest.mark.parametrize(
    "seed,nh,nw,thr",
    [(0, 8, 17, 0.8), (1, 11, 24, 0.7), (2, 6, 32, 0.9), (3, 21, 13, 0.8), (4, 21, 13, 0.0)],
)
def test_candidates_hold_focr_tpu_accepts(seed, nh, nw, thr):
    """The port's sweep (plain version) holds every position focr_tpu's
    ncc_candidates + exact_similarities accept, and replaying the port's
    candidates exactly gives the same hits in scan order."""
    page, needles = _planted(seed, nh, nw)
    T, H, W = needles.shape[0], *page.shape
    n = nh * nw
    inv = (255 - page.astype(np.int32)).astype(np.uint8)
    s_n = needles.reshape(T, -1).astype(np.int64).sum(1)
    s2_n = (needles.reshape(T, -1).astype(np.int64) ** 2).sum(1)
    idx, acc, sp, s2p, counts = (
        np.asarray(o) for o in jax_ncc_ops.ncc_candidates(
            jnp.asarray(inv), jnp.asarray(needles), jnp.asarray(s_n), jnp.asarray(s2_n),
            jnp.asarray(np.float32(thr)), nw=nw, nh=nh, cap=H * W,
        )
    )
    mask, rcnt = ncc_kernels.ncc_sweep(
        *(torch.from_numpy(a) for a in (inv[None], needles, s_n, s2_n)), thr)
    pos, off, hcnt, _ = (t.numpy() for t in ncc_kernels.compact_hits(mask, rcnt))
    W1 = word_stride(W, nw) * 32
    wins = np.lib.stride_tricks.sliding_window_view(inv.astype(np.int64), (nh, nw))
    thr64 = np.float64(np.float32(thr))
    ends = np.cumsum(hcnt[0].astype(np.int64))
    for t in range(T):
        c = slice(0, int(counts[t]))
        sim = torch_ncc.exact_similarities(
            acc[t, c], sp[t, c], s2p[t, c], int(s_n[t]), int(s2_n[t]), n)
        keep = (sim != np.inf) & (sim > thr64)
        lin = idx[t, c][keep].astype(np.int64)  # over the (y >= 1, x >= 1) domain
        want = [(int(1 + v % (W - nw)), int(1 + v // (W - nw)), np.float32(s).tobytes())
                for v, s in zip(lin, sim[keep])]
        assert len(want) > 0, "planted matches must be found"
        mine = pos[ends[t] - hcnt[0, t] : ends[t]].astype(np.int64)
        ys, xs = mine // W1, mine % W1
        assert {(x, y) for x, y, _ in want} <= set(zip(xs.tolist(), ys.tolist()))
        w = wins[ys, xs]
        msim = torch_ncc.exact_similarities(
            (w * needles[t].astype(np.int64)).sum(axis=(1, 2)), w.sum(axis=(1, 2)),
            (w * w).sum(axis=(1, 2)), int(s_n[t]), int(s2_n[t]), n)
        mkeep = (msim != np.inf) & (msim > thr64)
        got = [(int(x), int(y), np.float32(s).tobytes())
               for x, y, s in zip(xs[mkeep], ys[mkeep], msim[mkeep])]
        assert got == want


@pytest.mark.parametrize("T,nh,nw", [(3, 150, 150), (9, 21, 13), (8, 5, 4)])
def test_needle_words_layout(T, nh, nw):
    """The needle words the kernel's A fragments carry, read back word by
    word: k-word w = dy·ceil(nw/4) + q of needle t holds needle[t][dy][4q + k]
    in byte k, 0 past nw, past the last word and past T."""
    rng = np.random.default_rng(T)
    needles = rng.integers(0, 256, (T, nh, nw), dtype=np.uint8)
    frags = ncc_kernels.pack_needle_fragments(torch.from_numpy(needles)).numpy().view(np.uint32)
    nks, nw4 = ncc_kernels.k_steps(nh, nw), -(-nw // 4)
    assert frags.shape == (-(-T // 16), nks, 32, 4)
    # lane 4g + tq, register i: needle 16·mt + g + 8(i & 1), k-word 8s + tq + 4(i >> 1)
    mt, s, lane, i = np.meshgrid(*map(np.arange, frags.shape), indexing="ij")
    t = 16 * mt + (lane >> 2) + 8 * (i & 1)
    w = 8 * s + (lane & 3) + 4 * (i >> 1)
    want = np.zeros_like(frags)
    for k in range(4):
        dy, dx = w // nw4, 4 * (w % nw4) + k
        real = (t < T) & (dy < nh) & (dx < nw)
        byte = needles[np.minimum(t, T - 1), np.minimum(dy, nh - 1), np.minimum(dx, nw - 1)]
        want |= np.where(real, byte, 0).astype(np.uint32) << 8 * k
    np.testing.assert_array_equal(frags, want)
