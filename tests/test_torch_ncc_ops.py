"""focr_tpu_torch's ncc ops against focr_tpu's, on the CPU, exactly.

window_stats against focr_tpu.ops.ncc.window_stats; the sweep's plain
PyTorch version (the CUDA kernel's reference) against the Pallas kernel run in
interpret mode (pallas_ncc._sweep_impl), bit plane for bit plane and count for
count; the compaction's plain version against the XLA compaction
(pallas_ncc._compact_hits) with a cap above the candidate count.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from focr_tpu.ops import pallas_ncc
from focr_tpu.ops.ncc import window_stats as jax_window_stats
from focr_tpu_torch.ops import ncc_kernels
from focr_tpu_torch.ops.ncc import window_stats, word_stride

torch.set_num_threads(2)


def _planted(seed, nh, nw, B=2, H=72, W=101, T=6):
    """tests/test_pallas_ncc.py:52's pages (u8 noise with planted needles),
    two pages per case."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 40, (B, H, W), dtype=np.uint8)
    needles = rng.integers(0, 255, (T, nh, nw), dtype=np.uint8)
    for b in range(B):
        for t, (x, y) in enumerate([(5, 9), (40, 30), (70, 50)]):
            imgs[b, y + b : y + b + nh, x + 3 * b : x + 3 * b + nw] = needles[(t + b) % T]
    return imgs, needles


def _flat(seed, nh, nw):
    """Near-zero variance on both sides: a flat page block with one pixel
    off, a zero-variance needle (rtn = +inf) and a near-uniform one."""
    imgs, needles = _planted(seed, nh, nw)
    imgs[:, 20:40, 10:60] = 128
    imgs[:, 25, 30] = 129
    needles[0] = 7
    needles[1] = 100
    needles[1, 0, 0] = 101
    imgs[0, 50 : 50 + nh, 60 : 60 + nw] = needles[1]
    return imgs, needles


CASES = {
    "s0-7x6": (_planted, 0, 7, 6, 0.8),
    "s1-9x13": (_planted, 1, 9, 13, 0.3),
    "s2-4x16": (_planted, 2, 4, 16, 0.5),
    "s3-12x8": (_planted, 3, 12, 8, 0.3),
    "flat-13x9": (_flat, 4, 13, 9, 0.3),
    "wide-5x17": (_planted, 5, 5, 17, 0.4),
}
_JAX_CACHE: dict = {}


def _inputs(case):
    make, seed, nh, nw, thr = CASES[case]
    imgs, needles = make(seed, nh, nw)
    T = needles.shape[0]
    s_n = needles.reshape(T, -1).astype(np.int64).sum(1)
    s2_n = (needles.reshape(T, -1).astype(np.int64) ** 2).sum(1)
    return imgs, needles, s_n, s2_n, thr


def _jax_sweep(case):
    """(mask_hw [B, Hs8, Tp, W1/16] u16, rcnt_tm [B, Tp, Hs8], Hs8, Tp) from
    the Pallas kernel in interpret mode, computed once per case."""
    if case not in _JAX_CACHE:
        imgs, needles, s_n, s2_n, thr = _inputs(case)
        nh, nw = needles.shape[1:]
        _JAX_CACHE[case] = jax.device_get(
            pallas_ncc._sweep_impl(
                jnp.asarray(imgs), jnp.asarray(needles), jnp.asarray(s_n),
                jnp.asarray(s2_n), jnp.asarray(np.float32(thr)), nw, nh, 1e-3, True,
            )
        )
    return _JAX_CACHE[case]


def _torch_sweep(case):
    imgs, needles, s_n, s2_n, thr = _inputs(case)
    return ncc_kernels.ncc_sweep(
        *(torch.from_numpy(a) for a in (imgs, needles, s_n, s2_n)), thr
    )


def _bits(words: np.ndarray, width: int) -> np.ndarray:
    """[..., G] words of ``width`` bits -> bool [..., G*width], bit k of word
    g at index g*width + k."""
    w = words.astype(np.int64)[..., None] >> np.arange(width)
    return (w & 1).astype(bool).reshape(*words.shape[:-1], -1)


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_reference_matches_pallas_interpret(case):
    imgs, needles, _, _, _ = _inputs(case)
    B, H, W = imgs.shape
    T, nh, nw = needles.shape
    Hs = H - nh + 1
    mask_hw, rcnt_tm, _, _ = _jax_sweep(case)
    mask, rcnt = _torch_sweep(case)
    W1 = word_stride(W, nw) * 32
    assert mask.shape == (B, T, Hs, W1 // 32) and mask.dtype == torch.int32
    want = _bits(mask_hw, 16)[:, :Hs, :T].transpose(0, 2, 1, 3)  # [B, T, Hs, W1]
    got = _bits(mask.numpy(), 32)
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rcnt.numpy(), rcnt_tm[:, :T, :Hs])
    assert rcnt.numpy().sum() == got.sum()
    assert got.sum() > 0  # every case has candidates


@pytest.mark.parametrize("case", list(CASES))
def test_compact_reference_matches_xla_compaction(case):
    imgs, needles, _, _, _ = _inputs(case)
    B, H, W = imgs.shape
    T = needles.shape[0]
    mask_hw, rcnt_tm, Hs8, Tp = _jax_sweep(case)
    WB = word_stride(W, needles.shape[2]) * 4
    caph = int(rcnt_tm.sum(axis=(1, 2)).max()) + 64
    jpos, jhcnt, jnz = jax.device_get(
        jax.jit(
            pallas_ncc._compact_hits, static_argnums=(2, 3, 4, 5, 6, 7)
        )(jnp.asarray(mask_hw), jnp.asarray(rcnt_tm), B, T, Tp, Hs8, WB, caph)
    )
    pos, off, hcnt, nz = ncc_kernels.compact_hits(*_torch_sweep(case))
    np.testing.assert_array_equal(hcnt.numpy(), jhcnt)
    np.testing.assert_array_equal(nz.numpy(), jnz)
    for b in range(B):
        np.testing.assert_array_equal(
            pos[off[b] : off[b + 1]].numpy(), jpos[b, : int(jnz[b])]
        )
    assert pos.dtype == torch.int32 and int(off[-1]) == int(jnz.sum())


@pytest.mark.parametrize("case", list(CASES))
def test_compact_counts_reference_matches_old_arithmetic(case):
    """The count kernel's plain version gives the row offsets, off, hcnt and
    nz that the compaction wrapper computed before the count kernel (two
    cumsums over each page's rows, a subtraction, two sums), and its head
    buffer splits into them."""
    mask, rcnt = _torch_sweep(case)
    B, T, Hs = rcnt.shape
    incl = torch.cumsum(rcnt.reshape(B, T * Hs), dim=1)
    off = torch.zeros(B + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(incl[:, -1], 0)
    want_row_off = (incl - rcnt.reshape(B, T * Hs) + off[:-1, None]).reshape(-1)
    hcnt = rcnt.sum(-1, dtype=torch.int32)
    nz = hcnt.sum(-1, dtype=torch.int32)
    row_off, head = ncc_kernels.compact_counts(rcnt)
    assert row_off.dtype == torch.int64 and torch.equal(row_off, want_row_off)
    got = ncc_kernels.split_counts(head, B, T)
    for a, b in zip(got, (off, hcnt, nz)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert head.dtype == torch.uint8 and head.numel() == 8 * (B + 1) + 4 * (B * T + B)
    pos = ncc_kernels.compact_emit(mask, rcnt, row_off, int(off[-1]))
    assert torch.equal(pos, ncc_kernels.compact_hits_reference(mask, rcnt)[0])


@pytest.mark.parametrize("nh,nw", [(13, 9), (7, 6), (1, 1), (20, 20)])
def test_window_stats_matches_jax(nh, nw):
    rng = np.random.default_rng(nh * 100 + nw)
    img = rng.integers(0, 256, (61, 83), dtype=np.uint8)
    sp, s2p = window_stats(torch.from_numpy(img), nw, nh)
    jsp, js2p = jax_window_stats(jnp.asarray(img).astype(jnp.int32), nw, nh)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(s2p.numpy(), np.asarray(js2p))
    # batched pages give each page's own stats
    both = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    bsp, bs2p = window_stats(both, nw, nh)
    np.testing.assert_array_equal(bsp[0].numpy(), sp.numpy())
    np.testing.assert_array_equal(
        bs2p[1].numpy(), window_stats(both[1], nw, nh)[1].numpy()
    )


def test_sweep_terms_match_pallas_derivation():
    """sn_n, rtn and thr−ε: pallas_ncc.py:309-321 op for op, including the
    +inf of a zero-variance needle."""
    imgs, needles, s_n, s2_n, thr = _inputs("flat-13x9")
    n = needles.shape[1] * needles.shape[2]
    sn_n, rtn, thr_eps = ncc_kernels.sweep_terms(
        torch.from_numpy(s_n), torch.from_numpy(s2_n), n, thr
    )
    nf = np.float32(n)
    want_sn = s_n.astype(np.float32) / nf
    n2n = (n * s2_n - s_n**2).astype(np.float32) / nf
    with np.errstate(invalid="ignore"):
        want_rtn = np.where(n2n > 0, np.sqrt(n2n), np.float32(np.inf))
    assert sn_n.numpy().tobytes() == want_sn.tobytes()
    assert rtn.numpy().tobytes() == want_rtn.astype(np.float32).tobytes()
    assert rtn[0] == float("inf")
    assert np.float32(thr_eps) == np.float32(thr) - np.float32(1e-3)


@pytest.mark.parametrize(
    "fn", [ncc_kernels.ncc_sweep, ncc_kernels.ncc_sweep_reference]
)
@pytest.mark.parametrize("nh,nw,thr", [(17, 16, 0.8), (13, 9, 0.0), (13, 9, -0.5)])
def test_sweep_gate_raises(fn, nh, nw, thr):
    """Outside n·65025 < 2²⁴ and thr−ε > 0 the sweep takes its wide tier
    (focr_tpu's XLA-tier test), whose candidates hold every window the exact
    f64 similarity accepts; it raises only past focr_tpu's own bound
    n·65025 < 2³¹."""
    from focr_tpu_torch.models.ncc import exact_similarities

    rng = np.random.default_rng(nh * nw)
    imgs = rng.integers(0, 256, (1, 40, 44), dtype=np.uint8)
    needles = rng.integers(0, 256, (2, nh, nw), dtype=np.uint8)
    imgs[0, 5 : 5 + nh, 7 : 7 + nw] = needles[0]
    imgs[0, 20 : 20 + nh, 25 : 25 + nw] = needles[1]
    T, n = 2, nh * nw
    s_n = needles.reshape(T, -1).astype(np.int64).sum(1)
    s2_n = (needles.reshape(T, -1).astype(np.int64) ** 2).sum(1)
    assert ncc_kernels.sweep_tier(n, thr) == "wide"
    mask, rcnt = fn(*(torch.from_numpy(a) for a in (imgs, needles, s_n, s2_n)), thr)
    Hs, Wv = 40 - nh + 1, 44 - nw + 1
    cand = _bits(mask.numpy(), 32)[0, :, :, :Wv]  # [T, Hs, Wv]
    assert rcnt.numpy().sum() == cand.sum()
    wins = np.lib.stride_tricks.sliding_window_view(imgs[0].astype(np.int64), (nh, nw))
    sp, s2p = wins.sum(axis=(2, 3)), (wins**2).sum(axis=(2, 3))
    for t in range(T):
        acc = (wins * needles[t].astype(np.int64)).sum(axis=(2, 3))
        sim = exact_similarities(acc, sp, s2p, int(s_n[t]), int(s2_n[t]), n)
        accept = (sim != np.inf) & (sim > np.float64(np.float32(thr)))
        accept[0, :] = accept[:, 0] = False  # the search domain is y, x >= 1
        assert accept.any() and not (accept & ~cand[t]).any()
    big = torch.ones((1, 182, 182), dtype=torch.uint8)  # 33124·65025 >= 2³¹
    s = torch.full((1,), 182 * 182, dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^31"):
        fn(torch.zeros((1, 200, 200), dtype=torch.uint8), big, s, s, thr)


def test_cpu_wrappers_count_no_launches():
    """On CPU tensors the wrappers run the plain versions: no kernel launch
    is counted."""
    ncc_kernels.reset_launches()
    mask, rcnt = _torch_sweep("s0-7x6")
    ncc_kernels.compact_hits(mask, rcnt)
    row_off, head = ncc_kernels.compact_counts(rcnt)
    ncc_kernels.compact_emit(mask, rcnt, row_off, int(head[:8 * (mask.shape[0] + 1)]
                                                     .view(torch.int64)[-1]))
    assert ncc_kernels.LAUNCHES == {"ncc_sweep": 0, "ncc_sweep_mma": 0, "compact_count": 0,
                                    "compact_hits": 0}


def test_compact_chunk_matches_kernel():
    """compact_counts sizes the count kernel's look-back buffer with
    COMPACT_CHUNK rows a block: it must be csrc/ncc_compact.cu's CHUNK
    (CT threads x CPT rows), or the kernel would index past the buffer."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(ncc_kernels.__file__), os.pardir, "csrc",
                            "ncc_compact.cu")).read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert "constexpr int CHUNK = CT * CPT;" in src
    assert int(consts["CT"]) * int(consts["CPT"]) == ncc_kernels.COMPACT_CHUNK
