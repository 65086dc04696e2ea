"""A NumPy model of K1's tile walk (csrc/ncc_sweep.cu), held against the
plain version ncc_sweep_reference, exactly.

The card kernel cannot run here, so its index arithmetic is modelled lane by
lane: the host's packing of the needles into mma.m16n8k32 A fragments
(pack_needle_fragments), the K padding, the shared-memory page band and the
per-block k-word offset table, each lane's B registers as funnel shifts of
two band words, the s32 accumulation of the C fragments, the window sums of
each lane's own column with the padding masked out, the shuffles that bring
8 columns' terms to a lane, and the epilogue that assembles 32 keep bits a
(needle, word) from the C fragments with two xor-shuffles. A layout fault in
any of them changes the mask or the row counts. The launcher's plan (the
k-steps, the M-tiles a block takes, where A lives) is mirrored here too, with
the kernel's constants checked against the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from focr_tpu_torch.ops import ncc_kernels as K
from focr_tpu_torch.ops.ncc import word_stride

LANE = np.arange(32)
GQ, TQ = LANE >> 2, LANE & 3  # the fragments' groupID and thread-in-group
NT = 4  # N-tiles of 8 columns a warp item
# the kernel's block shape and shared-memory budget, as csrc/ncc_sweep.cu
# declares them (test_kernel_constants): M-tiles a chunk, M-tiles a block,
# window rows and 32-column words a block
MT, MTZ, TR, XW = 2, 16, 8, 8
SMEM_MAX = 232448 - 1024
SOURCE = Path(__file__).resolve().parents[1] / "focr_tpu_torch" / "csrc" / "ncc_sweep.cu"


def block_plan(T: int, nh: int, nw: int) -> tuple[int, int, bool]:
    """The launcher's plan (focr_ncc_sweep): (k-steps, blocks along grid.z,
    A's fragments in shared memory?). A block takes at most MTZ M-tiles; it
    stages their fragments beside its page band where both fit, else reads
    them from device memory; a band that alone does not fit is refused."""
    nks, nw4 = K.k_steps(nh, nw), -(-nw // 4)
    n_mt = -(-T // 16)
    nmz = min(n_mt, MTZ)
    band = nmz * 16 * 4 * 2 + nks * 8 * 4 + (TR + nh - 1) * (XW * 32 + 4 * nw4)
    if band > SMEM_MAX:
        raise ValueError(f"a {nw}x{nh} needle's page band ({band} bytes) exceeds shared memory")
    return nks, -(-n_mt // MTZ), band + nmz * nks * 32 * 16 <= SMEM_MAX


def _bytes(regs: np.ndarray) -> np.ndarray:
    """uint32 registers -> their 4 bytes, lowest first."""
    return (regs[..., None].astype(np.uint64) >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF


def _funnel(lo: np.ndarray, hi: np.ndarray, sh: np.ndarray) -> np.ndarray:
    """__funnelshift_r(lo, hi, sh): the low 32 bits of (hi:lo) >> sh."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> sh.astype(np.uint64)) & 0xFFFFFFFF).astype(np.uint64)


def _a_matrix(frag: np.ndarray) -> np.ndarray:
    """One (M-tile, k-step) of A from the lanes' uint4 fragments [32, 4]:
    register i of lane 4g+tq holds row g + 8(i&1), k = 4tq + 16(i>>1) + j."""
    A = np.zeros((16, 32), np.int64)
    i, j = np.arange(4)[None, :, None], np.arange(4)[None, None, :]
    rows = GQ[:, None, None] + 8 * (i & 1) + 0 * j
    cols = 4 * TQ[:, None, None] + 16 * (i >> 1) + j
    A[rows, cols] = _bytes(frag)
    return A


def _b_matrix(b0: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """One (k-step, N-tile) of B from the lanes' two registers [32]:
    register r of lane 4g+tq holds column g, k = 4tq + 16r + j."""
    B = np.zeros((32, 8), np.int64)
    j = np.arange(4)[None, :]
    for r, regs in enumerate((b0, b1)):
        B[4 * TQ[:, None] + 16 * r + j, GQ[:, None] + 0 * j] = _bytes(regs)
    return B


def _column_terms(sp, s2p, x, y, n, Wv, wide, thr_eps):
    """The kernel's per-column f32 terms (spf, q) from the exact sums, in the
    plain version's op order; q is NaN outside the keep domain."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    spf = torch.from_numpy(sp.astype(np.float32))
    s2pf = torch.from_numpy(s2p.astype(np.float32))
    dom = torch.from_numpy((x >= 1) & (x < Wv) & (y >= 1))
    if wide:
        _, err, _, _ = K.wide_scalars(n, thr_eps)
        norm2p = s2pf - (spf * spf) / f32(float(n))
        var = torch.from_numpy(n * s2p.astype(np.int64) - sp.astype(np.int64) ** 2)
        ok = (spf > 0) & (var > 0) & dom
        q = torch.sqrt(torch.maximum(norm2p + f32(err), f32(0.0)))
    else:
        norm2p = K._fma32(-(spf * spf), f32(np.float32(1.0 / n)), s2pf)
        ok = (spf > 0) & (norm2p > -8) & dom
        q = torch.sqrt(torch.maximum(norm2p - f32(8.0), f32(0.0)))
    return spf, torch.where(ok, q, f32(float("nan")))


def _keep(acc, sn, rtn, spf, q, n, wide, thr_eps):
    """The kernel's per-element test on f32 tensors of one shape."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    accf = torch.from_numpy(acc.astype(np.float32))
    if wide:
        inv_n, _, c_den, slack = K.wide_scalars(n, thr_eps)
        num = accf - (sn * spf) * f32(inv_n)
        den = (rtn * q) * f32(c_den)
        return (num > f32(thr_eps) * den - f32(slack)).numpy()
    num = K._fma32(-sn, spf, accf)
    return (num > K._fma32(f32(thr_eps), rtn * q, f32(-48.0))).numpy()


def model_sweep(imgs, needles, s_n, s2_n, threshold, mtz=MTZ):
    """csrc/ncc_sweep.cu's walk in NumPy: (mask int32 [B, T, Hs, NW], rcnt
    int32 [B, T, Hs]). ``mtz``: the M-tiles a block takes (MTZ in the
    kernel; smaller here to walk several blocks along grid.z)."""
    B, H, W = imgs.shape
    T, nh, nw = needles.shape
    n = nh * nw
    wide = K.sweep_tier(n, threshold) == "wide"
    sn_n, rtn, thr_eps = K.sweep_terms(torch.from_numpy(s_n), torch.from_numpy(s2_n), n,
                                       threshold)
    nks = block_plan(T, nh, nw)[0]
    frags = K.pack_needle_fragments(torch.from_numpy(needles)).numpy().view(np.uint32)
    n_mt = -(-T // 16)
    assert frags.shape == (n_mt, nks, 32, 4)
    nw4 = -(-nw // 4)
    pitch = XW * 32 + 4 * nw4  # covers x + dx and the funnel shift's next word
    Hs, Wv, NW = H - nh + 1, W - nw + 1, word_stride(W, nw)
    koff = np.array([(w // nw4) * pitch + 4 * (w % nw4) if w // nw4 < nh else 0
                     for w in range(nks * 8)])
    # the blocks along grid.z, then each block's chunks of MT M-tiles: (first, count)
    chunks = [(mt0, min(MT, mz0 + mtz - mt0, n_mt - mt0)) for mz0 in range(0, n_mt, mtz)
              for mt0 in range(mz0, min(n_mt, mz0 + mtz), MT)]
    mask = np.zeros((B, T, Hs, NW), np.uint32)
    rcnt = np.zeros((B, T, Hs), np.int64)
    written = np.zeros((B, T, Hs, NW), np.int64)
    brows = TR + nh - 1
    for b in range(B):
        for band in range(-(-Hs // TR)):
            for xt in range(-(-NW // XW)):
                y0, xb = band * TR, xt * XW * 32
                img_s = np.zeros((brows, pitch), np.uint8)
                rows = imgs[b, y0 : y0 + brows, xb : xb + pitch]
                img_s[: rows.shape[0], : rows.shape[1]] = rows
                words = img_s.reshape(-1).view("<u4").astype(np.uint64)
                for mt0, mts in chunks:
                    for r in range(TR):
                        for gw in range(XW):
                            y, g = y0 + r, xt * XW + gw
                            if y >= Hs or g >= NW:
                                continue
                            xw = gw * 32
                            # each lane's own column: Σp, Σp² over the real pixels
                            xl = xw + LANE
                            sh = (xl & 3) * 8
                            sp = np.zeros(32, np.int64)
                            s2p = np.zeros(32, np.int64)
                            for dy in range(nh):
                                base = (r + dy) * pitch // 4 + (xl >> 2)
                                for q in range(nw4):
                                    p4 = _bytes(_funnel(words[base + q], words[base + q + 1], sh))
                                    p4 = p4.astype(np.int64) * (4 * q + np.arange(4) < nw)
                                    sp += p4.sum(-1)
                                    s2p += (p4 * p4).sum(-1)
                            spf, qv = _column_terms(sp, s2p, xb + xl, y, n, Wv, wide, thr_eps)
                            # acc: C[mt][nt] += A[mt, s] @ B[s, nt], distributed to lanes
                            acc = np.zeros((mts, NT, 32, 4), np.int64)
                            bcol = r * pitch + ((xw + GQ) & ~3)
                            bsh = (GQ & 3) * 8
                            for s in range(nks):
                                o0, o1 = koff[8 * s + TQ], koff[8 * s + TQ + 4]
                                Bs = []
                                for nt in range(NT):
                                    a0 = (bcol + 8 * nt + o0) // 4
                                    a1 = (bcol + 8 * nt + o1) // 4
                                    Bs.append(_b_matrix(_funnel(words[a0], words[a0 + 1], bsh),
                                                        _funnel(words[a1], words[a1 + 1], bsh)))
                                for mt in range(mts):
                                    A = _a_matrix(frags[mt0 + mt, s])
                                    for nt in range(NT):
                                        C = A @ Bs[nt]
                                        for i in range(4):
                                            acc[mt, nt, :, i] += C[GQ + 8 * (i >> 1),
                                                                   2 * TQ + (i & 1)]
                            assert acc.max(initial=0) < 2**31  # s32, exact
                            # the epilogue: 8 columns' terms a lane, keep bits, shuffles
                            cols = 8 * np.arange(NT)[:, None, None] + 2 * TQ[None, :, None] + (
                                np.arange(4)[None, None, :] & 1)  # [NT, 32, 4]
                            for mt in range(mts):
                                t = 16 * (mt0 + mt) + GQ[None, :, None] + 8 * (
                                    np.arange(4)[None, None, :] >> 1)  # [1, 32, 4]
                                tt = torch.from_numpy(np.minimum(t, T - 1)).expand(NT, 32, 4)
                                keep = _keep(acc[mt], sn_n[tt], rtn[tt],
                                             spf[torch.from_numpy(cols)],
                                             qv[torch.from_numpy(cols)], n, wide, thr_eps)
                                w = np.zeros((2, 32), np.uint64)  # rows gq, gq + 8
                                for nt in range(NT):
                                    for i in range(4):
                                        w[i >> 1] |= keep[nt, :, i].astype(np.uint64) << cols[
                                            nt, :, i].astype(np.uint64)
                                for d in (1, 2):
                                    w |= w[:, LANE ^ d]
                                for lane in np.flatnonzero(TQ < 2):
                                    tw = 16 * (mt0 + mt) + GQ[lane] + 8 * TQ[lane]
                                    if tw < T:
                                        m = int(w[TQ[lane], lane])
                                        mask[b, tw, y, g] = m
                                        rcnt[b, tw, y] += bin(m).count("1")
                                        written[b, tw, y, g] += 1
    assert (written == 1).all()  # every word written once
    return mask.view(np.int32), rcnt.astype(np.int32)


def _case(T, nh, nw, H, W, seed, B=2):
    rng = np.random.default_rng(seed)
    imgs = ((rng.random((B, H, W)) < 0.35) * rng.integers(0, 256, (B, H, W))).astype(np.uint8)
    needles = rng.integers(0, 256, (T, nh, nw), dtype=np.uint8)
    needles[T - 1] = 7 if T > 1 else needles[T - 1]  # a zero-variance needle
    for b in range(B):
        for _ in range(4):
            t, y, x = rng.integers(T), rng.integers(0, H - nh + 1), rng.integers(0, W - nw + 1)
            imgs[b, y : y + nh, x : x + nw] = needles[t]
    imgs[:, 1 : 1 + nh, 2 : 2 + nw] = 128  # a flat window
    s_n = needles.reshape(T, -1).astype(np.int64).sum(1)
    s2_n = (needles.reshape(T, -1).astype(np.int64) ** 2).sum(1)
    return imgs, needles, s_n, s2_n


def _check(imgs, needles, s_n, s2_n, thr):
    mask, rcnt = model_sweep(imgs, needles, s_n, s2_n, thr)
    args = [torch.from_numpy(a) for a in (imgs, needles, s_n, s2_n)]
    mask_r, rcnt_r = K.ncc_sweep_reference(*args, thr)
    np.testing.assert_array_equal(mask, mask_r.numpy())
    np.testing.assert_array_equal(rcnt, rcnt_r.numpy())
    return int(rcnt.sum())


@pytest.mark.parametrize("tier,thr", [("narrow", 0.3), ("wide", -0.2)])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 40])
@pytest.mark.parametrize("nw", [1, 3, 4, 5, 8, 9, 13, 17])
def test_tile_walk_matches_plain_version(nw, T, tier, thr):
    nh = {1: 4, 3: 6, 17: 5}.get(nw, 13 if nw in (8, 9) else 7)
    assert K.sweep_tier(nh * nw, thr) == tier
    # Hs = 19: three bands of 8 rows, the last not full; W - nw + 1 = 37: two
    # words, the second not full, and not a multiple of the 8-column N-tile
    imgs, needles, s_n, s2_n = _case(T, nh, nw, nh + 18, nw + 36, seed=100 * nw + T)
    assert _check(imgs, needles, s_n, s2_n, thr) > 0


@pytest.mark.parametrize("nh,nw,W,thr", [
    (13, 9, 300, 0.5),   # two column tiles of 8 words
    (4, 5, 9, 0.2),      # a page narrower than one N-tile (5 window columns)
    (21, 13, 60, 0.8),   # the -t 20 needle: wide by n·65025 >= 2^24
])
def test_tile_walk_page_shapes(nh, nw, W, thr):
    imgs, needles, s_n, s2_n = _case(21, nh, nw, nh + 4, W, seed=nh * W, B=1)
    _check(imgs, needles, s_n, s2_n, thr)


@pytest.mark.parametrize("T,nh,nw", [(74, 13, 8), (222, 13, 9), (3, 150, 150), (9, 21, 13),
                                     (1, 1, 1), (17, 5, 17)])
def test_needle_fragments(T, nh, nw):
    """Each fragment byte is the needle byte the mma layout puts there; the
    K padding, bytes past nw and needles past T are zero; every needle byte
    appears exactly once."""
    rng = np.random.default_rng(T)
    needles = rng.integers(1, 256, (T, nh, nw), dtype=np.uint8)
    frags = K.pack_needle_fragments(torch.from_numpy(needles)).numpy().view(np.uint32)
    nks = K.k_steps(nh, nw)
    nw4 = -(-nw // 4)
    assert nks * 8 >= nh * nw4 > (nks - 1) * 8
    assert frags.shape == (-(-T // 16), nks, 32, 4)
    A = np.zeros((frags.shape[0] * 16, nks * 32), np.int64)
    for mt in range(frags.shape[0]):
        for s in range(nks):
            A[16 * mt : 16 * mt + 16, 32 * s : 32 * s + 32] = _a_matrix(frags[mt, s])
    want = np.zeros_like(A)
    for dy in range(nh):
        for dx in range(nw):
            want[:T, 4 * (dy * nw4 + dx // 4) + dx % 4] = needles[:, dy, dx]
    np.testing.assert_array_equal(A, want)
    assert {(74, 13, 8): 4, (222, 13, 9): 5}.get((T, nh, nw), nks) == nks


def test_block_plan():
    """Every group of the main path in one block along grid.z, A in shared
    memory beside the band where both fit; a group of any size spreads over
    grid.z with the shared memory of 16 M-tiles; a band that does not fit
    alone is refused."""
    assert block_plan(74, 13, 8) == (4, 1, True)
    assert block_plan(222, 13, 9) == (5, 1, True)
    assert block_plan(256, 13, 9) == (5, 1, True) and block_plan(257, 13, 9) == (5, 2, True)
    # a 7,000-glyph alphabet at --x-bits 2: 28,000 needles of one size
    assert block_plan(28000, 13, 9) == (5, 110, True)
    assert block_plan(10**6, 21, 13) == (11, 3907, True)
    assert block_plan(3, 150, 150)[1:] == (1, False)
    assert block_plan(16, 1, 1) == (1, 1, True)
    with pytest.raises(ValueError, match="shared memory"):
        block_plan(1, 1, 60000)


def test_kernel_constants():
    """The mirror above holds the kernel's own constants, and the launcher
    computes k-steps as k_steps does."""
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr (?:int|size_t) (\w+) = ([^;]+);", src))
    assert {k: int(eval(consts[k])) for k in ("MT", "MTZ", "TR", "XW", "NT", "SMEM_MAX")} == {
        "MT": MT, "MTZ": MTZ, "TR": TR, "XW": XW, "NT": NT, "SMEM_MAX": SMEM_MAX}
    assert "const int nks = (nh * nw4 + 7) / 8;" in src
    assert all(K.k_steps(nh, nw) == (nh * -(-nw // 4) + 7) // 8
               for nh in range(1, 40) for nw in range(1, 40))


@pytest.mark.parametrize("tier,thr", [("narrow", 0.3), ("wide", -0.2)])
def test_tile_walk_over_grid_z(tier, thr):
    """Blocks of one M-tile each along grid.z: the block's fragment, term and
    mask offsets reproduce the plain version for 3 M-tiles."""
    imgs, needles, s_n, s2_n = _case(40, 7, 5, 22, 30, seed=5)
    mask, rcnt = model_sweep(imgs, needles, s_n, s2_n, thr, mtz=1)
    args = [torch.from_numpy(a) for a in (imgs, needles, s_n, s2_n)]
    mask_r, rcnt_r = K.ncc_sweep_reference(*args, thr)
    np.testing.assert_array_equal(mask, mask_r.numpy())
    np.testing.assert_array_equal(rcnt, rcnt_r.numpy())
    assert K.sweep_tier(35, thr) == tier
