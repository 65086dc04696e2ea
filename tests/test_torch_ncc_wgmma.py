"""A NumPy model of K1's wgmma instance (csrc/ncc_sweep.cu,
focr_ncc_sweep_kernel), held against the plain version ncc_sweep_reference,
exactly.

The card kernel cannot run here, so its layouts are modelled lane by lane:
the host's packing of the needles into B (pack_needle_tiles) read back
through the shared-memory descriptor's addressing (core matrices of 8
needles x 16 bytes, LBO and SBO); the page band staged as aligned 4-byte
words; the windows' A registers as funnel shifts of two band words through
the per-block k-word table; Σp and Σp² from those registers with the
needles' byte masks and a quad's two xor-shuffles; the s32 product per
sub-chunk of needles and its C layout; the keep bits as the sign of R − num
shifted into a byte per register; the 8x8 bit transpose over the lanes; the
16-bit halves staged a needle; the coalesced store pass and its row counts.
A layout fault in any of them changes the mask or the row counts. The plan
(sweep_plan) and the walk's shape are checked against the source's
constants.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from focr_tpu_torch.ops import ncc_kernels as K
from focr_tpu_torch.ops.ncc import word_stride

SOURCE = Path(__file__).resolve().parents[1] / "focr_tpu_torch" / "csrc" / "ncc_sweep.cu"
LANE = np.arange(32)
G, TQ = LANE >> 2, LANE & 3  # the fragments' groupID and thread-in-group
WARP = np.arange(4)  # the warpgroup's warps
LBO, SBO = 128, 256  # B's descriptor: the k-half's and the 8-needle group's byte offsets
# the walk's shape, as the source declares it: window rows an item, windows a
# column chunk, needles a block at most
ROWS, COLS, NBMAX = 4, 128, 256
M32 = np.uint64(0xFFFFFFFF)


def _u64(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64)


def funnel_r(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh): the low 32 bits of (hi:lo) >> sh."""
    return ((_u64(hi) << np.uint64(32)) | _u64(lo)) >> _u64(sh) & M32


def byte_perm(x, y, sel: int):
    """__byte_perm(x, y, sel): result byte k is byte (sel >> 4k) & 7 of y:x."""
    src = [(_u64(x) >> np.uint64(8 * k)) & np.uint64(0xFF) for k in range(4)]
    src += [(_u64(y) >> np.uint64(8 * k)) & np.uint64(0xFF) for k in range(4)]
    return sum(src[(sel >> (4 * k)) & 7] << np.uint64(8 * k) for k in range(4))


def byte_sums(v):
    """(Σ bytes, Σ bytes²) of uint32 words: __dp4a(v, 0x01010101) and
    __dp4a(v, v)."""
    by = (_u64(v)[..., None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64))) & np.uint64(0xFF)
    by = by.astype(np.int64)
    return by.sum(-1), (by * by).sum(-1)


def band_words(flat: np.ndarray, b, H, W, y0, brows, xb, pw) -> np.ndarray:
    """stage_band: for rows y0 .. y0+brows-1 of page b, the pw aligned words
    from the one holding byte (y, xb) on, of the 4-aligned pages; a word past
    the tensor is zero, a partial last word holds the bytes that exist."""
    n = len(flat)
    pad = np.concatenate([flat, np.zeros(8, np.uint8)]).astype(np.uint64)
    o = (b * H + y0 + np.arange(brows)[:, None]) * W + xb
    at = (o & ~3) + 4 * np.arange(pw)
    v = sum(pad[np.minimum(at + k, n)] << np.uint64(8 * k) for k in range(4))
    return np.where(at < n, v, 0).astype(np.uint64)


def popcount(words) -> np.ndarray:
    """Set bits of each uint32 word."""
    by = np.ascontiguousarray(words, dtype=np.uint32).view(np.uint8)
    return np.unpackbits(by.reshape(*np.shape(words), 4), axis=-1).sum(-1).astype(np.int64)


def b_matrix(bs: np.ndarray, c: int, s: int, nks: int, N: int) -> np.ndarray:
    """B of (sub-chunk c of N needles, k-step s) read from the staged bytes
    as the descriptor addresses them: needle n, k-byte k at start + (n >> 3)·
    SBO + (k >> 4)·LBO + (n & 7)·16 + (k & 15)."""
    n, k = np.ix_(np.arange(N), np.arange(32))
    start = (c * nks + s) * N * 32
    return bs[start + (n >> 3) * SBO + (k >> 4) * LBO + (n & 7) * 16 + (k & 15)].astype(np.int64)


def _terms(sp, s2p, x, y, n, Wv, tier, thr_eps):
    """A window's f32 terms (spf, q, ok) from its exact sums, in the
    kernel's op order; q = 0 outside the test's domain."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    spf = torch.from_numpy(sp.astype(np.float32))
    s2pf = torch.from_numpy(s2p.astype(np.float32))
    dom = torch.from_numpy((x >= 1) & (x < Wv) & (y >= 1))
    if tier == "wide":
        _, err, _, _ = K.wide_scalars(n, thr_eps)
        norm2p = s2pf - (spf * spf) / f32(float(n))
        var = torch.from_numpy(n * s2p - sp * sp)
        ok = (spf > 0) & (var > 0) & dom
        q = torch.sqrt(torch.maximum(norm2p + f32(err), f32(0.0)))
    else:
        norm2p = K._fma32(-(spf * spf), f32(np.float32(1.0 / n)), s2pf)
        ok = (spf > 0) & (norm2p > -8) & dom
        q = torch.sqrt(torch.maximum(norm2p - f32(8.0), f32(0.0)))
    return spf, torch.where(ok, q, f32(0.0)), ok.numpy()


def _sign(acc, sn, rtn, spf, q, n, tier, thr_eps) -> np.ndarray:
    """keep_bit's bit: the sign of R − num in f32. A NaN (which the kernel's
    masks must keep out of every kept bit) counts as set."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    accf = torch.from_numpy(acc.astype(np.float32))
    if tier == "wide":
        inv_n, _, c_den, slack = K.wide_scalars(n, thr_eps)
        num = accf - (sn * spf) * f32(inv_n)
        diff = (f32(thr_eps) * ((rtn * q) * f32(c_den)) - f32(slack)) - num
    else:
        num = K._fma32(-sn, spf, accf)
        diff = K._fma32(f32(thr_eps), rtn * q, f32(-48.0)) - num
    return ((diff.view(torch.int32) < 0) | torch.isnan(diff)).numpy()


def _group(C, n0, nbv, sn_s, rtn_s, spf, qv, vmask, r, tl, stage, wpc, n, tier, thr_eps):
    """The epilogue of one 64-needle group (block needles n0 .. n0+63): C
    [item, 64 windows, 64 needles] its products; the keep bits, the byte a
    register, the lanes' bit transpose and the 16-bit halves into stage."""
    # d[4j + r]: window 16w + g + 8(r>>1), needle 8j + 2tq + (r&1)
    jj, rr = np.divmod(np.arange(32), 4)
    d = C[:, (16 * WARP[:, None, None] + G[:, None] + 8 * (rr >> 1)),
          8 * jj + 2 * TQ[:, None] + (rr & 1)]  # [item, warp, lane, 32]
    nj = min(8, (nbv - n0 + 7) >> 3)
    byr = [np.zeros(d.shape[:3], np.uint64) for _ in range(4)]
    for j in range(nj - 1, -1, -1):
        for rg in range(4):
            nn = torch.from_numpy(np.broadcast_to(
                n0 + 8 * j + 2 * TQ + (rg & 1), d.shape[:3]).copy())
            bit = _sign(d[..., 4 * j + rg], sn_s[nn], rtn_s[nn],
                        spf[..., rg >> 1], qv[..., rg >> 1], n, tier,
                        thr_eps)
            byr[rg] = ((byr[rg] << np.uint64(1)) | _u64(bit)) & M32
    t = byte_perm(byte_perm(byr[0], byr[1], 0x0040),
                  byte_perm(byr[2], byr[3], 0x0040), 0x5410)
    for k in range(3):
        m = _u64([0x55555555, 0x33333333, 0x0F0F0F0F][k])
        upper = ((G >> k) & 1).astype(bool)
        out = np.where(upper, (t & m) << _u64(1 << k), (t >> _u64(1 << k)) & m)
        out &= M32
        t = (t & np.where(upper, ~m & M32, m)) | out[..., LANE ^ (4 << k)]
    for e, sel in ((0, 0x4420), (1, 0x4431)):
        half = byte_perm(t, 0, sel) & vmask
        nl = n0 + 8 * G + 2 * TQ + e  # [lane]
        word = r[:, 0, 0, 0, 0][:, None] * wpc + 2 * tl[:, 0, 0, 0, 0][:, None] \
            + (WARP >> 1)  # [item, warp]
        for itm in range(t.shape[0]):
            for ww in range(4):
                sel_l = nl < nbv
                stage[nl[sel_l], word[itm, ww], ww & 1] = half[itm, ww][sel_l]


def model_sweep(imgs, needles, s_n, s2_n, threshold):
    """focr_ncc_sweep_kernel's walk in NumPy: (mask int32 [B, T, Hs, NW], rcnt
    int32 [B, T, Hs]). Items of ROWS window rows in column chunks of COLS
    windows, blocks of up to NBMAX needles along grid.z in sub-chunks of
    WG_N, as the launcher sizes them. The blocks' order over the items does
    not change what any item writes."""
    B, H, W = imgs.shape
    T, nh, nw = needles.shape
    npx = nh * nw
    tier = K.sweep_tier(npx, threshold)
    plan = K.sweep_plan(nh, nw, tier)
    assert plan.instance == "wgmma"
    rows, cols, nks, N = ROWS, COLS, plan.nks, K.WG_N
    nb = min(NBMAX, -(-T // N) * N)
    sn_n, rtn, thr_eps = K.sweep_terms(torch.from_numpy(s_n), torch.from_numpy(s2_n), npx,
                                       threshold)
    packed = K.pack_needle_tiles(torch.from_numpy(needles)).numpy()
    assert packed.shape == (-(-T // N), nks, N * 32) and packed.dtype == np.uint8
    nw4 = -(-nw // 4)
    Hs, Wv, NW = H - nh + 1, W - nw + 1, word_stride(W, nw)
    wpc, pw, brows = cols // 32, cols // 4 + nw4 + 2, rows + nh - 1
    nstr = rows * wpc + 1
    kw = np.arange(nks * 8)
    dy, q = kw // nw4, kw % nw4
    pm = np.where(dy < nh, (1 << (8 * np.clip(nw - 4 * q, 0, 4))) - 1, 0).astype(np.uint64)
    flat = imgs.reshape(-1)
    mask = np.zeros((B, T, Hs, NW), np.uint64)
    rcnt = np.zeros((B, T, Hs), np.int64)
    written = np.zeros((B, T, Hs, NW), np.int64)
    counted = np.zeros((B, T, Hs), np.int64)
    for b in range(B):
        for t0 in range(0, T, nb):
            nbv = min(nb, T - t0)
            nsub = -(-nbv // N)
            bs = packed[t0 // N : t0 // N + nsub].reshape(-1)
            ok_n = (np.arange(nb) < nbv) & np.isfinite(
                np.pad(rtn.numpy()[t0 : t0 + nbv], (0, nb - nbv)))
            sn_s = torch.from_numpy(np.where(ok_n, np.pad(sn_n.numpy()[t0 : t0 + nbv],
                                                          (0, nb - nbv)), np.inf)
                                    .astype(np.float32))
            rtn_s = torch.from_numpy(np.where(ok_n, np.pad(rtn.numpy()[t0 : t0 + nbv],
                                                           (0, nb - nbv)), 0).astype(np.float32))
            Bm = [np.concatenate([b_matrix(bs, c, s, nks, N) for s in range(nks)], 1)
                  for c in range(nsub)]
            for y0 in range(0, Hs, rows):
                nrv = min(rows, Hs - y0)
                cnt = np.zeros((nb, rows), np.int64)
                for ch in range(-(-NW // wpc)):
                    xb, g0 = ch * cols, ch * wpc
                    nwv = min(wpc, NW - g0)
                    band = band_words(flat, b, H, W, y0, brows, xb, pw).reshape(-1)
                    # kt_s[r][w]: k-word w's byte offset in the band for tile row r,
                    # its row's first byte's place in its word included
                    rr = np.arange(rows)[:, None] + np.where(dy < nh, dy, 0)
                    mis = ((b * H + y0 + rr) * W) & 3
                    koff = rr * 4 * pw + mis + np.where(dy < nh, 4 * q, 0)  # [rows, nks*8]
                    stage = np.zeros((nb, nstr, 2), np.uint64)  # 16-bit halves
                    ntiles = (nwv + 1) // 2
                    r, tl = np.divmod(np.arange(nrv * ntiles), ntiles)
                    r, tl = r[:, None, None, None, None], tl[:, None, None, None, None]
                    # A: [item, warp, lane, k-step, register]
                    w = WARP[:, None, None, None]
                    g, tq = G[:, None, None], TQ[:, None, None]
                    s_, i_ = np.arange(nks)[:, None], np.arange(4)
                    xl0 = 64 * tl + 16 * w + g
                    kwi = 8 * s_ + tq + 4 * (i_ >> 1)
                    kt = koff[r, kwi]
                    off = kt + xl0 + 8 * (i_ & 1)
                    a = funnel_r(band[off >> 2], band[(off >> 2) + 1], ((kt + xl0) & 3) * 8)
                    sp1, sq1 = byte_sums(a & pm[kwi])
                    # Σ over the k-steps and the registers of each window h,
                    # then over the quad (the xor-shuffles 1, 2)
                    sp = np.stack([sp1[..., h::2].sum((-1, -2)) for h in (0, 1)], -1)
                    s2p = np.stack([sq1[..., h::2].sum((-1, -2)) for h in (0, 1)], -1)
                    sp = sp.reshape(*sp.shape[:2], 8, 4, 2).sum(3, keepdims=True)
                    sp = np.broadcast_to(sp, (*sp.shape[:3], 4, 2)).reshape(-1, 4, 32, 2)
                    s2p = s2p.reshape(*s2p.shape[:2], 8, 4, 2).sum(3, keepdims=True)
                    s2p = np.broadcast_to(s2p, (*s2p.shape[:3], 4, 2)).reshape(-1, 4, 32, 2)
                    h = np.arange(2)
                    # the thread's windows in the tile: 16w + g + 8h  [item, warp, lane, h]
                    wt = 16 * WARP[:, None, None] + G[:, None] + 8 * h
                    win = 64 * tl[..., 0] + wt
                    spf, qv, ok = _terms(sp, s2p, xb + win, y0 + r[..., 0], npx, Wv, tier, thr_eps)
                    vmask = ok.astype(np.uint64) << _u64(wt - 16 * WARP[:, None, None])
                    vmask = np.bitwise_or.reduce(vmask, axis=(2, 3))[:, :, None]  # [item, warp, 1]
                    # the A matrix: window 16w + g + 8(i&1), k = 32s + 4tq + 16(i>>1) + byte
                    Am = np.zeros((a.shape[0], 64, nks * 32), np.int64)
                    by = (a[..., None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64))) & 0xFF
                    m_idx = np.broadcast_to(16 * w + g + 8 * (i_ & 1), a.shape)[..., None]
                    k_idx = np.broadcast_to(32 * s_ + 4 * tq + 16 * (i_ >> 1), a.shape)[..., None]
                    k_idx = k_idx + np.arange(4)
                    it = np.broadcast_to(np.arange(a.shape[0])[:, None, None, None, None, None],
                                         by.shape)
                    Am[it, np.broadcast_to(m_idx, by.shape), k_idx] = by.astype(np.int64)
                    for c in range(nsub):
                        C = Am @ Bm[c].T  # [item, 64 windows, N needles]
                        assert C.max(initial=0) < 2**31  # s32, exact
                        for gi in range(N // 64):
                            n0 = N * c + 64 * gi  # the 64-needle group's first needle
                            if n0 < nbv:
                                _group(C[:, :, 64 * gi : 64 * gi + 64], n0, nbv, sn_s, rtn_s, spf,
                                       qv, vmask, r, tl, stage, wpc, npx, tier, thr_eps)
                    # the store pass: needle by needle, (row, word) within; the
                    # counts add the words' set bits
                    words = (stage[:, :, 0] | (stage[:, :, 1] << np.uint64(16)))[:nbv, : rows * wpc]
                    words = words.reshape(nbv, rows, wpc)[:, :nrv, :nwv]
                    mask[b, t0 : t0 + nbv, y0 : y0 + nrv, g0 : g0 + nwv] = words
                    written[b, t0 : t0 + nbv, y0 : y0 + nrv, g0 : g0 + nwv] += 1
                    cnt[:nbv, :nrv] += popcount(words).sum(-1)
                rcnt[b, t0 : t0 + nbv, y0 : y0 + nrv] = cnt[:nbv, :nrv]
                counted[b, t0 : t0 + nbv, y0 : y0 + nrv] += 1
    assert (written == 1).all() and (counted == 1).all()  # every word and count once
    return mask.astype(np.uint32).view(np.int32), rcnt.astype(np.int32)


def _case(T, nh, nw, H, W, seed, B=2):
    """Sparse noise pages with needles planted, a flat window, and a
    zero-variance needle last."""
    rng = np.random.default_rng(seed)
    imgs = ((rng.random((B, H, W)) < 0.35) * rng.integers(0, 256, (B, H, W))).astype(np.uint8)
    needles = rng.integers(0, 256, (T, nh, nw), dtype=np.uint8)
    if T > 1:
        needles[T - 1] = 7
    for b in range(B):
        for _ in range(4):
            t, y, x = rng.integers(T), rng.integers(0, H - nh + 1), rng.integers(0, W - nw + 1)
            imgs[b, y : y + nh, x : x + nw] = needles[t]
    imgs[:, 1 : 1 + nh, 2 : 2 + nw] = 128
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
@pytest.mark.parametrize("T", [5, 64, 70])
@pytest.mark.parametrize("nw", range(4, 17))
def test_wgmma_walk_matches_plain_version(nw, T, tier, thr):
    """Every needle width 4..16 (each k-word padding), T inside one
    sub-chunk, exactly one and past one; Hs = 9 (the last item of 4 rows
    holds one) and W - nw + 1 = 70 (three mask words: the second tile's
    second word is past NW)."""
    nh = 7
    assert K.sweep_tier(nh * nw, thr) == tier
    imgs, needles, s_n, s2_n = _case(T, nh, nw, nh + 8, nw + 69, seed=100 * nw + T)
    assert _check(imgs, needles, s_n, s2_n, thr) > 0


@pytest.mark.parametrize("tier,thr", [("narrow", 0.5), ("wide", -0.1)])
@pytest.mark.parametrize("H,W", [(16, 200), (17, 300), (20, 130), (14, 100), (21, 420)])
def test_wgmma_walk_block_shapes(H, W, tier, thr):
    """The item (ROWS window rows) and the column chunk (COLS windows) over
    13x9 needles' windows: rows that fill one item, two items the last of
    one row, two whole items, one item's first two rows; words that fill one
    chunk, several chunks the last ragged, or a last chunk of one word."""
    imgs, needles, s_n, s2_n = _case(11, 13, 9, H, W, seed=H * W, B=1)
    assert _check(imgs, needles, s_n, s2_n, thr) > 0


@pytest.mark.parametrize("T,nh,nw,thr", [
    (300, 5, 6, 0.4),   # 256 + 44 needles: two blocks along grid.z
    (300, 5, 6, -0.3),  # the same in the wide tier
    (520, 3, 4, 0.4),   # blocks of 256, 256 and 8
    (260, 8, 9, 0.4),   # 5 k-steps: a block of two sub-chunks, then 4 needles
])
def test_wgmma_walk_over_grid_z(T, nh, nw, thr):
    imgs, needles, s_n, s2_n = _case(T, nh, nw, nh + 10, nw + 40, seed=T + nw, B=1)
    assert _check(imgs, needles, s_n, s2_n, thr) > 0


@pytest.mark.parametrize("T,nh,nw,H,W,thr", [
    (74, 13, 8, 20, 80, 0.5),   # the canonical 13x8 group: 4 k-steps
    (222, 13, 9, 17, 70, 0.5),  # the canonical 13x9 group: 5 k-steps
    (9, 16, 15, 20, 50, 0.6),   # 8 k-steps: every A register the narrow instance holds
    (7, 21, 13, 25, 60, 0.8),   # -t 20: wide by n·65025 >= 2^24, 11 k-steps
    (3, 24, 13, 26, 40, 0.1),   # 12 k-steps: every A register the wide instance holds
    (4, 5, 3, 9, 8, 0.3),       # a page of 6 windows: one tile, mostly outside
    (6, 4, 2, 8, 37, 0.2),      # nw < 4: one byte mask a row
    (5, 2, 1, 5, 34, 0.2),      # a 2x1 needle, W-nw+1 = 34: two words
    (128, 13, 9, 17, 70, 0.5),  # exactly one sub-chunk
    (129, 13, 8, 17, 70, 0.5),  # one needle in a second sub-chunk
    (256, 5, 6, 10, 60, 0.4),   # exactly one block of two sub-chunks
    (257, 5, 6, 10, 60, 0.4),   # one needle in a second block along grid.z
    (40, 13, 16, 18, 90, 0.5),  # 7 k-steps: the narrow general instance
    (10, 1, 4, 6, 50, 0.3),     # a needle of one row: one k-word
    (12, 32, 3, 36, 50, 0.2),   # 32 rows of one word: a tall band, 4 k-steps
    (6, 64, 1, 68, 40, 0.1),    # 64 rows of one byte: 8 k-steps, the tallest band of the narrow tier
])
def test_wgmma_walk_shapes(T, nh, nw, H, W, thr):
    imgs, needles, s_n, s2_n = _case(T, nh, nw, H, W, seed=T * nh + W, B=1)
    _check(imgs, needles, s_n, s2_n, thr)


def test_unaligned_row_bytes():
    """Page rows of 766 bytes (the canonical crop's width), whose starts are
    not 4-aligned: the band's words are funnel-shifted aligned loads, and the
    tensor's last word is partial."""
    imgs, needles, s_n, s2_n = _case(12, 13, 9, 15, 766, seed=766, B=2)
    imgs = imgs[:, :, :-1].copy()  # 765 bytes a row: the tensor ends mid-word
    assert imgs.size % 4 == 2
    assert _check(imgs, needles, s_n, s2_n, 0.4) > 0


@pytest.mark.parametrize("T,nh,nw", [(74, 13, 8), (222, 13, 9), (7, 21, 13), (1, 1, 1),
                                     (65, 5, 17), (3, 24, 13), (128, 13, 9), (129, 2, 3),
                                     (256, 4, 4), (257, 5, 6), (40, 13, 16), (6, 64, 1)])
def test_needle_tiles(T, nh, nw):
    """Each byte of the packed B is the needle byte that the descriptor's
    addressing reads for its (needle, k-byte); the K padding, bytes past nw
    and needles past T are zero; every needle byte appears exactly once."""
    N = K.WG_N
    rng = np.random.default_rng(T + nh)
    needles = rng.integers(1, 256, (T, nh, nw), dtype=np.uint8)
    packed = K.pack_needle_tiles(torch.from_numpy(needles)).numpy()
    nks, nw4 = K.k_steps(nh, nw), -(-nw // 4)
    assert packed.shape == (-(-T // N), nks, N * 32)
    Bm = np.zeros((packed.shape[0] * N, nks * 32), np.int64)
    flat = packed.reshape(-1)
    for c in range(packed.shape[0]):
        for s in range(nks):
            Bm[N * c : N * c + N, 32 * s : 32 * s + 32] = b_matrix(flat, c, s, nks, N)
    want = np.zeros_like(Bm)
    for dy in range(nh):
        for dx in range(nw):
            want[:T, 4 * (dy * nw4 + dx // 4) + dx % 4] = needles[:, dy, dx]
    np.testing.assert_array_equal(Bm, want)
    assert np.count_nonzero(packed) == T * nh * nw


def test_sweep_plan():
    """Every group of the main path takes the wgmma instance; a needle past
    the k-steps the instance holds in registers takes the mma instance; each
    instance counts under its own key."""
    plan = K.sweep_plan
    assert plan(13, 8, "narrow") == K.SweepPlan("wgmma", 4)
    assert plan(13, 9, "narrow") == K.SweepPlan("wgmma", 5)
    assert plan(21, 13, "wide") == K.SweepPlan("wgmma", 11)
    assert plan(16, 15, "narrow") == K.SweepPlan("wgmma", 8) and K.WG_KA["narrow"] == 8
    assert plan(17, 15, "narrow") == K.SweepPlan("mma", 9)
    assert plan(17, 15, "wide") == K.SweepPlan("wgmma", 9)
    assert plan(24, 13, "wide") == K.SweepPlan("wgmma", 12) and K.WG_KA["wide"] == 12
    assert plan(25, 13, "wide") == K.SweepPlan("mma", 13)
    assert plan(150, 150, "wide").instance == "mma"
    assert plan(1, 1, "narrow") == K.SweepPlan("wgmma", 1)
    for key, p in (("ncc_sweep", plan(13, 8, "narrow")), ("ncc_sweep_mma", plan(150, 150,
                                                                                "wide"))):
        assert p.key == key and key in K.LAUNCHES


def test_wgmma_constants():
    """The model's and the plan's constants are the source's; the launcher
    holds one straight-line or general instance for each plan; the
    descriptor's offsets are the packing's."""
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr (?:int|size_t) (\w+) = ([^;]+);", src))
    num = lambda k: int(eval(consts[k].split("//")[0]))  # noqa: E731
    assert {k: num(k) for k in ("WG_THREADS", "TILE", "WG_N", "NBMAX", "ROWS", "COLS",
                                "KA_NARROW", "KA_WIDE")} == {
        "WG_THREADS": 128, "TILE": 64, "WG_N": K.WG_N, "NBMAX": NBMAX, "ROWS": ROWS,
        "COLS": COLS, "KA_NARROW": K.WG_KA["narrow"], "KA_WIDE": K.WG_KA["wide"]}
    launcher = src[src.index('extern "C" int focr_ncc_sweep('):]
    for inst in ("<WIDE, 11, 11>", "<WIDE, KA_WIDE, 0>", "<NARROW, 4, 4>", "<NARROW, 5, 5>",
                 "<NARROW, KA_NARROW, 0>"):
        assert "focr_ncc_sweep_kernel" + inst in launcher
    assert len(re.findall(r"focr_ncc_sweep_kernel<", launcher)) == 5
    assert "(static_cast<uint64_t>(128 >> 4) << 16)" in src and \
        "(static_cast<uint64_t>(256 >> 4) << 32)" in src
    assert (LBO, SBO) == (128, 256)
    assert re.findall(r"wgmma\.mma_async\.sync\.aligned\.(m\w+)\.s32", src) == [
        f"m64n{K.WG_N}k32"]
    assert COLS % 64 == 0 and NBMAX % K.WG_N == 0
