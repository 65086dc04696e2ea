"""A NumPy model of K4's tensor-core walk (csrc/focr_ssd.cu, the mma
instance), held against the plain version ssd_argmin_reference, exactly.

The card kernel cannot run here, so its index arithmetic is modelled lane by
lane: the host's packing of each cell's templates into mma.m16n8k32 B
fragments (pack_template_fragments), the K padding, the shared-memory staging
of a block's 16 strips (inverted, rows of ``pitch`` bytes, zero past
crop_w, only the columns the block's 16 cells read), the per-block k-word
offset table, each lane's A registers as
funnel shifts of two staged words at the cell's start column, the s32
accumulation of the C fragments, each lane's strict-< minimum over its
glyphs and the quad's two xor-shuffles by (metric, g), and the white flag. A
layout fault in any of them changes the ids. The launcher's plan (which
instance, the k-steps, the pitch) is mirrored too, with the kernel's
constants checked against the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from focr_tpu_torch.ops import ssd_kernels as S

LANE = np.arange(32)
GQ, TQ = LANE >> 2, LANE & 3  # the fragments' groupID and thread-in-group
MS, NWARPS, KH = 16, 16, 5  # strips a block, cells a block, k-steps of A held
SOURCE = Path(__file__).resolve().parents[1] / "focr_tpu_torch" / "csrc" / "focr_ssd.cu"
I64_MAX = np.iinfo(np.int64).max


def _bytes(regs: np.ndarray) -> np.ndarray:
    """uint32 registers -> their 4 bytes, lowest first."""
    return (regs[..., None].astype(np.uint64) >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF


def _funnel(lo: np.ndarray, hi: np.ndarray, sh) -> np.ndarray:
    """__funnelshift_r(lo, hi, sh): the low 32 bits of (hi:lo) >> sh."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (v >> np.uint64(sh)) & np.uint64(0xFFFFFFFF)


def _a_matrix(regs: np.ndarray) -> np.ndarray:
    """One k-step of A from the lanes' four registers [32, 4]: register i of
    lane 4g+tq holds row g + 8(i&1), k = 4tq + 16(i>>1) + j."""
    A = np.zeros((16, 32), np.int64)
    i, j = np.arange(4)[None, :, None], np.arange(4)[None, None, :]
    rows = GQ[:, None, None] + 8 * (i & 1) + 0 * j
    cols = 4 * TQ[:, None, None] + 16 * (i >> 1) + j
    A[rows, cols] = _bytes(regs)
    return A


def _b_matrix(regs: np.ndarray) -> np.ndarray:
    """One (n-tile, k-step) of B from the lanes' two registers [32, 2]:
    register r of lane 4g+tq holds column g, k = 4tq + 16r + j."""
    B = np.zeros((32, 8), np.int64)
    j = np.arange(4)[None, :]
    for r in range(2):
        B[4 * TQ[:, None] + 16 * r + j, GQ[:, None] + 0 * j] = _bytes(regs[:, r])
    return B


def model_ssd(strips, templates, tsq, wx0):
    """csrc/focr_ssd.cu's mma walk in NumPy: strips u8 [N, h, crop_w] ->
    (ids int32 [N, C], white bool [N])."""
    N, h, crop_w = strips.shape
    C, G, _, win_w = templates.shape
    instance, nks, pitch = S.ssd_plan(h, crop_w, win_w)
    assert instance == "mma"
    bfrag = S.pack_template_fragments(torch.from_numpy(templates)).numpy().view(np.uint32)
    NT = -(-G // 8)
    assert bfrag.shape == (C, NT, nks, 32, 2)
    nw4 = -(-win_w // 4)
    koff = np.array([(w // nw4) * pitch + 4 * (w % nw4) if w // nw4 < h else 0
                     for w in range(nks * 8)])
    ids = np.full((N, C), -1, np.int64)
    white = np.zeros(N, bool)
    x0s = np.clip(wx0.astype(np.int64), 0, crop_w)
    for m0, c0 in ((m0, c0) for m0 in range(0, N, MS) for c0 in range(0, C, NWARPS)):
        # block (m0, grid.y = c0 / NWARPS) stages columns [xa, xe) of its
        # strips' rows, inverted, in whole 16-byte pieces up to crop_w, with
        # zeros past crop_w; the rest of its shared memory holds whatever it
        # held (0xA5 here, so a read outside the staged columns changes the
        # ids; rows of absent strips are never written out). Blocks of
        # grid.y 0 stage whole rows and give the white flags.
        ms = min(MS, N - m0)
        cells = x0s[c0 : c0 + NWARPS]
        xa = int(cells.min()) & ~15 if c0 else 0
        xe = min(crop_w, (int(cells.max()) & ~3) + 4 * nw4 + 4) if c0 else crop_w
        xs = min(crop_w, xa + 16 * (-(-(xe - xa) // 16)))
        st = np.full((MS * h, pitch), 0xA5, np.uint8)
        st[:, crop_w:] = 0
        st[: ms * h, xa:xs] = 255 - strips[m0 : m0 + ms].reshape(ms * h, crop_w)[:, xa:xs]
        words = st.reshape(-1).view("<u4").astype(np.uint64)
        if c0 == 0:
            white[m0 : m0 + ms] = (strips[m0 : m0 + ms] == 255).all(axis=(1, 2))
        for c in range(c0, min(C, c0 + NWARPS)):  # a warp a cell
            x0 = int(x0s[c])
            sh, xa = (x0 & 3) * 8, x0 & ~3
            lo = GQ * h * pitch + xa  # byte offset of each lane's strip gq, row 0
            hi = lo + 8 * h * pitch
            best = np.full((2, 32), I64_MAX)  # strips gq, gq + 8
            bg = np.full((2, 32), G)
            for nt in range(NT):
                acc = np.zeros((32, 4), np.int64)
                for s in range(nks):
                    o0, o1 = koff[8 * s + TQ], koff[8 * s + TQ + 4]
                    regs = np.stack([_funnel(words[(b + o) // 4], words[(b + o) // 4 + 1], sh)
                                     for b, o in ((lo, o0), (hi, o0), (lo, o1), (hi, o1))], axis=1)
                    Cm = _a_matrix(regs) @ _b_matrix(bfrag[c, nt, s])
                    for i in range(4):
                        acc[:, i] += Cm[GQ + 8 * (i >> 1), 2 * TQ + (i & 1)]
                assert np.abs(acc).max(initial=0) < 2**31  # s32, exact
                for e in range(2):
                    g = 8 * nt + 2 * TQ + e
                    t = tsq[c, np.minimum(g, G - 1)]
                    for half in range(2):
                        m = t - 2 * acc[:, 2 * half + e]
                        take = (g < G) & (m < best[half])  # strict <: the first minimum
                        best[half] = np.where(take, m, best[half])
                        bg[half] = np.where(take, g, bg[half])
            for d in (1, 2):  # the quad's xor-shuffles by (metric, g)
                om, og = best[:, LANE ^ d], bg[:, LANE ^ d]
                take = (om < best) | ((om == best) & (og < bg))
                best, bg = np.where(take, om, best), np.where(take, og, bg)
            for lane in np.flatnonzero(TQ == 0):
                for half in range(2):
                    m = GQ[lane] + 8 * half
                    if m < ms:
                        ids[m0 + m, c] = bg[half, lane]
    assert (ids >= 0).all()
    return ids.astype(np.int32), white


def _case(N, h, crop_w, C, G, win_w, seed, wx0=None):
    rng = np.random.default_rng(seed)
    strips = rng.integers(0, 256, (N, h, crop_w)).astype(np.uint8)
    strips[0] = 255  # a white strip
    if N > 2:
        strips[2] = np.clip(rng.integers(250, 262, (h, crop_w)), 0, 255)  # near-ties
    templates = rng.integers(0, 256, (C, G, h, win_w), dtype=np.uint8)
    templates[templates < 120] = 0
    if wx0 is None:
        wx0 = np.minimum(np.arange(C) * max(1, crop_w // C) + np.arange(C) % 3, crop_w)
    tsq = (templates.astype(np.int64) ** 2).sum(axis=(2, 3))
    return strips, templates, tsq, np.asarray(wx0, np.int32)


def _check(strips, templates, tsq, wx0):
    ids, white = model_ssd(strips, templates, tsq, wx0)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (strips[None], templates, tsq, wx0)]
    ids_r, white_r = S.ssd_argmin_reference(*args)
    np.testing.assert_array_equal(ids, ids_r[0].numpy())
    np.testing.assert_array_equal(white, white_r[0].numpy())
    return ids


@pytest.mark.parametrize("win_w", [1, 3, 4, 5, 9, 13])
@pytest.mark.parametrize("G", [1, 8, 9, 67, 200])
def test_tile_walk_matches_plain_version(G, win_w):
    """G around the 8-glyph n-tile; win_w around the 4-byte k-word; h in
    {1, 3, 12} in turn; 21 strips: a full block of 16 and a partial one;
    the last windows hang past crop_w, one starts at it."""
    h = (1, 3, 12)[(G + win_w) % 3]
    crop_w = 4 * win_w + 7
    C = 5
    wx0 = [0, 3, crop_w - win_w, crop_w - 2, crop_w]
    _check(*_case(21, h, crop_w, C, G, win_w, seed=G * 100 + win_w, wx0=wx0))


@pytest.mark.parametrize("N", [1, 15, 16, 17, 33])
def test_tile_walk_strip_counts(N):
    _check(*_case(N, 12, 40, 4, 11, 9, seed=N))


def columns_case(order: str):
    """40 cells over three blocks of grid.y on a 203-column strip (not a
    multiple of 16): the blocks past the first stage only their cells'
    columns, from a 16-byte piece that starts up to 15 bytes before the first
    of them. Cells ascending as on a grid, or shuffled; three start at
    crop_w and one hangs past it."""
    C, crop_w = 40, 203
    wx0 = np.minimum(np.arange(C) * 5 + np.arange(C) % 3 + 9, crop_w)
    wx0[[17, 33]], wx0[35] = crop_w, crop_w - 3
    if order == "shuffled":
        wx0 = np.random.default_rng(5).permutation(wx0)
    return _case(21, 12, crop_w, C, 11, 9, seed=5, wx0=wx0)


@pytest.mark.parametrize("order", ["ascending", "shuffled"])
def test_tile_walk_block_columns(order):
    _check(*columns_case(order))


def test_tile_walk_exact_ties():
    """Duplicated glyphs and empty glyphs tie exactly (on white windows every
    empty glyph scores 0): the lowest glyph index wins, across the lanes of
    a quad and across n-tiles."""
    strips, templates, tsq, wx0 = _case(18, 12, 60, 6, 30, 9, seed=7)
    templates[:, 20] = templates[:, 3]
    templates[:, 28] = templates[:, 3]
    templates[:, [5, 12, 17, 25]] = 0
    tsq = (templates.astype(np.int64) ** 2).sum(axis=(2, 3))
    strips[4:9] = 255
    ids = _check(strips, templates, tsq, wx0)
    assert not np.isin(ids, [20, 28, 12, 17, 25]).any() and (ids[4:9] == 5).all()


def test_canonical_shape_plan():
    """The canonical focr grid (78 cells of 12x9 windows on a 608-column
    strip, and the 3-row bottom group) takes the mma instance; a window whose
    dot may pass 2³¹ (n >= 33026) or a strip block too wide for shared
    memory takes the int64 one."""
    assert S.ssd_plan(12, 608, 9) == ("mma", 5, 624)
    assert S.ssd_plan(3, 608, 9) == ("mma", 2, 624)
    assert S.ssd_plan(1, 40000, 34000)[0] == "int64"
    assert S.ssd_plan(1, 40000, 33025)[0] == "int64"  # 16 strips of 40 KB: no room
    assert S.ssd_plan(1, 1000, 9000) == ("mma", 282, 10004)
    assert S.ssd_plan(12, 3000, 9)[0] == "int64"
    assert S.ssd_plan(16, 300, 40) == ("mma", 20, 344)


@pytest.mark.parametrize("C,G,h,win_w", [(2, 67, 12, 9), (1, 1, 1, 1), (3, 9, 3, 13),
                                          (1, 200, 5, 4)])
def test_template_fragments(C, G, h, win_w):
    """Each fragment byte is the template byte the mma layout puts there; the
    K padding, bytes past win_w and glyphs past G are zero; every template
    byte appears exactly once."""
    rng = np.random.default_rng(G)
    templates = rng.integers(1, 256, (C, G, h, win_w), dtype=np.uint8)
    frags = S.pack_template_fragments(torch.from_numpy(templates)).numpy().view(np.uint32)
    nks, nw4 = S.k_steps(h, win_w), -(-win_w // 4)
    assert nks * 8 >= h * nw4 > (nks - 1) * 8
    assert frags.shape == (C, -(-G // 8), nks, 32, 2)
    for c in range(C):
        B = np.zeros((nks * 32, frags.shape[1] * 8), np.int64)
        for nt in range(frags.shape[1]):
            for s in range(nks):
                B[32 * s : 32 * s + 32, 8 * nt : 8 * nt + 8] = _b_matrix(frags[c, nt, s])
        want = np.zeros_like(B)
        for dy in range(h):
            for dx in range(win_w):
                want[4 * (dy * nw4 + dx // 4) + dx % 4, :G] = templates[c, :, dy, dx]
        np.testing.assert_array_equal(B, want)


def test_kernel_constants():
    """The mirror above holds the kernel's own constants, and the launcher
    computes k-steps and the pitch as ssd_plan does."""
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr (?:int|size_t) (\w+) = ([^;]+);", src))
    assert {k: int(eval(consts[k])) for k in ("MS", "NWARPS", "KH", "SMEM_MAX")} == {
        "MS": MS, "NWARPS": NWARPS, "KH": KH, "SMEM_MAX": S.SMEM_MAX}
    assert S.MMA_STRIPS == MS
    assert "const int nks = (h * nw4 + 7) / 8;" in src
    assert "const int pitch = (crop_w + 4 * nw4 + 4 + 3) & ~3;" in src
    assert "h) * win_w * 65025LL < (1LL << 31) && smem <= SMEM_MAX" in src


# --- K4p: the PARTIAL instance's walk ------------------------------------------


def model_ssd_partial(strips, templates, tsq, wx0, g0, warps, white):
    """csrc/focr_ssd.cu's K4p block (k4p_block) in NumPy: strips u8 [N, h,
    crop_w] -> (key int64 [N, C], white bool [N] or None). A block of
    ``warps`` cells stages columns [xa, xs) of its 16 strips (whole 16-byte
    pieces from its first cell's, every byte below crop_w) at x - xa in rows
    of partial_pitch bytes, and zeroes each row from min(xs, crop_w) to the
    pitch; the two touch no byte in common. White flags: the y-blocks of an
    M-tile share its strips, strip m to block m mod gridDim.y, each reading
    its strips' whole rows. Lanes and quads keep plain minima of packed
    keys."""
    N, h, crop_w = strips.shape
    C, G, _, win_w = templates.shape
    pitch = S.partial_pitch(wx0, crop_w, h, win_w, warps)
    nks, nw4 = S.k_steps(h, win_w), -(-win_w // 4)
    assert pitch > 0 and pitch % 16 == 0
    assert nks * 32 + MS * h * pitch <= S.SMEM_MAX
    bfrag = S.pack_template_fragments(torch.from_numpy(templates)).numpy().view(np.uint32)
    NT = -(-G // 8)
    gy = -(-C // warps)
    koff = np.array([(w // nw4) * pitch + 4 * (w % nw4) if w // nw4 < h else 0
                     for w in range(nks * 8)])
    key = np.full((N, C), -1, np.int64)
    flags = np.full(N, -1, np.int8) if white else None
    x0s = np.clip(wx0.astype(np.int64), 0, crop_w)
    for m0, c0 in ((m0, c0) for m0 in range(0, N, MS) for c0 in range(0, C, warps)):
        ms = min(MS, N - m0)
        cells = x0s[c0 : c0 + warps]
        xa = int(cells.min()) & ~15
        xe = min(crop_w, (int(cells.max()) & ~3) + 4 * nw4 + 4)
        xs = xa + 16 * (-(-(xe - xa) // 16))
        assert xs - xa <= pitch
        st = np.full((MS * h, pitch), 0xA5, np.uint8)  # what the block's memory held
        zeroed = np.zeros(pitch, bool)
        zeroed[min(xs, crop_w) - xa :] = True
        staged = np.zeros(pitch, bool)
        staged[: min(xs, crop_w) - xa] = True
        assert not (zeroed & staged).any()  # no byte both staged and zeroed
        st[:, zeroed] = 0
        rows = 255 - strips[m0 : m0 + ms].reshape(ms * h, crop_w)
        st[: ms * h, staged] = rows[:, xa : min(xs, crop_w)]
        if white:  # this block's strips: m = y, y + gy, ... below ms
            for m in range(c0 // warps, ms, gy):
                assert flags[m0 + m] == -1  # one block a strip
                flags[m0 + m] = (strips[m0 + m] == 255).all()
        words = st.reshape(-1).view("<u4").astype(np.uint64)
        for c in range(c0, min(C, c0 + warps)):  # a warp a cell
            x0 = int(x0s[c])
            sh = (x0 & 3) * 8
            lo = GQ * h * pitch + (x0 & ~3) - xa
            hi = lo + 8 * h * pitch
            best = np.full((2, 32), I64_MAX)  # strips gq, gq + 8
            for nt in range(NT):
                acc = np.zeros((32, 4), np.int64)
                for s in range(nks):
                    o0, o1 = koff[8 * s + TQ], koff[8 * s + TQ + 4]
                    regs = np.stack([_funnel(words[(b + o) // 4], words[(b + o) // 4 + 1], sh)
                                     for b, o in ((lo, o0), (hi, o0), (lo, o1), (hi, o1))], axis=1)
                    Cm = _a_matrix(regs) @ _b_matrix(bfrag[c, nt, s])
                    for i in range(4):
                        acc[:, i] += Cm[GQ + 8 * (i >> 1), 2 * TQ + (i & 1)]
                assert np.abs(acc).max(initial=0) < 2**31  # s32, exact
                for e in range(2):
                    g = 8 * nt + 2 * TQ + e
                    t = tsq[c, np.minimum(g, G - 1)]
                    for half in range(2):
                        k = S.pack_key(t - 2 * acc[:, 2 * half + e], g0 + g)
                        best[half] = np.where(g < G, np.minimum(best[half], k), best[half])
            for d in (1, 2):  # the quad's xor-shuffles: plain minima of keys
                best = np.minimum(best, best[:, LANE ^ d])
            for lane in np.flatnonzero(TQ == 0):
                for half in range(2):
                    m = GQ[lane] + 8 * half
                    if m < ms:
                        key[m0 + m, c] = best[half, lane]
    assert (key >= 0).all()
    if white:
        assert (flags >= 0).all()  # every strip's flag written
        flags = flags.astype(bool)
    return key, flags


def _check_partial(strips, templates, tsq, wx0, warps, g0=0, white=True):
    key, flags = model_ssd_partial(strips, templates, tsq, wx0, g0, warps, white)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (strips[None], templates, tsq, wx0)]
    key_r, white_r = S.ssd_argmin_partial_reference(*args, g0=g0, white=white)
    np.testing.assert_array_equal(key, key_r[0].numpy())
    if white:
        np.testing.assert_array_equal(flags, white_r[0].numpy())
    else:
        assert flags is None and white_r is None
    return key


@pytest.mark.parametrize("win_w", [1, 3, 4, 5, 9, 13])
@pytest.mark.parametrize("G", [1, 8, 9, 67, 200])
def test_partial_walk_matches_plain_version(G, win_w):
    """test_tile_walk_matches_plain_version's cases through the PARTIAL
    walk, the block size, the white flag and the shard's first glyph varied
    with the case."""
    h = (1, 3, 12)[(G + win_w) % 3]
    crop_w = 4 * win_w + 7
    wx0 = [0, 3, crop_w - win_w, crop_w - 2, crop_w]
    _check_partial(*_case(21, h, crop_w, 5, G, win_w, seed=G * 100 + win_w, wx0=wx0),
                   warps=(1, 2, 3, 5)[(G + win_w) % 4], g0=G * win_w, white=bool(win_w % 2))


@pytest.mark.parametrize("warps", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("order", ["ascending", "shuffled"])
def test_partial_walk_block_sizes(order, warps):
    """40 cells over blocks of 1 to 16 cells: each block stages only its own
    window, from a 16-byte piece up to 15 bytes before its first cell, in
    rows of the widest window's pitch; the first shard's blocks of grid.y 0
    still read whole rows for the white flags."""
    _check_partial(*columns_case(order), warps=warps, g0=68, white=order == "ascending")


@pytest.mark.parametrize("warps", [1, 2, 3, 4])
@pytest.mark.parametrize("N", [1, 15, 16, 17, 33, 65])
def test_partial_walk_strip_counts(N, warps):
    """Strip counts around the M-tile of 16, over 4 cells in blocks of 1-4:
    the last M-tile may be partial, and its strips' white flags are shared
    out over the M-tile's y-blocks (more blocks than strips, or fewer)."""
    _check_partial(*_case(N, 12, 40, 4, 11, 9, seed=N), warps=warps, white=N % 2 == 1 or warps == 1)


def test_partial_walk_exact_ties():
    """Duplicated and empty glyphs tie exactly: the lowest glyph's key is the
    smallest, across a quad's lanes and across n-tiles."""
    strips, templates, tsq, wx0 = _case(18, 12, 60, 6, 30, 9, seed=7)
    templates[:, 20] = templates[:, 28] = templates[:, 3]
    templates[:, [5, 12, 17, 25]] = 0
    tsq = (templates.astype(np.int64) ** 2).sum(axis=(2, 3))
    strips[4:9] = 255
    key = _check_partial(strips, templates, tsq, wx0, warps=4, g0=1000)
    gid = S.unpack_key(key)[1] - 1000
    assert not np.isin(gid, [20, 28, 12, 17, 25]).any() and (gid[4:9] == 5).all()


def test_partial_plan():
    """K4p's pitch on the canonical grid: the widest 16-byte-aligned window
    of a block, 144 bytes at 16 cells a block (~28 KB of shared memory at
    h = 12, where K4's whole rows take ~121 KB); the int64 instance where the
    dot may pass 2^31 or the window's rows do not fit."""
    wx0 = np.array([0, 7, 15, 23, 31, 39, 46, 54, 62, 70, 78, 86, 93, 101, 109, 117, 125, 133]
                   + [140 + 7.8 * i for i in range(60)], np.float64).astype(np.int32)
    assert S.partial_pitch(wx0, 608, 12, 9, 16) == 144
    assert S.partial_pitch(wx0, 608, 12, 9, 1) == 32
    assert S.partial_pitch(np.array([0, 5000]), 40000, 1, 34000, 16) == 0  # dot past 2^31
    assert S.partial_pitch(np.array([0, 9000]), 40000, 12, 2000, 16) == 0  # no room
    assert S.partial_pitch(np.array([0, 2800]), 3000, 12, 9, 16) == 0  # one block, too wide
    assert S.partial_pitch(np.array([0, 2800]), 3000, 12, 9, 1) == 16  # K4 takes int64 here
    assert S.ssd_plan(12, 3000, 9)[0] == "int64"
    # one cell a block has the narrowest windows (shard_bank packs the
    # templates when the mma instance runs there)
    for cells in (wx0, columns_case("shuffled")[3]):
        p1 = S.partial_pitch(cells, 608, 12, 9, 1)
        assert all(S.partial_pitch(cells, 608, 12, 9, w) >= p1 for w in range(1, 17))


def test_partial_kernel_constants():
    """The key's constants, the shard count K6 takes and K4p's most warps a
    block are the kernel's; the launcher passes the pitch it is given."""
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr (?:int|long long) (\w+) = ([^;]+);", src))
    got = {k: int(eval(consts[k].replace("LL", ""))) for k in
           ("KEY_SHIFT", "KEY_BIAS", "MAX_SHARDS", "PMAXW")}
    assert got == {"KEY_SHIFT": S.KEY_SHIFT, "KEY_BIAS": S.KEY_BIAS, "MAX_SHARDS": S.MAX_SHARDS,
                   "PMAXW": S.MAX_PARTIAL_WARPS}
    assert 1 <= S.PARTIAL_WARPS <= S.MAX_PARTIAL_WARPS
    assert "+ static_cast<size_t>(MS) * sh->h * pitch;" in src
    assert [f for f, _ in S._ShardArgs._fields_] == re.findall(
        r"(\w+)[,;]", src[src.index("struct FocrSsdShard {"):src.index("};", src.index(
            "struct FocrSsdShard {"))].split("{", 1)[1].replace("const void* ", "").replace(
                "int ", ""))


# --- K6 over more than MAX_SHARDS shards: the fold plan ---------------------------


def model_combine(keys: list[np.ndarray]) -> np.ndarray:
    """K6 as the card runs it (csrc/focr_ssd.cu): fold_plan's launches, each
    of focr_ssd_fold_kernel's grid rows y taking keys y·MAX_SHARDS on, up to
    MAX_SHARDS of them, to their smallest key (whole), the rows in launch
    order the next level's keys; then focr_ssd_combine_kernel over at most
    MAX_SHARDS keys, the smallest key's low KEY_SHIFT bits."""
    cur = list(keys)
    for level in S.fold_plan(len(cur)):
        assert [k0 for k0, _ in level] == list(range(0, len(cur), S.FOLD_PTRS))
        assert sum(cnt for _, cnt in level) == len(cur)
        nxt = []
        for k0, cnt in level:
            assert 1 <= cnt <= S.FOLD_PTRS
            for y in range(-(-cnt // S.MAX_SHARDS)):
                base = y * S.MAX_SHARDS
                m = min(cnt - base, S.MAX_SHARDS)
                best = cur[k0 + base]
                for s in range(1, S.MAX_SHARDS):
                    if s < m:
                        best = np.minimum(best, cur[k0 + base + s])
                nxt.append(best)
        cur = nxt
    assert 1 <= len(cur) <= S.MAX_SHARDS
    best = cur[0]
    for s in range(1, S.MAX_SHARDS):
        if s < len(cur):
            best = np.minimum(best, cur[s])
    return (best & ((1 << S.KEY_SHIFT) - 1)).astype(np.int32)


@pytest.mark.parametrize("n_g", [1, 2, 8, 9, 16, 17, 63, 64, 65, 72, 513, 600])
def test_fold_plan_matches_plain_version(n_g):
    """The card's walk over fold_plan's launches gives the plain K6's glyphs
    on keys with ties across shards, the minimum in the last shard and
    padded copies of glyph 0."""
    rng = np.random.default_rng(n_g)
    n = 41
    Gl = S.GID_LIMIT // n_g
    metrics = rng.integers(-1, 2, (n_g, n)).astype(np.int64) * 10**9
    gids = rng.integers(0, Gl, (n_g, n)) + (np.arange(n_g, dtype=np.int64) * Gl)[:, None]
    metrics[-1, :5] = -2 * 10**9  # the minimum in the last shard
    metrics[:, 5:9], gids[0, 5:9] = -10**9 - 7, 0  # glyph 0 ties every later shard
    keys = S.pack_key(metrics, gids)
    got = model_combine(list(keys))
    want = S.first_min_combine_reference([torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got[:5], gids[-1, :5])
    np.testing.assert_array_equal(got[5:9], 0)


def test_fold_plan_launches():
    """No fold up to MAX_SHARDS keys; one fold launch up to FOLD_PTRS (9 to
    64 shards: two launches a combine); a second level past FOLD_PTRS."""
    assert [S.fold_plan(n) for n in (1, 8)] == [[], []]
    assert S.fold_plan(9) == [[(0, 9)]] and S.fold_plan(17) == [[(0, 17)]]
    assert S.fold_plan(64) == [[(0, 64)]]
    assert S.fold_plan(65) == [[(0, 64), (64, 1)], [(0, 9)]]
    assert S.fold_plan(600) == [[(0, 64), (64, 64), (128, 64), (192, 64), (256, 64), (320, 64),
                                 (384, 64), (448, 64), (512, 64), (576, 24)], [(0, 64), (64, 11)],
                                [(0, 10)]]


def test_fold_kernel_constants():
    """The fold pass's pointer count and group size are the kernel's, and
    its launcher's grid rows are the groups."""
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["FOLD_PTRS"]) == S.FOLD_PTRS and int(consts["MAX_SHARDS"]) == S.MAX_SHARDS
    assert S.FOLD_PTRS % S.MAX_SHARDS == 0
    assert "(n_k + MAX_SHARDS - 1) / MAX_SHARDS);" in src
    assert "const int base = blockIdx.y * MAX_SHARDS;" in src
