"""The ncc device stage: K1 (the NCC sweep) and K2 (candidate compaction),
each a hand-written CUDA kernel (csrc/) beside its plain PyTorch version.

Counterpart of focr_tpu/ops/pallas_ncc.py. The wrappers ``ncc_sweep`` and
``compact_hits`` run the plain version for a tensor on the CPU and launch the
kernel for a tensor on a CUDA card; there is no fallback between the two. Each
wrapper counts its kernel launches in ``LAUNCHES``.

Semantics (pallas_ncc.py:12-20): the sweep's mask is an ε-superset of the
reference's accept set over the search domain y >= 1, x >= 1; K3
(ops/replay_kernels.py) replays every candidate in exact f64 on the card, so
results are bit-identical to the oracle. The sweep has two tiers (``sweep_tier``), each an instance of
the kernel:

  narrow — focr_tpu's Pallas test (pallas_ncc.py:205-220), division-free,
           num > (thr−ε) · rtn · sqrt(max(norm2p − 8, 0)) − 48; it holds for
           needles with n·65025 < 2²⁴ (every sum is f32-exact) and thr−ε > 0;
  wide   — focr_tpu's XLA tier (ops/ncc.py::ncc_candidates :193-232) for
           every other needle below focr_tpu's own bound n·65025 < 2³¹ (its
           i32 correlate): f32 sums that may round, an exact int64 validity
           test, den_lo or den_hi by the sign of thr−ε, and a slack that
           covers the roundings.

Past n·65025 >= 2³¹ both versions raise, as focr_tpu cannot run there.

K1 has two designs (csrc/ncc_sweep.cu), picked by ``sweep_plan`` from the
shape alone: the wgmma instance for every shape whose needles' k-steps fit
its registers (every shape of the main path), and PR 5's mma.sync instance
for the rest (very tall or wide needles). Each packs the needles its own way
once a bank (``pack_needles``) and counts its launches under its own key.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from focr_tpu_torch.ops.ncc import window_stats, word_stride
from focr_tpu_torch.utils.device import count_launch, launch_stream

EPS = 1e-3
# K1's wgmma instance under "ncc_sweep", its mma instance under "ncc_sweep_mma"
LAUNCHES = {"ncc_sweep": 0, "ncc_sweep_mma": 0, "compact_count": 0, "compact_hits": 0}
# the wgmma instance's constants, as csrc/ncc_sweep.cu declares them: needles
# a wgmma (WG_N: B's sub-chunks) and k-steps of A held in registers by tier
WG_N = 128
WG_KA = {"narrow": 8, "wide": 12}
COMPACT_CHUNK = 1024 * 8  # csrc/ncc_compact.cu's CHUNK: mask rows a count block scans


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sweep_tier(n: int, threshold: float, eps: float = EPS) -> str:
    """"narrow" (pallas_ncc.pallas_supported :1014-1023 minus its VMEM terms)
    or "wide" (the XLA tier) for needles of n pixels; raises past focr_tpu's
    own bound n·65025 < 2³¹."""
    if n * 65025 >= 2**31:
        raise ValueError(
            f"ncc sweep: a needle of {n} pixels is past focr_tpu's bound n*65025 < 2^31 "
            "(its int32 correlation)"
        )
    if n * 65025 < 2**24 and np.float32(threshold) - np.float32(eps) > 0:
        return "narrow"
    return "wide"


def sweep_terms(
    s_n: torch.Tensor, s2_n: torch.Tensor, n: int, threshold: float, eps: float = EPS
) -> tuple[torch.Tensor, torch.Tensor, float]:
    """Per-needle f32 terms (sn_n, rtn) and thr−ε of the needles' tier,
    computed on the CPU from the EXACT int64 norm² n·Σn² − (Σn)² (f32 could
    flip a tiny positive variance to <= 0), then /n in f32:

      narrow — as pallas_ncc.py:309-321: sn_n = Σn/n, rtn = √norm², +inf
               for a zero-variance needle (it fails every compare);
      wide   — as ncc_candidates :197-228: sn_n = f32(Σn), rtn = the
               needle's factor of den_lo (thr−ε >= 0) or den_hi (below), NaN
               for a zero-variance needle (it fails every compare)."""
    s_n = s_n.detach().to("cpu", torch.int64)
    s2_n = s2_n.detach().to("cpu", torch.int64)
    nf = torch.tensor(n, dtype=torch.float32)
    norm2 = n * s2_n - s_n * s_n
    n2n = norm2.to(torch.float32) / nf
    thr_eps = float(np.float32(threshold) - np.float32(eps))
    if sweep_tier(n, threshold, eps) == "narrow":
        rtn = torch.where(n2n > 0, torch.sqrt(n2n), torch.tensor(float("inf")))
        return s_n.to(torch.float32) / nf, rtn, thr_eps
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    if thr_eps >= 0:
        rn = torch.sqrt(torch.maximum(n2n * f32(1.0 - 2.0**-22), f32(0.0)))
    else:
        rn = torch.sqrt(n2n * f32(1.0 + 2.0**-22))
    return s_n.to(torch.float32), torch.where(norm2 > 0, rn, f32(float("nan"))), thr_eps


def wide_scalars(n: int, thr_eps: float) -> tuple[float, float, float, float]:
    """The wide test's f32 scalars (inv_n, ±err_p, the den factor, slack),
    as ncc_candidates computes them (:193, :215-229)."""
    lo = thr_eps >= 0
    err = np.float32(8.0 * 2.0**-24 * n * 65025)
    return (
        float(np.float32(1.0) / np.float32(n)),
        float(-err if lo else err),
        float(np.float32(1.0 - 2.0**-21) if lo else np.float32(1.0 + 2.0**-21)),
        float(np.float32(32.0 * 2.0**-24 * n * 65025 + 16.0)),
    )


def _sweep_shapes(imgs: torch.Tensor, needles: torch.Tensor) -> tuple[int, ...]:
    if imgs.dim() != 3 or needles.dim() != 3:
        raise ValueError("ncc sweep: imgs [B, H, W] and needles [T, nh, nw] expected")
    B, H, W = imgs.shape
    T, nh, nw = needles.shape
    if B == 0 or T == 0 or nh > H or nw > W:
        raise ValueError(f"ncc sweep: no windows for pages {tuple(imgs.shape)}, "
                         f"needles {tuple(needles.shape)}")
    return B, H, W, T, nh, nw


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add a·b + c with ONE rounding (CUDA's __fmaf_rn),
    in plain PyTorch: the product of two f32s is exact in f64, TwoSum gives
    the f64 sum's rounding error exactly, and that error decides the one case
    where rounding the f64 sum to f32 would round twice — a sum that landed
    exactly halfway between two f32s."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)  # p + cd == s + err exactly
    r = s.to(torch.float32)
    nxt = torch.nextafter(r, torch.where(s > r.to(torch.float64), torch.inf, -torch.inf).to(torch.float32))
    half = (nxt.to(torch.float64) - r.to(torch.float64)) / 2
    tie = (s - r.to(torch.float64)) == half
    wrong_way = tie & (err != 0) & ((err > 0) == (half > 0))
    return torch.where(wrong_way, nxt, r)


def ncc_sweep_reference(
    imgs: torch.Tensor,  # [B, H, W] u8 inverted pages
    needles: torch.Tensor,  # [T, nh, nw] u8
    s_n: torch.Tensor,  # [T] i64
    s2_n: torch.Tensor,  # [T] i64
    threshold: float,
    eps: float = EPS,
    terms: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1, on the tensors' device: mask int32 [B, T, Hs, NW]
    (bit k of word g is window column x = 32g+k) and rcnt int32 [B, T, Hs].

    The correlation is unfold + float64 matmul (exact: integer products <=
    65025, sums < 2³¹), in row chunks so a full page fits in memory; never a
    convolution. The narrow tier's f32 test is pallas_ncc.py:205-220 op for
    op, with three multiply-adds fused (one rounding each), as XLA compiles
    them for focr_tpu's CPU reference (it always allows FMA fusion):

        norm2p = fma(-(sp·sp), f32(1/n), s2p)
        num    = fma(-sn_n, sp, acc)
        keep   = num > fma(thr−ε, rtn·q, -48)

    A fused op rounds once where the separate ops round twice, so it stays
    inside the −8 and −48 error bounds the test was derived with: the
    candidate set is still a certified superset. The wide tier's test is
    ncc_candidates :193-232 op for op, unfused (see csrc/ncc_sweep.cu)."""
    B, H, W, T, nh, nw = _sweep_shapes(imgs, needles)
    dev = imgs.device
    n = nh * nw
    wide = sweep_tier(n, threshold, eps) == "wide"
    Hs, Wv = H - nh + 1, W - nw + 1
    NW = word_stride(W, nw)
    W1 = NW * 32
    sn_n, rtn, thr_eps = terms if terms is not None else sweep_terms(
        s_n, s2_n, n, threshold, eps
    )
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    sn_n = sn_n.to(dev)[:, None, None]
    rtn = rtn.to(dev)[:, None, None]
    inv_n, thr, m8, m48 = f32(np.float32(1.0 / n)), f32(thr_eps), f32(8.0), f32(48.0)
    inf, zero = f32(float("inf")), f32(0.0)
    if wide:
        inv_n, err, c_den, slack = (f32(v) for v in wide_scalars(n, thr_eps))
        nf = f32(float(n))

    sp, s2p = window_stats(imgs, nw, nh)  # int64 [B, Hs, Wv]
    nd = needles.reshape(T, n).to(torch.float64).T  # [n, T]
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dev), torch.arange(32, device=dev)
    )
    mask = torch.empty((B, T, Hs, NW), dtype=torch.int32, device=dev)
    rcnt = torch.empty((B, T, Hs), dtype=torch.int32, device=dev)
    xs = torch.arange(Wv, device=dev)
    # rows per chunk: ~64 MB of f64 windows, ~32 MB per f64 test temporary
    rows = max(1, min((1 << 23) // (Wv * n), (1 << 22) // (Wv * T)))
    for b in range(B):
        for y0 in range(0, Hs, rows):
            y1 = min(Hs, y0 + rows)
            R = y1 - y0
            win = imgs[b, y0 : y1 + nh - 1].to(torch.float64).unfold(0, nh, 1).unfold(1, nw, 1)
            acc = (win.reshape(R * Wv, n) @ nd).to(torch.float32)
            acc = acc.reshape(R, Wv, T).permute(2, 0, 1)  # [T, R, Wv]
            spf = sp[b, y0:y1].to(torch.float32)
            s2pf = s2p[b, y0:y1].to(torch.float32)
            ys = torch.arange(y0, y1, device=dev)
            in_domain = (ys[:, None] >= 1) & (xs[None, :] >= 1)
            if wide:
                norm2p = s2pf - (spf * spf) / nf
                var = n * s2p[b, y0:y1] - sp[b, y0:y1] * sp[b, y0:y1]
                row_ok = (sp[b, y0:y1] > 0) & (var > 0) & in_domain
                num = acc - (sn_n * spf) * inv_n
                den = (rtn * torch.sqrt(torch.maximum(norm2p + err, zero))) * c_den
                keep = row_ok & (num > thr * den - slack)  # [T, R, Wv]
            else:
                norm2p = _fma32(-(spf * spf), inv_n, s2pf)
                num = _fma32(-sn_n, spf, acc)
                row_ok = (spf > 0) & (norm2p > -m8) & in_domain
                q = torch.where(row_ok, torch.sqrt(torch.maximum(norm2p - m8, zero)), inf)
                keep = num > _fma32(thr, rtn * q, -m48)  # [T, R, Wv]
            keep = torch.nn.functional.pad(keep, (0, W1 - Wv))
            words = (keep.reshape(T, R, NW, 32).to(torch.int64) * weights).sum(-1)
            mask[b, :, y0:y1] = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
            rcnt[b, :, y0:y1] = keep.sum(-1, dtype=torch.int32)
    return mask, rcnt


def k_steps(nh: int, nw: int) -> int:
    """The kernel's k-steps of 32 bytes: the needle as 4-byte words (dy, q),
    each row padded to ceil(nw/4) words, the total padded to a multiple of 8
    words (4 for 13x8, 5 for 13x9)."""
    return -(-nh * -(-nw // 4) // 8)


def fragment_index(T: int, nh: int, nw: int) -> np.ndarray:
    """Where each byte of the mma instance's A fragments comes from: int64
    [ceil(T/16), nks, 32, 16], byte 4i+j of lane L's four registers for
    (M-tile mt, k-step s) is the flat index into needles [T, nh, nw] of its
    needle byte, or T·nh·nw for a zero byte.

    mma.sync.m16n8k32 with A row-major (PTX ISA, the .u8 fragment layout):
    register i of lane L = 4g + tq holds row g + 8·(i & 1) — needle
    16·mt + g + 8·(i & 1) — and k bytes 32s + 4tq + 16·(i >> 1) + j, i.e.
    k-word w = 8s + tq + 4·(i >> 1), which is needle word (dy, q) =
    divmod(w, ceil(nw/4)) and pixel dx = 4q + j. Bytes past nw, past the
    needle's last word and past T are zero."""
    nks, nw4 = k_steps(nh, nw), -(-nw // 4)
    mt, s, lane, i, j = np.ix_(np.arange(-(-T // 16)), np.arange(nks), np.arange(32),
                               np.arange(4), np.arange(4))
    t = 16 * mt + (lane >> 2) + 8 * (i & 1)
    w = 8 * s + (lane & 3) + 4 * (i >> 1)
    dy, dx = w // nw4, 4 * (w % nw4) + j
    idx = (t * nh + dy) * nw + dx
    real = (t < T) & (dy < nh) & (dx < nw)
    return np.where(real, idx, T * nh * nw).reshape(-1, nks, 32, 16)


def pack_needle_fragments(needles: torch.Tensor) -> torch.Tensor:
    """[T, nh, nw] u8 -> the mma instance's A operand, int32 [ceil(T/16),
    nks, 32, 4] on the needles' device: one uint4 fragment a lane for each
    (M-tile, k-step), laid out by fragment_index."""
    idx = torch.from_numpy(fragment_index(*needles.shape)).to(needles.device)
    flat = torch.cat([needles.reshape(-1), needles.new_zeros(1)])
    return flat[idx].view(torch.int32)


@dataclass(frozen=True)
class SweepPlan:
    """K1's instance for one shape (``sweep_plan``): "wgmma" or "mma", and
    the needles' k-steps."""

    instance: str
    nks: int

    @property
    def key(self) -> str:
        """Its name in LAUNCHES."""
        return "ncc_sweep" if self.instance == "wgmma" else "ncc_sweep_mma"


@functools.lru_cache(maxsize=None)
def sweep_plan(nh: int, nw: int, tier: str) -> SweepPlan:
    """The static plan of K1 for needles of nh x nw in ``tier``: the wgmma
    instance where the needle's k-steps fit its registers (WG_KA), else the
    mma instance. The launcher sizes the wgmma blocks itself (up to 256
    needles, the rest on grid.z; every such block fits shared memory)."""
    nks = k_steps(nh, nw)
    return SweepPlan("wgmma" if nks <= WG_KA[tier] else "mma", nks)


def tile_index(T: int, nh: int, nw: int) -> np.ndarray:
    """Where each byte of the wgmma instance's B comes from: int64
    [ceil(T/n), nks, 32·n] for n = WG_N needles a wgmma; byte o of (sub-chunk
    c, k-step s) is the flat index into needles [T, nh, nw] of its needle
    byte, or T·nh·nw for a zero byte.

    wgmma's canonical K-major layout without swizzle: core matrices of 8
    needles x 16 bytes, 128 contiguous bytes; the two core matrices of a
    k-step's 32 bytes 128 apart (LBO), consecutive groups of 8 needles 256
    apart (SBO). So byte o is needle n·c + 8·(o >> 8) + ((o >> 4) & 7) and
    k-byte 16·((o >> 7) & 1) + (o & 15) of k-step s, i.e. k-word w = 8s +
    kbyte/4, needle word (dy, q) = divmod(w, ceil(nw/4)) and pixel dx = 4q +
    kbyte % 4. Bytes past nw, past the needle's last word and past T are
    zero."""
    nks, nw4, n = k_steps(nh, nw), -(-nw // 4), WG_N
    c, s, o = np.ix_(np.arange(-(-T // n)), np.arange(nks), np.arange(n * 32))
    t = n * c + 8 * (o >> 8) + ((o >> 4) & 7)
    kb = 16 * ((o >> 7) & 1) + (o & 15)
    w = 8 * s + (kb >> 2)
    dy, dx = w // nw4, 4 * (w % nw4) + (kb & 3)
    idx = (t * nh + dy) * nw + dx
    return np.where((t < T) & (dy < nh) & (dx < nw), idx, T * nh * nw)


def pack_needle_tiles(needles: torch.Tensor) -> torch.Tensor:
    """[T, nh, nw] u8 -> the wgmma instance's B, u8 [ceil(T/WG_N), nks,
    32·WG_N] on the needles' device, laid out by tile_index: a block copies
    its sub-chunks into shared memory as they are."""
    idx = torch.from_numpy(tile_index(*needles.shape)).to(needles.device)
    flat = torch.cat([needles.reshape(-1), needles.new_zeros(1)])
    return flat[idx]


def pack_needles(needles: torch.Tensor, plan: SweepPlan) -> torch.Tensor:
    """The needles as ``plan``'s instance takes them: pack_needle_tiles for
    the wgmma instance, pack_needle_fragments for the mma instance. The
    matcher packs each needle group once (models/ncc.py::DeviceGroup)."""
    if plan.instance == "wgmma":
        return pack_needle_tiles(needles)
    return pack_needle_fragments(needles)


def _packed_shape(T: int, plan: SweepPlan) -> tuple[tuple[int, ...], torch.dtype]:
    if plan.instance == "wgmma":
        return (-(-T // WG_N), plan.nks, WG_N * 32), torch.uint8
    return (-(-T // 16), plan.nks, 32, 4), torch.int32


def ncc_sweep(
    imgs: torch.Tensor,
    needles: torch.Tensor,
    s_n: torch.Tensor,
    s2_n: torch.Tensor,
    threshold: float,
    eps: float = EPS,
    terms: tuple | None = None,
    packed: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 (csrc/ncc_sweep.cu) for CUDA tensors, ncc_sweep_reference for CPU
    tensors; the needles' tier picks the test's instance and sweep_plan the
    design (wgmma or mma). ``terms`` and ``packed``: precomputed sweep_terms
    and pack_needles of these needles for their plan (the matcher's device
    groups carry them). The wgmma instance reads the pages as 4-byte words:
    ``imgs`` must start 4-byte aligned."""
    if imgs.device.type == "cpu":
        return ncc_sweep_reference(imgs, needles, s_n, s2_n, threshold, eps, terms)
    if imgs.device.type != "cuda":
        raise ValueError(f"ncc_sweep: unsupported device {imgs.device}")
    B, H, W, T, nh, nw = _sweep_shapes(imgs, needles)
    n = nh * nw
    tier = sweep_tier(n, threshold, eps)
    wide = tier == "wide"
    for name, t, dt in (("imgs", imgs, torch.uint8), ("needles", needles, torch.uint8)):
        if t.dtype != dt or not t.is_contiguous() or t.device != imgs.device:
            raise ValueError(f"ncc_sweep: {name} must be contiguous {dt} on {imgs.device}")
    plan = sweep_plan(nh, nw, tier)
    if plan.instance == "wgmma" and imgs.data_ptr() % 4:
        raise ValueError("ncc_sweep: imgs must start 4-byte aligned")
    sn_n, rtn, thr_eps = terms if terms is not None else sweep_terms(
        s_n, s2_n, n, threshold, eps
    )
    sn_n = sn_n.to(imgs.device, torch.float32).contiguous()
    rtn = rtn.to(imgs.device, torch.float32).contiguous()
    Hs = H - nh + 1
    NW = word_stride(W, nw)
    mask = torch.empty((B, T, Hs, NW), dtype=torch.int32, device=imgs.device)
    # the wgmma instance writes every row count; the mma instance adds to them
    rcnt = (torch.empty if plan.instance == "wgmma" else torch.zeros)(
        (B, T, Hs), dtype=torch.int32, device=imgs.device)
    inv_n, err, c_den, slack = (
        wide_scalars(n, thr_eps) if wide else (float(np.float32(1.0 / n)), 0.0, 0.0, 0.0)
    )
    if packed is None:
        packed = pack_needles(needles, plan)
    shape, dtype = _packed_shape(T, plan)
    if tuple(packed.shape) != shape or (
        packed.dtype != dtype or not packed.is_contiguous() or packed.device != imgs.device
    ):
        raise ValueError(f"ncc_sweep: packed must be pack_needles(needles) for the "
                         f"{plan.instance} instance")
    if packed.data_ptr() % 16:
        raise ValueError("ncc_sweep: packed must start 16-byte aligned")
    from focr_tpu_torch.native.build import load

    with launch_stream(imgs) as stream:
        rc = load().focr_ncc_sweep(
            imgs.data_ptr(), B, H, W, packed.data_ptr(), T, nh, nw,
            sn_n.data_ptr(), rtn.data_ptr(), thr_eps, inv_n,
            mask.data_ptr(), rcnt.data_ptr(), stream,
            int(wide), err, c_den, slack,
            int(plan.instance == "mma"),
        )
    if rc != 0:
        raise RuntimeError(f"ncc_sweep kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, plan.key)
    return mask, rcnt


def compact_hits_reference(
    mask: torch.Tensor, rcnt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2, on the tensors' device. From the sweep's mask int32
    [B, T, Hs, NW] and row counts [B, T, Hs]: (pos int32 [N] — every page's
    set bits as needle-local y·W1 + x in (needle, y, x) scan order, pages
    concatenated; off int64 [B+1] — page b owns pos[off[b]:off[b+1]];
    hcnt int32 [B, T] candidates per needle; nz int32 [B] per page)."""
    B, T, Hs, NW = mask.shape
    W1 = NW * 32
    shifts = torch.arange(32, device=mask.device)
    bits = ((mask.to(torch.int64)[..., None] >> shifts) & 1).bool()
    bits = bits.reshape(B, T, Hs, W1)
    pos = []
    for b in range(B):
        tyx = torch.nonzero(bits[b])  # row-major: (t, y, x) scan order
        pos.append((tyx[:, 1] * W1 + tyx[:, 2]).to(torch.int32))
    hcnt = rcnt.sum(-1, dtype=torch.int32)
    nz = hcnt.sum(-1, dtype=torch.int32)
    off = torch.zeros(B + 1, dtype=torch.int64, device=mask.device)
    off[1:] = torch.cumsum(nz.to(torch.int64), 0)
    return torch.cat(pos), off, hcnt, nz


def compact_counts_reference(rcnt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2's count kernel, on rcnt's device. From the row
    counts int32 [B, T, Hs]: (row_off int64 [B·T·Hs] — the exclusive prefix
    over every mask row, pages included: each row's offset in the output;
    head uint8 — off int64 [B+1], hcnt int32 [B, T] and nz int32 [B] back
    to back, the one small buffer the host fetches; split_counts reads
    it)."""
    B, T, _ = rcnt.shape
    flat = rcnt.reshape(-1).to(torch.int64)
    row_off = torch.cumsum(flat, 0) - flat
    hcnt = rcnt.sum(-1, dtype=torch.int32)
    nz = hcnt.sum(-1, dtype=torch.int32)
    off = torch.zeros(B + 1, dtype=torch.int64, device=rcnt.device)
    off[1:] = torch.cumsum(nz.to(torch.int64), 0)
    head = torch.cat([off.view(torch.uint8), hcnt.reshape(-1).view(torch.uint8),
                      nz.view(torch.uint8)])
    return row_off, head


def split_counts(head: torch.Tensor, B: int, T: int):
    """(off int64 [B+1], hcnt int32 [B, T], nz int32 [B]): views of a count
    buffer (compact_counts' head), on its device or on the host."""
    a, b = 8 * (B + 1), 8 * (B + 1) + 4 * B * T
    return (head[:a].view(torch.int64), head[a:b].view(torch.int32).view(B, T),
            head[b : b + 4 * B].view(torch.int32))


def compact_counts(rcnt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's count kernel (csrc/ncc_compact.cu) for a CUDA tensor,
    compact_counts_reference for a CPU one: (row_off, head), one launch."""
    if rcnt.device.type == "cpu":
        return compact_counts_reference(rcnt)
    if rcnt.device.type != "cuda":
        raise ValueError(f"compact_counts: unsupported device {rcnt.device}")
    if rcnt.dim() != 3 or rcnt.dtype != torch.int32 or not rcnt.is_contiguous():
        raise ValueError("compact_counts: rcnt must be contiguous int32 [B, T, Hs]")
    B, T, Hs = rcnt.shape
    rows = B * T * Hs
    n_head = 8 * (B + 1) + 4 * (B * T + B)
    at = -(-n_head // 8) * 8  # the look-back words and the two tickets, zeroed
    blocks = -(-rows // COMPACT_CHUNK)
    buf = torch.zeros(at + 8 * blocks + 8, dtype=torch.uint8, device=rcnt.device)
    head = buf[:n_head]
    off, hcnt, nz = split_counts(head, B, T)
    row_off = torch.empty(rows, dtype=torch.int64, device=rcnt.device)
    if rows:
        from focr_tpu_torch.native.build import load

        with launch_stream(rcnt) as stream:
            rc = load().focr_ncc_compact_count(
                rcnt.data_ptr(), B, T, Hs, row_off.data_ptr(), off.data_ptr(), hcnt.data_ptr(),
                nz.data_ptr(), buf[at:].data_ptr(), buf[at + 8 * blocks :].data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"compact_counts kernel launch failed: CUDA error {rc}")
        count_launch(LAUNCHES, "compact_count")
    return row_off, head


def compact_emit(
    mask: torch.Tensor, rcnt: torch.Tensor, row_off: torch.Tensor, total: int
) -> torch.Tensor:
    """K2's emit kernel (csrc/ncc_compact.cu) for CUDA tensors: pos int32
    [total], every set bit of the mask at its row's offset (row_off and the
    total from compact_counts). For CPU tensors the positions of
    compact_hits_reference."""
    if mask.device.type == "cpu":
        return compact_hits_reference(mask, rcnt)[0]
    if mask.device.type != "cuda":
        raise ValueError(f"compact_emit: unsupported device {mask.device}")
    B, T, Hs, NW = mask.shape
    for name, t, dt in (("mask", mask, torch.int32), ("rcnt", rcnt, torch.int32),
                        ("row_off", row_off, torch.int64)):
        if t.dtype != dt or not t.is_contiguous() or t.device != mask.device:
            raise ValueError(f"compact_emit: {name} must be contiguous {dt} on {mask.device}")
    if rcnt.shape != (B, T, Hs) or row_off.numel() != B * T * Hs:
        raise ValueError(f"compact_emit: rcnt {tuple(rcnt.shape)} or row_off "
                         f"{tuple(row_off.shape)} does not fit mask {tuple(mask.shape)}")
    pos = torch.empty(total, dtype=torch.int32, device=mask.device)
    if total:
        from focr_tpu_torch.native.build import load

        with launch_stream(mask) as stream:
            rc = load().focr_ncc_compact(
                mask.data_ptr(), rcnt.data_ptr(), row_off.data_ptr(), pos.data_ptr(),
                B * T * Hs, Hs, NW, stream,
            )
        if rc != 0:
            raise RuntimeError(f"compact_hits kernel launch failed: CUDA error {rc}")
        count_launch(LAUNCHES, "compact_hits")
    return pos


def to_host(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The tensors on the host after one wait: from a card, a non-blocking
    copy of each into pinned memory on the current stream, then one event
    to wait on; CPU tensors as they are."""
    if not tensors or tensors[0].device.type == "cpu":
        return list(tensors)
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    with torch.cuda.device(tensors[0].device):  # the event belongs to the tensors' card
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return host


def compact_hits(
    mask: torch.Tensor, rcnt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 for CUDA tensors: the count kernel, one wait for the total (the
    output is sized by the exact count, so nothing is ever truncated), then
    the emit kernel; compact_hits_reference for CPU tensors. Returns (pos,
    off, hcnt, nz) on the mask's device."""
    if mask.device.type == "cpu":
        return compact_hits_reference(mask, rcnt)
    B, T, Hs, _ = mask.shape
    if tuple(rcnt.shape) != (B, T, Hs):
        raise ValueError(f"compact_hits: rcnt {tuple(rcnt.shape)} != {(B, T, Hs)}")
    row_off, head = compact_counts(rcnt)
    total = int(split_counts(to_host([head])[0], B, T)[0][-1])
    off, hcnt, nz = split_counts(head, B, T)
    return compact_emit(mask, rcnt, row_off, total), off, hcnt, nz
