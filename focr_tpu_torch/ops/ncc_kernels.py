"""The ncc device stage: K1 (the NCC sweep) and K2 (candidate compaction),
each a hand-written CUDA kernel (csrc/) beside its plain PyTorch version.

Counterpart of focr_tpu/ops/pallas_ncc.py. The wrappers ``ncc_sweep`` and
``compact_hits`` run the plain version for a tensor on the CPU and launch the
kernel for a tensor on a CUDA card; there is no fallback between the two. Each
wrapper counts its kernel launches in ``LAUNCHES``.

Semantics (pallas_ncc.py:12-20): the sweep's mask is an ε-superset of the
reference's accept set over the search domain y >= 1, x >= 1; the matcher
replays every candidate in exact f64 on the host, so results are bit-identical
to the oracle. The test is division-free,

    num > (thr−ε) · rtn · sqrt(max(norm2p − 8, 0)) − 48,

equivalent to sim > thr−ε only for thr−ε > 0, and exact-integer only for
needles with n·65025 < 2²⁴ (``sweep_supported``). Other configurations need
the XLA-tier port (ROADMAP.md); both versions raise NotImplementedError there.
"""

from __future__ import annotations

import numpy as np
import torch

from focr_tpu_torch.ops.ncc import window_stats, word_stride

EPS = 1e-3
LAUNCHES = {"ncc_sweep": 0, "compact_hits": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sweep_supported(nh: int, nw: int, threshold: float, eps: float = EPS) -> bool:
    """pallas_ncc.pallas_supported (:1014-1023) minus its VMEM terms."""
    return nh * nw * 65025 < 2**24 and np.float32(threshold) - np.float32(eps) > 0


def _check_gate(nh: int, nw: int, threshold: float, eps: float) -> None:
    if not sweep_supported(nh, nw, threshold, eps):
        raise NotImplementedError(
            f"ncc sweep: needle {nw}x{nh} at threshold {threshold} is outside the "
            "kernel's gate (n*65025 < 2^24 and threshold - eps > 0); it needs the "
            "XLA-tier port of focr_tpu/ops/ncc.py::ncc_candidates (ROADMAP.md)"
        )


def sweep_terms(
    s_n: torch.Tensor, s2_n: torch.Tensor, n: int, threshold: float, eps: float = EPS
) -> tuple[torch.Tensor, torch.Tensor, float]:
    """Per-needle f32 (Σn/n, √norm²) and thr−ε, as pallas_ncc.py:309-321
    computes them: norm² from the EXACT int64 n·Σn² − (Σn)² (f32 could flip a
    tiny positive variance to <= 0), then /n in f32; zero-variance needles get
    rtn = +inf, which fails every compare. Computed on the CPU."""
    s_n = s_n.detach().to("cpu", torch.int64)
    s2_n = s2_n.detach().to("cpu", torch.int64)
    nf = torch.tensor(n, dtype=torch.float32)
    sn_n = s_n.to(torch.float32) / nf
    n2n = (n * s2_n - s_n * s_n).to(torch.float32) / nf
    rtn = torch.where(n2n > 0, torch.sqrt(n2n), torch.tensor(float("inf")))
    thr_eps = float(np.float32(threshold) - np.float32(eps))
    return sn_n, rtn, thr_eps


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
    65025, sums < 2²⁴), in row chunks so a full page fits in memory; never a
    convolution. The f32 threshold test is pallas_ncc.py:205-220 op for op,
    with three multiply-adds fused (one rounding each), as XLA compiles them
    for focr_tpu's CPU reference (it always allows FMA fusion):

        norm2p = fma(-(sp·sp), f32(1/n), s2p)
        num    = fma(-sn_n, sp, acc)
        keep   = num > fma(thr−ε, rtn·q, -48)

    A fused op rounds once where the separate ops round twice, so it stays
    inside the −8 and −48 error bounds the test was derived with: the
    candidate set is still a certified superset."""
    B, H, W, T, nh, nw = _sweep_shapes(imgs, needles)
    _check_gate(nh, nw, threshold, eps)
    dev = imgs.device
    n = nh * nw
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
            norm2p = _fma32(-(spf * spf), inv_n, s2pf)
            num = _fma32(-sn_n, spf, acc)
            ys = torch.arange(y0, y1, device=dev)
            row_ok = (spf > 0) & (norm2p > -m8) & (ys[:, None] >= 1) & (xs[None, :] >= 1)
            q = torch.where(row_ok, torch.sqrt(torch.maximum(norm2p - m8, zero)), inf)
            keep = num > _fma32(thr, rtn * q, -m48)  # [T, R, Wv]
            keep = torch.nn.functional.pad(keep, (0, W1 - Wv))
            words = (keep.reshape(T, R, NW, 32).to(torch.int64) * weights).sum(-1)
            mask[b, :, y0:y1] = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
            rcnt[b, :, y0:y1] = keep.sum(-1, dtype=torch.int32)
    return mask, rcnt


def ncc_sweep(
    imgs: torch.Tensor,
    needles: torch.Tensor,
    s_n: torch.Tensor,
    s2_n: torch.Tensor,
    threshold: float,
    eps: float = EPS,
    terms: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 (csrc/ncc_sweep.cu) for CUDA tensors, ncc_sweep_reference for CPU
    tensors. ``terms``: precomputed sweep_terms (the matcher's device groups
    carry them)."""
    if imgs.device.type == "cpu":
        return ncc_sweep_reference(imgs, needles, s_n, s2_n, threshold, eps, terms)
    if imgs.device.type != "cuda":
        raise ValueError(f"ncc_sweep: unsupported device {imgs.device}")
    B, H, W, T, nh, nw = _sweep_shapes(imgs, needles)
    _check_gate(nh, nw, threshold, eps)
    for name, t, dt in (("imgs", imgs, torch.uint8), ("needles", needles, torch.uint8)):
        if t.dtype != dt or not t.is_contiguous() or t.device != imgs.device:
            raise ValueError(f"ncc_sweep: {name} must be contiguous {dt} on {imgs.device}")
    n = nh * nw
    sn_n, rtn, thr_eps = terms if terms is not None else sweep_terms(
        s_n, s2_n, n, threshold, eps
    )
    sn_n = sn_n.to(imgs.device, torch.float32).contiguous()
    rtn = rtn.to(imgs.device, torch.float32).contiguous()
    Hs = H - nh + 1
    NW = word_stride(W, nw)
    mask = torch.empty((B, T, Hs, NW), dtype=torch.int32, device=imgs.device)
    rcnt = torch.zeros((B, T, Hs), dtype=torch.int32, device=imgs.device)
    from focr_tpu_torch.native.build import load

    rc = load().focr_ncc_sweep(
        imgs.data_ptr(), B, H, W, needles.data_ptr(), T, nh, nw,
        sn_n.data_ptr(), rtn.data_ptr(), thr_eps, float(np.float32(1.0 / n)),
        mask.data_ptr(), rcnt.data_ptr(),
        torch.cuda.current_stream(imgs.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ncc_sweep kernel launch failed: CUDA error {rc}")
    LAUNCHES["ncc_sweep"] += 1
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


def compact_hits(
    mask: torch.Tensor, rcnt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 (csrc/ncc_compact.cu) for CUDA tensors, compact_hits_reference for
    CPU tensors. The output is sized by the exact candidate total (one host
    sync per call), so nothing is ever truncated."""
    if mask.device.type == "cpu":
        return compact_hits_reference(mask, rcnt)
    if mask.device.type != "cuda":
        raise ValueError(f"compact_hits: unsupported device {mask.device}")
    B, T, Hs, NW = mask.shape
    for name, t in (("mask", mask), ("rcnt", rcnt)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != mask.device:
            raise ValueError(f"compact_hits: {name} must be contiguous int32 on {mask.device}")
    if rcnt.shape != (B, T, Hs):
        raise ValueError(f"compact_hits: rcnt {tuple(rcnt.shape)} != {(B, T, Hs)}")
    incl = torch.cumsum(rcnt.reshape(B, T * Hs), dim=1)  # int64
    off = torch.zeros(B + 1, dtype=torch.int64, device=mask.device)
    off[1:] = torch.cumsum(incl[:, -1], 0)
    row_off = (incl - rcnt.reshape(B, T * Hs) + off[:-1, None]).contiguous()
    hcnt = rcnt.sum(-1, dtype=torch.int32)
    nz = hcnt.sum(-1, dtype=torch.int32)
    total = int(off[-1].item())
    pos = torch.empty(total, dtype=torch.int32, device=mask.device)
    if total:
        from focr_tpu_torch.native.build import load

        rc = load().focr_ncc_compact(
            mask.data_ptr(), rcnt.data_ptr(), row_off.data_ptr(), pos.data_ptr(),
            B * T * Hs, Hs, NW, torch.cuda.current_stream(mask.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"compact_hits kernel launch failed: CUDA error {rc}")
        LAUNCHES["compact_hits"] += 1
    return pos, off, hcnt, nz
