"""K3, the exact f64 replay of the ncc sweep's candidates: a hand-written CUDA
kernel (csrc/ncc_replay.cu) beside its plain PyTorch version.

focr_tpu replays K2's candidates on the host (models/ncc.py:1422 ->
native/ncc_cpu.py::replay_group), because a TPU has no f64 unit; the card
has, so the port replays them where they already sit, right after K2's emit
kernel. It is the same function as csrc/ncc_host.cpp::focr_ncc_replay_pos_u8
(which native/ncc_cpu.py::replay_group binds, and which stays as the
yardstick the tests and chip_smoke.py hold K3 against): the same op order,
MAX_MATCHES cap and WARN condition, on crop-local positions, with the hits'
coordinates written for the full page.

The wrapper ``ncc_replay`` runs the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA card; there is no fallback between
the two. It counts its launches in ``LAUNCHES``. Its output is one uint8
buffer, read through ``split_replay``: x, y (i32) and sim (f32) sized like
the positions — segment (page b, needle t)'s hits at that segment's own
candidate offset, in scan order — then counts (i32) and warn (u8) [B, T].
"""

from __future__ import annotations

import torch

from focr_tpu_torch.ops.ncc import word_stride
from focr_tpu_torch.utils.device import count_launch, launch_stream

LAUNCHES = {"ncc_replay": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def replay_nbytes(total: int, B: int, T: int) -> int:
    """Bytes of K3's output buffer for ``total`` candidates of B pages by T
    needles."""
    return 12 * total + 5 * B * T


def split_replay(buf: torch.Tensor, total: int, B: int, T: int):
    """(x i32 [total], y i32 [total], sim f32 [total], counts i32 [B, T],
    warn u8 [B, T]): views of K3's output buffer, on its device or on the
    host."""
    a, b = 12 * total, 12 * total + 4 * B * T
    return (buf[: 4 * total].view(torch.int32), buf[4 * total : 8 * total].view(torch.int32),
            buf[8 * total : a].view(torch.float32), buf[a:b].view(torch.int32).view(B, T),
            buf[b : b + B * T].view(B, T))


def replay_hits(buf: torch.Tensor, off: torch.Tensor, hcnt: torch.Tensor):
    """The kept hits of K3's output, gathered in (page, needle, scan) order:
    (x i32, y i32, sim f32, counts i32 [B, T], warn u8 [B, T]). Two replays of
    one wave agree when these agree; the slots past a segment's count hold
    nothing."""
    B, T = hcnt.shape
    total = int(off[-1])
    x, y, sim, counts, warn = split_replay(buf, total, B, T)
    starts = (off[:-1, None] + torch.cumsum(hcnt.to(torch.int64), 1) - hcnt).reshape(-1)
    k = counts.reshape(-1).to(torch.int64)
    first = torch.cumsum(k, 0) - k
    seg = torch.repeat_interleave(torch.arange(B * T, device=buf.device), k)
    idx = starts[seg] + torch.arange(int(k.sum()), device=buf.device) - first[seg]
    return x[idx], y[idx], sim[idx], counts, warn


def _check(imgs, pos, off, hcnt, bank, s_n, s2_n) -> tuple[int, ...]:
    if imgs.dim() != 3 or bank.dim() != 3:
        raise ValueError("ncc_replay: imgs [B, Hc, Wc] and bank [T, nh, nw] expected")
    B, Hc, Wc = imgs.shape
    T, nh, nw = bank.shape
    if nh * nw * 65025 >= 2**31:
        raise ValueError(f"ncc_replay: a needle of {nh * nw} pixels is past the sweep's bound "
                         "n*65025 < 2^31")
    for name, t, dt, shape in (
        ("imgs", imgs, torch.uint8, None), ("pos", pos, torch.int32, (pos.numel(),)),
        ("off", off, torch.int64, (B + 1,)), ("hcnt", hcnt, torch.int32, (B, T)),
        ("bank", bank, torch.uint8, None), ("s_n", s_n, torch.int64, (T,)),
        ("s2_n", s2_n, torch.int64, (T,)),
    ):
        if t.dtype != dt or not t.is_contiguous() or t.device != imgs.device or (
                shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"ncc_replay: {name} must be contiguous {dt}"
                             f"{list(shape) if shape else ''} on {imgs.device}")
    return B, Hc, Wc, T, nh, nw


def ncc_replay_reference(
    imgs: torch.Tensor,  # [B, Hc, Wc] u8 the wave's cropped, inverted pages
    pos: torch.Tensor,  # [N] i32 K2's positions, crop-local y·row_len + x
    off: torch.Tensor,  # [B+1] i64 page b's positions are pos[off[b]:off[b+1]]
    hcnt: torch.Tensor,  # [B, T] i32 candidates of each (page, needle)
    bank: torch.Tensor,  # [T, nh, nw] u8
    s_n: torch.Tensor,  # [T] i64
    s2_n: torch.Tensor,  # [T] i64
    thr_f64: float,  # f64(f32(threshold))
    cy0: int,
    cx0: int,  # the crop's origin on the page
    max_matches: int,
) -> torch.Tensor:
    """Plain PyTorch K3, on the tensors' device: the windows gathered by
    index arithmetic and summed in int64, the f64 similarity as separate
    tensor ops in replay_impl's order (csrc/ncc_host.cpp:198-226), the accept
    test, and the cap per segment from a cumulative sum of the keep flags.
    Returns the buffer ``split_replay`` reads."""
    B, Hc, Wc, T, nh, nw = _check(imgs, pos, off, hcnt, bank, s_n, s2_n)
    dev = imgs.device
    n = nh * nw
    row_len = word_stride(Wc, nw) * 32
    total = pos.numel()
    buf = torch.zeros(replay_nbytes(total, B, T), dtype=torch.uint8, device=dev)
    out_x, out_y, out_sim, counts, warn = split_replay(buf, total, B, T)
    i64, f64 = torch.int64, torch.float64
    lens = hcnt.reshape(-1).to(i64)
    starts = (off[:-1, None] + torch.cumsum(hcnt.to(i64), 1) - hcnt).reshape(-1)
    first = torch.cumsum(lens, 0) - lens
    n_c = int(lens.sum())
    seg = torch.repeat_interleave(torch.arange(B * T, device=dev), lens)
    cidx = starts[seg] + torch.arange(n_c, device=dev) - first[seg]
    lin = pos[cidx].to(i64)
    ys, xs = lin // row_len, lin % row_len
    page, nid = seg // T, seg % T
    # exact integer window stats, in chunks of ~4M gathered pixels
    flat = imgs.reshape(-1)
    tap = (torch.arange(nh, device=dev)[:, None] * Wc + torch.arange(nw, device=dev)).reshape(-1)
    bank64 = bank.reshape(T, n).to(i64)
    acc, sp, s2p = (torch.empty(n_c, dtype=i64, device=dev) for _ in range(3))
    ch = max(1, (1 << 22) // n)
    for c0 in range(0, n_c, ch):
        c1 = min(n_c, c0 + ch)
        corner = (page[c0:c1] * Hc + ys[c0:c1]) * Wc + xs[c0:c1]
        win = flat[corner[:, None] + tap].to(i64)  # [chunk, n]
        acc[c0:c1] = (win * bank64[nid[c0:c1]]).sum(1)
        sp[c0:c1] = win.sum(1)
        s2p[c0:c1] = (win * win).sum(1)
    # the f64 similarity, one rounding an op, replay_impl's association
    nd = torch.tensor(float(n), dtype=f64, device=dev)
    one = torch.ones((), dtype=f64, device=dev)
    n_recip = one / nd
    s_nd = s_n.to(f64)
    norm2_n = s2_n.to(f64) - (s_nd * s_nd) / nd
    rnorm_n = one / torch.sqrt(norm2_n)
    spd = sp.to(f64)
    num = acc.to(f64) - (s_nd[nid] * spd) * n_recip
    norm_p = s2p.to(f64) - (spd * spd) / nd
    rnorm_p = one / torch.sqrt(norm_p)
    sim = num * (rnorm_n[nid] * rnorm_p)
    keep = (sim != float("inf")) & (sim > thr_f64)
    # each kept candidate's rank among its segment's kept candidates
    k64 = keep.to(i64)
    kept = torch.zeros(B * T, dtype=i64, device=dev).index_add_(0, seg, k64)
    rank = torch.cumsum(k64, 0) - k64 - (torch.cumsum(kept, 0) - kept)[seg]
    emit = keep & (rank < max_matches)
    o = (starts[seg] + rank)[emit]
    out_x[o] = (xs[emit] + cx0).to(torch.int32)
    out_y[o] = (ys[emit] + cy0).to(torch.int32)
    out_sim[o] = sim[emit].to(torch.float32)
    counts.copy_(torch.clamp(kept, max=max_matches).view(B, T))
    warn.copy_((kept >= max_matches).view(B, T))
    return buf


def ncc_replay(
    imgs: torch.Tensor, pos: torch.Tensor, off: torch.Tensor, hcnt: torch.Tensor,
    bank: torch.Tensor, s_n: torch.Tensor, s2_n: torch.Tensor, thr_f64: float,
    cy0: int, cx0: int, max_matches: int,
) -> torch.Tensor:
    """K3 (csrc/ncc_replay.cu) for CUDA tensors, ncc_replay_reference for CPU
    tensors; one launch per call, on the current stream, with no wait: the
    buffer is sized by the exact candidate count the caller already has."""
    if imgs.device.type == "cpu":
        return ncc_replay_reference(imgs, pos, off, hcnt, bank, s_n, s2_n, thr_f64, cy0, cx0,
                                    max_matches)
    if imgs.device.type != "cuda":
        raise ValueError(f"ncc_replay: unsupported device {imgs.device}")
    B, Hc, Wc, T, nh, nw = _check(imgs, pos, off, hcnt, bank, s_n, s2_n)
    total = pos.numel()
    buf = torch.empty(replay_nbytes(total, B, T), dtype=torch.uint8, device=imgs.device)
    if B * T:
        out_x, out_y, out_sim, counts, warn = split_replay(buf, total, B, T)
        from focr_tpu_torch.native.build import load

        with launch_stream(imgs) as stream:
            rc = load().focr_ncc_replay(
                imgs.data_ptr(), B, Hc, Wc, pos.data_ptr(), off.data_ptr(), hcnt.data_ptr(), T,
                bank.data_ptr(), nh, nw, s_n.data_ptr(), s2_n.data_ptr(), float(thr_f64),
                word_stride(Wc, nw) * 32, int(cy0), int(cx0), int(max_matches),
                out_x.data_ptr(), out_y.data_ptr(), out_sim.data_ptr(), counts.data_ptr(),
                warn.data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"ncc_replay kernel launch failed: CUDA error {rc}")
        count_launch(LAUNCHES, "ncc_replay")
    return buf
