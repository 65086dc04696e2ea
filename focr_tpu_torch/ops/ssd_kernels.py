"""The focr grid decoder's device step: K4 (ssd_argmin), a hand-written CUDA
kernel (csrc/focr_ssd.cu) beside its plain PyTorch version.

Counterpart of focr_tpu/models/focr.py::make_strip_forward (:60-80), the
jitted XLA step of the focr path: invert the strips, flag the all-white ones,
cut each cell's window, score every glyph with the exact-integer SSD metric
and take the first minimum. The wrapper ``ssd_argmin`` runs the plain version
for tensors on the CPU and launches the kernel for tensors on a CUDA card;
there is no fallback between the two. It counts its kernel launches in
``LAUNCHES``. The kernel has two instances, picked by the shape
(``ssd_plan``): the int8 tensor cores (``mma``) for windows whose u8 dot is
exact in s32 and whose block of 16 strips fits in shared memory, the int64
CUDA-core kernel for the rest. The ``mma`` instance reads the templates
packed in its B-fragment order (``pack_template_fragments``), which
StripForward does once a bank.
"""

from __future__ import annotations

import numpy as np
import torch

from focr_tpu_torch.ops.ssd import argmin_glyph, check_window, extract_windows, ssd_metric

LAUNCHES = {"ssd_argmin": 0}
# csrc/focr_ssd.cu's constants: strips a block of the mma instance, the
# shared memory a block may use
MMA_STRIPS = 16
SMEM_MAX = 232448 - 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _shapes(strips, templates, tsq, wx0) -> tuple[int, ...]:
    if strips.dim() != 4 or templates.dim() != 4:
        raise ValueError("ssd_argmin: strips [B, R, h, crop_w] and templates [C, G, h, win_w] expected")
    B, R, h, crop_w = strips.shape
    C, G, th, win_w = templates.shape
    if th != h or tuple(tsq.shape) != (C, G) or tuple(wx0.shape) != (C,):
        raise ValueError(
            f"ssd_argmin: strips {tuple(strips.shape)}, templates {tuple(templates.shape)}, "
            f"tsq {tuple(tsq.shape)} and wx0 {tuple(wx0.shape)} do not agree"
        )
    if G == 0:
        raise ValueError("ssd_argmin: empty alphabet")
    check_window(h * win_w)
    return B, R, h, crop_w, C, G, win_w


def ssd_argmin_reference(
    strips: torch.Tensor,  # [B, R, h, crop_w] u8, not inverted
    templates: torch.Tensor,  # [C, G, h, win_w] u8
    tsq: torch.Tensor,  # [C, G] integer
    wx0: torch.Tensor,  # [C] integer, window start columns (>= 0)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K4, on the tensors' device, composed of ops/ssd.py: (ids int32
    [B, R, C] — the first-minimum glyph of each cell; white bool [B, R] —
    the strip is all 255, main.rs:208-211)."""
    _shapes(strips, templates, tsq, wx0)
    inv = 255 - strips.to(torch.int32)
    white = inv.amax(dim=(2, 3)) == 0
    wins = extract_windows(inv, wx0.cpu().numpy(), templates.shape[3])
    ids = argmin_glyph(ssd_metric(wins, templates, tsq))
    return ids, white


def k_steps(h: int, win_w: int) -> int:
    """The mma instance's k-steps of 32 bytes: the window as 4-byte words
    (dy, q), each row padded to ceil(win_w/4) words, the total padded to a
    multiple of 8 words (5 for the canonical 12x9 window, 2 for 3x9)."""
    return -(-h * -(-win_w // 4) // 8)


def ssd_plan(h: int, crop_w: int, win_w: int) -> tuple[str, int, int]:
    """The launcher's plan (csrc/focr_ssd.cu::focr_ssd_argmin): (instance,
    k-steps, staged row pitch). "mma" while n·65025 < 2³¹ (the s32 dot is
    exact) and a block's 16 strips, rows padded to ``pitch`` bytes, fit in
    shared memory beside the k-word table; "int64" otherwise."""
    nw4 = -(-win_w // 4)
    nks = k_steps(h, win_w)
    pitch = (crop_w + 4 * nw4 + 4 + 3) & ~3  # covers x0 + 4q + 7 for x0 <= crop_w
    fits = nks * 8 * 4 + MMA_STRIPS * h * pitch <= SMEM_MAX
    return ("mma" if h * win_w * 65025 < 2**31 and fits else "int64"), nks, pitch


def template_fragment_index(G: int, h: int, win_w: int) -> np.ndarray:
    """Where each byte of one cell's B fragments comes from: int64
    [ceil(G/8), nks, 32, 8]; byte 4r+j of lane L's two registers for (n-tile
    nt, k-step s) is the flat index into the cell's templates [G, h, win_w]
    of its template byte, or G·h·win_w for a zero byte.

    mma.sync.m16n8k32 with B column-major (PTX ISA, the .u8 fragment
    layout): register r of lane L = 4g + tq holds column g — glyph 8·nt + g
    — and k bytes 32s + 4tq + 16r + j, i.e. k-word w = 8s + tq + 4r, which is
    window word (dy, q) = divmod(w, ceil(win_w/4)) and pixel dx = 4q + j.
    Bytes past win_w, past the window's last word and past G are zero."""
    nks, nw4 = k_steps(h, win_w), -(-win_w // 4)
    nt, s, lane, r, j = np.ix_(np.arange(-(-G // 8)), np.arange(nks), np.arange(32),
                               np.arange(2), np.arange(4))
    g = 8 * nt + (lane >> 2)
    w = 8 * s + (lane & 3) + 4 * r
    dy, dx = w // nw4, 4 * (w % nw4) + j
    idx = (g * h + dy) * win_w + dx
    real = (g < G) & (dy < h) & (dx < win_w)
    return np.where(real, idx, G * h * win_w).reshape(-1, nks, 32, 8)


def pack_template_fragments(templates: torch.Tensor) -> torch.Tensor:
    """[C, G, h, win_w] u8 -> the mma instance's B operand, int32 [C,
    ceil(G/8), nks, 32, 2] on the templates' device: one uint2 a lane for
    each (cell, n-tile, k-step), laid out by template_fragment_index.
    StripForward packs each bank once."""
    C, G, h, win_w = templates.shape
    idx = torch.from_numpy(template_fragment_index(G, h, win_w)).to(templates.device)
    flat = torch.cat([templates.reshape(C, -1), templates.new_zeros(C, 1)], dim=1)
    return flat[:, idx].view(torch.int32)


def ssd_argmin(
    strips: torch.Tensor, templates: torch.Tensor, tsq: torch.Tensor, wx0: torch.Tensor,
    bfrag: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 (csrc/focr_ssd.cu) for CUDA tensors, ssd_argmin_reference for CPU
    tensors. On the card: strips and templates contiguous u8, tsq int64, wx0
    int32 (>= 0), all on the strips' device; ids and white are new tensors
    there. ``bfrag``: pack_template_fragments(templates), precomputed (the
    decoder's StripForward carries it); packed here when the mma instance
    needs it and none is given."""
    if strips.device.type == "cpu":
        return ssd_argmin_reference(strips, templates, tsq, wx0)
    if strips.device.type != "cuda":
        raise ValueError(f"ssd_argmin: unsupported device {strips.device}")
    B, R, h, crop_w, C, G, win_w = _shapes(strips, templates, tsq, wx0)
    for name, t, dt in (
        ("strips", strips, torch.uint8), ("templates", templates, torch.uint8),
        ("tsq", tsq, torch.int64), ("wx0", wx0, torch.int32),
    ):
        if t.dtype != dt or not t.is_contiguous() or t.device != strips.device:
            raise ValueError(f"ssd_argmin: {name} must be contiguous {dt} on {strips.device}")
    ids = torch.empty((B, R, C), dtype=torch.int32, device=strips.device)
    white = torch.empty((B, R), dtype=torch.bool, device=strips.device)
    if B * R == 0 or C == 0:
        return ids, white
    instance, nks, _ = ssd_plan(h, crop_w, win_w)
    if instance == "mma":
        if bfrag is None:
            bfrag = pack_template_fragments(templates)
        if tuple(bfrag.shape) != (C, -(-G // 8), nks, 32, 2) or (
            bfrag.dtype != torch.int32 or not bfrag.is_contiguous()
            or bfrag.device != strips.device
        ):
            raise ValueError("ssd_argmin: bfrag must be pack_template_fragments(templates)")
    from focr_tpu_torch.native.build import load

    rc = load().focr_ssd_argmin(
        strips.data_ptr(), B * R, h, crop_w,
        templates.data_ptr(), bfrag.data_ptr() if instance == "mma" else None,
        tsq.data_ptr(), wx0.data_ptr(), C, G, win_w,
        ids.data_ptr(), white.data_ptr(),
        torch.cuda.current_stream(strips.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ssd_argmin kernel launch failed: CUDA error {rc}")
    LAUNCHES["ssd_argmin"] += 1
    return ids, white
