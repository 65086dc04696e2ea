"""The focr grid decoder's device step: K4 (ssd_argmin), a hand-written CUDA
kernel (csrc/focr_ssd.cu) beside its plain PyTorch version.

Counterpart of focr_tpu/models/focr.py::make_strip_forward (:60-80), the
jitted XLA step of the focr path: invert the strips, flag the all-white ones,
cut each cell's window, score every glyph with the exact-integer SSD metric
and take the first minimum. The wrapper ``ssd_argmin`` runs the plain version
for tensors on the CPU and launches the kernel for tensors on a CUDA card;
there is no fallback between the two. It counts its kernel launches in
``LAUNCHES``.
"""

from __future__ import annotations

import torch

from focr_tpu_torch.ops.ssd import argmin_glyph, check_window, extract_windows, ssd_metric

LAUNCHES = {"ssd_argmin": 0}


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


def ssd_argmin(
    strips: torch.Tensor, templates: torch.Tensor, tsq: torch.Tensor, wx0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 (csrc/focr_ssd.cu) for CUDA tensors, ssd_argmin_reference for CPU
    tensors. On the card: strips and templates contiguous u8, tsq int64, wx0
    int32, all on the strips' device; ids and white are new tensors there."""
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
    from focr_tpu_torch.native.build import load

    rc = load().focr_ssd_argmin(
        strips.data_ptr(), B * R, h, crop_w,
        templates.data_ptr(), tsq.data_ptr(), wx0.data_ptr(), C, G, win_w,
        ids.data_ptr(), white.data_ptr(),
        torch.cuda.current_stream(strips.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ssd_argmin kernel launch failed: CUDA error {rc}")
    LAUNCHES["ssd_argmin"] += 1
    return ids, white
