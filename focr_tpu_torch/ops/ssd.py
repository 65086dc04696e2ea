"""Exact-integer SSD scoring ops for the focr grid decoder, in plain PyTorch.

The counterpart of focr_tpu/ops/ssd.py, with its names. The reference scores
each candidate glyph with an i64 SSD over the whole line canvas
(main.rs:87-110, 510-516). Expanding ||I - T||^2 = ||I||^2 - 2 I.T + ||T||^2
and dropping the template-independent ||I||^2, the argmin over templates is
exactly argmin_T (||T||^2 - 2 I.T).

Exactness: pixels are u8, so every product is at most 255² = 65025 and every
partial sum of an n-pixel window at most n·65025. The products here run in
float64, exact while n·65025 < 2⁵³ — for any window this module accepts. So
focr_tpu's bf16 nibble-split ladder (_exact_dot, ops/ssd.py:62-92, which
exists because bf16 has an 8-bit mantissa) has nothing to do here. The
correlation and the metric are int64. focr_tpu's bound is kept: a window of
more than 74565 pixels raises, so both packages accept the same
configurations.

These are the plain versions the fused kernel (ops/ssd_kernels.py) is held
against, and what runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_WINDOW = 74565  # focr_tpu's exact-bf16 bound: n·15·15 < 2²⁴ (ops/ssd.py:80-83)


def check_window(n: int) -> None:
    """Raise for a window focr_tpu refuses (ops/ssd.py:80-83)."""
    if n > MAX_WINDOW:
        raise ValueError(
            f"window of {n} pixels exceeds the exact-bf16 SSD bound ({MAX_WINDOW}) "
            "that focr_tpu accepts"
        )


def extract_strips(inv: torch.Tensor, ys: tuple[int, ...], crop_h: int, x0: int, crop_w: int):
    """[B, H, W] inverted pages -> [B, R, crop_h, crop_w] line strips.
    Rows past the page bottom are zeros (white, inverted)."""
    B, H, W = inv.shape
    rows = []
    for y in ys:
        strip = inv[:, y : y + crop_h, x0 : x0 + crop_w]
        if strip.shape[1] < crop_h:
            strip = torch.nn.functional.pad(strip, (0, 0, 0, crop_h - strip.shape[1]))
        rows.append(strip)
    return torch.stack(rows, dim=1)


def extract_windows(strips: torch.Tensor, wx0, win_w: int) -> torch.Tensor:
    """[B, R, h, crop_w] strips -> [B, R, C, h, win_w] per-cell windows;
    columns at or past crop_w are zeros."""
    padded = torch.nn.functional.pad(strips, (0, win_w))
    cells = [padded[..., int(w) : int(w) + win_w] for w in np.asarray(wx0)]
    return torch.stack(cells, dim=2)


def exact_corr(wins: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
    """Exact integer correlation I.T.

    wins: [B, R, C, p, q] integer-valued (inverted image windows, 0..255)
    tmpl: [C, G, p, q] u8 templates
    returns: [B, R, C, G] int64, exactly sum(I*T) per (cell, glyph)
    """
    p, q = tmpl.shape[-2], tmpl.shape[-1]
    check_window(p * q)
    corr = torch.einsum("brcpq,cgpq->brcg", wins.to(torch.float64), tmpl.to(torch.float64))
    return corr.to(torch.int64)


def exact_corr_mat(wins: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
    """Exact integer correlation as a plain matmul.

    wins: [L, K] integer-valued 0..255; tmpl: [T, K] u8 templates.
    Returns [L, T] int64 == exact sum(wins * tmpl) per pair.
    """
    check_window(tmpl.shape[-1])
    return (wins.to(torch.float64) @ tmpl.to(torch.float64).T).to(torch.int64)


def ssd_metric(wins: torch.Tensor, tmpl: torch.Tensor, tsq: torch.Tensor) -> torch.Tensor:
    """[B, R, C, G] int64 metric = ||T||^2 - 2 I.T (equi-argmin with the
    full SSD)."""
    return tsq[None, None].to(torch.int64) - 2 * exact_corr(wins, tmpl)


def argmin_glyph(metric: torch.Tensor) -> torch.Tensor:
    """First-minimum argmin over the glyph axis (Rust min_by_key,
    main.rs:159): the lowest index among equal minima, int32."""
    G = metric.shape[-1]
    lowest = metric.min(dim=-1, keepdim=True).values
    idx = torch.arange(G, device=metric.device).expand_as(metric)
    return torch.where(metric == lowest, idx, G).min(dim=-1).values.to(torch.int32)
