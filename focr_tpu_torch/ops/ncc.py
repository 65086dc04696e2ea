"""Device NCC ops in plain PyTorch: exact window statistics and the mask-row
geometry shared by the sweep kernel, its plain version and the matcher.

Counterpart of focr_tpu/ops/ncc.py. Its XLA tier (``correlate`` +
``ncc_candidates``, the path for needles with n·65025 >= 2²⁴ or thr−ε <= 0)
is the sweep kernel's wide instance in the port (ops/ncc_kernels.py).
"""

from __future__ import annotations

import torch


def word_stride(W: int, nw: int) -> int:
    """Mask words per row: ceil of the window-column count W-nw+1 over 32
    (focr_tpu/ops/pallas_ncc.py::word_stride). A needle-local candidate
    position is y·W1 + x with W1 = 32·word_stride(W, nw)."""
    return (W - nw + 1 + 31) // 32


def _sliding_sum(a: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Exact sliding-window sum of width k along ``dim`` (integer cumsum
    difference)."""
    c = torch.cumsum(a, dim=dim)
    n = a.shape[dim]
    head = c.narrow(dim, k - 1, 1)
    rest = c.narrow(dim, k, n - k) - c.narrow(dim, 0, n - k)
    return torch.cat([head, rest], dim=dim)


def window_stats(img: torch.Tensor, nw: int, nh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σp, Σp²) of every nw×nh window of ``img`` [..., H, W] (values 0..255)
    -> two int64 [..., H-nh+1, W-nw+1] tensors, exact (int64 cumsums cannot
    overflow below ~10¹⁴ summed pixels). Window (x, y) covers rows
    [y, y+nh) and columns [x, x+nw), as in focr_tpu/ops/ncc.py:106-150."""
    p = img.to(torch.int64)
    sp = _sliding_sum(_sliding_sum(p, nw, -1), nh, -2)
    s2p = _sliding_sum(_sliding_sum(p * p, nw, -1), nh, -2)
    return sp, s2p
