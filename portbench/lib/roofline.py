"""The yardstick of the kernels' roofline shares: the card's peaks, the bound
(a frozen copy of chip_smoke.py::bound) and the work each kernel's inputs
need, counted from the shapes of the pages the benchmark made.

A kernel's bound is the larger of its operations (2 a multiply-add) over the
int8 tensor-core peak and its bytes (each input read once, each output
written once) over the memory peak; its roofline share is the summed bound of
the work a traced window gave it over the summed device time of its kernels.
The counts follow the kernels' main-path callers, frozen here so that a later
change to a kernel cannot move the yardstick: focr's pages go in batches of
16 (the CLI's --batch-size), each a launch a row group; ncc's in waves of 8,
each cropped to the wave's ink bounding box (focr_tpu/models/ncc.py
::_ink_crop), a launch of K1 and of K3 a size group.
"""

from __future__ import annotations

import numpy as np

# the H100 SXM's published dense int8 tensor-core rate and memory rate
# (NVIDIA's data sheet, at 700 W)
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12

FOCR_BATCH = 16
NCC_WAVE = 8


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """The least ms the card could take for ``ops`` operations (2 per
    multiply-add) and ``nbytes`` moved (each input read once, each output
    written once), and which of the two bounds it."""
    t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ink_crop(wave: np.ndarray, sizes: list[tuple[int, int]]) -> tuple[int, int] | None:
    """(Hc, Wc) of a wave's crop: the ink bounding box of the inverted pages
    [B, H, W], grown by the tallest and widest needle that fits the page,
    rounded up to 64 and clamped to the page; None for a white wave."""
    B, H, W = wave.shape
    fit = [(nh, nw) for nh, nw in sizes if nh < H and nw < W]
    if not fit:
        return H, W
    ink = wave != 255
    rows, cols = np.flatnonzero(ink.any(axis=(0, 2))), np.flatnonzero(ink.any(axis=(0, 1)))
    if not len(rows):
        return None
    nh_m, nw_m = max(s[0] for s in fit), max(s[1] for s in fit)
    y0, x0 = max(0, int(rows[0]) - nh_m), max(0, int(cols[0]) - nw_m)
    y1, x1 = min(H, int(rows[-1]) + 1 + nh_m), min(W, int(cols[-1]) + 1 + nw_m)
    return min(H - y0, -(-(y1 - y0) // 64) * 64), min(W - x0, -(-(x1 - x0) // 64) * 64)


def k1_work(B: int, Hc: int, Wc: int, T: int, nh: int, nw: int) -> tuple[int, int]:
    """K1, one size group on a wave of B pages cropped to Hc x Wc: every
    window against every needle. In: the crop, the needles and two f32 terms
    a needle; out: a bit a (window, needle) and a row count a (window row,
    needle)."""
    wins_y, wins_x = Hc - nh + 1, Wc - nw + 1
    ops = 2 * B * wins_y * wins_x * T * nh * nw
    nbytes = B * Hc * Wc + T * nh * nw + 8 * T + B * T * wins_y * (wins_x / 8 + 4)
    return ops, int(nbytes)


def k3_work(B: int, Hc: int, Wc: int, T: int, nh: int, nw: int, hits: int,
            kept: int) -> tuple[int, int]:
    """K3, one size group on a wave: the exact replay of every hit. In: a
    position a hit, the crop, the needles, their two i64 sums, the per-(page,
    needle) offsets and counts; out: x, y and f32 similarity a kept hit, a
    count and a WARN flag a (page, needle)."""
    ops = 2 * hits * nh * nw
    nbytes = (4 * hits + B * Hc * Wc + T * nh * nw + 16 * T + 4 * (2 * B * T + 1)
              + 12 * kept + 5 * B * T)
    return ops, nbytes


def k4_work(B: int, rows: int, h: int, crop_w: int, C: int, G: int, win_w: int
            ) -> tuple[int, int]:
    """K4, one row group of a batch of B pages: every (strip, cell, glyph)
    window. In: the strips, the templates, their i64 squared sums and the
    cells' window starts; out: an i32 glyph a cell and a white flag a
    strip."""
    ops = 2 * B * rows * C * G * h * win_w
    nbytes = B * rows * h * crop_w + C * G * h * win_w + 8 * C * G + 4 * C + 4 * B * rows * C + B * rows
    return ops, nbytes


def ncc_waves(pages: np.ndarray, sizes: list[tuple[int, int]]):
    """(first page, B, Hc, Wc) of each wave of a call's pages [N, H, W] that
    holds ink, in order."""
    for s in range(0, len(pages), NCC_WAVE):
        wave = pages[s : s + NCC_WAVE]
        crop = ink_crop(wave, sizes)
        if crop is not None:
            yield s, len(wave), *crop
