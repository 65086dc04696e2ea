"""The work of K2, ncc's compaction (a count kernel, then an emit kernel), for
its roofline share: bytes counted from the shape of a swept size group's mask
and the candidates it holds, divided by lib/roofline.py::bound_ms as the
other kernels' work is.

K2 only moves bytes, and reads each mask row only where its row count says
it holds a candidate. The count follows the kernels' main-path caller,
frozen here: a wave of up to 8 pages (lib/roofline.py::NCC_WAVE) cropped to
its ink bounding box, one count and one emit launch a size group that fits
the crop. The candidates are the plain reference's hits. The sweep's test
passes a few more windows (a float32 margin): on the canonical wave 5% more
candidates and 7% more rows, so the share reads ~4% below what the
kernels' own mask would give (PERF.md's kernel table).
"""

from __future__ import annotations

import numpy as np


def mask_shape(Hc: int, Wc: int, nh: int, nw: int) -> tuple[int, int]:
    """(Hs, NW) of a group's mask on a crop: a row a window row, 32 window
    columns a 4-byte word."""
    return Hc - nh + 1, (Wc - nw + 1 + 31) // 32


def k2_work(B: int, Hc: int, Wc: int, T: int, nh: int, nw: int, rows: int,
            candidates: int) -> tuple[int, int]:
    """K2, one size group on a wave of B pages cropped to Hc x Wc whose mask
    holds ``candidates`` set bits in ``rows`` (page, needle, window row)
    rows. In: those mask rows and every row count; out: a position a
    candidate, the pages' offsets, a count a (page, needle) and a page."""
    Hs, NW = mask_shape(Hc, Wc, nh, nw)
    nbytes = rows * NW * 4 + 4 * B * T * Hs + 4 * candidates + 8 * (B + 1) + 4 * B * T + 4 * B
    return 0, nbytes


def group_rows(hits: tuple, ids) -> tuple[int, int]:
    """(rows, candidates) of one page's hits (needle id, x, y, similarity
    arrays) among the needles ``ids``: the distinct (needle, y) rows that
    hold a hit, and the hits."""
    nid, _, y, _ = hits
    keep = np.isin(nid, np.asarray(ids))
    nid, y = np.asarray(nid)[keep].astype(np.int64), np.asarray(y)[keep].astype(np.int64)
    return len(np.unique((nid << 32) | y)), int(keep.sum())
