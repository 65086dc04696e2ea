"""Slow, width-unlimited direct NCC checker (differential oracle #2).

Counterpart of focr_tpu/oracle/ncc_direct.py. The primary oracle
(ncc_oracle.Searcher) mirrors the reference's integral tables and therefore
also mirrors its 16-px needle-width panic (ncc.rs:392). The device path DOES
take wider needles (K1's wide instance, ops/ncc_kernels.py::sweep_tier), and
this module is their independent check: a brute-force full-sweep search
computing every window's statistics directly from the pixels in exact int64
— no integral tables, no whitespace skip bounds, no candidate caps, no width
limit — then the reference's scalar-tail f64 similarity (ncc.cpp:233-247)
and accept test (emit iff sim != +inf and sim > f64(f32(threshold))) over
the reference scan domain (x >= 1, y >= 1, row-major), truncated to
MAX_MATCHES only at the end. O(H·W·n) per needle: a test oracle, never a
production path.
"""

from __future__ import annotations

import numpy as np

from focr_tpu_torch.models.types import MAX_MATCHES, Match


def direct_search(
    page: np.ndarray, needle: np.ndarray, threshold: float, cap: int = MAX_MATCHES
) -> list[Match]:
    """Uncapped brute-force search on an UN-inverted u8 page.

    Returns matches in the reference's row-major scan order, truncated to
    ``cap`` at the very end (no interaction with the scan beyond that)."""
    inv = (255 - page.astype(np.int64))
    n_h, n_w = needle.shape
    H, W = inv.shape
    ys_n = H - n_h + 1
    xs_n = W - n_w + 1
    if ys_n <= 1 or xs_n <= 1:
        return []
    needle64 = needle.astype(np.int64)
    n = n_w * n_h
    s_n = int(needle64.sum())
    s2_n = int((needle64 * needle64).sum())
    norm2_n = np.float64(s2_n) - np.float64(s_n * s_n) / np.float64(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        rnorm_n = np.float64(1.0) / np.sqrt(norm2_n)
    n_recip = np.float64(1.0) / np.float64(n)
    threshold_d = np.float64(np.float32(threshold))

    # exact integer window stats for the whole plane, straight from pixels
    wins = np.lib.stride_tricks.sliding_window_view(inv, (n_h, n_w))
    acc = np.einsum("ywij,ij->yw", wins, needle64, dtype=np.int64)
    sp = wins.sum(axis=(2, 3), dtype=np.int64)
    s2p = (wins * wins).sum(axis=(2, 3), dtype=np.int64)

    with np.errstate(divide="ignore", invalid="ignore"):
        rnorm_p = np.float64(1.0) / np.sqrt(
            s2p.astype(np.float64) - (sp.astype(np.float64) ** 2) * n_recip
        )
        num = acc.astype(np.float64) - (np.float64(s_n) * sp.astype(np.float64)) * n_recip
        sim = num * (rnorm_n * rnorm_p)
        emit = (sim != np.inf) & (sim > threshold_d)
    emit[0, :] = False  # scan domain excludes y=0 and x=0 (ncc.rs:279, ncc.cpp:98)
    emit[:, 0] = False
    ys, xs = np.nonzero(emit)  # row-major == reference scan order
    return [
        Match(x=int(x), y=int(y), w=n_w, h=n_h, similarity=float(np.float32(sim[y, x])))
        for y, x in zip(ys[:cap], xs[:cap])
    ]
