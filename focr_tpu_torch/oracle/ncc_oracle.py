"""Bit-exact NumPy re-implementation of the ncc template search.

Stage-0 oracle for the NCC engine: replicates the Searcher + C kernel
semantics (reference src/ncc.rs:128-483, src/ncc.cpp:48-396) exactly:

  * inversion ``255 - x``                                  (ncc.rs:880-892)
  * sum table: standard fully-accumulated 2-D prefix       (ncc.rs:938-955)
  * sumsqr table: row 0 / col 0 are raw ``p*p`` (NOT prefix-accumulated)
    with interior built by the usual recurrence             (ncc.rs:957-974).
    Closed form (proved in tests/test_oracle.py): for x,y >= 1
        S(x,y) = U(x,y) + P(0,y) + P(x,0) - P(0,0)
    where U is the prefix over the interior [1:,1:].  The `_nz` rect-sum
    accessor (ncc.rs:1006-1013) is therefore EXACT for every window with
    x,y >= 1 — the border asymmetry cancels.
  * per-row [start, end) whitespace skip bounds            (ncc.rs:279-305)
  * patch_sum / patch_rnorm precompute, f64                (ncc.rs:306-312)
  * C-kernel similarity:  sim = (acc - (s_n*s_p)*(1/n)) * rnorm_n * rnorm_p
    all f64, unfused, via n_recip — the reference C kernel's SCALAR-TAIL
    formula (ncc.cpp:233-247). NOTE the reference is internally inconsistent
    at the 1-ulp level: its vector lanes fuse the same expression with
    _mm256_fnmadd_pd (ncc.cpp:212, single rounding), and its own `--rust`
    differential kernel divides instead (`acc - s_n*s_p / n`, ncc.rs:457) —
    so the reference binary's sims depend on which lane processed a given x.
    This rebuild picks the scalar-tail formula ONCE and applies it in every
    tier (oracle, C++ native built -ffp-contract=off, device replay), so all
    tiers agree bit-for-bit with each other and with the reference's scalar
    lanes; emit iff sim != +inf && sim > threshold
  * scan-order truncation at MAX_MATCHES with a WARN        (ncc.cpp:222-229,
    ncc.rs:395-397)
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from focr_tpu_torch.models.types import MAX_MATCHES, Match


def invert_u8(img: np.ndarray) -> np.ndarray:
    """White paper -> 0, ink -> positive (ncc.rs:887-892)."""
    return (255 - img.astype(np.int32)).astype(np.uint8)


def sum_table(pixels: np.ndarray) -> np.ndarray:
    """u32 fully-accumulated 2-D prefix sum (ncc.rs:938-955)."""
    return pixels.astype(np.uint32).cumsum(axis=0, dtype=np.uint32).cumsum(
        axis=1, dtype=np.uint32
    )


def sumsqr_table(pixels: np.ndarray) -> np.ndarray:
    """u64 table with the reference's non-accumulated borders (ncc.rs:957-974).

    Built via the closed form S = U + P(0,y) + P(x,0) - P(0,0) (interior),
    which tests verify equals the literal recurrence.
    """
    p = pixels.astype(np.uint64)
    P = p * p
    S = np.zeros_like(P)
    S[0, :] = P[0, :]
    S[:, 0] = P[:, 0]
    U = P[1:, 1:].cumsum(axis=0, dtype=np.uint64).cumsum(axis=1, dtype=np.uint64)
    S[1:, 1:] = U + P[0:1, 1:] + P[1:, 0:1] - P[0, 0]
    return S


def rect_sum_nz(table: np.ndarray, x: int, y: int, w: int, h: int) -> int:
    """table rect sum for x,y >= 1 (`*_sum_nz`, ncc.rs:976-983, 1006-1013).

    Computed in the TABLE's dtype so overflow wraps and then cancels, exactly
    like the reference's `as u32` truncation (ncc.rs:977-984) / u64 wrapping
    arithmetic: the prefix tables may wrap on huge dark pages, but the true
    window sum always fits the dtype, so the wrapped difference is exact.
    Widening to python ints BEFORE differencing would instead be off by
    k*2^32 whenever the u32 table has wrapped."""
    a = table[y + h - 1, x + w - 1]
    b = table[y + h - 1, x - 1]
    c = table[y - 1, x + w - 1]
    d = table[y - 1, x - 1]
    with np.errstate(over="ignore"):  # the wrap IS the semantics
        return int(a - b + d - c)


@dataclass
class Prepared:
    start_end: np.ndarray  # [H, 2] int — per-row [start, end) search bounds
    patch_sum: np.ndarray  # [H, W] int64 — only valid inside [start, end)
    patch_rnorm: np.ndarray  # [H, W] f64 — 1/sqrt(S2 - S^2/n), only valid inside


class Searcher:
    """Per-page NCC search engine (ncc.rs:128-261)."""

    def __init__(self, img: np.ndarray):
        assert img.dtype == np.uint8 and img.ndim == 2
        self.reference = invert_u8(img)
        self._ref64 = self.reference.astype(np.int64)  # search() reads this
        # per needle; converting per call would churn H*W*8 bytes each time
        self.h, self.w = self.reference.shape
        self.sum_table = sum_table(self.reference)
        self.sumsqr_table = sumsqr_table(self.reference)
        self._prepared_size: tuple[int, int] | None = None
        self._prepared: Prepared | None = None

    def prepare_for_size(self, n_w: int, n_h: int) -> Prepared:
        """Per-row whitespace bounds + patch stats, memoized on needle size
        (ncc.rs:263-318)."""
        if self._prepared_size == (n_w, n_h):
            return self._prepared
        n = n_w * n_h
        x_searches = self.w - n_w + 1
        y_searches = self.h - n_h + 1

        # Vectorized rect sums for all (x, y) with x,y >= 1, differenced in
        # the tables' own dtypes so prefix-sum overflow wraps and cancels —
        # the reference's `as u32` truncation / u64 wrapping (ncc.rs:977-984,
        # 1006-1013). A u32 table wraps once total inverted ink exceeds 2^32
        # (~16.8M fully-dark pixels, i.e. large dark scans); widening before
        # differencing would make sp wrong by k*2^32 there.
        ys = np.arange(1, y_searches)
        xs = np.arange(1, x_searches)
        T = self.sum_table  # u32, wrapping
        a = T[np.ix_(ys + n_h - 1, xs + n_w - 1)]
        b = T[np.ix_(ys + n_h - 1, xs - 1)]
        c = T[np.ix_(ys - 1, xs + n_w - 1)]
        d = T[np.ix_(ys - 1, xs - 1)]
        sp = (a - b + d - c).astype(np.int64)  # exact: true sums fit u32

        T2 = self.sumsqr_table  # u64, wrapping
        a2 = T2[np.ix_(ys + n_h - 1, xs + n_w - 1)]
        b2 = T2[np.ix_(ys + n_h - 1, xs - 1)]
        c2 = T2[np.ix_(ys - 1, xs + n_w - 1)]
        d2 = T2[np.ix_(ys - 1, xs - 1)]
        s2p = (a2 - b2 + d2 - c2).astype(np.int64)

        start_end = np.zeros((self.h, 2), dtype=np.int64)
        patch_sum = np.zeros((self.h, self.w), dtype=np.int64)
        patch_rnorm = np.zeros((self.h, self.w), dtype=np.float64)
        nz = sp != 0
        for i, y in enumerate(ys):
            row_nz = nz[i]
            if row_nz.any():
                start = 1 + int(row_nz.argmax())
                end = 1 + len(xs) - int(row_nz[::-1].argmax())
            else:
                # while-loop exits at x = x_searches; end = start (empty range)
                # except the reference's backwards scan leaves end = x_searches
                # (see ncc.rs:291-301: x starts at x_searches-1, loop guard
                # x > start is false immediately, end = x + 1 = x_searches).
                start = x_searches
                end = x_searches
            start_end[y] = (start, end)
            if start < end:
                sl = slice(start - 1, end - 1)
                patch_sum[y, start:end] = sp[i, sl]
                with np.errstate(divide="ignore", invalid="ignore"):
                    norm = s2p[i, sl].astype(np.float64) - (
                        sp[i, sl].astype(np.float64) ** 2
                    ) / float(n)
                    patch_rnorm[y, start:end] = 1.0 / np.sqrt(norm)
        prepared = Prepared(start_end, patch_sum, patch_rnorm)
        self._prepared_size = (n_w, n_h)
        self._prepared = prepared
        return prepared

    def search(
        self, needle: np.ndarray, threshold: float, warn: bool = True
    ) -> list[Match]:
        """C-kernel-semantics search (ncc.cpp:48-251; dispatch ncc.rs:332-404).

        ``needle`` is the raw u8 template [n_h, n_w]; ``threshold`` the f32
        CLI threshold. Returns matches in row-major scan order, truncated at
        MAX_MATCHES.
        """
        n_h, n_w = needle.shape
        if n_w > 16:
            raise NotImplementedError("needle wider than 16 px (reference panics too, ncc.rs:392)")
        prep = self.prepare_for_size(n_w, n_h)
        n = n_w * n_h
        needle64 = needle.astype(np.int64)
        s_n = int(needle64.sum())
        s2_n = int((needle64 * needle64).sum())

        norm2_n = np.float64(s2_n) - np.float64(s_n * s_n) / np.float64(n)
        with np.errstate(divide="ignore", invalid="ignore"):
            rnorm_n = np.float64(1.0) / np.sqrt(norm2_n)
        n_recip = np.float64(1.0) / np.float64(n)
        threshold_d = np.float64(np.float32(threshold))

        y_searches = self.h - n_h + 1
        matches: list[Match] = []
        ref = self._ref64
        capped = False
        for y in range(1, y_searches):
            start, end = int(prep.start_end[y, 0]), int(prep.start_end[y, 1])
            if start >= end:
                continue
            # integer cross-correlation for this row span
            xs = np.arange(start, end)
            acc = np.zeros(len(xs), dtype=np.int64)
            for dy in range(n_h):
                row = ref[y + dy]
                win = np.lib.stride_tricks.sliding_window_view(row, n_w)[start:end]
                acc += win @ needle64[dy]
            sp = prep.patch_sum[y, start:end].astype(np.float64)
            rnp = prep.patch_rnorm[y, start:end]
            with np.errstate(invalid="ignore"):
                num = acc.astype(np.float64) - (np.float64(s_n) * sp) * n_recip
                sim = num * (rnorm_n * rnp)
                emit = (sim != np.inf) & (sim > threshold_d)
            for j in np.nonzero(emit)[0]:
                matches.append(
                    Match(
                        x=int(xs[j]),
                        y=int(y),
                        w=n_w,
                        h=n_h,
                        similarity=float(np.float32(sim[j])),
                    )
                )
                if len(matches) >= MAX_MATCHES:
                    capped = True
                    break
            if capped:
                break
        if capped and warn:
            print(f"WARN got >= {MAX_MATCHES} matches", file=sys.stderr)
        return matches
