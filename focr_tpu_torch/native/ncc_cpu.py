"""The ncc host tier: csrc/ncc_host.cpp behind NumPy interfaces.

Counterpart of focr_tpu/native/ncc_cpu.py, with its signatures and return
values:

  replay_group       — the exact f64 replay of the device's candidates, as
                       focr_tpu runs it on the host; off the port's main
                       path, where K3 (ops/replay_kernels.py) replays on
                       the card: the yardstick the tests and chip_smoke.py
                       hold K3 against
  post_page          — post-processing of one page's hits: anchor filter,
                       stable (y, x) sort, overlap-run winners and line
                       split (models/post.py::_post_page)
  post_winners       — the winner scan over sorted keys (post.py::_run_winners)
  NativeSearcher     — the all-host search of ``--engine native``

The library builds at first use (native/build.py::load_host); a failed build
raises, and no caller falls back to NumPy. The NumPy formulations stay beside
their callers as plain versions for the tests (models/ncc.py::
replay_group_reference, models/post.py::run_winners_reference and
winner_arrays_reference). Every entry point counts its calls in
``NATIVE_CALLS``. The calls release the GIL (ctypes), so several threads may
call at once.
"""

from __future__ import annotations

import sys
import threading

import numpy as np

from focr_tpu_torch.models.types import MAX_MATCHES, Match
from focr_tpu_torch.native.build import load_host
from focr_tpu_torch.oracle.ncc_oracle import Searcher as OracleSearcher

NATIVE_CALLS = {
    "search": 0, "search_many": 0, "replay_group": 0, "post_winners": 0, "post_page": 0,
}
_calls_lock = threading.Lock()  # collect threads count concurrently
# OpenMP threads of one replay_group call (0: the runtime's default team,
# every core). Two, as when the collect pool ran COLLECT_THREADS = 4 replays
# at once on 8 cores; the pool no longer replays (K3 does, on the card), so
# the team only sizes the yardstick's calls.
REPLAY_TEAM = 2

# csrc/ncc_host.cpp's FMatch {uint16 x, uint16 y, float similarity}
_FMATCH = np.dtype([("x", "<u2"), ("y", "<u2"), ("similarity", "<f4")])


def reset_native_calls() -> None:
    with _calls_lock:
        for k in NATIVE_CALLS:
            NATIVE_CALLS[k] = 0


def _count(name: str) -> None:
    with _calls_lock:
        NATIVE_CALLS[name] += 1


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class NativeSearcher:
    """oracle.ncc_oracle.Searcher with the correlation sweep in C++: the
    oracle's integral tables and patch stats (vectorized NumPy, and they
    encode the `_nz` border quirk) are reused; only the per-needle sweep is
    native."""

    def __init__(self, img: np.ndarray):
        self._lib = load_host()
        self._oracle = OracleSearcher(img)
        self.h, self.w = self._oracle.h, self._oracle.w
        self._ref = np.ascontiguousarray(self._oracle.reference)

    def _prep(self, n_w: int, n_h: int):
        prep = self._oracle.prepare_for_size(n_w, n_h)
        return (
            np.ascontiguousarray(prep.patch_sum),
            np.ascontiguousarray(prep.patch_rnorm),
            np.ascontiguousarray(prep.start_end),
        )

    def _needles(self, needles: np.ndarray) -> np.ndarray:
        n_h, n_w = needles.shape[-2:]
        if n_w > 16:
            raise NotImplementedError("needle wider than 16 px (reference panics too)")
        if n_w > self.w or n_h > self.h:
            raise ValueError(f"needle {n_w}x{n_h} larger than the page {self.w}x{self.h}")
        return np.ascontiguousarray(needles, dtype=np.uint8)

    def search(self, needle: np.ndarray, threshold: float, warn: bool = True) -> list[Match]:
        """One needle, the oracle's semantics: matches in scan order,
        truncated at MAX_MATCHES with the reference's WARN."""
        nd = self._needles(needle)
        n_h, n_w = nd.shape
        ps, rn, se = self._prep(n_w, n_h)
        out = np.empty(MAX_MATCHES, _FMATCH)
        _count("search")
        cnt = self._lib.focr_ncc_search_u8(
            _ptr(self._ref), self.w, self.h, _ptr(nd), n_w, n_h,
            _ptr(ps), _ptr(rn), _ptr(se), threshold, _ptr(out), MAX_MATCHES,
        )
        if cnt < 0:
            raise ValueError("ncc host library rejected the arguments")
        if cnt >= MAX_MATCHES and warn:
            print(f"WARN got >= {MAX_MATCHES} matches", file=sys.stderr)
        return _matches(out[:cnt], n_w, n_h)

    def search_many(self, needles: np.ndarray, threshold: float) -> list[list[Match]]:
        """A [T, n_h, n_w] bank of same-size needles, OpenMP-parallel across
        needles (the reference's rayon fan-out). No WARN, as in focr_tpu."""
        nd = self._needles(needles)
        T, n_h, n_w = nd.shape
        ps, rn, se = self._prep(n_w, n_h)
        out = np.empty(T * MAX_MATCHES, _FMATCH)
        counts = np.zeros(T, dtype=np.int64)
        _count("search_many")
        self._lib.focr_ncc_search_many_u8(
            _ptr(self._ref), self.w, self.h, _ptr(nd), T, n_w, n_h,
            _ptr(ps), _ptr(rn), _ptr(se), threshold, _ptr(out), MAX_MATCHES,
            _ptr(counts),
        )
        if (counts < 0).any():
            raise ValueError("ncc host library rejected the arguments")
        return [
            _matches(out[t * MAX_MATCHES : t * MAX_MATCHES + int(counts[t])], n_w, n_h)
            for t in range(T)
        ]


def _matches(rows: np.ndarray, n_w: int, n_h: int) -> list[Match]:
    return [
        Match(x=x, y=y, w=n_w, h=n_h, similarity=s)
        for x, y, s in zip(
            rows["x"].tolist(), rows["y"].tolist(), rows["similarity"].tolist()
        )
    ]


def replay_group(
    inv: np.ndarray,  # [H, W] u8 inverted page
    pos: np.ndarray,  # [N] i32 full-page linear candidate positions y*row_len + x
    starts: np.ndarray,  # [T] i64 candidate-range start per needle
    ends: np.ndarray,  # [T] i64 candidate-range end per needle
    bank: np.ndarray,  # [T, nh, nw] u8
    s_n: np.ndarray,  # [T] i64
    s2_n: np.ndarray,  # [T] i64
    thr_f64: float,
    row_len: int,  # the positions' row length W1
    max_matches: int,
):
    """Exact f64 replay of one size group's candidate positions.

    Returns (out_x i32, out_y i32, out_sim f32, counts i32 [T], warn u8 [T]):
    needle t's hits are out[starts[t] : starts[t] + counts[t]], in scan
    order, capped at max_matches; warn[t] is the reference's WARN condition
    (>= max_matches accepted). Window stats are recomputed per candidate from
    the page bytes, so no integral tables are needed."""
    lib = load_host()
    inv = np.ascontiguousarray(inv, dtype=np.uint8)
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    bank = np.ascontiguousarray(bank, dtype=np.uint8)
    s_n = np.ascontiguousarray(s_n, dtype=np.int64)
    s2_n = np.ascontiguousarray(s2_n, dtype=np.int64)
    T = len(starts)  # needles to replay
    _, n_h, n_w = bank.shape
    H, W = inv.shape
    if not (len(ends) == T and len(bank) >= T and len(s_n) >= T and len(s2_n) >= T):
        raise ValueError("replay_group: per-needle arrays disagree in length")
    if T and ((starts < 0).any() or (ends < starts).any() or ends.max() > len(pos)):
        raise ValueError("replay_group: candidate ranges outside the positions")
    if len(pos):
        ys, xs = np.divmod(pos, np.int32(row_len))
        if pos.min() < 0 or ys.max() + n_h > H or xs.max() + n_w > W:
            raise ValueError("replay_group: a candidate window lies outside the page")
    cap = max(len(pos), 1)
    out_x = np.empty(cap, dtype=np.int32)
    out_y = np.empty(cap, dtype=np.int32)
    out_sim = np.empty(cap, dtype=np.float32)
    counts = np.zeros(T, dtype=np.int32)
    warn = np.zeros(T, dtype=np.uint8)
    _count("replay_group")
    lib.focr_ncc_replay_pos_u8(
        _ptr(inv), W, H, _ptr(pos), _ptr(starts), _ptr(ends), T,
        _ptr(bank), n_w, n_h, _ptr(s_n), _ptr(s2_n),
        float(thr_f64), int(row_len), int(max_matches),
        _ptr(out_x), _ptr(out_y), _ptr(out_sim), _ptr(counts), _ptr(warn), REPLAY_TEAM,
    )
    return out_x, out_y, out_sim, counts, warn


def post_page(
    y: np.ndarray, x: np.ndarray, sim: np.ndarray, nid: np.ndarray, codes: np.ndarray,
    anchor: float, overlap: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """process_hits (ncc.rs:723-786) over one page's hits in engine order:
    ``y``, ``x`` the coordinates, ``sim`` the f32 similarities, ``nid`` the
    needle ids, ``codes`` each needle's letter as a u32 code. Returns (each
    run winner's ORIGINAL index in output order, i64; its letter's code,
    u32; the split points between text lines in that list, i64). The
    anchor is compared in float32; coordinates lie in 0..65535, the
    reference's u16 (ncc.rs:66-72), and needle ids index ``codes``, else
    ValueError."""
    y = np.ascontiguousarray(y, dtype=np.int64)
    x = np.ascontiguousarray(x, dtype=np.int64)
    sim = np.ascontiguousarray(sim, dtype=np.float32)
    nid = np.ascontiguousarray(nid, dtype=np.int32)
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    if y.ndim != 1 or any(a.shape != y.shape for a in (x, sim, nid)) or codes.ndim != 1:
        raise ValueError("post_page: y, x, sim and nid must be 1-D of one length")
    lib = load_host()
    n = len(y)
    win = np.empty(n, dtype=np.int64)
    wcodes = np.empty(n, dtype=np.uint32)
    bounds = np.empty(n, dtype=np.int64)
    nb = np.zeros(1, dtype=np.int64)
    # u16 coordinates: any overlap past 65535 acts as 65536, any negative as -1
    ov = min(max(int(overlap), -1), 1 << 16)
    _count("post_page")
    nw = lib.focr_post_page(_ptr(y), _ptr(x), _ptr(sim), _ptr(nid), n,
                            float(np.float32(anchor)), ov, _ptr(codes), len(codes),
                            _ptr(win), _ptr(wcodes), _ptr(bounds), _ptr(nb))
    if nw == -1:
        raise ValueError("post_page: a coordinate lies outside 0..65535")
    if nw < 0:
        raise ValueError(f"post_page: a needle id lies outside 0..{len(codes) - 1}")
    return win[:nw], wcodes[:nw], bounds[: int(nb[0])]


def post_winners(key: np.ndarray, sim: np.ndarray, overlap: int) -> np.ndarray:
    """Overlap-run winner scan over SORTED keys: ``key`` the composite
    (y << xbits) + x key (i64, ascending), ``sim`` the f32 similarities in
    the same order. Returns the winner's index per run, in run order
    (partition_by + last-max semantics, ncc.rs:753-766, 1036-1052)."""
    key = np.ascontiguousarray(key, dtype=np.int64)
    sim = np.ascontiguousarray(sim, dtype=np.float32)
    if key.shape != sim.shape or key.ndim != 1:
        raise ValueError("post_winners: key and sim must be 1-D of one length")
    out = np.empty(len(key), dtype=np.int64)
    _count("post_winners")
    nr = load_host().focr_post_winners(_ptr(key), _ptr(sim), len(key), int(overlap), _ptr(out))
    return out[:nr]


__all__ = [
    "NATIVE_CALLS", "NativeSearcher", "post_page", "post_winners",
    "replay_group", "reset_native_calls",
]
