"""The ncc template matcher on PyTorch + CUDA.

Counterpart of focr_tpu/models/ncc.py. Per wave of same-shape pages:

  dispatch (_dispatch_wave): invert -> ink-bbox crop (_ink_crop) -> upload
  -> per needle-size group: K1 ncc_sweep (candidate bitmask + row counts) ->
  K2's count kernel -> one wait for the group's counts -> K2's emit kernel
  (positions in scan order, sized by the exact count) -> K3 ncc_replay (the
  exact f64 replay of those positions where they sit, with the MAX_MATCHES
  scan cap, ncc.cpp:222-229: full-page x, y, f32 sim, counts, WARN flags)
  -> every group's hits copied to the host without blocking, one event
  recorded
  fetch (_fetch_wave): the wait on that event, the hits cut by page
  collect (_collect_page), per page on the collect pool: each needle's hits
  in reference iteration order (offsets outer, letters inner —
  ncc.rs:587-655), the WARN lines -> models/post.py.

get_hits_many runs the three stages as focr_tpu does (models/ncc.py:549-613):
a dispatch thread, a fetch thread and the collect pool, with PIPELINE_DEPTH
waves in flight beyond the one being collected. On a card the dispatch thread
works on a side stream, so a wave's upload and sweep run under the previous
wave's collection; uploads and fetches go through pinned host buffers that a
wave holds until its event has been waited on (_PinnedPool). Each stage is a
named span in a torch.profiler trace (focr_ncc_dispatch_wave,
focr_ncc_fetch_wave, focr_ncc_collect_wave; --profile), and the stages keep
counters (utils/metrics.py::count): K2's candidates (ncc_candidates), the
hits K3 kept (ncc_hits), the waits on the card (ncc_host_waits, beside
HOST_WAITS) and the caller's post-processing time a page, summed over the
collect threads (ncc_post_ns: a counter, since a span a page would cost more
than it measures; models/post.py counts the pages it posts in one call of
the host library in ncc_post_native). Every device
tensor of a wave is allocated, used and freed on that one stream, so the
caching allocator never hands a block to another stream while it is in use.

The sweep is a candidate FILTER: an ε-superset of the reference's accept
set; K3's exact f64 replay decides every hit, so the output is bit-identical
to the oracle (oracle/ncc_oracle.py) and to focr_tpu, whose replay runs on
the host (a TPU has no f64 unit). The host library's replay (native/
ncc_cpu.py::replay_group) and the NumPy one (replay_group_reference) are no
longer on the path: they are the yardsticks the tests and chip_smoke.py hold
K3 against (replay_inputs gives them K2's positions of one page).
focr_tpu's transport-era machinery (candidate caps and redo ladders, wire
codecs, adaptive wave and depth sizing) has nothing to do on a local card and
is not carried over: the depth is fixed.

On a mesh (parallel/mesh.py; get_hits_many_sharded) the same three stages
run with waves of WAVE pages for every slot: the dispatch thread deals a wave
round-robin over the slots (_scatter_waves, focr_tpu/models/ncc.py:722-789),
each slot with its own needle banks, stream and pinned pool (_SlotState), and
the fetch stage puts the pages back in order. Under several processes each
sweeps and replays a strided share of the corpus on its own slots and the
packed hits are all-gathered as host bytes (_get_hits_many_multiproc).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from focr_tpu_torch.fonts.bank import Needle, build_needles
from focr_tpu_torch.fonts.ft import Face
from focr_tpu_torch.models.types import MAX_MATCHES, BoxSize, MatchWithLetter, RenderOptions
from focr_tpu_torch.native import ncc_cpu
from focr_tpu_torch.ops.ncc import word_stride
from focr_tpu_torch.ops.ncc_kernels import (
    compact_counts,
    compact_emit,
    ncc_sweep,
    pack_needles,
    split_counts,
    sweep_plan,
    sweep_terms,
    sweep_tier,
    to_host,
)
from focr_tpu_torch.ops.replay_kernels import (
    ReplayNeedles, ncc_replay, replay_needles, split_replay,
)
from focr_tpu_torch.parallel import mesh as mesh_mod
from focr_tpu_torch.utils.device import resolve_device, slot_scope
from focr_tpu_torch.utils.metrics import count, span

WAVE = 8  # pages per device wave
# waves in flight beyond the one being collected (focr_tpu/models/ncc.py:565-613
# starts from 3 and adapts to its transport's stalls; a local card has none).
# 0 runs the stages one after another. On the card's 8-core host no depth from
# 0 to 3 read resolvably better than another (PERF.md §5): the host's
# collect stage bounds the run; 2 stands as the least depth that keeps a wave
# ready whenever a collection ends.
PIPELINE_DEPTH = 2
# pages of a wave collected at once (focr_tpu/models/ncc.py:552 takes 4). A
# page's collection reads K3's hits and assembles them in reference order, and
# the caller's post-processing runs in the same task; both hold the GIL but for
# the native post scan. On the card's 8-core host 2 threads collected as fast
# as 4 or faster, with ~8% less of the process's CPU and runs no wider spread;
# 1 was slower (PERF.md §6, the ncc cell)
COLLECT_THREADS = 2
HOST_WAITS = 0  # times the device stage waited on the card (dispatch + fetch)
_waits_lock = threading.Lock()  # the dispatch and fetch threads both count


def reset_host_waits() -> None:
    global HOST_WAITS
    with _waits_lock:
        HOST_WAITS = 0


def _count_host_wait() -> None:
    global HOST_WAITS
    with _waits_lock:
        HOST_WAITS += 1
    count("ncc_host_waits", 1)


class _PinnedPool:
    """Pinned host staging buffers, reused across waves. ``take`` hands out a
    u8 buffer of at least ``nbytes`` (a free one that is large enough, else a
    new one); the taker keeps it until the copies that read or write it are
    known to be done (the wave's event), then gives it back. Taken and given
    back from different threads."""

    def __init__(self):
        self._free: list[torch.Tensor] = []
        self._lock = threading.Lock()
        self.allocated = 0  # buffers ever created

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            for k, buf in enumerate(self._free):
                if buf.numel() >= nbytes:
                    return self._free.pop(k)
            self.allocated += 1
        size = -(-max(nbytes, 1) // (1 << 20)) * (1 << 20)  # whole MiB: sizes repeat
        return torch.empty(size, dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor) -> None:
        with self._lock:
            self._free.append(buf)


@dataclass
class _Dispatched:
    """A wave between _dispatch_wave and _fetch_wave."""

    per_page: list  # (page, inverted page, plan, start time, crop) per page
    swept: list[tuple]  # (plans, slot, grp, off, hcnt, total) of each swept group
    hits: list[torch.Tensor]  # K3's output of each swept group, on the host (split_replay)
    event: "torch.cuda.Event | None"  # a card: recorded behind the wave's last copy
    held: list[torch.Tensor]  # pinned buffers (hits lie in one) to give back after the event
    pool: "_PinnedPool | None"  # where they go back to: the pool of the slot that swept


@dataclass
class _SlotState:
    """What the device stage needs on one slot: the needle banks there, the
    stream it works on and the pinned staging pool (a card only). The matcher
    holds one for its own device and one for each mesh slot it has met."""

    device: torch.device
    dev_groups: list
    stream: "torch.cuda.Stream | None"
    pinned: "_PinnedPool | None"
    slot: "mesh_mod.Slot | None"

_NO_STREAM = contextlib.nullcontext()  # the CPU's place for torch.cuda.stream

_EMPTY = (
    np.zeros(0, np.int64),
    np.zeros(0, np.int64),
    np.zeros(0, np.float32),
)


@dataclass(frozen=True)
class HitStruct:
    """Array-of-hits form of get_hits output (reference iteration order) —
    the allocation-free fast path for post-processing big corpora."""

    needle_id: np.ndarray  # i32 [N] index into matcher.needles
    x: np.ndarray  # i64 [N]
    y: np.ndarray  # i64 [N]
    sim: np.ndarray  # f32 [N]
    matcher: "NccMatcher"

    def __len__(self) -> int:  # pragma: no cover - trivial
        return len(self.x)

    def to_objects(self) -> list[MatchWithLetter]:
        out: list[MatchWithLetter] = []
        i = 0
        N = len(self.x)
        while i < N:  # hits are grouped by needle (reference iteration order)
            j = i
            nid = self.needle_id[i]
            while j < N and self.needle_id[j] == nid:
                j += 1
            out.extend(
                self.matcher._needle_objects(
                    int(nid), (self.x[i:j], self.y[i:j], self.sim[i:j])
                )
            )
            i = j
        return out


def _pack_hits_payload(structs: list["HitStruct"]) -> bytes:
    """Serialize per-page hit structs for the multi-process result
    all-gather: per page — n i64, then nid i32[n], x i32[n], y i32[n], sim
    f32[n] (focr_tpu/models/ncc.py:154-167, byte for byte). Coordinates fit
    i32 for any real page (the reference caps them at u16, ncc.rs:66-72); f32
    similarity bits travel verbatim, so the decode side reconstructs
    bit-identical hits."""
    parts: list[bytes] = []
    for s in structs:
        parts.append(np.int64(len(s.x)).tobytes())
        parts.append(np.ascontiguousarray(s.needle_id, np.int32).tobytes())
        parts.append(s.x.astype(np.int32).tobytes())
        parts.append(s.y.astype(np.int32).tobytes())
        parts.append(np.ascontiguousarray(s.sim, np.float32).tobytes())
    return b"".join(parts)


def _unpack_hits_payload(buf: bytes) -> list[tuple]:
    """Inverse of _pack_hits_payload: list of (nid, x, y, sim) per page."""
    out: list[tuple] = []
    off = 0
    while off < len(buf):
        n = int(np.frombuffer(buf, np.int64, 1, off)[0])
        off += 8
        arrs = []
        for dt in (np.int32, np.int32, np.int32, np.float32):
            arrs.append(np.frombuffer(buf, dt, n, off))
            off += 4 * n
        out.append(tuple(arrs))
    return out


def _ink_crop(inv: np.ndarray, H: int, W: int, groups) -> tuple | None:
    """Ink-bbox crop (y0, x0, Hc, Wc) for a stacked inverted wave [*, H, W].

    Hits require a window with Σp > 0, and every such window lies within the
    ink bounding box expanded by one needle size: windows at local x=1/y=1
    then map exactly to the leftmost/topmost possible inked full-page
    windows, and the excluded local x=0/y=0 columns are provably Σp == 0 —
    or the reference's own x=0/y=0 exclusion when the crop hits the page
    edge (ncc.cpp:98). This is a device candidate FILTER: per the bit-parity
    invariant, widening it is safe, narrowing it is a correctness bug — keep
    the wave and sharded paths on this single implementation. Dims round up
    to 64 to bound compiled shapes. Returns None for a blank (all-white)
    wave: zero candidates everywhere, skip the device entirely.
    """
    sweepable = [g for g in groups if g.nh < H and g.nw < W]
    if not sweepable:
        return (0, 0, H, W)
    rows_ink = inv.any(axis=(0, 2))
    if not rows_ink.any():
        return None
    cols_ink = inv.any(axis=(0, 1))
    nz_r = np.flatnonzero(rows_ink)
    nz_c = np.flatnonzero(cols_ink)
    nh_m = max(g.nh for g in sweepable)
    nw_m = max(g.nw for g in sweepable)
    y0 = max(0, int(nz_r[0]) - nh_m)
    x0 = max(0, int(nz_c[0]) - nw_m)
    y1 = min(H, int(nz_r[-1]) + 1 + nh_m)
    x1 = min(W, int(nz_c[-1]) + 1 + nw_m)
    Hc = min(H - y0, -(-(y1 - y0) // 64) * 64)
    Wc = min(W - x0, -(-(x1 - x0) // 64) * 64)
    return (y0, x0, Hc, Wc)


@dataclass(frozen=True)
class _Group:
    nh: int
    nw: int
    needle_ids: list[int]  # indices into the needle list, original order
    bank: np.ndarray  # [T, nh, nw] u8
    s_n: np.ndarray  # [T] i64
    s2_n: np.ndarray  # [T] i64


def _group_needles(needles: list[Needle]) -> list[_Group]:
    groups: dict[tuple[int, int], list[int]] = {}
    for i, nd in enumerate(needles):
        groups.setdefault(nd.pixels.shape, []).append(i)
    out = []
    for (nh, nw), ids in groups.items():
        out.append(
            _Group(
                nh=nh,
                nw=nw,
                needle_ids=ids,
                bank=np.stack([needles[i].pixels for i in ids]),
                s_n=np.array([needles[i].s_n for i in ids], dtype=np.int64),
                s2_n=np.array([needles[i].s2_n for i in ids], dtype=np.int64),
            )
        )
    return out


@dataclass(frozen=True)
class DeviceGroup:
    """One size group's needle bank on the device, with the sweep's derived
    per-needle f32 terms and the bank packed for K1's plan."""

    bank: torch.Tensor  # [T, nh, nw] u8
    s_n: torch.Tensor  # [T] i64
    s2_n: torch.Tensor  # [T] i64
    sn_n: torch.Tensor  # [T] f32 Σn / n
    rtn: torch.Tensor  # [T] f32 √norm², +inf for zero-variance needles
    thr_eps: float  # f32(threshold) − f32(ε), exactly representable in f32
    packed: torch.Tensor  # pack_needles(bank, sweep_plan(...)): K1's B (wgmma) or A (mma)
    replay: ReplayNeedles  # bank, s_n and s2_n as K3 takes them, checked once

    @property
    def terms(self) -> tuple[torch.Tensor, torch.Tensor, float]:
        return self.sn_n, self.rtn, self.thr_eps


def group_from_numpy(
    bank: np.ndarray, s_n: np.ndarray, s2_n: np.ndarray, threshold: float,
    device: torch.device | str,
) -> DeviceGroup:
    """Carry one focr_tpu-style size group (numpy bank [T, nh, nw] u8, s_n and
    s2_n [T] i64) to ``device``, deriving sn_n, rtn and thr−ε exactly as
    focr_tpu/ops/pallas_ncc.py:309-321 does (f32, from the exact int64
    norm²)."""
    bank_t = torch.from_numpy(np.ascontiguousarray(bank, dtype=np.uint8))
    s_n_t = torch.from_numpy(np.ascontiguousarray(s_n, dtype=np.int64))
    s2_n_t = torch.from_numpy(np.ascontiguousarray(s2_n, dtype=np.int64))
    n = bank_t.shape[1] * bank_t.shape[2]
    sn_n, rtn, thr_eps = sweep_terms(s_n_t, s2_n_t, n, threshold)
    plan = sweep_plan(*bank_t.shape[1:], sweep_tier(n, threshold))
    bank_d, s_n_d, s2_n_d = bank_t.to(device), s_n_t.to(device), s2_n_t.to(device)
    return DeviceGroup(
        bank=bank_d, s_n=s_n_d, s2_n=s2_n_d,
        sn_n=sn_n.to(device), rtn=rtn.to(device), thr_eps=thr_eps,
        packed=pack_needles(bank_t, plan).to(device),
        replay=replay_needles(bank_d, s_n_d, s2_n_d),
    )


def exact_similarities(
    acc: np.ndarray, sp: np.ndarray, s2p: np.ndarray, s_n: int, s2_n: int, n: int
) -> np.ndarray:
    """The reference's f64 similarity, computed from exact integers.

    Mirrors ncc.cpp:233-238 (and the precompute ncc.rs:306-312):
      rnorm_p = 1/sqrt(s2p - sp*sp/n)        [division by n]
      num     = acc - (s_n*s_p) * (1/n)      [multiplication by 1/n]
      sim     = num * (rnorm_n * rnorm_p)
    """
    nf = np.float64(n)
    n_recip = np.float64(1.0) / nf
    s_n64 = np.asarray(s_n, dtype=np.float64)  # scalar or per-candidate array
    s2_n64 = np.asarray(s2_n, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rnorm_n = np.float64(1.0) / np.sqrt(s2_n64 - s_n64 * s_n64 / nf)
        norm_p = s2p.astype(np.float64) - (sp.astype(np.float64) * sp.astype(np.float64)) / nf
        rnorm_p = np.float64(1.0) / np.sqrt(norm_p)
        num = acc.astype(np.float64) - (s_n64 * sp.astype(np.float64)) * n_recip
        return num * (rnorm_n * rnorm_p)


def replay_inputs(grp: _Group, data: tuple, inv: np.ndarray, crop: tuple, thr_f64) -> tuple:
    """The arguments of the host replays, native/ncc_cpu.py::replay_group
    and replay_group_reference (K3's yardsticks, off the main path), for one
    swept size group of one page from ``data`` = (K2's crop-local positions
    of the page, its per-needle counts): the positions remapped to the full
    page, whose row length is W1 = word_stride(W, nw)·32
    (focr_tpu/models/ncc.py:1390-1408), and each needle's candidate range
    from the exact per-needle counts."""
    H, W = inv.shape
    cy0, cx0, Hc, Wc = crop
    pos_v, hcnt = data
    W1 = word_stride(W, grp.nw) * 32
    if (Hc, Wc) != (H, W):
        W1c = word_stride(Wc, grp.nw) * 32
        ysv, xsv = np.divmod(pos_v, np.int32(W1c))
        pos_v = (ysv + np.int32(cy0)) * np.int32(W1) + (xsv + np.int32(cx0))
    ends = np.cumsum(hcnt.astype(np.int64))
    starts = ends - hcnt
    return (inv, pos_v, starts, ends, grp.bank, grp.s_n, grp.s2_n, float(thr_f64), W1,
            MAX_MATCHES)


def replay_group_reference(
    inv, pos, starts, ends, bank, s_n, s2_n, thr_f64, row_len, max_matches
):
    """The plain NumPy version of native/ncc_cpu.py::replay_group, with its
    arguments and return value: window stats gathered from i32 page planes,
    exact_similarities, the accept test and the MAX_MATCHES cap
    (focr_tpu/models/ncc.py:1429-1461, 1489-1497). Not on the main path (K3,
    ops/replay_kernels.py, replays there)."""
    T = len(starts)
    _, nh, nw = bank.shape
    n = nh * nw
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(ends, np.int64) - starts
    cand = (
        np.concatenate([np.arange(a, a + k) for a, k in zip(starts, lens)])
        if T else np.zeros(0, np.int64)
    )
    nid_c = np.repeat(np.arange(T), lens)
    ys, xs = np.divmod(np.asarray(pos, np.int64)[cand], row_len)
    # window sums over these fit i32: n*255^2 < 2^31 (sweep_tier)
    i32 = inv.astype(np.int32)
    wins = np.lib.stride_tricks.sliding_window_view(i32, (nh, nw))
    wins_sq = np.lib.stride_tricks.sliding_window_view(i32 * i32, (nh, nw))
    bank32 = bank.astype(np.int32)
    s_n = np.asarray(s_n, np.int64)
    s2_n = np.asarray(s2_n, np.int64)
    sim = np.empty(len(cand), np.float64)
    # chunked: the [chunk, nh, nw] i32 gathers are the peak host allocation
    CH = 65536
    for c0 in range(0, len(cand), CH):
        sl = slice(c0, min(c0 + CH, len(cand)))
        w_cand = wins[ys[sl], xs[sl]]
        acc = (w_cand * bank32[nid_c[sl]]).sum(axis=(1, 2), dtype=np.int32)
        sp = w_cand.sum(axis=(1, 2), dtype=np.int32)
        s2p = wins_sq[ys[sl], xs[sl]].sum(axis=(1, 2), dtype=np.int32)
        sim[sl] = exact_similarities(acc, sp, s2p, s_n[nid_c[sl]], s2_n[nid_c[sl]], n)
    cap = max(len(pos), 1)
    out_x = np.empty(cap, np.int32)
    out_y = np.empty(cap, np.int32)
    out_sim = np.empty(cap, np.float32)
    counts = np.zeros(T, np.int32)
    warn = np.zeros(T, np.uint8)
    c0 = 0
    for t in range(T):
        s = slice(c0, c0 + int(lens[t]))
        c0 = s.stop
        keep = (sim[s] != np.inf) & (sim[s] > thr_f64)
        kept = int(keep.sum())
        k = min(kept, max_matches)
        o = int(starts[t])
        out_x[o : o + k] = xs[s][keep][:k]
        out_y[o : o + k] = ys[s][keep][:k]
        out_sim[o : o + k] = sim[s][keep][:k]
        counts[t] = k
        warn[t] = kept >= max_matches
    return out_x, out_y, out_sim, counts, warn


class NccMatcher:
    """One (font, size, alphabet, offsets, box policy) matching configuration
    on one device. ``needles``: a bank rendered elsewhere
    (fonts/bank.py::load_needle_bank); ``face`` may then be None unless raw
    output needs its metrics."""

    def __init__(
        self,
        face: Face | None,
        alphabet: str,
        ropts: RenderOptions,
        box_size: BoxSize = BoxSize.ALPHABET,
        x_bits: int = 0,
        y_bits: int = 0,
        padding: tuple[int, int] = (0, 0),
        threshold: float = 0.8,
        device: str | torch.device = "cuda",
        needles: list[Needle] | None = None,
    ):
        self.device = resolve_device(device)
        self.face = face
        self.alphabet = alphabet
        self.ropts = ropts
        self.threshold = float(threshold)
        if needles is None:
            needles = build_needles(face, alphabet, ropts, box_size, x_bits, y_bits, padding)
        self.needles = needles
        self.groups = _group_needles(self.needles)
        # per slot: the banks on its device, the device stage's stream and its
        # staging buffers. None is the matcher's own device (a side stream of
        # its own); a mesh's slots are added as they are first swept on
        cuda = self.device.type == "cuda"
        self._states: dict[tuple | None, _SlotState] = {None: _SlotState(
            self.device, self._upload_groups(self.device),
            torch.cuda.Stream(self.device) if cuda else None,
            _PinnedPool() if cuda else None, None)}
        self._states_lock = threading.Lock()

    @property
    def dev_groups(self) -> list[DeviceGroup]:
        """The needle banks on the matcher's own device."""
        return self._states[None].dev_groups

    def _upload_groups(self, device: torch.device) -> list[DeviceGroup]:
        return [group_from_numpy(g.bank, g.s_n, g.s2_n, self.threshold, device)
                for g in self.groups]

    def _state(self, slot) -> _SlotState:
        """The device stage's state on ``slot`` (None: the matcher's own
        device), built when the slot is first swept on: the banks go up on
        the slot's own stream, so nothing has to wait for another stream."""
        if slot is None:
            return self._states[None]
        key = (slot.index, str(slot.device))  # by value: an equal mesh finds its banks
        with self._states_lock:
            st = self._states.get(key)
            if st is None:
                with slot.context():
                    groups = self._upload_groups(slot.device)
                st = _SlotState(slot.device, groups, slot.stream,
                                _PinnedPool() if slot.device.type == "cuda" else None, slot)
                self._states[key] = st
            return st

    def get_hits(
        self, page: np.ndarray, verbose: bool = False, raw: bool = False, out=None,
        sync: bool = False,
    ) -> list[MatchWithLetter]:
        """Device search and exact replay; hits in reference order
        (get_hits, ncc.rs:544-721).

        ``sync``: fence the device after every size group's dispatch, so the
        verbose elapsed/ns-per-pixel lines are true wall-clock measurements
        (the reference measures each search, ncc.rs:657-666; the default can
        only estimate, since device work is asynchronous). Slower by
        design."""
        meas: dict | None = {} if sync else None
        d = self._fetch_wave(self._dispatch_wave([page], measure=meas))[0]
        return self._collect_page(d, verbose, raw, out, meas=meas)

    def get_hits_many(
        self, pages: list[np.ndarray], verbose: bool = False, struct: bool = False,
        post=None,
    ) -> list:
        """Every page's hits (HitStruct when ``struct``), in page order, from
        waves of WAVE pages through three stages on three sets of threads, as
        focr_tpu runs them (models/ncc.py:549-613): a dispatch thread
        (_dispatch_wave: invert, crop, upload, sweep, compaction, replay), a
        fetch thread (_fetch_wave: the wait for the wave's hits) and the
        collect pool (COLLECT_THREADS pages at once: assembly and ``post``),
        with up to PIPELINE_DEPTH waves in flight beyond the one being
        collected, so a wave's upload and sweep run under the previous wave's
        collection. With ``verbose`` pages collect serially, so the stderr
        lines keep the reference's order. ``post``: applied to each page's
        hits inside its collect task; the list then holds post(hits) per
        page. An exception in any stage is raised here."""
        return self._scatter_waves(pages, [None], verbose, struct, post)

    def get_hits_many_sharded(
        self, pages: list[np.ndarray], mesh, verbose: bool = False,
        struct: bool = False, post=None,
    ) -> list:
        """Multi-card corpus search (focr_tpu/models/ncc.py:615-647): the
        pages are dealt over every slot of the mesh, pages and glyphs axes
        alike (data parallelism: ncc has no glyph axis worth sharding), each
        slot sweeping and replaying its pages with K1, K2 and K3.
        Bit-identical to get_hits_many. Pages should share one shape (the
        caller buckets).

        Under several processes each sweeps and replays a strided share of
        the corpus on its own slots and the hit arrays are all-gathered
        (_get_hits_many_multiproc), so every process returns every page.
        ``verbose`` prints per-search lines during collection, and a process
        only collects its own share: a verbose run under several processes
        therefore runs the whole corpus on each process's own slots."""
        if not pages:
            return []
        if len(mesh.owners) > 1:
            if not verbose:
                return self._get_hits_many_multiproc(pages, mesh, struct, post)
            print(
                "focr_tpu_torch: multi-process --verbose run: every process searches "
                "the whole corpus on its own slots (per-search diagnostics need every "
                "page's replay on every process)",
                file=sys.stderr,
            )
        return self._scatter_waves(pages, mesh.local_slots, verbose, struct, post)

    def _scatter_waves(
        self, pages: list[np.ndarray], slots: list, verbose: bool, struct: bool, post,
    ) -> list:
        """The three-stage pipeline over ``slots`` (mesh slots, or [None] for
        the matcher's own device: then this is get_hits_many's single-card
        path). A wave is WAVE pages for every slot; slot d takes pages d, d+D,
        d+2D, ... of it (focr_tpu/models/ncc.py:766-774) and sweeps them in
        one dispatch on its own stream; the fetch stage restores the page
        order. One dispatch thread deals to every slot, so the launch and
        wait counters keep a single writer each. A slot with fewer pages
        simply sweeps fewer: inverted pages need no filler."""
        D = len(slots)

        def collect_one(d):
            hits = self._collect_page(d, verbose, False, None, struct)
            if post is None:
                return hits
            t = time.perf_counter_ns()  # a counter, not a span: post runs once a page
            lines = post(hits)
            count("ncc_post_ns", time.perf_counter_ns() - t)
            return lines

        def dispatch(sub: list) -> tuple[list, int]:
            return [(d, self._dispatch_wave(sub[d::D], slot=slots[d]))
                    for d in range(D) if sub[d::D]], len(sub)

        def fetch(dfut: cf.Future) -> list:
            sub_waves, n = dfut.result()
            merged: list = [None] * n
            for d, disp in sub_waves:  # back from the round-robin deal
                for k, tup in enumerate(self._fetch_wave(disp)):
                    merged[d + k * D] = tup
            return merged

        out: list = []
        own = self._states[None]
        if None in slots and own.stream is not None:
            # the groups' banks were uploaded on the caller's stream
            own.stream.wait_stream(torch.cuda.current_stream(self.device))
        with (
            cf.ThreadPoolExecutor(max_workers=1) as dpool,
            cf.ThreadPoolExecutor(max_workers=1) as fpool,
            cf.ThreadPoolExecutor(max_workers=COLLECT_THREADS) as cpool,
        ):
            def collect_wave(fetched: list) -> None:
                with span("focr_ncc_collect_wave"):
                    if verbose:
                        out.extend([collect_one(d) for d in fetched])
                    else:
                        out.extend(cpool.map(collect_one, fetched))

            pending: deque[tuple[cf.Future, cf.Future]] = deque()
            try:
                for s in range(0, len(pages), WAVE * D):
                    dfut = dpool.submit(dispatch, pages[s : s + WAVE * D])
                    ffut = fpool.submit(fetch, dfut)
                    pending.append((dfut, ffut))
                    if len(pending) > PIPELINE_DEPTH:
                        collect_wave(pending.popleft()[1].result())
                while pending:
                    collect_wave(pending.popleft()[1].result())
            finally:
                # after a failure: waves not yet started are dropped, the one
                # in flight runs to its end as the pools shut down
                for futs in pending:
                    for f in futs:
                        f.cancel()
        return out

    def _get_hits_many_multiproc(self, pages: list[np.ndarray], mesh, struct: bool, post) -> list:
        """The mesh path under several processes (focr_tpu/models/ncc.py:
        791-861): each process scatters a strided share of the corpus
        (pages[rank::P] for the owner of rank ``rank``) over its OWN slots,
        K3 replaying its hits exactly there; then the per-page hit ARRAYS —
        not device buffers — are all-gathered over gloo, so every process
        reconstructs the identical full ordered result. The lengths go first,
        then one u8 buffer padded to the longest (mesh.all_gather_bytes).

        Bit parity: each page is produced by exactly ONE process through the
        same scatter as the single-process path; the wire carries i32
        coordinates and raw f32 similarity bits, both lossless."""
        owners = mesh.owners
        if mesh.rank in owners:
            mine = pages[owners.index(mesh.rank) :: len(owners)]
            structs = self._scatter_waves(mine, mesh.local_slots, False, True, None) if mine else []
        else:
            structs = []
        payloads = mesh_mod.all_gather_bytes(_pack_hits_payload(structs))
        # parse each owner's payload once, then deal the pages back out in
        # global order (page g belongs to owner g % P, its g // P-th)
        per_proc = {p: _unpack_hits_payload(payloads[p]) for p in owners}
        out = []
        for g in range(len(pages)):
            nid, xs, ys, sims = per_proc[owners[g % len(owners)]][g // len(owners)]
            hits = (
                HitStruct(needle_id=nid, x=xs.astype(np.int64), y=ys.astype(np.int64),
                          sim=sims, matcher=self)
                if struct
                else [
                    MatchWithLetter(
                        self.needles[i].letter, int(x), int(y),
                        self.needles[i].pixels.shape[1], self.needles[i].pixels.shape[0],
                        float(s),
                    )
                    for i, x, y, s in zip(nid.tolist(), xs.tolist(), ys.tolist(), sims.tolist())
                ]
            )
            out.append(post(hits) if post is not None else hits)
        return out

    def _sweep_wave(self, batch: list[np.ndarray]) -> list[tuple]:
        """The device stage for one wave, start to end: _dispatch_wave, then
        _fetch_wave."""
        return self._fetch_wave(self._dispatch_wave(batch))

    def _dispatch_wave(
        self, batch: list[np.ndarray], slot=None, measure: dict | None = None,
    ) -> _Dispatched:
        """First half of the device stage for one wave: per page shape,
        invert, crop to the wave's ink bbox, upload once; per size group K1,
        K2's count kernel, one wait for the group's counts (they size its
        output), K2's emit kernel, K3's replay of the positions; then every
        group's hits are copied to one pinned host buffer without blocking
        and an event is recorded behind the copies. On a card all of it runs
        on the slot's stream (``slot``: a mesh slot, or None for the
        matcher's own device and side stream), with the slot's card as the
        current device. A wave with G
        swept groups waits G times here and once in _fetch_wave (HOST_WAITS).

        ``measure``: a dict; when given, the device is fenced after the
        upload and after every size group, and measure[(nh, nw)] accumulates
        the group's wall-clock seconds, the upload excluded from the first
        group's span (--verbose-sync; focr_tpu/models/ncc.py:945-1006)."""
        st = self._state(slot)
        cuda = st.device.type == "cuda"
        with (
            span("focr_ncc_dispatch_wave"),
            torch.cuda.device(st.device) if cuda else _NO_STREAM,
            torch.cuda.stream(st.stream) if cuda else _NO_STREAM,
            slot_scope(st.slot.index) if st.slot is not None else _NO_STREAM,
        ):
            return self._dispatch(batch, measure, st)

    def _dispatch(self, batch, measure, st: _SlotState) -> _Dispatched:
        cuda = st.device.type == "cuda"
        t0 = time.perf_counter()
        by_shape: dict[tuple[int, int], list[int]] = {}
        for i, p in enumerate(batch):
            by_shape.setdefault(p.shape, []).append(i)
        per_page: list = [None] * len(batch)
        swept: list[tuple] = []
        hits_dev: list[torch.Tensor] = []
        held: list[torch.Tensor] = []
        thr_f64 = float(np.float32(self.threshold))
        candidates = 0
        for (H, W), idxs in by_shape.items():
            inv = np.empty((len(idxs), H, W), np.uint8)
            for k, i in enumerate(idxs):
                p = batch[i]
                if p.dtype != np.uint8:  # tolerate wider dtypes (0..255 values)
                    p = p.astype(np.uint8)
                np.subtract(255, p, out=inv[k])
            crop = _ink_crop(inv, H, W, self.groups)
            plans: list[list] = [[] for _ in idxs]
            if crop is None or not any(g.nh < H and g.nw < W for g in self.groups):
                crop = (0, 0, H, W)
                for pp in plans:
                    pp.extend((g, "empty", None) for g in self.groups)
            else:
                y0, x0, Hc, Wc = crop
                cropped = inv[:, y0 : y0 + Hc, x0 : x0 + Wc]
                if cuda:
                    # the crop lands in a pinned buffer the wave holds until
                    # its event, and goes up without blocking this thread
                    stage = st.pinned.take(cropped.size)
                    held.append(stage)
                    staged = stage[: cropped.size].view(cropped.shape)
                    np.copyto(staged.numpy(), cropped)
                    inv_dev = staged.to(st.device, non_blocking=True)
                else:
                    inv_dev = torch.from_numpy(np.ascontiguousarray(cropped))
                if measure is not None and cuda:
                    torch.cuda.synchronize(st.device)  # the upload is not a group's time
                for grp, dg in zip(self.groups, st.dev_groups):
                    if grp.nh >= H or grp.nw >= W or grp.nh >= Hc or grp.nw >= Wc:
                        # past the page (reference semantics) or past the crop
                        # (a window overlapping ink cannot fit: Hc >= 2·nh + ink)
                        for pp in plans:
                            pp.append((grp, "empty", None))
                        continue
                    tg = time.perf_counter()
                    mask, rcnt = ncc_sweep(
                        inv_dev, dg.bank, dg.s_n, dg.s2_n, self.threshold, terms=dg.terms,
                        packed=dg.packed,
                    )
                    row_off, head = compact_counts(rcnt)
                    _count_host_wait()
                    off, hcnt, _ = (t.numpy() for t in split_counts(
                        to_host([head])[0], len(idxs), len(grp.needle_ids)))
                    total = int(off[-1])
                    candidates += total
                    pos = compact_emit(mask, rcnt, row_off, total)
                    del mask, rcnt, row_off  # free before the next group's sweep
                    d_off, d_hcnt, _ = split_counts(head, len(idxs), len(grp.needle_ids))
                    hits_dev.append(ncc_replay(inv_dev, pos, d_off, d_hcnt, dg.replay, thr_f64,
                                               y0, x0, MAX_MATCHES))
                    del pos
                    if measure is not None:
                        if cuda:
                            torch.cuda.synchronize(st.device)
                        key = (grp.nh, grp.nw)
                        measure[key] = measure.get(key, 0.0) + time.perf_counter() - tg
                    swept.append((plans, len(plans[0]), grp, off, hcnt, total))
                    for pp in plans:
                        pp.append(None)  # this group's place, filled by _fetch_wave
            for k, i in enumerate(idxs):
                per_page[i] = (batch[i], inv[k], plans[k], t0, crop)
        count("ncc_candidates", candidates)
        hits, event = hits_dev, None
        if swept and cuda:
            # each group's buffer at an 8-byte boundary of one pinned buffer
            at = np.cumsum([0] + [-(-h.numel() // 8) * 8 for h in hits_dev])
            buf = st.pinned.take(int(at[-1]))
            held.append(buf)
            hits = [buf[a : a + h.numel()] for a, h in zip(at.tolist(), hits_dev)]
            for dst, h in zip(hits, hits_dev):
                dst.copy_(h, non_blocking=True)
        if held:  # behind every copy that reads or writes a held buffer
            event = torch.cuda.Event()
            event.record()
        return _Dispatched(per_page, swept, hits, event, held, st.pinned)

    def _fetch_wave(self, disp: _Dispatched) -> list[tuple]:
        """Second half of the device stage: one wait for the wave's event
        (every group's hits are then on the host), the hits cut by page into
        the plans, the pinned buffers given back. Returns per page (page,
        inverted page, plan, start time, crop) with plan = [(group, "empty" |
        "sweep", (x i32, y i32, sim f32, counts i32 [T], warn u8 [T],
        candidates i32 [T]))]: K3's output for the page's candidates, needle
        t's hits at the sum of the candidates of the needles before it."""
        if disp.swept or disp.event is not None:
            _count_host_wait()
        if disp.event is not None:
            with span("focr_ncc_fetch_wave"):
                disp.event.synchronize()
        kept = 0
        for (plans, slot, grp, off, hcnt, total), h in zip(disp.swept, disp.hits):
            if disp.held:
                h = h.clone()  # out of the pinned buffer, which goes back to the pool
            x, y, sim, counts, warn = (v.numpy() for v in split_replay(
                h, total, len(plans), len(grp.needle_ids)))
            kept += int(counts.sum())
            for k, pp in enumerate(plans):
                a, b = off[k], off[k + 1]
                pp[slot] = (grp, "sweep", (x[a:b], y[a:b], sim[a:b], counts[k], warn[k], hcnt[k]))
        count("ncc_hits", kept)
        for buf in disp.held:
            disp.pool.give(buf)
        disp.held = []
        return disp.per_page

    def _collect_page(
        self, dispatched, verbose: bool, raw: bool, out, struct: bool = False,
        meas: dict | None = None,
    ):
        """One page's hits from K3's replay, assembled in reference order,
        with the reference's WARN lines and verbose and raw diagnostics.

        ``meas``: per-group measured wall seconds from a sync dispatch
        (--verbose-sync); None = the default, where per-group time is
        unobservable and the page span is attributed by search share."""
        page, _, plan, t_dispatch, _ = dispatched
        H, W = page.shape
        # device work and the fetch are one span per wave; attribute the page
        # span to groups by their share of searches
        page_elapsed = time.perf_counter() - t_dispatch
        total_searches = max(sum(len(g.needle_ids) for g in self.groups), 1)
        time_label = (
            "measured wall time, split evenly"
            if meas is not None
            else "estimated: page span attributed evenly"
        )

        per_needle: dict[int, tuple] = {}
        needle_s: dict[int, float] = {}  # attributed per-search seconds
        t00 = t_dispatch  # the reference's "overall" span starts at get_hits
        for grp, kind, data in plan:
            if kind == "empty":
                for i in grp.needle_ids:
                    per_needle[i] = _EMPTY
                    needle_s[i] = 0.0
                continue
            if meas is not None:
                elapsed = meas.get((grp.nh, grp.nw), 0.0)
            else:
                elapsed = page_elapsed * len(grp.needle_ids) / total_searches
            for i in grp.needle_ids:
                needle_s[i] = elapsed / max(len(grp.needle_ids), 1)
            self._group_hits(grp, data, per_needle)
            if verbose:
                per_search_ms = elapsed * 1000.0 / max(len(grp.needle_ids), 1)
                ns_per_px = elapsed * 1e9 / (W * H) / max(len(grp.needle_ids), 1)
                print(
                    f"[{self.device.type} group {grp.nw}x{grp.nh}] {len(grp.needle_ids)} "
                    f"searches ~{per_search_ms:.2f}ms each ({time_label}; "
                    f"{ns_per_px:.2f} ns/pixel)",
                    file=sys.stderr,
                )

        # assemble in reference iteration order (offsets outer, letters inner)
        parts: list[tuple[int, tuple]] = []
        n_hits = 0
        for i, nd in enumerate(self.needles):
            arrs = per_needle.get(i, _EMPTY)
            if verbose:
                # per-search line in the reference's format (ncc.rs:657-666),
                # with the page span attributed evenly across searches
                s = needle_s.get(i, 0.0)
                print(
                    f"`{nd.letter}` [{_f32_debug(nd.offset[0])}, {_f32_debug(nd.offset[1])}] "
                    f"needle size {nd.pixels.shape[1]}x{nd.pixels.shape[0]} hits {len(arrs[0])} "
                    f"elapsed {int(s * 1000)}ms ({s * 1e9 / (W * H):.2f} ns/pixel)",
                    file=sys.stderr,
                )
            if raw and out is not None:
                self._print_raw(nd, self._needle_objects(i, arrs), out)
            parts.append((i, arrs))
            n_hits += len(arrs[0])
        if verbose:
            print(f"overall {(time.perf_counter() - t00) * 1000.0:.4f}ms", file=sys.stderr)
            print(f"hits: {n_hits}", file=sys.stderr)
            _print_count_table(
                (self.needles[i].letter, len(arrs[0])) for i, arrs in parts
            )
        if struct:
            return self._make_struct(parts)
        all_hits: list[MatchWithLetter] = []
        for i, arrs in parts:
            all_hits.extend(self._needle_objects(i, arrs))
        return all_hits

    def _group_hits(self, grp, data, per_needle) -> None:
        """One swept size group of one page: each needle's hits from K3's
        output, filled in as focr_tpu fills them from its host replay
        (models/ncc.py:1463-1488), WARN line included."""
        out_x, out_y, out_sim, counts, warn, hcnt = data
        starts = np.cumsum(hcnt, dtype=np.int64) - hcnt
        for ti, i in enumerate(grp.needle_ids):
            if warn[ti]:
                print(f"WARN got >= {MAX_MATCHES} matches", file=sys.stderr)
            off = int(starts[ti])
            k = int(counts[ti])
            # i32 views: _make_struct widens once after concatenation
            per_needle[i] = (out_x[off : off + k], out_y[off : off + k], out_sim[off : off + k])

    def _needle_objects(self, i: int, arrs: tuple) -> list[MatchWithLetter]:
        nd = self.needles[i]
        nh, nw = nd.pixels.shape
        return [
            MatchWithLetter(nd.letter, int(x), int(y), nw, nh, float(s))
            for x, y, s in zip(*arrs)
        ]

    def _make_struct(self, parts: list[tuple[int, tuple]]) -> HitStruct:
        sizes = [len(arrs[0]) for _, arrs in parts]
        total = sum(sizes)
        nid = np.repeat(
            np.array([i for i, _ in parts], dtype=np.int32),
            np.array(sizes, dtype=np.int64),
        )
        if total:
            xs = np.concatenate([arrs[0] for _, arrs in parts]).astype(np.int64)
            ys = np.concatenate([arrs[1] for _, arrs in parts]).astype(np.int64)
            sims = np.concatenate([arrs[2] for _, arrs in parts]).astype(np.float32)
        else:
            xs = np.zeros(0, np.int64)
            ys = np.zeros(0, np.int64)
            sims = np.zeros(0, np.float32)
        return HitStruct(needle_id=nid, x=xs, y=ys, sim=sims, matcher=self)

    def get_hits_native(
        self, page: np.ndarray, verbose: bool = False, raw: bool = False, out=None
    ) -> list[MatchWithLetter]:
        """All-host tier (``--engine native``, focr_tpu/models/ncc.py:
        1509-1565): the C++ search sweeps each size group's whole needle bank,
        OpenMP-parallel across needles (the reference's default C path and
        rayon fan-out). Same results as the device and oracle paths."""
        searcher = ncc_cpu.NativeSearcher(page)
        H, W = page.shape
        per_needle: dict[int, list[MatchWithLetter]] = {}
        needle_s: dict[int, float] = {}  # measured group time, split evenly
        t00 = time.perf_counter()
        for grp in self.groups:
            if grp.nh >= H or grp.nw >= W:
                for i in grp.needle_ids:
                    per_needle[i] = []
                continue
            t0 = time.perf_counter()
            results = searcher.search_many(grp.bank, self.threshold)
            elapsed = time.perf_counter() - t0
            for ti, i in enumerate(grp.needle_ids):
                nd = self.needles[i]
                needle_s[i] = elapsed / max(len(grp.needle_ids), 1)
                per_needle[i] = [
                    MatchWithLetter(nd.letter, m.x, m.y, m.w, m.h, m.similarity)
                    for m in results[ti]
                ]
            if verbose:
                per_search_ms = elapsed * 1000.0 / max(len(grp.needle_ids), 1)
                ns_per_px = elapsed * 1e9 / (W * H) / max(len(grp.needle_ids), 1)
                print(
                    f"[native group {grp.nw}x{grp.nh}] {len(grp.needle_ids)} searches "
                    f"~{per_search_ms:.2f}ms each (group-measured average; "
                    f"{ns_per_px:.2f} ns/pixel)",
                    file=sys.stderr,
                )
        all_hits: list[MatchWithLetter] = []
        for i, nd in enumerate(self.needles):
            hits = per_needle.get(i, [])
            if verbose:
                s = needle_s.get(i, 0.0)
                print(
                    f"`{nd.letter}` [{_f32_debug(nd.offset[0])}, {_f32_debug(nd.offset[1])}] "
                    f"needle size {nd.pixels.shape[1]}x{nd.pixels.shape[0]} hits {len(hits)} "
                    f"elapsed {int(s * 1000)}ms ({s * 1e9 / (W * H):.2f} ns/pixel)",
                    file=sys.stderr,
                )
            if raw and out is not None:
                self._print_raw(nd, hits, out)
            all_hits.extend(hits)
        if verbose:
            print(f"overall {(time.perf_counter() - t00) * 1000.0:.4f}ms", file=sys.stderr)
            print(f"hits: {len(all_hits)}", file=sys.stderr)
            _print_count_table((h.letter, 1) for h in all_hits)
        return all_hits

    def get_hits_oracle(
        self, page: np.ndarray, verbose: bool = False, raw: bool = False, out=None
    ) -> list[MatchWithLetter]:
        """Host-only differential-oracle path (the reference's --rust flag,
        ncc.rs:532-533, 651-655): NumPy Searcher per needle, same results."""
        from focr_tpu_torch.oracle.ncc_oracle import Searcher

        t00 = time.perf_counter()
        searcher = Searcher(page)
        all_hits: list[MatchWithLetter] = []
        for nd in self.needles:
            nh, nw = nd.pixels.shape
            H, W = page.shape
            if nh >= H or nw >= W:
                hits: list[MatchWithLetter] = []
            else:
                t0 = time.perf_counter()
                ms = searcher.search(nd.pixels, self.threshold)
                elapsed = time.perf_counter() - t0
                hits = [
                    MatchWithLetter(nd.letter, m.x, m.y, m.w, m.h, m.similarity) for m in ms
                ]
                if verbose:
                    print(
                        f"`{nd.letter}` [{_f32_debug(nd.offset[0])}, {_f32_debug(nd.offset[1])}] "
                        f"needle size {nw}x{nh} hits {len(hits)} elapsed "
                        f"{int(elapsed * 1000)}ms ({elapsed * 1e9 / (W * H):.2f} ns/pixel)",
                        file=sys.stderr,
                    )
            if raw and out is not None:
                self._print_raw(nd, hits, out)
            all_hits.extend(hits)
        if verbose:
            print(f"overall {(time.perf_counter() - t00) * 1000.0:.4f}ms", file=sys.stderr)
            print(f"hits: {len(all_hits)}", file=sys.stderr)
            _print_count_table((h.letter, 1) for h in all_hits)
        return all_hits

    def _print_raw(self, nd: Needle, hits: list[MatchWithLetter], out) -> None:
        """The 11-field --raw CSV per hit (ncc.rs:683-698)."""
        m = self.face.metrics
        to_px = np.float32(1.0) / np.float32(m.units_per_em) * np.float32(self.ropts.size)
        gid = self.face.glyph_for_char(nd.letter)
        tb = self.face.typographic_bounds(gid).scale(float(to_px))
        bearing_x = np.float32(tb.x0)
        for h in hits:
            cx, cy = h.center
            print(
                f"{ord(nd.letter)},{_f32(cx)},{_f32(cy)},{h.x},{h.y},{h.w},{h.h},"
                f"{_f32(bearing_x)},{_f32(nd.corrected_offset[1])},"
                f"{_f32(nd.offset[0])},{_f32(nd.offset[1])}",
                file=out,
            )


def _print_count_table(letter_counts) -> None:
    """Per-char totals, sorted by (count, char), zeros skipped
    (ncc.rs:709-718)."""
    counts: dict[str, int] = {}
    for letter, k in letter_counts:
        if k:
            counts[letter] = counts.get(letter, 0) + k
    for letter, count in sorted(counts.items(), key=lambda kv: (kv[1], kv[0])):
        print(f"`{letter}` {count}", file=sys.stderr)


def _f32(v) -> str:
    """Rust `{}` Display for f32: shortest round-trip, no trailing .0."""
    return np.format_float_positional(np.float32(v), unique=True, trim="-")


def _f32_debug(v) -> str:
    """Rust `{:?}` Debug for f32: shortest round-trip, keeps one decimal."""
    return np.format_float_positional(np.float32(v), unique=True, trim="0")
