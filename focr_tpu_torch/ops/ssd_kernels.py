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

Two more wrappers serve the glyph axis of a mesh (parallel/decode.py), the
counterpart of focr_tpu/parallel/decode.py:65-80. K4p
(``ssd_argmin_partial``) is K4 on a glyph shard's slice of the bank: the same
two kernels' PARTIAL instances, which write one packed int64 key a cell
(``pack_key``: the minimum metric above the bank's glyph number, so the
smallest key is the first minimum) and white flags only when asked (the
first shard). A shard's bank is checked once (``shard_bank``, a
``ShardBank``); a call checks only the strips. K6 (``first_min_combine``, the
same source) reads every shard's keys where they lie and writes the smallest
key's glyph; over more than MAX_SHARDS shards its fold pass first writes the
smallest key of each group of up to MAX_SHARDS (``fold_plan``). Each has its
plain version here (``ssd_argmin_partial_reference``,
``first_min_combine_reference``), used by the CPU path and the tests and by
nothing on a card.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from focr_tpu_torch.ops.ssd import argmin_glyph, check_window, extract_windows, ssd_metric
from focr_tpu_torch.utils.device import count_launch, launch_stream

# "ssd_combine_fold": K6's fold launches, over more than MAX_SHARDS shards
LAUNCHES = {"ssd_argmin": 0, "ssd_argmin_partial": 0, "ssd_combine": 0, "ssd_combine_fold": 0}
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
    for label, t, dt in (
        ("strips", strips, torch.uint8), ("templates", templates, torch.uint8),
        ("tsq", tsq, torch.int64), ("wx0", wx0, torch.int32),
    ):
        if t.dtype != dt or not t.is_contiguous() or t.device != strips.device:
            raise ValueError(f"ssd_argmin: {label} must be contiguous {dt} on {strips.device}")
    ids = torch.empty((B, R, C), dtype=torch.int32, device=strips.device)
    white = torch.empty((B, R), dtype=torch.bool, device=strips.device)
    if B * R == 0 or C == 0:
        return ids, white
    instance, nks, _ = ssd_plan(h, crop_w, win_w)
    if instance == "mma":
        if bfrag is None:
            bfrag = pack_template_fragments(templates)
        _check_bfrag("ssd_argmin", bfrag, C, G, nks, strips.device)
    from focr_tpu_torch.native.build import load

    with launch_stream(strips) as stream:
        rc = load().focr_ssd_argmin(
            strips.data_ptr(), B * R, h, crop_w,
            templates.data_ptr(), bfrag.data_ptr() if instance == "mma" else None,
            tsq.data_ptr(), wx0.data_ptr(), C, G, win_w, ids.data_ptr(), white.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_argmin kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "ssd_argmin")
    return ids, white


def _check_bfrag(name: str, bfrag: torch.Tensor, C: int, G: int, nks: int, device) -> None:
    if tuple(bfrag.shape) != (C, -(-G // 8), nks, 32, 2) or (
        bfrag.dtype != torch.int32 or not bfrag.is_contiguous() or bfrag.device != device
    ):
        raise ValueError(f"{name}: bfrag must be pack_template_fragments(templates)")


# --- the glyph axis of a mesh: K4p and K6 -------------------------------------

# the packed key of a cell's first minimum over a shard's glyphs (csrc/
# focr_ssd.cu mirrors both constants): ((metric + KEY_BIAS) << KEY_SHIFT) | gid
KEY_SHIFT = 28
KEY_BIAS = 1 << 34
GID_LIMIT = 1 << KEY_SHIFT  # a bank glyph number must lie below it
MAX_SHARDS = 8  # the key tensors K6's last pass takes (csrc/focr_ssd.cu's MAX_SHARDS)
FOLD_PTRS = 64  # the key tensors a launch of its fold pass takes (FOLD_PTRS there)
# the cells (warps) of a K4p mma block: the fastest on a slot's 8-page block
# of the focr corpus at 2 and 4 glyph shards (tools/torch_cli_profile.py
# ssd-partial-blocks sweeps 1 to MAX_PARTIAL_WARPS, csrc/focr_ssd.cu's
# PMAXW); any count gives the same keys
PARTIAL_WARPS = 16
MAX_PARTIAL_WARPS = 16


def pack_key(metric, gid):
    """The packed key of (metric, bank glyph): a non-negative int64 whose
    order is the metric's, then the glyph's, so the smallest key is the
    first minimum (the reference's min_by_key, main.rs:159, and the argmin
    over ascending shards, focr_tpu/parallel/decode.py:78). check_window
    bounds n <= 74565, so metric = tsq - 2·corr lies in (-2^34, 2^33) and
    metric + KEY_BIAS in [0, 2^35); gid must lie in [0, GID_LIMIT). Works on
    ints, numpy and torch int64 alike."""
    return ((metric + KEY_BIAS) << KEY_SHIFT) | gid


def unpack_key(key):
    """(metric, gid) of pack_key's keys."""
    return (key >> KEY_SHIFT) - KEY_BIAS, key & (GID_LIMIT - 1)


def ssd_argmin_partial_reference(
    strips: torch.Tensor, templates: torch.Tensor, tsq: torch.Tensor, wx0: torch.Tensor,
    g0: int = 0, white: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain K4p, on the tensors' device: on a glyph shard's slice of the
    templates and tsq, whose first glyph is the bank's ``g0``, the packed key
    of each cell's first minimum — key int64 [B, R, C] — and, when
    ``white``, the white flags bool [B, R] (else None). ssd_metric, then
    argmin_glyph and the metric at that id (focr_tpu/parallel/decode.py:
    71-73), then pack_key with the bank's glyph number (:74)."""
    _shapes(strips, templates, tsq, wx0)
    inv = 255 - strips.to(torch.int32)
    metric = ssd_metric(extract_windows(inv, wx0.cpu().numpy(), templates.shape[3]), templates,
                        tsq)
    ids = argmin_glyph(metric).to(torch.int64)
    val = metric.gather(-1, ids[..., None])[..., 0]
    return pack_key(val, ids + g0), (inv.amax(dim=(2, 3)) == 0) if white else None


def first_min_combine_reference(keys) -> torch.Tensor:
    """Plain K6, on the tensors' device: every shard's keys (int64, one
    shape) -> int32: the bank's glyph of the smallest key, which is the
    first minimum over the shards (focr_tpu/parallel/decode.py:75-79)."""
    return unpack_key(torch.stack(list(keys)).amin(dim=0))[1].to(torch.int32)


def fold_plan(n_g: int) -> list[list[tuple[int, int]]]:
    """K6's fold passes over ``n_g`` key tensors (none for n_g <= MAX_SHARDS):
    a level a list, each launch (first key, keys) over the level's key list,
    FOLD_PTRS keys at most. A launch writes one row a group of MAX_SHARDS
    consecutive keys, ceil(keys / MAX_SHARDS) rows, and the level's rows in
    launch order are the next level's keys; the levels end when at most
    MAX_SHARDS keys remain, which K6's last pass takes."""
    levels = []
    while n_g > MAX_SHARDS:
        levels.append([(k, min(FOLD_PTRS, n_g - k)) for k in range(0, n_g, FOLD_PTRS)])
        n_g = -(-n_g // MAX_SHARDS)
    return levels


def partial_pitch(wx0: np.ndarray, crop_w: int, h: int, win_w: int, warps: int) -> int:
    """K4p's plan (csrc/focr_ssd.cu::focr_ssd_partial) for blocks of
    ``warps`` cells: the staged row pitch of its mma instance — the widest
    column window of any block, from its first cell's 16-byte piece to 4
    bytes past its last cell's window words, a multiple of 16 — or 0 for the
    int64 instance (a metric that may pass 32 bits, 2·n·65025 ≥ 2³¹, which
    the lanes keep in 32 bits; or 16 strips' windows that do not fit in
    shared memory beside the k-word table, as they never do for such n)."""
    nw4 = -(-win_w // 4)
    if 2 * h * win_w * 65025 >= 2**31:  # the lanes keep the metric in 32 bits
        return 0
    x = np.clip(np.asarray(wx0, np.int64), 0, crop_w)
    n = -(-len(x) // warps) * warps
    lo = np.pad(x, (0, n - len(x)), constant_values=crop_w).reshape(-1, warps).min(axis=1)
    hi = np.pad(x, (0, n - len(x)), constant_values=0).reshape(-1, warps).max(axis=1)
    need = int(((hi & ~3) + 4 * nw4 + 4 - (lo & ~15)).max())
    pitch = -(-need // 16) * 16
    fits = k_steps(h, win_w) * 8 * 4 + MMA_STRIPS * h * pitch <= SMEM_MAX
    return pitch if fits else 0


class _ShardArgs(ctypes.Structure):
    """csrc/focr_ssd.cu's FocrSsdShard."""

    _fields_ = [("tmpl", ctypes.c_void_p), ("bfrag", ctypes.c_void_p), ("tsq", ctypes.c_void_p),
                ("wx0", ctypes.c_void_p), ("h", ctypes.c_int), ("crop_w", ctypes.c_int),
                ("C", ctypes.c_int), ("G", ctypes.c_int), ("win_w", ctypes.c_int),
                ("g0", ctypes.c_int)]


@dataclass(frozen=True, eq=False)
class ShardBank:
    """One glyph shard's bank as K4p takes it, checked once (``shard_bank``):
    templates u8 [C, G, h, win_w], tsq int64 [C, G], wx0 int32 [C], bfrag
    (the mma instance's packed templates, or None), on one device; g0, the
    bank's number of its first glyph; on a card the launcher's argument
    block; what a call compares the strips with; and the window starts on
    the host, for ``pitch``."""

    templates: torch.Tensor
    tsq: torch.Tensor
    wx0: torch.Tensor
    bfrag: torch.Tensor | None
    g0: int
    args: _ShardArgs | None  # a card only
    addr: int  # the argument block's address (0 off a card)
    n_cells: int
    strip_shape: tuple[int, int]  # (h, crop_w): the strips' last two dimensions
    device_index: int  # the templates' card (get_device()), -1 off a card
    wx0_host: np.ndarray
    _pitches: dict[int, int] = field(default_factory=dict)

    def pitch(self, warps: int) -> int:
        """partial_pitch for blocks of ``warps`` cells, worked out at its
        first use (a decoder builds a bank a slot and a row group)."""
        p = self._pitches.get(warps)
        if p is None:
            h, crop_w = self.strip_shape
            p = self._pitches[warps] = partial_pitch(self.wx0_host, crop_w, h,
                                                     self.templates.shape[3], warps)
        return p


def shard_bank(
    templates: torch.Tensor, tsq: torch.Tensor, wx0: torch.Tensor, crop_w: int, g0: int = 0,
    bfrag: torch.Tensor | None = None,
) -> ShardBank:
    """Check a glyph shard's bank for K4p once (where the mesh step is
    built): raises ValueError on a wrong type, shape, layout or device, a
    window past check_window's bound, a negative window start, or glyph
    numbers g0 .. g0+G-1 past GID_LIMIT. ``bfrag``: pack_template_fragments
    (templates) when the caller has it; packed here when the mma instance
    needs it and none is given."""
    if templates.dim() != 4:
        raise ValueError("ssd_argmin_partial: templates [C, G, h, win_w] expected")
    C, G, h, win_w = templates.shape
    if C == 0 or G == 0:
        raise ValueError("ssd_argmin_partial: a shard without cells or glyphs")
    check_window(h * win_w)
    for label, t, dt, shape in (("templates", templates, torch.uint8, None),
                                ("tsq", tsq, torch.int64, (C, G)),
                                ("wx0", wx0, torch.int32, (C,))):
        if t.dtype != dt or not t.is_contiguous() or t.device != templates.device or (
                shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"ssd_argmin_partial: {label} must be contiguous {dt}"
                             f"{list(shape) if shape else ''} on {templates.device}")
    wx0_h = wx0.cpu().numpy()
    if (wx0_h < 0).any():
        raise ValueError("ssd_argmin_partial: window starts must be >= 0")
    if g0 < 0 or g0 + G > GID_LIMIT:
        raise ValueError(f"ssd_argmin_partial: glyphs {g0}..{g0 + G - 1} do not fit below "
                         f"2^{KEY_SHIFT}")
    # the mma instance can run at some block size iff it runs at one cell a
    # block, whose windows are the narrowest
    mma = partial_pitch(wx0_h, crop_w, h, win_w, 1) > 0
    args = None
    if templates.device.type == "cuda":
        if mma:
            if bfrag is None:
                bfrag = pack_template_fragments(templates)
            _check_bfrag("ssd_argmin_partial", bfrag, C, G, k_steps(h, win_w), templates.device)
        args = _ShardArgs(templates.data_ptr(), bfrag.data_ptr() if mma else None,
                          tsq.data_ptr(), wx0.data_ptr(), h, crop_w, C, G, win_w, g0)
    return ShardBank(templates, tsq, wx0, bfrag, g0, args,
                     ctypes.addressof(args) if args is not None else 0, C, (h, crop_w),
                     templates.get_device(), wx0_h)


_KeyPointers = ctypes.c_void_p * MAX_SHARDS  # K6's key pointers, as its launcher takes them
_FoldPointers = ctypes.c_void_p * FOLD_PTRS  # and its fold launcher's (the first n_k read)
_partial_launcher = None  # the library's focr_ssd_partial, bound at the first launch
_combine_launcher = None  # and its focr_ssd_combine
_fold_launcher = None  # and its focr_ssd_fold


def ssd_argmin_partial(
    strips: torch.Tensor, shard: ShardBank, white: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K4p (csrc/focr_ssd.cu::focr_ssd_partial) for CUDA tensors,
    ssd_argmin_partial_reference for CPU tensors: strips u8 [B, R, h,
    crop_w] against a glyph shard's bank -> (key int64 [B, R, C], white bool
    [B, R] when ``white``, else None). A call checks only the strips; one
    launch on the current stream, with no wait."""
    global _partial_launcher
    if strips.device.type == "cpu":
        return ssd_argmin_partial_reference(strips, shard.templates, shard.tsq, shard.wx0,
                                            shard.g0, white)
    if strips.device.type != "cuda":
        raise ValueError(f"ssd_argmin_partial: unsupported device {strips.device}")
    if (strips.dtype != torch.uint8 or strips.dim() != 4 or not strips.is_contiguous()
            or strips.shape[2:] != shard.strip_shape
            or strips.get_device() != shard.device_index):
        raise ValueError(f"ssd_argmin_partial: strips must be a contiguous uint8 [B, R, "
                         f"{', '.join(map(str, shard.strip_shape))}] on {shard.templates.device}")
    B, R = strips.shape[:2]
    key = torch.empty((B, R, shard.n_cells), dtype=torch.int64, device=strips.device)
    wt = torch.empty((B, R), dtype=torch.bool, device=strips.device) if white else None
    if B * R:
        if _partial_launcher is None:
            from focr_tpu_torch.native.build import load

            _partial_launcher = load().focr_ssd_partial
        with launch_stream(strips) as stream:
            rc = _partial_launcher(strips.data_ptr(), B * R, shard.addr, PARTIAL_WARPS,
                                   shard.pitch(PARTIAL_WARPS), key.data_ptr(),
                                   wt.data_ptr() if white else None, stream)
        if rc != 0:
            raise RuntimeError(f"ssd_argmin_partial kernel launch failed: CUDA error {rc}")
        count_launch(LAUNCHES, "ssd_argmin_partial")
    return key, wt


def first_min_combine(keys) -> torch.Tensor:
    """K6 (csrc/focr_ssd.cu::focr_ssd_combine) for CUDA tensors,
    first_min_combine_reference for CPU tensors: key tensors (K4p's, int64,
    one shape, contiguous, on one device), any number of them, read where
    they lie -> int32: the bank's glyph of the smallest key, the first
    minimum over the shards. Over more than MAX_SHARDS shards the fold pass
    (csrc/focr_ssd.cu::focr_ssd_fold, fold_plan's launches) writes the
    groups' smallest keys to a scratch tensor first."""
    global _combine_launcher, _fold_launcher
    first = keys[0] if keys else None
    if first is None or any(k.shape != first.shape for k in keys):
        raise ValueError(f"first_min_combine: key tensors of one shape expected, got "
                         f"{[tuple(k.shape) for k in keys]}")
    dev = first.get_device()
    if dev < 0:
        if first.device.type == "cpu":
            return first_min_combine_reference(keys)
        raise ValueError(f"first_min_combine: unsupported device {first.device}")
    for k in keys:
        if k.dtype != torch.int64 or not k.is_contiguous() or k.get_device() != dev:
            raise ValueError(f"first_min_combine: keys must be contiguous int64 on "
                             f"{first.device}")
    out = torch.empty(first.shape, dtype=torch.int32, device=first.device)
    n = out.numel()
    if n:
        if _combine_launcher is None:
            from focr_tpu_torch.native.build import load

            lib = load()
            _combine_launcher, _fold_launcher = lib.focr_ssd_combine, lib.focr_ssd_fold
        ptrs = [k.data_ptr() for k in keys]
        with launch_stream(first) as stream:
            if len(ptrs) > MAX_SHARDS:
                scratch = torch.empty((_fold_rows(len(ptrs)), n), dtype=torch.int64,
                                      device=first.device)
                ptrs = _fold(ptrs, n, scratch.data_ptr(), stream)
            rc = _combine_launcher(_KeyPointers(*ptrs), len(ptrs), n, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"first_min_combine kernel launch failed: CUDA error {rc}")
        count_launch(LAUNCHES, "ssd_combine")
    return out


def _fold_rows(n_g: int) -> int:
    """The scratch rows fold_plan's launches write over n_g key tensors."""
    return sum(-(-cnt // MAX_SHARDS) for level in fold_plan(n_g) for _, cnt in level)


def _fold(ptrs: list[int], n: int, row: int, stream: int) -> list[int]:
    """K6's fold launches (fold_plan) over the keys at ``ptrs``, n int64
    each, into the scratch rows from address ``row`` on: the addresses of
    the at most MAX_SHARDS rows left for the last pass."""
    for level in fold_plan(len(ptrs)):
        nxt = []
        for k0, cnt in level:
            rc = _fold_launcher(_FoldPointers(*ptrs[k0 : k0 + cnt]), cnt, n, row, stream)
            if rc != 0:
                raise RuntimeError(f"first_min_combine fold launch failed: CUDA error {rc}")
            count_launch(LAUNCHES, "ssd_combine_fold")
            for _ in range(-(-cnt // MAX_SHARDS)):  # a row a group
                nxt.append(row)
                row += 8 * n
        ptrs = nxt
    return ptrs
