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
(``ssd_argmin_partial``) is K4 on a slice of the glyphs that also returns the
minimum it found: the same two kernels with one more output. K6
(``first_min_combine``, the same source) takes every shard's partial and
picks the first minimum over shards. Each has its plain version here
(``ssd_argmin_partial_reference``, ``first_min_combine_reference``), used by
the CPU path and the tests and by nothing on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from focr_tpu_torch.ops.ssd import argmin_glyph, check_window, extract_windows, ssd_metric
from focr_tpu_torch.utils.device import count_launch, launch_stream

LAUNCHES = {"ssd_argmin": 0, "ssd_argmin_partial": 0, "ssd_combine": 0}
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


def ssd_argmin_partial_reference(
    strips: torch.Tensor, templates: torch.Tensor, tsq: torch.Tensor, wx0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K4p, on the tensors' device: ssd_argmin_reference on a slice of
    the glyphs that also gives the minimum — (ids int32 [B, R, C], local to
    the slice; val int64 [B, R, C], the metric tsq − 2·corr at that id; white
    bool [B, R]). ssd_metric, then argmin_glyph, then a gather, as
    focr_tpu/parallel/decode.py:71-73."""
    _shapes(strips, templates, tsq, wx0)
    inv = 255 - strips.to(torch.int32)
    white = inv.amax(dim=(2, 3)) == 0
    metric = ssd_metric(extract_windows(inv, wx0.cpu().numpy(), templates.shape[3]), templates,
                        tsq)
    ids = argmin_glyph(metric)
    val = metric.gather(-1, ids.to(torch.int64)[..., None])[..., 0]
    return ids, val, white


def first_min_combine_reference(
    vals: torch.Tensor, ids: torch.Tensor, shard_glyphs: int,
) -> torch.Tensor:
    """Plain K6, on the tensors' device: vals int64 [n_g, ...] and ids int32
    [n_g, ...], shard s's partial minimum and its glyph, local to the shard's
    slice of ``shard_glyphs`` glyphs -> int32 [...]: the bank's id (local +
    s·shard_glyphs, focr_tpu/parallel/decode.py:74-76) of the smallest val,
    the lowest shard among equal ones (:78-79). The rule is written out (the
    lowest shard index whose val equals the minimum) rather than left to
    argmin's choice among ties."""
    n_g = vals.shape[0]
    lowest = vals.min(dim=0, keepdim=True).values
    shard = torch.arange(n_g, device=vals.device).view(-1, *[1] * (vals.dim() - 1))
    first = torch.where(vals == lowest, shard, n_g).min(dim=0, keepdim=True).values
    return (ids.gather(0, first) + first * shard_glyphs)[0].to(torch.int32)


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


def _launch(strips, templates, tsq, wx0, bfrag, partial: bool):
    """Check the card's inputs and launch csrc/focr_ssd.cu::focr_ssd_argmin,
    with the val output when ``partial``. Returns (ids, val or None, white);
    counts the launch under the wrapper's own name."""
    name = "ssd_argmin_partial" if partial else "ssd_argmin"
    if strips.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {strips.device}")
    B, R, h, crop_w, C, G, win_w = _shapes(strips, templates, tsq, wx0)
    for label, t, dt in (
        ("strips", strips, torch.uint8), ("templates", templates, torch.uint8),
        ("tsq", tsq, torch.int64), ("wx0", wx0, torch.int32),
    ):
        if t.dtype != dt or not t.is_contiguous() or t.device != strips.device:
            raise ValueError(f"{name}: {label} must be contiguous {dt} on {strips.device}")
    ids = torch.empty((B, R, C), dtype=torch.int32, device=strips.device)
    val = torch.empty((B, R, C), dtype=torch.int64, device=strips.device) if partial else None
    white = torch.empty((B, R), dtype=torch.bool, device=strips.device)
    if B * R == 0 or C == 0:
        return ids, val, white
    instance, nks, _ = ssd_plan(h, crop_w, win_w)
    if instance == "mma":
        if bfrag is None:
            bfrag = pack_template_fragments(templates)
        if tuple(bfrag.shape) != (C, -(-G // 8), nks, 32, 2) or (
            bfrag.dtype != torch.int32 or not bfrag.is_contiguous()
            or bfrag.device != strips.device
        ):
            raise ValueError(f"{name}: bfrag must be pack_template_fragments(templates)")
    from focr_tpu_torch.native.build import load

    with launch_stream(strips) as stream:
        rc = load().focr_ssd_argmin(
            strips.data_ptr(), B * R, h, crop_w,
            templates.data_ptr(), bfrag.data_ptr() if instance == "mma" else None,
            tsq.data_ptr(), wx0.data_ptr(), C, G, win_w,
            ids.data_ptr(), white.data_ptr(), val.data_ptr() if partial else None, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)
    return ids, val, white


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
    ids, _, white = _launch(strips, templates, tsq, wx0, bfrag, partial=False)
    return ids, white


def ssd_argmin_partial(
    strips: torch.Tensor, templates: torch.Tensor, tsq: torch.Tensor, wx0: torch.Tensor,
    bfrag: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4p (csrc/focr_ssd.cu, the val output) for CUDA tensors,
    ssd_argmin_partial_reference for CPU tensors: ssd_argmin on a glyph
    shard's slice of the templates and tsq (and its own bfrag), which also
    returns val int64 [B, R, C], the minimum at each id."""
    if strips.device.type == "cpu":
        return ssd_argmin_partial_reference(strips, templates, tsq, wx0)
    return _launch(strips, templates, tsq, wx0, bfrag, partial=True)


def first_min_combine(vals: torch.Tensor, ids: torch.Tensor, shard_glyphs: int) -> torch.Tensor:
    """K6 (csrc/focr_ssd.cu::focr_ssd_combine) for CUDA tensors,
    first_min_combine_reference for CPU tensors. vals int64 [n_g, ...] and
    ids int32 [n_g, ...] (K4p's, local to each shard's slice of
    ``shard_glyphs`` glyphs), contiguous on one device, 1 <= n_g <= 8 ->
    int32 [...]: the bank's id (local + shard·shard_glyphs) of the smallest
    val, the lowest shard on ties."""
    if vals.shape != ids.shape or vals.dim() < 1 or not 1 <= vals.shape[0] <= 8:
        raise ValueError(f"first_min_combine: vals {tuple(vals.shape)} and ids "
                         f"{tuple(ids.shape)} must be one shape [n_g <= 8, ...]")
    if vals.device.type == "cpu":
        return first_min_combine_reference(vals, ids, shard_glyphs)
    if vals.device.type != "cuda":
        raise ValueError(f"first_min_combine: unsupported device {vals.device}")
    for label, t, dt in (("vals", vals, torch.int64), ("ids", ids, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != vals.device:
            raise ValueError(f"first_min_combine: {label} must be contiguous {dt} on "
                             f"{vals.device}")
    out = torch.empty(vals.shape[1:], dtype=torch.int32, device=vals.device)
    if out.numel() == 0:
        return out
    from focr_tpu_torch.native.build import load

    with launch_stream(vals) as stream:
        rc = load().focr_ssd_combine(vals.data_ptr(), ids.data_ptr(), vals.shape[0],
                                     out.numel(), shard_glyphs, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"first_min_combine kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "ssd_combine")
    return out
