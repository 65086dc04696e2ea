"""The proportional focr decoder's device scan: K5 (prop_scan), a hand-written
CUDA kernel (csrc/focr_prop.cu) beside its plain PyTorch version.

Counterpart of focr_tpu/models/focr_prop.py::make_prop_forward (:49-160), the
lax.scan of the greedy cursor decode. For every line it repeats one step
until the cursor passes the line's width or ``n_steps`` is reached:

    s    = ox + pos                         (f32, the oracle's op order)
    t64  = floor(s·64 + 0.5)                (FreeType's 26.6 rounding)
    k, p = t64 >> 6, t64 & 63               (window column, subpixel phase)
    acc  = Σ window(k) · templates[g, p]    (exact integers)
    tsq  = colsq_cum[g, p, thi] − colsq_cum[g, p, tlo]   (‖T‖² clipped to
           the canvas: tlo = clip(base − k, 0, wbank), thi = clip(crop_w − k
           + base, 0, wbank))
    g    = first argmin_g (tsq − 2·acc)     (Rust min_by_key, main.rs:159)
    pos += adv[g]                           (f32)

The window is the strip's columns [k − base, k − base + wbank), reading 0
outside [0, crop_w). Steps past the end write END_ID. focr_tpu correlates
every window with all G·64 phase templates and then picks the phase; both
versions here correlate only with the G templates of the line's own phase.

The wrapper ``prop_scan`` runs the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA card; there is no fallback between
the two. It counts its kernel launches in ``LAUNCHES``.
"""

from __future__ import annotations

import numpy as np
import torch

from focr_tpu_torch.ops.ssd import argmin_glyph
from focr_tpu_torch.utils.device import count_launch, launch_stream

END_ID = 255  # u8 sentinel: the cursor passed the width bound
PHASES = 64
LAUNCHES = {"prop_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_bank(n_glyphs: int, window: int) -> None:
    """focr_tpu's bounds on a proportional bank (focr_prop.py:79, :84-86):
    glyph ids travel as u8 below the sentinel, and the int32 score
    tsq − 2·acc is exact only while 3·K·255² < 2³¹."""
    if n_glyphs >= END_ID:
        raise ValueError(f"{n_glyphs} glyphs exceed the u8 id format ({END_ID - 1})")
    if 3 * window * 65025 >= 2**31:
        raise ValueError(f"prop window of {window} px exceeds the exact-i32 score bound (11008)")


def _shapes(strips, templates, colsq_cum, advances) -> tuple[int, ...]:
    if strips.dim() != 3 or templates.dim() != 4:
        raise ValueError("prop_scan: strips [L, h, crop_w] and templates [G, 64, h, wbank] expected")
    L, h, crop_w = strips.shape
    G, P, th, wbank = templates.shape
    if P != PHASES or th != h or tuple(colsq_cum.shape) != (G, P, wbank + 1) or (
        tuple(advances.shape) != (G,)
    ):
        raise ValueError(
            f"prop_scan: strips {tuple(strips.shape)}, templates {tuple(templates.shape)}, "
            f"colsq_cum {tuple(colsq_cum.shape)} and advances {tuple(advances.shape)} do not agree"
        )
    if G == 0:
        raise ValueError("prop_scan: empty alphabet")
    check_bank(G, h * wbank)
    return L, h, crop_w, G, wbank


def prop_scan_reference(
    strips: torch.Tensor,  # [L, h, crop_w] u8, inverted
    templates: torch.Tensor,  # [G, 64, h, wbank] u8
    colsq_cum: torch.Tensor,  # [G, 64, wbank+1] int32
    advances: torch.Tensor,  # [G] f32
    base: int,
    ox: float,
    n_steps: int,
) -> torch.Tensor:
    """Plain K5, on the tensors' device: ids u8 [L, n_steps], END_ID past
    each line's end. The correlation is a float64 batched matmul at each
    line's phase (exact: K·65025 < 2⁵³); the argmin is ops/ssd.py's
    written-out first minimum."""
    L, h, crop_w, G, wbank = _shapes(strips, templates, colsq_cum, advances)
    dev = strips.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    ox_t, w_t, c64, half = f32(ox), f32(float(crop_w)), f32(64.0), f32(0.5)
    adv = advances.to(dev, torch.float32)
    by_phase = templates.permute(1, 0, 2, 3).reshape(PHASES, G, h * wbank)
    cc_by_phase = colsq_cum.permute(1, 0, 2).to(torch.int64)  # [64, G, wbank+1]
    cols = torch.arange(wbank, device=dev)
    pos = torch.zeros(L, dtype=torch.float32, device=dev)
    ids = torch.full((L, n_steps), END_ID, dtype=torch.uint8, device=dev)
    for step in range(n_steps):
        active = pos < w_t
        if not bool(active.any()):
            break
        s = ox_t + pos
        t64 = torch.floor(s * c64 + half).to(torch.int32)  # s >= 0: ties away from zero
        k, p = (t64 >> 6).to(torch.int64), (t64 & 63).to(torch.int64)
        x = k[:, None] - base + cols  # [L, wbank] strip columns of the window
        inside = (x >= 0) & (x < crop_w)
        win = strips.gather(2, x.clamp(0, crop_w - 1)[:, None, :].expand(L, h, wbank))
        win = (win * inside[:, None, :]).reshape(L, h * wbank, 1).to(torch.float64)
        acc = torch.bmm(by_phase[p].to(torch.float64), win)[..., 0].to(torch.int64)  # [L, G]
        tlo = (base - k).clamp(0, wbank)
        thi = (crop_w - k + base).clamp(0, wbank)
        cc = cc_by_phase[p]  # [L, G, wbank+1]
        tsq = cc.gather(2, thi[:, None, None].expand(L, G, 1))[..., 0] - cc.gather(
            2, tlo[:, None, None].expand(L, G, 1)
        )[..., 0]
        g = argmin_glyph(tsq - 2 * acc).to(torch.int64)
        ids[:, step] = torch.where(active, g, END_ID).to(torch.uint8)
        pos = torch.where(active, pos + adv[g], pos)
    return ids


def template_index(G: int, h: int, wbank: int) -> np.ndarray:
    """Where each byte of the kernel's template words comes from: int64
    [64, G, kwp, 4], byte j of word m of (phase p, glyph g) is the flat index
    into templates [G, 64, h, wbank] of column c = 4q + j of row y, (y, q) =
    divmod(m, ceil(wbank/4)), or G·64·h·wbank (a zero byte) past wbank and
    past the last row. kwp = h·ceil(wbank/4) rounded up to a multiple of 32:
    no word straddles two rows, and a warp's lanes read whole 32-word
    chunks."""
    wb4 = -(-wbank // 4)
    kwp = -(-h * wb4 // 32) * 32
    p, g, m, j = np.ix_(np.arange(PHASES), np.arange(G), np.arange(kwp), np.arange(4))
    y, c = m // wb4, 4 * (m % wb4) + j
    idx = ((g * PHASES + p) * h + y) * wbank + c
    return np.where((y < h) & (c < wbank), idx, G * PHASES * h * wbank)


def template_words(templates: torch.Tensor) -> torch.Tensor:
    """[G, 64, h, wbank] u8 -> the kernel's template words, int32 [64, G,
    kwp] on the templates' device, laid out by template_index. The decoder
    lays out each bank once (models/focr_prop.py::PropForward)."""
    G, _, h, wbank = templates.shape
    idx = torch.from_numpy(template_index(G, h, wbank)).to(templates.device)
    flat = torch.cat([templates.reshape(-1), templates.new_zeros(1)])
    return flat[idx].reshape(PHASES, G, -1).view(torch.int32)


def prop_scan(
    strips: torch.Tensor,
    templates: torch.Tensor,
    colsq_cum: torch.Tensor,
    advances: torch.Tensor,
    base: int,
    ox: float,
    n_steps: int,
    words: torch.Tensor | None = None,
) -> torch.Tensor:
    """K5 (csrc/focr_prop.cu) for CUDA tensors, prop_scan_reference for CPU
    tensors. On the card: strips and templates contiguous u8, colsq_cum
    int32, advances f32, all on the strips' device; ids is a new tensor
    there. ``words``: template_words(templates), precomputed (the decoder's
    forward module carries it)."""
    if strips.device.type == "cpu":
        return prop_scan_reference(strips, templates, colsq_cum, advances, base, ox, n_steps)
    if strips.device.type != "cuda":
        raise ValueError(f"prop_scan: unsupported device {strips.device}")
    L, h, crop_w, G, wbank = _shapes(strips, templates, colsq_cum, advances)
    for name, t, dt in (
        ("strips", strips, torch.uint8), ("templates", templates, torch.uint8),
        ("colsq_cum", colsq_cum, torch.int32), ("advances", advances, torch.float32),
    ):
        if t.dtype != dt or not t.is_contiguous() or t.device != strips.device:
            raise ValueError(f"prop_scan: {name} must be contiguous {dt} on {strips.device}")
    ids = torch.empty((L, n_steps), dtype=torch.uint8, device=strips.device)
    if L == 0 or n_steps == 0:
        return ids
    from focr_tpu_torch.native.build import load

    tw = template_words(templates) if words is None else words
    if tw.dtype != torch.int32 or not tw.is_contiguous() or tw.device != strips.device or (
        tuple(tw.shape[:2]) != (PHASES, G) or tw.shape[2] != -(-h * -(-wbank // 4) // 32) * 32
    ):
        raise ValueError("prop_scan: words must be template_words(templates)")
    with launch_stream(strips) as stream:
        rc = load().focr_prop_scan(
            strips.data_ptr(), L, h, crop_w, tw.data_ptr(), tw.shape[2], colsq_cum.data_ptr(),
            advances.data_ptr(), G, wbank, int(base), float(ox), n_steps, ids.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"prop_scan kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "prop_scan")
    return ids
