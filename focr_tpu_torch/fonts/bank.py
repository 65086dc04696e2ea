"""Template banks: every glyph rendered once at startup, matched on the device.

Counterpart of focr_tpu/fonts/bank.py: the grid bank (GridBank,
build_grid_bank — :28-173) for monospace alphabets, the 64-phase proportional
bank (PropBank, build_prop_bank — :181-298) and the ncc needles (:307-454),
each rendered once and kept in the disk cache (utils/cache.py) under the key
parameters focr_tpu uses.

Every bank can also be saved to and loaded from an .npz file
(save_grid_bank / load_grid_bank, save_needle_bank / load_needle_bank), so a
machine without FreeType can decode with glyphs rendered elsewhere. A saved
focr bank set holds one grid or proportional bank per crop height (its
settings name the kind), so every page height on its grid is served; it loads
lazily (BankSet): a crop height is decompressed when a decoder first asks for
it, and kept raw in the bank cache, so that a later process reads it back
without decompressing it again.
"""

from __future__ import annotations

import io
import json
import os
import threading
from collections.abc import Iterator, Mapping
from dataclasses import dataclass

import numpy as np

from focr_tpu_torch.fonts.ft import Canvas, Face, RectF
from focr_tpu_torch.models.types import BoxSize, RenderOptions
from focr_tpu_torch.oracle.focr_oracle import advance_px, alphabet_origin
from focr_tpu_torch.utils import cache
from focr_tpu_torch.utils.metrics import count, span


@dataclass(frozen=True)
class GridBank:
    """Per-cell glyph templates for one (grid, crop-height) configuration.

    templates[k, g] is glyph g rasterized at cursor position k into the
    (crop_w × crop_h) line canvas — exactly what score_glyph compares against
    (main.rs:87-110) — cropped to the cell window [wx0[k], wx0[k]+win_w).
    """

    alphabet: str
    templates: np.ndarray  # [C, G, crop_h, win_w] u8
    tsq: np.ndarray  # [C, G] i32 (i64 when it would not fit) — Σ T² over the full canvas
    wx0: np.ndarray  # [C] i32 — window start column in the line crop
    positions: np.ndarray  # [C] f32 — cursor x positions
    crop_w: int
    crop_h: int
    monospace: bool

    @property
    def n_cells(self) -> int:
        return self.templates.shape[0]

    @property
    def n_glyphs(self) -> int:
        return self.templates.shape[1]

    @property
    def win_w(self) -> int:
        return self.templates.shape[3]


def cursor_positions(face: Face, alphabet: str, ropts: RenderOptions, width: int) -> np.ndarray:
    """Static cursor grid for monospace fonts: replicates the f32 accumulation
    ``pos += advance/upem*size*kern_x`` (main.rs:176-178). Requires every
    alphabet glyph to share one advance (checked by caller)."""
    adv = advance_px(face, face.glyph_for_char(alphabet[0]), ropts)
    out = []
    pos = np.float32(0.0)
    while pos < np.float32(width):
        out.append(pos)
        pos = pos + adv
    return np.array(out, dtype=np.float32)


def is_monospace(face: Face, alphabet: str, ropts: RenderOptions) -> bool:
    advs = {float(advance_px(face, face.glyph_for_char(c), ropts)) for c in alphabet}
    return len(advs) <= 1


def build_grid_bank(
    face: Face,
    alphabet: str,
    ropts: RenderOptions,
    crop_w: int,
    crop_h: int,
) -> GridBank:
    """Build the focr cell/glyph template bank for a (crop_w × crop_h) line.

    Replaces decode_line's inner rasterization (main.rs:125-172). Each
    template is rasterized into a full line-sized canvas (so edge clipping
    matches the reference exactly) and cropped to a fixed-width window derived
    from actual ink extents.
    """
    if not is_monospace(face, alphabet, ropts):
        raise ValueError("grid bank requires a monospace alphabet (use the sequential fallback)")
    key = cache.bank_key(
        "grid",
        face.path,
        size=ropts.size,
        kern_x=ropts.kern_x,
        hinting=(ropts.hinting.full, ropts.hinting.size),
        alphabet=alphabet,
        crop_w=crop_w,
        crop_h=crop_h,
    )
    if (hit := cache.load_arrays(key)) is not None:
        return GridBank(
            alphabet=alphabet,
            templates=hit["templates"],
            tsq=hit["tsq"],
            wx0=hit["wx0"],
            positions=hit["positions"],
            crop_w=crop_w,
            crop_h=crop_h,
            monospace=True,
        )

    gids = [face.glyph_for_char(c) for c in alphabet]
    ox, oy = alphabet_origin(face, alphabet, ropts)
    positions = cursor_positions(face, alphabet, ropts, crop_w)
    C, G = len(positions), len(gids)

    canvases = np.zeros((C, G, crop_h, crop_w), dtype=np.uint8)
    canvas = Canvas(crop_w, crop_h)
    for k, pos in enumerate(positions):
        for gi, gid in enumerate(gids):
            canvas.fill(0)
            face.rasterize_glyph(
                canvas, gid, ropts.size, (float(ox + pos), float(oy)), ropts.hinting
            )
            canvases[k, gi] = canvas.pixels

    # Window per cell from actual ink extents (can exceed the metrics-derived
    # raster bounds by a pixel, so we derive from pixels, not metrics).
    col_ink = canvases.any(axis=2)  # [C, G, crop_w]
    any_ink = col_ink.any(axis=1)  # [C, crop_w]
    wx0 = np.zeros(C, dtype=np.int32)
    wx1 = np.ones(C, dtype=np.int32)
    for k in range(C):
        cols = np.nonzero(any_ink[k])[0]
        if len(cols):
            wx0[k], wx1[k] = cols[0], cols[-1] + 1
        else:
            wx0[k], wx1[k] = 0, 1
    win_w = int((wx1 - wx0).max())
    wx1 = np.minimum(wx0 + win_w, crop_w)
    wx0 = wx1 - win_w
    np.clip(wx0, 0, None, out=wx0)

    templates = np.zeros((C, G, crop_h, win_w), dtype=np.uint8)
    for k in range(C):
        w = min(win_w, crop_w - wx0[k])
        templates[k, :, :, :w] = canvases[k, :, :, wx0[k] : wx0[k] + w]

    # ||T||^2 over the FULL line canvas, not the window: the metric's argmin
    # equals the reference's whole-canvas SSD argmin only with this term
    t64 = canvases.astype(np.int64)
    tsq = (t64 * t64).sum(axis=(2, 3))
    # ||T||^2 exceeds i32 only for very large dense glyphs (>~33k ink px);
    # keep the compact i32 when safe, widen otherwise
    if tsq.max() < 2**31:
        tsq = tsq.astype(np.int32)
    cache.store_arrays(
        key, {"templates": templates, "tsq": tsq, "wx0": wx0, "positions": positions}
    )
    return GridBank(
        alphabet=alphabet,
        templates=templates,
        tsq=tsq,
        wx0=wx0,
        positions=positions,
        crop_w=crop_w,
        crop_h=crop_h,
        monospace=True,
    )


PROP_PHASES = 64  # FreeType quantizes translations to 1/64 px (26.6 fixed)


@dataclass(frozen=True)
class PropBank:
    """Per-(glyph, subpixel-phase) templates for the sequential greedy decode
    of a proportional alphabet (focr_tpu/fonts/bank.py:184-216).

    FreeType rounds the rasterization translation to 1/64 px, and a shift by
    whole pixels moves the coverage bitmap exactly, so the bitmap the
    reference draws at cursor t is templates[g, round(t*64) % 64] shifted by
    round(t*64) // 64 px: 64 phases make the decode exact.

    templates[g, p] is glyph g rendered at x = base + p/64 into a
    (crop_h × wbank) canvas; colsq_cum[g, p, c] = Σ_{cols<c} Σ_rows T² gives
    the exact clipped ‖T‖² when the window hangs past the line canvas' edge
    (the reference clips ink at the canvas, main.rs:96-106).
    """

    alphabet: str
    templates: np.ndarray  # [G, P, crop_h, wbank] u8
    colsq_cum: np.ndarray  # [G, P, wbank+1] i32
    advances: np.ndarray  # [G] f32 — cursor advance per glyph
    base: int  # template canvas x margin (covers negative left bearing)
    ox: np.float32  # alphabet origin (main.rs:131-147)
    oy: np.float32
    crop_h: int


def build_prop_bank(face: Face, alphabet: str, ropts: RenderOptions, crop_h: int) -> PropBank:
    """Rasterize the G×64 phase bank for one crop height (cached on disk
    like the grid bank)."""
    P = PROP_PHASES
    gids = [face.glyph_for_char(c) for c in alphabet]
    ox, oy = alphabet_origin(face, alphabet, ropts)
    advances = np.array([advance_px(face, g, ropts) for g in gids], dtype=np.float32)

    key = cache.bank_key(
        "prop",
        face.path,
        size=ropts.size,
        kern_x=ropts.kern_x,
        hinting=(ropts.hinting.full, ropts.hinting.size),
        alphabet=alphabet,
        crop_h=crop_h,
        phases=P,
    )
    if (hit := cache.load_arrays(key)) is not None:
        return PropBank(
            alphabet=alphabet,
            templates=hit["templates"],
            colsq_cum=hit["colsq_cum"],
            advances=advances,
            base=int(hit["base"][0]),
            ox=ox,
            oy=oy,
            crop_h=crop_h,
        )

    # canvas extent: union of raster bounds over glyphs and phases, ±2 px of
    # slack (actual ink can exceed the metrics-derived bounds by a pixel)
    x0 = x1 = 0
    for g in gids:
        for p in range(P):
            rb = face.raster_bounds(g, ropts.size, (p / P, float(oy)), ropts.hinting)
            x0 = min(x0, rb.x0)
            x1 = max(x1, rb.x1)
    base = -x0 + 2
    wbank = base + x1 + 2

    G = len(gids)
    templates = np.zeros((G, P, crop_h, wbank), dtype=np.uint8)
    canvas = Canvas(wbank, crop_h)
    for gi, g in enumerate(gids):
        for p in range(P):
            canvas.fill(0)
            face.rasterize_glyph(canvas, g, ropts.size, (base + p / P, float(oy)), ropts.hinting)
            templates[gi, p] = canvas.pixels

    colsq = (templates.astype(np.int64) ** 2).sum(axis=2)  # [G, P, wbank]
    colsq_cum = np.zeros((G, P, wbank + 1), dtype=np.int64)
    np.cumsum(colsq, axis=2, out=colsq_cum[:, :, 1:])
    assert colsq_cum.max() < 2**31
    colsq_cum = colsq_cum.astype(np.int32)
    cache.store_arrays(
        key, {"templates": templates, "colsq_cum": colsq_cum, "base": np.array([base])}
    )
    return PropBank(
        alphabet=alphabet,
        templates=templates,
        colsq_cum=colsq_cum,
        advances=advances,
        base=base,
        ox=ox,
        oy=oy,
        crop_h=crop_h,
    )


def prop_bank_from_arrays(
    alphabet: str, templates, colsq_cum, advances, base, ox, oy, crop_h
) -> PropBank:
    """A PropBank from another package's fields as numpy (focr_tpu's PropBank
    carries the same ones), with the port's dtypes."""
    return PropBank(
        alphabet=alphabet,
        templates=np.ascontiguousarray(templates, dtype=np.uint8),
        colsq_cum=np.ascontiguousarray(colsq_cum, dtype=np.int32),
        advances=np.ascontiguousarray(advances, dtype=np.float32),
        base=int(base),
        ox=np.float32(ox),
        oy=np.float32(oy),
        crop_h=int(crop_h),
    )


FocrBank = GridBank | PropBank


def grid_bank_settings(
    font_path: str, alphabet: str, ropts: RenderOptions, crop_w: int, kind: str = "grid"
) -> dict:
    """Everything a focr bank depends on besides its crop height, as saved
    beside it: a loaded bank is used only under the settings it was rendered
    with. ``kind`` is "grid" (monospace, per-cell templates for one crop
    width) or "prop" (64 phases per glyph, for any crop width)."""
    settings = {
        "font": os.path.basename(font_path),
        "size": float(ropts.size),
        "kern_x": float(ropts.kern_x),
        "hinting": [bool(ropts.hinting.full), float(ropts.hinting.size)],
        "alphabet": alphabet,
        "kind": kind,
    }
    if kind == "grid":
        settings["crop_w"] = int(crop_w)
    elif kind != "prop":
        raise ValueError(f"focr bank kind {kind!r}: expected 'grid' or 'prop'")
    return settings


def grid_bank_arrays(banks: list[FocrBank], settings: dict) -> dict[str, np.ndarray]:
    """The .npz fields of a saved focr bank set (see load_grid_bank): one bank
    per crop height, all of the settings' kind and alphabet (and, for grid
    banks, crop width)."""
    kind = settings["kind"]
    out = {"grid_bank_settings": np.array(json.dumps(settings, sort_keys=True))}
    for bank in banks:
        if (
            bank.alphabet != settings["alphabet"]
            or isinstance(bank, PropBank) != (kind == "prop")
            or (kind == "grid" and bank.crop_w != settings["crop_w"])
        ):
            raise ValueError("focr bank set: every bank must match the settings")
        h = bank.crop_h
        if kind == "grid":
            out[f"grid_h{h}_templates"] = bank.templates
            out[f"grid_h{h}_tsq"] = bank.tsq
            out[f"grid_h{h}_wx0"] = bank.wx0
            out[f"grid_h{h}_positions"] = bank.positions
        else:
            out[f"prop_h{h}_templates"] = bank.templates
            out[f"prop_h{h}_colsq_cum"] = bank.colsq_cum
            out[f"prop_h{h}_advances"] = bank.advances
            out[f"prop_h{h}_origin"] = np.array([bank.ox, bank.oy], dtype=np.float32)
            out[f"prop_h{h}_base"] = np.array([bank.base], dtype=np.int32)
    return out


def save_grid_bank(path: str, banks: list[FocrBank], settings: dict) -> None:
    np.savez_compressed(path, **grid_bank_arrays(banks, settings))


_MEMBERS = {"grid": ("templates", "tsq", "wx0", "positions"),
            "prop": ("templates", "colsq_cum", "advances", "origin", "base")}


class BankSet(Mapping):
    """A saved focr bank set as a read-only mapping {crop height: GridBank or
    PropBank} that loads a height when it is first asked for and keeps it.
    The settings and the member names are read when the set is opened, so
    ``set(banks)``, ``len`` and ``in`` decompress nothing; ``kind`` is the
    settings' "grid" or "prop". ``loads`` lists the heights loaded so far, in
    order. A height is read from its raw copy in the bank cache
    (utils/cache.py) when the cache holds a sound one (counted as
    ``bank_cache_hits``), else decompressed from the file and its copy
    written (``bank_cache_misses``). The .npz handle stays open as long as
    the set lives; ``close`` (or the set's end of life) releases it, after
    which only the heights already loaded can be read. The decoders may ask
    from worker threads: a lock guards each first load."""

    def __init__(self, path: str):
        self._z = np.load(path, allow_pickle=False)
        try:
            self.settings = json.loads(str(self._z["grid_bank_settings"]))
        except BaseException:
            self._z.close()
            raise
        self.settings.setdefault("kind", "grid")  # a set saved without a kind is a grid set
        self.kind: str = self.settings["kind"]
        self._prefix = "grid_h" if self.kind == "grid" else "prop_h"
        self._heights = sorted(
            int(k[len(self._prefix) : -len("_templates")])
            for k in self._z.files
            if k.startswith(self._prefix) and k.endswith("_templates")
        )
        self._banks: dict[int, FocrBank] = {}
        self._lock = threading.Lock()
        self.loads: list[int] = []

    def __iter__(self) -> Iterator[int]:
        return iter(self._heights)

    def __len__(self) -> int:
        return len(self._heights)

    def __contains__(self, h) -> bool:
        return h in self._heights

    def __getitem__(self, h: int) -> FocrBank:
        with self._lock:
            bank = self._banks.get(h)
            if bank is None:
                if h not in self._heights:
                    raise KeyError(h)
                if self._z is None:
                    raise ValueError(f"focr bank set: closed before crop height {h} was loaded")
                with span("focr_bank_height_load"):
                    bank = self._banks[h] = self._load(h)
                count("bank_bytes_loaded", sum(
                    v.nbytes for v in vars(bank).values() if isinstance(v, np.ndarray)))
                self.loads.append(h)
            return bank

    def _members(self, h: int) -> dict[str, np.ndarray]:
        """Crop height ``h``'s members by field, from the bank cache's raw
        copy or, on a miss, decompressed (and the copy written)."""
        fields = _MEMBERS[self.kind]
        infos = [self._z.zip.getinfo(f"{self._prefix}{h}_{f}.npy") for f in fields]
        members = [(i.filename, i.CRC, i.file_size) for i in infos]
        key = cache.members_key("saved_bank_height", members, settings=self.settings, crop_h=h)
        raw = cache.load_members(key, members)
        count("bank_cache_misses" if raw is None else "bank_cache_hits", 1)
        if raw is None:
            raw = [self._z.zip.read(i) for i in infos]
            cache.store_members(key, raw)
        return {f: np.lib.format.read_array(io.BytesIO(b), allow_pickle=False)
                for f, b in zip(fields, raw)}

    def _load(self, h: int) -> FocrBank:
        m, s = self._members(h), self.settings
        if self.kind == "grid":
            return GridBank(
                alphabet=s["alphabet"],
                templates=m["templates"],
                tsq=m["tsq"],
                wx0=m["wx0"],
                positions=m["positions"],
                crop_w=s["crop_w"],
                crop_h=h,
                monospace=True,
            )
        ox, oy = m["origin"]
        return prop_bank_from_arrays(
            s["alphabet"], m["templates"], m["colsq_cum"], m["advances"], m["base"][0], ox, oy, h,
        )

    def close(self) -> None:
        with self._lock:
            if self._z is not None:
                self._z.close()
                self._z = None

    def __del__(self):
        z = getattr(self, "_z", None)
        if z is not None:
            z.close()


def load_grid_bank(path: str) -> tuple[BankSet, dict]:
    """(the saved set as a lazy {crop_h: GridBank or PropBank} mapping, the
    settings the banks were rendered with)."""
    banks = BankSet(path)
    return banks, banks.settings


@dataclass(frozen=True)
class Needle:
    letter: str
    offset: tuple[float, float]  # the subpixel grid offset (pre-correction)
    corrected_offset: tuple[float, float]
    pixels: np.ndarray  # [n_h, n_w] u8
    s_n: int
    s2_n: int


def offsets_grid(x_bits: int, y_bits: int) -> list[tuple[float, float]]:
    """2^x_bits × 2^y_bits subpixel offsets, x-major (ncc.rs:563-573)."""
    xs = 2**x_bits
    ys = 2**y_bits
    return [(x / xs, y / ys) for x in range(xs) for y in range(ys)]


def _box_for_offset(
    face: Face,
    alphabet: str,
    ropts: RenderOptions,
    box_size: BoxSize,
    offset: tuple[float, float],
) -> tuple[float, tuple[int, int] | None]:
    """(y_offset, canvas (w, h) or None for per-char boxes) — ncc.rs:588-628."""
    m = face.metrics
    to_px = np.float32(1.0) / np.float32(m.units_per_em) * np.float32(ropts.size)
    if box_size is BoxSize.FONT:
        bbox = m.bounding_box.scale(float(to_px)).round_out()
        y_offset = float(np.ceil(np.float32(m.ascent) * to_px))
        return y_offset, (bbox.width, bbox.height)
    if box_size is BoxSize.ALPHABET:
        y_offset = 0.0
        bbox = RectF()
        for c in alphabet:
            gid = face.glyph_for_char(c)
            tb = face.typographic_bounds(gid).scale(float(to_px))
            bearing_y = tb.y0 + tb.height  # glyph_bounds.origin().y() + height
            y_offset = max(y_offset, float(np.ceil(np.float32(bearing_y))))
            rb = face.raster_bounds(gid, ropts.size, offset, ropts.hinting)
            bbox = bbox.union_rect(rb.to_f32())
        out = bbox.round_out()
        return y_offset, (out.width, out.height)
    return 0.0, None


def render_needle(
    face: Face,
    letter: str,
    corrected_offset: tuple[float, float],
    ropts: RenderOptions,
    canvas_size: tuple[int, int] | None,
    padding: tuple[int, int],
) -> np.ndarray:
    """The ncc glyph renderer (ncc.rs:143-196): canvas = box (+2*padding) for
    fixed boxes (origin (0,0)) or tight raster bounds for per-char boxes
    (origin -raster_bounds.origin())."""
    gid = face.glyph_for_char(letter)
    if canvas_size is not None:
        size = (canvas_size[0] + 2 * padding[0], canvas_size[1] + 2 * padding[1])
        origin = (0.0, 0.0)
    else:
        rb = face.raster_bounds(gid, ropts.size, corrected_offset, ropts.hinting)
        size = (rb.width + 2 * padding[0], rb.height + 2 * padding[1])
        origin = (-float(rb.x0), -float(rb.y0))
    canvas = Canvas(size[0], size[1])
    face.rasterize_glyph(
        canvas,
        gid,
        ropts.size,
        (
            origin[0] + padding[0] + corrected_offset[0],
            origin[1] + padding[1] + corrected_offset[1],
        ),
        ropts.hinting,
    )
    return canvas.pixels


def _needle(letter, offset, corrected, px) -> Needle:
    p64 = px.astype(np.int64)
    return Needle(
        letter=letter,
        offset=offset,
        corrected_offset=corrected,
        pixels=px,
        s_n=int(p64.sum()),
        s2_n=int((p64 * p64).sum()),
    )


def build_needles(
    face: Face,
    alphabet: str,
    ropts: RenderOptions,
    box_size: BoxSize,
    x_bits: int,
    y_bits: int,
    padding: tuple[int, int] = (0, 0),
) -> list[Needle]:
    """All (offset × letter) needles in reference iteration order
    (offsets outer, letters inner — ncc.rs:587-655), cached on disk."""
    key = cache.bank_key(
        "needles",
        face.path,
        size=ropts.size,
        hinting=(ropts.hinting.full, ropts.hinting.size),
        alphabet=alphabet,
        box=box_size.value,
        x_bits=x_bits,
        y_bits=y_bits,
        padding=padding,
    )
    if (hit := cache.load_arrays(key)) is not None:
        return [
            Needle(
                letter=str(hit["letters"][i]),
                offset=(float(hit["offsets"][i, 0]), float(hit["offsets"][i, 1])),
                corrected_offset=(float(hit["corrected"][i, 0]), float(hit["corrected"][i, 1])),
                pixels=hit[f"px{i}"],
                s_n=int(hit["s_n"][i]),
                s2_n=int(hit["s2_n"][i]),
            )
            for i in range(int(hit["n"][0]))
        ]

    needles: list[Needle] = []
    for offset in offsets_grid(x_bits, y_bits):
        y_off, canvas_size = _box_for_offset(face, alphabet, ropts, box_size, offset)
        corrected = (offset[0], offset[1] + y_off)
        for letter in alphabet:
            px = render_needle(face, letter, corrected, ropts, canvas_size, padding)
            needles.append(_needle(letter, offset, corrected, px))
    arrays: dict[str, np.ndarray] = {
        "n": np.array([len(needles)]),
        "letters": np.array([nd.letter for nd in needles]),
        "offsets": np.array([nd.offset for nd in needles], dtype=np.float64),
        "corrected": np.array([nd.corrected_offset for nd in needles], dtype=np.float64),
        "s_n": np.array([nd.s_n for nd in needles], dtype=np.int64),
        "s2_n": np.array([nd.s2_n for nd in needles], dtype=np.int64),
    }
    for i, nd in enumerate(needles):
        arrays[f"px{i}"] = nd.pixels
    cache.store_arrays(key, arrays)
    return needles


def bank_settings(
    font_path: str,
    alphabet: str,
    ropts: RenderOptions,
    box_size: BoxSize,
    x_bits: int,
    y_bits: int,
    padding: tuple[int, int],
) -> dict:
    """Everything a needle bank depends on, as saved beside it: a loaded bank
    is used only under the settings it was rendered with."""
    return {
        "font": os.path.basename(font_path),
        "size": float(ropts.size),
        "hinting": [bool(ropts.hinting.full), float(ropts.hinting.size)],
        "alphabet": alphabet,
        "box": box_size.value,
        "x_bits": int(x_bits),
        "y_bits": int(y_bits),
        "padding": [int(padding[0]), int(padding[1])],
    }


def needle_bank_arrays(needles: list[Needle], settings: dict) -> dict[str, np.ndarray]:
    """The .npz fields of a saved bank (see load_needle_bank)."""
    return {
        "bank_settings": np.array(json.dumps(settings, sort_keys=True)),
        "letters": np.array([nd.letter for nd in needles]),
        "offsets": np.array([nd.offset for nd in needles], dtype=np.float64),
        "corrected": np.array([nd.corrected_offset for nd in needles], dtype=np.float64),
        "shapes": np.array([nd.pixels.shape for nd in needles], dtype=np.int32),
        "pixels": np.concatenate([nd.pixels.ravel() for nd in needles]),
    }


def save_needle_bank(path: str, needles: list[Needle], settings: dict) -> None:
    np.savez_compressed(path, **needle_bank_arrays(needles, settings))


def load_needle_bank(path: str) -> tuple[list[Needle], dict]:
    """(needles in reference order, the settings they were rendered with)."""
    with np.load(path, allow_pickle=False) as z:
        settings = json.loads(str(z["bank_settings"]))
        letters, offsets, corrected = z["letters"], z["offsets"], z["corrected"]
        shapes, blob = z["shapes"], z["pixels"]
    needles = []
    off = 0
    for i, (h, w) in enumerate(shapes.tolist()):
        px = blob[off : off + h * w].reshape(h, w).copy()
        off += h * w
        needles.append(
            _needle(
                str(letters[i]),
                (float(offsets[i, 0]), float(offsets[i, 1])),
                (float(corrected[i, 0]), float(corrected[i, 1])),
                px,
            )
        )
    return needles, settings
