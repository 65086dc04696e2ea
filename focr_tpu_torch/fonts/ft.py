"""ctypes binding to the system FreeType library plus a font-kit-compatible Face.

A copy of focr_tpu/fonts/ft.py (the port may not import focr_tpu, which
imports jax); the one change is that FreeType is loaded by the first Face,
not at import. The reference drives
FreeType through the Rust `font_kit` crate (reference src/main.rs:4-10,
src/ncc.rs:7-13); we bind libfreetype.so directly and replicate the font-kit
`Loader` semantics the reference depends on:

  * ``glyph_for_char``    — FT_Get_Char_Index            (main.rs:49)
  * ``advance``           — FT_LOAD_NO_SCALE horiAdvance (main.rs:51, 176)
  * ``typographic_bounds``— NO_SCALE glyph metrics rect  (ncc.rs:606, 671)
  * ``metrics``           — face-wide ascender/descender/bbox (ncc.rs:791-802)
  * ``raster_bounds``     — font-kit Loader's default implementation:
                            round_out(translate + flip_y(typo_bounds * size/upem))
                            (main.rs:59-67, 133-147; ncc.rs:157-165)
  * ``rasterize_glyph``   — FT_Set_Transform + FT_Render_Glyph(NORMAL), A8
                            grayscale-AA, baseline at the translation point,
                            y-down canvas (main.rs:73-83, 98-106; ncc.rs:184-194)

The rasterizer runs host-side ONCE per (font, size, alphabet, offset-grid) to
build the device-resident template bank; it is never in the decode hot loop
(unlike the reference, which re-rasterizes every candidate — SURVEY.md §3.1).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from ctypes import (
    POINTER,
    Structure,
    byref,
    c_byte,
    c_char_p,
    c_int,
    c_long,
    c_short,
    c_ubyte,
    c_uint,
    c_ulong,
    c_ushort,
    c_void_p,
)
from dataclasses import dataclass

import numpy as np

# --------------------------------------------------------------------------
# Raw FreeType ABI (stable since FreeType 2.x)
# --------------------------------------------------------------------------

FT_Pos = c_long
FT_Fixed = c_long
FT_F26Dot6 = c_long


class FT_Vector(Structure):
    _fields_ = [("x", FT_Pos), ("y", FT_Pos)]


class FT_Matrix(Structure):
    _fields_ = [("xx", FT_Fixed), ("xy", FT_Fixed), ("yx", FT_Fixed), ("yy", FT_Fixed)]


class FT_BBox(Structure):
    _fields_ = [("xMin", FT_Pos), ("yMin", FT_Pos), ("xMax", FT_Pos), ("yMax", FT_Pos)]


class FT_Generic(Structure):
    _fields_ = [("data", c_void_p), ("finalizer", c_void_p)]


class FT_Bitmap(Structure):
    _fields_ = [
        ("rows", c_uint),
        ("width", c_uint),
        ("pitch", c_int),
        ("buffer", POINTER(c_ubyte)),
        ("num_grays", c_ushort),
        ("pixel_mode", c_ubyte),
        ("palette_mode", c_ubyte),
        ("palette", c_void_p),
    ]


class FT_Glyph_Metrics(Structure):
    _fields_ = [
        ("width", FT_Pos),
        ("height", FT_Pos),
        ("horiBearingX", FT_Pos),
        ("horiBearingY", FT_Pos),
        ("horiAdvance", FT_Pos),
        ("vertBearingX", FT_Pos),
        ("vertBearingY", FT_Pos),
        ("vertAdvance", FT_Pos),
    ]


class FT_Outline(Structure):
    _fields_ = [
        ("n_contours", c_short),
        ("n_points", c_short),
        ("points", POINTER(FT_Vector)),
        ("tags", POINTER(c_byte)),
        ("contours", POINTER(c_short)),
        ("flags", c_int),
    ]


class FT_GlyphSlotRec(Structure):
    _fields_ = [
        ("library", c_void_p),
        ("face", c_void_p),
        ("next", c_void_p),
        ("glyph_index", c_uint),
        ("generic", FT_Generic),
        ("metrics", FT_Glyph_Metrics),
        ("linearHoriAdvance", FT_Fixed),
        ("linearVertAdvance", FT_Fixed),
        ("advance", FT_Vector),
        ("format", c_int),
        ("bitmap", FT_Bitmap),
        ("bitmap_left", c_int),
        ("bitmap_top", c_int),
        ("outline", FT_Outline),
        ("num_subglyphs", c_uint),
        ("subglyphs", c_void_p),
        ("control_data", c_void_p),
        ("control_len", c_long),
        ("lsb_delta", FT_Pos),
        ("rsb_delta", FT_Pos),
        ("other", c_void_p),
        ("internal", c_void_p),
    ]


class FT_FaceRec(Structure):
    _fields_ = [
        ("num_faces", c_long),
        ("face_index", c_long),
        ("face_flags", c_long),
        ("style_flags", c_long),
        ("num_glyphs", c_long),
        ("family_name", c_char_p),
        ("style_name", c_char_p),
        ("num_fixed_sizes", c_int),
        ("available_sizes", c_void_p),
        ("num_charmaps", c_int),
        ("charmaps", c_void_p),
        ("generic", FT_Generic),
        ("bbox", FT_BBox),
        ("units_per_EM", c_ushort),
        ("ascender", c_short),
        ("descender", c_short),
        ("height", c_short),
        ("max_advance_width", c_short),
        ("max_advance_height", c_short),
        ("underline_position", c_short),
        ("underline_thickness", c_short),
        ("glyph", POINTER(FT_GlyphSlotRec)),
        ("size", c_void_p),
        ("charmap", c_void_p),
        # private fields follow; never touched
    ]


# Load flags (freetype.h)
FT_LOAD_DEFAULT = 0x0
FT_LOAD_NO_SCALE = 0x1
FT_LOAD_NO_HINTING = 0x2
FT_LOAD_RENDER = 0x4
FT_LOAD_NO_BITMAP = 0x8
FT_LOAD_FORCE_AUTOHINT = 0x20
FT_LOAD_MONOCHROME = 0x1000
FT_LOAD_NO_AUTOHINT = 0x8000

FT_RENDER_MODE_NORMAL = 0
FT_RENDER_MODE_MONO = 2

FT_PIXEL_MODE_GRAY = 2


def _load_library() -> ctypes.CDLL:
    for name in ("libfreetype.so.6", "libfreetype.so", ctypes.util.find_library("freetype")):
        if not name:
            continue
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise OSError(
        "libfreetype not found; rendering needles needs the system FreeType "
        "(on a machine without it, load a saved bank with --needle-bank)"
    )


_ft = None  # the bound library, loaded by the first Face
_library = c_void_p()


def _freetype() -> ctypes.CDLL:
    """Load and initialise FreeType once, at first use: importing this module
    must work on machines without the library (the needle bank can then come
    from a file, fonts/bank.py::load_needle_bank)."""
    global _ft
    if _ft is not None:
        return _ft
    ft = _load_library()
    ft.FT_Init_FreeType.argtypes = [POINTER(c_void_p)]
    ft.FT_Init_FreeType.restype = c_int
    ft.FT_New_Face.argtypes = [c_void_p, c_char_p, c_long, POINTER(POINTER(FT_FaceRec))]
    ft.FT_New_Face.restype = c_int
    ft.FT_Done_Face.argtypes = [POINTER(FT_FaceRec)]
    ft.FT_Done_Face.restype = c_int
    ft.FT_Set_Char_Size.argtypes = [POINTER(FT_FaceRec), FT_F26Dot6, FT_F26Dot6, c_uint, c_uint]
    ft.FT_Set_Char_Size.restype = c_int
    ft.FT_Set_Transform.argtypes = [POINTER(FT_FaceRec), POINTER(FT_Matrix), POINTER(FT_Vector)]
    ft.FT_Set_Transform.restype = None
    ft.FT_Load_Glyph.argtypes = [POINTER(FT_FaceRec), c_uint, c_int]
    ft.FT_Load_Glyph.restype = c_int
    ft.FT_Render_Glyph.argtypes = [POINTER(FT_GlyphSlotRec), c_int]
    ft.FT_Render_Glyph.restype = c_int
    ft.FT_Get_Char_Index.argtypes = [POINTER(FT_FaceRec), c_ulong]
    ft.FT_Get_Char_Index.restype = c_uint
    err = ft.FT_Init_FreeType(byref(_library))
    if err != 0:
        raise OSError(f"FT_Init_FreeType failed: error {err}")
    _ft = ft
    return ft


# --------------------------------------------------------------------------
# Geometry helpers (pathfinder_geometry semantics)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RectF:
    """Float rect, matching pathfinder_geometry::rect::RectF semantics.

    ``(x0, y0)`` is the origin (min corner), ``(x1, y1)`` the max corner.
    """

    x0: float = 0.0
    y0: float = 0.0
    x1: float = 0.0
    y1: float = 0.0

    @property
    def width(self) -> float:
        return self.x1 - self.x0

    @property
    def height(self) -> float:
        return self.y1 - self.y0

    def union_rect(self, other: "RectF") -> "RectF":
        # pathfinder union_rect: componentwise min of origins / max of corners.
        # Note the reference folds starting from RectF::default() (the zero
        # rect), so the union always contains the point (0, 0)
        # (main.rs:56-58, 133-135; ncc.rs:602-604).
        return RectF(
            min(self.x0, other.x0),
            min(self.y0, other.y0),
            max(self.x1, other.x1),
            max(self.y1, other.y1),
        )

    def round_out(self) -> "RectI":
        return RectI(
            math.floor(self.x0), math.floor(self.y0), math.ceil(self.x1), math.ceil(self.y1)
        )

    def round(self) -> "RectI":
        # pathfinder RectF::round rounds each coordinate to the nearest
        # integer (f32::round = half away from zero). Used for the string
        # renderer's canvas size (main.rs:71).
        def r(v: float) -> int:
            return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))

        return RectI(r(self.x0), r(self.y0), r(self.x1), r(self.y1))

    def scale(self, s: float) -> "RectF":
        return RectF(
            np.float32(self.x0) * np.float32(s),
            np.float32(self.y0) * np.float32(s),
            np.float32(self.x1) * np.float32(s),
            np.float32(self.y1) * np.float32(s),
        )

    def flip_y(self) -> "RectF":
        # Transform2F::from_scale((1, -1)): maps y-up font space to y-down
        # raster space; the rect's y-extent [y0, y1] becomes [-y1, -y0].
        return RectF(self.x0, -self.y1, self.x1, -self.y0)

    def translate(self, tx: float, ty: float) -> "RectF":
        return RectF(self.x0 + tx, self.y0 + ty, self.x1 + tx, self.y1 + ty)


@dataclass(frozen=True)
class RectI:
    x0: int = 0
    y0: int = 0
    x1: int = 0
    y1: int = 0

    @property
    def width(self) -> int:
        return self.x1 - self.x0

    @property
    def height(self) -> int:
        return self.y1 - self.y0

    def to_f32(self) -> RectF:
        return RectF(float(self.x0), float(self.y0), float(self.x1), float(self.y1))


@dataclass(frozen=True)
class Metrics:
    """font-kit Metrics equivalent, all values in font units."""

    units_per_em: int
    ascent: float
    descent: float
    line_gap: float
    bounding_box: RectF  # y-up font space


class Canvas:
    """A8 grayscale canvas, y-down, top-left origin (font_kit::canvas::Canvas)."""

    def __init__(self, width: int, height: int):
        self.width = max(int(width), 0)
        self.height = max(int(height), 0)
        self.pixels = np.zeros((self.height, self.width), dtype=np.uint8)

    def fill(self, value: int = 0) -> None:
        self.pixels.fill(value)


def _to_f26dot6(v: float) -> int:
    # font-kit converts f32 -> 26.6 with Rust's f32::round, which rounds
    # ties AWAY FROM ZERO — python round() is banker's (half-to-even) and
    # diverges at exact half-ulp translations (e.g. 125.2265625*64 = 8014.5:
    # Rust 8015, banker's 8014), shifting the rasterized bitmap 1/64 px.
    x = float(v) * 64.0
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


@dataclass(frozen=True)
class HintingOptions:
    """font-kit HintingOptions: None or Full(size) (main.rs:394-398)."""

    full: bool = False
    size: float = 0.0

    @property
    def load_flags(self) -> int:
        if self.full:
            return FT_LOAD_DEFAULT
        return FT_LOAD_NO_HINTING

    def flags_for(self, point_size: float) -> int:
        """load_flags guarded by the Full(size) contract: font-kit hints the
        outline at `size` and scales it to point_size; this binding hints at
        point_size directly, which is equivalent only when the two agree —
        the reference's sole usage (Full(text_size), main.rs:394-398).
        Any other combination would silently render different bitmaps, so
        fail loudly instead."""
        if self.full and self.size and float(self.size) != float(point_size):
            raise NotImplementedError(
                f"Full(size={self.size}) hinting at point_size={point_size} "
                "is not supported (font-kit hints at `size` then rescales)"
            )
        return self.load_flags


class Face:
    """A loaded font face with font-kit-compatible query/rasterize methods."""

    def __init__(self, path: str, index: int = 0):
        self._face = POINTER(FT_FaceRec)()
        err = _freetype().FT_New_Face(_library, path.encode(), index, byref(self._face))
        if err != 0:
            raise OSError(f"FT_New_Face({path!r}) failed: error {err}")
        self.path = path
        self._current_size: float | None = None
        self._glyph_cache: dict[str, int] = {}
        # per-instance metric caches (a module-level lru_cache would key on
        # self and pin every Face + its native FT handle for process life)
        self._advance_cache: dict[int, float] = {}
        self._typo_cache: dict[int, RectF] = {}

    def __del__(self):  # pragma: no cover - interpreter shutdown ordering
        try:
            if self._face:
                _ft.FT_Done_Face(self._face)
        except Exception:
            pass

    # -- font-kit Loader queries ------------------------------------------

    @property
    def metrics(self) -> Metrics:
        f = self._face.contents
        bb = f.bbox
        return Metrics(
            units_per_em=int(f.units_per_EM),
            ascent=float(f.ascender),
            descent=float(f.descender),
            line_gap=float(f.height - f.ascender + f.descender),
            bounding_box=RectF(float(bb.xMin), float(bb.yMin), float(bb.xMax), float(bb.yMax)),
        )

    def glyph_for_char(self, char: str) -> int:
        gid = self._glyph_cache.get(char)
        if gid is None:
            gid = int(_ft.FT_Get_Char_Index(self._face, ord(char)))
            self._glyph_cache[char] = gid
        return gid

    def _load_unscaled(self, glyph_id: int) -> FT_GlyphSlotRec:
        _ft.FT_Set_Transform(self._face, None, None)
        err = _ft.FT_Load_Glyph(self._face, glyph_id, FT_LOAD_NO_SCALE)
        if err != 0:
            raise OSError(f"FT_Load_Glyph({glyph_id}) failed: error {err}")
        return self._face.contents.glyph.contents

    def advance(self, glyph_id: int) -> float:
        """Horizontal advance in font units (font-kit Font::advance().x)."""
        v = self._advance_cache.get(glyph_id)
        if v is None:
            slot = self._load_unscaled(glyph_id)
            v = float(slot.metrics.horiAdvance)
            self._advance_cache[glyph_id] = v
        return v

    def typographic_bounds(self, glyph_id: int) -> RectF:
        """Glyph metrics rect in font units, y-up (font-kit typographic_bounds)."""
        r = self._typo_cache.get(glyph_id)
        if r is None:
            m = self._load_unscaled(glyph_id).metrics
            r = RectF(
                float(m.horiBearingX),
                float(m.horiBearingY - m.height),
                float(m.horiBearingX + m.width),
                float(m.horiBearingY),
            )
            self._typo_cache[glyph_id] = r
        return r

    def raster_bounds(
        self,
        glyph_id: int,
        point_size: float,
        translation: tuple[float, float] = (0.0, 0.0),
        hinting: HintingOptions = HintingOptions(),
    ) -> RectI:
        """font-kit Loader::raster_bounds default implementation.

        round_out(transform * flip_y(typographic_bounds * size/upem)) — an
        integer rect in y-down raster space (reference main.rs:59-67).
        """
        del hinting  # bounds are metrics-derived, hinting does not enter
        scale = np.float32(point_size) / np.float32(self.metrics.units_per_em)
        rect = self.typographic_bounds(glyph_id).scale(float(scale)).flip_y()
        return rect.translate(*translation).round_out()

    # -- Rasterization ------------------------------------------------------

    def _set_size(self, point_size: float) -> None:
        if self._current_size != point_size:
            err = _ft.FT_Set_Char_Size(self._face, _to_f26dot6(point_size), 0, 72, 72)
            if err != 0:
                raise OSError(f"FT_Set_Char_Size({point_size}) failed: error {err}")
            self._current_size = point_size

    def rasterize_glyph(
        self,
        canvas: Canvas,
        glyph_id: int,
        point_size: float,
        translation: tuple[float, float],
        hinting: HintingOptions = HintingOptions(),
    ) -> None:
        """Rasterize one glyph into ``canvas`` (A8, grayscale AA).

        The glyph baseline origin lands at ``translation`` in y-down canvas
        coordinates, fractional positions honored at FreeType's native 1/64 px
        resolution — the semantics of font-kit's
        ``rasterize_glyph(canvas, gid, size, Transform2F::from_translation(t),
        hinting, GrayscaleAa)`` used throughout the reference
        (main.rs:73-83, 98-106; ncc.rs:184-194).

        Compositing uses saturating-max so overlapping glyphs in string
        rendering never erase each other's coverage.
        """
        self._set_size(point_size)
        tx, ty = translation
        delta = FT_Vector(_to_f26dot6(tx), _to_f26dot6(-ty))
        _ft.FT_Set_Transform(self._face, None, byref(delta))
        flags = hinting.flags_for(point_size) | FT_LOAD_NO_BITMAP
        err = _ft.FT_Load_Glyph(self._face, glyph_id, flags)
        if err != 0:
            raise OSError(f"FT_Load_Glyph({glyph_id}) failed: error {err}")
        slot = self._face.contents.glyph.contents
        err = _ft.FT_Render_Glyph(byref(slot), FT_RENDER_MODE_NORMAL)
        if err != 0:
            raise OSError(f"FT_Render_Glyph failed: error {err}")
        bmp = slot.bitmap
        rows, width, pitch = int(bmp.rows), int(bmp.width), int(bmp.pitch)
        if rows == 0 or width == 0:
            return
        assert bmp.pixel_mode == FT_PIXEL_MODE_GRAY, "expected 8-bit grayscale bitmap"
        buf = np.ctypeslib.as_array(bmp.buffer, shape=(rows * abs(pitch),))
        if pitch < 0:  # pragma: no cover - FT always renders top-down here
            img = buf.reshape(rows, -1)[::-1, :width]
        else:
            img = buf.reshape(rows, pitch)[:, :width]

        # Canvas placement: FT space is y-up with the baseline at y=0 after the
        # delta translation; bitmap_top is the distance from y=0 up to the top
        # row, so the canvas (y-down) position of the bitmap's top-left is
        # (bitmap_left, -bitmap_top).
        dst_x = int(slot.bitmap_left)
        dst_y = -int(slot.bitmap_top)

        # Clip to canvas.
        sx0 = max(0, -dst_x)
        sy0 = max(0, -dst_y)
        sx1 = min(width, canvas.width - dst_x)
        sy1 = min(rows, canvas.height - dst_y)
        if sx0 >= sx1 or sy0 >= sy1:
            return
        dx0, dy0 = dst_x + sx0, dst_y + sy0
        dst = canvas.pixels[dy0 : dy0 + (sy1 - sy0), dx0 : dx0 + (sx1 - sx0)]
        np.maximum(dst, img[sy0:sy1, sx0:sx1], out=dst)
