"""Page I/O: PNM and PNG in NumPy and zlib, other formats through Pillow.

The counterpart of focr_tpu/io/images.py, which reads every page through
Pillow. The card's machine has no Pillow, so the port decodes the formats the
reference's image crate reads (png + pnm, Cargo.toml:10) itself and gives the
same bytes as focr_tpu's Pillow path, conversion for conversion:

  PNM  P1-P6 (plain and raw PBM, PGM, PPM), comments, any maxval 1..65535:
       a PBM 1 bit is black (mode "1" -> 0/255); a maxval other than 255 is
       rescaled as Pillow's PPM decoder does, round(v / maxval * out_max)
       with out_max 255, or 65535 for a gray maxval above 255 (mode "I",
       which focr_tpu then shifts right by 8); a raw 65535 is taken as is
  PNG  colour types 0, 2, 3, 4, 6 at every bit depth the format allows, the
       five row filters, Adam7 interlace, every chunk's CRC checked: gray
       below 8 bits scales to 0..255 (1 bit -> 0/255), 16-bit samples keep
       their high byte, palettes are looked up (black past PLTE), alpha
       and tRNS are dropped (focr_tpu's convert("RGB"))

RGB pages then decode with the image crate's integer Rec.709 luma (luma =
(2126*r + 7152*g + 722*b) / 10000, truncating), as in focr_tpu. The Average
and Paeth filters depend on the byte just decoded to their left, so a
filtered PNG is unfiltered in the ncc host library (csrc/ncc_host.cpp::
focr_png_unfilter); ``unfilter_reference`` is its plain NumPy version. Other
formats (JPEG, TIFF, ...) go through Pillow where it is installed and raise
where it is not. ``save_gray`` writes .pgm and .png itself, ``save_rgb`` and
``save_rgba`` .png (colour types 2 and 6).

Raw 8-bit gray pages (P5, maxval 255: what pdfimages writes) are not read:
``load_gray_many`` and ``load_gray_many_isolated`` map each such file
read-only and return a view of its raster, so the first copy of its pixels is
the decoder's crop (``map_gray``).

Batching (focr): pages are grouped into same-shape buckets, decoded a batch
at a time.
"""

from __future__ import annotations

import concurrent.futures as _futures
import ctypes
import functools
import mmap
import os
import re
import stat
import struct
import weakref
import zlib
from dataclasses import dataclass

import numpy as np

from focr_tpu_torch.utils.metrics import count

_PNM_WHITESPACE = b" \t\n\v\f\r"
_PNM_MAGIC = (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, the bit depths the format allows)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's seven passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _luma(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.uint32)
    luma = (2126 * rgb[..., 0] + 7152 * rgb[..., 1] + 722 * rgb[..., 2]) // 10000
    return luma.astype(np.uint8)


def _pnm_token(data: bytes, i: int, path: str) -> tuple[bytes, int]:
    """One header token from data[i:] as Pillow's PPM reader takes it: leading
    whitespace skipped, a '#' drops the rest of its line (even inside a
    token), and the one whitespace byte that ends the token is consumed.
    Returns (token, index after it)."""
    tok = bytearray()
    while len(tok) <= 10 and i < len(data):
        c = data[i]
        i += 1
        if c in _PNM_WHITESPACE:
            if tok:
                break
        elif c == 0x23:  # '#': to the end of the line, its CR or LF included
            while i < len(data) and data[i] not in b"\r\n":
                i += 1
            i += 1
        else:
            tok.append(c)
    if not tok:
        raise ValueError(f"{path}: PNM header ends early")
    if len(tok) > 10:
        raise ValueError(f"{path}: PNM header token too long")
    return bytes(tok), i


def _rescale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Pillow's min(out_max, round(v / maxval * out_max)): float64, ties to
    even (Python's round)."""
    return np.minimum(np.rint(v / np.float64(maxval) * out_max), out_max).astype(np.int64)


def _plain_values(body: bytes, need: int, path: str) -> np.ndarray:
    """The first ``need`` whitespace-separated integers of a plain PNM body,
    after Pillow's comment removal (a '#' through its line end, the end byte
    included)."""
    tokens = re.sub(rb"#[^\r\n]*[\r\n]?", b"", body).split()[:need]
    if len(tokens) < need:
        raise ValueError(f"{path}: PNM data truncated ({len(tokens)} < {need} values)")
    if any(len(t) > 10 for t in tokens):
        raise ValueError(f"{path}: PNM data token too long")
    try:
        v = np.array(tokens).astype(np.int64)
    except ValueError:
        raise ValueError(f"{path}: PNM data holds a value that is not an integer") from None
    if (v < 0).any():
        raise ValueError(f"{path}: PNM channel value is negative")
    return v


def _read_pnm(data: bytes, path: str) -> np.ndarray:
    """P1-P6 -> u8 [H, W] gray, as focr_tpu's load_gray gives it through
    Pillow (PpmImagePlugin)."""
    magic = data[:2]
    W, i = _pnm_token(data, 3, path)
    H, i = _pnm_token(data, i, path)
    W, H = int(W), int(H)
    if magic in (b"P1", b"P4"):
        if magic == b"P4":  # rows padded to whole bytes, MSB first, 1 = black
            rb = (W + 7) // 8
            if len(data) - i < H * rb:
                raise ValueError(f"{path}: PBM data truncated")
            bits = np.unpackbits(np.frombuffer(data, np.uint8, H * rb, i).reshape(H, rb), axis=1)
            return ((1 - bits[:, :W]) * 255).astype(np.uint8)
        chars = b"".join(re.sub(rb"#[^\r\n]*[\r\n]?", b"", data[i:]).split())[: H * W]
        if len(chars) < H * W:
            raise ValueError(f"{path}: PBM data truncated")
        if chars.translate(None, b"01"):
            raise ValueError(f"{path}: PBM data holds a token other than 0 and 1")
        return ((np.frombuffer(chars, np.uint8) == 0x30) * 255).astype(np.uint8).reshape(H, W)
    maxval_tok, i = _pnm_token(data, i, path)
    maxval = int(maxval_tok)
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: PNM maxval {maxval} outside 1..65535")
    ch = 3 if magic in (b"P3", b"P6") else 1
    # Pillow opens a gray maxval above 255 in mode "I" (0..65535), which
    # focr_tpu shifts right by 8; every other page in 0..255
    out_max = 65535 if ch == 1 and maxval > 255 else 255
    need = H * W * ch
    if magic in (b"P2", b"P3"):
        v = _plain_values(data[i:], need, path)
        if (v > maxval).any():
            raise ValueError(f"{path}: PNM channel value above maxval {maxval}")
        v = _rescale(v, maxval, out_max)
    else:
        wide = maxval > 255
        if len(data) - i < need * (1 + wide):
            raise ValueError(f"{path}: PNM data truncated")
        v = np.frombuffer(data, ">u2" if wide else np.uint8, need, i)
        if maxval not in (255, 65535) or (wide and ch == 3):
            v = _rescale(v, maxval, out_max)
    if out_max == 65535:
        v = v >> 8
    if ch == 1:
        return v.astype(np.uint8, copy=False).reshape(H, W)
    return _luma(v.reshape(H, W, 3))


def _png_chunks(data: bytes, path: str):
    """(type, body) of each PNG chunk, its CRC checked, through IEND."""
    i = len(_PNG_SIGNATURE)
    while i < len(data):
        if len(data) - i < 12:
            raise ValueError(f"{path}: PNG chunk truncated")
        n = int.from_bytes(data[i : i + 4], "big")
        if len(data) - i < 12 + n:
            raise ValueError(f"{path}: PNG chunk truncated")
        kind = data[i + 4 : i + 8]
        if zlib.crc32(data[i + 4 : i + 8 + n]) != int.from_bytes(data[i + 8 + n : i + 12 + n],
                                                                 "big"):
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, data[i + 8 : i + 8 + n]
        if kind == b"IEND":
            return
        i += 12 + n


def unfilter_reference(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """Plain NumPy version of csrc/ncc_host.cpp::focr_png_unfilter:
    filtered u8 [rows, 1 + stride] (each row's filter type, then its bytes)
    -> u8 [rows, stride], undoing None, Sub, Up, Average and Paeth (PNG §9)
    with the previous row taken as zeros above the first."""
    rows, stride = filtered.shape[0], filtered.shape[1] - 1
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(rows):
        ft, s = int(filtered[y, 0]), filtered[y, 1:]
        if ft == 0:
            row = s.copy()
        elif ft == 1:  # a running sum mod 256 of each of the bpp byte lanes
            row = np.cumsum(s.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:
            row = s + prev
        elif ft in (3, 4):
            row = np.zeros(stride, np.uint8)
            for x in range(stride):
                a = int(row[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[x] = (int(s[x]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y}: filter type {ft}")
        out[y] = prev = row
    return out


def _unfilter(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """unfilter_reference's result: rows that are all unfiltered need no
    work; any filtered row sends the pass to the host library."""
    if not filtered[:, 0].any():
        return filtered[:, 1:]
    from focr_tpu_torch.native.build import load_host

    rows, stride = filtered.shape[0], filtered.shape[1] - 1
    src = np.ascontiguousarray(filtered)
    out = np.empty((rows, stride), np.uint8)
    bad = load_host().focr_png_unfilter(src.ctypes.data, rows, stride, bpp, out.ctypes.data)
    if bad >= 0:
        raise ValueError(f"PNG row {bad}: filter type {int(filtered[bad, 0])}")
    return out


def _png_samples(raw: memoryview, w: int, h: int, depth: int, ch: int, path: str):
    """One pass of w x h pixels from the start of ``raw``: (samples [h, w,
    ch] uint8 or big-endian uint16, bytes consumed)."""
    stride = (w * ch * depth + 7) // 8
    n = h * (stride + 1)
    if len(raw) < n:
        raise ValueError(f"{path}: PNG image data truncated")
    filtered = np.frombuffer(raw, np.uint8, n).reshape(h, stride + 1)
    rows = _unfilter(filtered, max(1, ch * depth // 8))
    if depth == 16:
        return np.ascontiguousarray(rows).view(">u2").reshape(h, w, ch), n
    if depth == 8:
        return rows.reshape(h, w, ch), n
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)  # ch == 1 below 8 bits
    v = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
    return v[:, :w, None], n


def _read_png(data: bytes, path: str) -> np.ndarray:
    """PNG -> u8 [H, W] gray, as focr_tpu's load_gray gives it through
    Pillow (PngImagePlugin's modes, then its convert("RGB") where needed)."""
    ihdr, plte, idat = None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: bad PNG IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    W, H, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]:
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth {depth}")
    if comp or filt or interlace > 1 or W == 0 or H == 0:
        raise ValueError(f"{path}: unsupported PNG header {ihdr}")
    if ctype == 3 and (plte is None or len(plte) % 3):
        raise ValueError(f"{path}: PNG palette missing or malformed")
    ch = _PNG_TYPES[ctype][0]
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise ValueError(f"{path}: PNG image data: {e}") from None
    if not interlace:
        px = _png_samples(raw, W, H, depth, ch, path)[0]
    else:
        px = np.zeros((H, W, ch), ">u2" if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            w, h = max(0, -(-(W - x0) // dx)), max(0, -(-(H - y0) // dy))
            if w and h:
                px[y0::dy, x0::dx], n = _png_samples(raw[pos:], w, h, depth, ch, path)
                pos += n
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)  # an index past PLTE reads black, as in Pillow
        pal[: len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        return _luma(pal[px[..., 0]])
    if ctype in (2, 6):
        return _luma(px[..., :3])
    if depth < 8:  # Pillow's 1-bit "1", 2- and 4-bit "L;2"/"L;4" unpackers
        return (px[..., 0] * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return px[..., 0].copy()  # gray (with alpha: its gray channel)


def load_gray(path: str) -> np.ndarray:
    """Load an image as u8 grayscale [H, W] with image-crate-equivalent luma."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] in _PNM_MAGIC and len(data) > 2 and data[2] in _PNM_WHITESPACE:
        return _read_pnm(data, path)
    if data.startswith(_PNG_SIGNATURE):
        return _read_png(data, path)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: not a PNM or PNG image, and reading other formats needs "
            "Pillow, which is not installed"
        ) from None
    with Image.open(path) as im:
        if im.mode in ("L",):
            return np.asarray(im, dtype=np.uint8)
        if im.mode in ("I;16", "I"):
            arr = np.asarray(im)
            return (arr >> 8).astype(np.uint8)
        if im.mode == "1":
            return (np.asarray(im, dtype=np.uint8) * 255).astype(np.uint8)
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint32)
    return _luma(rgb)


_MAP_FAILED = ctypes.c_void_p(-1).value


@functools.cache
def _libc() -> ctypes.CDLL:
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_long)
    libc.mmap.restype = ctypes.c_void_p
    libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
    libc.munmap.restype = ctypes.c_int
    return libc


def _map_file(fd: int, size: int) -> ctypes.Array:
    """The first ``size`` bytes of the open file ``fd`` mapped read-only, as a
    ctypes byte array; unmapped when the array is collected. libc's mmap holds
    no descriptor of its own (Python's mmap.mmap keeps a duplicate of each
    file's), so the caller closes ``fd`` at once. MAP_POPULATE (where the
    platform has it) maps every page of the file in the one call, so reading
    the map later takes no page fault. Raises OSError where the map fails
    (ENOMEM past the process's map count, for one)."""
    libc = _libc()
    flags = mmap.MAP_PRIVATE | getattr(mmap, "MAP_POPULATE", 0)
    addr = libc.mmap(None, size, mmap.PROT_READ, flags, fd, 0)
    if addr is None or addr == _MAP_FAILED:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err))
    buf = (ctypes.c_ubyte * size).from_address(addr)
    # not at exit: a view still alive then must stay readable; the OS unmaps it with the process
    weakref.finalize(buf, libc.munmap, addr, size).atexit = False
    return buf


def map_gray(path: str) -> np.ndarray | None:
    """A raw 8-bit gray page (P5, maxval 255) as a read-only u8 [H, W] view of
    its file mapped into memory, the bytes load_gray gives; None where the
    file is not a regular, non-empty file holding such a page with its whole
    raster, or where the map fails: load_gray then reads it, and raises what
    it raises. The map lives as long as the last view of the page; no file
    descriptor is held. A page file truncated by another process while its
    view lives ends the process with SIGBUS, as with any reader that maps its
    input."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        st = os.fstat(fd)
        if not stat.S_ISREG(st.st_mode) or st.st_size < 3:
            return None
        buf = _map_file(fd, st.st_size)
    except OSError:
        return None
    finally:
        os.close(fd)
    data = memoryview(buf).toreadonly().cast("B")
    if data[:2] != b"P5" or data[2] not in _PNM_WHITESPACE:
        return None
    try:
        W, i = _pnm_token(data, 3, path)
        H, i = _pnm_token(data, i, path)
        maxval, i = _pnm_token(data, i, path)
        W, H, maxval = int(W), int(H), int(maxval)
    except ValueError:
        return None
    if maxval != 255 or W <= 0 or H <= 0 or len(data) - i < H * W:
        return None
    return np.frombuffer(data, np.uint8, H * W, i).reshape(H, W)


def _map_pages(paths: list[str]) -> tuple[list[np.ndarray | None], list[int]]:
    """Each page that map_gray maps, on the calling thread, and the indices of
    the rest, ascending; counts the pages mapped."""
    pages = [map_gray(p) for p in paths]
    rest = [k for k, page in enumerate(pages) if page is None]
    count("pages_mapped", len(paths) - len(rest))
    return pages, rest


def _read_each(fn, paths: list[str], max_workers: int) -> list:
    """fn over paths, in order: on the calling thread for one path, else on a
    pool of threads (file reads, zlib and NumPy release the GIL)."""
    if len(paths) <= 1:
        return [fn(p) for p in paths]
    with _futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(fn, paths))


def load_gray_many(paths: list[str], max_workers: int = 8) -> list[np.ndarray]:
    """Page loader: raw 8-bit gray pages mapped (map_gray), the rest read by
    load_gray on a pool of threads (the reference's rayon page fan-out for the
    I/O stage, main.rs:442-448); the first unreadable page raises. Counts the
    pages mapped and the pages read."""
    pages, rest = _map_pages(paths)
    for k, page in zip(rest, _read_each(load_gray, [paths[k] for k in rest], max_workers)):
        pages[k] = page
    count("pages_decoded", len(rest))
    return pages


def load_gray_many_isolated(
    paths: list[str], max_workers: int = 8
) -> tuple[list[np.ndarray | None], list[tuple[int, str]]]:
    """Fault-isolating page loader: a bad page yields None for its slot plus
    an (index, error) record instead of killing the whole batch (the
    reference panics on the first unreadable page, main.rs:448). Raw 8-bit
    gray pages are mapped as in load_gray_many; counts the pages mapped and
    the pages read."""

    def one(path: str):
        try:
            return load_gray(path), None
        except Exception as e:  # noqa: BLE001 - isolate any per-page failure
            return None, f"{type(e).__name__}: {e}"

    pages, rest = _map_pages(paths)
    errors = []
    for k, (page, err) in zip(rest, _read_each(one, [paths[k] for k in rest], max_workers)):
        pages[k] = page
        if err is not None:
            errors.append((k, err))
    count("pages_decoded", len(rest) - len(errors))
    return pages, errors


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (len(body).to_bytes(4, "big") + kind + body
            + zlib.crc32(kind + body).to_bytes(4, "big"))


def _save_png(path: str, img: np.ndarray, channels: int, colour_type: int, mode: str) -> None:
    """Write u8 [H, W] (channels == 1) or [H, W, channels] as an 8-bit PNG of
    ``colour_type`` (one IDAT, every row unfiltered) for a .png path, through
    Pillow (its ``mode``) for any other."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim < 2 or img.shape[2:] != ((channels,) if channels > 1 else ()):
        raise ValueError(f"{path}: a {mode} image of shape {img.shape}")
    H, W = img.shape[:2]
    if path.lower().endswith(".png"):
        rows = np.zeros((H, W * channels + 1), np.uint8)
        rows[:, 1:] = img.reshape(H, W * channels)
        with open(path, "wb") as f:
            f.write(_PNG_SIGNATURE
                    + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour_type, 0, 0, 0))
                    + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
                    + _png_chunk(b"IEND", b""))
        return
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: writing anything but .pgm and .png needs Pillow, which is not installed"
        ) from None
    Image.fromarray(img, mode=mode).save(path)


def save_gray(path: str, img: np.ndarray) -> None:
    """Write u8 [H, W]: binary PGM for a .pgm path, 8-bit gray PNG (one
    IDAT, every row unfiltered) for a .png path, Pillow otherwise."""
    if path.lower().endswith(".pgm"):
        img = np.ascontiguousarray(img, dtype=np.uint8)
        H, W = img.shape
        with open(path, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (W, H))
            f.write(img.tobytes())
        return
    _save_png(path, img, 1, 0, "L")


def save_rgb(path: str, img: np.ndarray) -> None:
    """Write u8 [H, W, 3]: 8-bit truecolour PNG (colour type 2) for a .png
    path, Pillow otherwise (focr_tpu/io/images.py:74-75)."""
    _save_png(path, img, 3, 2, "RGB")


def save_rgba(path: str, img: np.ndarray) -> None:
    """Write u8 [H, W, 4]: 8-bit truecolour PNG with alpha (colour type 6)
    for a .png path, Pillow otherwise (focr_tpu/io/images.py:78-79)."""
    _save_png(path, img, 4, 6, "RGBA")


@dataclass(frozen=True)
class Bucket:
    """Pages sharing one (H, W) shape. The pages are not stacked: the
    decoder crops each one where it lies (a mapped page: in its file's map)."""

    shape: tuple[int, int]
    indices: list[int]  # original page indices, in order
    pages: list[np.ndarray]  # the bucket's [H, W] u8 pages, in order


def bucket_pages(pages: list[np.ndarray]) -> list[Bucket]:
    """Group pages by shape, in order of each shape's first page."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(pages):
        groups.setdefault(p.shape, []).append(i)
    return [Bucket(shape=shape, indices=idxs, pages=[pages[i] for i in idxs])
            for shape, idxs in groups.items()]
