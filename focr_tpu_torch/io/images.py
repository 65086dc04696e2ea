"""Page I/O: binary PGM/PPM in NumPy, other formats through Pillow.

The counterpart of focr_tpu/io/images.py. PGM (P5) and PPM (P6) are what
`pdfimages` writes by default and need no imaging library, so the port reads
and writes them itself; PNG and the rest go through Pillow where it is
installed. RGB pages decode with the image crate's integer Rec.709 luma
(luma = (2126*r + 7152*g + 722*b) / 10000, truncating), as in focr_tpu.

Batching (focr): pages are grouped into same-shape buckets, decoded a batch
at a time.
"""

from __future__ import annotations

import concurrent.futures as _futures
from dataclasses import dataclass

import numpy as np

_PNM_WHITESPACE = b" \t\r\n\v\f"


def _luma(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.uint32)
    luma = (2126 * rgb[..., 0] + 7152 * rgb[..., 1] + 722 * rgb[..., 2]) // 10000
    return luma.astype(np.uint8)


def _read_pnm(data: bytes, path: str) -> np.ndarray:
    """Binary P5 (gray) / P6 (RGB) with maxval 255 -> u8 [H, W] gray."""
    magic = data[:2]
    fields: list[int] = []
    i = 2
    while len(fields) < 3:
        while i < len(data) and data[i] in _PNM_WHITESPACE:
            i += 1
        if i < len(data) and data[i] == ord("#"):  # comment to end of line
            while i < len(data) and data[i] not in b"\r\n":
                i += 1
            continue
        j = i
        while j < len(data) and data[j] not in _PNM_WHITESPACE:
            j += 1
        if j == i:
            raise ValueError(f"{path}: truncated PNM header")
        fields.append(int(data[i:j]))
        i = j
    i += 1  # the single whitespace byte that ends the header
    W, H, maxval = fields
    if maxval != 255:
        raise ValueError(f"{path}: PNM maxval {maxval} is not supported (only 255)")
    ch = 1 if magic == b"P5" else 3
    need = H * W * ch
    if len(data) - i < need:
        raise ValueError(f"{path}: PNM data truncated ({len(data) - i} < {need} bytes)")
    px = np.frombuffer(data, np.uint8, need, i)
    if ch == 1:
        return px.reshape(H, W).copy()
    return _luma(px.reshape(H, W, 3))


def load_gray(path: str) -> np.ndarray:
    """Load an image as u8 grayscale [H, W] with image-crate-equivalent luma."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] in (b"P5", b"P6"):
        return _read_pnm(data, path)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: not a binary PGM/PPM, and reading other formats needs "
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


def load_gray_many(paths: list[str], max_workers: int = 8) -> list[np.ndarray]:
    """Threaded page loader (file reads and Pillow's decode release the GIL).

    Replaces the reference's rayon page fan-out for the I/O stage
    (main.rs:442-448); the first unreadable page raises.
    """
    if len(paths) <= 1:
        return [load_gray(p) for p in paths]
    with _futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(load_gray, paths))


def load_gray_many_isolated(
    paths: list[str], max_workers: int = 8
) -> tuple[list[np.ndarray | None], list[tuple[int, str]]]:
    """Fault-isolating page loader: a bad page yields None for its slot plus
    an (index, error) record instead of killing the whole batch (the
    reference panics on the first unreadable page, main.rs:448)."""

    def one(path: str):
        try:
            return load_gray(path), None
        except Exception as e:  # noqa: BLE001 - isolate any per-page failure
            return None, f"{type(e).__name__}: {e}"

    with _futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        results = list(ex.map(one, paths))
    pages = [r[0] for r in results]
    errors = [(i, r[1]) for i, r in enumerate(results) if r[1] is not None]
    return pages, errors


def save_gray(path: str, img: np.ndarray) -> None:
    """Write u8 [H, W]: binary PGM for a .pgm path, Pillow otherwise."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if path.lower().endswith(".pgm"):
        H, W = img.shape
        with open(path, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (W, H))
            f.write(img.tobytes())
        return
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: writing anything but .pgm needs Pillow, which is not installed"
        ) from None
    Image.fromarray(img, mode="L").save(path)


@dataclass(frozen=True)
class Bucket:
    """Pages sharing one (H, W) shape, batched into a single array."""

    shape: tuple[int, int]
    indices: list[int]  # original page indices, in order
    pages: np.ndarray  # [B, H, W] u8


def bucket_pages(pages: list[np.ndarray]) -> list[Bucket]:
    """Group pages by shape, in order of each shape's first page."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(pages):
        groups.setdefault(p.shape, []).append(i)
    return [
        Bucket(shape=shape, indices=idxs, pages=np.stack([pages[i] for i in idxs], axis=0))
        for shape, idxs in groups.items()
    ]
