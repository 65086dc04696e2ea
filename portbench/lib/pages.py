"""The benchmark's inputs, made from ``--seed``: pages assembled from real
line renders, a pool of them written as PGM files, and the documents the
calls take from the pool.

A configuration's ``data`` file holds real FreeType renders of whole pages
whose text lines sit on a fixed pitch (``bands``: the first line's top row,
the pitch, the number of lines, the rows a line's ink may take). Cutting
every page at that pitch gives line bands; a page of the pool is a white page
with a band drawn at random into each of its inked line slots. A band keeps
its page's columns, so it sits on the page exactly where a render would put
it, and every page is a real render of its lines. A traffic mix says which
line slots are inked (``inked``: "all", or ``{"always": [...], "random": k}``
for the listed slots plus k others drawn from the rest), how many distinct
pages the pool holds and how many pages a call takes.
"""

from __future__ import annotations

import os

import numpy as np

WHITE = 255


def cut_bands(pages: np.ndarray, bands: dict) -> np.ndarray:
    """[N, H, W] renders -> [N * lines, pitch, W] line bands. Raises unless
    every band's ink lies in its first ``ink_rows`` rows and nothing outside
    the bands is inked, so a band moved to another slot carries all its
    line's ink and nothing of its neighbours'."""
    y0, pitch, lines, ink_rows = (bands[k] for k in ("y0", "pitch", "lines", "ink_rows"))
    y1 = y0 + pitch * lines
    if (pages[:, :y0] != WHITE).any() or (pages[:, y1:] != WHITE).any():
        raise ValueError("ink outside the line bands")
    cut = pages[:, y0:y1].reshape(len(pages) * lines, pitch, pages.shape[2])
    if (cut[:, ink_rows:] != WHITE).any():
        raise ValueError(f"a line's ink reaches past its first {ink_rows} rows")
    if not (cut[:, :ink_rows] != WHITE).any(axis=(1, 2)).all():
        raise ValueError("a line band holds no ink")
    return cut


def inked_slots(rng: np.random.Generator, lines: int, inked) -> np.ndarray:
    """The line slots of one page that get a band, ascending."""
    if inked == "all":
        return np.arange(lines)
    always = [s % lines for s in inked.get("always", [])]
    rest = np.setdiff1d(np.arange(lines), always)
    drawn = rng.choice(rest, size=inked["random"], replace=False)
    return np.sort(np.concatenate([always, drawn]).astype(np.int64))


def make_pool(source: np.ndarray, bands: dict, traffic: dict, seed: int) -> np.ndarray:
    """``traffic["pool_pages"]`` distinct pages [P, H, W] u8 from ``seed``."""
    cut = cut_bands(source, bands)
    H, W = source.shape[1:]
    y0, pitch, lines = bands["y0"], bands["pitch"], bands["lines"]
    rng = np.random.default_rng([seed, 0])
    pool = np.full((traffic["pool_pages"], H, W), WHITE, np.uint8)
    seen = set()
    for k in range(len(pool)):
        while True:
            slots = inked_slots(rng, lines, traffic["inked"])
            picks = rng.choice(len(cut), size=len(slots), replace=False)
            key = (tuple(slots), tuple(picks))
            if key not in seen:
                seen.add(key)
                break
        for s, b in zip(slots, picks):
            pool[k, y0 + s * pitch : y0 + (s + 1) * pitch] = cut[b]
    return pool


def documents(traffic: dict, seed: int):
    """The calls' documents, endlessly: each an array of pool indices, the
    same sequence for the same seed."""
    rng = np.random.default_rng([seed, 1])
    n, P = traffic["pages_per_call"], traffic["pool_pages"]
    while True:
        yield rng.choice(P, size=n, replace=False)


def write_pgm(path: str, page: np.ndarray) -> None:
    """A binary 8-bit gray PGM (P5), the form pdfimages writes."""
    H, W = page.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{W} {H}\n255\n".encode())
        f.write(np.ascontiguousarray(page, np.uint8).tobytes())


def write_pool(pool: np.ndarray, where: str) -> list[str]:
    paths = []
    for k, page in enumerate(pool):
        paths.append(os.path.join(where, f"page{k:04d}.pgm"))
        write_pgm(paths[-1], page)
    return paths
