"""Template-bank disk cache.

Counterpart of focr_tpu/utils/cache.py: the rendered template banks are
cached on disk, keyed by every input that affects the rendered pixels (font
file content hash, size, kerning, hinting, alphabet, grid/box geometry). A
warm start skips the FreeType rasterization of every (cell, glyph) pair.

Layout: one .npz per bank under $FOCR_TPU_CACHE_DIR (default
~/.cache/focr_tpu_torch/banks), filename = sha256 of the canonicalized key.
The key's payload names this package, so a directory shared with focr_tpu is
safe: the port's banks carry other dtypes and fields, and neither package
ever reads the other's entries. Disable with FOCR_TPU_NO_BANK_CACHE=1. Writes
are atomic (tmp + rename) so concurrent processes can share a cache dir
safely.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

_FONT_HASHES: dict[tuple[str, int, int], str] = {}


def _font_hash(path: str) -> str:
    """sha256 of the font file content, memoized on (path, size, mtime)."""
    st = os.stat(path)
    memo_key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    h = _FONT_HASHES.get(memo_key)
    if h is None:
        with open(path, "rb") as f:
            h = hashlib.sha256(f.read()).hexdigest()
        _FONT_HASHES[memo_key] = h
    return h


def cache_dir() -> str | None:
    if os.environ.get("FOCR_TPU_NO_BANK_CACHE"):
        return None
    d = os.environ.get("FOCR_TPU_CACHE_DIR")
    if d is None:
        home = os.path.expanduser("~")
        d = os.path.join(home, ".cache", "focr_tpu_torch", "banks")
    return d


_PACKAGE = "focr_tpu_torch"  # in every key: entries are this package's own
_SEMVER = 2  # bump when rasterization semantics change (v2: f26.6 ties-away)


def bank_key(kind: str, font_path: str, **params) -> str:
    """Stable cache key: package + kind + font content hash + canonical
    param JSON."""
    payload = json.dumps(
        {"package": _PACKAGE, "kind": kind, "v": _SEMVER, "font": _font_hash(font_path),
         **params},
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def load_arrays(key: str) -> dict[str, np.ndarray] | None:
    d = cache_dir()
    if d is None:
        return None
    path = os.path.join(d, key + ".npz")
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except FileNotFoundError:
        return None
    except Exception:  # noqa: BLE001 - corrupt/truncated cache entry (e.g.
        # zipfile.BadZipFile after a crash mid-write): treat as a miss and
        # remove it so the rebuild can overwrite — never fail the run
        try:
            os.unlink(path)
        except OSError:
            pass
        return None


def store_arrays(key: str, arrays: dict[str, np.ndarray]) -> None:
    d = cache_dir()
    if d is None:
        return
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, os.path.join(d, key + ".npz"))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    except OSError:
        pass  # cache is best-effort; never fail the run over it
