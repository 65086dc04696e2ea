"""Template-bank disk cache.

Counterpart of focr_tpu/utils/cache.py: the rendered template banks are
cached on disk, keyed by every input that affects the rendered pixels (font
file content hash, size, kerning, hinting, alphabet, grid/box geometry). A
warm start skips the FreeType rasterization of every (cell, glyph) pair.

Layout: one .npz per bank under $FOCR_TPU_CACHE_DIR (default
~/.cache/focr_tpu_torch/banks), filename = sha256 of the canonicalized key.
The key's payload names this package, so a directory shared with focr_tpu is
safe: the port's banks carry other dtypes and fields, and neither package
ever reads the other's entries.

A saved focr bank set (fonts/bank.py::BankSet) keeps each crop height it
has decompressed here too, raw: one <key>.raw file, the height's members'
.npy bytes end to end, keyed by the set's settings, the height and each
member's name, CRC-32 and size as the set's zip directory records them, so a
moved file still hits and a rewritten one misses. A later process reads the
copy instead of running LZMA again, after checking every member's size and
CRC-32 against that record; a copy that fails the check is a miss and is
removed.

Disable both with FOCR_TPU_NO_BANK_CACHE=1. Writes are atomic (tmp + rename)
so concurrent processes can share a cache dir safely, and best effort: a
directory that cannot be written costs a miss, never the run.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import zlib

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
_RAW_FORMAT = 1  # bump when the layout of a raw copy (<key>.raw) changes


def _digest(payload: dict) -> str:
    text = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()


def bank_key(kind: str, font_path: str, **params) -> str:
    """Stable cache key: package + kind + font content hash + canonical
    param JSON."""
    return _digest({"package": _PACKAGE, "kind": kind, "v": _SEMVER,
                    "font": _font_hash(font_path), **params})


def members_key(kind: str, members: list[tuple[str, int, int]], **params) -> str:
    """Cache key of a raw copy: package + kind + format version + canonical
    param JSON + each member's (name, CRC-32, size)."""
    return _digest({"package": _PACKAGE, "kind": kind, "v": _RAW_FORMAT,
                    "members": [list(m) for m in members], **params})


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


def _store(name: str, write) -> None:
    """Write the entry ``name`` with ``write(file)``: tmp + rename, best
    effort."""
    d = cache_dir()
    if d is None:
        return
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                write(f)
            os.replace(tmp, os.path.join(d, name))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    except OSError:
        pass  # cache is best-effort; never fail the run over it


def store_arrays(key: str, arrays: dict[str, np.ndarray]) -> None:
    _store(key + ".npz", lambda f: np.savez(f, **arrays))


def load_members(key: str, members: list[tuple[str, int, int]]) -> list[memoryview] | None:
    """The raw copy ``key`` cut into ``members``, each checked against its
    (name, CRC-32, size); None on a miss. A copy of another length or with a
    member whose CRC-32 differs is removed."""
    d = cache_dir()
    if d is None:
        return None
    path = os.path.join(d, key + ".raw")
    try:
        with open(path, "rb") as f:
            data = memoryview(f.read())
    except OSError:  # missing or unreadable
        return None
    out, off = [], 0
    if len(data) == sum(size for _, _, size in members):
        for _, crc, size in members:
            part = data[off : off + size]
            if zlib.crc32(part) != crc:
                break
            out.append(part)
            off += size
        else:
            return out
    try:
        os.unlink(path)
    except OSError:
        pass
    return None


def store_members(key: str, parts: list[bytes]) -> None:
    """Write the raw copy ``key``: the members' bytes end to end."""
    _store(key + ".raw", lambda f: f.writelines(parts))
