"""The port's page reader and writer (focr_tpu_torch/io/images.py) against
focr_tpu's Pillow-based load_gray, byte for byte.

Every case reads the same file twice through the port: once as it is here,
and once with Pillow blocked from import, as on the card's machine, which
has no Pillow. PNM: P1-P6 with comments, every value 0..maxval at maxvals
1, 15, 100, 254, 255, 256, 1000 and 65535. PNG (written here by a small
encoder, since Pillow writes neither every filter nor Adam7): every colour
type at every bit depth, each row filter on its own, Adam7, palettes with
and without tRNS, alpha. The host library's row unfiltering is held against
its plain NumPy version.
"""

import struct
import sys
import zlib

import numpy as np
import pytest

from focr_tpu.io.images import load_gray as jax_load_gray
from focr_tpu_torch.io import images as timages
from focr_tpu_torch.native.build import load_host

MAXVALS = [1, 15, 100, 254, 255, 256, 1000, 65535]
PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _read_both(path, monkeypatch):
    """(focr_tpu's decode, the port's decode with Pillow, the port's decode
    with Pillow blocked)."""
    want = jax_load_gray(str(path))
    got = timages.load_gray(str(path))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        m.setitem(sys.modules, "PIL.Image", None)
        got_nopil = timages.load_gray(str(path))
    return want, got, got_nopil


def _assert_same(path, monkeypatch):
    want, got, got_nopil = _read_both(path, monkeypatch)
    assert want.dtype == np.uint8 and got.dtype == np.uint8 and got_nopil.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_nopil, want)
    return want


# --- PNM ------------------------------------------------------------------


def _all_values(maxval, n_samples, rng):
    """n_samples values holding every value 0..maxval (as far as they fit),
    then seeded ones."""
    v = np.arange(maxval + 1)
    if len(v) < n_samples:
        v = np.concatenate([v, rng.integers(0, maxval + 1, n_samples - len(v))])
    return rng.permutation(v)[:n_samples] if len(v) > n_samples else v


def _pnm_shape(maxval, ch):
    n = max(maxval + 1, 60) // ch + 1
    W = 37 if n > 37 * 37 else 13
    return -(-n // W), W


@pytest.mark.parametrize("magic", ["P2", "P3", "P5", "P6"])
@pytest.mark.parametrize("maxval", MAXVALS)
def test_pnm_maxval_matches_focr_tpu(tmp_path, monkeypatch, magic, maxval):
    rng = np.random.default_rng(maxval)
    ch = 3 if magic in ("P3", "P6") else 1
    H, W = _pnm_shape(maxval, ch)
    v = _all_values(maxval, H * W * ch, rng)
    assert len(np.unique(v)) == min(maxval + 1, H * W * ch)
    head = f"{magic}\n# a comment line\n{W} {H}\n# another\n{maxval}\n".encode()
    if magic in ("P2", "P3"):
        lines = [" ".join(map(str, v[i : i + 17])) for i in range(0, len(v), 17)]
        body = ("\n".join(lines) + "\n").encode()
    else:
        body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    path = tmp_path / f"page.{magic}"
    path.write_bytes(head + body)
    want = _assert_same(path, monkeypatch)
    assert want.shape == (H, W)


def test_pnm_rescale_pins():
    """Pillow's conversions, value by value: maxval 15 -> L (1 -> 17, 7 ->
    119), maxval 1000 -> I (1 -> 66, 1000 -> 65535) then >> 8."""
    assert timages._rescale(np.array([1, 7, 15]), 15, 255).tolist() == [17, 119, 255]
    assert timages._rescale(np.array([1, 1000]), 1000, 65535).tolist() == [66, 65535]


@pytest.mark.parametrize("magic", ["P1", "P4"])
@pytest.mark.parametrize("W", [1, 8, 13, 29])
def test_pbm_matches_focr_tpu(tmp_path, monkeypatch, magic, W):
    rng = np.random.default_rng(W)
    H = 7
    bits = rng.integers(0, 2, (H, W), dtype=np.uint8)
    if magic == "P4":
        body = np.packbits(bits, axis=1).tobytes()
        head = f"P4\n# 1-bit page\n{W} {H}\n".encode()
    else:  # plain: digits may run together, and a comment may sit between rows
        rows = ["".join(map(str, r)) if k % 2 else " ".join(map(str, r))
                for k, r in enumerate(bits)]
        body = ("\n".join(rows[:3]) + "\n# mid-data\n" + "\n".join(rows[3:]) + "\n").encode()
        head = f"P1\n{W} {H}\n".encode()
    path = tmp_path / f"page.{magic}"
    path.write_bytes(head + body)
    want = _assert_same(path, monkeypatch)
    np.testing.assert_array_equal(want, (1 - bits) * 255)  # a 1 bit is black


def test_pnm_header_comments(tmp_path, monkeypatch):
    """Comments at every header position, CR line ends, and a comment inside
    a token (Pillow drops it and joins the token)."""
    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (9, 11), dtype=np.uint8)
    path = tmp_path / "c.pgm"
    path.write_bytes(b"P5 #x\r11#y\n #z\r9 2#w\n55\n" + gray.tobytes())
    np.testing.assert_array_equal(_assert_same(path, monkeypatch), gray)


def test_pnm_errors_raise(tmp_path):
    for name, data in [("trunc.pgm", b"P5\n4 4\n255\n" + bytes(15)),
                       ("maxval0.pgm", b"P5\n4 4\n0\n" + bytes(16)),
                       ("big.pgm", b"P2\n2 1\n15\n3 16\n"),
                       ("pbm.pbm", b"P1\n2 2\n0 1 2 0\n")]:
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError):
            timages.load_gray(str(tmp_path / name))


# --- PNG ------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return len(body).to_bytes(4, "big") + kind + body + zlib.crc32(kind + body).to_bytes(4, "big")


def _filter_rows(raw: np.ndarray, ftypes, bpp: int) -> bytes:
    """raw u8 [rows, stride] -> the filtered stream, row r with filter
    ftypes[r] (PNG §9, the predictors from the unfiltered bytes)."""
    rows, stride = raw.shape
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for r in range(rows):
        x = raw[r].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])[:stride]
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:stride]
        b = prev
        ft = ftypes[r]
        if ft == 0:
            pred = np.zeros(stride, np.int64)
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(ft)
        out += ((x - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = x
    return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """samples [h, w, ch] -> the rows' bytes [h, stride] at ``depth``."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, w * ch).astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(bits, axis=1)


def encode_png(samples, depth, ctype, filters=(0,), interlace=False, plte=None, trns=None):
    """A PNG of samples [H, W, ch] at ``depth``; row r of each pass takes
    filters[r % len(filters)]."""
    H, W, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    stream = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            rows = _pack(sub, depth)
            stream += _filter_rows(rows, [filters[r % len(filters)] for r in range(len(rows))], bpp)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(stream)
    out += _chunk(b"IDAT", z[: len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2 :])
    return out + _chunk(b"IEND", b"")


def _png_samples(ctype, depth, H, W, rng):
    """Seeded samples, every value of the depth present where they fit."""
    hi = (1 << depth) - 1
    ch = CHANNELS[ctype]
    v = _all_values(hi, H * W * ch, rng) if ctype != 3 else rng.integers(0, hi + 1, H * W)
    return v.reshape(H, W, ch)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", PNG_TYPES)
def test_png_matches_focr_tpu(tmp_path, monkeypatch, ctype, depth, interlace):
    rng = np.random.default_rng(16 * ctype + depth)
    H, W = (256, 256) if depth == 16 and ctype == 0 else (23, 37)
    samples = _png_samples(ctype, depth, H, W, rng)
    plte = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    path = tmp_path / "p.png"
    path.write_bytes(encode_png(samples, depth, ctype, filters=(0, 1, 2, 3, 4),
                                interlace=interlace, plte=plte))
    assert _assert_same(path, monkeypatch).shape == (H, W)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 8), (0, 16), (2, 8), (6, 16)])
def test_png_each_filter(tmp_path, monkeypatch, ftype, ctype, depth):
    rng = np.random.default_rng(ftype + 10 * depth)
    samples = _png_samples(ctype, depth, 19, 41, rng)
    path = tmp_path / "f.png"
    path.write_bytes(encode_png(samples, depth, ctype, filters=(ftype,)))
    _assert_same(path, monkeypatch)


@pytest.mark.parametrize("W,H", [(1, 1), (3, 2), (5, 9), (8, 8), (13, 17)])
def test_png_adam7_small_pages(tmp_path, monkeypatch, W, H):
    """Adam7 on pages small enough that some passes are empty."""
    rng = np.random.default_rng(W * H)
    samples = rng.integers(0, 256, (H, W, 3))
    path = tmp_path / "a.png"
    path.write_bytes(encode_png(samples, 8, 2, filters=(4, 3, 1), interlace=True))
    _assert_same(path, monkeypatch)


@pytest.mark.parametrize("case", ["plte-short", "trns-one", "trns-alphas", "gray-trns",
                                  "rgb-trns"])
def test_png_palette_and_transparency(tmp_path, monkeypatch, case):
    """Palettes shorter than the index range (an index past PLTE reads
    black in Pillow) and tRNS of every kind (dropped, as convert("RGB")
    drops it)."""
    rng = np.random.default_rng(len(case))
    H, W = 11, 17
    if case.startswith("plte") or case.startswith("trns"):
        samples = rng.integers(0, 256, (H, W, 1))
        n = 40 if case == "plte-short" else 256
        plte = rng.integers(0, 256, (n, 3))
        trns = {"plte-short": None, "trns-one": b"\xff\xff\x00\xff",
                "trns-alphas": bytes(rng.integers(0, 256, 60).astype(np.uint8))}[case]
        data = encode_png(samples, 8, 3, filters=(2,), plte=plte, trns=trns)
    elif case == "gray-trns":
        data = encode_png(rng.integers(0, 256, (H, W, 1)), 8, 0, trns=b"\x00\x07")
    else:
        data = encode_png(rng.integers(0, 65536, (H, W, 3)), 16, 2, trns=b"\x00\x01" * 3)
    path = tmp_path / "t.png"
    path.write_bytes(data)
    _assert_same(path, monkeypatch)


def test_png_bad_chunks_raise(tmp_path):
    rng = np.random.default_rng(0)
    good = encode_png(rng.integers(0, 256, (5, 6, 1)), 8, 0, filters=(1,))
    bad_crc = bytearray(good)
    bad_crc[40] ^= 0xFF  # inside the first IDAT's body
    cases = {"crc": bytes(bad_crc), "truncated": good[:-20]}
    raw = np.zeros((5, 7), np.uint8)
    raw[2, 0] = 9  # filter type 9
    cases["filter"] = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 5, 8, 0,
                                                                           0, 0, 0))
                       + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))
    for name, data in cases.items():
        (tmp_path / f"{name}.png").write_bytes(data)
        with pytest.raises(ValueError):
            timages.load_gray(str(tmp_path / f"{name}.png"))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_unfilter_native_matches_plain_version(bpp):
    """csrc/ncc_host.cpp::focr_png_unfilter against unfilter_reference on
    every filter type, mixed by row."""
    rng = np.random.default_rng(bpp)
    rows, stride = 40, 12 * bpp
    filtered = rng.integers(0, 256, (rows, stride + 1)).astype(np.uint8)
    filtered[:, 0] = rng.integers(0, 5, rows)
    filtered[0, 0] = 4
    out = np.empty((rows, stride), np.uint8)
    assert load_host().focr_png_unfilter(filtered.ctypes.data, rows, stride, bpp,
                                         out.ctypes.data) == -1
    np.testing.assert_array_equal(out, timages.unfilter_reference(filtered, bpp))
    np.testing.assert_array_equal(timages._unfilter(filtered, bpp), out)


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (662, 792)])
def test_saved_png_reads_back(tmp_path, monkeypatch, shape):
    """A PNG written by save_gray without Pillow reads back the same through
    Pillow (focr_tpu) and through the port."""
    gray = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "s.png"
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        timages.save_gray(str(path), gray)
    np.testing.assert_array_equal(_assert_same(path, monkeypatch), gray)
