"""Raw 8-bit gray pages mapped, not read (focr_tpu_torch/io/images.py::
map_gray, load_gray_many, load_gray_many_isolated), and the decoder's crops
taken straight from the maps (models/focr.py::crop_strips, inked_strips).

A mapped page holds the bytes of the port's reader and of focr_tpu's
load_gray, is read-only, holds no file descriptor and is unmapped with its
last view; every other page, and any page whose map fails, is read as
before, with the same errors. The crops over a list of mapped pages are the
stacked formulas they replaced, written out here, byte for byte, and the
CLI's stdout is focr_tpu's."""

import errno
import gc
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from focr_tpu.cli.focr import main as jax_main
from focr_tpu.fonts.ft import Face
from focr_tpu.io.images import load_gray as jax_load_gray
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions
from focr_tpu_torch.cli.focr import main as torch_main
from focr_tpu_torch.io import images as timages
from focr_tpu_torch.models import focr as tfocr
from focr_tpu_torch.models.types import DecodeOptions as TDecodeOptions
from focr_tpu_torch.utils.metrics import COUNTERS, reset_counters
from tests.test_focr_oracle import width_for_cells
from tests.test_torch_images import encode_png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _p5(path, page, header=None):
    H, W = page.shape
    with open(path, "wb") as f:
        f.write(header if header is not None else b"P5\n%d %d\n255\n" % (W, H))
        f.write(np.ascontiguousarray(page, np.uint8).tobytes())
    return str(path)


def _maps_of(path):
    """The lines of this process's memory map that map ``path``."""
    with open("/proc/self/maps") as f:
        return [ln for ln in f if ln.rstrip().endswith(os.path.realpath(path))]


# --- what is mapped, and what it holds --------------------------------------

HEADERS = {
    "plain": None,
    "comments": b"P5 # a comment\n# another, before the width\n%(W)d\t%(H)d #x\n255\n",
    "crlf": b"P5\r\n%(W)d %(H)d\r\n255\r",
    "padded-tokens": b"P5\n  %(W)d\n\n%(H)d   0255\n",
}


@pytest.mark.parametrize("shape", [(7, 13), (1, 21), (19, 1), (33, 31)],
                         ids=["odd-width", "one-row", "one-column", "odd-both"])
@pytest.mark.parametrize("header", list(HEADERS))
def test_a_mapped_page_is_the_read_one(tmp_path, shape, header):
    """map_gray's view holds the bytes of the port's reader and of focr_tpu's
    load_gray, at every header form the reader takes."""
    page = np.random.default_rng(hash(shape) % 2**32).integers(0, 256, shape, dtype=np.uint8)
    H, W = shape
    raw = HEADERS[header]
    path = _p5(tmp_path / "p.pgm", page, None if raw is None else raw % {b"W": W, b"H": H})
    got = timages.map_gray(path)
    assert got is not None and got.dtype == np.uint8 and got.shape == shape
    assert got.tobytes() == timages.load_gray(path).tobytes() == jax_load_gray(path).tobytes()
    assert got.tobytes() == page.tobytes()


def test_a_mapped_page_is_read_only(tmp_path):
    path = _p5(tmp_path / "p.pgm", np.zeros((4, 5), np.uint8))
    page = timages.map_gray(path)
    with pytest.raises(ValueError, match="read-only"):
        page[0, 0] = 1
    with pytest.raises(ValueError):
        page.flags.writeable = True
    for view in (page[1:], page.T, page[None], page.reshape(-1)):
        assert not view.flags.writeable
    assert timages.load_gray(path).tobytes() == bytes(20)


def _pnm(magic, maxval, page):
    H, W = page.shape
    if magic == b"P2":
        body = " ".join(map(str, page.reshape(-1).tolist())).encode()
    elif maxval > 255:
        body = page.astype(">u2").tobytes()
    else:
        body = page.tobytes()
    return b"%s\n%d %d\n%d\n" % (magic, W, H, maxval) + body


def _others(rng):
    """Pages the map leaves to the reader: {name: file bytes}."""
    g = rng.integers(0, 200, (6, 9), dtype=np.uint8)
    bits = rng.integers(0, 2, (6, 9), dtype=np.uint8)
    return {
        "P2": _pnm(b"P2", 255, g),
        "P5-maxval-200": _pnm(b"P5", 200, g),
        "P5-maxval-65535": _pnm(b"P5", 65535, g.astype(np.uint16) * 257),
        "P6": b"P6\n9 6\n255\n" + rng.integers(0, 256, (6, 9, 3), dtype=np.uint8).tobytes(),
        "PBM": b"P4\n9 6\n" + np.packbits(bits, axis=1).tobytes(),
        "PNG": encode_png(g[..., None], 8, 0),
    }


@pytest.mark.parametrize("name", ["P2", "P5-maxval-200", "P5-maxval-65535", "P6", "PBM", "PNG"])
def test_other_pages_take_the_read_path(tmp_path, name):
    """Every page but a raw maxval-255 PGM is read, as focr_tpu reads it, and
    counted in pages_decoded; the raw PGM beside it is mapped."""
    path = tmp_path / f"page.{name.lower()}"
    path.write_bytes(_others(np.random.default_rng(3))[name])
    mapped = _p5(tmp_path / "beside.pgm", np.full((6, 9), 7, np.uint8))
    assert timages.map_gray(str(path)) is None
    for loader in (timages.load_gray_many, lambda ps: timages.load_gray_many_isolated(ps)[0]):
        reset_counters()
        pages = loader([str(path), mapped, str(path)])
        assert COUNTERS == {"pages_mapped": 1, "pages_decoded": 2}
        assert np.array_equal(pages[0], jax_load_gray(str(path)))
        assert np.array_equal(pages[2], pages[0]) and pages[0].flags.writeable
        assert not pages[1].flags.writeable and pages[1].tobytes() == bytes([7]) * 54


def _old_loaders(monkeypatch):
    """The loaders as they were: every page read by load_gray."""
    monkeypatch.setattr(timages, "map_gray", lambda path: None)


BAD = {
    "empty": b"",
    "truncated-P5": b"P5\n9 6\n255\n" + bytes(53),
    "header-only": b"P5\n9 6\n",
    "token-too-long": b"P5\n123456789012 6\n255\n",
}


@pytest.mark.parametrize("bad", list(BAD))
@pytest.mark.parametrize("strict", [False, True], ids=["isolated", "strict"])
def test_bad_pages_fail_as_before(tmp_path, capsys, monkeypatch, mono_font_path, bad, strict):
    """A bad page's error, its `ERROR <path>:` line and --strict's exception
    are those of the loaders that read every page; the good pages' stdout is
    unchanged."""
    (tmp_path / "bad.pgm").write_bytes(BAD[bad])
    good = _p5(tmp_path / "good.pgm", np.full((30, 40), 255, np.uint8))
    paths = [good, str(tmp_path / "bad.pgm"), good]
    argv = ["-i", *paths, "-f", mono_font_path, "-t", "13", "-w", "30", "--line-height", "12",
            "--line-advance", "15", "--device", "cpu", *(["--strict"] if strict else [])]
    runs = []
    for old in (False, True):
        with monkeypatch.context() as m:
            if old:
                _old_loaders(m)
            if strict:
                with pytest.raises(Exception) as exc:
                    torch_main(argv)
                runs.append((type(exc.value), str(exc.value)))
                with pytest.raises(type(exc.value), match="^" + re.escape(str(exc.value))):
                    timages.load_gray_many(paths)
            else:
                assert torch_main(argv) == 0
                runs.append(capsys.readouterr())
                pages, errors = timages.load_gray_many_isolated(paths)
                runs.append(([p is None for p in pages], errors))
    assert runs[: len(runs) // 2] == runs[len(runs) // 2 :]
    if not strict:
        assert runs[0].err.startswith(f"ERROR {paths[1]}: ") and runs[0].err.count("\n") == 1
        assert runs[1][0] == [False, True, False] and [i for i, _ in runs[1][1]] == [1]


def test_a_failed_map_reads_the_page(tmp_path, monkeypatch, capsys, mono_font_path):
    """A map that fails (ENOMEM past the process's map count) reads the page:
    the same pixels, counted as decoded, and the same stdout."""
    face, ropts = Face(mono_font_path), RenderOptions(size=13.0)
    width = width_for_cells(face, ropts, 6)
    dopts = DecodeOptions(x_start=5, y_start=6, width=width, line_height=12, line_advance=15)
    page = synthesize_page(face, ["Abc123", "x=yz"], dopts, ropts, FOCR_DEFAULT_ALPHABET, (60, 80))
    paths = [_p5(tmp_path / f"p{k}.pgm", page) for k in range(3)]
    argv = ["-i", *paths, "-f", mono_font_path, "-t", "13", "-x", "5", "-y", "6", "-w",
            str(width), "--line-height", "12", "--line-advance", "15", "--device", "cpu"]
    assert torch_main(argv) == 0
    want = capsys.readouterr().out

    def fail(fd, size):
        raise OSError(errno.ENOMEM, os.strerror(errno.ENOMEM))

    monkeypatch.setattr(timages, "_map_file", fail)
    reset_counters()
    pages = timages.load_gray_many(paths)
    assert COUNTERS == {"pages_mapped": 0, "pages_decoded": 3}
    assert all(np.array_equal(p, page) for p in pages)
    assert torch_main(argv) == 0
    assert capsys.readouterr().out == want and "Abc123" in want


_FD_SCRIPT = """
import gc, json, os, resource, sys
sys.path.insert(0, sys.argv[1])
from focr_tpu_torch.io.images import load_gray_many_isolated
from focr_tpu_torch.utils.metrics import COUNTERS
soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
resource.setrlimit(resource.RLIMIT_NOFILE, (64, hard))
paths = sys.argv[2:]
pages, errors = load_gray_many_isolated(paths)
fds = len(os.listdir("/proc/self/fd"))
with open("/proc/self/maps") as f:
    maps = sum(ln.rstrip().endswith(".pgm") for ln in f)
ok = all(int(p[0, 0]) == k % 251 for k, p in enumerate(pages))
del pages
gc.collect()
with open("/proc/self/maps") as f:
    left = sum(ln.rstrip().endswith(".pgm") for ln in f)
print(json.dumps({"errors": errors, "counters": COUNTERS, "fds": fds, "maps": maps,
                  "left": left, "ok": ok}))
"""


def test_two_hundred_maps_under_64_descriptors(tmp_path):
    """A process whose soft descriptor limit is 64 maps 200 pages and keeps
    them all: no EMFILE, no descriptor held a page, and no map left once the
    pages are dropped."""
    paths = [_p5(tmp_path / f"p{k:03d}.pgm", np.full((3, 4), k % 251, np.uint8))
             for k in range(200)]
    proc = subprocess.run([sys.executable, "-c", _FD_SCRIPT, REPO, *paths], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["errors"] == [] and got["ok"]
    assert got["counters"] == {"pages_mapped": 200, "pages_decoded": 0}
    assert got["fds"] < 64 and got["maps"] == 200 and got["left"] == 0


def test_the_maps_go_with_the_last_view(tmp_path):
    """A page's map lives while any view of it does (a bucket's list, a
    batch's slice, a strided crop view), and is gone once they are dropped."""
    path = _p5(tmp_path / "p.pgm", np.arange(600, dtype=np.uint8).reshape(20, 30))
    pages = timages.load_gray_many([path, path])
    assert len(_maps_of(path)) == 2
    bucket = timages.bucket_pages(pages)[0]
    view = tfocr._grid_view(bucket.pages[1], (0, 5), 3, 2, 10)
    del pages, bucket
    gc.collect()
    assert len(_maps_of(path)) == 1
    assert view[1, 0, 0] == 5 * 30 + 2
    del view
    gc.collect()
    assert _maps_of(path) == []


# --- the crops over mapped pages --------------------------------------------


def _old_crop(pages, ys, crop_h, x0, crop_w):
    """crop_strips as it was, over a stacked [B, H, W] batch."""
    B, H, W = pages.shape
    out = np.empty((B, len(ys), crop_h, crop_w), dtype=np.uint8)
    for ri, y in enumerate(ys):
        h = min(crop_h, H - y)
        out[:, ri, :h] = pages[:, y : y + h, x0 : x0 + crop_w]
        if h < crop_h:
            out[:, ri, h:] = 255
    return out


def _old_strips(pages, grp, x0, crop_w):
    """The prop strips as they were: the stacked batch inverted, every row's
    strip stacked, those whose maximum is above 0 kept."""
    inv = np.subtract(255, pages, dtype=np.uint8)
    ch = grp.crop_h
    strips = np.stack([inv[:, y : y + ch, x0 : x0 + crop_w] for y in grp.ys],
                      axis=1).reshape(-1, ch, crop_w)
    inked = np.flatnonzero(strips.reshape(len(strips), -1).max(axis=1) > 0)
    return inked, strips[inked]


GRIDS = {  # (H, W), (x, y, width, line height, advance)
    "partial-bottom": ((100, 90), (5, 3, 70, 12, 15)),  # the last row 7 px high
    "narrow": ((64, 40), (5, 4, 70, 12, 15)),  # crop_w clamped to 35
    "overlap": ((70, 60), (2, 1, 50, 12, 8)),  # each pixel in two strips
    "one-row-page": ((1, 30), (0, 0, 30, 12, 15)),
    "x-past-the-page": ((40, 20), (25, 2, 10, 12, 15)),  # crop_w 0
}


def _mapped(tmp_path, rng, shape, n=5):
    """n pages of ``shape`` with some white and some inked strips, mapped from
    their files, and the same pages stacked."""
    pages = np.full((n,) + shape, 255, np.uint8)
    for b in range(n):
        for y in range(0, shape[0], 4):
            if rng.random() < 0.6:
                pages[b, y : y + 4] = rng.integers(0, 256, pages[b, y : y + 4].shape)
    paths = [_p5(tmp_path / f"m{b}.pgm", p) for b, p in enumerate(pages)]
    reset_counters()
    mapped = timages.load_gray_many(paths)
    assert COUNTERS["pages_mapped"] == n and not any(p.flags.writeable for p in mapped)
    return mapped, pages


@pytest.mark.parametrize("grid", list(GRIDS))
def test_crops_over_mapped_pages_are_the_stacked_formulas(tmp_path, grid):
    """crop_strips (into a fresh array and into a flat buffer's view) and
    inked_strips over the list of mapped pages give the old stacked formulas'
    bytes; crop_strips' rows that are no even grid (a row past the bottom,
    white-padded) too."""
    (H, W), (x, y, width, lh, adv) = GRIDS[grid]
    mapped, stacked = _mapped(tmp_path, np.random.default_rng(len(grid)), (H, W))
    x0 = min(x, W)
    crop_w = max(min(width, W - x0), 0)
    groups = tfocr._row_groups(TDecodeOptions(x_start=x, y_start=y, width=width, line_height=lh,
                                              line_advance=adv), H)
    assert groups
    for grp in groups:
        want = _old_crop(stacked, grp.ys, grp.crop_h, x0, crop_w)
        assert tfocr.crop_strips(mapped, grp.ys, grp.crop_h, x0, crop_w).tobytes() == want.tobytes()
        flat = np.zeros(want.size + 3, np.uint8)
        view = flat[3:].reshape(want.shape)
        tfocr.crop_strips(mapped, grp.ys, grp.crop_h, x0, crop_w, out=view)
        assert view.tobytes() == want.tobytes()
        if not crop_w:  # the decoder takes no strip of width 0 (decode_batch returns first)
            continue
        want_idx, want_lines = _old_strips(stacked, grp, x0, crop_w)
        got_idx, got_lines = tfocr.inked_strips(mapped, grp, x0, crop_w)
        assert np.array_equal(got_idx, want_idx) and got_lines.flags.c_contiguous
        assert got_lines.shape == want_lines.shape and got_lines.tobytes() == want_lines.tobytes()
    if H < 12:
        return
    uneven = (0, 5, H - 4)
    want = _old_crop(stacked, uneven, 6, x0, crop_w)
    assert tfocr.crop_strips(mapped, uneven, 6, x0, crop_w).tobytes() == want.tobytes()


def test_decode_batch_takes_a_list_or_an_array(tmp_path, mono_font_path):
    """decode_batch gives the same lines for the mapped pages' list and for
    their stacked array, and refuses a page of another shape."""
    from focr_tpu_torch.fonts.ft import Face as TFace
    from focr_tpu_torch.models.types import RenderOptions as TRenderOptions

    face, ropts = Face(mono_font_path), RenderOptions(size=13.0)
    width = width_for_cells(face, ropts, 5)
    grid = dict(x_start=3, y_start=2, width=width, line_height=12, line_advance=15)
    page = synthesize_page(face, ["AB=01", "", "x/yz+"], DecodeOptions(**grid), ropts,
                           FOCR_DEFAULT_ALPHABET, (52, 70), blank_rows={1})
    mapped = timages.load_gray_many([_p5(tmp_path / "a.pgm", page),
                                     _p5(tmp_path / "b.pgm", page[::-1].copy())])
    dec = tfocr.GridDecoder(TFace(mono_font_path), FOCR_DEFAULT_ALPHABET, TDecodeOptions(**grid),
                            TRenderOptions(size=13.0), (52, 70), "cpu")
    got = dec.decode_batch(mapped)
    assert got == dec.decode_batch(np.stack(mapped))
    assert [ln.text for ln in got[0]] == ["AB=01", "x/yz+"]
    with pytest.raises(ValueError, match="not \\(52, 70\\)"):
        dec.decode_batch([mapped[0], np.full((50, 70), 255, np.uint8)])


# --- the CLI ------------------------------------------------------------------


def _cli_pages(tmp_path, font, alphabet, size, lines, shapes, grid):
    face, ropts = Face(font), RenderOptions(size=size)
    paths = []
    for k, (text, shape) in enumerate(zip(lines, shapes)):
        page = synthesize_page(face, text, DecodeOptions(**grid), ropts, alphabet, shape)
        paths.append(_p5(tmp_path / f"page{k}.pgm", page))
    return paths


@pytest.mark.parametrize("doc", ["grid", "prop", "streamed"])
def test_cli_stdout_over_mapped_pages_is_focr_tpus(tmp_path, capsys, mono_font_path,
                                                   sans_font_path, doc):
    """The CLI's stdout over mapped pages is focr_tpu's: a grid document of
    two page shapes in batches of 2, a document in a proportional font, and
    one streamed page; every page is mapped."""
    if doc == "prop":
        alphabet, font = "AWijm01.:| ", sans_font_path
        grid = dict(x_start=4, y_start=5, line_height=12, line_advance=15, width=120)
        texts = [["AWij01", "m.:|Wi"], ["W0", "jim|"], ["iiii", "1.0"]]
        shapes = [(50, 130), (50, 130), (54, 130)]
        flags = ["-a", alphabet, "-t", "11"]
    else:
        alphabet, font = FOCR_DEFAULT_ALPHABET, mono_font_path
        width = width_for_cells(Face(font), RenderOptions(size=13.0), 6)
        grid = dict(x_start=5, y_start=6, line_height=12, line_advance=15, width=width)
        texts = [["Abc123", "> =xyz"], ["Q+/90z", "hello="], ["WORLD0"]]
        shapes = [(60, 80), (67, 80), (60, 80)]
        flags = ["-t", "13", "--batch-size", "2"]
        if doc == "streamed":
            texts, shapes = texts[:1], shapes[:1]
    paths = _cli_pages(tmp_path, font, alphabet, float(flags[flags.index("-t") + 1]), texts,
                       shapes, grid)
    argv = ["-i", *paths, "-f", font, *flags, "-x", str(grid["x_start"]),
            "-y", str(grid["y_start"]), "-w", str(grid["width"]),
            "--line-height", "12", "--line-advance", "15"]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    mpath = tmp_path / "m.json"
    assert torch_main([*argv, "--device", "cpu", "--metrics-json", str(mpath)]) == 0
    assert capsys.readouterr().out == want and want.strip()
    counters = json.loads(mpath.read_text())["counters"]
    assert (counters["pages_mapped"], counters["pages_decoded"]) == (len(paths), 0)

