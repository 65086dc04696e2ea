"""focr_tpu_torch's focr host layer (copied from focr_tpu, since the port may
not import it) against the originals: the grid bank byte for byte, its .npz
round trip, the golden fixture, the focr oracle, and the page loaders and
buckets."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from focr_tpu.fonts import bank as jbank
from focr_tpu.fonts.ft import Face, HintingOptions
from focr_tpu.io import images as jimages
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions
from focr_tpu.oracle import focr_oracle as joracle
from focr_tpu_torch.fonts import bank as tbank
from focr_tpu_torch.fonts.ft import Face as TFace, HintingOptions as THinting
from focr_tpu_torch.io import images as timages
from focr_tpu_torch.models.types import (
    DecodeOptions as TDecodeOptions, RenderOptions as TRenderOptions,
)
from focr_tpu_torch.oracle import focr_oracle as toracle

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_focr_golden.npz")
FIELDS = ("templates", "tsq", "wx0", "positions")


@pytest.fixture(scope="module")
def faces(mono_font_path):
    return Face(mono_font_path), TFace(mono_font_path)


def _ropts(size=13.0, kern_x=1.0, hinting=False):
    j = RenderOptions(size=size, kern_x=kern_x,
                      hinting=HintingOptions(full=True, size=size) if hinting else HintingOptions())
    tr = TRenderOptions(size=size, kern_x=kern_x,
                        hinting=THinting(full=True, size=size) if hinting else THinting())
    return j, tr


def _same_bank(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.alphabet, a.crop_w, a.crop_h, a.monospace) == (b.alphabet, b.crop_w, b.crop_h,
                                                            b.monospace)


@pytest.mark.parametrize(
    "crop_w,crop_h,alphabet,kern_x,hinting",
    [
        (608, 12, FOCR_DEFAULT_ALPHABET, 1.0, False),  # the canonical grid
        (608, 3, FOCR_DEFAULT_ALPHABET, 1.0, False),  # its partial bottom row
        (30, 12, FOCR_DEFAULT_ALPHABET, 1.0, False),  # a narrow grid
        (5, 12, "AB01", 1.0, False),  # narrower than a window
        (90, 13, "AB01ab", 1.1, True),  # kerning and hinting
    ],
    ids=["canonical", "partial", "narrow", "tiny", "kern-hint"],
)
def test_grid_bank_matches_focr_tpu(faces, crop_w, crop_h, alphabet, kern_x, hinting):
    jr, tr = _ropts(kern_x=kern_x, hinting=hinting)
    want = jbank.build_grid_bank(faces[0], alphabet, jr, crop_w, crop_h)
    got = tbank.build_grid_bank(faces[1], alphabet, tr, crop_w, crop_h)
    _same_bank(got, want)
    assert np.array_equal(tbank.cursor_positions(faces[1], alphabet, tr, crop_w),
                          jbank.cursor_positions(faces[0], alphabet, jr, crop_w))


def test_is_monospace_matches_focr_tpu(sans_font_path, faces):
    jr, tr = _ropts()
    sans = (Face(sans_font_path), TFace(sans_font_path))
    for (jf, tf), alpha in ((faces, FOCR_DEFAULT_ALPHABET), (sans, "AWij"), (sans, "ab")):
        assert tbank.is_monospace(tf, alpha, tr) == jbank.is_monospace(jf, alpha, jr)
    with pytest.raises(ValueError, match="monospace"):
        tbank.build_grid_bank(sans[1], "AWij", tr, 50, 12)


def test_grid_bank_file_roundtrip(faces, tmp_path):
    _, tr = _ropts()
    banks = [tbank.build_grid_bank(faces[1], "AB01", tr, 40, h) for h in (12, 3)]
    settings = tbank.grid_bank_settings("/fonts/DejaVuSansMono.ttf", "AB01", tr, 40)
    path = str(tmp_path / "grid.npz")
    tbank.save_grid_bank(path, banks, settings)
    loaded, saved = tbank.load_grid_bank(path)
    assert saved == settings and saved["font"] == "DejaVuSansMono.ttf"
    assert sorted(loaded) == [3, 12]
    for b in banks:
        _same_bank(loaded[b.crop_h], b)
    other = tbank.build_grid_bank(faces[1], "AB", tr, 40, 12)
    with pytest.raises(ValueError, match="settings"):
        tbank.save_grid_bank(path, [other], settings)


def test_golden_fixture_bank_is_focr_tpus(faces):
    """The committed golden's grid banks are focr_tpu's build_grid_bank (and
    the port's) for every crop height 1..12 at crop width 608; its pages are
    bench.py's focr corpus and its lines focr_tpu's."""
    jr, tr = _ropts()
    loaded, settings = tbank.load_grid_bank(FIXTURE)
    assert settings == tbank.grid_bank_settings(
        "DejaVuSansMono.ttf", FOCR_DEFAULT_ALPHABET, tr, 608)
    assert sorted(loaded) == list(range(1, 13))
    for h in (1, 3, 7, 12):
        _same_bank(loaded[h], jbank.build_grid_bank(faces[0], FOCR_DEFAULT_ALPHABET, jr, 608, h))
        _same_bank(loaded[h], tbank.build_grid_bank(faces[1], FOCR_DEFAULT_ALPHABET, tr, 608, h))
    with np.load(FIXTURE, allow_pickle=False) as z:
        pages, truths = z["pages"], json.loads(str(z["truths"]))
        lines = json.loads(str(z["lines"]))
    assert pages.shape == (16, 792, 662) and pages.dtype == np.uint8
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    assert np.array_equal(
        pages[0], synthesize_page(faces[0], truths[0], dopts, jr, FOCR_DEFAULT_ALPHABET,
                                  (792, 662)))
    assert len(lines) == 16 and all(len(p) == 48 for p in lines)


def test_focr_tpu_bank_loads_into_port_gridbank(faces, tmp_path):
    """A bank built by focr_tpu saves through the port's format and loads as
    the port's GridBank, unchanged."""
    jr, tr = _ropts()
    jb = jbank.build_grid_bank(faces[0], "=+AB", jr, 33, 9)
    path = str(tmp_path / "j.npz")
    tbank.save_grid_bank(path, [jb], tbank.grid_bank_settings("f.ttf", "=+AB", tr, 33))
    loaded, _ = tbank.load_grid_bank(path)
    assert isinstance(loaded[9], tbank.GridBank)
    _same_bank(loaded[9], jb)


@pytest.mark.parametrize("text", ["AbzQ+/09", "> =hello", "iiWW", ""])
def test_render_string_matches(faces, text):
    jr, tr = _ropts()
    want = joracle.render_string(faces[0], text, jr).pixels
    got = toracle.render_string(faces[1], text, tr).pixels
    assert got.shape == want.shape and np.array_equal(got, want)


def test_sum_of_squares_matches():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 5000, dtype=np.uint8)
    b = rng.integers(0, 256, 5000, dtype=np.uint8)
    assert toracle.sum_of_squares(a, b) == joracle.sum_of_squares(a, b)


@pytest.mark.parametrize("font", ["mono", "sans"])
def test_oracle_decode_image_matches(faces, sans_font_path, font):
    """decode_line / decode_image on a synthesized page with a blank row and
    on a noise page: identical (text, y) lines."""
    jf, tf = faces if font == "mono" else (Face(sans_font_path), TFace(sans_font_path))
    alpha = "AB01=x" if font == "mono" else "AWij1."
    jr, tr = _ropts()
    d = dict(x_start=3, y_start=4, line_height=12, line_advance=15, width=50)
    page = synthesize_page(jf, ["AB01", "x=BA"], DecodeOptions(**d), jr, alpha, (50, 60),
                           blank_rows={1})
    noise = np.random.default_rng(1).integers(0, 256, (40, 60), dtype=np.uint8)
    for img in (page, noise):
        want = joracle.decode_image(img, jf, alpha, DecodeOptions(**d), jr)
        got = toracle.decode_image(img, tf, alpha, TDecodeOptions(**d), tr)
        assert [(ln.text, ln.y) for ln in got] == [(ln.text, ln.y) for ln in want]
        assert len(want) > 0
    crop = noise[4:16, 3:53]
    assert toracle.decode_line(crop, tf, alpha, tr) == joracle.decode_line(crop, jf, alpha, jr)


def test_page_loaders_and_buckets_match(tmp_path):
    rng = np.random.default_rng(2)
    shapes = [(20, 30), (25, 30), (20, 30), (7, 9)]
    paths = []
    for k, s in enumerate(shapes):
        p = str(tmp_path / f"p{k}.pgm")
        timages.save_gray(p, rng.integers(0, 256, s, dtype=np.uint8))
        paths.append(p)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    for a, b in zip(timages.load_gray_many(paths), jimages.load_gray_many(paths)):
        assert np.array_equal(a, b)
    with_bad = paths[:2] + [str(bad)] + paths[2:]
    tp, te = timages.load_gray_many_isolated(with_bad)
    jp, je = jimages.load_gray_many_isolated(with_bad)
    assert te == je and [i for i, _ in te] == [2]
    assert [p is None for p in tp] == [p is None for p in jp]
    with pytest.raises(Exception) as exc:
        timages.load_gray_many(with_bad)
    with pytest.raises(type(exc.value)):
        jimages.load_gray_many(with_bad)
    pages = [p for p in tp if p is not None]
    for tb, jb in zip(timages.bucket_pages(pages), jimages.bucket_pages(pages), strict=True):
        assert (tb.shape, tb.indices) == (jb.shape, jb.indices)
        assert np.array_equal(tb.pages, jb.pages)


def test_focr_port_imports_without_jax():
    """The focr modules of the port import where jax cannot be imported, and
    none of them imports focr_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import focr_tpu_torch.cli.focr, focr_tpu_torch.models.focr\n"
        "import focr_tpu_torch.ops.ssd_kernels, focr_tpu_torch.oracle.focr_oracle\n"
        "bad = [m for m in sys.modules if m == 'focr_tpu' or m.startswith('focr_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# --- the lazy bank set (load_grid_bank) --------------------------------------

PROP_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_prop_golden.npz")
CANONICAL = dict(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)


@pytest.mark.parametrize("fixture,kind", [(FIXTURE, "grid"), (PROP_FIXTURE, "prop")])
def test_bank_set_names_its_heights_without_decompressing(fixture, kind):
    banks, settings = tbank.load_grid_bank(fixture)
    assert set(banks) == set(range(1, 13)) and len(banks) == 12 and sorted(banks)[-1] == 12
    assert 12 in banks and 13 not in banks and banks.get(13) is None
    assert banks.kind == kind == settings["kind"] and banks.settings is settings
    assert not (set(range(1, 13)) - set(banks))  # the CLI's missing-height check
    assert banks.loads == []
    with pytest.raises(KeyError):
        banks[13]
    b = banks[3]
    assert banks.loads == [3] and banks[3] is b and banks.get(3) is b and banks.loads == [3]
    assert b.crop_h == 3 and isinstance(b, tbank.GridBank if kind == "grid" else tbank.PropBank)


@pytest.mark.parametrize("fixture", [FIXTURE, PROP_FIXTURE], ids=["focr", "prop"])
def test_canonical_decode_loads_heights_12_and_3_only(fixture):
    """A decoder for the canonical grid on a 792x662 page asks for crop
    heights 12 and 3 and nothing else, and decodes what a decoder over the
    eagerly loaded set decodes."""
    from focr_tpu_torch.models.focr import GridDecoder

    with np.load(fixture, allow_pickle=False) as z:
        pages, lines = z["pages"][:2], json.loads(str(z["lines"]))[:2]
    lazy, settings = tbank.load_grid_bank(fixture)
    dopts, tr = TDecodeOptions(**CANONICAL), TRenderOptions(size=13.0)
    dec = GridDecoder(None, settings["alphabet"], dopts, tr, pages.shape[1:], "cpu", banks=lazy)
    assert sorted(lazy.loads) == [3, 12] and len(lazy.loads) == 2
    got = [[[ln.text, ln.y] for ln in p] for p in dec.decode_batch(pages)]
    assert sorted(lazy.loads) == [3, 12]
    every, _ = tbank.load_grid_bank(fixture)
    eager = {h: every[h] for h in every}  # what the eager load held: every height
    assert every.loads == list(range(1, 13))
    dec2 = GridDecoder(None, settings["alphabet"], dopts, tr, pages.shape[1:], "cpu", banks=eager)
    assert dec2.monospace == dec.monospace == (settings["kind"] == "grid")
    assert [[[ln.text, ln.y] for ln in p] for p in dec2.decode_batch(pages)] == got == lines


@pytest.mark.parametrize("cache", ["cold", "warm", "off"])
def test_bank_set_first_load_is_guarded_and_close_keeps_loaded_heights(cache, tmp_path,
                                                                       monkeypatch):
    """One load of a height however many threads ask, whether it is
    decompressed or read from the bank cache."""
    import threading

    from focr_tpu_torch.utils.metrics import COUNTERS, reset_counters

    monkeypatch.setenv("FOCR_TPU_CACHE_DIR", str(tmp_path / "banks"))
    monkeypatch.delenv("FOCR_TPU_NO_BANK_CACHE", raising=False)
    if cache == "off":
        monkeypatch.setenv("FOCR_TPU_NO_BANK_CACHE", "1")
    if cache == "warm":
        tbank.load_grid_bank(FIXTURE)[0][12]
    reset_counters()
    banks, _ = tbank.load_grid_bank(FIXTURE)
    got, barrier = [], threading.Barrier(8)

    def ask():
        barrier.wait(timeout=30)
        got.append(banks[12])

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert banks.loads == [12] and len(got) == 8 and all(b is got[0] for b in got)
    assert (COUNTERS.get("bank_cache_hits", 0), COUNTERS.get("bank_cache_misses", 0)) == (
        (1, 0) if cache == "warm" else (0, 1))
    banks.close()
    banks.close()
    assert banks[12] is got[0] and set(banks) == set(range(1, 13))
    with pytest.raises(ValueError, match="closed"):
        banks[3]


def test_decoder_loads_only_the_heights_of_its_grid():
    """A decoder on a lazy set loads the crop heights its grid uses, each
    once; a second decoder on the same set loads none again."""
    from focr_tpu_torch.models.focr import GridDecoder

    banks, settings = tbank.load_grid_bank(FIXTURE)
    dopts, tr = TDecodeOptions(**CANONICAL), TRenderOptions(size=13.0)
    args = (None, settings["alphabet"], dopts, tr, (100, 662), "cpu")
    dec = GridDecoder(*args, banks=banks)
    assert dec.bank_set is banks and [g.crop_h for g, _ in dec.groups] == [12, 1]
    GridDecoder(*args, banks=banks)
    assert sorted(banks.loads) == [1, 12]  # 100 rows: 4 full rows and a 1-pixel one


def test_cli_reports_a_missing_height_without_decompressing(faces, tmp_path, capsys, mono_font_path,
                                                           monkeypatch):
    from focr_tpu_torch.cli.focr import main as torch_main

    _, tr = _ropts()
    path = str(tmp_path / "short.npz")
    tbank.save_grid_bank(path, [tbank.build_grid_bank(faces[1], "AB01", tr, 40, h) for h in (12, 2)],
                         tbank.grid_bank_settings(mono_font_path, "AB01", tr, 40))
    page = str(tmp_path / "p.pgm")
    timages.save_gray(page, np.full((30, 60), 255, np.uint8))
    made = []
    real = tbank.load_grid_bank
    monkeypatch.setattr(tbank, "load_grid_bank", lambda p: made.append(real(p)) or made[-1])
    rc = torch_main(["-i", page, "-f", mono_font_path, "-t", "13", "-a", "AB01", "-w", "40",
                     "--line-height", "12", "--line-advance", "15", "--device", "cpu",
                     "--grid-bank", path])
    cap = capsys.readouterr()
    assert rc == 2 and cap.out == "" and "no bank for crop heights [1, 3, 4" in cap.err
    assert made[0][0].loads == []


# --- the saved sets' raw copies in the bank cache -----------------------------


def _cold(fixture, h):
    """Crop height ``h`` of a saved set as np.load decompresses it."""
    with np.load(fixture, allow_pickle=False) as z:
        settings = json.loads(str(z["grid_bank_settings"]))
        if settings.get("kind", "grid") == "grid":
            return tbank.GridBank(settings["alphabet"], *(z[f"grid_h{h}_{f}"] for f in FIELDS),
                                  crop_w=settings["crop_w"], crop_h=h, monospace=True)
        ox, oy = z[f"prop_h{h}_origin"]
        return tbank.prop_bank_from_arrays(
            settings["alphabet"], z[f"prop_h{h}_templates"], z[f"prop_h{h}_colsq_cum"],
            z[f"prop_h{h}_advances"], z[f"prop_h{h}_base"][0], ox, oy, h)


def _identical(a, b):
    assert type(a) is type(b)
    for f, x in vars(a).items():
        y = getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f
        else:
            assert type(x) is type(y) and x == y, f


def _load(path, *heights):
    """A new set's ``heights``, and the cache's hits and misses while it
    loaded them."""
    from focr_tpu_torch.utils.metrics import COUNTERS, reset_counters

    reset_counters("bank_cache_hits", "bank_cache_misses")
    banks, _ = tbank.load_grid_bank(path)
    got = [banks[h] for h in heights]
    assert banks.loads == list(heights)
    return got, (COUNTERS["bank_cache_hits"], COUNTERS["bank_cache_misses"])


def _entries(d):
    return sorted(d.glob("*.raw")) if d.exists() else []


@pytest.fixture
def bank_cache(tmp_path, monkeypatch):
    d = tmp_path / "banks"
    monkeypatch.setenv("FOCR_TPU_CACHE_DIR", str(d))
    monkeypatch.delenv("FOCR_TPU_NO_BANK_CACHE", raising=False)
    return d


@pytest.mark.parametrize("fixture", [FIXTURE, PROP_FIXTURE], ids=["grid", "prop"])
def test_a_second_set_of_the_same_file_hits(bank_cache, tmp_path, fixture):
    """The first set decompresses and writes a raw copy a height; a second
    one of the same bytes under another path reads them back: the same
    arrays, bit for bit, as np.load's."""
    import shutil

    first, counts = _load(fixture, 12, 3)
    assert counts == (0, 2) and len(_entries(bank_cache)) == 2
    moved = str(tmp_path / "moved.npz")
    shutil.copyfile(fixture, moved)
    for path in (fixture, moved):
        again, counts = _load(path, 3, 12)
        assert counts == (2, 0)
        for got, before in zip(again, first[::-1]):
            _identical(got, _cold(fixture, got.crop_h))
            _identical(got, before)
    assert len(_entries(bank_cache)) == 2


def test_a_rewritten_file_misses(bank_cache, tmp_path):
    path = str(tmp_path / "set.npz")
    with np.load(FIXTURE, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k.startswith("grid_")}
    np.savez_compressed(path, **arrays)
    assert _load(path, 3)[1] == (0, 1)
    assert _load(path, 3)[1] == (1, 0)
    arrays["grid_h3_templates"] = arrays["grid_h3_templates"].copy()
    arrays["grid_h3_templates"][0, 0, 0, 0] ^= 1
    np.savez_compressed(path, **arrays)
    (got,), counts = _load(path, 3)
    assert counts == (0, 1) and len(_entries(bank_cache)) == 2
    _identical(got, _cold(path, 3))
    assert np.array_equal(got.templates, arrays["grid_h3_templates"])


@pytest.mark.parametrize("damage", ["truncated", "flipped", "empty"])
def test_a_damaged_copy_misses_and_is_rewritten(bank_cache, damage):
    _load(FIXTURE, 3)
    (entry,) = _entries(bank_cache)
    good = entry.read_bytes()
    bad = {"truncated": good[:-7], "empty": b"",
           "flipped": bytearray(good)}[damage]
    if damage == "flipped":
        bad[len(good) // 2] ^= 0x10
    entry.write_bytes(bad)
    (got,), counts = _load(FIXTURE, 3)
    assert counts == (0, 1)
    assert _entries(bank_cache) == [entry] and entry.read_bytes() == good
    _identical(got, _cold(FIXTURE, 3))
    assert _load(FIXTURE, 3)[1] == (1, 0)


def test_no_bank_cache_writes_nothing_and_always_misses(bank_cache, monkeypatch):
    monkeypatch.setenv("FOCR_TPU_NO_BANK_CACHE", "1")
    for _ in range(2):
        (got,), counts = _load(FIXTURE, 3)
        assert counts == (0, 1)
        _identical(got, _cold(FIXTURE, 3))
    assert not bank_cache.exists()


def test_an_unwritable_cache_still_decodes(tmp_path, monkeypatch):
    """A cache directory that cannot be made (a file stands where its
    parent should be): every load misses, and decodes all the same."""
    blocker = tmp_path / "file"
    blocker.write_bytes(b"")
    monkeypatch.setenv("FOCR_TPU_CACHE_DIR", str(blocker / "banks"))
    monkeypatch.delenv("FOCR_TPU_NO_BANK_CACHE", raising=False)
    for _ in range(2):
        got, counts = _load(PROP_FIXTURE, 12, 3)
        assert counts == (0, 2)
        for b in got:
            _identical(b, _cold(PROP_FIXTURE, b.crop_h))
    assert blocker.read_bytes() == b""
