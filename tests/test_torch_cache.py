"""focr_tpu_torch's bank disk cache (utils/cache.py, and its place around the
three functions that build banks) on the CPU: a warm hit equals a cold render dtype for
dtype, the environment switches, a corrupt entry, the key, and that a cache
directory shared with focr_tpu is safe."""

import os

import numpy as np
import pytest

from focr_tpu.fonts import bank as jbank
from focr_tpu.fonts.ft import Face
from focr_tpu.models.types import BoxSize, RenderOptions
from focr_tpu.utils import cache as jcache
from focr_tpu_torch.fonts import bank as tbank
from focr_tpu_torch.fonts.ft import Face as TFace, HintingOptions as THinting
from focr_tpu_torch.models.types import BoxSize as TBoxSize, RenderOptions as TRenderOptions
from focr_tpu_torch.utils import cache as tcache


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("FOCR_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("FOCR_TPU_NO_BANK_CACHE", raising=False)
    return tmp_path


def _fields(obj):
    """Every array field (with its dtype) and scalar field of a bank."""
    out = {}
    for k, v in vars(obj).items():
        out[k] = (v.dtype.str, v.shape, v.tobytes()) if isinstance(v, np.ndarray) else (
            type(v).__name__, v)
    return out


def _needle_fields(needles):
    return [_fields(nd) for nd in needles]


BANK_KINDS = {
    "grid": (lambda f, r: tbank.build_grid_bank(f, "AB01", r, 120, 13), _fields),
    "prop": (lambda f, r: tbank.build_prop_bank(f, "AWij", r, 9), _fields),
    "needles": (lambda f, r: tbank.build_needles(f, "AB0", r, TBoxSize.ALPHABET, 1, 0),
                _needle_fields),
}


@pytest.mark.parametrize("kind", list(BANK_KINDS))
def test_warm_hit_equals_cold_render(kind, cache_dir, mono_font_path, sans_font_path):
    build, fields = BANK_KINDS[kind]
    face = TFace(sans_font_path if kind == "prop" else mono_font_path)
    ropts = TRenderOptions(size=11.0)
    cold = build(face, ropts)
    assert len(os.listdir(cache_dir)) == 1
    warm = build(face, ropts)
    assert fields(warm) == fields(cold)
    assert len(os.listdir(cache_dir)) == 1


@pytest.mark.parametrize("kind", list(BANK_KINDS))
def test_warm_hit_renders_nothing(kind, cache_dir, mono_font_path, sans_font_path, monkeypatch):
    """The second build reads the entry: FreeType rasterizes no glyph."""
    build, fields = BANK_KINDS[kind]
    face = TFace(sans_font_path if kind == "prop" else mono_font_path)
    ropts = TRenderOptions(size=11.0)
    cold = build(face, ropts)

    def no_render(*a, **kw):
        raise AssertionError("a warm build rasterized a glyph")

    monkeypatch.setattr(TFace, "rasterize_glyph", no_render)
    assert fields(build(face, ropts)) == fields(cold)


@pytest.mark.parametrize("kind", list(BANK_KINDS))
def test_cache_disabled_by_env(kind, cache_dir, mono_font_path, sans_font_path, monkeypatch):
    monkeypatch.setenv("FOCR_TPU_NO_BANK_CACHE", "1")
    build, fields = BANK_KINDS[kind]
    face = TFace(sans_font_path if kind == "prop" else mono_font_path)
    a = build(face, TRenderOptions(size=11.0))
    assert os.listdir(cache_dir) == []
    assert fields(build(face, TRenderOptions(size=11.0))) == fields(a)
    assert tcache.cache_dir() is None
    tcache.store_arrays("k", {"a": np.arange(3)})
    assert tcache.load_arrays("k") is None and os.listdir(cache_dir) == []


@pytest.mark.parametrize("damage", ["truncated", "garbage", "empty"])
def test_corrupt_entry_is_a_miss_and_is_removed(damage, cache_dir, mono_font_path):
    face, ropts = TFace(mono_font_path), TRenderOptions(size=11.0)
    cold = tbank.build_grid_bank(face, "AB01", ropts, 120, 13)
    (entry,) = os.listdir(cache_dir)
    path = cache_dir / entry
    blob = path.read_bytes()
    path.write_bytes({"truncated": blob[: len(blob) // 2], "garbage": b"not a zip" * 50,
                      "empty": b""}[damage])
    assert tcache.load_arrays(entry[: -len(".npz")]) is None
    assert os.listdir(cache_dir) == []
    again = tbank.build_grid_bank(face, "AB01", ropts, 120, 13)
    assert _fields(again) == _fields(cold)
    assert os.listdir(cache_dir) == [entry]


def test_store_is_atomic_and_leaves_no_temporary(cache_dir):
    tcache.store_arrays("k", {"a": np.arange(5, dtype=np.int16)})
    assert os.listdir(cache_dir) == ["k.npz"]
    got = tcache.load_arrays("k")
    assert got["a"].dtype == np.int16 and got["a"].tolist() == [0, 1, 2, 3, 4]
    assert tcache.load_arrays("other") is None


KEY_BASE = dict(size=13.0, kern_x=1.0, hinting=(False, 0.0), alphabet="AB", crop_w=100, crop_h=12)


@pytest.mark.parametrize(
    "change",
    [{"size": 13.5}, {"kern_x": 1.1}, {"hinting": (True, 13.0)}, {"alphabet": "ABC"},
     {"crop_w": 101}, {"crop_h": 3}, {"kind": "prop"}, {"font": "sans"}],
    ids=lambda c: next(iter(c)),
)
def test_keys_differ_when_any_parameter_does(change, mono_font_path, sans_font_path):
    base = tcache.bank_key("grid", mono_font_path, **KEY_BASE)
    assert base == tcache.bank_key("grid", mono_font_path, **KEY_BASE)
    params = {**KEY_BASE, **{k: v for k, v in change.items() if k not in ("kind", "font")}}
    other = tcache.bank_key(change.get("kind", "grid"),
                            sans_font_path if "font" in change else mono_font_path, **params)
    assert other != base and len(base) == 64


def test_key_is_the_ports_own(mono_font_path):
    """The same parameters give focr_tpu another key (the package is in the
    payload), and the font is keyed by content, not by path."""
    assert tcache.bank_key("grid", mono_font_path, **KEY_BASE) != jcache.bank_key(
        "grid", mono_font_path, **KEY_BASE)
    assert tcache._font_hash(mono_font_path) == jcache._font_hash(mono_font_path)


def test_default_directory_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("FOCR_TPU_CACHE_DIR", raising=False)
    monkeypatch.delenv("FOCR_TPU_NO_BANK_CACHE", raising=False)
    d = tcache.cache_dir()
    assert d.endswith(os.path.join(".cache", "focr_tpu_torch", "banks"))
    assert d != jcache.cache_dir()


@pytest.mark.parametrize("first", ["focr_tpu", "port"])
def test_directory_shared_with_focr_tpu_is_safe(first, cache_dir, sans_font_path):
    """Both packages cache the same proportional bank in one directory, in
    either order: two entries, and each warm hit is its own package's bank
    (the port's fields keep the port's dtypes)."""
    jface, tface = Face(sans_font_path), TFace(sans_font_path)
    jr, tr = RenderOptions(size=11.0), TRenderOptions(size=11.0)
    builds = [lambda: jbank.build_prop_bank(jface, "AWij", jr, 9),
              lambda: tbank.build_prop_bank(tface, "AWij", tr, 9)]
    if first == "port":
        builds.reverse()
    colds = [b() for b in builds]
    assert len(os.listdir(cache_dir)) == 2
    warms = [b() for b in builds]
    for cold, warm in zip(colds, warms):
        assert _fields(warm) == _fields(cold)
    port = warms[1] if first == "focr_tpu" else warms[0]
    assert port.colsq_cum.dtype == np.int32 and port.templates.dtype == np.uint8


@pytest.mark.parametrize("kind", ["grid", "needles"])
def test_cached_banks_equal_focr_tpus(kind, cache_dir, mono_font_path):
    """Cold and warm, the port's cached bank holds focr_tpu's pixels."""
    jface, tface = Face(mono_font_path), TFace(mono_font_path)
    jr = RenderOptions(size=13.0)
    tr = TRenderOptions(size=13.0, hinting=THinting())
    for _ in range(2):  # cold, then warm
        if kind == "grid":
            want = jbank.build_grid_bank(jface, "AB01", jr, 90, 12)
            got = tbank.build_grid_bank(tface, "AB01", tr, 90, 12)
            for f in ("templates", "tsq", "wx0", "positions"):
                a, b = getattr(got, f), getattr(want, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            want = jbank.build_needles(jface, "AB0", jr, BoxSize.CHAR, 1, 1)
            got = tbank.build_needles(tface, "AB0", tr, TBoxSize.CHAR, 1, 1)
            assert [(n.letter, n.offset, n.corrected_offset, n.s_n, n.s2_n, n.pixels.tobytes())
                    for n in got] == [
                (n.letter, n.offset, n.corrected_offset, n.s_n, n.s2_n, n.pixels.tobytes())
                for n in want]
