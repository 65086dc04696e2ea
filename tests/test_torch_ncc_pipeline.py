"""focr_tpu_torch's three-stage ncc pipeline (get_hits_many: a dispatch
thread, a fetch thread, the collect pool) on the CPU, where the stages run the
kernels' plain versions: every page's result equals page-by-page get_hits byte
for byte, verbose stderr keeps the reference's order, a worker's exception
surfaces, and the golden pages give focr_tpu's get_hits_many."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models import ncc as jax_ncc
from focr_tpu.models.post import process_hits_text as jax_process_hits_text
from focr_tpu.models.types import DecodeOptions, NCC_DEFAULT_ALPHABET, RenderOptions
from focr_tpu_torch.fonts.bank import load_needle_bank
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.models import ncc as torch_ncc
from focr_tpu_torch.models.post import process_hits_text
from focr_tpu_torch.models.types import RenderOptions as TRenderOptions

torch.set_num_threads(2)

ALPHA = "AB01ab"
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_ncc_golden.npz"


def key(hits):
    return [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hits]


def struct_key(s):
    return (s.needle_id.tobytes(), s.x.tobytes(), s.y.tobytes(), s.sim.tobytes(),
            s.needle_id.dtype.str, s.x.dtype.str, s.y.dtype.str, s.sim.dtype.str)


@pytest.fixture(scope="module")
def matcher(mono_font_path):
    return torch_ncc.NccMatcher(TFace(mono_font_path), ALPHA, TRenderOptions(size=11.0),
                                x_bits=1, device="cpu")


@pytest.fixture(scope="module")
def corpus(mono_font_path):
    """20 pages of two shapes (mixed within the waves), one of them blank;
    made from a seed."""
    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    rng = np.random.default_rng(7)
    pages = []
    for k in range(20):
        shape = (48, 112) if k % 3 == 1 else (64, 128)
        if k == 11:
            pages.append(np.full(shape, 255, np.uint8))
            continue
        text = ["".join(rng.choice(list(ALPHA), 6)) for _ in range(2)]
        pages.append(synthesize_page(face, text, dopts, ropts, ALPHA, shape))
    return pages


@pytest.fixture(scope="module")
def singles(matcher, corpus):
    return [matcher.get_hits(p) for p in corpus]


@pytest.mark.parametrize("n_pages", [1, 8, 9, 20])
@pytest.mark.parametrize("form", ["objects", "struct", "struct-post", "objects-post"])
def test_pipeline_equals_page_by_page(matcher, corpus, singles, n_pages, form):
    pages = corpus[:n_pages]
    post = (lambda hs: process_hits_text(hs, 0.95, 5)) if form == "struct-post" else (
        (lambda hs: [h.letter for h in hs]) if form == "objects-post" else None)
    got = matcher.get_hits_many(pages, struct=form.startswith("struct"), post=post)
    assert len(got) == n_pages
    if form == "objects":
        assert [key(h) for h in got] == [key(h) for h in singles[:n_pages]]
    elif form == "struct":
        want = [matcher._collect_page(matcher._sweep_wave([p])[0], False, False, None, True)
                for p in pages]
        assert [struct_key(s) for s in got] == [struct_key(s) for s in want]
        assert [key(s.to_objects()) for s in got] == [key(h) for h in singles[:n_pages]]
    elif form == "struct-post":
        want = [process_hits_text(
            matcher._collect_page(matcher._sweep_wave([p])[0], False, False, None, True), 0.95, 5)
            for p in pages]
        assert got == want and any(got)
    else:
        assert got == [[h.letter for h in hs] for hs in singles[:n_pages]]


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
@pytest.mark.parametrize("threads", [1, 4])
def test_depth_and_pool_size_change_nothing(matcher, corpus, singles, monkeypatch, depth, threads):
    monkeypatch.setattr(torch_ncc, "PIPELINE_DEPTH", depth)
    monkeypatch.setattr(torch_ncc, "COLLECT_THREADS", threads)
    monkeypatch.setattr(torch_ncc, "WAVE", 3)  # 7 waves
    got = matcher.get_hits_many(corpus)
    assert [key(h) for h in got] == [key(h) for h in singles]


def _masked(err: str) -> str:
    """stderr with every number's digits masked (the times differ run to run)."""
    return re.sub(r"\d+(\.\d+)?", "N", err)


def test_verbose_stderr_in_reference_order(matcher, corpus, capsys):
    """With verbose, pages collect serially: the stderr lines are those of
    page-by-page get_hits(verbose=True), page after page, needle after
    needle, whatever the waves' overlap."""
    pages = corpus[:10]
    capsys.readouterr()
    want_hits = [matcher.get_hits(p, verbose=True) for p in pages]
    want = capsys.readouterr().err
    got_hits = matcher.get_hits_many(pages, verbose=True)
    got = capsys.readouterr().err
    assert [key(h) for h in got_hits] == [key(h) for h in want_hits]
    assert _masked(got) == _masked(want)
    # the letters' lines, with their unmasked hit counts, in needle order for each page
    lines = [ln for ln in got.splitlines() if ln.startswith("`") and "needle size" in ln]
    assert lines == [ln for ln in want.splitlines() if ln.startswith("`") and "needle size" in ln] \
        or [re.sub(r"elapsed.*", "", a) for a in lines] == [
            re.sub(r"elapsed.*", "", b) for b in want.splitlines()
            if b.startswith("`") and "needle size" in b]
    assert len(lines) == len(pages) * len(matcher.needles)
    assert got.count("estimated: page span attributed evenly") > 0


class Boom(RuntimeError):
    pass


@pytest.mark.parametrize("stage", ["dispatch", "fetch", "collect", "post"])
@pytest.mark.parametrize("wave", [0, 1])
def test_a_workers_exception_surfaces(matcher, corpus, monkeypatch, stage, wave):
    """An exception raised in the dispatch thread, the fetch thread, a
    collect thread or the caller's post comes out of get_hits_many, and the
    pools shut down."""
    monkeypatch.setattr(torch_ncc, "WAVE", 4)
    calls = {"n": 0}

    def failing(fn, per_wave):
        def wrapper(*a, **kw):
            calls["n"] += 1
            if calls["n"] > wave * per_wave:
                raise Boom(stage)
            return fn(*a, **kw)
        return wrapper

    post = None
    if stage == "dispatch":
        monkeypatch.setattr(matcher, "_dispatch_wave", failing(matcher._dispatch_wave, 1))
    elif stage == "fetch":
        monkeypatch.setattr(matcher, "_fetch_wave", failing(matcher._fetch_wave, 1))
    elif stage == "collect":
        monkeypatch.setattr(matcher, "_collect_page", failing(matcher._collect_page, 4))
    else:
        post = failing(lambda hs: hs, 4)
    import threading

    before = threading.active_count()
    with pytest.raises(Boom, match=stage):
        matcher.get_hits_many(corpus[:12], post=post)
    assert threading.active_count() == before  # no stage's thread is left behind


def test_host_waits_count_through_the_pipeline(matcher, corpus, monkeypatch):
    """G + 1 waits a wave of G swept groups (here every needle is one size),
    counted from the dispatch and the fetch thread; a blank wave waits for
    nothing."""
    monkeypatch.setattr(torch_ncc, "WAVE", 4)
    torch_ncc.reset_host_waits()
    matcher.get_hits_many(corpus[:12])
    by_shape_groups = 0
    for s in range(0, 12, 4):
        shapes = {p.shape for p in corpus[s : s + 4] if (p != 255).any()}
        by_shape_groups += len(shapes) * len(matcher.groups) + 1
    assert torch_ncc.HOST_WAITS == by_shape_groups
    torch_ncc.reset_host_waits()
    matcher.get_hits_many([corpus[11]] * 5)
    assert torch_ncc.HOST_WAITS == 0


def test_many_threads_short_switch_interval(matcher, corpus, singles, monkeypatch):
    """More collect threads than cores and a short switch interval: results
    stay in page order and the wait count loses no update."""
    monkeypatch.setattr(torch_ncc, "WAVE", 2)
    monkeypatch.setattr(torch_ncc, "COLLECT_THREADS", 16)
    monkeypatch.setattr(torch_ncc, "PIPELINE_DEPTH", 3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        torch_ncc.reset_host_waits()
        got = matcher.get_hits_many(corpus + corpus)
        waits = torch_ncc.HOST_WAITS
    finally:
        sys.setswitchinterval(old)
    assert [key(h) for h in got] == [key(h) for h in singles + singles]
    want = 0
    for s in range(0, 40, 2):
        wave = (corpus + corpus)[s : s + 2]
        shapes = {p.shape for p in wave if (p != 255).any()}
        want += len(shapes) * len(matcher.groups) + (1 if shapes else 0)
    assert waits == want


def test_sync_measures_each_group(matcher, corpus, capsys):
    """get_hits(sync=True): the same hits, a measured time for each swept
    size group, and the measured label on the group lines."""
    page = corpus[0]
    meas: dict = {}
    disp = matcher._dispatch_wave([page], measure=meas)
    assert set(meas) == {(g.nh, g.nw) for g in matcher.groups} and all(
        v > 0 for v in meas.values())
    d = matcher._fetch_wave(disp)[0]
    capsys.readouterr()
    hits = matcher._collect_page(d, True, False, None, meas=meas)
    err = capsys.readouterr().err
    assert key(hits) == key(matcher.get_hits(page))
    groups = [ln for ln in err.splitlines() if " group " in ln]
    assert len(groups) == len(matcher.groups)
    assert all("measured wall time, split evenly" in ln for ln in groups)
    capsys.readouterr()
    assert key(matcher.get_hits(page, verbose=True, sync=True)) == key(hits)
    assert "measured wall time, split evenly" in capsys.readouterr().err
    matcher.get_hits(page, verbose=True)
    assert "estimated: page span attributed evenly" in capsys.readouterr().err


def test_pinned_pool_reuses_and_grows(monkeypatch):
    """_PinnedPool hands a free buffer that is large enough back out, makes a
    new one otherwise, in whole MiB (page-locking itself needs a card: here
    the allocation is an ordinary one)."""
    real = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **kw: real(*a, **kw))
    pool = torch_ncc._PinnedPool()
    a = pool.take(10)
    assert a.dtype == torch.uint8 and a.numel() == 1 << 20 and pool.allocated == 1
    b = pool.take(10)
    assert b.data_ptr() != a.data_ptr() and pool.allocated == 2
    pool.give(a)
    assert pool.take(1 << 20).data_ptr() == a.data_ptr() and pool.allocated == 2
    pool.give(a)
    big = pool.take((1 << 20) + 1)
    assert big.numel() == 2 << 20 and pool.allocated == 3
    pool.give(big)
    pool.give(b)
    assert pool.take(5).data_ptr() == a.data_ptr()  # first fit
    assert pool.take(0).numel() >= 1


@pytest.fixture(scope="module")
def golden():
    """The golden ncc pages' top 120 rows (their first lines of text; a
    whole page through two packages' CPU references takes minutes) and the
    fixture's needles."""
    with np.load(FIXTURE, allow_pickle=False) as z:
        pages = [p[:120].copy() for p in z["pages"][:3]]
    needles, _ = load_needle_bank(str(FIXTURE))
    return pages, needles


def test_golden_pages_equal_focr_tpus_get_hits_many(golden, mono_font_path, monkeypatch):
    """The canonical configuration (74 letters, --x-bits 2, size 13, both
    size groups) through both packages' pipelines: positions equal
    (tolerance 0), similarities f32-identical, in struct form and as text."""
    pages, needles = golden
    monkeypatch.setattr(torch_ncc, "WAVE", 2)  # two waves
    tm = torch_ncc.NccMatcher(None, NCC_DEFAULT_ALPHABET, TRenderOptions(size=13.0), x_bits=2,
                              threshold=0.8, device="cpu", needles=needles)
    jm = jax_ncc.NccMatcher(Face(mono_font_path), NCC_DEFAULT_ALPHABET, RenderOptions(size=13.0),
                            x_bits=2, threshold=0.8)
    want = jm.get_hits_many(pages, struct=True)
    got = tm.get_hits_many(pages, struct=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g.x) > 1000
        assert np.array_equal(g.needle_id, w.needle_id)
        assert np.array_equal(g.x, w.x) and np.array_equal(g.y, w.y)
        assert g.sim.dtype == w.sim.dtype == np.float32 and g.sim.tobytes() == w.sim.tobytes()
    assert tm.get_hits_many(pages, struct=True, post=lambda hs: process_hits_text(hs, 0.95, 5)) \
        == jm.get_hits_many(pages, struct=True, post=lambda hs: jax_process_hits_text(hs, 0.95, 5))
