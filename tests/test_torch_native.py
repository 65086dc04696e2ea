"""focr_tpu_torch's ncc host tier (native/ncc_cpu.py over csrc/ncc_host.cpp)
against focr_tpu's native tier and against the port's plain NumPy versions,
on the CPU, exactly: f32 similarity bytes, coordinates, counts, warn flags
and winner indices."""

import ctypes
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models import ncc as jax_ncc
from focr_tpu.models.types import DecodeOptions, RenderOptions
from focr_tpu.native import ncc_cpu as jax_native
from focr_tpu.oracle.ncc_direct import direct_search as jax_direct_search
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.models import ncc as torch_ncc
from focr_tpu_torch.models import post as torch_post
from focr_tpu_torch.models.types import (
    MAX_MATCHES, MatchWithLetter, RenderOptions as TRenderOptions,
)
from focr_tpu_torch.native import build, ncc_cpu
from focr_tpu_torch.ops.ncc import word_stride
from focr_tpu_torch.ops.ncc_kernels import compact_emit
from focr_tpu_torch.ops.replay_kernels import ncc_replay
from focr_tpu_torch.oracle.ncc_direct import direct_search
from focr_tpu_torch.oracle.ncc_oracle import Searcher

torch.set_num_threads(2)

GOLDEN = str(Path(__file__).resolve().parent.parent / "portbench" / "data" / "torch_ncc_golden.npz")


def _replay_key(out, starts):
    """Each needle's hits (x, y, f32 sim bytes), count and warn flag."""
    out_x, out_y, out_sim, counts, warn = out
    per = []
    for t, k in enumerate(counts.tolist()):
        s = slice(int(starts[t]), int(starts[t]) + k)
        per.append((k, int(warn[t]), out_x[s].astype(np.int64).tolist(),
                    out_y[s].astype(np.int64).tolist(), out_sim[s].astype(np.float32).tobytes()))
    return per


def _planted_replay_args(nw, thr, max_matches, seed, nh=9, T=5, H=56, W=84):
    """A sparse random page with every needle planted three times, a
    zero-variance block and blank windows; each needle's candidates a random
    70% of the search domain's windows, in scan order, at full-page
    positions y·W1 + x."""
    rng = np.random.default_rng(seed)
    inv = ((rng.random((H, W)) < 0.3) * rng.integers(0, 256, (H, W))).astype(np.uint8)
    inv[:, W - 12 :] = 0
    bank = rng.integers(0, 256, (T, nh, nw), dtype=np.uint8)
    for t in range(T):
        for _ in range(3):
            y, x = rng.integers(1, H - nh), rng.integers(1, W - 12 - nw)
            inv[y : y + nh, x : x + nw] = bank[t]
    inv[2 : 2 + nh + 3, 2 : 2 + nw + 3] = 128  # zero variance: sim is NaN
    W1 = word_stride(W, nw) * 32
    ys, xs = np.mgrid[1 : H - nh + 1, 1 : W - nw + 1]
    domain = (ys * W1 + xs).ravel().astype(np.int32)
    pos = [np.sort(rng.choice(domain, int(0.7 * len(domain)), replace=False)) for _ in range(T)]
    ends = np.cumsum([len(p) for p in pos]).astype(np.int64)
    starts = ends - np.array([len(p) for p in pos])
    s_n = bank.reshape(T, -1).astype(np.int64).sum(1)
    s2_n = (bank.reshape(T, -1).astype(np.int64) ** 2).sum(1)
    thr64 = float(np.float64(np.float32(thr)))
    return (inv, np.concatenate(pos), starts, ends, bank, s_n, s2_n, thr64, W1, max_matches)


@pytest.mark.parametrize("thr,max_matches", [(0.6, MAX_MATCHES), (-0.2, 7)],
                         ids=["thr0.6", "truncated"])
@pytest.mark.parametrize("nw", [4, 8, 13, 16, 21])
def test_replay_group_matches_focr_tpu_and_plain(nw, thr, max_matches):
    """The templated widths (4, 8, 13, 16) and the generic instance (21),
    with and without MAX_MATCHES truncation and its warn flag."""
    args = _planted_replay_args(nw, thr, max_matches, seed=nw)
    got = _replay_key(ncc_cpu.replay_group(*args), args[2])
    assert got == _replay_key(jax_native.replay_group(*args), args[2])
    assert got == _replay_key(torch_ncc.replay_group_reference(*args), args[2])
    counts = [k for k, *_ in got]
    warns = [w for _, w, *_ in got]
    assert sum(counts) > 0
    if max_matches < MAX_MATCHES:
        assert all(warns) and counts == [max_matches] * len(counts)
    else:
        assert not any(warns)


@pytest.fixture(scope="module")
def faces(mono_font_path):
    return Face(mono_font_path), TFace(mono_font_path)


def _noise_page():
    rng = np.random.default_rng(0)
    page = rng.integers(0, 256, size=(60, 70), dtype=np.uint8)
    page[10:20, 10:20] = 128  # sp > 0, norm2p == 0
    page[30:35, :] = 255
    return page


def _text_page(face):
    """Ink far inside a large page: the device sweeps an ink-bbox crop."""
    dopts = DecodeOptions(x_start=200, y_start=300, line_height=13, line_advance=15, width=110)
    return synthesize_page(face, ["AB01ab", "10BAba"], dopts, RenderOptions(size=11.0),
                           "AB01ab", (640, 512))


@pytest.mark.parametrize("case", ["cropped", "uncropped"])
def test_matcher_native_replay_matches_plain(faces, case, monkeypatch):
    """Through NccMatcher (device="cpu"): every swept group's candidates (K2's
    positions), remapped to the full page, replay identically in the host
    library, in focr_tpu's native tier, in the NumPy plain version and in
    K3's plain version, whose output the wave's plan holds; the matcher's
    hits equal focr_tpu's."""
    if case == "cropped":
        page, alphabet, kw = _text_page(faces[0]), "AB01ab", dict(x_bits=1, threshold=0.5)
        size = 11.0
    else:
        page, alphabet, kw = _noise_page(), "AbQ", dict(threshold=0.3)
        size = 13.0
    tm = torch_ncc.NccMatcher(faces[1], alphabet, TRenderOptions(size=size), device="cpu", **kw)
    positions = []

    def emit(*args):
        positions.append(compact_emit(*args))
        return positions[-1]

    monkeypatch.setattr(torch_ncc, "compact_emit", emit)
    (d,) = tm._sweep_wave([page])
    _, inv, plan, _, crop = d
    assert (tuple(crop[2:]) == page.shape) == (case == "uncropped")
    thr64 = np.float64(np.float32(tm.threshold))
    hits = 0
    for (grp, kind, data), pos in zip(plan, positions, strict=True):
        assert kind == "sweep"
        args = torch_ncc.replay_inputs(grp, (pos.numpy(), data[5]), inv, crop, thr64)
        got = _replay_key(ncc_cpu.replay_group(*args), args[2])
        assert got == _replay_key(torch_ncc.replay_group_reference(*args), args[2])
        assert got == _replay_key(jax_native.replay_group(*args), args[2])
        assert got == _replay_key(data[:5], args[2])  # K3's, in full-page coordinates
        hits += sum(k for k, *_ in got)
    assert hits > 0
    jm = jax_ncc.NccMatcher(faces[0], alphabet, RenderOptions(size=size), **kw)
    key = lambda hs: [(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in hs]
    assert key(tm.get_hits(page)) == key(jm.get_hits(page))


def test_collect_pool_counts_every_replay(faces, monkeypatch):
    """With the collect pool's threads busy (more pages than threads, a short
    switch interval), K3 replays every swept group of every wave once, in
    the dispatch stage — counted under a lock from whichever thread calls
    it, no lost update — the host library's replay never runs, and each page
    gets its get_hits result."""
    monkeypatch.setattr(torch_ncc, "WAVE", 6)
    page = _noise_page()
    rng = np.random.default_rng(5)
    pages = [np.roll(page, int(rng.integers(0, 70)), axis=1) for _ in range(12)]
    tm = torch_ncc.NccMatcher(faces[1], "AbQ", TRenderOptions(size=13.0), threshold=0.3,
                              device="cpu")
    singles = [tm.get_hits(p) for p in pages]
    replays = {"calls": 0, "threads": set()}
    lock = threading.Lock()

    def replay(*args):
        with lock:
            replays["calls"] += 1
            replays["threads"].add(threading.get_ident())
        return ncc_replay(*args)

    monkeypatch.setattr(torch_ncc, "ncc_replay", replay)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ncc_cpu.reset_native_calls()
        many = tm.get_hits_many(pages)
        calls = dict(ncc_cpu.NATIVE_CALLS)
    finally:
        sys.setswitchinterval(interval)
    waves = -(-len(pages) // torch_ncc.WAVE)
    assert replays["calls"] == waves * len(tm.groups) and len(replays["threads"]) == 1
    assert calls["replay_group"] == 0
    assert many == singles


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nw,nh", [(5, 7), (8, 8), (13, 9), (16, 4)])
def test_native_searcher_matches_oracle(seed, nw, nh):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    bank = rng.integers(0, 256, (3, nh, nw), dtype=np.uint8)
    for t, (x, y) in enumerate([(5, 9), (40, 30), (70, 50)]):
        img[y : y + nh, x : x + nw] = 255 - bank[t]
    o = Searcher(img)
    n = ncc_cpu.NativeSearcher(img)
    for thr in (0.5, 0.8, 0.95):
        want = [o.search(b, thr, warn=False) for b in bank]
        assert [n.search(b, thr, warn=False) for b in bank] == want
        assert n.search_many(bank, thr) == want
        assert any(want)


def test_native_searcher_cap_and_width_limit(capsys):
    """A periodic page floods matches: the scan-order cap and WARN agree
    with the oracle; needles wider than 16 px raise, as the oracle and the
    reference do."""
    rng = np.random.default_rng(3)
    img = np.tile(rng.integers(0, 256, (4, 4), dtype=np.uint8), (40, 40))
    needle = 255 - img[8:16, 8:16].copy()
    want = Searcher(img).search(needle, 0.5)
    err_o = capsys.readouterr().err
    n = ncc_cpu.NativeSearcher(img)
    assert n.search(needle, 0.5) == want and len(want) == MAX_MATCHES
    assert capsys.readouterr().err == err_o == f"WARN got >= {MAX_MATCHES} matches\n"
    wide = rng.integers(0, 256, (8, 17), dtype=np.uint8)
    with pytest.raises(NotImplementedError):
        n.search(wide, 0.5)
    with pytest.raises(NotImplementedError):
        n.search_many(wide[None], 0.5)


def _keys(seed, n_max=4000):
    """Sorted composite (y << 17) + x keys and their similarities."""
    rng = np.random.default_rng(seed)
    N = int(rng.integers(1, n_max))
    ys = rng.integers(0, 7, N).astype(np.int64) << 17
    xs = rng.integers(0, 600, N).astype(np.int64)
    # quantized sims force plenty of exact ties (the last-max surface)
    sim = (rng.integers(0, 8, N) / 8.0).astype(np.float32)
    return np.sort(ys + xs), sim


OVERLAPS = [-1, 0, 5, 1 << 40]


@pytest.mark.parametrize("ov", OVERLAPS)
@pytest.mark.parametrize("seed", range(3))
def test_post_winners_match_numpy(seed, ov):
    key, sim = _keys(seed)
    want = torch_post.run_winners_reference(key, sim, ov, len(key))
    np.testing.assert_array_equal(ncc_cpu.post_winners(key, sim, ov), want)
    np.testing.assert_array_equal(torch_post._run_winners(key, sim, ov, len(key)), want)


class _Letters:
    """A matcher's needle list as post-processing reads it: each needle's
    letter and pixel shape."""

    def __init__(self, letters):
        self.needles = [
            SimpleNamespace(letter=c, pixels=np.zeros((13, 8 + i % 2), np.uint8))
            for i, c in enumerate(letters)
        ]


ANCHOR = float(np.float32(0.95))
BELOW = float(np.nextafter(np.float32(0.95), np.float32(0)))


def _hits(nid, x, y, sim, matcher):
    return torch_ncc.HitStruct(
        needle_id=np.asarray(nid, np.int32), x=np.asarray(x, np.int64),
        y=np.asarray(y, np.int64), sim=np.asarray(sim, np.float32), matcher=matcher)


def _post_case(case, golden):
    """A list of HitStructs in engine order (hits grouped by needle, needles
    ascending) for one case of test_post_page_matches_reference."""
    rng = np.random.default_rng(len(case))
    m = _Letters("ABCDEFGHIJKL")
    if case == "golden":
        return golden
    if case == "empty":
        return [_hits([], [], [], [], m)]
    N = 3000
    nid = np.sort(rng.integers(0, 12, N))
    if case == "below-anchor":
        return [_hits(nid, rng.integers(0, 600, N), rng.integers(0, 8, N) * 15 + 9,
                      rng.choice([0.8, 0.9, BELOW], N), m)]
    if case == "random":
        return [_hits(nid, rng.integers(0, 600, N), rng.integers(0, 8, N) * 15 + 9,
                      rng.integers(70, 101, N) / 100.0, m)]
    if case == "u16":
        # coordinates at both ends of the reference's u16 range
        x = np.where(rng.random(N) < 0.5, rng.integers(0, 12, N), 65535 - rng.integers(0, 12, N))
        y = rng.choice([0, 1, 30000, 65534, 65535], N)
        return [_hits(nid, x, y, rng.choice([0.9, 0.95, 1.0], N), m)]
    if case == "duplicates":
        # (y, x) pairs repeated across needles with equal f32 similarities:
        # the later hit in engine order wins each run
        pair = _hits([0, 1, 2], [5, 5, 40], [10, 10, 10], [0.97, 0.97, 0.96], m)
        return [pair, _hits(nid, rng.integers(0, 4, N), rng.choice([3, 18], N),
                            rng.choice([0.95, 0.97], N), m)]
    if case == "at-anchor":
        # lines whose best hit is exactly the f32 anchor keep their hits;
        # lines whose best is one ulp below it lose them
        y = rng.integers(0, 10, N) * 15
        best = np.where(y % 30 == 0, ANCHOR, BELOW)
        return [_hits(nid, rng.integers(0, 300, N), y,
                      np.where(rng.random(N) < 0.3, best, 0.85), m)]
    assert case == "lines"
    # many lines, half of them with no anchor at all
    y = rng.integers(0, 40, N) * 13
    sim = np.where(y % 26 == 0, rng.choice([0.9, 0.96, 0.99], N), rng.choice([0.8, 0.9], N))
    return [_hits(nid, rng.integers(0, 700, N), y, sim, m)]


@pytest.fixture(scope="module")
def golden_hits():
    """The hits the port's matcher gives on the top 200 rows (the first
    lines of text) of the ncc cell's first two dense pages, with the cell's
    bank and thresholds."""
    from focr_tpu_torch.fonts.bank import load_needle_bank
    from focr_tpu_torch.models.types import NCC_DEFAULT_ALPHABET

    with np.load(GOLDEN, allow_pickle=False) as z:
        pages = [p[:200].copy() for p in z["pages"][:2]]
    needles, _ = load_needle_bank(GOLDEN)
    tm = torch_ncc.NccMatcher(None, NCC_DEFAULT_ALPHABET, TRenderOptions(size=13.0), x_bits=2,
                              threshold=0.8, device="cpu", needles=needles)
    return tm.get_hits_many(pages, struct=True)


POST_CASES = ["empty", "below-anchor", "random", "u16", "duplicates", "at-anchor", "lines",
              "golden"]


@pytest.mark.parametrize("ov", OVERLAPS)
@pytest.mark.parametrize("case", POST_CASES)
def test_post_page_matches_reference(case, ov, request):
    """One host-library call a page (post_page) against the plain versions:
    _winner_arrays against winner_arrays_reference, and process_hits_text
    and process_hits_struct against the object-form process_hits."""
    golden = request.getfixturevalue("golden_hits") if case == "golden" else None
    assert not isinstance(build.load_host(), ctypes.PyDLL)  # a CDLL drops the GIL
    for hs in _post_case(case, golden):
        calls = ncc_cpu.NATIVE_CALLS["post_page"]
        a = torch_post._winner_arrays(hs, 0.95, ov)
        b = torch_post.winner_arrays_reference(hs, 0.95, ov)
        assert (a is None) == (b is None)
        for ai, bi in zip(a or (), b or ()):
            np.testing.assert_array_equal(ai, bi)
        letters = [nd.letter for nd in hs.matcher.needles]
        objs = [MatchWithLetter(letters[i], int(x), int(y), nd.pixels.shape[1],
                                nd.pixels.shape[0], float(s))
                for i, x, y, s, nd in zip(hs.needle_id.tolist(), hs.x.tolist(), hs.y.tolist(),
                                          hs.sim.tolist(),
                                          (hs.matcher.needles[i] for i in hs.needle_id))]
        want = torch_post.process_hits(objs, 0.95, ov)
        assert torch_post.process_hits_text(hs, 0.95, ov) == [
            "".join(m.letter for m in line) for line in want]
        assert torch_post.process_hits_struct(hs, 0.95, ov) == want
        assert ncc_cpu.NATIVE_CALLS["post_page"] == calls + 3
    if case == "duplicates" and ov >= 0:
        assert torch_post.process_hits_text(_post_case(case, None)[0], 0.95, ov)[0][0] == "B"
    assert (b is None) == (case in ("empty", "below-anchor"))


def test_post_page_rejects_out_of_range_input():
    """Coordinates outside the reference's u16 range (ncc.rs:66-72), and
    needle ids outside the code table, raise."""
    m = _Letters("AB")
    codes = torch_post._needle_tables(m)[3]
    for x, y in ((65536, 3), (3, 65536), (-1, 3), (3, -1)):
        with pytest.raises(ValueError, match="0..65535"):
            ncc_cpu.post_page(np.array([3, y]), np.array([3, x]), np.ones(2, np.float32),
                              np.zeros(2, np.int32), codes, 0.95, 5)
    for bad in (-1, 2):
        with pytest.raises(ValueError, match="needle id"):
            ncc_cpu.post_page(np.array([3, 3]), np.array([3, 9]), np.ones(2, np.float32),
                              np.array([0, bad], np.int32), codes, 0.95, 5)
    assert torch_post.process_hits_text(_hits([0, 1], [0, 65535], [65535, 65535], [1, 1], m),
                                        0.95, 5) == ["AB"]


def test_post_page_threads_agree():
    """The collect threads post pages at once: 8 threads, each posting its
    own pages of other sizes over and over (each thread's scratch grows and
    shrinks), get what posting them one after another gives."""
    m = _Letters("ABCDEFGHIJKL")
    rng = np.random.default_rng(5)
    pages = []
    for k in range(16):
        N = int(rng.integers(1, 6000))
        pages.append(_hits(np.sort(rng.integers(0, 12, N)), rng.integers(0, 40 + 200 * k, N),
                           rng.integers(0, 3 + k, N) * 15, rng.integers(80, 101, N) / 100.0, m))
    want = [torch_post.process_hits_text(hs, 0.95, 5) for hs in pages]
    got = {}

    def work(t):
        mine = [(t + 3 * i) % len(pages) for i in range(len(pages))]
        got[t] = all(torch_post.process_hits_text(pages[i], 0.95, 5) == want[i]
                     for _ in range(10) for i in mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert got == {t: True for t in range(8)} and any(want)


@pytest.mark.parametrize("ov", OVERLAPS)
def test_winner_arrays_match_numpy(ov):
    """_winner_arrays (one host-library call) against its NumPy plain
    version on HitStructs, the overlap clamp included."""
    rng = np.random.default_rng(17)
    for trial in range(6):
        N = int(rng.integers(1, 3000))
        hs = torch_ncc.HitStruct(
            needle_id=np.sort(rng.integers(0, 50, N)).astype(np.int32),
            x=rng.integers(0, 600, N).astype(np.int64),
            y=(rng.integers(0, 8, N) * 15 + 9).astype(np.int64),
            sim=(rng.integers(70, 101, N) / 100.0).astype(np.float32),
            matcher=_Letters([chr(65 + i) for i in range(50)]),
        )
        a = torch_post._winner_arrays(hs, 0.95, ov)
        b = torch_post.winner_arrays_reference(hs, 0.95, ov)
        assert (a is None) == (b is None)
        for ai, bi in zip(a or (), b or ()):
            np.testing.assert_array_equal(ai, bi, err_msg=f"trial {trial}")


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_host_build_raises(faces, monkeypatch, tmp_path, compiler):
    """A host library that cannot be built makes the ncc path raise with the
    compiler's words where it needs the library (post-processing's native
    scan); it never answers from the NumPy versions, and the host replay,
    which K3 took off the path, is never called."""
    if compiler == "missing":
        cxx, words = str(tmp_path / "no-such-g++"), "no-such-g++"
    else:
        cxx, words = str(tmp_path / "broken-g++"), "broken compiler says no"
        with open(cxx, "w") as f:
            f.write('#!/bin/sh\ncase "$1" in --version|-march=native) echo broken 1.0; '
                    f'exit 0;; esac\necho "{words}" >&2\nexit 1\n')
        (tmp_path / "broken-g++").chmod(0o755)
    page = _noise_page()
    tm = torch_ncc.NccMatcher(faces[1], "AbQ", TRenderOptions(size=13.0), threshold=0.3,
                              device="cpu")
    monkeypatch.setattr(build, "HOST_CXX", cxx)
    monkeypatch.setattr(build, "_host_lib", None)
    ncc_cpu.reset_native_calls()
    with pytest.raises(RuntimeError, match=words):
        torch_post.process_hits_struct(tm.get_hits_many([page], struct=True)[0], 0.3, 5)
    with pytest.raises(RuntimeError, match=words):
        tm.get_hits_many([page, page], struct=True,
                         post=lambda hs: torch_post.process_hits_text(hs, 0.3, 5))
    assert ncc_cpu.NATIVE_CALLS["replay_group"] == 0


def test_built_cuda_library_loads_without_nvcc(monkeypatch, tmp_path):
    """A CUDA library already at library_path() is returned without asking
    for nvcc, whose absence would raise; its name does not depend on which
    nvcc is on PATH."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc", no_nvcc)
    name = build.library_path()
    assert name.startswith(str(tmp_path))
    open(name, "wb").close()
    assert build.build() == name
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.library_path() == name
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(report=True)  # a build asks for the compiler


def test_host_library_path_runs_no_compiler(monkeypatch):
    """host_library_path() starts no subprocess: the host CPU's model and
    flags come from /proc/cpuinfo, and the name covers the compiler's name
    and flags."""
    import subprocess

    def refuse(*args, **kwargs):
        raise AssertionError(f"host_library_path started a subprocess: {args}")

    name = build.host_library_path()
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(subprocess, "check_output", refuse)
    assert build.host_library_path() == name
    assert build._host_cpu()
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("-DX",))
    assert build.host_library_path() != name
    monkeypatch.setattr(build, "HOST_CXX", "clang++")
    assert build.host_library_path() != name


@pytest.mark.parametrize("thr", [0.8, -0.2])
def test_direct_search_matches_focr_tpu(thr):
    """The width-unlimited direct checker on a 21x13 needle (the -t 20 size)
    planted in a sparse page, uncapped."""
    rng = np.random.default_rng(31)
    page = 255 - ((rng.random((70, 90)) < 0.15) * rng.integers(0, 256, (70, 90))).astype(np.uint8)
    needle = rng.integers(0, 256, (21, 13), dtype=np.uint8)
    for y, x in [(3, 4), (30, 50), (45, 70)]:
        page[y : y + 21, x : x + 13] = 255 - needle
    want = jax_direct_search(page, needle, thr, cap=1 << 20)
    got = direct_search(page, needle, thr, cap=1 << 20)
    key = lambda ms: [(m.x, m.y, m.w, m.h, np.float32(m.similarity).tobytes()) for m in ms]
    assert key(got) == key(want) and len(got) >= 3
