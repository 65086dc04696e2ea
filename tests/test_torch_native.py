"""focr_tpu_torch's ncc host tier (native/ncc_cpu.py over csrc/ncc_host.cpp)
against focr_tpu's native tier and against the port's plain NumPy versions,
on the CPU, exactly: f32 similarity bytes, coordinates, counts, warn flags
and winner indices."""

import sys

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
from focr_tpu_torch.models.types import MAX_MATCHES, RenderOptions as TRenderOptions
from focr_tpu_torch.native import build, ncc_cpu
from focr_tpu_torch.ops.ncc import word_stride
from focr_tpu_torch.oracle.ncc_direct import direct_search
from focr_tpu_torch.oracle.ncc_oracle import Searcher

torch.set_num_threads(2)


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
def test_matcher_native_replay_matches_plain(faces, case):
    """Through NccMatcher (device="cpu"): every swept group's candidates,
    remapped to the full page, replay identically in the host library, in
    focr_tpu's native tier and in the NumPy plain version; the matcher's hits
    equal focr_tpu's."""
    if case == "cropped":
        page, alphabet, kw = _text_page(faces[0]), "AB01ab", dict(x_bits=1, threshold=0.5)
        size = 11.0
    else:
        page, alphabet, kw = _noise_page(), "AbQ", dict(threshold=0.3)
        size = 13.0
    tm = torch_ncc.NccMatcher(faces[1], alphabet, TRenderOptions(size=size), device="cpu", **kw)
    (d,) = tm._sweep_wave([page])
    _, inv, plan, _, crop = d
    assert (tuple(crop[2:]) == page.shape) == (case == "uncropped")
    thr64 = np.float64(np.float32(tm.threshold))
    hits = 0
    for grp, kind, data in plan:
        assert kind == "sweep"
        args = torch_ncc.replay_inputs(grp, data, inv, crop, thr64)
        got = _replay_key(ncc_cpu.replay_group(*args), args[2])
        assert got == _replay_key(torch_ncc.replay_group_reference(*args), args[2])
        assert got == _replay_key(jax_native.replay_group(*args), args[2])
        hits += sum(k for k, *_ in got)
    assert hits > 0
    jm = jax_ncc.NccMatcher(faces[0], alphabet, RenderOptions(size=size), **kw)
    key = lambda hs: [(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in hs]
    assert key(tm.get_hits(page)) == key(jm.get_hits(page))


def test_collect_pool_counts_every_replay(faces, monkeypatch):
    """The collect pool's threads (more pages than threads, a short switch
    interval) replay every swept group of every page once — no lost update
    of the shared call counter — and give each page its get_hits result."""
    monkeypatch.setattr(torch_ncc, "WAVE", 6)
    page = _noise_page()
    rng = np.random.default_rng(5)
    pages = [np.roll(page, int(rng.integers(0, 70)), axis=1) for _ in range(12)]
    tm = torch_ncc.NccMatcher(faces[1], "AbQ", TRenderOptions(size=13.0), threshold=0.3,
                              device="cpu")
    singles = [tm.get_hits(p) for p in pages]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ncc_cpu.reset_native_calls()
        many = tm.get_hits_many(pages)
        calls = dict(ncc_cpu.NATIVE_CALLS)
    finally:
        sys.setswitchinterval(interval)
    assert calls["replay_group"] == len(pages) * len(tm.groups)
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


def _keys(seed, n_max=4000, shift=17, sort=False):
    rng = np.random.default_rng(seed)
    N = int(rng.integers(1, n_max))
    ys = rng.integers(0, 7, N).astype(np.int64) << shift
    xs = rng.integers(0, 600, N).astype(np.int64)
    key = np.sort(ys + xs) if sort else ys + xs
    # quantized sims force plenty of exact ties (the last-max surface)
    sim = (rng.integers(0, 8, N) / 8.0).astype(np.float32)
    return key, sim


OVERLAPS = [-1, 0, 5, 1 << 40]


@pytest.mark.parametrize("ov", OVERLAPS)
@pytest.mark.parametrize("seed", range(3))
def test_post_winners_match_numpy(seed, ov):
    key, sim = _keys(seed, sort=True)
    want = torch_post.run_winners_reference(key, sim, ov, len(key))
    np.testing.assert_array_equal(ncc_cpu.post_winners(key, sim, ov), want)
    np.testing.assert_array_equal(torch_post._run_winners(key, sim, ov, len(key)), want)


@pytest.mark.parametrize("ov", OVERLAPS)
@pytest.mark.parametrize("shift", [17, 33, 49], ids=["2-pass", "3-pass", "4-pass"])
def test_post_sort_winners_match_sort_then_scan(shift, ov):
    """Unsorted keys with duplicates (the stability surface); keys past 2³²
    and 2⁴⁸ force the radix sort's third and fourth digit passes."""
    key, sim = _keys(100 + shift, shift=shift)
    order = np.argsort(key, kind="stable")
    want = order[torch_post.run_winners_reference(key[order], sim[order], ov, len(key))]
    np.testing.assert_array_equal(ncc_cpu.post_sort_winners(key, sim, ov), want)


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
            matcher=None,
        )
        a = torch_post._winner_arrays(hs, 0.95, ov)
        b = torch_post.winner_arrays_reference(hs, 0.95, ov)
        assert (a is None) == (b is None)
        for ai, bi in zip(a or (), b or ()):
            np.testing.assert_array_equal(ai, bi, err_msg=f"trial {trial}")


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_host_build_raises(faces, monkeypatch, tmp_path, compiler):
    """A host library that cannot be built makes the matcher raise with the
    compiler's words; it never answers from the NumPy replay."""
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
        tm.get_hits(page)
    with pytest.raises(RuntimeError, match=words):
        tm.get_hits_many([page, page])
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
