"""K3, the exact f64 replay (focr_tpu_torch/ops/replay_kernels.py: the
wrapper and its plain PyTorch version; csrc/ncc_replay.cu runs only on a
card), on the CPU against the three host replays — focr_tpu's native tier
(focr_tpu/native/ncc_cpu.py::replay_group), the port's
(native/ncc_cpu.py::replay_group) and the port's NumPy version
(models/ncc.py::replay_group_reference) — bit for bit: coordinates, the f32
similarities' bits, counts and WARN flags. The candidates are the ones K1 and
K2 (their plain versions) give the matcher's own wave, inverted and
ink-cropped as the dispatch stage does it."""

from pathlib import Path

import numpy as np
import pytest
import torch

from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import random_text_lines, synthesize_page
from focr_tpu.models import ncc as jax_ncc
from focr_tpu.models.types import DecodeOptions, NCC_DEFAULT_ALPHABET, RenderOptions
from focr_tpu.native import ncc_cpu as jax_native
from focr_tpu_torch.fonts.bank import load_needle_bank
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.models import ncc as torch_ncc
from focr_tpu_torch.models.types import (
    MAX_MATCHES, BoxSize as TBoxSize, RenderOptions as TRenderOptions,
)
from focr_tpu_torch.native import ncc_cpu
from focr_tpu_torch.ops import ncc_kernels, replay_kernels

torch.set_num_threads(2)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_ncc_golden.npz"


def _noisy_text_page(seed: int, mono_font_path: str):
    """tests/test_fuzz_parity.py::test_fuzz_ncc_device_vs_oracle's page and
    matcher settings for ``seed``: synthesized text with 2% salt-and-pepper
    noise, a random size, grid, alphabet, box policy and threshold."""
    rng = np.random.default_rng(100 + seed)
    face = Face(mono_font_path)
    size = float(rng.choice([9.0, 11.0, 13.0]))
    dopts = DecodeOptions(
        x_start=int(rng.integers(0, 8)), y_start=int(rng.integers(0, 8)),
        line_height=int(rng.integers(10, 16)), line_advance=int(rng.integers(14, 19)),
        width=int(rng.integers(60, 120)),
    )
    alphabet = "".join(rng.choice(list("ABXab01+/=:"), size=5, replace=False))
    shape = (int(rng.integers(48, 90)), int(rng.integers(90, 150)))
    lines = random_text_lines(rng, alphabet, int(rng.integers(1, 4)), int(rng.integers(3, 9)))
    page = synthesize_page(face, lines, dopts, RenderOptions(size=size), alphabet, shape).copy()
    mask = rng.random(page.shape) < 0.02
    page[mask] = rng.integers(0, 256, int(mask.sum()), dtype=np.uint8)
    threshold = float(rng.uniform(0.3, 0.9))
    box = str(rng.choice(["font", "alphabet", "char"]))
    kw = dict(box_size=TBoxSize(box), x_bits=int(rng.integers(0, 2)),
              y_bits=int(rng.integers(0, 2)), threshold=threshold)
    return page, alphabet, size, kw


def _low_variance_page(seed: int):
    """tests/test_fuzz_parity.py::test_fuzz_adversarial_low_variance's page
    for ``seed``: a near-uniform dark page with sparse ±3 deltas (zero-variance
    windows: NaN similarities), needles 'il.' boxed per character."""
    rng = np.random.default_rng(300 + seed)
    H, W = 56, 96
    page = np.full((H, W), 255 - int(rng.integers(230, 246)), dtype=np.uint8)
    n_spots = int(rng.integers(5, 30))
    ys, xs = rng.integers(0, H, n_spots), rng.integers(0, W, n_spots)
    page[ys, xs] = np.clip(page[ys, xs].astype(int) + rng.integers(-3, 4, n_spots), 0,
                           255).astype(np.uint8)
    return page, "il.", 11.0, dict(box_size=TBoxSize.CHAR,
                                   threshold=float(rng.uniform(0.2, 0.9)))


def _wave(tm, pages, crop=True):
    """The matcher's dispatch of one wave of same-shape pages, group by
    group, on the plain versions: (group, device group, inverted pages, crop,
    cropped pages, K2's positions, offsets and counts) of each swept group."""
    inv = np.stack([255 - p for p in pages]).astype(np.uint8)
    H, W = inv.shape[1:]
    y0, x0, Hc, Wc = torch_ncc._ink_crop(inv, H, W, tm.groups) if crop else (0, 0, H, W)
    inv_c = torch.from_numpy(np.ascontiguousarray(inv[:, y0 : y0 + Hc, x0 : x0 + Wc]))
    out = []
    for grp, dg in zip(tm.groups, tm.dev_groups):
        if grp.nh >= Hc or grp.nw >= Wc:
            continue
        mask, rcnt = ncc_kernels.ncc_sweep(inv_c, dg.bank, dg.s_n, dg.s2_n, tm.threshold,
                                           terms=dg.terms)
        pos, off, hcnt, _ = ncc_kernels.compact_hits(mask, rcnt)
        out.append((grp, dg, inv, (y0, x0, Hc, Wc), inv_c, pos, off, hcnt))
    return out


def _key(out, starts):
    """Each needle's hits (count, warn, x, y, f32 sim bytes)."""
    out_x, out_y, out_sim, counts, warn = out
    per = []
    for t, k in enumerate(np.asarray(counts).tolist()):
        s = slice(int(starts[t]), int(starts[t]) + k)
        per.append((k, int(warn[t]), np.asarray(out_x[s]).astype(np.int64).tolist(),
                    np.asarray(out_y[s]).astype(np.int64).tolist(),
                    np.asarray(out_sim[s], np.float32).tobytes()))
    return per


def _k3_keys(buf, off, hcnt):
    """_key of K3's output, page by page."""
    B, T = hcnt.shape
    x, y, sim, counts, warn = (v.numpy() for v in replay_kernels.split_replay(
        buf, int(off[-1]), B, T))
    starts = off[:-1, None].numpy() + np.cumsum(hcnt.numpy(), 1, dtype=np.int64) - hcnt.numpy()
    return [_key((x, y, sim, counts[b], warn[b]), starts[b]) for b in range(B)]


def _check_against_host(tm, pages, max_matches=MAX_MATCHES, thr_f64=None, crop=True):
    """K3 (the wrapper, on CPU tensors: its plain version) against the three
    host replays on every swept group of the wave. Returns (candidates,
    hits, K3's keys by group)."""
    thr = float(np.float32(tm.threshold)) if thr_f64 is None else thr_f64
    n_cand = n_hits = 0
    keys = []
    for grp, dg, inv, crop_, inv_c, pos, off, hcnt in _wave(tm, pages, crop):
        y0, x0 = crop_[:2]
        buf = replay_kernels.ncc_replay(inv_c, pos, off, hcnt, dg.replay, thr, y0, x0,
                                        max_matches)
        got = _k3_keys(buf, off, hcnt)
        for b in range(len(pages)):
            data = (pos[off[b] : off[b + 1]].numpy(), hcnt[b].numpy())
            args = (*torch_ncc.replay_inputs(grp, data, inv[b], crop_, thr)[:-1], max_matches)
            want = _key(ncc_cpu.replay_group(*args), args[2])
            assert got[b] == want
            assert _key(jax_native.replay_group(*args), args[2]) == want
            assert _key(torch_ncc.replay_group_reference(*args), args[2]) == want
            n_hits += sum(k for k, *_ in want)
        n_cand += len(pos)
        keys.append(got)
    return n_cand, n_hits, keys


@pytest.mark.parametrize("seed", range(6))
def test_noisy_text_pages_match_host_replays(mono_font_path, seed):
    page, alphabet, size, kw = _noisy_text_page(seed, mono_font_path)
    tm = torch_ncc.NccMatcher(TFace(mono_font_path), alphabet, TRenderOptions(size=size),
                              device="cpu", **kw)
    n_cand, _, _ = _check_against_host(tm, [page, np.roll(page, 7, axis=1)])
    assert n_cand > 0


@pytest.mark.parametrize("seed", range(4))
def test_low_variance_pages_match_host_replays(mono_font_path, seed):
    """Zero-variance windows give NaN similarities, which fail the accept
    test in every replay alike."""
    page, alphabet, size, kw = _low_variance_page(seed)
    tm = torch_ncc.NccMatcher(TFace(mono_font_path), alphabet, TRenderOptions(size=size),
                              device="cpu", **kw)
    n_cand, n_hits, _ = _check_against_host(tm, [page])
    assert n_cand > 10 * n_hits  # most candidates are flat windows, rejected


def _text_matcher(mono_font_path, **kw):
    tm = torch_ncc.NccMatcher(TFace(mono_font_path), "AB01ab", TRenderOptions(size=11.0),
                              device="cpu", x_bits=1, **kw)
    dopts = DecodeOptions(x_start=30, y_start=20, line_height=13, line_advance=15, width=110)
    pages = [synthesize_page(Face(mono_font_path), lines, dopts, RenderOptions(size=11.0),
                             "AB01ab", (96, 180)).copy()
             for lines in (["AB01ab", "ba10BA"], ["0a1b", "AAB"])]
    return tm, pages


def test_threshold_at_a_candidates_exact_sim(mono_font_path):
    """A threshold equal to one candidate's exact f64 similarity rejects
    that candidate (the test is strict), in K3 and in every host replay."""
    tm, pages = _text_matcher(mono_font_path, threshold=0.5)
    grp, dg, inv, (y0, x0, _, _), inv_c, pos, off, hcnt = _wave(tm, pages)[0]
    # the similarity of needle 0's first hit on page 0, computed here exactly
    buf = replay_kernels.ncc_replay(inv_c, pos, off, hcnt, dg.replay, float(np.float32(0.5)),
                                    y0, x0, MAX_MATCHES)
    x, y, *_ = replay_kernels.split_replay(buf, len(pos), *hcnt.shape)
    t = int(np.flatnonzero(hcnt[0].numpy())[0])
    start = int(off[0]) + int(hcnt[0, :t].sum())
    hx, hy = int(x[start]), int(y[start])
    win = inv[0, hy : hy + grp.nh, hx : hx + grp.nw].astype(np.int64)
    sim = torch_ncc.exact_similarities(
        np.array([(win * grp.bank[t]).sum()]), np.array([win.sum()]), np.array([(win**2).sum()]),
        int(grp.s_n[t]), int(grp.s2_n[t]), grp.nh * grp.nw)[0]
    _, _, keys = _check_against_host(tm, pages, thr_f64=float(sim))
    kept = keys[0][0][t]
    assert (hx, hy) not in set(zip(kept[2], kept[3]))
    _, _, below = _check_against_host(tm, pages, thr_f64=float(np.nextafter(sim, -1.0)))
    assert (hx, hy) in set(zip(below[0][0][t][2], below[0][0][t][3]))


def test_max_matches_cap_and_warn(mono_font_path):
    """A small max_matches keeps each needle's first hits in scan order and
    raises its WARN flag, as the host replays do."""
    tm, pages = _text_matcher(mono_font_path, threshold=0.3)
    _, n_hits, keys = _check_against_host(tm, pages, max_matches=3)
    flat = [k for g in keys for page in g for k in page]
    assert n_hits > 0 and any(w for _, w, *_ in flat) and max(k for k, *_ in flat) == 3


def test_needles_wider_than_16(mono_font_path):
    """A group of needles 21 pixels wide (the host library's generic
    instance; the reference itself panics past 16)."""
    rng = np.random.default_rng(3)
    bank = rng.integers(0, 256, (4, 9, 21), dtype=np.uint8)
    page = np.full((70, 130), 255, np.uint8)
    page[20:50, 10:120] = rng.integers(0, 256, (30, 110), dtype=np.uint8)
    for t, (y, x) in enumerate([(22, 15), (30, 60), (40, 90), (25, 40)]):
        page[y : y + 9, x : x + 21] = 255 - bank[t]
    needles = [torch_ncc.Needle(letter=c, offset=(0.0, 0.0), corrected_offset=(0.0, 0.0),
                                pixels=bank[t], s_n=int(bank[t].astype(np.int64).sum()),
                                s2_n=int((bank[t].astype(np.int64) ** 2).sum()))
               for t, c in enumerate("wxyz")]
    tm = torch_ncc.NccMatcher(None, "wxyz", TRenderOptions(size=13.0), threshold=0.4,
                              device="cpu", needles=needles)
    assert [g.nw for g in tm.groups] == [21]
    _, n_hits, _ = _check_against_host(tm, [page])
    assert n_hits >= 4


def test_cropped_and_uncropped_waves_agree(mono_font_path):
    """The dispatch stage sweeps and replays the wave's ink crop; the same
    wave uncropped gives the same full-page hits."""
    tm = torch_ncc.NccMatcher(TFace(mono_font_path), "AB01ab", TRenderOptions(size=11.0),
                              device="cpu", x_bits=1, threshold=0.5)
    dopts = DecodeOptions(x_start=200, y_start=300, line_height=13, line_advance=15, width=110)
    page = synthesize_page(Face(mono_font_path), ["AB01ab", "10BAba"], dopts,
                           RenderOptions(size=11.0), "AB01ab", (640, 512))
    _, hits_c, cropped = _check_against_host(tm, [page])
    _, hits_u, uncropped = _check_against_host(tm, [page], crop=False)
    assert hits_c == hits_u > 0 and cropped == uncropped
    assert _wave(tm, [page])[0][3] != (0, 0, *page.shape)


def test_group_without_candidates(mono_font_path):
    """A wave whose sweep keeps no candidate: K3 writes zero counts and no
    WARN, as the host replays do."""
    tm, pages = _text_matcher(mono_font_path, threshold=0.9)
    blank = [np.full_like(pages[0], 255), np.full_like(pages[0], 255)]
    blank[0][40, 40] = 0  # one dot: ink, but nothing a needle matches
    n_cand, n_hits, keys = _check_against_host(tm, blank)
    assert n_cand == n_hits == 0
    assert all(k == 0 and not w for g in keys for page in g for k, w, *_ in page)


def test_golden_pages_match_focr_tpu(mono_font_path):
    """The canonical configuration (the fixture's 296 needles, --x-bits 2)
    on a CPU slot, K3's plain version replaying, against focr_tpu's
    get_hits_many on a band of two golden pages: positions and f32
    similarity bits identical. The host replay is not called."""
    with np.load(FIXTURE, allow_pickle=False) as z:
        pages = [p[240:360].copy() for p in z["pages"][:2]]
    needles, _ = load_needle_bank(str(FIXTURE))
    tm = torch_ncc.NccMatcher(None, NCC_DEFAULT_ALPHABET, TRenderOptions(size=13.0), x_bits=2,
                              threshold=0.8, device="cpu", needles=needles)
    jm = jax_ncc.NccMatcher(Face(mono_font_path), NCC_DEFAULT_ALPHABET, RenderOptions(size=13.0),
                            x_bits=2, threshold=0.8)
    ncc_cpu.reset_native_calls()
    got = tm.get_hits_many(pages, struct=True)
    assert ncc_cpu.NATIVE_CALLS["replay_group"] == 0
    want = jm.get_hits_many(pages, struct=True)
    for g, w in zip(got, want, strict=True):
        assert len(g.x) > 1000
        assert np.array_equal(g.needle_id, w.needle_id)
        assert np.array_equal(g.x, w.x) and np.array_equal(g.y, w.y)
        assert g.sim.tobytes() == w.sim.tobytes()


def test_wrapper_raises_on_other_devices():
    """K3's wrapper takes CPU tensors (the plain version) and CUDA tensors
    (the kernel); any other device raises, with no fallback."""
    meta = dict(device="meta")
    args = (torch.empty((1, 20, 30), dtype=torch.uint8, **meta),
            torch.empty(0, dtype=torch.int32, **meta), torch.empty(2, dtype=torch.int64, **meta),
            torch.empty((1, 2), dtype=torch.int32, **meta),
            replay_kernels.replay_needles(torch.empty((2, 5, 4), dtype=torch.uint8, **meta),
                                          torch.empty(2, dtype=torch.int64, **meta),
                                          torch.empty(2, dtype=torch.int64, **meta)))
    with pytest.raises(ValueError, match="unsupported device meta"):
        replay_kernels.ncc_replay(*args, 0.5, 0, 0, MAX_MATCHES)
    replay_kernels.reset_launches()
    assert replay_kernels.LAUNCHES == {"ncc_replay": 0}


def test_wrapper_checks_its_arguments():
    """Wrong types or shapes raise before anything runs: the needles when
    they are checked (once, where the device group is built), the rest at
    the call."""
    imgs = torch.zeros((2, 20, 30), dtype=torch.uint8)
    bank = torch.zeros((3, 5, 4), dtype=torch.uint8)
    s = torch.zeros(3, dtype=torch.int64)
    pos = torch.zeros(0, dtype=torch.int32)
    off = torch.zeros(3, dtype=torch.int64)
    hcnt = torch.zeros((2, 3), dtype=torch.int32)
    buf = replay_kernels.ncc_replay(imgs, pos, off, hcnt,
                                    replay_kernels.replay_needles(bank, s, s), 0.5, 0, 0, 4)
    assert buf.numel() == replay_kernels.replay_nbytes(0, 2, 3)
    for bad in (dict(pos=pos.to(torch.int64)), dict(hcnt=hcnt[:1]), dict(off=off[:2]),
                dict(bank=bank.to(torch.int32))):
        a = dict(imgs=imgs, pos=pos, off=off, hcnt=hcnt, bank=bank, s_n=s, s2_n=s)
        a.update(bad)
        with pytest.raises(ValueError, match="ncc_replay"):
            replay_kernels.ncc_replay(
                a["imgs"], a["pos"], a["off"], a["hcnt"],
                replay_kernels.replay_needles(a["bank"], a["s_n"], a["s2_n"]), 0.5, 0, 0, 4)
