"""focr_tpu_torch's NccMatcher (device="cpu": the kernels' plain PyTorch
versions) against focr_tpu's NccMatcher, on the CPU, exactly: hit tuples with
f32 similarity bytes, decoded text, and the converted device groups."""

from pathlib import Path

import numpy as np
import pytest
import torch

from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import synthesize_page
from focr_tpu.models import ncc as jax_ncc
from focr_tpu.models.post import process_hits_text as jax_process_hits_text
from focr_tpu.models.types import BoxSize, DecodeOptions, NCC_DEFAULT_ALPHABET, RenderOptions
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.models import ncc as torch_ncc
from focr_tpu_torch.models.post import process_hits_text
from focr_tpu_torch.models.types import BoxSize as TBoxSize, RenderOptions as TRenderOptions

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def faces(mono_font_path):
    return Face(mono_font_path), TFace(mono_font_path)


def key(hits):
    return [
        (h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hits
    ]


def _pair(faces, alphabet, size=13.0, box="alphabet", **kw):
    jm = jax_ncc.NccMatcher(
        faces[0], alphabet, RenderOptions(size=size), box_size=BoxSize(box), **kw
    )
    tm = torch_ncc.NccMatcher(
        faces[1], alphabet, TRenderOptions(size=size), box_size=TBoxSize(box),
        device="cpu", **kw,
    )
    return jm, tm


def _noise_page():
    rng = np.random.default_rng(0)
    page = rng.integers(0, 256, size=(60, 70), dtype=np.uint8)
    page[10:20, 10:20] = 128  # sp > 0, norm2p == 0
    page[30:35, :] = 255
    return page


# the pages and matchers of tests/test_ncc_engine.py:23-55
ENGINE_CASES = {
    "noise": (_noise_page, "AbQ", dict(threshold=0.3)),
    "offsets": (
        lambda: np.random.default_rng(1).integers(100, 256, size=(50, 60), dtype=np.uint8),
        "ai", dict(x_bits=1, y_bits=1, threshold=0.25),
    ),
    "char-box": (
        lambda: np.random.default_rng(2).integers(0, 256, size=(40, 50), dtype=np.uint8),
        "lI.", dict(box="char", threshold=0.3),
    ),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_matcher_hits_match_focr_tpu(faces, case):
    make, alphabet, kw = ENGINE_CASES[case]
    page = make()
    jm, tm = _pair(faces, alphabet, **kw)
    want = jm.get_hits(page)
    got = tm.get_hits(page)
    assert len(want) > 0
    assert key(got) == key(want)
    assert key(got) == key(tm.get_hits_oracle(page))


def test_synth_page_text_matches_focr_tpu(faces):
    """A small dense page of the canonical configuration (74 letters,
    --x-bits 2, size 13): identical decoded text through the text post."""
    rng = np.random.default_rng(3)
    lines = ["".join(rng.choice(list(NCC_DEFAULT_ALPHABET), 36)) for _ in range(8)]
    dopts = DecodeOptions(x_start=6, y_start=8, line_height=12, line_advance=15, width=300)
    page = synthesize_page(
        faces[0], lines, dopts, RenderOptions(size=13.0), NCC_DEFAULT_ALPHABET, (200, 320)
    )
    jm, tm = _pair(faces, NCC_DEFAULT_ALPHABET, x_bits=2)
    want = jm.get_hits_many(
        [page], struct=True, post=lambda hs: jax_process_hits_text(hs, 0.95, 5)
    )
    got = tm.get_hits_many(
        [page], struct=True, post=lambda hs: process_hits_text(hs, 0.95, 5)
    )
    assert len(want[0]) == 8
    assert got == want


def test_group_from_numpy_matches_port_groups(faces):
    """focr_tpu's size groups, carried over by group_from_numpy, equal the
    port's own device groups (banks, sums and the derived f32 terms)."""
    jm, tm = _pair(faces, NCC_DEFAULT_ALPHABET, x_bits=2)
    jgroups = jax_ncc._group_needles(jm.needles)
    assert [(g.nh, g.nw, g.needle_ids) for g in jgroups] == [
        (g.nh, g.nw, g.needle_ids) for g in tm.groups
    ]
    for jg, dg in zip(jgroups, tm.dev_groups):
        conv = torch_ncc.group_from_numpy(jg.bank, jg.s_n, jg.s2_n, tm.threshold, "cpu")
        for field in ("bank", "s_n", "s2_n", "sn_n", "rtn"):
            a, b = getattr(conv, field), getattr(dg, field)
            assert a.dtype == b.dtype and torch.equal(a, b), field
        assert conv.thr_eps == dg.thr_eps
    assert {(g.nh, g.nw, len(g.needle_ids)) for g in tm.groups} == {(13, 8, 74), (13, 9, 222)}


def test_waves_mixed_shapes_match_single_pages(faces, monkeypatch):
    """Waves smaller than the corpus, with pages of two shapes mixed in one
    wave and an all-white page, give each page exactly its get_hits result."""
    monkeypatch.setattr(torch_ncc, "WAVE", 3)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    texts = [["AB01ab"], ["10BAba"], ["baAB10"], ["A0b1Ba"], ["bbAA11"]]
    shapes = [(64, 128), (64, 128), (48, 112), (64, 128), (48, 112)]
    pages = [
        synthesize_page(faces[0], t, dopts, ropts, "AB01ab", s)
        for t, s in zip(texts, shapes)
    ] + [np.full((64, 128), 255, np.uint8)]
    tm = torch_ncc.NccMatcher(
        faces[1], "AB01ab", TRenderOptions(size=11.0), x_bits=1, device="cpu"
    )
    many = tm.get_hits_many(pages)
    singles = [tm.get_hits(p) for p in pages]
    assert [key(h) for h in many] == [key(h) for h in singles]
    assert all(len(h) > 0 for h in singles[:5]) and singles[5] == []
    structs = tm.get_hits_many(pages, struct=True)
    assert [key(s.to_objects()) for s in structs] == [key(h) for h in singles]


def test_max_matches_truncation_warns_like_focr_tpu(faces, capsys):
    """A needle with more than MAX_MATCHES accepted windows keeps the first
    MAX_MATCHES in scan order and warns on stderr, as focr_tpu does."""
    page = np.random.default_rng(4).integers(0, 256, size=(180, 200), dtype=np.uint8)
    jm, tm = _pair(faces, "o", threshold=0.05)
    want = jm.get_hits(page)
    capsys.readouterr()
    got = tm.get_hits(page)
    cap = capsys.readouterr()
    assert len(got) == torch_ncc.MAX_MATCHES
    assert "WARN got >= 1024 matches" in cap.err and cap.out == ""
    assert key(got) == key(want)


def test_crop_remap_matches_focr_tpu(faces):
    """Ink far inside a large page: the device sweeps only the ink-bbox crop,
    and the remapped hits equal focr_tpu's."""
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=200, y_start=300, line_height=13, line_advance=15, width=110)
    page = synthesize_page(faces[0], ["AB01ab", "10BAba"], dopts, ropts, "AB01ab", (640, 512))
    jm, tm = _pair(faces, "AB01ab", size=11.0, x_bits=1)
    (_, _, _, _, crop), = tm._sweep_wave([page])
    assert crop[0] > 0 and crop[1] > 0 and crop[2:] != page.shape
    got = tm.get_hits(page)
    assert len(got) > 0 and key(got) == key(jm.get_hits(page))


def test_sweep_wave_plans_and_host_waits(monkeypatch):
    """On the golden ncc pages (their top 200 rows: the first lines of
    text), _sweep_wave's plans hold each group's hits as K3's plain version
    replays them from the crop-local positions and per-needle counts that
    compact_hits_reference gives from the sweep's mask, with those counts
    beside them, and the wave waits on the device once for each swept
    group's counts and once for every group's hits; a blank wave never
    waits, and a wave of two page shapes still fetches its hits once."""
    from focr_tpu_torch.fonts.bank import load_needle_bank
    from focr_tpu_torch.models.types import MAX_MATCHES, NCC_DEFAULT_ALPHABET
    from focr_tpu_torch.ops import ncc_kernels, replay_kernels

    fixture = Path(__file__).resolve().parent / "fixtures" / "torch_ncc_golden.npz"
    with np.load(fixture, allow_pickle=False) as z:
        pages = [p[:200].copy() for p in z["pages"][:2]]
    needles, _ = load_needle_bank(str(fixture))
    tm = torch_ncc.NccMatcher(None, NCC_DEFAULT_ALPHABET, TRenderOptions(size=13.0), x_bits=2,
                              threshold=0.8, device="cpu", needles=needles)
    sweeps = []

    def sweep(*args, **kw):
        sweeps.append(ncc_kernels.ncc_sweep(*args, **kw))
        return sweeps[-1]

    monkeypatch.setattr(torch_ncc, "ncc_sweep", sweep)
    torch_ncc.reset_host_waits()
    wave = tm._sweep_wave(pages)
    assert torch_ncc.HOST_WAITS == len(tm.groups) + 1 == 3
    assert len(sweeps) == len(tm.groups)
    y0, x0, Hc, Wc = wave[0][4]
    inv = torch.from_numpy(np.stack([d[1] for d in wave])[:, y0 : y0 + Hc, x0 : x0 + Wc].copy())
    n_cand = n_hits = 0
    for gi, (grp, dg, (mask, rcnt)) in enumerate(zip(tm.groups, tm.dev_groups, sweeps)):
        pos, off, hcnt, _ = ncc_kernels.compact_hits_reference(mask, rcnt)
        buf = replay_kernels.ncc_replay_reference(
            inv, pos, off, hcnt, dg.bank, dg.s_n, dg.s2_n, float(np.float32(tm.threshold)), y0,
            x0, MAX_MATCHES)
        want = [v.numpy() for v in replay_kernels.split_replay(buf, len(pos), *hcnt.shape)]
        for k, (_, _, plan, _, _) in enumerate(wave):
            g, kind, (*got, p_hcnt) = plan[gi]
            assert g is grp and kind == "sweep"
            assert [v.dtype for v in (*got, p_hcnt)] == [np.int32, np.int32, np.float32,
                                                         np.int32, np.uint8, np.int32]
            a, b = off[k], off[k + 1]
            for v, w in zip(got, (*(w[a:b] for w in want[:3]), want[3][k], want[4][k])):
                np.testing.assert_array_equal(v, w)
            np.testing.assert_array_equal(p_hcnt, hcnt[k].numpy())
            n_cand += len(got[0])
            n_hits += int(got[3].sum())
    assert n_cand > 0 and n_hits > 0
    torch_ncc.reset_host_waits()
    blank = tm._sweep_wave([np.full((60, 80), 255, np.uint8)])
    assert torch_ncc.HOST_WAITS == 0 and all(kind == "empty" for _, kind, _ in blank[0][2])
    torch_ncc.reset_host_waits()
    tm._sweep_wave([pages[0][:90], pages[1][:120]])
    assert torch_ncc.HOST_WAITS == 2 * len(tm.groups) + 1
