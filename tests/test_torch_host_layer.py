"""focr_tpu_torch's host layer (copied from focr_tpu, since the port may not
import it) against the originals: needle banks, synthetic pages, hit
post-processing and page I/O; the golden fixture against focr_tpu; and the
port importing with jax blocked."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from focr_tpu.fonts.bank import build_needles as jax_build_needles
from focr_tpu.fonts.ft import Face
from focr_tpu.io.images import load_gray as jax_load_gray
from focr_tpu.io.synth import random_text_lines as jax_random_text_lines
from focr_tpu.io.synth import synthesize_page as jax_synthesize_page
from focr_tpu.models import post as jax_post
from focr_tpu.models.types import (
    BoxSize, DecodeOptions, NCC_DEFAULT_ALPHABET, RenderOptions,
)
from focr_tpu_torch.fonts import bank as tbank
from focr_tpu_torch.fonts.ft import Face as TFace, HintingOptions as THinting
from focr_tpu_torch.io import images as timages
from focr_tpu_torch.io import synth as tsynth
from focr_tpu_torch.models import post as tpost
from focr_tpu_torch.models import types as ttypes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_ncc_golden.npz")


@pytest.fixture(scope="module")
def faces(mono_font_path):
    return Face(mono_font_path), TFace(mono_font_path)


def _needle_key(nds):
    return [
        (nd.letter, nd.offset, nd.corrected_offset, nd.pixels.shape,
         nd.pixels.tobytes(), nd.s_n, nd.s2_n)
        for nd in nds
    ]


@pytest.mark.parametrize(
    "alphabet,box,x_bits,y_bits,padding,hinting",
    [
        (NCC_DEFAULT_ALPHABET, "alphabet", 2, 0, (0, 0), False),
        ("AbQ", "alphabet", 1, 1, (0, 0), False),
        ("lI.", "char", 0, 0, (1, 2), False),
        ("Wg=", "font", 1, 0, (0, 0), True),
    ],
)
def test_needle_banks_match(faces, alphabet, box, x_bits, y_bits, padding, hinting):
    hint = dict(full=True, size=13.0) if hinting else {}
    from focr_tpu.fonts.ft import HintingOptions

    want = jax_build_needles(
        faces[0], alphabet, RenderOptions(size=13.0, hinting=HintingOptions(**hint)),
        BoxSize(box), x_bits, y_bits, padding,
    )
    got = tbank.build_needles(
        faces[1], alphabet, ttypes.RenderOptions(size=13.0, hinting=THinting(**hint)),
        ttypes.BoxSize(box), x_bits, y_bits, padding,
    )
    assert _needle_key(got) == _needle_key(want)


def test_needle_bank_file_roundtrip(faces, tmp_path):
    ropts = ttypes.RenderOptions(size=13.0)
    needles = tbank.build_needles(faces[1], "AbQ=", ropts, ttypes.BoxSize.ALPHABET, 1, 0)
    settings = tbank.bank_settings("/x/DejaVuSansMono.ttf", "AbQ=", ropts,
                                   ttypes.BoxSize.ALPHABET, 1, 0, (0, 0))
    path = str(tmp_path / "bank.npz")
    tbank.save_needle_bank(path, needles, settings)
    loaded, saved = tbank.load_needle_bank(path)
    assert saved == settings and saved["font"] == "DejaVuSansMono.ttf"
    assert _needle_key(loaded) == _needle_key(needles)


def test_synthesize_page_matches(faces):
    rng_j, rng_t = np.random.default_rng(11), np.random.default_rng(11)
    lines_j = jax_random_text_lines(rng_j, NCC_DEFAULT_ALPHABET, 6, 30)
    lines_t = tsynth.random_text_lines(rng_t, NCC_DEFAULT_ALPHABET, 6, 30)
    assert lines_t == lines_j
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    want = jax_synthesize_page(faces[0], lines_j, dopts, RenderOptions(size=13.0),
                               NCC_DEFAULT_ALPHABET, (160, 300), blank_rows={2})
    got = tsynth.synthesize_page(
        faces[1], lines_t, ttypes.DecodeOptions(45, 39, 12, 15, 608),
        ttypes.RenderOptions(size=13.0), NCC_DEFAULT_ALPHABET, (160, 300), blank_rows={2},
    )
    assert got.dtype == want.dtype and np.array_equal(got, want)


class _FakeMatcher:
    def __init__(self, needles):
        self.needles = needles


def _random_hits(seed):
    """A HitStruct-shaped bundle of random hits over 6 needles, with dense
    duplicates on shared rows (anchor filter, overlap runs and ties)."""
    rng = np.random.default_rng(seed)
    N = 400
    from focr_tpu_torch.fonts.bank import Needle

    needles = [
        Needle(c, (0.0, 0.0), (0.0, 0.0), np.zeros((13, 8 + (i % 2)), np.uint8), 0, 0)
        for i, c in enumerate("AB=xy0")
    ]
    nid = np.sort(rng.integers(0, 6, N)).astype(np.int32)
    x = rng.integers(1, 120, N).astype(np.int64)
    y = (rng.integers(0, 8, N) * 15 + 3).astype(np.int64)
    sim = rng.choice(np.float32([0.8, 0.9, 0.95, 0.97, 0.97, 1.0]), N).astype(np.float32)
    return needles, nid, x, y, sim


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_post_processing_matches(seed):
    needles, nid, x, y, sim = _random_hits(seed)
    m = _FakeMatcher(needles)
    hs_t = type("HS", (), dict(needle_id=nid, x=x, y=y, sim=sim, matcher=m))
    hs_j = type("HS", (), dict(needle_id=nid, x=x, y=y, sim=sim, matcher=_FakeMatcher(needles)))
    assert tpost.process_hits_text(hs_t, 0.95, 5) == jax_post.process_hits_text(hs_j, 0.95, 5)
    got = tpost.process_hits_struct(hs_t, 0.95, 5)
    want = jax_post.process_hits_struct(hs_j, 0.95, 5)
    fields = lambda lines: [[(m.letter, m.x, m.y, m.w, m.h, m.similarity) for m in ln] for ln in lines]  # noqa: E731
    assert fields(got) == fields(want) and len(got) > 0
    objs = [
        ttypes.MatchWithLetter(needles[i].letter, int(a), int(b), 8, 13, float(s))
        for i, a, b, s in zip(nid, x, y, sim)
    ]
    assert fields(tpost.process_hits(objs, 0.95, 5)) == fields(
        jax_post.process_hits(objs, 0.95, 5)
    )


def test_pnm_io_matches_pillow_reader(tmp_path):
    """The port's own PGM/PPM reader agrees with focr_tpu's Pillow-based
    load_gray (incl. the integer Rec.709 luma of RGB pages); PGM round-trips."""
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    pgm = str(tmp_path / "g.pgm")
    timages.save_gray(pgm, gray)
    assert np.array_equal(timages.load_gray(pgm), gray)
    assert np.array_equal(jax_load_gray(pgm), gray)
    rgb = rng.integers(0, 256, (29, 41, 3), dtype=np.uint8)
    ppm = tmp_path / "c.ppm"
    ppm.write_bytes(b"P6\n# a comment\n41 29\n255\n" + rgb.tobytes())
    assert np.array_equal(timages.load_gray(str(ppm)), jax_load_gray(str(ppm)))
    png = str(tmp_path / "g.png")
    timages.save_gray(png, gray)  # written by the port itself, read back by both
    assert np.array_equal(timages.load_gray(png), gray)
    assert np.array_equal(jax_load_gray(png), gray)
    wide = tmp_path / "b.pgm"  # 16-bit samples: the same pixels as focr_tpu's
    wide.write_bytes(b"P5\n4 4\n65535\n" + (np.arange(16) * 4369).astype(">u2").tobytes())
    assert np.array_equal(timages.load_gray(str(wide)), jax_load_gray(str(wide)))


def test_golden_fixture_matches_focr_tpu(faces):
    """The committed golden's needle banks are focr_tpu's build_needles here,
    and its banks load back through the port as the port renders them."""
    with np.load(FIXTURE, allow_pickle=False) as z:
        groups = [
            {k: z[f"g{i}_{k}"] for k in ("bank", "s_n", "s2_n", "ids")}
            for i in range(int(z["n_groups"]))
        ]
        pages, lines = z["pages"], json.loads(str(z["lines"]))
    want = jax_build_needles(faces[0], NCC_DEFAULT_ALPHABET, RenderOptions(size=13.0),
                             BoxSize.ALPHABET, 2, 0)
    for g in groups:
        ids = g["ids"].tolist()
        assert np.array_equal(g["bank"], np.stack([want[i].pixels for i in ids]))
        assert g["s_n"].tolist() == [want[i].s_n for i in ids]
        assert g["s2_n"].tolist() == [want[i].s2_n for i in ids]
    assert sorted(i for g in groups for i in g["ids"].tolist()) == list(range(296))
    loaded, settings = tbank.load_needle_bank(FIXTURE)
    assert _needle_key(loaded) == _needle_key(want)
    assert settings["x_bits"] == 2 and settings["font"] == "DejaVuSansMono.ttf"
    assert pages.shape == (16, 792, 662) and pages.dtype == np.uint8
    assert len(lines) == 2 and all(len(p) >= 48 for p in lines)


def test_port_imports_without_jax():
    """Every module of the port imports in a process where jax cannot be
    imported, and none of them imports focr_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import focr_tpu_torch.cli.ncc, focr_tpu_torch.models.ncc\n"
        "import focr_tpu_torch.ops.ncc_kernels, focr_tpu_torch.native.build\n"
        "import focr_tpu_torch.oracle.ncc_oracle, focr_tpu_torch.io.synth\n"
        "import focr_tpu_torch.utils.device\n"
        "bad = [m for m in sys.modules if m == 'focr_tpu' or m.startswith('focr_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
