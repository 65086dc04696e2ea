"""The port's pages x glyphs mesh (focr_tpu_torch/parallel/) on ``["cpu"] * n``
slots against focr_tpu's sharded paths on the 8-device virtual CPU mesh
(tests/conftest.py), and against the port's own single-slot engines.

Counterpart of tests/test_parallel.py, case for case. The same inputs, made
from a numpy seed, go through both packages; every comparison is exact
(integer ids and flags, decoded text, and ncc hits by the bytes of their f32
similarity). On CPU slots the kernels' plain PyTorch versions run (K4p, K6,
K1, K2, K5); focr_tpu runs as its own tests run it, its Pallas kernel in
interpret mode.
"""

import dataclasses
import queue
import threading
import types
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from focr_tpu.fonts.bank import build_grid_bank
from focr_tpu.fonts.ft import Face
from focr_tpu.io.synth import random_text_lines, synthesize_page
from focr_tpu.models import ncc as jncc
from focr_tpu.models.focr import GridDecoder as JGridDecoder
from focr_tpu.models.types import DecodeOptions, RenderOptions
from focr_tpu.ops import ssd as jssd
from focr_tpu.parallel import decode as jdecode
from focr_tpu.parallel import mesh as jmesh
from focr_tpu_torch.fonts.bank import GridBank as TGridBank
from focr_tpu_torch.fonts.ft import Face as TFace
from focr_tpu_torch.io.images import save_gray
from focr_tpu_torch.models import focr as tfocr
from focr_tpu_torch.models import ncc as tncc
from focr_tpu_torch.models.post import process_hits, process_hits_text
from focr_tpu_torch.models.types import DecodeOptions as TDecodeOptions
from focr_tpu_torch.models.types import RenderOptions as TRenderOptions
from focr_tpu_torch.ops import ncc_kernels, prop_kernels, ssd_kernels
from focr_tpu_torch.parallel import decode as tdecode
from focr_tpu_torch.parallel import mesh as tmesh
from focr_tpu_torch.utils import device as tdevice

torch.set_num_threads(2)

ALPHA = "ABC abc019+/"
MESHES = [(8, 1), (4, 2), (2, 4)]  # pages x glyphs, eight cpu slots each


def cpu_mesh(n: int = 8, glyph_shards: int = 1) -> tmesh.Mesh:
    return tmesh.page_mesh(["cpu"] * n, glyph_shards)


def tbank(jb) -> TGridBank:
    """focr_tpu's bank, array for array, as the port's GridBank."""
    return TGridBank(**{f.name: getattr(jb, f.name) for f in dataclasses.fields(TGridBank)})


def lines(decoded):
    return [[(ln.text, ln.y) for ln in page] for page in decoded]


def hit_key(hs):
    return [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs]


@pytest.fixture
def slot_calls(monkeypatch):
    """(slot index, wrapper's name) -> the plain-version calls made for a
    mesh slot. On cpu slots no kernel launches, so the slots' launch counts
    (utils/device.py::SLOT_LAUNCHES) stay empty; how the work was dealt is
    read from the slot that was current when a plain version ran."""
    calls: Counter = Counter()

    def spy(mod, plain, name):
        fn = getattr(mod, plain)

        def wrapped(*args, **kwargs):
            if tdevice.current_slot() is not None:
                calls[(tdevice.current_slot(), name)] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, plain, wrapped)

    spy(ssd_kernels, "ssd_argmin_reference", "ssd_argmin")
    spy(ssd_kernels, "ssd_argmin_partial_reference", "ssd_argmin_partial")
    spy(ssd_kernels, "first_min_combine_reference", "ssd_combine")
    spy(prop_kernels, "prop_scan_reference", "prop_scan")
    spy(ncc_kernels, "ncc_sweep_reference", "ncc_sweep")
    tdevice.reset_slot_launches()
    yield calls
    assert not tdevice.SLOT_LAUNCHES  # nothing launched: no card here


@pytest.fixture(scope="module")
def setup(mono_font_path):
    """tests/test_parallel.py's corpus: six 64x136 pages of three lines."""
    face = Face(mono_font_path)
    ropts = RenderOptions(size=10.0)
    dopts = DecodeOptions(x_start=4, y_start=3, line_height=12, line_advance=14, width=120)
    shape = (64, 136)
    rng = np.random.default_rng(7)
    pages = np.stack([
        synthesize_page(face, random_text_lines(rng, ALPHA.replace(" ", "A"), 3, 9),
                        dopts, ropts, ALPHA, shape)
        for _ in range(6)
    ])
    return face, ropts, dopts, shape, pages


# --- the sharded grid step ---------------------------------------------------


@pytest.mark.parametrize("n_pages,glyph_shards", MESHES)
def test_sharded_grid_matches_single_slot_and_focr_tpu(setup, n_pages, glyph_shards, slot_calls):
    """make_sharded_grid_fn on 8 cpu slots: ids and white flags equal the
    port's unsharded step and focr_tpu's sharded fn on the same bank."""
    face, ropts, dopts, shape, pages = setup
    mesh = cpu_mesh(8, glyph_shards)
    assert mesh.shape == {"pages": n_pages, "glyphs": glyph_shards}
    jm = jmesh.page_mesh(glyph_shards=glyph_shards)
    dec = JGridDecoder(face, ALPHA, dopts, ropts, shape)
    padded, B = jmesh.pad_batch(pages, 8)
    slot_calls.clear()
    for grp, _ in dec.groups:
        jb = build_grid_bank(face, ALPHA, ropts, dec.crop_w, grp.crop_h)
        bank = tbank(jb)
        ids_j, white_j = jax.device_get(
            jdecode.make_sharded_grid_fn(jb, grp.ys, dec.x0, jm)(padded))
        ids_t, white_t = tmesh.fetch_global(
            tdecode.make_sharded_grid_fn(bank, grp.ys, dec.x0, mesh)(padded))
        strips = tfocr.crop_strips(padded, grp.ys, grp.crop_h, dec.x0, dec.crop_w)
        ids_s, white_s = tfocr.StripForward(bank, torch.device("cpu"))(torch.from_numpy(strips))
        assert ids_t.dtype == np.int32 and white_t.dtype == np.bool_
        np.testing.assert_array_equal(ids_t, ids_s.numpy())
        np.testing.assert_array_equal(white_t, white_s.numpy())
        np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
        np.testing.assert_array_equal(white_t, np.asarray(white_j))
        assert white_t[B:].all()  # the padded white pages decode to nothing
    kernel = "ssd_argmin" if glyph_shards == 1 else "ssd_argmin_partial"
    assert {i for i, k in slot_calls if k == kernel} == set(range(8))
    heads = {i for i, k in slot_calls if k == "ssd_combine"}
    assert heads == (set() if glyph_shards == 1 else set(range(0, 8, glyph_shards)))


def test_sharded_grid_refuses_a_batch_that_does_not_divide(setup):
    face, ropts, dopts, shape, pages = setup
    dec = JGridDecoder(face, ALPHA, dopts, ropts, shape)
    grp = dec.groups[0][0]
    bank = tbank(build_grid_bank(face, ALPHA, ropts, dec.crop_w, grp.crop_h))
    fn = tdecode.make_sharded_grid_fn(bank, grp.ys, dec.x0, cpu_mesh(8, 2))
    with pytest.raises(ValueError, match="does not divide"):
        fn(pages[:3])


def test_sharded_decode_end_to_end(setup):
    """The sharded step decodes the synthetic pages to the exact text."""
    face, ropts, dopts, shape, pages = setup
    mesh = cpu_mesh(8, 2)
    dec = JGridDecoder(face, ALPHA, dopts, ropts, shape)
    expect = dec.decode_batch(pages)
    padded, B = tmesh.pad_batch(pages, mesh.shape["pages"])
    grp = dec.groups[0][0]
    bank = tbank(build_grid_bank(face, ALPHA, ropts, dec.crop_w, grp.crop_h))
    ids, white = tmesh.fetch_global(
        tdecode.make_sharded_grid_fn(bank, grp.ys, dec.x0, mesh)(padded))
    chars = np.array(list(ALPHA))
    for b in range(B):
        got = ["".join(chars[ids[b, r]]) for r in range(len(grp.ys)) if not white[b, r]]
        assert got == [ln.text for ln in expect[b] if ln.y in grp.ys]
    assert white[B:].all()


@pytest.mark.parametrize("n_pages,glyph_shards", MESHES)
def test_grid_decoder_mesh_parity(mono_font_path, n_pages, glyph_shards):
    """GridDecoder(mesh=...) equals the single-slot decoder and focr_tpu's
    sharded decoder, with a batch that does not divide the mesh (padded,
    then trimmed)."""
    face = Face(mono_font_path)
    ropts = RenderOptions(size=10.0)
    dopts = DecodeOptions(x_start=3, y_start=4, line_height=12, line_advance=14, width=100)
    shape = (50, 115)
    rng = np.random.default_rng(5)
    pages = np.stack([
        synthesize_page(face, ["".join(rng.choice(list("AB01ab"), size=9)) for _ in range(3)],
                        dopts, ropts, "AB01ab", shape)
        for _ in range(3)  # deliberately not a multiple of the mesh size
    ])
    want = lines(JGridDecoder(face, "AB01ab", dopts, ropts, shape,
                              mesh=jmesh.page_mesh(glyph_shards=glyph_shards)).decode_batch(pages))
    args = (TFace(mono_font_path), "AB01ab", TDecodeOptions(**dataclasses.asdict(dopts)),
            TRenderOptions(size=10.0), shape, "cpu")
    sharded = tfocr.GridDecoder(*args, mesh=cpu_mesh(8, glyph_shards))
    assert sharded.mesh is not None and sharded.device == torch.device("cpu")
    got = lines(sharded.decode_batch(pages))
    assert got == lines(tfocr.GridDecoder(*args).decode_batch(pages)) == want
    assert any(t.strip() for page in got for t, _ in page)
    # a single page through the streaming entry: a mesh decoder takes the batch path
    assert lines([list(tfocr.decode_single_stream(sharded, pages[1]))]) == want[1:2]


def test_a_mesh_of_one_slot_is_no_mesh(mono_font_path):
    args = (TFace(mono_font_path), "AB", TDecodeOptions(width=40, line_height=12,
                                                         line_advance=14),
            TRenderOptions(size=10.0), (30, 60), "cpu")
    dec = tfocr.GridDecoder(*args, mesh=cpu_mesh(1))
    assert dec.mesh is None and isinstance(dec.groups[0][1], tfocr.StripForward)


def test_prop_decoder_mesh_parity(sans_font_path, slot_calls):
    """Proportional lines dealt over 8 slots equal the single-slot decode and
    focr_tpu's sharded one: 3 pages x 3 rows = 9 lines, not a multiple of 8;
    and 2 inked lines on 8 slots, where most slots get none."""
    face = Face(sans_font_path)
    alpha = "AWim01"
    ropts = RenderOptions(size=12.0)
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=16, line_advance=19, width=110)
    shape = (65, 130)
    rng = np.random.default_rng(11)
    pages = np.stack([
        synthesize_page(face, ["".join(rng.choice(list(alpha), size=7)) for _ in range(3)],
                        dopts, ropts, alpha, shape)
        for _ in range(3)
    ])
    want = lines(JGridDecoder(face, alpha, dopts, ropts, shape,
                              mesh=jmesh.page_mesh()).decode_batch(pages))
    args = (TFace(sans_font_path), alpha, TDecodeOptions(**dataclasses.asdict(dopts)),
            TRenderOptions(size=12.0), shape, "cpu")
    sharded = tfocr.GridDecoder(*args, mesh=cpu_mesh(8, 2))
    assert sharded.prop_groups and sharded.prop_groups[0][1].mesh is not None
    slot_calls.clear()
    got = lines(sharded.decode_batch(pages))
    assert got == lines(tfocr.GridDecoder(*args).decode_batch(pages)) == want
    assert sum(len(p) for p in got) == 9
    assert len({i for i, k in slot_calls if k == "prop_scan"}) >= 5
    sparse = np.full_like(pages[:1], 255)
    sparse[0, 5:40] = pages[0, 5:40]  # two inked rows
    slot_calls.clear()
    assert lines(sharded.decode_batch(sparse)) == [want[0][:2]]
    assert sum(slot_calls.values()) == 2  # six slots got no line and ran nothing


# --- ncc ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ncc_setup(mono_font_path):
    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    pages = [synthesize_page(face, [t], dopts, ropts, "AB01ab", (64, 128))
             for t in ("AB01ab", "ba10BA", "A0b1aB")]
    jm = jncc.NccMatcher(face, "AB01ab", ropts, x_bits=1)
    tm = tncc.NccMatcher(TFace(mono_font_path), "AB01ab", TRenderOptions(size=11.0), x_bits=1,
                         device="cpu")
    return jm, tm, pages


@pytest.mark.parametrize("n_pages,glyph_shards", MESHES)
def test_ncc_sharded_matches_single(ncc_setup, n_pages, glyph_shards, slot_calls):
    """get_hits_many_sharded over 8 slots == per-page get_hits == focr_tpu's
    sharded search, bit for bit, for a page count that does not divide."""
    jm, tm, pages = ncc_setup
    slot_calls.clear()
    sharded = tm.get_hits_many_sharded(pages, cpu_mesh(8, glyph_shards))
    assert [hit_key(h) for h in sharded] == [hit_key(tm.get_hits(p)) for p in pages]
    want = jm.get_hits_many_sharded(pages, jmesh.page_mesh(glyph_shards=glyph_shards))
    assert [hit_key(h) for h in sharded] == [hit_key(h) for h in want]
    assert any(sharded)
    # three pages of one wave: slots 0, 1 and 2 swept one page each
    assert {i for i, k in slot_calls if k == "ncc_sweep"} == {0, 1, 2}


def test_ncc_scatter_restores_page_order_over_many_waves(ncc_setup, monkeypatch, mono_font_path):
    """Eleven pages whose ink differs in extent (each slot crops its own
    sub-wave), waves of 2 pages a slot on 3 slots: two waves, the second
    short; hits in page order, equal to page-by-page get_hits."""
    _, tm, pages = ncc_setup
    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    rng = np.random.default_rng(3)
    corpus = []
    for k in range(11):
        dopts = DecodeOptions(x_start=3 + 4 * (k % 5), y_start=4 + 3 * (k % 4), line_height=13,
                              line_advance=15, width=40 + 6 * (k % 7))
        text = "".join(rng.choice(list("AB01ab"), size=2 + k % 4))
        corpus.append(synthesize_page(face, [text], dopts, ropts, "AB01ab", (64, 128)))
    corpus[4] = np.full((64, 128), 255, np.uint8)  # a blank page inside a sub-wave
    monkeypatch.setattr(tncc, "WAVE", 2)
    want = [hit_key(tm.get_hits(p)) for p in corpus]
    got = tm.get_hits_many_sharded(corpus, cpu_mesh(3))
    assert [hit_key(h) for h in got] == want
    assert len({tuple(w) for w in want}) > 6
    structs = tm.get_hits_many_sharded(corpus, cpu_mesh(3), struct=True)
    assert [hit_key(s.to_objects()) for s in structs] == want
    assert tm.get_hits_many_sharded([], cpu_mesh(3)) == []


def test_ncc_sharded_fused_post(ncc_setup):
    """post= fused into the scatter's collect tasks yields the object
    pipeline's exact text lines, and focr_tpu's."""
    jm, tm, pages = ncc_setup
    post = lambda hs: process_hits_text(hs, 0.95, 5)  # noqa: E731
    fused = tm.get_hits_many_sharded(pages, cpu_mesh(8), struct=True, post=post)
    want = [["".join(h.letter for h in ln) for ln in process_hits(tm.get_hits(p), 0.95, 5)]
            for p in pages]
    assert fused == want
    from focr_tpu.models.post import process_hits_text as jpost

    assert fused == jm.get_hits_many_sharded(
        pages, jmesh.page_mesh(), struct=True, post=lambda hs: jpost(hs, 0.95, 5))


def test_ncc_verbose_on_a_mesh_keeps_page_order_on_stderr(ncc_setup, capsys):
    _, tm, pages = ncc_setup
    tm.get_hits_many(pages, verbose=True)
    want = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("hits:")]
    tm.get_hits_many_sharded(pages, cpu_mesh(4), verbose=True)
    got = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("hits:")]
    assert got == want and len(got) == 3


def test_slot_state_is_keyed_by_value(ncc_setup):
    """An equal mesh finds the banks the first one uploaded; the matcher's
    own device keeps its own."""
    _, tm, pages = ncc_setup
    tm.get_hits_many_sharded(pages, cpu_mesh(2))
    states = dict(tm._states)
    tm.get_hits_many_sharded(pages, cpu_mesh(2))
    assert tm._states == states and {None, (0, "cpu"), (1, "cpu")} <= set(states)
    assert tm.dev_groups is states[None].dev_groups


@pytest.mark.parametrize("n_pages", [0, 1, 5])
def test_hits_payload_codec_matches_focr_tpu(ncc_setup, n_pages):
    """_pack_hits_payload's bytes are focr_tpu's for the same hits, and
    unpacking gives the arrays back bit for bit."""
    jm, tm, pages = ncc_setup
    corpus = (pages * 2)[:n_pages]
    structs = tm.get_hits_many(corpus, struct=True)
    jstructs = [jncc.HitStruct(needle_id=s.needle_id, x=s.x, y=s.y, sim=s.sim, matcher=jm)
                for s in structs]
    payload = tncc._pack_hits_payload(structs)
    assert payload == jncc._pack_hits_payload(jstructs)
    back = tncc._unpack_hits_payload(payload)
    assert len(back) == n_pages
    for (nid, x, y, sim), s in zip(back, structs):
        assert nid.dtype == x.dtype == y.dtype == np.int32 and sim.dtype == np.float32
        np.testing.assert_array_equal(nid, s.needle_id)
        np.testing.assert_array_equal(x, s.x)
        np.testing.assert_array_equal(y, s.y)
        assert sim.tobytes() == s.sim.tobytes()
    assert n_pages == 0 or sum(len(b[0]) for b in back) > 0


# --- both CLIs under FOCR_TORCH_MESH_DEVICES -------------------------------------


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("slots,extra", [(8, ["--glyph-shards", "2"]), (4, ["--glyph-shards", "4"]),
                                         (3, [])], ids=["4x2", "1x4", "3x1"])
def test_focr_cli_mesh_auto(mono_font_path, tmp_path, capsys, monkeypatch, slots, extra, slot_calls):
    """--mesh auto over the slots FOCR_TORCH_MESH_DEVICES names: the stdout
    of --mesh off and of focr_tpu's CLI on its 8-device mesh."""
    from focr_tpu.cli.focr import main as jax_main
    from focr_tpu.models.types import FOCR_DEFAULT_ALPHABET
    from focr_tpu_torch.cli.focr import main as torch_main

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=120)
    paths = []
    for k, text in enumerate(("AB01", "xyz+/=", "Q")):
        page = synthesize_page(face, [text], dopts, ropts, FOCR_DEFAULT_ALPHABET, (64, 140))
        paths.append(str(tmp_path / f"m{k}.pgm"))
        save_gray(paths[-1], page)
    argv = ["-i", *paths, "-f", mono_font_path, "-t", "11", "-x", "5", "-y", "6", "-w", "120",
            "--line-height", "13", "--line-advance", "15"]
    _, want, _ = _run(torch_main, [*argv, "--device", "cpu", "--mesh", "off"], capsys)
    monkeypatch.setenv(tmesh.MESH_DEVICES_ENV, ",".join(["cpu"] * slots))
    slot_calls.clear()
    rc, got, err = _run(torch_main, [*argv, "--device", "cpu", *extra], capsys)
    assert rc == 0 and got == want and err == "" and "AB01" in got
    assert {i for i, _ in slot_calls} == set(range(slots))
    # a single image: the mesh decoder takes the batch path, same lines
    _, one, _ = _run(torch_main, ["-i", paths[1], *argv[4:], "--device", "cpu", *extra], capsys)
    assert one == "".join(want.splitlines(keepends=True)[1:2])
    monkeypatch.delenv(tmesh.MESH_DEVICES_ENV)
    rc_j, out_j, _ = _run(jax_main, [*argv, *(extra if slots == 8 else [])], capsys)
    assert rc_j == 0 and out_j == want


def test_focr_cli_glyph_shards_must_divide_the_slots(mono_font_path, tmp_path, monkeypatch):
    from focr_tpu_torch.cli.focr import main as torch_main

    path = str(tmp_path / "p.pgm")
    save_gray(path, np.full((40, 60), 255, np.uint8))
    monkeypatch.setenv(tmesh.MESH_DEVICES_ENV, "cpu,cpu,cpu")
    argv = ["-i", path, path, "-f", mono_font_path, "-t", "11", "-w", "40", "--line-height", "13",
            "--line-advance", "15", "--device", "cpu", "--glyph-shards", "2"]
    with pytest.raises(ValueError, match="glyph_shards=2 must divide device count 3"):
        torch_main(argv)
    assert torch_main([*argv, "--mesh", "off"]) == 0  # --mesh off never builds one


@pytest.mark.parametrize("extra", [[], ["--csv"], ["-v"]], ids=["text", "csv", "verbose"])
def test_ncc_cli_mesh_auto(mono_font_path, tmp_path, capsys, monkeypatch, extra, slot_calls):
    from focr_tpu.cli.ncc import main as jax_main
    from focr_tpu_torch.cli.ncc import main as torch_main

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    paths = []
    for i, (t, shape) in enumerate((("AB01ab", (64, 128)), ("ba10BA", (64, 128)),
                                    ("b0A", (70, 120)))):  # two shapes: two buckets
        paths.append(str(tmp_path / f"{i}.pgm"))
        save_gray(paths[-1], synthesize_page(face, [t], dopts, ropts, "AB01ab", shape))
    argv = ["-i", *paths, "-f", mono_font_path, "-t", "11", "-a", "AB01ab", "--x-bits", "2",
            *extra]
    _, want, _ = _run(torch_main, [*argv, "--device", "cpu", "--mesh", "off"], capsys)
    monkeypatch.setenv(tmesh.MESH_DEVICES_ENV, "cpu,cpu,cpu,cpu")
    slot_calls.clear()
    rc, got, _ = _run(torch_main, [*argv, "--device", "cpu"], capsys)
    assert rc == 0 and got == want
    assert not extra and got.splitlines() == ["AB01ab", "ba10BA", "b0A"] or extra
    assert {i for i, k in slot_calls if k == "ncc_sweep"} == {0, 1}
    monkeypatch.delenv(tmesh.MESH_DEVICES_ENV)
    rc_j, out_j, _ = _run(jax_main, argv, capsys)
    assert rc_j == 0 and out_j == want


# --- mesh.py ------------------------------------------------------------------


def test_page_mesh_layout_and_errors():
    mesh = tmesh.page_mesh(["cpu"] * 6, glyph_shards=3)
    assert mesh.shape == {tmesh.PAGES_AXIS: 2, tmesh.GLYPHS_AXIS: 3} and mesh.size == 6
    # row-major: a glyph group is adjacent slots
    assert [[s.index for s in row] for row in mesh.grid] == [[0, 1, 2], [3, 4, 5]]
    assert mesh.local_slots == mesh.slots and mesh.owners == [0]
    for n, g in ((8, 3), (3, 2), (2, 4)):
        with pytest.raises(ValueError, match=f"glyph_shards={g} must divide device count {n}"):
            tmesh.page_mesh(["cpu"] * n, glyph_shards=g)
        with pytest.raises(ValueError, match="must divide device count"):  # as focr_tpu's
            jmesh.page_mesh(jax.devices()[:n], glyph_shards=g)
    assert tmesh.page_mesh().size == 1  # no card here: the CPU, once


def test_mesh_is_keyed_by_value():
    """Equal meshes are one key, as jax.sharding.Mesh's are (a new mesh at a
    dead one's address is not taken for it); other devices, another order,
    other axis sizes or owning ranks are other keys."""
    a, b = cpu_mesh(4, 2), cpu_mesh(4, 2)
    assert a is not b and a == b and hash(a) == hash(b) and len({a, b}) == 1
    others = [cpu_mesh(4, 1), cpu_mesh(4, 4), cpu_mesh(8, 2),
              tmesh.Mesh(["cpu", "cpu", "cpu", "cuda:0"], 2),
              tmesh.Mesh(["cuda:0", "cpu", "cpu", "cpu"], 2),
              tmesh.Mesh(["cpu"] * 4, 2, ranks=[0, 0, 1, 1])]
    assert len({a, *others}) == 1 + len(others) and a != "mesh"


def test_auto_mesh_policy(monkeypatch):
    """None for one slot; the environment's list; every visible card."""
    monkeypatch.delenv(tmesh.MESH_DEVICES_ENV, raising=False)
    monkeypatch.delenv(tmesh.DISTRIBUTED_ENV, raising=False)
    assert tmesh.auto_mesh("cpu") is None and tmesh.auto_mesh("cpu", glyph_shards=2) is None
    assert tmesh.maybe_init_distributed() is False and tmesh.process_count() == 1
    monkeypatch.setenv(tmesh.MESH_DEVICES_ENV, "cpu, cpu,cpu,cpu")
    assert tmesh.auto_mesh("cpu", glyph_shards=2) == cpu_mesh(4, 2)
    with pytest.raises(ValueError, match="not cuda"):
        tmesh.mesh_devices("cuda")
    monkeypatch.setenv(tmesh.MESH_DEVICES_ENV, "cpu")
    assert tmesh.auto_mesh("cpu") is None
    monkeypatch.delenv(tmesh.MESH_DEVICES_ENV)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = tmesh.auto_mesh("cuda", glyph_shards=2)  # no stream is made until a slot runs
    assert mesh.shape == {"pages": 2, "glyphs": 2}
    assert [str(s.device) for s in mesh.slots] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]


def test_pad_batch_matches_focr_tpu():
    pages = np.random.default_rng(0).integers(0, 256, (5, 7, 9), dtype=np.uint8)
    for multiple in (1, 4, 5, 8):
        got, n = tmesh.pad_batch(pages, multiple)
        want, n_j = jmesh.pad_batch(pages, multiple)
        assert n == n_j == 5
        np.testing.assert_array_equal(got, want)
    assert (tmesh.pad_batch(pages, 8)[0][5:] == 255).all()


@pytest.mark.parametrize("over", [tmesh.PAGES_AXIS, tmesh.SLOTS])
def test_put_global_fetch_global_round_trip(over):
    """put_global deals a batch by global index (ragged at the end),
    fetch_global brings it back whole and in order."""
    mesh = cpu_mesh(8, 2)
    arr = np.arange(11 * 3 * 5, dtype=np.int32).reshape(11, 3, 5)
    sh = tmesh.put_global(arr, mesh, over)
    assert len(sh.shards) == 8 and sh.shape == arr.shape
    blocks = [idx for _, idx, _ in sh.shards]
    if over == tmesh.PAGES_AXIS:  # a glyph group shares its page block
        assert blocks[0] == blocks[1] == slice(0, 3) and blocks[6] == blocks[7] == slice(9, 11)
    else:
        assert blocks[:2] == [slice(0, 2), slice(2, 4)] and blocks[5:] == [
            slice(10, 11), slice(11, 11), slice(11, 11)]
    for slot, idx, t in sh.shards:
        np.testing.assert_array_equal(t.numpy(), arr[idx])
    tree = {"a": sh, "b": [torch.arange(3), "as it is"], "c": (np.int64(3),)}
    out = tmesh.fetch_global(tree)
    np.testing.assert_array_equal(out["a"], arr)
    np.testing.assert_array_equal(out["b"][0], [0, 1, 2])
    assert out["b"][1] == "as it is" and out["c"] == (3,)


def test_merge_shards_reproduces_global_order():
    """Shards merge by global index, in any order; against focr_tpu's on
    its 8-device mesh."""
    arr = np.arange(8 * 3 * 5, dtype=np.int32).reshape(8, 3, 5)
    sh = tmesh.put_global(arr, cpu_mesh(8), tmesh.SLOTS)
    shards = [((idx,), t.numpy()) for _, idx, t in sh.shards]
    np.testing.assert_array_equal(tmesh.merge_shards(shards, arr.shape, arr.dtype), arr)
    np.testing.assert_array_equal(tmesh.merge_shards(shards[::-1], arr.shape, arr.dtype), arr)
    x = jax.device_put(arr, jmesh.pages_sharding(jmesh.page_mesh()))
    jshards = [(s.index, np.asarray(s.data)) for s in x.addressable_shards]
    np.testing.assert_array_equal(
        tmesh.merge_shards(reversed(jshards), arr.shape, arr.dtype),
        jmesh.merge_shards(jshards, arr.shape, arr.dtype))


def test_gather_group_stacks_in_slot_order():
    mesh = cpu_mesh(4, 4)
    parts = [(s, torch.full((2, 3), s.index, dtype=torch.int64)) for s in mesh.grid[0]]
    out = tmesh.gather_group(mesh.slots[0], parts)
    assert out.shape == (4, 2, 3) and out[:, 0, 0].tolist() == [0, 1, 2, 3]


def test_all_gather_in_one_process_is_the_identity():
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    (only,) = tmesh.all_gather_host(arr)
    np.testing.assert_array_equal(only, arr)
    assert tmesh.all_gather_bytes(b"abc") == [b"abc"] and tmesh.all_gather_bytes(b"") == [b""]


# --- K4p and K6: the plain versions against focr_tpu's shard arithmetic ------------

# the metric's ends: tsq - 2·corr over a window of check_window's 74565 pixels
METRIC_MIN, METRIC_MAX = -2 * 74565 * 65025, 74565 * 65025


@pytest.mark.parametrize("n_g", [1, 2, 4, 5])
def test_partial_and_combine_match_focr_tpus_shard_fn(setup, n_g):
    """On each glyph slice of one bank (shard_grid_bank: padded with copies of
    glyph 0): K4p's plain version gives keys that unpack to focr_tpu's
    loc_val and loc_idx + g·Gl (parallel/decode.py:71-74), white flags from
    the first shard only, and K6's plain version gives focr_tpu's argmin
    over the gathered partials (:75-79), which is the unsharded first
    minimum."""
    import jax.numpy as jnp

    face, ropts, dopts, shape, pages = setup
    dec = JGridDecoder(face, ALPHA, dopts, ropts, shape)
    grp = dec.groups[0][0]
    jb = build_grid_bank(face, ALPHA, ropts, dec.crop_w, grp.crop_h)
    noise = np.random.default_rng(n_g).integers(0, 256, (2, *shape), dtype=np.uint8)
    batch = np.concatenate([pages[:3], noise])
    strips = tfocr.crop_strips(batch, grp.ys, grp.crop_h, dec.x0, dec.crop_w)
    slices = tdecode.shard_grid_bank(jb.templates, jb.tsq, n_g)
    tmpl_p = jdecode._pad_glyph_axis(jb.templates, n_g)
    Gl = tmpl_p.shape[1] // n_g
    assert [t.shape[1] for t, _ in slices] == [Gl] * n_g
    np.testing.assert_array_equal(np.concatenate([t for t, _ in slices], axis=1), tmpl_p)
    wx0 = torch.from_numpy(jb.wx0.astype(np.int32))
    inv = 255 - jnp.asarray(strips).astype(jnp.int32)
    wins = jssd.extract_windows(inv, jb.wx0, jb.win_w)
    keys, jvals, jidxs = [], [], []
    for g, (tmpl, tsq) in enumerate(slices):
        shard = ssd_kernels.shard_bank(torch.from_numpy(tmpl), torch.from_numpy(
            tsq.astype(np.int64)), wx0, dec.crop_w, g * Gl)
        key, white = ssd_kernels.ssd_argmin_partial(torch.from_numpy(strips), shard, white=g == 0)
        metric = jssd.ssd_metric(wins, jnp.asarray(tmpl), jnp.asarray(tsq.astype(np.int32)))
        loc_idx = jnp.argmin(metric, axis=-1).astype(jnp.int32)
        loc_val = jnp.take_along_axis(metric, loc_idx[..., None], axis=-1)[..., 0]
        val, gid = ssd_kernels.unpack_key(key)
        assert key.dtype == torch.int64 and int(key.min()) >= 0
        np.testing.assert_array_equal(gid.numpy(), np.asarray(loc_idx) + g * Gl)
        np.testing.assert_array_equal(val.numpy(), np.asarray(loc_val).astype(np.int64))
        if g == 0:
            np.testing.assert_array_equal(white.numpy(),
                                          np.asarray(jnp.max(inv, axis=(2, 3)) == 0))
        else:
            assert white is None
        keys.append(key)
        jvals.append(loc_val), jidxs.append(loc_idx + g * Gl)
    got = ssd_kernels.first_min_combine(keys)
    s = jnp.argmin(jnp.stack(jvals), axis=0)
    want = jnp.take_along_axis(jnp.stack(jidxs), s[None], axis=0)[0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full, _ = ssd_kernels.ssd_argmin(torch.from_numpy(strips), torch.from_numpy(jb.templates),
                                     torch.from_numpy(jb.tsq.astype(np.int64)), wx0)
    assert torch.equal(got, full) and int(full.max()) < jb.n_glyphs  # no padded copy wins
    assert ssd_kernels.LAUNCHES == {"ssd_argmin": 0, "ssd_argmin_partial": 0, "ssd_combine": 0,
                                    "ssd_combine_fold": 0}


def _combine_want(metrics: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """focr_tpu's rule (parallel/decode.py:78-79): numpy's first-occurrence
    argmin over the shards' metrics, then that shard's glyph."""
    return np.take_along_axis(gids, np.argmin(metrics, axis=0)[None], axis=0)[0]


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 8), st.integers(1, 40), st.integers(0, 3), st.integers(0, 2**32 - 1),
       st.sampled_from([1, 17, 1000, ssd_kernels.GID_LIMIT // 8]))
def test_first_min_combine_ties(n_g, n, spread, seed, Gl):
    """Few distinct metrics, so most cells tie: the combined glyph is that of
    the LOWEST shard holding the minimum, as numpy's first-occurrence argmin
    over shards (jnp.argmin's rule, focr_tpu/parallel/decode.py:78), the
    shard's glyphs numbered from its first (:74-76)."""
    rng = np.random.default_rng(seed)
    metrics = rng.integers(-spread, spread + 1, (n_g, n)).astype(np.int64) * 10**9
    gids = rng.integers(0, Gl, (n_g, n)) + (np.arange(n_g, dtype=np.int64) * Gl)[:, None]
    keys = [torch.from_numpy(k) for k in ssd_kernels.pack_key(metrics, gids)]
    got = ssd_kernels.first_min_combine(keys)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _combine_want(metrics, gids))


@pytest.mark.parametrize("case", ["all-equal", "minimum-last", "padded-copies", "int64-range"])
def test_first_min_combine_adversarial(case):
    """Keys at the cases the combine's order must get right; "int64-range":
    metrics at both ends of the key's range with glyphs up to 2^28 - 1."""
    n_g, n = 4, 9
    metrics = np.full((n_g, n), 7, np.int64)
    gids = np.tile(np.arange(n, dtype=np.int64), (n_g, 1)) + 100 * np.arange(n_g)[:, None]
    if case == "minimum-last":
        metrics[-1] = 6
    elif case == "padded-copies":  # shard 3 holds copies of glyph 0: glyph 0's metric
        metrics[0], metrics[1:3], metrics[3] = 5, 9, 5
        gids[0], gids[3] = 0, 300
    elif case == "int64-range":
        gids += ssd_kernels.GID_LIMIT - 1 - int(gids.max())
        metrics[:] = METRIC_MAX
        metrics[2], metrics[3, :4] = METRIC_MIN + 1, METRIC_MIN  # the very end wins
        metrics[1, 4:] = METRIC_MIN
    keys = [torch.from_numpy(k) for k in ssd_kernels.pack_key(metrics, gids)]
    got = ssd_kernels.first_min_combine(keys)
    np.testing.assert_array_equal(got.numpy(), _combine_want(metrics, gids))
    shard = {"all-equal": [0] * n, "minimum-last": [3] * n, "padded-copies": [0] * n,
             "int64-range": [3] * 4 + [1] * 5}[case]
    np.testing.assert_array_equal(got.numpy(), gids[shard, np.arange(n)])
    if case == "padded-copies":
        assert (got.numpy() == 0).all()
    # any number of shards on the CPU; none, or keys of two shapes, are refused
    nine = ssd_kernels.first_min_combine([torch.zeros(2, dtype=torch.int64)] * 9)
    assert nine.dtype == torch.int32 and nine.tolist() == [0, 0]
    with pytest.raises(ValueError, match="one shape"):
        ssd_kernels.first_min_combine([])
    with pytest.raises(ValueError, match="one shape"):
        ssd_kernels.first_min_combine([torch.zeros(2, dtype=torch.int64),
                                       torch.zeros(3, dtype=torch.int64)])


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.integers(METRIC_MIN, METRIC_MAX),
                          st.integers(0, ssd_kernels.GID_LIMIT - 1)), min_size=2, max_size=2))
def test_pack_key_round_trip_and_order(pairs):
    """Over the whole range (the metric of any window check_window admits,
    any glyph below 2^28): the key is a non-negative int64, unpacks to its
    (metric, glyph) as ints, numpy and torch int64 alike, and two keys order
    as their (metric, glyph) pairs do — the reference's first minimum."""
    keys = [ssd_kernels.pack_key(m, g) for m, g in pairs]
    assert all(0 <= k < 2**63 for k in keys)
    assert [ssd_kernels.unpack_key(k) for k in keys] == pairs
    assert (keys[0] < keys[1]) == (pairs[0] < pairs[1])
    m, g = (np.array(v, np.int64) for v in zip(*pairs))
    for arr in (ssd_kernels.pack_key(m, g), ssd_kernels.pack_key(torch.from_numpy(m),
                                                                  torch.from_numpy(g)).numpy()):
        assert arr.dtype == np.int64 and arr.tolist() == keys
        back = ssd_kernels.unpack_key(arr)
        assert back[0].tolist() == m.tolist() and back[1].tolist() == g.tolist()


def test_shard_bank_checks_once():
    """shard_bank refuses what K4p cannot take: a glyph number past 2^28, a
    negative window start, a wrong dtype or shape; a good shard keeps its
    first glyph and the launcher's pitch for every block size."""
    rng = np.random.default_rng(3)
    tmpl = torch.from_numpy(rng.integers(0, 256, (5, 7, 12, 9), dtype=np.uint8))
    tsq = (tmpl.to(torch.int64) ** 2).sum(dim=(2, 3))
    wx0 = torch.tensor([0, 7, 15, 23, 31], dtype=torch.int32)
    sb = ssd_kernels.shard_bank(tmpl, tsq, wx0, 40, g0=ssd_kernels.GID_LIMIT - 7)
    assert sb.g0 == ssd_kernels.GID_LIMIT - 7 and sb.n_cells == 5 and sb.addr == 0
    assert all(sb.pitch(w) == ssd_kernels.partial_pitch(wx0.numpy(), 40, 12, 9, w) > 0
               for w in range(1, ssd_kernels.MAX_PARTIAL_WARPS + 1))
    for kwargs, match in (({"g0": ssd_kernels.GID_LIMIT - 6}, "2\\^28"),
                          ({"wx0": -wx0}, ">= 0"), ({"tsq": tsq.to(torch.int32)}, "tsq"),
                          ({"tsq": tsq[:, :3].contiguous()}, "tsq")):
        args = {"templates": tmpl, "tsq": tsq, "wx0": wx0, "crop_w": 40, **kwargs}
        with pytest.raises(ValueError, match=match):
            ssd_kernels.shard_bank(**args)


# --- the combine's two paths: in place on one device, gathered across devices ---------


def _sharded_ids(setup, mesh):
    face, ropts, dopts, shape, pages = setup
    dec = JGridDecoder(face, ALPHA, dopts, ropts, shape)
    padded, _ = tmesh.pad_batch(pages, mesh.shape["pages"])
    out = []
    for grp, _ in dec.groups:
        bank = tbank(build_grid_bank(face, ALPHA, ropts, dec.crop_w, grp.crop_h))
        out.append(tmesh.fetch_global(
            tdecode.make_sharded_grid_fn(bank, grp.ys, dec.x0, mesh)(padded)))
        strips = tfocr.crop_strips(padded, grp.ys, grp.crop_h, dec.x0, dec.crop_w)
        out.append(tuple(t.numpy() for t in tfocr.StripForward(bank, torch.device("cpu"))(
            torch.from_numpy(strips))))
    return out


def test_one_device_row_combines_in_place_and_other_rows_gather(setup, monkeypatch):
    """A glyph row whose slots share a device reads the shards' keys where
    they lie (no gather_group call); a row whose slots name different devices
    (cpu and cpu:0, faked) takes the gather path, one stack of keys a row.
    Both give the unsharded step's ids and white flags."""
    gathers = []
    real = tmesh.gather_group

    def spy(dst, parts):
        gathers.append((dst.index, [s.index for s, _ in parts]))
        out = real(dst, parts)
        assert out.dtype == torch.int64  # one tensor a row: the keys
        return out

    monkeypatch.setattr(tdecode, "gather_group", spy)
    one, mixed = cpu_mesh(8, 2), tmesh.page_mesh(["cpu", "cpu:0"] * 4, 2)
    assert all(tmesh.on_one_device([s.device for s in row]) for row in one.grid)
    assert not any(tmesh.on_one_device([s.device for s in row]) for row in mixed.grid)
    in_place = _sharded_ids(setup, one)
    assert gathers == []
    gathered = _sharded_ids(setup, mixed)
    n_groups = len(gathered) // 2
    assert gathers == [(2 * r, [2 * r, 2 * r + 1]) for r in range(4)] * n_groups
    for a, b in zip(in_place, gathered):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for (ids, white), (ids_s, white_s) in zip(in_place[::2], in_place[1::2]):
        np.testing.assert_array_equal(ids, ids_s)
        np.testing.assert_array_equal(white, white_s)


@pytest.mark.parametrize("glyph_shards", [2, 4])
def test_only_the_first_shard_gives_white_flags(setup, monkeypatch, glyph_shards):
    """K4p is asked for white flags on the first slot of each glyph row
    only; the mesh's white flags still equal those of the step GridDecoder
    runs a row group with on one slot (StripForward)."""
    asked = []
    real = ssd_kernels.ssd_argmin_partial_reference

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        asked.append((tdevice.current_slot(), out[1] is not None))
        return out

    monkeypatch.setattr(ssd_kernels, "ssd_argmin_partial_reference", spy)
    mesh = cpu_mesh(8, glyph_shards)
    res = _sharded_ids(setup, mesh)
    assert asked and all(w == (i % glyph_shards == 0) for i, w in asked)
    assert {i for i, _ in asked} == set(range(8))
    for (ids, white), (ids_s, white_s) in zip(res[::2], res[1::2]):
        np.testing.assert_array_equal(white, white_s)
        np.testing.assert_array_equal(ids, ids_s)


# --- more than 8 glyph shards; glyph rows that span processes --------------------


@pytest.mark.parametrize("glyph_shards", [8, 9, 16, 17])
def test_sharded_grid_over_many_glyph_shards(setup, glyph_shards, slot_calls):
    """One glyph row of ``glyph_shards`` cpu slots (the 12-glyph bank padded
    with copies of glyph 0 to a multiple of the shards, as shard_grid_bank
    pads): ids and white flags bit-identical to focr_tpu's unsharded
    make_strip_forward on the same pages, and at 8 to focr_tpu's sharded fn
    on its 8 virtual devices. K4p runs on every slot, K6 once, on the head.
    (K6 used to refuse more than 8 key tensors, even on cpu slots.)"""
    from focr_tpu.models.focr import make_strip_forward

    face, ropts, dopts, shape, pages = setup
    mesh = cpu_mesh(glyph_shards, glyph_shards)
    assert mesh.shape == {"pages": 1, "glyphs": glyph_shards}
    dec = JGridDecoder(face, ALPHA, dopts, ropts, shape)
    noise = np.random.default_rng(glyph_shards).integers(0, 256, (2, *shape), dtype=np.uint8)
    batch = np.concatenate([pages, noise])  # noise: near-ties across the shards
    slot_calls.clear()
    for grp, _ in dec.groups:
        jb = build_grid_bank(face, ALPHA, ropts, dec.crop_w, grp.crop_h)
        ids_t, white_t = tmesh.fetch_global(
            tdecode.make_sharded_grid_fn(tbank(jb), grp.ys, dec.x0, mesh)(batch))
        strips = tfocr.crop_strips(batch, grp.ys, grp.crop_h, dec.x0, dec.crop_w)
        ids_j, white_j = (np.asarray(a) for a in make_strip_forward(jb)(strips))
        np.testing.assert_array_equal(ids_t, ids_j.astype(np.int32))
        np.testing.assert_array_equal(white_t, white_j)
        if glyph_shards == 8:
            ids_s, white_s = jax.device_get(jdecode.make_sharded_grid_fn(
                jb, grp.ys, dec.x0, jmesh.page_mesh(glyph_shards=8))(batch))
            np.testing.assert_array_equal(ids_t, np.asarray(ids_s))
            np.testing.assert_array_equal(white_t, np.asarray(white_s))
    assert {i for i, k in slot_calls if k == "ssd_argmin_partial"} == set(range(glyph_shards))
    assert {i for i, k in slot_calls if k == "ssd_combine"} == {0}


@pytest.mark.parametrize("n_g", [9, 16, 17, 64, 65, 130])
@pytest.mark.parametrize("case", ["all-equal", "minimum-last", "padded-copies", "metric-ends",
                                  "few-values"])
def test_first_min_combine_many_shards(case, n_g):
    """The plain K6 over more than 8 shards against numpy's first-occurrence
    argmin over the shards (focr_tpu/parallel/decode.py:78-79): every shard
    equal, the minimum in the last shard only, padded copies of glyph 0 in
    the later shards, the metric's ends with glyphs up to 2^28 - 1, and few
    distinct values."""
    rng = np.random.default_rng(n_g)
    n = 37
    Gl = ssd_kernels.GID_LIMIT // n_g
    metrics = rng.integers(0, 100, (n_g, n)).astype(np.int64)
    gids = rng.integers(0, Gl, (n_g, n)) + (np.arange(n_g, dtype=np.int64) * Gl)[:, None]
    if case == "all-equal":
        metrics[:] = 7
    elif case == "minimum-last":
        metrics[-1] = -1
    elif case == "padded-copies":  # shards 1.. hold copies of glyph 0, shard 0 glyph 0 itself
        metrics[:] = 3
        gids[0] = 0
    elif case == "metric-ends":
        metrics[:] = METRIC_MAX
        metrics[-1, ::2], metrics[n_g // 2, 1::4] = METRIC_MIN, METRIC_MIN
        gids[-1] = ssd_kernels.GID_LIMIT - 1 - rng.integers(0, 2, n)
    else:
        metrics = rng.integers(-1, 2, (n_g, n)).astype(np.int64) * 10**9
    keys = [torch.from_numpy(k) for k in ssd_kernels.pack_key(metrics, gids)]
    got = ssd_kernels.first_min_combine(keys)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _combine_want(metrics, gids))
    if case == "padded-copies":
        assert (got.numpy() == 0).all()
    elif case == "minimum-last":
        np.testing.assert_array_equal(got.numpy(), gids[-1])


@pytest.mark.parametrize("world,n,g", [(2, 1, 2), (2, 3, 2), (2, 4, 8), (3, 2, 3), (2, 3, 6),
                                       (2, 3, 3)])
def test_page_mesh_lets_a_glyph_group_span_processes(monkeypatch, world, n, g):
    """Under a process group, glyph_shards need only divide the slot count
    over every process (focr_tpu's page_mesh divides the global device
    count): a row may span processes, its head in the lowest of them.
    (page_mesh used to require it to divide this process's own count.)"""
    monkeypatch.setattr(tmesh, "process_count", lambda: world)
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    monkeypatch.setattr(tmesh, "all_gather_host", lambda a: [a] * world)
    mesh = tmesh.page_mesh(["cpu"] * n, g)
    assert mesh.shape == {"pages": world * n // g, "glyphs": g} and mesh.rank == 1
    assert [s.rank for s in mesh.slots] == [r for r in range(world) for _ in range(n)]
    assert [s.index for s in mesh.local_slots] == list(range(n, 2 * n))
    assert all(s.device is None for s in mesh.slots if s.rank != 1)
    spans = [row for row in mesh.grid if len({s.rank for s in row}) > 1]
    assert bool(spans) == (n % g != 0)
    assert all(row[0].rank == min(s.rank for s in row) for row in mesh.grid)
    with pytest.raises(ValueError, match=f"glyph_shards=5 must divide device count "
                                         f"{world * n} \\({world} processes of {n}\\)"):
        tmesh.page_mesh(["cpu"] * n, 5)


class _Wire:
    """gloo's point to point between the threads that stand for processes: a
    queue a (source, destination, tag), the sender's rank in a thread-local.
    Stands in for mesh.send_group and mesh.recv_group."""

    def __init__(self):
        self.boxes: dict = {}
        self.lock = threading.Lock()
        self.me = threading.local()
        self.sent: list = []

    def box(self, key):
        with self.lock:
            return self.boxes.setdefault(key, queue.Queue())

    def send_group(self, dst, tag, parts):
        host = torch.stack([t for _, t in parts])
        with self.lock:
            self.sent.append((self.me.rank, dst, tag, [s.index for s, _ in parts]))
        self.box((self.me.rank, dst, tag)).put(host.clone())
        return types.SimpleNamespace(wait=lambda: None), host

    def recv_group(self, src, tag, k, shape, dtype, dst):
        host = torch.empty((k, *shape), dtype=dtype)
        box = self.box((src, self.me.rank, tag))

        def wait():
            got = box.get(timeout=120)
            assert got.shape == host.shape and got.dtype == host.dtype
            host.copy_(got)

        return types.SimpleNamespace(wait=wait), host


@pytest.mark.parametrize("world,n,g", [(2, 1, 2), (2, 3, 2), (2, 4, 8), (3, 2, 3), (3, 1, 3)])
def test_spanning_rows_in_simulated_processes(setup, monkeypatch, slot_calls, world, n, g):
    """make_sharded_grid_fn on every process's view of one mesh (threads for
    processes, _Wire for gloo): each process runs K4p on its own slots; the
    later processes of a spanning row send their keys once, in slot order,
    to the head's; K6 runs on the heads only. Every row's ids and white
    flags come from its head's process, bit-identical to the unsharded
    step."""
    face, ropts, dopts, shape, pages = setup
    wire = _Wire()
    monkeypatch.setattr(tdecode, "send_group", wire.send_group)
    monkeypatch.setattr(tdecode, "recv_group", wire.recv_group)
    meshes = [tmesh.Mesh(["cpu"] * (world * n), g, [r for r in range(world) for _ in range(n)],
                         r) for r in range(world)]
    dec = JGridDecoder(face, ALPHA, dopts, ropts, shape)
    padded, _ = tmesh.pad_batch(pages, meshes[0].shape["pages"])
    slot_calls.clear()
    for grp, _ in dec.groups:
        bank = tbank(build_grid_bank(face, ALPHA, ropts, dec.crop_w, grp.crop_h))
        fns = [tdecode.make_sharded_grid_fn(bank, grp.ys, dec.x0, m) for m in meshes]
        outs, errors = [None] * world, []

        def run(r):
            wire.me.rank = r
            try:
                outs[r] = fns[r](padded)
            except Exception as e:  # noqa: BLE001 - a thread's failure, asserted below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors and all(o is not None for o in outs), errors
        strips = tfocr.crop_strips(padded, grp.ys, grp.crop_h, dec.x0, dec.crop_w)
        ids_s, white_s = tfocr.StripForward(bank, torch.device("cpu"))(torch.from_numpy(strips))
        covered = np.zeros(len(padded), bool)
        for r, (ids, white) in enumerate(outs):
            heads = [row[0] for row in meshes[r].grid if row[0].rank == r]
            assert [s for s, _, _ in ids.shards] == heads == [s for s, _, _ in white.shards]
            for (_, idx, t), (_, _, w) in zip(ids.shards, white.shards):
                assert torch.equal(t, ids_s[idx]) and torch.equal(w, white_s[idx])
                covered[idx] = True
        assert covered.all()
    rows = meshes[0].grid
    want = [(r, row[0].rank, p, [s.index for s in row if s.rank == r])  # one send a process
            for p, row in enumerate(rows) for r in sorted({s.rank for s in row} - {row[0].rank})]
    assert want and sorted(wire.sent) == sorted(want * len(dec.groups))
    assert {i for i, k in slot_calls if k == "ssd_argmin_partial"} == set(range(world * n))
    assert {i for i, k in slot_calls if k == "ssd_combine"} == {row[0].index for row in rows}
