"""Two real processes over gloo, each with four slots: the port's counterpart
of tools/multihost_smoke.py.

    python tools/torch_multiproc_smoke.py [--device cpu|cuda:0] [--corpus small|canonical]

Spawns 2 OS processes (never forks: a fork after CUDA is initialised breaks
the children). Each joins the group with ``init_distributed("tcp://127.0.0.1:
<port>", 2, rank)`` (a free port, found by binding port 0), names ``--device``
four times as its slots — ``cpu`` four times here, ``cuda:0`` four times on a
card — and runs the mesh paths over the resulting 8-slot global mesh:

  * focr grid decode, ``GridDecoder(mesh=...).decode_batch``, at 2 glyph
    shards (K4p on every slot, K6 on each group's first): every process must
    hold the whole corpus' lines (mesh.fetch_global's all-gather);
  * focr on meshes whose glyph rows span the two processes (SPANNING: 1 slot
    a process at 2 shards, every row spans; 3 slots at 2, one row of three
    spans; 4 slots at 8, the one row spans): the later process sends its
    keys to the head's (parallel/decode.py); every process must hold the
    whole batch's ids and white flags, bit-identical to its local unsharded
    step, and the lines; on a card, also the host exchange's ms a batch for
    a spanning row (mesh.send_group, recv_group and upload_group on the
    keys of one batch, timed on the head's process);
  * the proportional decoder over all eight slots;
  * ncc, ``NccMatcher.get_hits_many_sharded``: each process sweeps and replays
    its share on its own slots and the packed hits are all-gathered
    (models/ncc.py::_get_hits_many_multiproc); as objects, as structs, and
    with a fused post step.

Every process asserts bit parity with its local single-slot engines and, on a
card, that K4p and K1 were launched on its own slots and K6 on its glyph
rows' heads only (utils/device.py::SLOT_LAUNCHES, counted where a wrapper
launches; on cpu slots the plain versions run and nothing is counted). Each
prints one ``{"multiproc": ...}`` JSON line with those launches and the
exchange's ms. Exit code 0 = every process passed.

``--corpus small`` (the default where FreeType and the DejaVu fonts load)
renders small banks and pages; ``--corpus canonical`` (the default elsewhere)
takes the banks and the first pages of tests/fixtures/torch_*_golden.npz.
(pytest wrapper: tests/test_torch_multiproc.py; on a card chip_smoke.py runs
it as its phase 19.)
"""

from __future__ import annotations

import argparse
import json
import os
import select
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
SANS_FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
WORLD = 2
SLOTS_EACH = 4
SPANNING = ((1, 2), (3, 2), (4, 8))  # (slots a process, glyph shards): rows across processes
CHILD_TIMEOUT_S = 300  # under the pytest wrapper's, so a hung rendezvous is reaped here


def small_corpus():
    """(focr, prop, ncc) cases rendered with FreeType: each (decoder or
    matcher arguments, pages)."""
    import numpy as np

    from focr_tpu_torch.fonts.ft import Face
    from focr_tpu_torch.io.synth import synthesize_page
    from focr_tpu_torch.models.types import DecodeOptions, RenderOptions

    face, sans = Face(FONT), Face(SANS_FONT)
    ropts = RenderOptions(size=9.0)
    dopts = DecodeOptions(x_start=2, y_start=2, line_height=11, line_advance=12, width=60)
    alphabet, shape = "ABab01", (40, 72)
    texts = [["ABab01", "ba10BA"], ["01abAB", "AA11bb"], ["baAB10", "B0a1bA"]]
    pages = np.stack([synthesize_page(face, t, dopts, ropts, alphabet, shape) for t in texts])
    p_ropts = RenderOptions(size=12.0)
    p_dopts = DecodeOptions(x_start=4, y_start=5, line_height=16, line_advance=19, width=110)
    p_alpha, p_shape = "AWim01", (65, 130)
    rng = np.random.default_rng(11)
    p_pages = np.stack([
        synthesize_page(sans, ["".join(rng.choice(list(p_alpha), size=7)) for _ in range(3)],
                        p_dopts, p_ropts, p_alpha, p_shape) for _ in range(3)])
    return (
        (dict(face=face, alphabet=alphabet, dopts=dopts, ropts=ropts, page_shape=shape), pages),
        (dict(face=sans, alphabet=p_alpha, dopts=p_dopts, ropts=p_ropts, page_shape=p_shape),
         p_pages),
        (dict(face=face, alphabet="ABab", ropts=ropts, x_bits=1, threshold=0.8), pages),
    )


def canonical_corpus(n_pages: int = 16):
    """The same cases from the golden fixtures (saved banks: no FreeType)."""
    import numpy as np

    from focr_tpu_torch.fonts.bank import load_grid_bank, load_needle_bank
    from focr_tpu_torch.models.types import (
        NCC_DEFAULT_ALPHABET, DecodeOptions, RenderOptions,
    )

    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    cases = []
    for name in ("focr", "prop"):
        path = os.path.join(FIXTURES, f"torch_{name}_golden.npz")
        banks, settings = load_grid_bank(path)
        with np.load(path, allow_pickle=False) as z:
            pages = z["pages"][:n_pages]
        cases.append((dict(face=None, alphabet=settings["alphabet"], dopts=dopts, ropts=ropts,
                           page_shape=pages.shape[1:], banks=banks), pages))
    path = os.path.join(FIXTURES, "torch_ncc_golden.npz")
    needles, _ = load_needle_bank(path)
    with np.load(path, allow_pickle=False) as z:
        pages = z["pages"][:n_pages]
    cases.append((dict(face=None, alphabet=NCC_DEFAULT_ALPHABET, ropts=ropts, x_bits=2,
                       threshold=0.8, needles=needles), pages))
    return tuple(cases)


def spanning_checks(rank: int, device: str, kw: dict, local, pages) -> dict:
    """The focr case (``kw``; ``local``, its single-slot decoder) over the
    SPANNING meshes: ids, white flags and lines against the local unsharded
    step; on a card, K4p on every own slot and K6 on the own heads only.
    Returns the launches by mesh."""
    import numpy as np
    import torch

    from focr_tpu_torch.models.focr import GridDecoder, StripForward, crop_strips
    from focr_tpu_torch.parallel import mesh as M
    from focr_tpu_torch.parallel.decode import make_sharded_grid_fn
    from focr_tpu_torch.utils.device import SLOT_LAUNCHES, reset_slot_launches

    on_card = torch.device(device).type == "cuda"
    want_lines = [[(ln.text, ln.y) for ln in page] for page in local.decode_batch(pages)]
    out = {}
    for n, g in SPANNING:
        mesh = M.page_mesh([device] * n, glyph_shards=g)
        assert any(len({s.rank for s in row}) > 1 for row in mesh.grid)
        padded, _ = M.pad_batch(pages, mesh.shape[M.PAGES_AXIS])
        reset_slot_launches()
        for grp, bank in zip((grp for grp, _ in local.groups), local.banks):
            ids, white = M.fetch_global(
                make_sharded_grid_fn(bank, grp.ys, local.x0, mesh)(padded))
            strips = crop_strips(padded, grp.ys, grp.crop_h, local.x0, local.crop_w)
            ids_s, white_s = StripForward(bank, torch.device(device))(
                torch.from_numpy(strips).to(device))
            assert np.array_equal(ids, ids_s.cpu().numpy()), f"[p{rank}] {n}x{g}: ids"
            assert np.array_equal(white, white_s.cpu().numpy()), f"[p{rank}] {n}x{g}: white"
        launches = {f"{i}/{k}": v for (i, k), v in sorted(SLOT_LAUNCHES.items())}
        if on_card:
            k4p = {i for i, k in SLOT_LAUNCHES if k == "ssd_argmin_partial"}
            k6 = {i for i, k in SLOT_LAUNCHES if k == "ssd_combine"}
            heads = {row[0].index for row in mesh.grid if row[0].rank == rank}
            assert k4p == {s.index for s in mesh.local_slots}, f"[p{rank}] K4p on {k4p}"
            assert k6 == heads, f"[p{rank}] {n}x{g}: K6 on slots {k6}, heads {heads}"
        got = [[(ln.text, ln.y) for ln in page]
               for page in GridDecoder(device=device, mesh=mesh, **kw).decode_batch(pages)]
        assert got == want_lines, f"[p{rank}] {n}x{g}: lines"
        out[f"{n}x{g}"] = launches
    return out


def exchange_ms(device: str, local, pages, reps: int = 30) -> float:
    """The host exchange of one batch's spanning rows on the 1-slot, 2-shard
    mesh: each row group of ``local`` (the focr case's single-slot decoder)
    gives keys [b, R, C] int64 that go from process 1's slot to process 0's
    (send_group: a pinned copy, the stream waited on, gloo; recv_group,
    upload_group and the head's stream waited on); ms a batch as the head's
    process sees it."""
    import time

    import torch
    import torch.distributed as dist

    from focr_tpu_torch.parallel import mesh as M

    mesh = M.page_mesh([device], glyph_shards=2)
    b = len(M.pad_batch(pages, mesh.shape[M.PAGES_AXIS])[0]) // mesh.shape[M.PAGES_AXIS]
    head, slot = mesh.grid[0]
    mine = mesh.local_slots[0]
    shapes = [(b, len(grp.ys), bank.n_cells)
              for (grp, _), bank in zip(local.groups, local.banks)]
    keys = [torch.randint(0, 2**40, s, dtype=torch.int64, device=device) for s in shapes]
    torch.cuda.synchronize()

    def one_batch():
        for tag, key in enumerate(keys):
            if mine is slot:
                work, _ = M.send_group(head.rank, tag, [(slot, key)])
                work.wait()
            else:
                work, host = M.recv_group(slot.rank, tag, 1, tuple(key.shape), key.dtype, head)
                work.wait()
                got = M.upload_group(head, host)[0]
                head.stream.synchronize()
                assert torch.equal(got, key)

    one_batch()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        one_batch()
    return (time.perf_counter() - t0) / reps * 1e3


def say(line: str) -> None:
    """One line on stdout in a single write: the two processes share the
    parent's pipe, and print() under PYTHONUNBUFFERED=1 writes the text and
    its newline apart, so another process's line could land between them. A
    pipe write of at most PIPE_BUF bytes is never split."""
    data = (line + "\n").encode()
    assert len(data) <= select.PIPE_BUF, f"a {len(data)}-byte line could be split"
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), data)


def worker(rank: int, port: int, device: str, corpus: str) -> None:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from focr_tpu_torch.models.focr import GridDecoder
    from focr_tpu_torch.models.ncc import NccMatcher
    from focr_tpu_torch.models.post import process_hits_text
    from focr_tpu_torch.parallel import mesh as M
    from focr_tpu_torch.utils.device import SLOT_LAUNCHES, reset_slot_launches

    torch.set_num_threads(2)
    M.init_distributed(f"tcp://127.0.0.1:{port}", WORLD, rank)
    try:
        assert M.process_count() == WORLD and M.process_index() == rank
        slots = [device] * SLOTS_EACH
        flat = M.page_mesh(slots)
        assert flat.size == WORLD * SLOTS_EACH and len(flat.local_slots) == SLOTS_EACH
        focr_case, prop_case, ncc_case = small_corpus() if corpus == "small" else canonical_corpus()
        on_card = torch.device(device).type == "cuda"

        def lines(decoded):
            return [[(ln.text, ln.y) for ln in page] for page in decoded]

        # focr: the mesh decode == the local single-slot decode, on EVERY process
        kw, pages = focr_case
        local = GridDecoder(device=device, **kw)
        reset_slot_launches()
        got = lines(GridDecoder(device=device, mesh=M.page_mesh(slots, glyph_shards=2),
                                **kw).decode_batch(pages))
        want = lines(local.decode_batch(pages))
        assert got == want, f"[p{rank}] focr mesh != local"
        assert any(t.strip() for page in got for t, _ in page), "focr decoded nothing"
        mine = {s.index for s in flat.local_slots} if on_card else set()
        assert {i for i, k in SLOT_LAUNCHES if k == "ssd_argmin_partial"} == mine, (
            f"[p{rank}] K4p was launched on slots {sorted(SLOT_LAUNCHES)}")
        # focr on meshes whose glyph rows span the two processes
        spanning = spanning_checks(rank, device, kw, local, pages)
        ms = None
        if on_card:
            torch.manual_seed(5)  # the same keys on both processes
            ms = exchange_ms(device, local, pages)
        say(json.dumps({"multiproc": {"rank": rank, "device": device, "corpus": corpus,
                                      "spanning_slot_launches": spanning,
                                      "exchange_ms_per_batch": ms}}))

        # prop: the inked lines over all eight slots
        kw, pages = prop_case
        dec = GridDecoder(device=device, mesh=flat, **kw)
        assert dec.prop_groups and dec.prop_groups[0][1].mesh is not None
        got = lines(dec.decode_batch(pages))
        assert got == lines(GridDecoder(device=device, **kw).decode_batch(pages)), (
            f"[p{rank}] prop mesh != local")

        # ncc: the sharded corpus search == the per-page local search
        kw, pages = ncc_case
        m = NccMatcher(device=device, **kw)

        def key(hs):
            return [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes())
                    for h in hs]

        local = [key(m.get_hits(p)) for p in pages]
        assert any(local), "ncc found nothing"
        reset_slot_launches()
        sharded = m.get_hits_many_sharded(list(pages), flat)
        assert [key(h) for h in sharded] == local, f"[p{rank}] ncc mesh != local"
        swept = {i for i, k in SLOT_LAUNCHES if k == "ncc_sweep"}
        share = len(pages[rank::WORLD]) if on_card else 0
        assert swept == {s.index for s in flat.local_slots[:share]}, (
            f"[p{rank}] K1 was launched on slots {sorted(swept)} for a share of {share} pages")
        structs = m.get_hits_many_sharded(list(pages), flat, struct=True)
        assert [key(s.to_objects()) for s in structs] == local, f"[p{rank}] ncc struct path"
        post = lambda hs: process_hits_text(hs, 0.95, 5)  # noqa: E731
        fused = m.get_hits_many_sharded(list(pages), flat, struct=True, post=post)
        assert fused == [post(s) for s in structs], f"[p{rank}] ncc fused post"
        say(f"[p{rank}] multiproc smoke OK ({corpus} corpus, {SLOTS_EACH} slots on {device}, "
            f"{flat.size} in the mesh)")
    finally:
        M.shutdown_distributed()


def default_corpus() -> str:
    sys.path.insert(0, HERE)
    from focr_tpu_torch.fonts.ft import Face

    try:
        Face(FONT), Face(SANS_FONT)
    except OSError:
        return "canonical"
    return "small"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="the device every slot names: cuda:N, or cpu (the plain versions)")
    ap.add_argument("--corpus", choices=["small", "canonical"], default=None)
    ap.add_argument("--worker", nargs=2, metavar=("RANK", "PORT"), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    corpus = args.corpus or default_corpus()
    if args.worker is not None:
        worker(int(args.worker[0]), int(args.worker[1]), args.device, corpus)
        return 0
    with socket.socket() as s:  # a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--device", args.device,
                          "--corpus", corpus, "--worker", str(r), str(port)])
        for r in range(WORLD)
    ]
    try:
        rcs = [p.wait(timeout=CHILD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"multiproc smoke rcs={rcs}")
    # a signal death has a NEGATIVE return code: max() would mask it
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
