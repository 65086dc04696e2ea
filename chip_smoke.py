#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (focr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives every slice of the port at its canonical workload, from golden
fixtures made by focr_tpu on a CPU with saved glyph banks, so no FreeType is
needed:

  ncc  — bench.py's dense corpus: DejaVu Sans Mono 13, 74 letters, --x-bits 2,
         296 needles in a 13x8 and a 13x9 group, 792x662 letter pages of 48
         lines x 77 characters (tests/fixtures/torch_ncc_golden.npz)
  focr — bench.py's focr corpus: DejaVu Sans Mono 13, the 67-glyph default
         alphabet, grid -x 45 -y 39 -w 608 --line-height 12 --line-advance 15
         (78 cells, 50 full rows and one 3-pixel bottom row), 792x662 pages of
         48 lines x 77 characters (tests/fixtures/torch_focr_golden.npz)
  prop — bench.py's prop corpus: DejaVu Sans 13, the same alphabet with ' '
         -> 'A' and '>' -> 'B' (67 glyphs, 65 characters: exact ties), the
         same grid, 792x662 pages of 48 lines x 60 characters
         (tests/fixtures/torch_prop_golden.npz)

Phases, each of which raises on failure:

  1. device  — the card's name and power limit; CUDA must be available
  2. build   — nvcc builds csrc/*.cu and g++ builds csrc/ncc_host.cpp (the
               ncc host library) into focr_tpu_torch/_build/; both then load
               in a process with no compiler on PATH; cuobjdump -sass of the
               kernels must show GMMA instructions in each of K1's five
               wgmma instances
  3. kernels — on the first 8-page wave, inverted and ink-cropped as the
               matcher does: K1 (ncc_sweep, its wgmma instance) and K2
               (compact_hits: its count kernel, one wait, its emit kernel; the
               count kernel also alone) against their plain PyTorch versions
               on the card, exact (tolerance 0), then timed with CUDA events
               (K2 as the main path runs it, and each of its kernels alone;
               K1's device time from a torch.profiler trace too), beside
               cuDNN's conv2d in TF32 on the same wave and needles (a
               yardstick of the correlation alone; the port never calls it);
               then K1 on its edge cases (every needle width 4..16 in both
               tiers, T past 256, ragged words, tiles and items, each
               straight-line and general instance, and the shapes that take
               its mma instance), each
               exact and launching the instance its plan names, and the mma
               instance timed on a shape that takes it
  4. golden  — NccMatcher on the card decodes the fixture's two golden pages
               to focr_tpu's lines, through K1, K2 and K3
  5. cli     — the ncc CLI on 16 pages: once in-process, with the launch
               counts, the host library's call counts and the device stage's
               host waits reset just before and read just after (the counted
               main path: K1, K2's two kernels and K3 — as many K3 launches as
               K1's, no host replay call — and the native post-processing
               scan; 3 waits a wave of two size groups), once as
               `python -m focr_tpu_torch.cli.ncc` (exit 0, same stdout); every
               page's lines are checked against its text
  6. focr-kernels — K4 (ssd_argmin) against its plain PyTorch version on the
               card, exact (tolerance 0 on ids and white): its tensor-core
               instance on a 16-page wave of the corpus cropped as
               GridDecoder crops it (both row groups), seeded noise pages
               (near-ties), an alphabet with duplicated characters (exact
               ties) and a narrow strip whose windows hang past its width; its
               int64 instance on a 1x34000 window; then the main path's
               instance and the plain version timed with CUDA events
  7. focr-golden — GridDecoder on the card decodes the 16 pages, and one
               page streamed in row chunks as the CLI does for a single
               image, to focr_tpu's lines, through K4
  8. focr-cli — the focr CLI on the 16 pages with --grid-bank: once
               in-process with K4's launch count reset just before and read
               just after, once as `python -m focr_tpu_torch.cli.focr`; both
               exit 0 with the same stdout, equal to focr_tpu's lines, and
               every page's text is found in its lines
  9. prop-kernels — K5 (prop_scan) against its plain PyTorch version on the
               card, exact (tolerance 0 on ids), on the 16-page prop wave
               cropped as GridDecoder crops it (both row groups), seeded noise
               strips and a narrow strip whose windows hang past its edge; K1's
               wide instance against its plain version, bit for bit, on seeded
               21x13 needles (the -t 20 size) with planted matches, at a
               threshold above and one below ε, and its hits after the exact
               replay against a host exact search; then both timed with CUDA
               events
 10. prop-golden — GridDecoder on the card decodes the 16 prop pages, and one
               page through the single-image path, to focr_tpu's lines, through
               K5
 11. prop-cli — the focr CLI with DejaVu Sans, the prop alphabet and grid and
               --grid-bank of the prop fixture: once in-process with K5's
               launch count reset just before and read just after, once as
               `python -m focr_tpu_torch.cli.focr`; both exit 0 with the same
               stdout, equal to focr_tpu's lines (the prop corpus' acceptance
               rule, bench.py:209-216: a greedy proportional decode derails on
               look-alike glyphs on every engine, so the text is not compared)
 12. host-native — the ncc host library (host C++, not a device kernel): its
               build (compiler, seconds, OpenMP threads); on phase 3's wave
               (K2's positions) the native replay, K3's yardstick, against the
               NumPy plain replay, bit for bit
               (coordinates, f32 similarity bytes, counts, warn flags), and
               the native post-processing scan against its NumPy version
               (same winners), each timed per page; the matcher's 4-thread
               collect pool against serial collection on the 16 pages; the
               CLI with --engine native on the two golden pages, whose lines
               must equal focr_tpu's; the page reader with Pillow blocked from
               import: one corpus page as P1-P6 and as PNG (all five filters,
               16-bit RGB with Adam7, and as save_gray writes it) must decode
               to its PGM, and a PGM and a PNG page's read times

 13. pipeline — the ncc CLI in-process on the 16 pages four times over (64
               pages, eight waves, 296 needles): stdout equal to the 16 pages'
               four times; 3 host waits a wave; K1, K2 and K3 launched twice a
               wave each; a torch.profiler trace of one such run, between
               K1 launches on the caller's stream as markers, must show
               the pipeline's K1 launches on another stream, and the first K1
               of wave k+1 starting before the collection of wave k ends, for
               every k; then pages/s at the pipeline's depth and at depth 0
               (the stages in series), in turns, four calls
 14. banks   — the focr and prop CLIs on their 16 pages decompress exactly the
               crop heights they use (12 and 3), counted on the bank set the
               CLI opened; the bank load's ms when every height is asked for
               (what the eager load did) and when only those two are
 15. metrics — the focr and ncc CLIs with --metrics-json and --profile: the
               JSON has exactly focr_tpu's keys (focr's with its byte
               counters besides) and decoded_pages 16, the
               trace file names a focr_ kernel, stdout is unchanged by both
               flags; --verbose-sync on one golden page prints the measured
               label on every group line and the golden lines on stdout;
               --device-kernel pallas --wire pos --mesh auto leave stdout
               unchanged
 16. overlays — where FreeType loads: focr --verify and --test write their
               PNGs and the verify line; where it does not: --verify with
               --grid-bank raises Face's error, and the run prints
               {"overlays": "no FreeType on this machine"}
 17. mesh-kernels — the glyph axis' two kernels on the focr corpus' bank cut
               into 2 and into 4 glyph slices (parallel/decode.py::
               shard_grid_bank: 67 glyphs pad to 68 with a copy of glyph 0),
               each slice checked once as the mesh path builds it
               (ops/ssd_kernels.py::shard_bank): K4p (ssd_argmin_partial) on
               every slice against its plain version (the packed keys and,
               from the first slice only, the white flags, bit-identical) on
               the corpus wave, on noise and white pages and on the 8-page
               block a slot of a 2x2 mesh is given (the shape that is timed);
               K6 (first_min_combine) on the slices' keys where they lie
               against its plain version, and on adversarial keys at 2, 4, 8,
               9, 16 and 17 shards (equal metrics in every shard, the minimum
               in the last shard, padded copies of glyph 0, the metric's ends
               with glyphs up to 2^28 - 1, few distinct values); the combined
               ids against unsharded K4's; K4p's int64 instance on a 1x34000
               window; the same on the bank cut into 9, 16 and 17 slices (K6
               folds groups of 8 shards first: one fold launch, then its last
               pass); then both timed at each count on a slot's block of 8
               pages: the call with CUDA events, device time from a
               torch.profiler trace (the calls are host-bound; K6's fold pass
               apart), each wrapper's host us a call (200 calls, one sync),
               the plain versions, and for K6 torch.amin of the stacked keys
               over the shard axis (one call that computes K6's function but
               for the final mask)
 18. mesh-paths — the three CLIs in-process over four slots,
               FOCR_TORCH_MESH_DEVICES=cuda:0 four times (each slot its own
               stream), and over the physical cards as well when more than one
               is visible (the log says which ran): focr with --glyph-shards
               1, 2 and 4, prop, and ncc on 64 pages (two waves of 32, eight
               sub-waves); every run's stdout byte-identical to focr_tpu's,
               three runs each; the wrappers' launch counts, reset before a
               run and read after it, equal the slots' own counts, and every
               slot launched; then pages/s in turns against --mesh off (off,
               mesh, mesh, off; three runs a turn); then focr at
               --glyph-shards 9, 16 and 17 over as many slots of cuda:0, one
               counted run each: stdout, K4p on every slot, K6 and its fold
               launches on the head only
 19. multiproc — tools/torch_multiproc_smoke.py: two processes over gloo,
               four slots each on the card, the canonical corpora, and focr
               on meshes whose glyph rows span the two processes (1 slot a
               process at 2 glyph shards, 3 at 2, 4 at 8): every process's
               ids and white flags bit-identical to its local unsharded step,
               K4p launched on all its slots, K6 on its rows' heads only; the
               host exchange of a batch's spanning row timed; both must print
               OK
 20. replay  — K3 (ncc_replay) on phase 3's wave, from K2's positions on the
               card: the candidates a (page, needle) segment holds (p50, p99,
               max); K3 against its plain PyTorch version on the card and
               against the host library's replay of each page (x, y, the f32
               similarities' bits, counts, WARN flags; tolerance 0), with
               MAX_MATCHES and with a cap of 5 (it must raise WARN flags); the
               same on tests/replay_cases.py's edge cases (segments of 0-769
               candidates, a window on the crop's last byte, every instance
               kind) at caps 1024, 33, 32 and 5; then K3 timed with CUDA
               events (the call), from a
               torch.profiler trace (device time) and on the host clock (the
               wrapper's µs a call: 200 calls, one sync), beside its plain
               version and the host replay, each per page

Then a JSON line with the conv2d yardstick, one JSON line of the kernels
(with the host tier's numbers under "host_native" and phases 13-14's under
"pipeline" and "banks"), the card line, and last
{"ok": true, "device": {...}}. Each kernel's entry carries its launches on
the counted main path (phases 5, 8, 11; K3 phase 5) and per page, its
max|err| against
its plain version, its ms and plain_ms per page, bound_ms per page — the
larger of its operations (2 per multiply-add, over the ink crop for K1, the
steps taken for K5 and the candidates' windows for K3) over the H100's int8
tensor-core peak and its bytes
(inputs read once, outputs written once) over the memory rate — with
bound_by, and library_ms (null but for K6: no single PyTorch call computes
the other functions). K1's entry carries its device time, its wide
instance's numbers as wide_* and its two designs under "instances" (the
wgmma one with the main path's launches; the mma one, which no shape of the
main path takes, with its numbers on a shape that takes it); K2's
(whose bytes are the mask rows that hold candidates, the row counts and its
outputs) its count kernel's launches, each of its two kernels' ms alone, and
the device stage's host waits a wave; K4's the instance the main path takes;
K3's its device time, the host replay's ms per page (host_replay_ms), the
wrapper's host µs a call, the warps a segment gets and the segments'
candidates.
K4p's and K6's launches are those of phase 18's focr run at 2 glyph shards on
four slots; their ms are per page of a slot's block and per launch (K4p: a
glyph row's calls divided by its shards), with each wrapper's host µs a call,
K6's library_ms (torch.amin of the stacked keys), K4p's cells a block
("warps") and the numbers at 4, 9, 16 and 17 glyph shards under
"by_glyph_shards" (past 8, with phase 18's launches of those runs and K6's
fold launches and fold device time); K4p's entry carries phase 19's under
"spanning" (the launches by process and slot, the exchange's ms a batch). The
line also carries phase 18's pages/s under "mesh" (every entry names its
slots and the number of physical cards under them).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# the card's peaks and the least time a kernel's work needs: the benchmark's
# yardstick (every kernel here multiplies u8 pixels by u8 templates)
from portbench.lib.roofline import bound_ms as bound

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_ncc_golden.npz")
FOCR_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_focr_golden.npz")
PROP_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_prop_golden.npz")
FOCR_GRID = ["-x", "45", "-y", "39", "-w", "608", "--line-height", "12", "--line-advance", "15"]
# the fonts the fixtures' banks were rendered from; only their names are checked
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
SANS_FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
THRESHOLD = 0.8


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call on the card: one warm-up, then ``reps`` calls between
    two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int, kernel: str, per_call: int = 1, traces: int = 4) -> float:
    """Mean ms of device time per call of the kernels whose name holds
    ``kernel``, from a torch.profiler trace of ``reps`` calls, each launching
    ``per_call`` of them: what a call costs the card, where cuda_ms times a
    call that the host bounds. torch.profiler has been seen to leave kernels
    out of a trace (2 of 20, trace after trace) and, once, every kernel of
    one: up to ``traces`` traces are taken until one holds every launch, the
    fullest is used, its time is the mean of the kernels it holds times
    ``per_call``, and the log says when some were missing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want, held = reps * per_call, []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if kernel in e.key]
        # the attribute's name differs between torch versions
        total = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                    for e in evs)
        n = sum(e.count for e in evs)
        held.append((n, total))
        if n == want and total > 0:
            break
    n, total = max(held)
    if not n or total <= 0:
        raise AssertionError(f"{len(held)} traces held no device time of a kernel named "
                             f"{kernel}")
    if n != want:
        log(f"[device-time] {kernel}: {len(held)} trace(s) held "
            f"{[h for h, _ in held]} of the {want} kernels launched; the mean of the "
            "fullest is used")
    return total / n * per_call / 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(a, b) -> int:
    """Largest elementwise |a - b| of two integer tensors of one shape."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def focr_phases(dev, card: str) -> tuple[dict, float, float]:
    """Phases 6-8: the focr slice. Returns (K4's kernels entry, in-process
    CLI pages/s, subprocess CLI pages/s)."""
    import numpy as np
    import torch

    from focr_tpu_torch.cli.focr import main as focr_main
    from focr_tpu_torch.fonts.bank import load_grid_bank
    from focr_tpu_torch.io.images import save_gray
    from focr_tpu_torch.models import focr as focr_model
    from focr_tpu_torch.models.types import DecodeOptions, RenderOptions
    from focr_tpu_torch.ops import ssd_kernels as S

    banks, settings = load_grid_bank(FOCR_FIXTURE)
    with np.load(FOCR_FIXTURE, allow_pickle=False) as z:
        pages = z["pages"]
        truths = json.loads(str(z["truths"]))
        golden = json.loads(str(z["lines"]))
    alphabet = settings["alphabet"]
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    dec = focr_model.GridDecoder(None, alphabet, dopts, RenderOptions(size=13.0),
                                 pages.shape[1:], dev, banks=banks)
    B = len(pages)

    # 6. focr-kernels: K4 against its plain version on four kinds of input
    # (the tensor-core instance) and on a wide window (the int64 instance)
    def check(label, strips, templates, tsq, wx0, forbidden=(), want="mma"):
        args = [torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                for a in (strips, templates, tsq, wx0)]
        instance = S.ssd_plan(strips.shape[-2], strips.shape[-1], templates.shape[-1])[0]
        ids, white = S.ssd_argmin(*args)
        ids_r, white_r = S.ssd_argmin_reference(*args)
        torch.cuda.synchronize()
        e = max(max_abs_err(ids, ids_r), max_abs_err(white.to(torch.int32),
                                                      white_r.to(torch.int32)))
        bad = [g for g in forbidden if bool((ids == g).any())]
        log(f"[focr-kernels] {label}: strips {tuple(strips.shape)}, {templates.shape[1]} glyphs, "
            f"{instance} instance, K4 vs plain max|err| {e}, {int(white.sum())} white strips")
        if e or bad or instance != want:
            raise AssertionError(f"K4 mismatch on {label}: max|err| {e}, duplicate ids {bad}, "
                                 f"instance {instance}")
        return e, args

    err, ms, plain_ms, ops, moved = 0, 0.0, 0.0, 0, 0
    for (grp, fwd), bank in zip(dec.groups, dec.banks):
        strips = focr_model.crop_strips(pages, grp.ys, grp.crop_h, dec.x0, dec.crop_w)
        e, args = check(f"corpus wave, row group h={grp.crop_h} ({len(grp.ys)} rows)", strips,
                        bank.templates, bank.tsq.astype(np.int64), bank.wx0)
        err = max(err, e)
        # every (strip, cell, glyph) window: h x win_w multiply-adds
        Bs, R, h, _ = args[0].shape
        C, G, _, win_w = args[1].shape
        ops += 2 * Bs * R * C * G * h * win_w
        moved += nbytes(*args, *S.ssd_argmin(*args))
        # as the decoder calls it: the bank's fragments packed once
        k_ms = cuda_ms(lambda: S.ssd_argmin(*args, bfrag=fwd.bfrag), 20) / B
        p_ms = cuda_ms(lambda: S.ssd_argmin_reference(*args), 5) / B
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        log(f"[focr-kernels] row group h={grp.crop_h} ms/page: K4 {k_ms:.5f} (plain {p_ms:.5f})")
    bank = banks[12]
    G = bank.n_glyphs
    ys = dec.groups[0][0].ys
    rng = np.random.default_rng(11)
    noise = rng.integers(0, 256, (6, *pages.shape[1:]), dtype=np.uint8)
    noise[4:] = np.clip(rng.integers(248, 262, (2, *pages.shape[1:])), 0, 255)
    noise_strips = focr_model.crop_strips(noise, ys, 12, dec.x0, dec.crop_w)
    tsq = bank.tsq.astype(np.int64)
    err = max(err, check("seeded noise pages", noise_strips, bank.templates, tsq, bank.wx0)[0])
    corpus_strips = focr_model.crop_strips(pages[:4], ys, 12, dec.x0, dec.crop_w)
    for label, order, forbidden in (
        ("duplicated characters at the end", np.r_[np.arange(G), [3, 17, 40, G - 1]],
         range(G, G + 4)),
        ("a duplicated character in front", np.r_[[10], np.arange(G)], [11]),
    ):
        for strips in (corpus_strips, noise_strips):
            err = max(err, check(label, strips, bank.templates[:, order], tsq[:, order],
                                 bank.wx0, forbidden)[0])
    narrow = rng.integers(0, 256, (4, 6, 12, 20), dtype=np.uint8)
    err = max(err, check("narrow strip, windows hang past crop_w", narrow,
                         bank.templates[:4], tsq[:4], np.array([0, 7, 14, 19], np.int32))[0])
    # a window whose dot may pass 2^31 (n = 34000 >= 33026) takes the int64 instance
    wide_t = rng.integers(0, 256, (2, 33, 1, 34000), dtype=np.uint8)
    wide_t[wide_t < 140] = 0
    err = max(err, check("wide window 1x34000 (n*65025 >= 2^31)",
                         rng.integers(0, 256, (1, 3, 1, 40000), dtype=np.uint8), wide_t,
                         (wide_t.astype(np.int64) ** 2).sum(axis=(2, 3)),
                         np.array([0, 5000], np.int32), want="int64")[0])

    # 7. focr-golden: GridDecoder on the card reproduces focr_tpu's lines
    S.reset_launches()
    got = [[[ln.text, ln.y] for ln in p] for p in dec.decode_batch(pages)]
    n_golden = S.LAUNCHES["ssd_argmin"]
    if got != golden:
        raise AssertionError("focr golden pages: the card's lines differ from focr_tpu's")
    if not n_golden:
        raise AssertionError("focr golden pages did not launch K4")
    # the single-image path (the CLI with one page) streams row chunks
    S.reset_launches()
    streamed = [[ln.text, ln.y] for ln in focr_model.decode_single_stream(dec, pages[0])]
    n_stream = S.LAUNCHES["ssd_argmin"]
    if streamed != golden[0] or not n_stream:
        raise AssertionError(f"focr streamed page: lines differ or K4 not launched ({n_stream})")
    log(f"[focr-golden] {B} pages: {sum(map(len, got))} lines identical to focr_tpu's; "
        f"K4 launches {n_golden}; one page streamed in row chunks: identical, "
        f"K4 launches {n_stream}")

    # 8. focr-cli: the focr command line on the 16 pages, with the saved bank
    want_out = "".join(f"{text}\n" for p in golden for text, _ in p)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k, p in enumerate(pages):
            paths.append(os.path.join(tmp, f"page{k:02d}.pgm"))
            save_gray(paths[-1], p)
        argv = ["-i", *paths, "-f", FONT, "-t", "13", *FOCR_GRID, "--grid-bank", FOCR_FIXTURE]
        buf = io.StringIO()
        S.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = focr_main(argv)
        wall = time.perf_counter() - t0
        launches = S.LAUNCHES["ssd_argmin"]
        if rc != 0 or not launches:
            raise AssertionError(f"in-process focr CLI: rc {rc}, K4 launches {launches}")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "focr_tpu_torch.cli.focr", *argv],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        sub_wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"focr CLI exited {res.returncode}: {res.stderr[-2000:]}")
    if res.stdout != buf.getvalue():
        raise AssertionError("focr CLI subprocess stdout differs from the in-process run")
    if res.stdout != want_out:
        raise AssertionError("focr CLI: the lines differ from focr_tpu's")
    out_lines = res.stdout.splitlines()
    off = 0
    for p, page_lines in enumerate(golden):  # bench.py:90-93's acceptance rule
        have = [ln.rstrip() for ln in out_lines[off : off + len(page_lines)]]
        off += len(page_lines)
        if have[: len(truths[p])] != [t.rstrip() for t in truths[p]]:
            raise AssertionError(f"focr CLI page {p}: the page's text was not decoded")
    log(f"[focr-cli] exit 0; {B} pages, {len(out_lines)} lines (identical to focr_tpu's, every "
        f"page's text decoded); in-process {B / wall:.2f} pages/s ({wall:.3f} s), subprocess "
        f"{B / sub_wall:.2f} pages/s ({sub_wall:.2f} s incl. start-up); K4 launches {launches}; "
        f"card {card}")
    bound_ms, bound_by = bound(ops / B, moved / B)
    entry = {"name": "ssd_argmin", "route": "cuda", "source": "focr_tpu_torch/csrc/focr_ssd.cu",
             "replaces": "focr_tpu/models/focr.py:60", "instance": "mma", "launches": launches,
             "launches_per_page": launches / B, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": None}
    return entry, B / wall, B / sub_wall


def sweep_sass(build) -> dict:
    """Phase 2's look at K1's machine code: the GMMA instructions (IGMMA,
    wgmma on u8) in each instance of the wgmma kernel, from cuobjdump -sass
    of the built library; raises unless every instance has some."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path()], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "focr_ncc_sweep_kernel" in name:  # the wgmma instances (not focr_ncc_sweep_mma_kernel)
            counts[name] = part.count("GMMA")
    if len(counts) != 5 or not all(counts.values()):
        raise AssertionError(f"K1's wgmma instances in the SASS: {counts}")
    log(f"[build] K1's wgmma instances ({len(counts)}): GMMA instructions in each "
        f"{sorted(counts.values())}")
    return counts


def sweep_edge_checks(dev) -> dict:
    """Phase 3's K1 checks beyond the canonical wave, each against the plain
    version bit for bit (tolerance 0) and launching the instance its plan
    names: every needle width 4..16 in both tiers; T of 1, 17, 257 and 600
    (blocks along grid.z); windows whose last word, tile or item is ragged
    and a page narrower than a tile; the straight-line and general
    instances' k-steps (8 and 12 held); and the shapes that take the mma instance (9 and 13 k-steps, a
    150x150 needle). Then the mma instance timed on a shape that takes it: 2
    pages 792x662, 74 needles of 25x16 (the wide tier, 13 k-steps). Returns
    that instance's numbers and the largest error of all the checks."""
    import numpy as np
    import torch

    from focr_tpu_torch.ops import ncc_kernels as K

    def inputs(B, H, W, T, nh, nw, seed, density=0.3):
        rng = np.random.default_rng(seed)
        imgs = ((rng.random((B, H, W)) < density) * rng.integers(0, 256, (B, H, W))
                ).astype(np.uint8)
        needles = rng.integers(0, 256, (T, nh, nw), dtype=np.uint8)
        if T > 1:
            needles[0] = 7  # zero variance: never kept
        for b in range(B):
            for _ in range(5):
                t = rng.integers(T)
                y, x = rng.integers(0, H - nh + 1), rng.integers(0, W - nw + 1)
                imgs[b, y : y + nh, x : x + nw] = needles[t]
        s_n = needles.reshape(T, -1).astype(np.int64).sum(1)
        s2_n = (needles.reshape(T, -1).astype(np.int64) ** 2).sum(1)
        return [torch.from_numpy(a).to(dev) for a in (imgs, needles, s_n, s2_n)]

    def check(label, B, H, W, T, nh, nw, thr, seed, want=None):
        args = inputs(B, H, W, T, nh, nw, seed)
        plan = K.sweep_plan(nh, nw, K.sweep_tier(nh * nw, thr))
        K.reset_launches()
        mask, rcnt = K.ncc_sweep(*args, thr)
        torch.cuda.synchronize()
        launched = dict(K.LAUNCHES)
        mask_r, rcnt_r = K.ncc_sweep_reference(*args, thr)
        e = max(max_abs_err(mask, mask_r), max_abs_err(rcnt, rcnt_r))
        if e or launched[plan.key] != 1 or (want and plan.instance != want):
            raise AssertionError(f"K1 edge case {label}: max|err| {e}, plan {plan}, launches "
                                 f"{launched}")
        return e, plan

    err, seen = 0, set()
    for nw in range(4, 17):
        for thr in (0.3, -0.2):
            e, plan = check(f"nw {nw}, thr {thr}", 2, 60, 150, 70, 7, nw, thr, nw)
            err = max(err, e)
            seen.add((plan.instance, plan.nks))
    for label, case, want in (
        ("T 1", (2, 40, 100, 1, 13, 9, 0.5), "wgmma"),
        ("T 17", (2, 40, 100, 17, 13, 8, 0.5), "wgmma"),
        ("T 257", (1, 40, 100, 257, 13, 9, 0.4), "wgmma"),
        ("T 600", (1, 40, 100, 600, 13, 9, 0.3), "wgmma"),
        ("a page narrower than a tile", (2, 35, 9, 17, 4, 5, 0.2), "wgmma"),
        ("W 97: the last word ragged", (3, 97, 97, 17, 13, 8, 0.3), "wgmma"),
        ("W 627: the crop's width + 1", (2, 60, 627, 74, 13, 8, 0.5), "wgmma"),
        ("Hs 5: the last item of one row", (2, 17, 300, 222, 13, 9, 0.5), "wgmma"),
        ("W 400: a last column chunk of one word", (2, 21, 400, 74, 13, 8, 0.5), "wgmma"),
        ("16x15: 8 k-steps, the narrow general instance", (2, 50, 200, 9, 16, 15, 0.6), "wgmma"),
        ("21x13: the wide straight-line instance", (2, 60, 200, 74, 21, 13, 0.8), "wgmma"),
        ("24x13: 12 k-steps, the wide general instance", (1, 60, 200, 9, 24, 13, 0.1), "wgmma"),
        ("17x15: 9 k-steps, the mma instance", (2, 50, 200, 9, 17, 15, 0.6), "mma"),
        ("25x16: 13 k-steps, the mma instance", (1, 60, 200, 9, 25, 16, 0.2), "mma"),
        ("150x150: the mma instance, A from device memory", (1, 330, 300, 3, 150, 150, 0.7),
         "mma"),
    ):
        e, plan = check(label, *case, seed=len(label), want=want)
        err = max(err, e)
        seen.add((plan.instance, plan.nks))
    log(f"[kernels] K1 edge cases: {len(seen)} (instance, k-steps) kinds, "
        f"all bit-identical to the plain version; max|err| {err}")
    # the mma instance's time, on a shape that takes it
    B = 2
    args = inputs(B, 792, 662, 74, 25, 16, seed=25, density=0.15)
    T, nh, nw = args[1].shape
    thr = 0.8
    plan = K.sweep_plan(nh, nw, K.sweep_tier(nh * nw, thr))
    packed = K.pack_needles(args[1], plan)
    terms = K.sweep_terms(args[2], args[3], nh * nw, thr)
    mask, rcnt = K.ncc_sweep(*args, thr, terms=terms, packed=packed)
    mask_r, rcnt_r = K.ncc_sweep_reference(*args, thr, terms=terms)
    e = max(max_abs_err(mask, mask_r), max_abs_err(rcnt, rcnt_r))
    if e or plan.instance != "mma":
        raise AssertionError(f"K1's mma instance at 74 needles of 25x16: max|err| {e}, {plan}")
    k_bound = bound(2 * (792 - nh + 1) * (662 - nw + 1) * T * nh * nw,
                    nbytes(args[0], args[1], *terms[:2], mask, rcnt) / B)
    out = {"shape": "2 pages 792x662, 74 needles of 25x16 (wide tier, 13 k-steps)",
           "max_abs_err": e,
           "ms": cuda_ms(lambda: K.ncc_sweep(*args, thr, terms=terms, packed=packed), 5) / B,
           "device_ms": device_ms(lambda: K.ncc_sweep(*args, thr, terms=terms, packed=packed), 5,
                                  "focr_ncc_sweep_mma") / B,
           "plain_ms": cuda_ms(lambda: K.ncc_sweep_reference(*args, thr, terms=terms), 1) / B,
           "bound_ms": k_bound[0], "bound_by": k_bound[1], "library_ms": None,
           "edge_max_abs_err": max(err, e)}
    log(f"[kernels] K1's mma instance, {out['shape']}: ms/page {out['ms']:.4f}, device "
        f"{out['device_ms']:.4f} (plain {out['plain_ms']:.4f}, bound {k_bound[0]:.4f} by "
        f"{k_bound[1]})")
    return out


def wide_sweep_checks(dev) -> tuple[int, float, float, float, tuple[float, str]]:
    """Phase 9's K1 wide-instance checks. Returns (max|err| against the plain
    version, kernel ms/page, its device ms/page, plain ms/page, (bound
    ms/page, what bounds it))."""
    import numpy as np
    import torch

    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.ops import ncc_kernels as K
    from focr_tpu_torch.oracle.ncc_direct import direct_search

    def planted(B, H, W, T, seed):
        rng = np.random.default_rng(seed)
        imgs = ((rng.random((B, H, W)) < 0.15) * rng.integers(0, 256, (B, H, W))).astype(np.uint8)
        needles = rng.integers(0, 256, (T, 21, 13), dtype=np.uint8)
        for b in range(B):
            for _ in range(3 * T):
                t, y, x = rng.integers(T), rng.integers(0, H - 21), rng.integers(0, W - 13)
                imgs[b, y : y + 21, x : x + 13] = needles[t]
        return imgs, needles

    def run(imgs, needles, thr):
        T = len(needles)
        s_n = needles.reshape(T, -1).astype(np.int64).sum(1)
        s2_n = (needles.reshape(T, -1).astype(np.int64) ** 2).sum(1)
        dg = ncc_model.group_from_numpy(needles, s_n, s2_n, thr, dev)
        args = (torch.from_numpy(imgs).to(dev), dg.bank, dg.s_n, dg.s2_n, thr)
        mask, rcnt = K.ncc_sweep(*args, terms=dg.terms)
        mask_r, rcnt_r = K.ncc_sweep_reference(*args, terms=dg.terms)
        torch.cuda.synchronize()
        return max(max_abs_err(mask, mask_r), max_abs_err(rcnt, rcnt_r)), args, dg, mask, rcnt

    err = 0
    # the replay check: a small wave, every window searched exactly on the host
    for thr in (0.8, -0.2):
        imgs, needles = planted(2, 120, 200, 8, seed=31)
        e, _, dg, mask, rcnt = run(imgs, needles, thr)
        pos, off, hcnt, _ = (t.cpu().numpy() for t in K.compact_hits(mask, rcnt))
        W1 = mask.shape[-1] * 32
        n_hits = 0
        for b in range(len(imgs)):
            ends = np.cumsum(hcnt[b].astype(np.int64)) + off[b]
            for t in range(len(needles)):
                # the direct search takes the page as printed (not inverted)
                want = {(m.y, m.x) for m in direct_search(255 - imgs[b], needles[t], thr,
                                                          cap=imgs[b].size)}
                cand = pos[ends[t] - hcnt[b, t] : ends[t]].astype(np.int64)
                if not want <= set(zip((cand // W1).tolist(), (cand % W1).tolist())):
                    raise AssertionError(f"K1 wide: candidates miss exact hits (thr {thr}, "
                                         f"page {b})")
                n_hits += len(want)
        log(f"[prop-kernels] K1 wide instance, 21x13 needles, thr {thr}: vs plain max|err| {e}; "
            f"{int(rcnt.sum())} candidates hold all {n_hits} exact hits")
        if e:
            raise AssertionError(f"K1 wide instance mismatch: max|err| {e}")
        err = max(err, e)
    # timing at a -t 20 wave's shape: 74 needles of 21x13 on 792x662 pages
    imgs, needles = planted(2, 792, 662, 74, seed=32)
    e, args, dg, mask, rcnt = run(imgs, needles, 0.8)
    if e:
        raise AssertionError(f"K1 wide instance mismatch on the -t 20 wave: max|err| {e}")
    B, H, W = imgs.shape
    T, nh, nw = needles.shape
    k_bound = bound(2 * (H - nh + 1) * (W - nw + 1) * T * nh * nw,
                    nbytes(*args[:2], *dg.terms[:2], mask, rcnt) / B)
    k_ms = cuda_ms(lambda: K.ncc_sweep(*args, terms=dg.terms, packed=dg.packed), 10) / B
    d_ms = device_ms(lambda: K.ncc_sweep(*args, terms=dg.terms, packed=dg.packed), 10,
                     "focr_ncc_sweep") / B
    p_ms = cuda_ms(lambda: K.ncc_sweep_reference(*args, terms=dg.terms), 1) / B
    log(f"[prop-kernels] K1 wide instance, 2 pages 792x662, 74 needles 21x13: vs plain "
        f"max|err| {e}; ms/page K1 {k_ms:.4f}, device {d_ms:.4f} (plain {p_ms:.4f}, bound "
        f"{k_bound[0]:.4f} by {k_bound[1]})")
    return err, k_ms, d_ms, p_ms, k_bound


def prop_phases(dev, card: str) -> tuple[dict, dict, float, float]:
    """Phases 9-11: the proportional focr slice. Returns (K5's kernels entry,
    K1's wide-instance numbers, in-process CLI pages/s, subprocess CLI
    pages/s)."""
    import numpy as np
    import torch

    from focr_tpu_torch.cli.focr import main as focr_main
    from focr_tpu_torch.fonts.bank import load_grid_bank
    from focr_tpu_torch.io.images import save_gray
    from focr_tpu_torch.models import focr as focr_model
    from focr_tpu_torch.models.types import DecodeOptions, RenderOptions
    from focr_tpu_torch.ops import prop_kernels as P

    banks, settings = load_grid_bank(PROP_FIXTURE)
    with np.load(PROP_FIXTURE, allow_pickle=False) as z:
        pages = z["pages"]
        golden = json.loads(str(z["lines"]))
    alphabet = settings["alphabet"]
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    dec = focr_model.GridDecoder(None, alphabet, dopts, RenderOptions(size=13.0),
                                 pages.shape[1:], dev, banks=banks)
    B = len(pages)
    if not dec.prop_groups:
        raise AssertionError("prop: the decoder did not take its device path")

    # 9. prop-kernels: K5 against its plain version
    def check(label, strips, pd):
        f = pd.fwd
        args = (torch.as_tensor(np.ascontiguousarray(strips)).to(dev), f.templates,
                f.colsq_cum, f.advances, f.base, f.ox, f.n_steps)
        ids = P.prop_scan(*args)
        ids_r = P.prop_scan_reference(*args)
        torch.cuda.synchronize()
        e = max_abs_err(ids, ids_r)
        steps = int((ids != P.END_ID).sum(dim=1).max())
        log(f"[prop-kernels] {label}: strips {tuple(strips.shape)}, K5 vs plain max|err| {e}, "
            f"longest line {steps} of {f.n_steps} steps")
        if e:
            raise AssertionError(f"K5 mismatch on {label}: max|err| {e}")
        return e, args, ids

    inv = np.subtract(255, pages, dtype=np.uint8)
    err, ms, plain_ms, ops, moved = 0, 0.0, 0.0, 0, 0
    for grp, pd in dec.prop_groups:
        strips = np.stack([inv[:, y : y + grp.crop_h, dec.x0 : dec.x0 + dec.crop_w]
                           for y in grp.ys], axis=1).reshape(-1, grp.crop_h, dec.crop_w)
        e, args, ids = check(f"prop wave, row group h={grp.crop_h} ({len(grp.ys)} rows)",
                             strips, pd)
        err = max(err, e)
        # the steps these lines take, each G glyphs x h x wbank multiply-adds
        G, _, h, wbank = args[1].shape
        ops += 2 * int((ids != P.END_ID).sum()) * G * h * wbank
        moved += nbytes(*args[:4], ids)
        k_ms = cuda_ms(lambda: P.prop_scan(*args, words=pd.fwd.words), 10) / B
        p_ms = cuda_ms(lambda: P.prop_scan_reference(*args), 2) / B
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        log(f"[prop-kernels] row group h={grp.crop_h} ms/page: K5 {k_ms:.5f} (plain {p_ms:.5f})")
    pd12 = dec.prop_groups[0][1]
    rng = np.random.default_rng(17)
    err = max(err, check("seeded noise strips", rng.integers(0, 256, (48, 12, 608),
                                                             dtype=np.uint8), pd12)[0])
    narrow = focr_model.GridDecoder(None, alphabet, DecodeOptions(
        x_start=0, y_start=0, line_height=12, line_advance=15, width=20), RenderOptions(size=13.0),
        (12, 20), dev, banks=banks).prop_groups[0][1]
    err = max(err, check("narrow strip, windows hang past its edge",
                         rng.integers(0, 256, (6, 12, 20), dtype=np.uint8), narrow)[0])
    wide_err, wide_ms, wide_dev_ms, wide_plain_ms, wide_bound = wide_sweep_checks(dev)

    # 10. prop-golden: GridDecoder on the card reproduces focr_tpu's lines
    P.reset_launches()
    got = [[[ln.text, ln.y] for ln in p] for p in dec.decode_batch(pages)]
    n_golden = P.LAUNCHES["prop_scan"]
    if got != golden or not n_golden:
        raise AssertionError(f"prop golden pages: lines differ or K5 not launched ({n_golden})")
    P.reset_launches()
    single = [[ln.text, ln.y] for ln in focr_model.decode_single_stream(dec, pages[5])]
    if single != golden[5] or not P.LAUNCHES["prop_scan"]:
        raise AssertionError("prop single page: lines differ or K5 not launched")
    log(f"[prop-golden] {B} pages: {sum(map(len, got))} lines identical to focr_tpu's; "
        f"K5 launches {n_golden}; one page through the single-image path: identical")

    # 11. prop-cli: the focr CLI on the 16 pages, with the saved prop bank
    want_out = "".join(f"{text}\n" for p in golden for text, _ in p)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k, p in enumerate(pages):
            paths.append(os.path.join(tmp, f"page{k:02d}.pgm"))
            save_gray(paths[-1], p)
        argv = ["-i", *paths, "-f", SANS_FONT, "-t", "13", "-a", alphabet, *FOCR_GRID,
                "--grid-bank", PROP_FIXTURE]
        buf = io.StringIO()
        P.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = focr_main(argv)
        wall = time.perf_counter() - t0
        launches = P.LAUNCHES["prop_scan"]
        if rc != 0 or not launches:
            raise AssertionError(f"in-process prop CLI: rc {rc}, K5 launches {launches}")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "focr_tpu_torch.cli.focr", *argv],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        sub_wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"prop CLI exited {res.returncode}: {res.stderr[-2000:]}")
    if res.stdout != buf.getvalue():
        raise AssertionError("prop CLI subprocess stdout differs from the in-process run")
    if res.stdout != want_out:
        raise AssertionError("prop CLI: the lines differ from focr_tpu's")
    log(f"[prop-cli] exit 0; {B} pages, {len(res.stdout.splitlines())} lines (identical to "
        f"focr_tpu's); in-process {B / wall:.2f} pages/s ({wall:.3f} s), subprocess "
        f"{B / sub_wall:.2f} pages/s ({sub_wall:.2f} s incl. start-up); K5 launches {launches}; "
        f"card {card}")
    bound_ms, bound_by = bound(ops / B, moved / B)
    entry = {"name": "prop_scan", "route": "cuda", "source": "focr_tpu_torch/csrc/focr_prop.cu",
             "replaces": "focr_tpu/models/focr_prop.py:49", "launches": launches,
             "launches_per_page": launches / B, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": None}
    wide = {"wide_max_abs_err": wide_err, "wide_ms": wide_ms, "wide_device_ms": wide_dev_ms,
            "wide_plain_ms": wide_plain_ms,
            "wide_bound_ms": wide_bound[0], "wide_bound_by": wide_bound[1],
            "wide_library_ms": None}
    return entry, wide, B / wall, B / sub_wall


def _png(samples, ctype: int, depth: int, filters, interlace: bool = False) -> bytes:
    """A PNG of samples [H, W, ch] (8 or 16 bits), row r of each pass with
    filter filters[r % len(filters)]: the encoder side of PNG §9, for reading
    back through the port's decoder."""
    import struct
    import zlib

    import numpy as np

    def chunk(kind, body):
        return len(body).to_bytes(4, "big") + kind + body + zlib.crc32(kind + body).to_bytes(4, "big")

    H, W, ch = samples.shape
    bpp = ch * depth // 8
    stream = b""
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
              (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),)
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        rows = sub.astype(">u2" if depth == 16 else np.uint8).reshape(len(sub), -1)
        rows = rows.view(np.uint8).astype(np.int64)
        prev = np.zeros(rows.shape[1], np.int64)
        for r, x in enumerate(rows):
            ft = filters[r % len(filters)]
            a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
            c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            p = a + prev - c
            paeth = np.where((abs(p - a) <= abs(p - prev)) & (abs(p - a) <= abs(p - c)), a,
                             np.where(abs(p - prev) <= abs(p - c), prev, c))
            pred = (0 * x, a, prev, (a + prev) >> 1, paeth)[ft]
            stream += bytes([ft]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes()
            prev = x
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, int(interlace)))
            + chunk(b"IDAT", zlib.compress(stream)) + chunk(b"IEND", b""))


def page_formats_phase(page) -> dict:
    """Phase 12's page reader check: one corpus page written in every format
    the port reads itself, read back with Pillow blocked from import (the
    card's machine has none): each decode must equal the PGM of the same
    page (a 1-bit format: of the page thresholded at 128). Returns the read
    times of one PGM and one PNG page (median ms)."""
    import numpy as np

    from focr_tpu_torch.io import images

    H, W = page.shape
    ink = np.where(page < 128, 0, 255).astype(np.uint8)
    v = page.astype(np.int64)
    bits = (ink == 0).astype(np.uint8)
    rgb = np.repeat(page[..., None], 3, axis=2)
    files = {  # name: (bytes, the page its decode must equal)
        "P1.pbm": (b"P1\n%d %d\n" % (W, H) + "\n".join(
            "".join(map(str, r)) for r in bits).encode(), ink),
        "P2.pgm": (b"P2\n# plain\n%d %d\n255\n" % (W, H) + "\n".join(
            " ".join(map(str, r)) for r in page).encode(), page),
        "P3.ppm": (b"P3\n%d %d\n255\n" % (W, H) + " ".join(map(str, rgb.reshape(-1))).encode(),
                   page),
        "P4.pbm": (b"P4\n%d %d\n" % (W, H) + np.packbits(bits, axis=1).tobytes(), ink),
        "P5-16bit.pgm": (b"P5\n%d %d\n65535\n" % (W, H) + (v * 257).astype(">u2").tobytes(),
                         page),
        "P6.ppm": (b"P6\n%d %d\n255\n" % (W, H) + rgb.tobytes(), page),
        "gray8-filters.png": (_png(page[..., None], 0, 8, (0, 1, 2, 3, 4)), page),
        "rgb16-adam7.png": (_png(rgb.astype(np.int64) * 257, 2, 16, (4, 3, 1, 2), True), page),
    }
    timings = {}
    with tempfile.TemporaryDirectory() as tmp:
        images.save_gray(os.path.join(tmp, "page.pgm"), page)
        images.save_gray(os.path.join(tmp, "saved.png"), page)
        files["saved.png"] = (open(os.path.join(tmp, "saved.png"), "rb").read(), page)
        saved = sys.modules.get("PIL", 0)
        sys.modules["PIL"] = None  # Pillow absent, as on the card's machine
        try:
            base = images.load_gray(os.path.join(tmp, "page.pgm"))
            if not np.array_equal(base, page):
                raise AssertionError("page reader: the PGM does not read back")
            for name, (data, want) in files.items():
                path = os.path.join(tmp, name)
                with open(path, "wb") as f:
                    f.write(data)
                if not np.array_equal(images.load_gray(path), want):
                    raise AssertionError(f"page reader: {name} differs from the PGM of the page")
            for name in ("page.pgm", "gray8-filters.png", "saved.png"):
                path = os.path.join(tmp, name)
                ts = []
                for _ in range(15):
                    t0 = time.perf_counter()
                    images.load_gray(path)
                    ts.append(time.perf_counter() - t0)
                timings[name] = sorted(ts)[len(ts) // 2] * 1e3
        finally:
            if saved == 0:
                del sys.modules["PIL"]
            else:
                sys.modules["PIL"] = saved
    log(f"[host-native] page reader without Pillow: {', '.join(files)} of one {W}x{H} page "
        f"equal its PGM; read ms (median of 15): PGM {timings['page.pgm']:.3f}, PNG with all "
        f"five filters {timings['gray8-filters.png']:.3f}, PNG as save_gray writes it "
        f"{timings['saved.png']:.3f}")
    return {"read_ms_pgm": timings["page.pgm"], "read_ms_png_filtered":
            timings["gray8-filters.png"], "read_ms_png_unfiltered": timings["saved.png"]}


def canonical_wave(matcher, pages) -> list[tuple]:
    """Phase 3's wave (the first WAVE pages) as the matcher's dispatch stage
    hands it to K3, made with K1 and K2 on the card: per swept size group
    (group, device group, inverted pages [B, H, W] on the host, crop, the
    cropped pages on the card, K2's positions, offsets and counts there)."""
    import numpy as np
    import torch

    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.ops import ncc_kernels as K

    inv = (255 - np.asarray(pages[: ncc_model.WAVE]).astype(np.int16)).astype(np.uint8)
    y0, x0, Hc, Wc = crop = ncc_model._ink_crop(inv, *inv.shape[1:], matcher.groups)
    inv_dev = torch.from_numpy(np.ascontiguousarray(inv[:, y0 : y0 + Hc, x0 : x0 + Wc])).to(
        matcher.device)
    out = []
    for grp, dg in zip(matcher.groups, matcher.dev_groups):
        mask, rcnt = K.ncc_sweep(inv_dev, dg.bank, dg.s_n, dg.s2_n, matcher.threshold,
                                 terms=dg.terms, packed=dg.packed)
        pos, off, hcnt, _ = K.compact_hits(mask, rcnt)
        out.append((grp, dg, inv, crop, inv_dev, pos, off, hcnt))
    return out


def host_replay_inputs(grp, inv, crop, pos, off, hcnt, thr: float, max_matches: int) -> list:
    """The host replay's arguments (models/ncc.py::replay_inputs) for each
    page of one canonical_wave group, with ``max_matches``."""
    from focr_tpu_torch.models import ncc as ncc_model

    pos, off, hcnt = pos.cpu().numpy(), off.cpu().numpy(), hcnt.cpu().numpy()
    return [(*ncc_model.replay_inputs(grp, (pos[off[b] : off[b + 1]], hcnt[b]), inv[b], crop,
                                      thr)[:-1], max_matches) for b in range(len(inv))]


def host_native_phase(matcher, pages, golden, host_build: dict) -> dict:
    """Phase 12: the ncc host library (csrc/ncc_host.cpp, built in phase 2)
    on the card's host. Returns its numbers for the JSON line."""
    import numpy as np

    from focr_tpu_torch.cli.ncc import main as ncc_main
    from focr_tpu_torch.io.images import save_gray
    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.models import post as post_model
    from focr_tpu_torch.models.types import MAX_MATCHES
    from focr_tpu_torch.native import ncc_cpu

    def median_s(fn, reps: int) -> float:
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    def valid(out, starts):
        """Each needle's hits: (x, y, f32 sim bits) at its offset, counts, warn."""
        x, y, sim, counts, warn = out
        idx = np.concatenate([np.arange(s, s + k) for s, k in zip(starts, counts)] or
                             [np.zeros(0, np.int64)]).astype(np.int64)
        return x[idx], y[idx], sim[idx].view(np.uint32), counts, warn

    log(f"[host-native] host library: {host_build['compiler']}, built and loaded in "
        f"{host_build['host_build_s']:.1f} s; OpenMP threads {host_build['omp_threads']}")
    # the host replay (K3's yardstick) on phase 3's wave: native against the
    # NumPy plain version
    thr = float(np.float32(matcher.threshold))
    groups = [args for grp, _, inv, crop, _, pos, off, hcnt in canonical_wave(matcher, pages)
              for args in host_replay_inputs(grp, inv, crop, pos, off, hcnt, thr,
                                             MAX_MATCHES)]
    wave = matcher._sweep_wave(list(pages[: ncc_model.WAVE]))
    B = len(wave)
    n_cand = n_hits = 0
    for args in groups:
        a = valid(ncc_cpu.replay_group(*args), args[2])
        b = valid(ncc_model.replay_group_reference(*args), args[2])
        if not all(np.array_equal(u, v) for u, v in zip(a, b)):
            raise AssertionError("native replay differs from the NumPy plain replay")
        n_cand += len(args[1])
        n_hits += int(a[3].sum())
    replay_ms = median_s(lambda: [ncc_cpu.replay_group(*g) for g in groups], 7) * 1e3 / B
    replay_plain_ms = median_s(
        lambda: [ncc_model.replay_group_reference(*g) for g in groups], 3) * 1e3 / B
    log(f"[host-native] host replay (off the main path: K3's yardstick) on the {B}-page wave: "
        f"{n_cand} candidates, {n_hits} hits, native identical to plain (coordinates, f32 sim "
        f"bits, counts, warn); ms/page native {replay_ms:.3f} (plain {replay_plain_ms:.3f})")

    # post-processing: one host-library call a page against the NumPy plain version
    structs = [matcher._collect_page(d, False, False, None, True) for d in wave]
    for hs in structs:
        a = post_model._winner_arrays(hs, 0.95, 5)
        b = post_model.winner_arrays_reference(hs, 0.95, 5)
        if not all(np.array_equal(u, v) for u, v in zip(a, b)):
            raise AssertionError("native post-processing differs from the NumPy one")
    post_ms = median_s(lambda: [post_model._winner_arrays(h, 0.95, 5) for h in structs],
                       7) * 1e3 / B
    post_plain_ms = median_s(
        lambda: [post_model.winner_arrays_reference(h, 0.95, 5) for h in structs], 3) * 1e3 / B
    text_ms = median_s(lambda: [post_model.process_hits_text(h, 0.95, 5) for h in structs],
                       7) * 1e3 / B
    log(f"[host-native] post-processing, {sum(map(len, structs)) // B} hits/page: the same "
        f"winners; ms/page post_page native {post_ms:.3f} (plain {post_plain_ms:.3f}), "
        f"process_hits_text {text_ms:.3f}")

    # the collect pool (get_hits_many) against serial collection, in turns
    post = lambda hs: post_model.process_hits_text(hs, 0.95, 5)  # noqa: E731
    plist = list(pages)

    def serial():
        out = []
        for s in range(0, len(plist), ncc_model.WAVE):
            for d in matcher._sweep_wave(plist[s : s + ncc_model.WAVE]):
                out.append(post(matcher._collect_page(d, False, False, None, True)))
        return out

    want = serial()
    times = {"pool": [], "serial": []}
    for name in ("pool", "serial", "serial", "pool", "pool", "serial"):
        t0 = time.perf_counter()
        got = (matcher.get_hits_many(plist, struct=True, post=post) if name == "pool"
               else serial())
        times[name].append(time.perf_counter() - t0)
        if got != want:
            raise AssertionError(f"{name} collection changed the lines")
    pool_s, serial_s = min(times["pool"]), min(times["serial"])
    log(f"[host-native] {len(plist)} pages, matcher + post: {ncc_model.COLLECT_THREADS}-thread "
        f"collect pool "
        f"{[round(t, 4) for t in times['pool']]} s, serial {[round(t, 4) for t in times['serial']]}"
        f" s (best {len(plist) / pool_s:.1f} against {len(plist) / serial_s:.1f} pages/s)")

    # --engine native on the two golden pages
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k, p in enumerate(pages[: len(golden)]):
            paths.append(os.path.join(tmp, f"page{k:02d}.pgm"))
            save_gray(paths[-1], p)
        argv = ["-i", *paths, "-f", FONT, "-t", "13", "--x-bits", "2", "--needle-bank", FIXTURE,
                "--engine", "native"]
        buf = io.StringIO()
        ncc_cpu.reset_native_calls()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = ncc_main(argv)
        native_s = (time.perf_counter() - t0) / len(golden)
    calls = ncc_cpu.NATIVE_CALLS["search_many"]
    if rc != 0 or buf.getvalue().splitlines() != [ln for page in golden for ln in page]:
        raise AssertionError(f"--engine native: rc {rc}, lines differ from focr_tpu's")
    if not calls:
        raise AssertionError("--engine native did not call the host search")
    log(f"[host-native] --engine native on the {len(golden)} golden pages: lines identical to "
        f"focr_tpu's; {native_s:.3f} s/page, {calls} search_many calls")
    reads = page_formats_phase(pages[0])
    return {"replay_ms_per_page": replay_ms, "replay_plain_ms_per_page": replay_plain_ms,
            "post_ms_per_page": post_ms, "post_plain_ms_per_page": post_plain_ms,
            "post_text_ms_per_page": text_ms, "collect_pool_s": times["pool"],
            "collect_serial_s": times["serial"], "engine_native_s_per_page": native_s,
            "candidates_per_page": n_cand / B, **reads}


def _write_pages(tmp: str, pages) -> list[str]:
    from focr_tpu_torch.io.images import save_gray

    paths = []
    for k, p in enumerate(pages):
        paths.append(os.path.join(tmp, f"page{k:02d}.pgm"))
        save_gray(paths[-1], p)
    return paths


def _run_cli(main, argv) -> tuple[str, str]:
    """(stdout, stderr) of one in-process CLI run, which must exit 0."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def pipeline_phase(matcher, pages, want16: str, card: str) -> dict:
    """Phase 13: the ncc pipeline on 64 pages. ``want16``: the CLI's stdout on
    the 16 pages (phase 5 held it to the fixture)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from focr_tpu_torch.cli.ncc import main as ncc_main
    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.ops import ncc_kernels as K
    from focr_tpu_torch.ops import replay_kernels as R

    reps = 4
    n = reps * len(pages)
    n_waves = -(-n // ncc_model.WAVE)
    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_pages(tmp, pages)
        argv = ["-i", *(paths * reps), "-f", FONT, "-t", "13", "--x-bits", "2",
                "--needle-bank", FIXTURE]
        # the counted run
        K.reset_launches()
        R.reset_launches()
        ncc_model.reset_host_waits()
        out, _ = _run_cli(ncc_main, argv)
        launches, waits = {**K.LAUNCHES, **R.LAUNCHES}, ncc_model.HOST_WAITS
        if out != want16 * reps:
            raise AssertionError("pipeline: the 64 pages' stdout is not the 16 pages' four times")
        groups = len(matcher.groups)
        if waits != (groups + 1) * n_waves or launches != {
                "ncc_sweep": groups * n_waves, "ncc_sweep_mma": 0,
                "compact_count": groups * n_waves,
                "compact_hits": groups * n_waves, "ncc_replay": groups * n_waves}:
            raise AssertionError(f"pipeline: {n_waves} waves waited {waits} times and launched "
                                 f"{launches}")
        # the traced run between K1 launches on the caller's stream, as
        # markers: two before it, two after. Late in this process
        # torch.profiler leaves some of the caller's kernels out of a trace (a
        # lone marker, trace after trace; one of two markers, a second from
        # either end; a fresh process keeps every one, `python
        # tools/torch_cli_profile.py trace-marker`), so one kept marker
        # suffices. A fill on the caller's stream at each end, and each kept
        # kernel's start less its launch call's, are logged. The pipeline's
        # stream is the one that holds all of its K1 launches; the caller's,
        # the one that holds only markers. A trace without both is taken
        # again (up to 3 times)
        dg = matcher.dev_groups[0]
        strip = torch.from_numpy(255 - np.ascontiguousarray(pages[:1, :64])).to(matcher.device)
        pad = torch.empty(1 << 10, dtype=torch.int32, device=matcher.device)
        trace_path = os.path.join(tmp, "trace.json")
        n_piped = groups * n_waves
        held = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pad.fill_(1)
                torch.cuda.synchronize()
                time.sleep(1.0)
                for k in range(4):
                    if k == 2:
                        out, _ = _run_cli(ncc_main, argv)
                    K.ncc_sweep(strip, dg.bank, dg.s_n, dg.s2_n, THRESHOLD, terms=dg.terms,
                                packed=dg.packed)
                    torch.cuda.synchronize()
                time.sleep(1.0)
                pad.fill_(2)
                torch.cuda.synchronize()
            if out != want16 * reps:
                raise AssertionError("pipeline: the traced run's stdout differs")
            prof.export_chrome_trace(trace_path)
            with open(trace_path) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            k1 = sorted((e for e in kernels if "focr_ncc_sweep_kernel" in e.get("name", "")),
                        key=lambda e: e["ts"])
            spans = [e for e in events if e.get("name") == "focr_ncc_collect_wave"
                     and e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op")]
            if any(e["cat"] == "user_annotation" for e in spans):
                spans = [e for e in spans if e["cat"] == "user_annotation"]
            spans.sort(key=lambda e: e["ts"])
            by_stream, fills = {}, {}  # K1 and fill kernels by stream
            for e in k1:
                by_stream[e["args"].get("stream")] = by_stream.get(e["args"].get("stream"), 0) + 1
            for e in kernels:
                if "FillFunctor" in e.get("name", ""):
                    fills[e["args"].get("stream")] = fills.get(e["args"].get("stream"), 0) + 1
            launch_ts = {e["args"].get("correlation"): e["ts"] for e in events
                         if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")}
            lag = [(e["ts"] - launch_ts[e["args"].get("correlation")]) / 1e3 for e in kernels
                   if e["args"].get("correlation") in launch_ts]
            side = [st for st, c in by_stream.items() if c == n_piped]
            callers = [st for st in by_stream if st not in side]
            first = min((e["ts"] for e in k1 if e["args"].get("stream") in side), default=0)
            held.append({"k1": by_stream, "fills": fills, "markers_before_after": [
                sum(1 for e in k1 if e["args"].get("stream") in callers and e["ts"] < first),
                sum(1 for e in k1 if e["args"].get("stream") in callers and e["ts"] > first)],
                "start_less_launch_ms": [round(min(lag), 3), round(max(lag), 3)]
                if lag else None})
            if len(side) == 1 and callers and len(spans) >= n_waves:
                break
        log(f"[pipeline] {len(held)} trace(s) taken; K1 and fill kernels by stream in each "
            f"{held}, of the {n_piped} K1 the pipeline launched and 4 markers")
        if len(side) != 1 or len(callers) != 1 or by_stream[callers[0]] > 4 \
                or len(spans) != n_waves:
            raise AssertionError(f"pipeline trace: K1 launches by stream {by_stream} (the "
                                 f"pipeline launched {n_piped}, 4 markers on the caller's "
                                 f"stream) and {len(spans)} collect spans for {n_waves} waves")
        piped = [e for e in k1 if e["args"].get("stream") == side[0]]
        marker = callers[0]
        leads = []  # how long before wave k's collection ended wave k+1's first K1 started
        for k in range(n_waves - 1):
            start = piped[groups * (k + 1)]["ts"]
            end = spans[k]["ts"] + spans[k]["dur"]
            if not start < end:
                raise AssertionError(f"pipeline trace: wave {k + 1}'s sweep started {start - end} "
                                     f"us after wave {k}'s collection ended: no overlap")
            leads.append((end - start) / 1e3)
        log(f"[pipeline] {n} pages, {n_waves} waves: stdout = the 16 pages' x{reps}; host waits "
            f"{waits} ({waits / n_waves:g} a wave); launches {launches}; trace: K1 on stream "
            f"{side[0]} (the caller's is {marker}), wave k+1's first K1 starts "
            f"{min(leads):.2f}-{max(leads):.2f} ms before wave k's collection ends, for every k")
        # pages/s at the pipeline's depth against depth 0 (the stages in series)
        depth = ncc_model.PIPELINE_DEPTH
        rates = {depth: [], 0: []}
        try:
            for d in (depth, 0, 0, depth):
                ncc_model.PIPELINE_DEPTH = d
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    if _run_cli(ncc_main, argv)[0] != want16 * reps:
                        raise AssertionError(f"pipeline: depth {d} changed the stdout")
                    ts.append(time.perf_counter() - t0)
                rates[d].append(n / sorted(ts)[1])
        finally:
            ncc_model.PIPELINE_DEPTH = depth
    log(f"[pipeline] {n} pages, pages/s (median of 3 runs a call; calls in turns): depth {depth} "
        f"{[round(r, 1) for r in rates[depth]]}, depth 0 {[round(r, 1) for r in rates[0]]}; "
        f"collect threads {ncc_model.COLLECT_THREADS}; card {card}")
    return {"pages": n, "waves": n_waves, "host_waits": waits, "launches": launches,
            "depth": depth, "pages_per_s": rates[depth], "pages_per_s_depth0": rates[0],
            "sweep_lead_ms_min": min(leads), "collect_threads": ncc_model.COLLECT_THREADS}


@contextlib.contextmanager
def recorded_bank_sets():
    """The focr bank sets that load_grid_bank opens inside the block (the CLI
    opens its own)."""
    from focr_tpu_torch.fonts import bank

    made, orig = [], bank.load_grid_bank

    def recording(path):
        out = orig(path)
        made.append(out[0])
        return out

    bank.load_grid_bank = recording
    try:
        yield made
    finally:
        bank.load_grid_bank = orig


def focr_cli_cases(tmp: str) -> dict:
    """name -> (argv of the focr CLI on the corpus' 16 pages, focr_tpu's
    stdout) for the focr and prop corpora, pages written under ``tmp``."""
    import numpy as np

    from focr_tpu_torch.fonts.bank import load_grid_bank

    cases = {}
    for name, fixture, font in (("focr", FOCR_FIXTURE, FONT), ("prop", PROP_FIXTURE, SANS_FONT)):
        with np.load(fixture, allow_pickle=False) as z:
            pages, golden = z["pages"], json.loads(str(z["lines"]))
        os.makedirs(os.path.join(tmp, name))
        paths = _write_pages(os.path.join(tmp, name), pages)
        alphabet = load_grid_bank(fixture)[1]["alphabet"]
        cases[name] = (["-i", *paths, "-f", font, "-t", "13", "-a", alphabet, *FOCR_GRID,
                        "--grid-bank", fixture],
                       "".join(f"{text}\n" for p in golden for text, _ in p))
    return cases


def banks_phase(cases: dict) -> dict:
    """Phase 14: the lazy bank load."""
    from focr_tpu_torch.cli.focr import main as focr_main
    from focr_tpu_torch.fonts.bank import load_grid_bank

    def load_ms(path, heights) -> float:
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            banks, _ = load_grid_bank(path)
            for h in heights or sorted(banks):
                banks[h]
            ts.append((time.perf_counter() - t0) * 1e3)
            banks.close()
        return sorted(ts)[1]

    result = {}
    for name, (argv, want) in cases.items():
        with recorded_bank_sets() as made:
            out, _ = _run_cli(focr_main, argv)
        if out != want:
            raise AssertionError(f"banks: the {name} CLI's lines differ from focr_tpu's")
        if len(made) != 1 or sorted(made[0].loads) != [3, 12] or len(made[0]) != 12:
            raise AssertionError(f"banks: the {name} CLI loaded crop heights "
                                 f"{[m.loads for m in made]} of {len(made[0])}, not 12 and 3")
        path = argv[argv.index("--grid-bank") + 1]
        eager, lazy = load_ms(path, None), load_ms(path, (12, 3))
        log(f"[banks] {name}: the CLI loaded crop heights {made[0].loads} of 12; bank load "
            f"ms (median of 3): every height {eager:.1f}, heights 12 and 3 {lazy:.1f}")
        result[name] = {"loads": made[0].loads, "load_all_ms": eager, "load_used_ms": lazy}
    return result


def metrics_phase(cases: dict, pages, golden, want16: str) -> None:
    """Phase 15: --metrics-json, --profile, --verbose-sync and the flags kept
    for command-line compatibility."""
    import re

    from focr_tpu_torch.cli.focr import main as focr_main
    from focr_tpu_torch.cli.ncc import main as ncc_main
    from focr_tpu_torch.utils.metrics import TRACE_NAME

    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_pages(tmp, pages)
        ncc_argv = ["-i", *paths, "-f", FONT, "-t", "13", "--x-bits", "2", "--needle-bank",
                    FIXTURE]
        runs = (
            ("focr", focr_main, *cases["focr"],
             {"tool", "pages", "decoded_pages", "lines", "errors", "decode_seconds",
              "pages_per_sec", "counters"}),
            ("ncc", ncc_main, ncc_argv, want16,
             {"tool", "pages", "decoded_pages", "lines", "hits", "errors", "search_seconds",
              "engine", "counters"}),
        )
        for name, main, argv, want, keys in runs:
            mpath, pdir = os.path.join(tmp, f"{name}.json"), os.path.join(tmp, f"{name}-trace")
            out, _ = _run_cli(main, [*argv, "--metrics-json", mpath, "--profile", pdir])
            if out != want:
                raise AssertionError(f"metrics: --metrics-json/--profile changed {name}'s stdout")
            with open(mpath) as f:
                m = json.load(f)
            if set(m) != keys or m["decoded_pages"] != len(pages) or m["tool"] != name:
                raise AssertionError(f"metrics: {name} wrote {m}")
            if name == "ncc" and m["counters"]["ncc_post_native"] != len(pages):
                raise AssertionError(f"metrics: ncc posted {m['counters']} natively, "
                                     f"not each of {len(pages)} pages")
            trace = os.path.join(pdir, TRACE_NAME)
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            named = sorted({k for e in events if e.get("cat") == "kernel"
                            for k in re.findall(r"focr_\w+", e.get("name", ""))})
            if not named:
                raise AssertionError(f"metrics: {name}'s trace names no focr_ kernel")
            spans = sorted({e["name"] for e in events if e.get("cat") == "user_annotation"
                            and str(e.get("name")).startswith("focr_")})
            log(f"[metrics] {name}: stdout unchanged; metrics {m}; trace "
                f"{os.path.getsize(trace)} bytes, kernels {named}, spans {spans}")
        out, err = _run_cli(ncc_main, ["-i", paths[0], *ncc_argv[1 + len(paths):],
                                       "--verbose-sync"])
        group_lines = [ln for ln in err.splitlines() if " group " in ln and ln.startswith("[")]
        if out.splitlines() != golden[0] or len(group_lines) != 2 or not all(
                "measured wall time, split evenly" in ln for ln in group_lines):
            raise AssertionError(f"metrics: --verbose-sync printed {group_lines}")
        log(f"[metrics] --verbose-sync on one golden page: its lines on stdout; {group_lines}")
        out, _ = _run_cli(ncc_main, [*ncc_argv, "--device-kernel", "pallas", "--wire", "pos",
                                     "--mesh", "auto"])
        if out != want16:
            raise AssertionError("metrics: --device-kernel/--wire/--mesh changed the stdout")
        log("[metrics] --device-kernel pallas --wire pos --mesh auto: accepted, stdout unchanged")


def overlays_phase(cases: dict) -> str | None:
    """Phase 16: focr --verify and --test render with FreeType. Returns what
    to print when this machine has none."""
    import re

    from focr_tpu_torch.cli.focr import main as focr_main
    from focr_tpu_torch.fonts.ft import Face

    argv, _ = cases["focr"]
    n = argv.index("-f") - 1  # the pages
    two = ["-i", *argv[1:3], *argv[1 + n:]]
    with tempfile.TemporaryDirectory() as tmp:
        try:
            Face(FONT)
        except OSError as e:
            try:
                focr_main([*two, "--verify", tmp])
            except OSError as e2:
                if str(e2) != str(e):
                    raise
                log(f"[overlays] no FreeType here: --verify with --grid-bank raises Face's "
                    f"error ({e2})")
                return "no FreeType on this machine"
            raise AssertionError("overlays: --verify ran without FreeType")
        out, err = _run_cli(focr_main, [*two, "--verify", tmp])
        lines = err.splitlines()
        stems = [os.path.splitext(os.path.basename(p))[0] + ".png" for p in two[1:3]]
        if sorted(os.listdir(tmp)) != sorted(stems) or len(lines) != 2 or not all(
                re.fullmatch(re.escape(p) + r" \d+\.\d{6}", ln) for p, ln in zip(two[1:3], lines)):
            raise AssertionError(f"overlays: --verify wrote {os.listdir(tmp)} and {lines}")
        _run_cli(focr_main, ["-i", two[1], *two[3:], "--test", os.path.join(tmp, "t")])
        if not all(os.path.getsize(os.path.join(tmp, f"t-{k}.png")) for k in ("rect", "text")):
            raise AssertionError("overlays: --test did not write its two PNGs")
        log(f"[overlays] --verify: {lines}; --test: t-rect.png, t-text.png")
    return None


def host_us(fn, reps: int = 200) -> float:
    """A wrapper's host µs a call: ``reps`` calls with one sync at the end,
    timed on the host clock up to the last call's return."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def mesh_kernels_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 17: K4p and K6 against their plain versions. Returns their
    kernels entries (launches filled in by phase 18)."""
    import numpy as np
    import torch

    from focr_tpu_torch.fonts.bank import load_grid_bank
    from focr_tpu_torch.models import focr as focr_model
    from focr_tpu_torch.models.types import DecodeOptions, RenderOptions
    from focr_tpu_torch.ops import ssd_kernels as S
    from focr_tpu_torch.parallel.decode import shard_grid_bank

    banks, settings = load_grid_bank(FOCR_FIXTURE)
    with np.load(FOCR_FIXTURE, allow_pickle=False) as z:
        pages = z["pages"]
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    dec = focr_model.GridDecoder(None, settings["alphabet"], dopts, RenderOptions(size=13.0),
                                 pages.shape[1:], dev, banks=banks)
    rng = np.random.default_rng(23)
    noise = rng.integers(0, 256, (4, *pages.shape[1:]), dtype=np.uint8)
    noise[2:] = 255  # white pages: every glyph's metric is its tsq, the emptiest glyph wins
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    def shard_banks(slices, wx0_d, crop_w):
        """Every slice's ShardBank, as the mesh path builds them: its first
        glyph's bank number, its templates packed once."""
        Gl = slices[0][0].shape[1]
        return [S.shard_bank(up(t), up(q.astype(np.int64)), wx0_d, crop_w, g * Gl)
                for g, (t, q) in enumerate(slices)]

    def row_of_calls(strips_d, shards):
        """One glyph row's K4p calls, white flags from the first shard only."""
        return [S.ssd_argmin_partial(strips_d, sb, white=g == 0) for g, sb in enumerate(shards)]

    def checked(strips_d, shards, full_args, n_glyphs, what):
        """K4p on every shard and K6 on their keys, in place, against their
        plain versions, and the combined ids against unsharded K4's, folded
        into ``err``; raises on a difference. Returns the keys."""
        e4, keys = 0, []
        for g, (key, white) in enumerate(row_of_calls(strips_d, shards)):
            sb = shards[g]
            key_r, white_r = S.ssd_argmin_partial_reference(strips_d, sb.templates, sb.tsq,
                                                            sb.wx0, sb.g0, white=g == 0)
            torch.cuda.synchronize()
            if (white is None) != (g > 0):
                raise AssertionError(f"K4p, shard {g}: white flags {white is not None}")
            e4 = max(e4, max_abs_err(key, key_r), 0 if g else
                     max_abs_err(white.to(torch.int32), white_r.to(torch.int32)))
            keys.append(key)
        out = S.first_min_combine(keys)
        out_r = S.first_min_combine_reference(keys)
        full, _ = S.ssd_argmin(strips_d, *full_args)
        torch.cuda.synchronize()
        e6, e_full = max_abs_err(out, out_r), max_abs_err(out, full)
        metric = S.unpack_key(torch.stack(keys))[0]
        ties = int((metric == metric.min(dim=0).values).sum(dim=0).gt(1).sum())
        log(f"[mesh-kernels] {len(shards)} glyph shards of {shards[0].templates.shape[1]}, "
            f"{what}: K4p vs plain max|err| {e4}, K6 vs plain {e6}, combined vs unsharded K4 "
            f"{e_full}; {ties} cells tie across shards")
        err["ssd_argmin_partial"] = max(err["ssd_argmin_partial"], e4)
        err["ssd_combine"] = max(err["ssd_combine"], e6, e_full)
        if e4 or e6 or e_full or int(out.max()) >= n_glyphs:
            raise AssertionError(f"mesh kernels mismatch, {what}: K4p {e4}, K6 {e6}, combined "
                                 f"{e_full}, largest id {int(out.max())} of {n_glyphs} glyphs")
        return keys

    err = {"ssd_argmin_partial": 0, "ssd_combine": 0}
    by_shards: dict[int, dict] = {}
    block = 8  # pages of a slot's block on a 2x2 mesh of the 16-page batch
    # past MAX_SHARDS (8) K6 folds first: one fold launch, then its last pass
    for n_g in (2, 4, 9, 16, 17):
        folds = sum(len(level) for level in S.fold_plan(n_g))
        t = {k: 0.0 for k in ("k4p_ms", "k4p_plain_ms", "k4p_device_ms", "k4p_first_device_ms",
                              "k4p_other_device_ms", "k6_ms", "k6_plain_ms", "k6_device_ms",
                              "k6_fold_device_ms", "k6_library_ms", "k4p_ops", "k4p_bytes",
                              "k6_bytes")}
        hus = {"k4p": [], "k6": []}
        for (grp, _), bank in zip(dec.groups, dec.banks):
            wx0_d = up(bank.wx0)
            shards = shard_banks(shard_grid_bank(bank.templates, bank.tsq, n_g), wx0_d,
                                 bank.crop_w)
            full_args = (up(bank.templates), up(bank.tsq.astype(np.int64)), wx0_d)
            # the 16-page wave, noise and white pages, and the block of 8 pages
            # that a slot of a 2 x n_g mesh is given: checked, then timed
            for label, src in (("corpus wave", pages), ("noise and white pages", noise),
                               (f"a slot's block of {block} pages", pages[:block])):
                strips_d = up(focr_model.crop_strips(src, grp.ys, grp.crop_h, dec.x0, dec.crop_w))
                keys = checked(strips_d, shards, full_args, bank.n_glyphs,
                               f"row group h={grp.crop_h}, {label}")
            Bs, R, h, _ = strips_d.shape
            C, Gl, _, win_w = shards[0].templates.shape
            first, other = shards[0], shards[-1]
            # per K4p launch: a row's n_g calls, divided by n_g
            t["k4p_ms"] += cuda_ms(lambda: row_of_calls(strips_d, shards), 20) / n_g / block
            t["k4p_device_ms"] += device_ms(lambda: row_of_calls(strips_d, shards), 20,
                                            "focr_ssd_argmin", n_g) / n_g / block
            t["k4p_first_device_ms"] += device_ms(
                lambda: S.ssd_argmin_partial(strips_d, first), 20, "focr_ssd_argmin") / block
            t["k4p_other_device_ms"] += device_ms(
                lambda: S.ssd_argmin_partial(strips_d, other, white=False), 20,
                "focr_ssd_argmin") / block
            t["k4p_plain_ms"] += cuda_ms(lambda: [S.ssd_argmin_partial_reference(
                strips_d, sb.templates, sb.tsq, sb.wx0, sb.g0, white=g == 0)
                for g, sb in enumerate(shards)], 3) / n_g / block
            t["k6_ms"] += cuda_ms(lambda: S.first_min_combine(keys), 50) / block
            t["k6_device_ms"] += device_ms(lambda: S.first_min_combine(keys), 20,
                                           "focr_ssd_combine") / block
            if folds:  # the fold pass's share, in K6's device time too
                fold = device_ms(lambda: S.first_min_combine(keys), 20, "focr_ssd_fold",
                                 folds) / block
                t["k6_fold_device_ms"] += fold
                t["k6_device_ms"] += fold
            t["k6_plain_ms"] += cuda_ms(lambda: S.first_min_combine_reference(keys), 10) / block
            stacked = torch.stack(keys)
            t["k6_library_ms"] += cuda_ms(lambda: torch.amin(stacked, dim=0), 50) / block
            hus["k4p"].append(host_us(lambda: S.ssd_argmin_partial(strips_d, other, white=False)))
            hus["k6"].append(host_us(lambda: S.first_min_combine(keys)))
            # operations and bytes a K4p launch needs, on average over the row
            t["k4p_ops"] += 2 * Bs * R * C * Gl * h * win_w
            t["k4p_bytes"] += sum(nbytes(strips_d, sb.templates, sb.tsq, sb.wx0, k)
                                  for sb, k in zip(shards, keys)) / n_g + Bs * R / n_g
            t["k6_bytes"] += nbytes(*keys, S.first_min_combine(keys))
        k4p_bound = bound(t["k4p_ops"] / block, t["k4p_bytes"] / block)
        k6_bound = bound(0, t["k6_bytes"] / block)
        by_shards[n_g] = {
            "k4p": {"ms": t["k4p_ms"], "device_ms": t["k4p_device_ms"],
                    "first_shard_device_ms": t["k4p_first_device_ms"],
                    "other_shard_device_ms": t["k4p_other_device_ms"],
                    "plain_ms": t["k4p_plain_ms"], "bound_ms": k4p_bound[0],
                    "bound_by": k4p_bound[1], "host_us_per_call": hus["k4p"],
                    "library_ms": None},
            "k6": {"ms": t["k6_ms"], "device_ms": t["k6_device_ms"],
                   "fold_launches_per_call": folds, "fold_device_ms": t["k6_fold_device_ms"],
                   "plain_ms": t["k6_plain_ms"], "bound_ms": k6_bound[0],
                   "bound_by": k6_bound[1], "host_us_per_call": hus["k6"],
                   "library_ms": t["k6_library_ms"]}}
        log(f"[mesh-kernels] {n_g} glyph shards, blocks of {block} pages, ms/page (both row "
            f"groups), per launch: K4p {t['k4p_ms']:.5f} as its calls are timed, "
            f"{t['k4p_device_ms']:.5f} of device time (the first shard, with white flags, "
            f"{t['k4p_first_device_ms']:.5f}; a later one {t['k4p_other_device_ms']:.5f}; plain "
            f"{t['k4p_plain_ms']:.5f}, bound {k4p_bound[0]:.6f} by {k4p_bound[1]}; "
            f"{S.PARTIAL_WARPS} cells a block), K6 {t['k6_ms']:.6f}, {t['k6_device_ms']:.6f} of "
            f"device time ({folds} fold launch(es) a call, {t['k6_fold_device_ms']:.6f} of it; plain {t['k6_plain_ms']:.5f}, torch.amin of the stacked keys "
            f"{t['k6_library_ms']:.6f}, bound {k6_bound[0]:.7f} by {k6_bound[1]}); host us a call "
            f"by row group: K4p {', '.join(f'{v:.1f}' for v in hus['k4p'])}, K6 "
            f"{', '.join(f'{v:.1f}' for v in hus['k6'])}; card {card}")
    # K6 on adversarial keys
    n = 3978 * 3 + 1
    lo, hi = -2 * 74565 * 65025, 74565 * 65025  # the metric's ends at check_window's bound

    def adversarial(label, n_g):
        Gl = S.GID_LIMIT // n_g  # glyphs a shard, numbered from the shard's first
        metrics = rng.integers(0, 100, (n_g, n)).astype(np.int64)
        gids = rng.integers(0, Gl, (n_g, n)) + (np.arange(n_g, dtype=np.int64) * Gl)[:, None]
        if label == "equal metrics in every shard":
            metrics[:] = 7
        elif label == "the minimum in the last shard":
            metrics[-1] = -5
        elif label == "padded copies of glyph 0":  # the last shard: copies of glyph 0
            metrics[:] = 9
            metrics[0], gids[0], metrics[-1] = 3, 0, 3
        elif label == "the metric's ends, glyphs up to 2^28 - 1":
            metrics[:] = hi
            metrics[-1, ::2], metrics[0, 1::4] = lo, lo
            gids[-1] = S.GID_LIMIT - 1 - rng.integers(0, 2, n)
        else:  # few distinct values
            metrics = rng.integers(-1, 2, (n_g, n)).astype(np.int64) * 10**9
        return metrics, gids

    for label in ("equal metrics in every shard", "the minimum in the last shard",
                  "padded copies of glyph 0", "the metric's ends, glyphs up to 2^28 - 1",
                  "few distinct values"):
        for n_g in (2, 4, 8, 9, 16, 17):
            metrics, gids = adversarial(label, n_g)
            keys = [up(k) for k in S.pack_key(metrics, gids)]
            got = S.first_min_combine(keys)
            torch.cuda.synchronize()
            want = np.take_along_axis(gids, np.argmin(metrics, axis=0)[None], axis=0)[0]
            e = max(max_abs_err(got, up(want.astype(np.int32))),
                    max_abs_err(got, S.first_min_combine_reference(keys)))
            if e:
                raise AssertionError(f"K6 mismatch on {label} at {n_g} shards: max|err| {e}")
            err["ssd_combine"] = max(err["ssd_combine"], e)
        log(f"[mesh-kernels] K6, {label}, {n} cells, 2, 4, 8, 9, 16 and 17 shards: the lowest "
            "shard that holds the minimum, max|err| 0 against numpy's first-occurrence argmin "
            "and the plain version")
    # K4p's int64 instance (a window whose dot may pass 2^31)
    wide_t = rng.integers(0, 256, (2, 34, 1, 34000), dtype=np.uint8)
    wide_t[wide_t < 140] = 0
    wide_t[:, 20] = wide_t[:, 3]  # a duplicated glyph: a tie across the two shards
    tsq = (wide_t.astype(np.int64) ** 2).sum(axis=(2, 3))
    strips_d = up(rng.integers(0, 256, (1, 3, 1, 40000), dtype=np.uint8))
    wx0_d = up(np.array([0, 5000], np.int32))
    shards = shard_banks(shard_grid_bank(wide_t, tsq, 2), wx0_d, 40000)
    if any(sb.pitch(S.PARTIAL_WARPS) for sb in shards):
        raise AssertionError("the 1x34000 window did not take the int64 instance")
    checked(strips_d, shards, (up(wide_t), up(tsq), wx0_d), 34, "int64 instance, 1x34000 window")
    entries = []
    for name, key, line in (("ssd_argmin_partial", "k4p", 71), ("ssd_combine", "k6", 75)):
        entries.append({"name": name, "route": "cuda",
                        "source": "focr_tpu_torch/csrc/focr_ssd.cu",
                        "replaces": f"focr_tpu/parallel/decode.py:{line}", "launches": 0,
                        "launches_per_page": 0.0, "max_abs_err": err[name],
                        **by_shards[2][key], "glyph_shards": 2, "block_pages": block,
                        "by_glyph_shards": {str(n_g): v[key] for n_g, v in by_shards.items()}})
    entries[0]["warps"] = S.PARTIAL_WARPS
    return entries[0], entries[1]


def mesh_paths_phase(cases: dict, ncc_paths: list[str], want16: str, card: str) -> dict:
    """Phase 18: the three CLIs over a mesh of slots. ``cases``: the focr and
    prop argv and stdout; ``ncc_paths``, ``want16``: the ncc corpus' 16 page
    files and the CLI's stdout on them. Returns the numbers for the JSON line,
    with K4p's and K6's launches of the counted run."""
    import torch

    from focr_tpu_torch.cli.focr import main as focr_main
    from focr_tpu_torch.cli.ncc import main as ncc_main
    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.ops import ncc_kernels as K
    from focr_tpu_torch.ops import prop_kernels as P
    from focr_tpu_torch.ops import replay_kernels as R
    from focr_tpu_torch.ops import ssd_kernels as S
    from focr_tpu_torch.parallel import mesh as M
    from focr_tpu_torch.utils.device import SLOT_LAUNCHES, reset_slot_launches

    reps = 4
    ncc_argv = ["-i", *(ncc_paths * reps), "-f", FONT, "-t", "13", "--x-bits", "2",
                "--needle-bank", FIXTURE]
    n_ncc = reps * len(ncc_paths)
    # (name, main, argv, stdout, pages, the wrappers whose LAUNCHES the slots' counts must equal)
    configs = [
        (f"focr --glyph-shards {g}", focr_main, [*cases["focr"][0], "--glyph-shards", str(g)],
         cases["focr"][1], 16, (S,)) for g in (1, 2, 4)
    ] + [("prop", focr_main, cases["prop"][0], cases["prop"][1], 16, (P,)),
         (f"ncc --pages {n_ncc}", ncc_main, ncc_argv, want16 * reps, n_ncc, (K, R))]
    slot_lists = [["cuda:0"] * 4]
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        slot_lists.append([f"cuda:{i}" for i in range(n_cards)])
    log(f"[mesh-paths] {n_cards} physical card(s) visible: running on 4 slots of cuda:0"
        + (f" and on the {n_cards} cards, one slot each" if n_cards > 1 else
           "; the run over several physical cards does NOT run here (peer copies and the "
           "current-device switch at each launch stay untested)"))
    result: dict = {"runs": []}
    saved = os.environ.get(M.MESH_DEVICES_ENV)
    try:
        for slots in slot_lists:
            os.environ[M.MESH_DEVICES_ENV] = ",".join(slots)
            where = f"{len(slots)} slots on {len(set(slots))} card(s)"
            for name, main, argv, want, n_pages, wrappers in configs:
                if "--glyph-shards" in argv and len(slots) % int(argv[-1]):
                    log(f"[mesh-paths] {name}: {argv[-1]} glyph shards do not divide {where}: "
                        "not run")
                    continue
                # the counted run, then two more: every stdout is focr_tpu's
                for k in range(3):
                    for w in wrappers:
                        w.reset_launches()
                    reset_slot_launches()
                    out, _ = _run_cli(main, argv)
                    launches = {kn: v for w in wrappers for kn, v in w.LAUNCHES.items()}
                    by_slot = dict(SLOT_LAUNCHES)
                    if out != want:
                        raise AssertionError(f"mesh {name} on {where}, run {k}: stdout differs")
                    for kernel in launches:  # every launch was made for a slot
                        if launches[kernel] != sum(v for (_, kn), v in by_slot.items()
                                                   if kn == kernel):
                            raise AssertionError(f"mesh {name}: {kernel} launched "
                                                 f"{launches[kernel]} times, the slots count "
                                                 f"{by_slot}")
                    busy = {i for i, _ in by_slot}
                    if busy != set(range(len(slots))) or not any(launches.values()):
                        raise AssertionError(f"mesh {name} on {where}: slots {sorted(busy)} "
                                             f"launched, of {len(slots)}; launches {launches}")
                if slots is slot_lists[0] and name == "focr --glyph-shards 2":
                    result["counted"] = launches
                # pages/s in turns against --mesh off
                rates = {"off": [], "mesh": []}
                for side in ("off", "mesh", "mesh", "off"):
                    side_argv = [*argv, "--mesh", "off"] if side == "off" else argv
                    for _ in range(3):
                        t0 = time.perf_counter()
                        out, _ = _run_cli(main, side_argv)
                        torch.cuda.synchronize()
                        rates[side].append(n_pages / (time.perf_counter() - t0))
                        if out != want:
                            raise AssertionError(f"mesh {name} on {where}, --mesh {side}: stdout "
                                                 "differs")
                med = {k: sorted(v)[len(v) // 2] for k, v in rates.items()}
                log(f"[mesh-paths] {name} on {where}: stdout identical to focr_tpu's on 3 + 12 "
                    f"runs; launches {launches}, every slot launched; pages/s, median of 6 "
                    f"(min-max), in turns: mesh {med['mesh']:.1f} ({min(rates['mesh']):.1f}-"
                    f"{max(rates['mesh']):.1f}) against --mesh off {med['off']:.1f} "
                    f"({min(rates['off']):.1f}-{max(rates['off']):.1f}); card {card}")
                result["runs"].append({
                    "path": name, "slots": slots, "physical_cards": len(set(slots)),
                    "pages": n_pages, "launches": launches, "pages_per_s_mesh": rates["mesh"],
                    "pages_per_s_mesh_off": rates["off"]})
        # focr past 8 glyph shards: one glyph row of n_g slots of cuda:0, K6
        # folding first; one counted run each
        result["many_shards"] = []
        for n_g in (9, 16, 17):
            os.environ[M.MESH_DEVICES_ENV] = ",".join(["cuda:0"] * n_g)
            S.reset_launches()
            reset_slot_launches()
            out, _ = _run_cli(focr_main, [*cases["focr"][0], "--glyph-shards", str(n_g)])
            launches, by_slot = dict(S.LAUNCHES), dict(SLOT_LAUNCHES)
            if out != cases["focr"][1]:
                raise AssertionError(f"focr --glyph-shards {n_g}: stdout differs")
            folds = sum(len(level) for level in S.fold_plan(n_g))
            k6_slots = {i for i, kn in by_slot if kn in ("ssd_combine", "ssd_combine_fold")}
            k4p_slots = {i for i, kn in by_slot if kn == "ssd_argmin_partial"}
            if (any(v != sum(c for (_, kn), c in by_slot.items() if kn == k)
                    for k, v in launches.items())
                    or k4p_slots != set(range(n_g)) or k6_slots != {0}
                    or not launches["ssd_combine"]
                    or launches["ssd_combine_fold"] != folds * launches["ssd_combine"]):
                raise AssertionError(f"focr --glyph-shards {n_g}: launches {launches}, by slot "
                                     f"{by_slot}")
            log(f"[mesh-paths] focr --glyph-shards {n_g} on {n_g} slots of cuda:0: stdout "
                f"identical to focr_tpu's; launches {launches} ({folds} fold launch(es) a "
                f"combine), K4p on every slot, K6 on the head; card {card}")
            result["many_shards"].append({"glyph_shards": n_g, "pages": 16,
                                          "launches": launches})
    finally:
        if saved is None:
            os.environ.pop(M.MESH_DEVICES_ENV, None)
        else:
            os.environ[M.MESH_DEVICES_ENV] = saved
    # ncc on a mesh waits as the single-card path does, for each sub-wave
    ncc_model.reset_host_waits()
    return result


def multiproc_phase(card: str) -> dict:
    """Phase 19: two processes over gloo on the card, with the meshes whose
    glyph rows span them (the tool checks parity and where K4p and K6 ran).
    Returns each process's launches on those meshes and the exchange's ms a
    batch."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_multiproc_smoke.py"), "--device",
         "cuda:0", "--corpus", "canonical"],
        cwd=REPO, capture_output=True, text=True, timeout=700)
    oks = [ln for ln in res.stdout.splitlines() if "multiproc smoke OK" in ln]
    info = sorted((json.loads(ln)["multiproc"] for ln in res.stdout.splitlines()
                   if ln.startswith('{"multiproc"')), key=lambda d: d["rank"])
    if res.returncode != 0 or len(oks) != 2 or [d["rank"] for d in info] != [0, 1]:
        raise AssertionError(f"multiproc smoke exited {res.returncode}: {res.stdout[-2000:]}\n"
                             f"{res.stderr[-3000:]}")
    ms = info[0]["exchange_ms_per_batch"]
    launches = [d["spanning_slot_launches"] for d in info]
    log(f"[multiproc] two processes over gloo, {time.perf_counter() - t0:.1f} s: {oks}; glyph "
        f"rows across the processes bit-identical on meshes {sorted(launches[0])}, launches by "
        f"process and slot {launches}; the host exchange of a batch's spanning row {ms:.3f} ms; "
        f"card {card}")
    return {"slot_launches_by_rank": launches, "exchange_ms_per_batch": ms}


def replay_phase(matcher, pages, launches: dict, n_pages: int, card: str) -> dict:
    """Phase 20: K3 on phase 3's wave against its plain version and the host
    library's replay. ``launches``: the counted CLI run's (phase 5) K1 and
    K3 launches on ``n_pages`` pages. Returns K3's kernels entry."""
    import numpy as np
    import torch

    from focr_tpu_torch.models.types import MAX_MATCHES
    from focr_tpu_torch.native import ncc_cpu
    from focr_tpu_torch.ops import replay_kernels as R

    thr = float(np.float32(matcher.threshold))
    cw = canonical_wave(matcher, pages)
    B = len(cw[0][2])
    # candidates a (page, needle) segment on the canonical wave
    lens = np.concatenate([hcnt.cpu().numpy().reshape(-1) for *_, hcnt in cw])
    dist = {"segments": int(lens.size), "p50": float(np.percentile(lens, 50)),
            "p99": float(np.percentile(lens, 99)), "max": int(lens.max()),
            "mean": float(lens.mean())}
    log(f"[replay] candidates a (page, needle) segment on the {B}-page wave: {dist}")
    err = n_cand = n_hits = n_capped = 0
    ops = moved = 0
    timed = []  # (K3's arguments, the host replay's) of each group
    for grp, dg, inv, crop, inv_dev, pos, off, hcnt in cw:
        for mm in (MAX_MATCHES, 5):
            tail = (thr, crop[0], crop[1], mm)
            plain = R.replay_hits(R.ncc_replay_reference(
                inv_dev, pos, off, hcnt, dg.bank, dg.s_n, dg.s2_n, *tail), off, hcnt)
            hargs = host_replay_inputs(grp, inv, crop, pos, off, hcnt, thr, mm)
            host = _host_hits(hargs)
            kargs = (inv_dev, pos, off, hcnt, dg.replay, *tail)
            got = R.replay_hits(R.ncc_replay(*kargs), off, hcnt)
            torch.cuda.synchronize()
            e_plain, e_host = _bits_err(got, plain), _bits_err(got, host)
            kept, warned = int(got[3].sum()), int(got[4].sum())
            log(f"[replay] group {grp.nw}x{grp.nh}, max_matches {mm}: {len(pos)} candidates, "
                f"{kept} hits, {warned} WARN flags; K3 vs plain max|err| {e_plain}, vs the host "
                f"library {e_host}")
            if e_plain or e_host:
                raise AssertionError(f"K3 mismatch in group {grp.nw}x{grp.nh}, max_matches "
                                     f"{mm}: plain {e_plain}, host {e_host}")
            err = max(err, e_plain, e_host)
            if mm != MAX_MATCHES:
                n_capped += warned
                continue
            n_cand += len(pos)
            n_hits += kept
            timed.append((kargs, hargs))
            # the correlation's multiply-adds of every candidate's window; the
            # bytes: positions, crop, bank and counts in once, the hits out
            T, nh, nw = dg.bank.shape
            ops += 2 * len(pos) * nh * nw
            moved += (nbytes(pos, inv_dev, dg.bank, dg.s_n, dg.s2_n, off, hcnt)
                      + 12 * kept + 5 * B * T)
    if not n_capped:
        raise AssertionError("K3: the cap of 5 raised no WARN flag")
    edges = replay_edge_cases(R)
    err = max(err, edges["max_abs_err"])
    ms = sum(cuda_ms(lambda: R.ncc_replay(*ka), 20) for ka, _ in timed) / B
    dev_ms = sum(device_ms(lambda: R.ncc_replay(*ka), 20, "focr_ncc_replay")
                 for ka, _ in timed) / B
    plain_ms = sum(cuda_ms(lambda: R.ncc_replay_reference(
        *ka[:4], ka[4].bank, ka[4].s_n, ka[4].s2_n, *ka[5:9]), 3) for ka, _ in timed) / B
    # the wrapper's host time a call: many calls, one wait at the end
    k3_host_us = [host_us(lambda: R.ncc_replay(*ka)) for ka, _ in timed]
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _, ha in timed:
            for args in ha:
                ncc_cpu.replay_group(*args)
        host.append((time.perf_counter() - t0) * 1e3 / B)
    host_ms = sorted(host)[len(host) // 2]
    bound_ms, bound_by = bound(ops / B, moved / B)
    n3, n1 = launches["ncc_replay"], launches["ncc_sweep"]
    log(f"[replay] {B}-page wave: {n_cand / B:.0f} candidates and {n_hits / B:.0f} hits a page, "
        f"K3 identical to its plain version and to the host library with MAX_MATCHES and with a "
        f"cap of 5 ({n_capped} WARN flags), {R.WARPS} warps a segment; ms/page K3 "
        f"{ms:.5f} as the call is timed, {dev_ms:.5f} of device time (plain {plain_ms:.4f}, "
        f"host library replay {host_ms:.4f}, bound {bound_ms:.6f} by {bound_by}); the wrapper's "
        f"host time a call {', '.join(f'{v:.1f}' for v in k3_host_us)} us by group; launches "
        f"on the counted CLI run {n3} (K1 {n1}, {n3 / n_pages:g} a page); card {card}")
    return {"name": "ncc_replay", "route": "cuda", "source": "focr_tpu_torch/csrc/ncc_replay.cu",
            "replaces": "focr_tpu/models/ncc.py:1422", "launches": n3,
            "launches_per_page": n3 / n_pages, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "host_replay_ms": host_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "candidates_per_page": n_cand / B,
            "hits_per_page": n_hits / B, "host_us_per_call": k3_host_us,
            "warps": R.WARPS,
            "segment_candidates": dist, "edge_cases": edges["cases"]}


def replay_edge_cases(R) -> dict:
    """K3 on tests/replay_cases.py's design cases on the card: against its
    plain version on the card and the host library's replay of each page,
    bit for bit, at MAX_MATCHES and caps of 33, 32 and 5."""
    import numpy as np
    import torch

    from focr_tpu_torch.models.types import MAX_MATCHES
    # by its path: a package named ``tests`` elsewhere on sys.path would win
    # over the repo's tests directory, which is no package
    spec = importlib.util.spec_from_file_location(
        "replay_cases", os.path.join(REPO, "tests", "replay_cases.py"))
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)

    err = runs = 0
    for nw in C.EDGE_WIDTHS:
        case = C.replay_case(nw, seed=nw)
        t = {k: torch.from_numpy(v).cuda() for k, v in case.items() if isinstance(v, np.ndarray)}
        args = (t["imgs"], t["pos"], t["off"], t["hcnt"])
        nd = R.replay_needles(t["bank"], t["s_n"], t["s2_n"])
        for mm in (MAX_MATCHES, 33, 32, 5):
            plain = R.replay_hits(R.ncc_replay_reference(
                *args, t["bank"], t["s_n"], t["s2_n"], case["thr_f64"], 0, 0, mm),
                t["off"], t["hcnt"])
            host = _host_hits([C.host_args(case, b, mm) for b in range(len(case["hcnt"]))])
            got = R.replay_hits(R.ncc_replay(*args, nd, case["thr_f64"], 0, 0, mm),
                                t["off"], t["hcnt"])
            torch.cuda.synchronize()
            e = max(_bits_err(got, plain), _bits_err(got, host))
            runs += 1
            if e:
                raise AssertionError(f"K3 edge case nw {nw}, max_matches {mm}: max|err| {e}")
            err = max(err, e)
    log(f"[replay] edge cases (segments of {C.SEGMENT_LENGTHS} candidates, a window on the "
        f"crop's last byte, widths {C.EDGE_WIDTHS}; caps 1024, 33, 32, 5): "
        f"{runs} runs, K3 identical to its plain version and to the host library")
    return {"max_abs_err": err, "cases": runs}


def _host_hits(arg_list) -> tuple:
    """The host library's replays of one group's pages (each page's
    replay_group arguments), in K3's replay_hits form."""
    import numpy as np

    from focr_tpu_torch.native import ncc_cpu

    parts, counts, warns = [], [], []
    for args in arg_list:
        x, y, sim, c, w = ncc_cpu.replay_group(*args)
        idx = np.concatenate([np.arange(a, a + k) for a, k in zip(args[2], c)]
                             or [np.zeros(0, np.int64)]).astype(np.int64)
        parts.append((x[idx], y[idx], sim[idx]))
        counts.append(c)
        warns.append(w)
    return (*(np.concatenate([p[i] for p in parts]) for i in range(3)), np.stack(counts),
            np.stack(warns))


def _bits_err(a, b) -> int:
    """Largest |difference| over x, y, the f32 sims' bits, counts and warn of
    two replay_hits results (tensors on any device, or NumPy arrays)."""
    import numpy as np
    import torch

    e = 0
    for u, v in zip(a, b, strict=True):
        u, v = (np.asarray(t.cpu() if torch.is_tensor(t) else t) for t in (u, v))
        if u.shape != v.shape:
            raise AssertionError(f"K3: shapes {u.shape} and {v.shape} differ")
        if u.dtype == np.float32:
            u, v = u.view(np.int32), v.view(np.int32)
        if u.size:
            e = max(e, int(np.abs(u.astype(np.int64) - v.astype(np.int64)).max()))
    return e


def main() -> int:
    import numpy as np
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; it needs a CUDA card")
    sys.path.insert(0, REPO)
    from focr_tpu_torch.utils.device import card_label

    card = card_label()
    log(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    # 2. build
    from focr_tpu_torch.native import build

    t0 = time.perf_counter()
    build.load()
    log(f"[build] nvcc + load {time.perf_counter() - t0:.1f} s: {build.build()}")
    k1_gmma = sweep_sass(build)
    t0 = time.perf_counter()
    build.load_host()
    host_build = {
        "host_build_s": time.perf_counter() - t0,
        "compiler": subprocess.run([build.HOST_CXX, "--version"], capture_output=True,
                                   text=True, check=True).stdout.splitlines()[0],
        # libgomp's team size: OMP_NUM_THREADS, else every CPU the process may use
        "omp_threads": int(os.environ.get("OMP_NUM_THREADS") or len(os.sched_getaffinity(0))),
    }
    log(f"[build] {host_build['compiler']}, {' '.join(build.HOST_FLAGS)}, + load "
        f"{host_build['host_build_s']:.1f} s: {build.host_library_path()}")
    # the built libraries load in a process with no compiler on PATH
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    with tempfile.TemporaryDirectory() as empty:
        env["PATH"] = empty
        res = subprocess.run(
            [sys.executable, "-c", "from focr_tpu_torch.native import build; build.load(); "
             "build.load_host(); print(build.library_path(), build.host_library_path())"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    if res.returncode != 0 or res.stdout.split() != [build.library_path(),
                                                     build.host_library_path()]:
        raise AssertionError(f"the built libraries did not load without the compilers: "
                             f"{res.stderr[-2000:]}")
    log("[build] both libraries load in a process with no compiler on PATH")

    from focr_tpu_torch.fonts.bank import load_needle_bank
    from focr_tpu_torch.io.images import save_gray
    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.models.post import line_matches_truth, process_hits_text
    from focr_tpu_torch.models.types import NCC_DEFAULT_ALPHABET, RenderOptions
    from focr_tpu_torch.native import ncc_cpu
    from focr_tpu_torch.ops import ncc_kernels as K
    from focr_tpu_torch.ops import replay_kernels as R

    dev = torch.device("cuda")
    with np.load(FIXTURE, allow_pickle=False) as z:
        pages = z["pages"]
        truths = json.loads(str(z["truths"]))
        golden = json.loads(str(z["lines"]))
    needles, _ = load_needle_bank(FIXTURE)

    # 3. kernels: K1 and K2 against their plain versions on one main-path wave
    wave = pages[: ncc_model.WAVE]
    B = len(wave)
    inv = (255 - wave.astype(np.int16)).astype(np.uint8)
    groups = ncc_model._group_needles(needles)
    y0, x0, Hc, Wc = ncc_model._ink_crop(inv, *inv.shape[1:], groups)
    inv_dev = torch.from_numpy(np.ascontiguousarray(inv[:, y0 : y0 + Hc, x0 : x0 + Wc])).to(dev)
    log(f"[kernels] wave of {B} pages {wave.shape[1]}x{wave.shape[2]}, ink crop {Hc}x{Wc}")
    err = {"ncc_sweep": 0, "compact_hits": 0}
    ms = {"ncc_sweep": 0.0, "compact_hits": 0.0}
    plain_ms = {"ncc_sweep": 0.0, "compact_hits": 0.0}
    ops = {"ncc_sweep": 0, "compact_hits": 0}  # K2 only moves bytes
    moved = {"ncc_sweep": 0, "compact_hits": 0}
    k2_parts = {"count_ms": 0.0, "emit_ms": 0.0}
    conv_ms = k1_device_ms = 0.0
    for g in groups:
        dg = ncc_model.group_from_numpy(g.bank, g.s_n, g.s2_n, THRESHOLD, dev)
        args = (inv_dev, dg.bank, dg.s_n, dg.s2_n, THRESHOLD)
        mask, rcnt = K.ncc_sweep(*args, terms=dg.terms)
        mask_r, rcnt_r = K.ncc_sweep_reference(*args, terms=dg.terms)
        torch.cuda.synchronize()
        e1 = max(max_abs_err(mask, mask_r), max_abs_err(rcnt, rcnt_r))
        out = K.compact_hits(mask, rcnt)
        out_r = K.compact_hits_reference(mask, rcnt)
        row_off, head = K.compact_counts(rcnt)
        row_off_r, head_r = K.compact_counts_reference(rcnt)
        torch.cuda.synchronize()
        e2 = max(max_abs_err(a, b) for a, b in zip(out, out_r))
        e_count = max(max_abs_err(row_off, row_off_r), max_abs_err(head, head_r))
        n_cand = int(out[3].sum())
        log(f"[kernels] group {g.nw}x{g.nh} T={len(g.needle_ids)}: K1 vs plain max|err| {e1}, "
            f"K2 vs plain max|err| {e2} (its count kernel: {e_count}), {n_cand} candidates, "
            f"{int(rcnt.sum())} mask bits")
        if e1 or e2 or e_count or n_cand == 0:
            raise AssertionError(f"kernel mismatch in group {g.nw}x{g.nh}: K1 {e1}, K2 {e2}, "
                                 f"K2 count {e_count}")
        err["ncc_sweep"] = max(err["ncc_sweep"], e1)
        err["compact_hits"] = max(err["compact_hits"], e2, e_count)
        # every window of the ink crop against every needle: nh x nw multiply-adds
        T, nh, nw = dg.bank.shape
        ops["ncc_sweep"] += 2 * B * (Hc - nh + 1) * (Wc - nw + 1) * T * nh * nw
        moved["ncc_sweep"] += nbytes(inv_dev, dg.bank, *dg.terms[:2], mask, rcnt)
        # K2 needs the mask rows that hold candidates, the row counts, its outputs
        moved["compact_hits"] += (int((rcnt > 0).sum()) * mask.shape[-1] * 4
                                  + nbytes(rcnt, *out))
        # the yardstick of the correlation alone: cuDNN's conv2d in TF32 (0..255
        # and their products are exact there, sums stay below 2^24); the port
        # never calls it
        x, w = inv_dev.float()[:, None], dg.bank.float()[:, None]
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            t_conv = cuda_ms(lambda: torch.nn.functional.conv2d(x, w), 5)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        del x, w
        conv_ms += t_conv / B
        ts = {
            ("ncc_sweep", False): cuda_ms(
                lambda: K.ncc_sweep(*args, terms=dg.terms, packed=dg.packed), 10),
            ("ncc_sweep", True): cuda_ms(lambda: K.ncc_sweep_reference(*args, terms=dg.terms), 3),
            # K2 as the main path runs it: count, one wait for the total, emit
            ("compact_hits", False): cuda_ms(lambda: K.compact_hits(mask, rcnt), 10),
            ("compact_hits", True): cuda_ms(lambda: K.compact_hits_reference(mask, rcnt), 3),
        }
        k1_dev = device_ms(lambda: K.ncc_sweep(*args, terms=dg.terms, packed=dg.packed), 10,
                           "focr_ncc_sweep") / B
        k1_device_ms += k1_dev
        total = int(out[1][-1])
        count_ms = cuda_ms(lambda: K.compact_counts(rcnt), 20)
        emit_ms = cuda_ms(lambda: K.compact_emit(mask, rcnt, row_off, total), 20)
        k2_parts["count_ms"] += count_ms / B
        k2_parts["emit_ms"] += emit_ms / B
        for (name, plain), t in ts.items():
            (plain_ms if plain else ms)[name] += t / B
        log(f"[kernels] group {g.nw}x{g.nh} ms/page: K1 {ts['ncc_sweep', False] / B:.4f}, "
            f"device {k1_dev:.4f} ({K.sweep_plan(nh, nw, 'narrow')}; plain "
            f"{ts['ncc_sweep', True] / B:.4f}, conv2d TF32 correlation alone "
            f"{t_conv / B:.4f}), K2 count + wait + emit {ts['compact_hits', False] / B:.4f} "
            f"(count alone {count_ms / B:.5f}, emit alone {emit_ms / B:.5f}; plain "
            f"{ts['compact_hits', True] / B:.4f})")
    bounds = {k: bound(ops[k] / B, moved[k] / B) for k in ops}
    # K1 beyond the canonical wave: its tile edges, both designs
    k1_mma = sweep_edge_checks(dev)
    err["ncc_sweep"] = max(err["ncc_sweep"], k1_mma["edge_max_abs_err"])

    # 4. golden: the matcher on the card reproduces focr_tpu's lines
    ropts = RenderOptions(size=13.0)
    matcher = ncc_model.NccMatcher(
        None, NCC_DEFAULT_ALPHABET, ropts, x_bits=2, threshold=THRESHOLD,
        device=dev, needles=needles,
    )
    K.reset_launches()
    R.reset_launches()
    got = matcher.get_hits_many(
        list(pages[: len(golden)]), struct=True,
        post=lambda hs: process_hits_text(hs, 0.95, 5),
    )
    counts = {**K.LAUNCHES, **R.LAUNCHES}
    if got != golden:
        raise AssertionError("golden pages: the card's lines differ from focr_tpu's")
    # every kernel of the path; K1's mma instance serves none of its shapes
    if not all(v for k, v in counts.items() if k != "ncc_sweep_mma") or counts["ncc_sweep_mma"]:
        raise AssertionError(f"golden pages did not launch every kernel: {counts}")
    log(f"[golden] {len(golden)} pages: {sum(map(len, got))} lines identical to focr_tpu's; "
        f"launches {counts}")

    # 5. cli: the ncc command line on 16 pages
    try:
        import ctypes

        ctypes.CDLL("libfreetype.so.6")
        freetype = os.path.exists(FONT)
    except OSError:
        freetype = False
    if freetype:
        from focr_tpu_torch.fonts.bank import build_needles
        from focr_tpu_torch.fonts.ft import Face
        from focr_tpu_torch.models.types import BoxSize

        local = build_needles(Face(FONT), NCC_DEFAULT_ALPHABET, ropts, BoxSize.ALPHABET, 2, 0)
        same = [n.pixels.tobytes() for n in local] == [n.pixels.tobytes() for n in needles]
        log(f"[cli] this machine's FreeType renders the fixture's bank "
            f"{'byte for byte' if same else 'DIFFERENTLY'}")
    else:
        log(f"[cli] no FreeType or no {os.path.basename(FONT)} on this machine")
    log("[cli] the CLI loads the fixture's needle bank (--needle-bank), the bank "
        "focr_tpu rendered")
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k, p in enumerate(pages):
            paths.append(os.path.join(tmp, f"page{k:02d}.pgm"))
            save_gray(paths[-1], p)
        argv = ["-i", *paths, "-f", FONT, "-t", "13", "--x-bits", "2", "--needle-bank", FIXTURE]
        from focr_tpu_torch.cli.ncc import main as ncc_main

        buf = io.StringIO()
        K.reset_launches()
        R.reset_launches()
        ncc_cpu.reset_native_calls()
        ncc_model.reset_host_waits()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = ncc_main(argv)
        wall = time.perf_counter() - t0
        launches = {**K.LAUNCHES, **R.LAUNCHES}
        waits = ncc_model.HOST_WAITS
        native_calls = {k: ncc_cpu.NATIVE_CALLS[k] for k in ("replay_group", "post_page")}
        # K3 replays every group K1 swept; the host replay is off the path;
        # each page is posted in one host-library call
        if (rc != 0 or not all(v for k, v in launches.items() if k != "ncc_sweep_mma")
                or launches["ncc_sweep_mma"] or native_calls["replay_group"]
                or native_calls["post_page"] != len(pages)
                or launches["ncc_replay"] != launches["ncc_sweep"]):
            raise AssertionError(f"in-process CLI: rc {rc}, launches {launches}, host library "
                                 f"calls {native_calls}")
        # a canonical wave: two size groups, one wait for each group's counts
        # and one for every group's positions
        n_waves = -(-len(pages) // ncc_model.WAVE)
        if waits != 3 * n_waves:
            raise AssertionError(f"the ncc device stage waited {waits} times in {n_waves} "
                                 "waves, not 3 a wave")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "focr_tpu_torch.cli.ncc", *argv],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        sub_wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"CLI exited {res.returncode}: {res.stderr[-2000:]}")
    if res.stdout != buf.getvalue():
        raise AssertionError("CLI subprocess stdout differs from the in-process run")
    out_lines = res.stdout.splitlines()
    n_golden = sum(map(len, golden))
    if out_lines[:n_golden] != [ln for page in golden for ln in page]:
        raise AssertionError("CLI: the golden pages' lines differ from focr_tpu's")
    # split the CLI's lines by page with the matcher's own per-page result;
    # each page's text must be found in its lines (bench.py's acceptance
    # rule: subpixel duplicate characters are reference semantics)
    per_page = matcher.get_hits_many(
        list(pages), struct=True, post=lambda hs: process_hits_text(hs, 0.95, 5)
    )
    if out_lines != [ln for lines in per_page for ln in lines]:
        raise AssertionError("CLI lines differ from the in-process matcher's")
    for p, lines in enumerate(per_page):
        missing = [t for t in truths[p] if not any(line_matches_truth(g, t) for g in lines)]
        if missing:
            raise AssertionError(f"CLI page {p}: text lines not decoded: {missing[:2]}")
    log(f"[cli] exit 0; {len(pages)} pages, {len(out_lines)} lines (golden pages identical to "
        f"focr_tpu's, every page's text decoded); in-process {len(pages) / wall:.2f} pages/s "
        f"({wall:.2f} s), subprocess {len(pages) / sub_wall:.2f} pages/s ({sub_wall:.2f} s "
        f"incl. start-up); launches {launches}; host waits {waits} ({waits / n_waves:g} a wave); "
        f"host library calls {native_calls}; card {card}")

    kernels = [
        {"name": name, "route": "cuda", "source": f"focr_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name],
         "launches_per_page": launches[name] / len(pages), "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, src, replaces in (
            ("ncc_sweep", "ncc_sweep.cu", "focr_tpu/ops/pallas_ncc.py:98"),
            ("compact_hits", "ncc_compact.cu", "focr_tpu/ops/pallas_ncc.py:436"),
        )
    ]
    # K1's entry: its device time, and each design with its own launches (the
    # main path's shapes take the wgmma one; the mma one is timed on a shape
    # that takes it)
    kernels[0].update(device_ms=k1_device_ms, instances=[
        {"name": "focr_ncc_sweep_kernel", "design": "wgmma", "launches": launches["ncc_sweep"],
         "shapes": "every shape of the main path",
         "sass_gmma_per_instance": sorted(k1_gmma.values())},
        {"name": "focr_ncc_sweep_mma_kernel", "design": "mma.sync m16n8k32",
         "launches": launches["ncc_sweep_mma"],
         **{k: v for k, v in k1_mma.items() if k != "edge_max_abs_err"}}])
    # K2's entry: count + wait + emit; its count kernel's own launches and
    # each kernel's time alone beside it
    kernels[1].update(k2_parts, count_launches=launches["compact_count"],
                      host_waits_per_wave=waits / n_waves)

    # 6-8. the focr slice
    k4, focr_pps, focr_sub_pps = focr_phases(dev, card)
    kernels.append(k4)
    # 9-11. the proportional focr slice, with K1's wide instance
    k5, wide, prop_pps, prop_sub_pps = prop_phases(dev, card)
    kernels[0].update(wide)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], wide["wide_max_abs_err"])
    kernels.append(k5)
    # 12. the ncc host library
    host_native = host_native_phase(matcher, pages, golden, host_build)
    host_native.update(host_build, ncc_cli_pages_per_s=len(pages) / wall)
    # 13. the ncc pipeline on 64 pages
    pipeline = pipeline_phase(matcher, pages, buf.getvalue(), card)
    with tempfile.TemporaryDirectory() as tmp:
        cases = focr_cli_cases(tmp)
        # 14. the lazy bank load
        banks = banks_phase(cases)
        # 15. metrics, traces and the remaining flags
        metrics_phase(cases, pages, golden, buf.getvalue())
        # 16. the overlays
        no_overlays = overlays_phase(cases)
        # 17. the glyph axis' kernels, K4p and K6
        k4p, k6 = mesh_kernels_phase(dev, card)
        # 18. the CLIs over a mesh of slots
        mesh_runs = mesh_paths_phase(cases, _write_pages(tmp, pages), buf.getvalue(), card)
        for entry in (k4p, k6):
            entry["launches"] = mesh_runs["counted"][entry["name"]]
            entry["launches_per_page"] = entry["launches"] / 16
            if not entry["launches"]:
                raise AssertionError(f"the mesh path did not launch {entry['name']}")
            for run in mesh_runs["many_shards"]:  # the runs past 8 glyph shards
                by = entry["by_glyph_shards"][str(run["glyph_shards"])]
                by["launches"] = run["launches"][entry["name"]]
                by["launches_per_page"] = by["launches"] / run["pages"]
                if entry is k6:
                    by["fold_launches_per_page"] = run["launches"]["ssd_combine_fold"] / 16
        kernels += [k4p, k6]
    # 19. two processes over gloo, glyph rows spanning them among the meshes
    k4p["spanning"] = multiproc_phase(card)
    # 20. K3 against its plain version and the host replay
    kernels.insert(2, replay_phase(matcher, pages, launches, len(pages), card))
    if no_overlays:
        print(json.dumps({"overlays": no_overlays}), flush=True)
    print(json.dumps({"yardstick": "the correlation alone, not a library call of K1: "
                      "torch.nn.functional.conv2d, f32 inputs in TF32, on phase 3's wave and "
                      "needle groups (the port never calls it)",
                      "kernel": "ncc_sweep", "conv2d_tf32_ms": conv_ms}), flush=True)
    print(json.dumps({"kernels": kernels, "host_native": host_native, "pipeline": pipeline,
                      "banks": banks, "mesh": mesh_runs["runs"],
                      "cli_pages_per_s": len(pages) / wall,
                      "cli_subprocess_pages_per_s": len(pages) / sub_wall,
                      "focr_cli_pages_per_s": focr_pps,
                      "focr_cli_subprocess_pages_per_s": focr_sub_pps,
                      "prop_cli_pages_per_s": prop_pps,
                      "prop_cli_subprocess_pages_per_s": prop_sub_pps}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
