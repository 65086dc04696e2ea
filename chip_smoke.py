#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (focr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the ncc slice at its canonical workload (bench.py's dense corpus:
DejaVu Sans Mono 13, 74 letters, --x-bits 2, 296 needles in a 13x8 and a 13x9
group, 792x662 letter pages of 48 lines x 77 characters), from the golden
fixture tests/fixtures/torch_ncc_golden.npz (made by focr_tpu on a CPU, with
a saved needle bank, so no FreeType is needed). Phases, each of which raises
on failure:

  1. device  — the card's name and power limit; CUDA must be available
  2. build   — nvcc builds csrc/ into focr_tpu_torch/_build/
  3. kernels — on the first 8-page wave, inverted and ink-cropped as the
               matcher does: K1 (ncc_sweep) and K2 (compact_hits) against
               their plain PyTorch versions on the card, exact (tolerance 0),
               then timed with CUDA events
  4. golden  — NccMatcher on the card decodes the fixture's two golden pages
               to focr_tpu's lines, through both kernels
  5. cli     — the ncc CLI on 16 pages: once in-process, with the launch
               counts reset just before and read just after (the counted main
               path), once as `python -m focr_tpu_torch.cli.ncc` (exit 0, same
               stdout); every page's lines are checked against its text

Then one JSON line of the kernels, the card line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_ncc_golden.npz")
# the font the fixture's bank was rendered from; only its name is checked
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
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


def max_abs_err(a, b) -> int:
    """Largest elementwise |a - b| of two integer tensors of one shape."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


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

    from focr_tpu_torch.fonts.bank import load_needle_bank
    from focr_tpu_torch.io.images import save_gray
    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.models.post import line_matches_truth, process_hits_text
    from focr_tpu_torch.models.types import NCC_DEFAULT_ALPHABET, RenderOptions
    from focr_tpu_torch.ops import ncc_kernels as K

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
    for g in groups:
        dg = ncc_model.group_from_numpy(g.bank, g.s_n, g.s2_n, THRESHOLD, dev)
        args = (inv_dev, dg.bank, dg.s_n, dg.s2_n, THRESHOLD)
        mask, rcnt = K.ncc_sweep(*args, terms=dg.terms)
        mask_r, rcnt_r = K.ncc_sweep_reference(*args, terms=dg.terms)
        torch.cuda.synchronize()
        e1 = max(max_abs_err(mask, mask_r), max_abs_err(rcnt, rcnt_r))
        out = K.compact_hits(mask, rcnt)
        out_r = K.compact_hits_reference(mask, rcnt)
        torch.cuda.synchronize()
        e2 = max(max_abs_err(a, b) for a, b in zip(out, out_r))
        n_cand = int(out[3].sum())
        log(f"[kernels] group {g.nw}x{g.nh} T={len(g.needle_ids)}: K1 vs plain max|err| {e1}, "
            f"K2 vs plain max|err| {e2}, {n_cand} candidates, {int(rcnt.sum())} mask bits")
        if e1 or e2 or n_cand == 0:
            raise AssertionError(f"kernel mismatch in group {g.nw}x{g.nh}: K1 {e1}, K2 {e2}")
        err["ncc_sweep"] = max(err["ncc_sweep"], e1)
        err["compact_hits"] = max(err["compact_hits"], e2)
        ts = {
            ("ncc_sweep", False): cuda_ms(lambda: K.ncc_sweep(*args, terms=dg.terms), 10),
            ("ncc_sweep", True): cuda_ms(lambda: K.ncc_sweep_reference(*args, terms=dg.terms), 3),
            ("compact_hits", False): cuda_ms(lambda: K.compact_hits(mask, rcnt), 10),
            ("compact_hits", True): cuda_ms(lambda: K.compact_hits_reference(mask, rcnt), 3),
        }
        for (name, plain), t in ts.items():
            (plain_ms if plain else ms)[name] += t / B
        log(f"[kernels] group {g.nw}x{g.nh} ms/page: K1 {ts['ncc_sweep', False] / B:.4f} "
            f"(plain {ts['ncc_sweep', True] / B:.4f}), K2 {ts['compact_hits', False] / B:.4f} "
            f"(plain {ts['compact_hits', True] / B:.4f})")

    # 4. golden: the matcher on the card reproduces focr_tpu's lines
    ropts = RenderOptions(size=13.0)
    matcher = ncc_model.NccMatcher(
        None, NCC_DEFAULT_ALPHABET, ropts, x_bits=2, threshold=THRESHOLD,
        device=dev, needles=needles,
    )
    K.reset_launches()
    got = matcher.get_hits_many(
        list(pages[: len(golden)]), struct=True,
        post=lambda hs: process_hits_text(hs, 0.95, 5),
    )
    counts = dict(K.LAUNCHES)
    if got != golden:
        raise AssertionError("golden pages: the card's lines differ from focr_tpu's")
    if not all(counts.values()):
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
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = ncc_main(argv)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        if rc != 0 or not all(launches.values()):
            raise AssertionError(f"in-process CLI: rc {rc}, launches {launches}")
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
        f"incl. start-up); launches {launches}; card {card}")

    kernels = [
        {"name": "ncc_sweep", "route": "cuda", "source": "focr_tpu_torch/csrc/ncc_sweep.cu",
         "replaces": "focr_tpu/ops/pallas_ncc.py:98", "launches": launches["ncc_sweep"],
         "max_abs_err": err["ncc_sweep"], "ms": ms["ncc_sweep"],
         "plain_ms": plain_ms["ncc_sweep"]},
        {"name": "compact_hits", "route": "cuda",
         "source": "focr_tpu_torch/csrc/ncc_compact.cu",
         "replaces": "focr_tpu/ops/pallas_ncc.py:436", "launches": launches["compact_hits"],
         "max_abs_err": err["compact_hits"], "ms": ms["compact_hits"],
         "plain_ms": plain_ms["compact_hits"]},
    ]
    print(json.dumps({"kernels": kernels, "cli_pages_per_s": len(pages) / wall,
                      "cli_subprocess_pages_per_s": len(pages) / sub_wall}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
