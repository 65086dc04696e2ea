"""Where the port's ncc, focr and prop CLIs spend their time on a CUDA card,
and their pages/s (or the kernels' times alone) against another checkout of
the repo, in turns.

    python tools/torch_cli_profile.py profile [--runs N]            # stage tables
    python tools/torch_cli_profile.py compare OTHER_ROOT [--runs N] # pages/s in turns
    python tools/torch_cli_profile.py kernels OTHER_ROOT            # K1-K4 in turns
    python tools/torch_cli_profile.py replay-warps                  # K3 by warps a segment
    python tools/torch_cli_profile.py sweep-tiles                   # K1 by its launch shape
    python tools/torch_cli_profile.py trace-marker                  # K1 launches a trace holds
    python tools/torch_cli_profile.py ssd-partial-blocks            # K4p by cells a block
    python tools/torch_cli_profile.py pool [depth] [--runs N]       # ncc pool and depth settings
    python tools/torch_cli_profile.py summary OUTPUT_FILE           # medians of a run's lines
    python tools/torch_cli_profile.py pool-summary OUTPUT_FILE      # a pool run by setting

All run the CLIs in-process (``main()``) on the 16 pages of the golden
fixtures (tests/fixtures/torch_{ncc,focr,prop}_golden.npz, written as PGMs),
with the saved banks (``--needle-bank``, ``--grid-bank``), after one warm-up
run.

profile — for each CLI: the wall of N warm runs (default 6), with the ncc
    stages' seconds in each run (dispatch, fetch and collect, each summed
    over the threads that run it: they overlap, so they need not add up to
    the wall); one run under cProfile with the ncc stages in series (pipeline
    depth 0, one collect thread: cProfile follows every thread, so
    overlapping stages would interleave the stacks), reduced to the
    cumulative seconds of the stages named in STAGES (ncc: the dispatch
    stage launches K1, K2 and K3 — ``ncc_replay`` is K3's call, the exact
    replay — and the collect stage only assembles K3's hits, ``_group_hits``);
    one run under torch.profiler, reduced to the device time by kernel and in
    all (device busy = device time / wall; ncc: K1's, K2's and K3's device
    time by name beside it); for focr and prop the bank load by crop height
    (opening the set, then each height's decompression).
compare — runs ``time`` in a fresh process for OTHER_ROOT, this root, this
    root and OTHER_ROOT (in that order), each timing N warm runs of each CLI
    (with the ncc device stage's ms a run: ``_dispatch_wave`` and
    ``_fetch_wave``, or ``_sweep_wave`` in a checkout from before the
    pipeline), and prints each process's pages/s. OTHER_ROOT is a checkout
    of the package (``git archive`` of a commit, or a variant's copy under
    ``_checkout/``), imported in place of this one.
kernels — the same turns, each process timing K1 and K3 (each the call, and
    its device time from a torch.profiler trace), K2 (``compact_hits``:
    everything the main path runs between K1 and the positions) at the ncc
    main path's shapes — the first wave of the ncc fixture, inverted and
    ink-cropped as the matcher does, against both needle groups — and K4 on
    the focr fixture's 16 pages cropped as the decoder crops them (each held
    bit for bit against its plain version first; the best of 5 means of 20
    calls, CUDA events). Each process builds its kernels with the register
    report (stderr).
sweep-tiles — K1's device time (torch.profiler, 20 calls) on the same ncc
    wave, both needle groups, for each launch shape of its wgmma instance in
    SWEEP_TILE_SETTINGS (needles a wgmma, window rows an item, windows a
    column chunk): each shape is a copy of the package with those constants
    edited into csrc/ncc_sweep.cu (and the packer's WG_N), built and timed in
    a process of its own (tools/torch_k1_probes.py), its mask and row counts
    first held bit for bit against the plain version; the fastest in sum over
    the groups is the choice behind the source's WG_N, ROWS and COLS; then,
    as built here, K1's wide instance on a -t 20 wave's shape (2 pages, 74
    needles of 21x13). The band is always double-buffered (two stages): its
    copy is not on the path that waits.
trace-marker — six torch.profiler traces of the ncc CLI's 64-page run for
    each of three places of a K1 marker launch on the caller's stream
    (first, after a fill kernel, last), in turns: the K1 launches each trace
    holds by stream (chip_smoke.py phase 13 reads the caller's stream from
    such a marker).
replay-warps — K3's device time (torch.profiler, 20 calls) on the same ncc
    wave at 1 to ``replay_kernels.MAX_WARPS`` warps a (page, needle) segment,
    each count's output first held bit for bit against the plain version;
    with the segments' candidates (p50, p99, max) by needle group. The
    wrapper gives every segment ``replay_kernels.WARPS``; this is the sweep
    behind that constant.
ssd-partial-blocks — K4p's device time (torch.profiler, 20 calls of a glyph
    row: its shards' calls, white flags from the first) per launch and page
    on a slot's block of the focr fixture (its first 8 pages, both row
    groups, cropped as the decoder crops them), at 2 and 4 glyph shards and
    at 1 (the whole bank as one shard with white flags: K4's work in K4p's
    shape, beside K4's own device time), for each of PARTIAL_BLOCK_SETTINGS
    cells a block, each setting's keys and white flags first held bit for
    bit against the plain version; at the kept setting, the first shard
    (white flags) and a later one alone; and at 2 shards the K4p and K6
    wrappers' host µs a call (200 calls, one sync) by row group, first in the
    fresh process and again after the sweep's traces. The wrapper gives every launch
    ``ssd_kernels.PARTIAL_WARPS``; this is the sweep behind that constant.
pool — the ncc CLI's pages/s at 16 and at 64 pages (the fixture's pages four
    times: eight waves) under each of POOL_SETTINGS (collect threads, the
    pipeline's depth), in four turns whose order rotates and alternates
    (``pool depth``: only the depths, at the first setting's pool, in eight
    turns); ``pool-summary`` reduces a saved run to one line a setting.
summary — reads the JSON lines that ``compare`` or ``kernels`` printed (saved
    to a file) and prints, for each process in order, the median and
    quartiles of every list (pages/s, the stages' ms) and every number.

Every output line is JSON; each names the card (`nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`).
"""

from __future__ import annotations

import contextlib
import cProfile
import importlib.util
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
SANS_FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
GRID = ["-x", "45", "-y", "39", "-w", "608", "--line-height", "12", "--line-advance", "15"]
RUNS = int(sys.argv[sys.argv.index("--runs") + 1]) if "--runs" in sys.argv else 6
# the stages each stage table reports (cumulative seconds of these functions)
STAGES = {
    "ncc": ("load_needle_bank", "load_gray", "group_from_numpy", "get_hits_many",
            "_dispatch_wave", "ncc_sweep", "compact_counts", "compact_emit", "ncc_replay",
            "_fetch_wave", "_collect_page", "_group_hits", "process_hits_text"),
    "focr": ("load_grid_bank", "load_gray_many_isolated", "decode_pages", "_dispatch",
             "ssd_argmin", "_finish"),
    "prop": ("load_grid_bank", "load_gray_many_isolated", "decode_pages", "_decode_prop",
             "prop_scan", "decode_lines"),
}
CLIS = ("ncc", "focr", "prop")


def _fixture(cli: str) -> str:
    return os.path.join(FIXTURES, f"torch_{cli}_golden.npz")


def _argv(cli: str, paths: list[str]) -> list[str]:
    if cli == "ncc":
        return ["-i", *paths, "-f", FONT, "-t", "13", "--x-bits", "2", "--needle-bank",
                _fixture(cli)]
    if cli == "focr":
        return ["-i", *paths, "-f", FONT, "-t", "13", *GRID, "--grid-bank", _fixture(cli)]
    from focr_tpu_torch.fonts.bank import load_grid_bank

    alphabet = load_grid_bank(_fixture(cli))[1]["alphabet"]
    return ["-i", *paths, "-f", SANS_FONT, "-t", "13", "-a", alphabet, *GRID, "--grid-bank",
            _fixture(cli)]


@contextlib.contextmanager
def _cli(cli: str):
    """(main, argv, pages) for one CLI on its 16 fixture pages as PGMs."""
    import numpy as np

    from focr_tpu_torch.io.images import save_gray

    with np.load(_fixture(cli), allow_pickle=False) as z:
        pages = z["pages"]
    if cli == "ncc":
        from focr_tpu_torch.cli.ncc import main
    else:
        from focr_tpu_torch.cli.focr import main
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k, p in enumerate(pages):
            paths.append(os.path.join(tmp, f"page{k:02d}.pgm"))
            save_gray(paths[-1], p)
        yield main, _argv(cli, paths), len(pages)


def _run(main, argv) -> float:
    import torch

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the CLI exited {rc}")
    return wall


def _card() -> str:
    from focr_tpu_torch.utils.device import card_label

    return card_label()


# the ncc device and collect stages, by the method that runs each; a checkout
# from before the pipeline has only _sweep_wave (dispatch and fetch in one)
NCC_STAGES = ("_dispatch_wave", "_fetch_wave", "_collect_page")


@contextlib.contextmanager
def _ncc_stage_timers():
    """Wall seconds spent inside each ncc stage method, summed over the
    threads that run it: yields {stage: [seconds of each run]}; the caller
    appends a 0.0 to every list before each run."""
    import threading

    from focr_tpu_torch.models import ncc as ncc_model

    cls = ncc_model.NccMatcher
    names = [n for n in NCC_STAGES if hasattr(cls, n)]
    if "_dispatch_wave" not in names:
        names.insert(0, "_sweep_wave")
    spent = {n: [] for n in names}
    lock = threading.Lock()
    saved = {n: getattr(cls, n) for n in names}

    def timed(name, fn):
        def wrapper(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                with lock:
                    spent[name][-1] += time.perf_counter() - t0
        return wrapper

    for n, fn in saved.items():
        setattr(cls, n, timed(n, fn))
    try:
        yield spent
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def time_clis(root: str) -> None:
    """pages/s of each CLI, with the ncc stages' ms per run (the device
    stage waits for K1 and K2)."""
    import torch

    import focr_tpu_torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    for cli in CLIS:
        with _cli(cli) as (main, argv, n), _ncc_stage_timers() as spent:
            for v in spent.values():
                v.append(0.0)
            _run(main, argv)
            for v in spent.values():
                v.clear()
            walls = []
            for _ in range(RUNS):
                for v in spent.values():
                    v.append(0.0)
                walls.append(_run(main, argv))
        line = {"root": root, "package": os.path.dirname(focr_tpu_torch.__file__), "cli": cli,
                "pages_per_s": [n / w for w in walls], "card": _card()}
        if cli == "ncc":
            for name, v in spent.items():
                line[f"{name.strip('_')}_ms"] = [t * 1e3 for t in v]
        print(json.dumps(line), flush=True)


def _bank_load_by_height(cli: str) -> dict:
    """ms to open a saved focr bank set and to decompress each crop height."""
    from focr_tpu_torch.fonts.bank import load_grid_bank

    t0 = time.perf_counter()
    banks, _ = load_grid_bank(_fixture(cli))
    out = {"open_ms": (time.perf_counter() - t0) * 1e3, "by_height_ms": {}}
    for h in sorted(banks):
        t0 = time.perf_counter()
        banks[h]
        out["by_height_ms"][h] = (time.perf_counter() - t0) * 1e3
    return out


def _best_ms(fn, per: int) -> float:
    """The best of 5 means of 20 calls, in ms per ``per`` pages (CUDA events)."""
    import torch

    fn()
    best = float("inf")
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / 20 / per)
    return best


def _device_ms(fn, kernel: str, per: int, per_call: int = 1) -> float:
    """ms per ``per`` pages of device time of the kernels whose name holds
    ``kernel``, from a torch.profiler trace of 20 calls, each launching
    ``per_call`` of them: the mean of the kernels the trace holds (it has
    been seen to leave some out) times ``per_call``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
             for e in evs)
    n = sum(e.count for e in evs)
    return us / n * per_call / 1e3 / per if n else 0.0


def _host_us(fn, reps: int = 200) -> float:
    """A wrapper's host µs a call: ``reps`` calls with one sync at the end,
    timed on the host clock up to the last call's return (chip_smoke.py's
    measure)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def _ncc_wave():
    """The ncc fixture's first wave as the matcher hands it to K1, inverted
    and ink-cropped, on the card: (pages [B, Hc, Wc], needle groups, y0,
    x0)."""
    import numpy as np
    import torch

    from focr_tpu_torch.fonts.bank import load_needle_bank
    from focr_tpu_torch.models import ncc as ncc_model

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    with np.load(_fixture("ncc"), allow_pickle=False) as z:
        pages = z["pages"][: ncc_model.WAVE]
    inv = (255 - pages.astype(np.int16)).astype(np.uint8)
    groups = ncc_model._group_needles(load_needle_bank(_fixture("ncc"))[0])
    y0, x0, Hc, Wc = ncc_model._ink_crop(inv, *inv.shape[1:], groups)
    x = torch.from_numpy(np.ascontiguousarray(inv[:, y0 : y0 + Hc, x0 : x0 + Wc])).cuda()
    return x, groups, y0, x0


def time_kernels(root: str) -> None:
    """K1's, K2's and K3's ms/page per needle group and K4's per row group
    for the checkout at ``root``."""
    import numpy as np
    import torch

    from focr_tpu_torch.fonts.bank import load_grid_bank
    from focr_tpu_torch.models import focr as focr_model
    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.models.types import DecodeOptions, RenderOptions
    from focr_tpu_torch.native import build
    from focr_tpu_torch.ops import ncc_kernels as K
    from focr_tpu_torch.ops import ssd_kernels as S

    build.build(report=True)
    x, groups, y0, x0 = _ncc_wave()
    B = x.shape[0]
    out = {"root": root}
    for g in groups:
        dg = ncc_model.group_from_numpy(g.bank, g.s_n, g.s2_n, 0.8, x.device)
        args = (x, dg.bank, dg.s_n, dg.s2_n, 0.8)
        # the bank as the checkout's K1 takes it (PR 12's: fragment order)
        kw = {"packed": dg.packed} if hasattr(dg, "packed") else {"afrag": dg.afrag}
        mask, rcnt = K.ncc_sweep(*args, terms=dg.terms, **kw)
        mask_r, rcnt_r = K.ncc_sweep_reference(*args, terms=dg.terms)
        if not (torch.equal(mask, mask_r) and torch.equal(rcnt, rcnt_r)):
            raise AssertionError(f"K1 differs from its plain version ({g.nw}x{g.nh})")
        if not all(torch.equal(a, b) for a, b in zip(K.compact_hits(mask, rcnt),
                                                    K.compact_hits_reference(mask, rcnt))):
            raise AssertionError(f"K2 differs from its plain version ({g.nw}x{g.nh})")
        name = f"{g.nw}x{g.nh}"
        out[f"k1_{name}"] = _best_ms(lambda: K.ncc_sweep(*args, terms=dg.terms, **kw), B)
        out[f"k1dev_{name}"] = _device_ms(lambda: K.ncc_sweep(*args, terms=dg.terms, **kw),
                                          "focr_ncc_sweep", B)
        out[f"k2_{name}"] = _best_ms(lambda: K.compact_hits(mask, rcnt), B)
        if hasattr(K, "compact_counts"):  # K2's two kernels alone, without the wait
            row_off, head = K.compact_counts(rcnt)
            total = int(K.split_counts(head.cpu(), *rcnt.shape[:2])[0][-1])
            out[f"k2count_{name}"] = _best_ms(lambda: K.compact_counts(rcnt), B)
            out[f"k2emit_{name}"] = _best_ms(lambda: K.compact_emit(mask, rcnt, row_off, total), B)
        if importlib.util.find_spec("focr_tpu_torch.ops.replay_kernels"):  # a checkout with K3
            from focr_tpu_torch.ops import replay_kernels as R

            pos, off, hcnt, _ = K.compact_hits(mask, rcnt)
            tail = (float(np.float32(0.8)), y0, x0, 1024)
            if hasattr(R, "replay_needles"):  # the needles checked once
                k3 = (x, pos, off, hcnt, dg.replay, *tail)
            else:
                k3 = (x, pos, off, hcnt, dg.bank, dg.s_n, dg.s2_n, *tail)
            out[f"k3_{name}"] = _best_ms(lambda: R.ncc_replay(*k3), B)
            out[f"k3dev_{name}"] = _device_ms(lambda: R.ncc_replay(*k3), "focr_ncc_replay", B)
    banks, settings = load_grid_bank(_fixture("focr"))
    with np.load(_fixture("focr"), allow_pickle=False) as z:
        fpages = z["pages"]
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    dec = focr_model.GridDecoder(None, settings["alphabet"], dopts, RenderOptions(size=13.0),
                                 fpages.shape[1:], "cuda", banks=banks)
    for grp, fwd in dec.groups:
        strips = torch.from_numpy(focr_model.crop_strips(
            fpages, grp.ys, grp.crop_h, dec.x0, dec.crop_w)).cuda()
        got = fwd(strips)
        want = S.ssd_argmin_reference(strips, fwd.templates, fwd.tsq, fwd.wx0)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K4 differs from its plain version (h={grp.crop_h})")
        out[f"k4_h{grp.crop_h}"] = _best_ms(lambda: fwd(strips), len(fpages))
    for k in ("k1", "k1dev", "k2", "k2count", "k2emit", "k3", "k3dev", "k4"):
        out[f"{k}_total"] = sum(v for n, v in out.items() if n.startswith(f"{k}_"))
    out["card"] = _card()
    print(json.dumps(out), flush=True)


def replay_warps() -> None:
    """K3's device ms/page on the ncc wave by the warps a segment gets."""
    import numpy as np
    import torch

    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.ops import ncc_kernels as K
    from focr_tpu_torch.ops import replay_kernels as R

    x, groups, y0, x0 = _ncc_wave()
    out = {"warps": R.WARPS, "segments": {}, "device_ms_by_warps": {}}
    kept = R.WARPS
    try:
        for g in groups:
            dg = ncc_model.group_from_numpy(g.bank, g.s_n, g.s2_n, 0.8, x.device)
            mask, rcnt = K.ncc_sweep(x, dg.bank, dg.s_n, dg.s2_n, 0.8, terms=dg.terms,
                                     packed=dg.packed)
            pos, off, hcnt, _ = K.compact_hits(mask, rcnt)
            tail = (float(np.float32(0.8)), y0, x0, 1024)
            want = R.replay_hits(R.ncc_replay_reference(
                x, pos, off, hcnt, dg.bank, dg.s_n, dg.s2_n, *tail), off, hcnt)
            name = f"{g.nw}x{g.nh}"
            lens = hcnt.cpu().numpy()
            out["segments"][name] = {k: float(np.percentile(lens, q))
                                     for k, q in (("p50", 50), ("p99", 99), ("max", 100))}
            by = out["device_ms_by_warps"][name] = {}
            for w in range(1, R.MAX_WARPS + 1):
                R.WARPS = w
                got = R.replay_hits(R.ncc_replay(x, pos, off, hcnt, dg.replay, *tail), off, hcnt)
                if not all(torch.equal(*(v.view(torch.int32) if v.dtype == torch.float32 else v
                                         for v in ab)) for ab in zip(got, want)):
                    raise AssertionError(f"K3 at {w} warps differs from its plain version "
                                         f"({name})")
                by[w] = _device_ms(lambda: R.ncc_replay(x, pos, off, hcnt, dg.replay, *tail),
                                   "focr_ncc_replay", x.shape[0])
    finally:
        R.WARPS = kept
    out["card"] = _card()
    print(json.dumps(out), flush=True)


# (needles a wgmma, window rows an item, windows a column chunk)
SWEEP_TILE_SETTINGS = ((128, 1, 128), (128, 1, 256), (128, 2, 64), (128, 2, 128), (128, 2, 256),
                       (128, 4, 64), (128, 4, 128), (128, 4, 256), (128, 8, 64), (128, 8, 128),
                       (64, 2, 128), (64, 2, 256), (64, 4, 64), (64, 4, 128))
SWEEP_SRC = os.path.join("focr_tpu_torch", "csrc", "ncc_sweep.cu")
KERNELS_PY = os.path.join("focr_tpu_torch", "ops", "ncc_kernels.py")


def _wgmma_asm(n: int) -> str:
    """wgmma_u8's asm statement at m64n{n}k32: n/2 accumulators a thread."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+r"(d[{i}])' for i in range(r))
    return ("    asm volatile(\n"
            f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.u8.u8 {{{regs}}}, '
            f'{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p;\\n}}\\n"\n'
            f"        : {outs}\n"
            '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));')


def _tile_edits(n: int, rows: int, cols: int) -> dict:
    """The edits that rebuild K1 at ``n`` needles a wgmma (the packer's WG_N
    too), ``rows`` window rows an item and ``cols`` windows a column chunk."""
    import re

    def sweep(src: str) -> str:
        for name, v in (("WG_N", n), ("ROWS", rows), ("COLS", cols)):
            src, k = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};", src)
            if k != 1:
                raise RuntimeError(f"sweep-tiles: no single constant {name} in {SWEEP_SRC}")
        a = src.index("    static_assert(WG_N == 128")
        b = src.index('"r"(accumulate));', a) + len('"r"(accumulate));')
        return src[:a] + _wgmma_asm(n) + src[b:]

    def packer(src: str) -> str:
        src, k = re.subn(r"^WG_N = \d+$", f"WG_N = {n}", src, flags=re.M)
        if k != 1:
            raise RuntimeError(f"sweep-tiles: no single WG_N in {KERNELS_PY}")
        return src

    return {SWEEP_SRC: sweep, KERNELS_PY: packer}


def sweep_tiles() -> None:
    """K1's device ms/page on the ncc wave by its wgmma launch shape, each
    shape a rebuilt copy of the package (tools/torch_k1_probes.py)."""
    import re

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import torch_k1_probes as P

    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.ops import ncc_kernels as K

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    with open(os.path.join(HERE, SWEEP_SRC)) as f:
        consts = dict(re.findall(r"constexpr int (ROWS|COLS|WG_N) = (\d+);", f.read()))
    kept = [int(consts[k]) for k in ("WG_N", "ROWS", "COLS")]
    out = {"kept": kept, "device_ms_by_setting": {}}
    names = [f"tiles-n{n}-{rows}x{cols}" for n, rows, cols in SWEEP_TILE_SETTINGS]
    roots = [P.make(name, _tile_edits(*setting))
             for name, setting in zip(names, SWEEP_TILE_SETTINGS)]
    P.build_all(roots)
    for name, root, (n, rows, cols) in zip(names, roots, SWEEP_TILE_SETTINGS):
        res = P.run_measure(name, root, exact=True)
        by = {k[: -len("_device_ms")]: v for k, v in res.items() if k.endswith("_device_ms")}
        by["total"] = sum(by.values())
        out["device_ms_by_setting"][f"n{n}_{rows}x{cols}"] = by
        print(json.dumps({"n": n, "rows": rows, "cols": cols, **by}), flush=True)
    best = min(out["device_ms_by_setting"].items(), key=lambda kv: kv[1]["total"])
    out["fastest"] = best[0]
    # the wide instance as built here: a -t 20 wave, 74 needles of 21x13
    x, _, _, _ = _ncc_wave()
    rng = np.random.default_rng(32)
    imgs = ((rng.random((2, 792, 662)) < 0.15) * rng.integers(0, 256, (2, 792, 662))
            ).astype(np.uint8)
    needles = rng.integers(0, 256, (74, 21, 13), dtype=np.uint8)
    dg = ncc_model.group_from_numpy(needles, needles.reshape(74, -1).astype(np.int64).sum(1),
                                    (needles.reshape(74, -1).astype(np.int64) ** 2).sum(1),
                                    0.8, x.device)
    args = (torch.from_numpy(imgs).cuda(), dg.bank, dg.s_n, dg.s2_n, 0.8)
    got = K.ncc_sweep(*args, terms=dg.terms, packed=dg.packed)
    ref = K.ncc_sweep_reference(*args, terms=dg.terms)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError("K1's wide instance differs from its plain version")
    out["wide_21x13_device_ms"] = _device_ms(
        lambda: K.ncc_sweep(*args, terms=dg.terms, packed=dg.packed), "focr_ncc_sweep", 2)
    out["card"] = _card()
    print(json.dumps(out), flush=True)


TRACE_MARKER_LAYOUTS = ("first", "after-fill", "last")


def trace_marker(traces: int = 6) -> None:
    """How often a torch.profiler trace of the ncc CLI's 64-page run (the
    fixture's pages four times) holds each of its K1 launches, with one more
    K1 launch on the caller's stream as a marker placed three ways: first in
    the trace, after a fill kernel on the caller's stream (and a second fill
    after the run), or last, after the run. ``traces`` traces a layout, the
    layouts in turns; one line a trace: K1 launches by stream."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.ops import ncc_kernels as K

    x, groups, _, _ = _ncc_wave()
    g = groups[0]
    dg = ncc_model.group_from_numpy(g.bank, g.s_n, g.s2_n, 0.8, x.device)
    strip = x[:1, :64]
    pad = torch.empty(1 << 10, dtype=torch.int32, device=x.device)

    def marker():
        K.ncc_sweep(strip, dg.bank, dg.s_n, dg.s2_n, 0.8, terms=dg.terms, packed=dg.packed)

    with _cli("ncc") as (main, argv, n), tempfile.TemporaryDirectory() as tmp:
        av = _argv("ncc", argv[1 : 1 + n] * 4)
        _run(main, av)
        marker()
        trace_path = os.path.join(tmp, "trace.json")
        for turn in range(traces):
            for layout in TRACE_MARKER_LAYOUTS:
                torch.cuda.synchronize()
                with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    if layout == "after-fill":
                        pad.fill_(1)
                        torch.cuda.synchronize()
                    if layout != "last":
                        marker()
                        torch.cuda.synchronize()
                    _run(main, av)
                    if layout == "last":
                        marker()
                    if layout == "after-fill":
                        pad.fill_(2)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(trace_path)
                with open(trace_path) as f:
                    events = json.load(f)["traceEvents"]
                by_stream = {}
                for e in events:
                    if e.get("cat") == "kernel" and "focr_ncc_sweep_kernel" in e.get("name", ""):
                        st = str(e["args"].get("stream"))
                        by_stream[st] = by_stream.get(st, 0) + 1
                print(json.dumps({"layout": layout, "turn": turn, "k1_by_stream": by_stream,
                                  "launched": 1 + len(groups) * -(-n * 4 // ncc_model.WAVE),
                                  "card": _card()}), flush=True)


PARTIAL_BLOCK_SETTINGS = (1, 2, 4, 6, 8, 12, 16)  # cells (warps) a K4p block


def ssd_partial_blocks() -> None:
    """K4p's device ms/page on a slot's 8-page focr block by the cells a
    block, at 1, 2 and 4 glyph shards; K4's beside it."""
    import numpy as np
    import torch

    from focr_tpu_torch.fonts.bank import load_grid_bank
    from focr_tpu_torch.models import focr as focr_model
    from focr_tpu_torch.models.types import DecodeOptions, RenderOptions
    from focr_tpu_torch.ops import ssd_kernels as S
    from focr_tpu_torch.parallel.decode import shard_grid_bank

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    block = 8
    banks, settings = load_grid_bank(_fixture("focr"))
    with np.load(_fixture("focr"), allow_pickle=False) as z:
        pages = z["pages"][:block]
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    dec = focr_model.GridDecoder(None, settings["alphabet"], dopts, RenderOptions(size=13.0),
                                 pages.shape[1:], "cuda", banks=banks)
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a)).cuda()  # noqa: E731
    groups = []  # (strips, K4's step) of each row group
    for grp, fwd in dec.groups:
        groups.append((up(focr_model.crop_strips(pages, grp.ys, grp.crop_h, dec.x0,
                                                 dec.crop_w)), fwd))

    def shard_rows(n_g):
        """(strips, the n_g shards' banks) of each row group."""
        rows = []
        for (x, fwd), bank in zip(groups, dec.banks):
            slices = shard_grid_bank(bank.templates, bank.tsq, n_g)
            Gl = slices[0][0].shape[1]
            rows.append((x, [S.shard_bank(up(t), up(q.astype(np.int64)), fwd.wx0, bank.crop_w,
                                          g * Gl) for g, (t, q) in enumerate(slices)]))
        return rows

    def wrapper_us(rows):
        """K4p's (a later shard) and K6's host µs a call, by row group."""
        res = {"k4p": [], "k6": []}
        for x, shards in rows:
            keys = [S.ssd_argmin_partial(x, sb, white=g == 0)[0] for g, sb in enumerate(shards)]
            res["k4p"].append(_host_us(lambda: S.ssd_argmin_partial(x, shards[-1], white=False)))
            res["k6"].append(_host_us(lambda: S.first_min_combine(keys)))
        return res

    out = {"warps": S.PARTIAL_WARPS, "block_pages": block,
           "host_us_per_call_2_shards": {"fresh": wrapper_us(shard_rows(2))},
           "k4_device_ms": sum(_device_ms(lambda: fwd(x), "focr_ssd_argmin", block)
                               for x, fwd in groups),
           "device_ms_by_warps": {}}
    kept = S.PARTIAL_WARPS
    try:
        for n_g in (1, 2, 4):
            rows = shard_rows(n_g)
            by = out["device_ms_by_warps"][str(n_g)] = {}
            for w in PARTIAL_BLOCK_SETTINGS:
                S.PARTIAL_WARPS = w
                total = 0.0
                for x, shards in rows:
                    def row():
                        return [S.ssd_argmin_partial(x, sb, white=g == 0)
                                for g, sb in enumerate(shards)]

                    for g, ((key, white), sb) in enumerate(zip(row(), shards)):
                        key_r, white_r = S.ssd_argmin_partial_reference(
                            x, sb.templates, sb.tsq, sb.wx0, sb.g0, white=g == 0)
                        if not torch.equal(key, key_r) or (g == 0 and not torch.equal(white,
                                                                                      white_r)):
                            raise AssertionError(f"K4p at {w} cells a block differs from its "
                                                 f"plain version ({n_g} shards, shard {g})")
                    total += _device_ms(row, "focr_ssd_argmin", block, n_g) / n_g
                by[w] = total
            # at the kept setting: the first shard (white flags) and a later one alone
            S.PARTIAL_WARPS = kept
            if n_g > 1:
                out.setdefault("first_shard_device_ms", {})[str(n_g)] = sum(
                    _device_ms(lambda: S.ssd_argmin_partial(x, shards[0]), "focr_ssd_argmin",
                               block) for x, shards in rows)
                out.setdefault("other_shard_device_ms", {})[str(n_g)] = sum(
                    _device_ms(lambda: S.ssd_argmin_partial(x, shards[-1], white=False),
                               "focr_ssd_argmin", block) for x, shards in rows)
    finally:
        S.PARTIAL_WARPS = kept
    out["host_us_per_call_2_shards"]["after_the_traces"] = wrapper_us(shard_rows(2))
    out["card"] = _card()
    print(json.dumps(out), flush=True)


def profile() -> None:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from focr_tpu_torch.models import ncc as ncc_model

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    for cli in CLIS:
        with _cli(cli) as (main, argv, n):
            _run(main, argv)
            with _ncc_stage_timers() as spent:
                walls = []
                for _ in range(RUNS):
                    for v in spent.values():
                        v.append(0.0)
                    walls.append(_run(main, argv))
            threads, depth = ncc_model.COLLECT_THREADS, ncc_model.PIPELINE_DEPTH
            ncc_model.COLLECT_THREADS, ncc_model.PIPELINE_DEPTH = 1, 0
            try:
                prof = cProfile.Profile()
                prof.enable()
                wall_cp = _run(main, argv)
                prof.disable()
            finally:
                ncc_model.COLLECT_THREADS, ncc_model.PIPELINE_DEPTH = threads, depth
            stats = pstats.Stats(prof)
            stages = {name: 0.0 for name in STAGES[cli]}
            for (_, _, func), (_, _, _, cum, _) in stats.stats.items():
                if func in stages:
                    stages[func] += cum
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                          acc_events=True) as tp:
                wall_tp = _run(main, argv)
            dev = {}
            for ev in tp.key_averages():
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = ev.cuda_time_total
                if t and ev.device_type == torch.autograd.DeviceType.CUDA:
                    dev[ev.key] = dev.get(ev.key, 0.0) + t / 1e3
            busy = sum(dev.values())
        by_kernel = {name: sum(v for k, v in dev.items() if f"focr_ncc_{name}_kernel" in k)
                     for name in ("sweep", "count", "emit", "replay")}
        line = {
            "cli": cli, "pages": n, "pages_per_s": [n / w for w in walls],
            "cprofile_wall_s": wall_cp, "stages_cum_s": stages,
            "torch_profiler_wall_ms": wall_tp * 1e3, "device_ms": busy,
            "device_busy": busy / (wall_tp * 1e3),
            "device_ms_by_kernel": dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8]),
            "card": _card()}
        if cli == "ncc":
            line["stage_thread_ms"] = {k.strip("_"): [t * 1e3 for t in v]
                                       for k, v in spent.items()}
            line["device_ms_k1_k2_k3"] = by_kernel
        else:
            line["bank_load"] = _bank_load_by_height(cli)
        print(json.dumps(line), flush=True)


# (collect threads, pipeline depth) to time against each other in ``pool`` mode
POOL_SETTINGS = ((4, 2), (2, 2), (1, 2), (8, 2), (4, 0), (4, 1), (4, 3))
POOL_TURNS = 4


def pool(settings=POOL_SETTINGS, turns: int = POOL_TURNS) -> None:
    """The ncc CLI's pages/s at 16 and at 64 pages under each of
    ``settings``, in ``turns`` turns: each turn starts two settings further
    on, and every other turn runs in reverse, so that no setting keeps one
    place in the order; RUNS warm runs each (models/ncc.py::COLLECT_THREADS
    and PIPELINE_DEPTH are set for the runs and restored)."""
    import torch

    from focr_tpu_torch.models import ncc as ncc_model

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    saved = (ncc_model.COLLECT_THREADS, ncc_model.PIPELINE_DEPTH)
    with _cli("ncc") as (main, argv, n):
        paths = argv[1 : 1 + n]
        for reps in (1, 4) * 6:  # warm both sizes: pools, pinned buffers, the host's clocks
            _run(main, _argv("ncc", paths * reps))
        try:
            for turn in range(turns):
                k = 2 * turn % len(settings)
                order = (settings[k:] + settings[:k])[:: -1 if turn % 2 else 1]
                for threads, depth in order:
                    ncc_model.COLLECT_THREADS, ncc_model.PIPELINE_DEPTH = threads, depth
                    line = {"collect_threads": threads, "depth": depth, "turn": turn,
                            "card": _card()}
                    for reps in (1, 4):
                        av = _argv("ncc", paths * reps)
                        line[f"pages_per_s_{n * reps}"] = [
                            n * reps / _run(main, av) for _ in range(RUNS)]
                    print(json.dumps(line), flush=True)
        finally:
            ncc_model.COLLECT_THREADS, ncc_model.PIPELINE_DEPTH = saved


def pool_summary(path: str) -> None:
    """One line a setting from a saved ``pool`` run: each turn's median
    pages/s at both sizes, and the median over all runs of all turns."""
    import numpy as np

    by: dict = {}
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                r = json.loads(line)
                by.setdefault((r["collect_threads"], r["depth"]), []).append(r)
    for (threads, depth), rows in by.items():
        out = {"collect_threads": threads, "depth": depth}
        for key in sorted(k for k in rows[0] if k.startswith("pages_per_s_")):
            out[key] = {"turn_medians": [float(np.median(r[key])) for r in rows],
                        "median": float(np.median([v for r in rows for v in r[key]]))}
        print(json.dumps(out), flush=True)


def compare(other: str, mode: str) -> None:
    me = os.path.abspath(__file__)
    for root in (other, HERE, HERE, other):
        res = subprocess.run([sys.executable, me, mode, "--root", root, "--runs", str(RUNS)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"timing {root} failed: {res.stderr[-2000:]}")
        sys.stdout.write(res.stdout)
        sys.stdout.flush()
        sys.stderr.write(res.stderr)


def summary(path: str) -> None:
    import numpy as np

    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            out = {k: rec[k] for k in ("root", "cli", "collect_threads", "depth", "turn")
                   if k in rec}
            for k, v in rec.items():
                if isinstance(v, list) and v:
                    q1, med, q3 = np.percentile(v, [25, 50, 75])
                    out[k] = {"median": med, "q1": q1, "q3": q3}
                elif isinstance(v, float):
                    out[k] = v
            print(json.dumps(out), flush=True)


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "profile"
    if mode in ("time", "kernels-time"):
        root = os.path.abspath(sys.argv[sys.argv.index("--root") + 1] if "--root" in sys.argv
                               else HERE)
        sys.path.insert(0, root)
        (time_clis if mode == "time" else time_kernels)(root)
    elif mode == "summary":
        summary(sys.argv[2])
    elif mode == "pool-summary":
        pool_summary(sys.argv[2])
    elif mode == "pool":
        sys.path.insert(0, HERE)
        if "depth" in sys.argv[2:]:  # the depths alone, at the kept pool, more turns
            kept = POOL_SETTINGS[0][0]
            pool(tuple(s for s in POOL_SETTINGS if s[0] == kept), 2 * POOL_TURNS)
        else:
            pool()
    elif mode == "replay-warps":
        sys.path.insert(0, HERE)
        replay_warps()
    elif mode == "sweep-tiles":
        sys.path.insert(0, HERE)
        sweep_tiles()
    elif mode == "trace-marker":
        sys.path.insert(0, HERE)
        trace_marker()
    elif mode == "ssd-partial-blocks":
        sys.path.insert(0, HERE)
        ssd_partial_blocks()
    elif mode in ("compare", "kernels"):
        compare(os.path.abspath(sys.argv[2]), "time" if mode == "compare" else "kernels-time")
    else:
        sys.path.insert(0, HERE)
        profile()
    return 0


if __name__ == "__main__":
    sys.exit(main())
