"""Where the port's ncc, focr and prop CLIs spend their time on a CUDA card,
and their pages/s (or the kernels' times alone) against another checkout of
the repo, in turns.

    python tools/torch_cli_profile.py profile [--runs N]            # stage tables
    python tools/torch_cli_profile.py compare OTHER_ROOT [--runs N] # pages/s in turns
    python tools/torch_cli_profile.py kernels OTHER_ROOT            # K1, K2, K4 in turns
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
kernels — the same turns, each process timing K1 and K2 (``compact_hits``:
    everything the main path runs between K1 and the positions) at the ncc
    main path's shapes — the first wave of the ncc fixture, inverted and
    ink-cropped as the matcher does, against both needle groups — and K4 on
    the focr fixture's 16 pages cropped as the decoder crops them (each held
    bit for bit against its plain version first; the best of 5 means of 20
    calls, CUDA events). Each process builds its kernels with the register
    report (stderr).
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


def time_kernels(root: str) -> None:
    """K1's and K2's ms/page per needle group and K4's per row group for the
    checkout at ``root``."""
    import numpy as np
    import torch

    from focr_tpu_torch.fonts.bank import load_grid_bank, load_needle_bank
    from focr_tpu_torch.models import focr as focr_model
    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.models.types import DecodeOptions, RenderOptions
    from focr_tpu_torch.native import build
    from focr_tpu_torch.ops import ncc_kernels as K
    from focr_tpu_torch.ops import ssd_kernels as S

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    build.build(report=True)
    with np.load(_fixture("ncc"), allow_pickle=False) as z:
        pages = z["pages"][: ncc_model.WAVE]
    inv = (255 - pages.astype(np.int16)).astype(np.uint8)
    groups = ncc_model._group_needles(load_needle_bank(_fixture("ncc"))[0])
    y0, x0, Hc, Wc = ncc_model._ink_crop(inv, *inv.shape[1:], groups)
    x = torch.from_numpy(np.ascontiguousarray(inv[:, y0 : y0 + Hc, x0 : x0 + Wc])).cuda()
    out = {"root": root}
    for g in groups:
        dg = ncc_model.group_from_numpy(g.bank, g.s_n, g.s2_n, 0.8, x.device)
        args = (x, dg.bank, dg.s_n, dg.s2_n, 0.8)
        mask, rcnt = K.ncc_sweep(*args, terms=dg.terms, afrag=dg.afrag)
        mask_r, rcnt_r = K.ncc_sweep_reference(*args, terms=dg.terms)
        if not (torch.equal(mask, mask_r) and torch.equal(rcnt, rcnt_r)):
            raise AssertionError(f"K1 differs from its plain version ({g.nw}x{g.nh})")
        if not all(torch.equal(a, b) for a, b in zip(K.compact_hits(mask, rcnt),
                                                    K.compact_hits_reference(mask, rcnt))):
            raise AssertionError(f"K2 differs from its plain version ({g.nw}x{g.nh})")
        name = f"{g.nw}x{g.nh}"
        out[f"k1_{name}"] = _best_ms(lambda: K.ncc_sweep(*args, terms=dg.terms, afrag=dg.afrag),
                                     len(pages))
        out[f"k2_{name}"] = _best_ms(lambda: K.compact_hits(mask, rcnt), len(pages))
        if hasattr(K, "compact_counts"):  # K2's two kernels alone, without the wait
            row_off, head = K.compact_counts(rcnt)
            total = int(K.split_counts(head.cpu(), *rcnt.shape[:2])[0][-1])
            out[f"k2count_{name}"] = _best_ms(lambda: K.compact_counts(rcnt), len(pages))
            out[f"k2emit_{name}"] = _best_ms(
                lambda: K.compact_emit(mask, rcnt, row_off, total), len(pages))
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
    for k in ("k1", "k2", "k2count", "k2emit", "k4"):
        out[f"{k}_total"] = sum(v for n, v in out.items() if n.startswith(f"{k}_"))
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
    elif mode in ("compare", "kernels"):
        compare(os.path.abspath(sys.argv[2]), "time" if mode == "compare" else "kernels-time")
    else:
        sys.path.insert(0, HERE)
        profile()
    return 0


if __name__ == "__main__":
    sys.exit(main())
