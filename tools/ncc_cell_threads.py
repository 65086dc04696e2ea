#!/usr/bin/env python3
"""Where an ncc cell's host CPU goes: one untraced run of a benchmark cell, as
`portbench/run.py --trace 0` makes it, with the window's CPU time read per
thread besides its pages a second.

    python3 tools/ncc_cell_threads.py --workload ncc-b64-mono13.doc64 --seed <n>
        [--seconds 51] [--out FILE]

From the root of a checkout, on a machine with a CUDA card. The pipeline's
worker threads live for one call each, so each is read as it ends
(`time.thread_time()`), by the stage it served (dispatch, fetch, collect or
another pool); the threads alive through the window (the main thread, the
CUDA driver's, torch's) are read from /proc/self/task/*/stat after the
window's first and last calls. The card's waits are the program's
HOST_WAITS over the window's waves. Prints one JSON line; --out appends it to
FILE too.
"""

import os
import time

T_START = time.perf_counter()
os.environ["OMP_NUM_THREADS"] = "1"  # as portbench/run.py sets it, before numpy and torch

import argparse  # noqa: E402
import concurrent.futures.thread as cft  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICK = os.sysconf("SC_CLK_TCK")


def task_cpu() -> dict[str, float]:
    """CPU seconds (user + system) of each live thread of this process, by
    ``name:tid``."""
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        name = stat[stat.index("(") + 1 : stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2 :].split()
        out[f"{name}:{tid}"] = (int(fields[11]) + int(fields[12])) / TICK
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="ncc-b64-mono13.doc64")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from focr_tpu_torch.models import ncc as ncc_model
    from portbench import harness

    # each worker thread's role, marked by the stage it runs, and its CPU at its end
    roles: dict[int, str] = {}
    ended: list[tuple[float, str, float]] = []  # (end time, role, thread CPU seconds)
    lock = threading.Lock()

    def marking(role, fn):
        def wrapped(*a, **k):
            roles[threading.get_ident()] = role
            return fn(*a, **k)
        return wrapped

    M = ncc_model.NccMatcher
    M._dispatch_wave = marking("dispatch", M._dispatch_wave)
    M._fetch_wave = marking("fetch", M._fetch_wave)
    M._collect_page = marking("collect", M._collect_page)
    worker = cft._worker

    def _worker(*a, **k):
        try:
            worker(*a, **k)
        finally:
            with lock:
                ended.append((time.perf_counter(),
                              roles.pop(threading.get_ident(), "other pool"),
                              time.thread_time()))

    cft._worker = _worker

    # the window's edges: after the warm-up call and after the last call
    marks: list[tuple[float, dict, int, int, float]] = []
    call = harness.Runner.call

    def timed_call(self, doc, metrics=False):
        rec = call(self, doc, metrics)
        marks.append((time.perf_counter(), task_cpu(), ncc_model.HOST_WAITS, len(doc),
                      time.process_time()))
        return rec

    harness.Runner.call = timed_call
    cell = harness.load_cell(args.workload)
    res = harness.run_cell(cell, args.seed, args.seconds, False, "cuda", T_START,
                           lambda m: print(f"[threads] {m}", file=sys.stderr, flush=True))
    (t_a, cpu_a, w_a, _, p_a), (t_b, cpu_b, w_b, _, p_b) = marks[0], marks[-1]
    pages = sum(m[3] for m in marks[1:])
    per_role: dict[str, float] = {}
    for t, role, sec in ended:
        if t_a < t <= t_b:
            per_role[role] = per_role.get(role, 0.0) + sec
    live = {k: round(cpu_b[k] - cpu_a[k], 3) for k in cpu_b if k in cpu_a}
    card = torch.cuda.get_device_name(0)
    line = {
        "workload": args.workload, "seed": args.seed,
        "collect_threads": ncc_model.COLLECT_THREADS,
        "pages_per_s": res["metrics"]["pages_per_s"]["value"],
        "setup_s": res["metrics"]["setup_s"]["value"],
        "correct": res["correct"], "window_s": round(t_b - t_a, 3),
        "process_cpu_s": round(p_b - p_a, 3),
        "threads_cpu_s": round(sum(per_role.values()) + sum(live.values()), 3),
        "worker_cpu_s": {k: round(v, 3) for k, v in sorted(per_role.items())},
        "live_cpu_s": dict(sorted(live.items(), key=lambda kv: -kv[1])[:8]),
        "host_waits_per_wave": (w_b - w_a) / max(1, pages / ncc_model.WAVE),
        "checks": {k: v["value"] for k, v in res["checks"].items()},
        "card": card,
    }
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
