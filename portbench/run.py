#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for. With --trace 0 the run measures the cell's end-to-end metrics over a
window of --seconds; with --trace 1 it traces a few steady calls and reads the
cell's per-layer metrics. Either way every call's stdout is checked against
the plain reference; the numbers compared and their limits are the last lines
on stderr, and the result is the last line on stdout, one JSON object.

It exits non-zero and prints no result without the cards, without the
program (focr_tpu_torch), or if JAX or focr_tpu has been loaded.
"""

import os
import time

T_START = time.perf_counter()
# One OpenMP thread for the process's CPU-side tensor and BLAS work, a noise
# control and no deployment setting: on the card's shared 8-core host, torch's
# pool of 8 spinning threads spread a cell's runs by ~30% where one thread
# spread them by ~11%. The CLI with its default threads is slower in some
# cells (PERF.md §2 gives both); no claim rests on that difference. Set
# before numpy and torch are imported, which read it once.
os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    sys.path.insert(0, ROOT)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"error: {args.workload} needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    importlib.import_module(cell.driver.CLI)  # the program under test must be here
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_START, log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"error: modules loaded that the port must not load: {bad}")
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"card: {card}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
