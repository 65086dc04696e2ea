#!/usr/bin/env python3
"""The control of a cell's `correct`: the plain reference put in the program's
place, computed with one of its guarantees broken (or at a lower precision),
held to the cell's check on the documents a run of each seed would send.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--calls N]
                                 [--variant guarantee|precision] [--device cuda|cpu]

Prints, for each seed, the numbers the cell compares and their limits, as a
JSON line; the control has failed the check where a number passes its limit.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_checks(cell, seed: int, calls: int, variant: str, device: str) -> dict:
    """The cell's check of the warm-up's and ``calls`` window documents of
    ``seed``, each answered by the reference's ``variant`` in place of the
    program: its stdout, and its hits in the calls whose hits a run records."""
    from portbench import harness
    from portbench.lib import pages as P

    pool = harness.make_pool(cell, seed)
    docs = P.documents(cell.traffic, seed)
    doc_list = [next(docs) for _ in range(calls + 1)]
    used = sorted({int(i) for d in doc_list for i in d})
    ref = cell.reference
    want, want_stats = ref.expected_lines(pool[used], cell.bank, cell.config, device)
    got, got_stats = ref.expected_lines(pool[used], cell.bank, cell.config, device,
                                        variant=variant)
    answer = dict(zip(used, got))
    got_hits = {i: s["hits"] for i, s in zip(used, got_stats) if "hits" in s}
    recorded = harness.recorded_calls(seed)
    answered = []
    for n, d in enumerate(doc_list, start=-1):  # the warm-up is call -1
        rec = {"doc": d, "rc": 0,
               "stdout": "".join(ln + "\n" for i in d for ln in answer[int(i)])}
        if n in recorded and got_hits:
            rec["hits"] = [got_hits[int(i)] for i in d]
        answered.append(rec)
    return harness.check(answered, dict(zip(used, want)), cell.config["checks"],
                         {i: s["hits"] for i, s in zip(used, want_stats) if "hits" in s})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--calls", type=int, default=8, help="documents a seed")
    ap.add_argument("--variant", choices=["guarantee", "precision"], default="guarantee")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = control_checks(cell, seed, args.calls, args.variant, args.device)
        failed = any(c["value"] > c["limit"] for c in checks.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "variant": args.variant,
                          "calls": args.calls, "control_failed": failed, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
