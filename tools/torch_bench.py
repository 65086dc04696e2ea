"""Pages per second of the port's three CLIs on their canonical corpora, on a
CUDA card: the port's counterpart of bench.py, from the committed fixtures.

    python tools/torch_bench.py [--reps N] [--pages P] [--corpus focr|prop|ncc ...]
                                [--device cpu] [--mesh PxG]
    python tools/torch_bench.py --fresh [--corpus ...]

For each corpus (focr, prop, ncc: tests/fixtures/torch_<corpus>_golden.npz,
16 pages written as PGMs, with the saved bank: --grid-bank, --needle-bank):
one warm-up run of the CLI's ``main()`` in-process, whose stdout is held to
the fixture's lines (focr and prop: every line, focr_tpu's; ncc: the golden
pages' lines, and every page's text found in its lines); then N timed runs
(default 11), each one's stdout compared with the warm-up's, and one JSON
line in bench.py's shape (bench.py:485-499, without ``vs_baseline``):

    {"metric": "<corpus>_pages_per_sec", "value": <median>, "unit": "pages/sec",
     "extra": {"spread": [p05, p95], "pages": P, "reps": N, "card": "<name>,
     <power limit>", "bank_load_ms": <median of 3 loads of what the run
     loads>, "device": "cuda" | "cpu", "mesh": "PxG" | "off", "slots": [...],
     "physical_cards": n}}

``--pages P`` (a multiple of 16) repeats the fixture's pages, so that ncc runs
P/8 waves and not two. A wrong stdout raises; nothing is caught. Without a
card the tool fails unless ``--device cpu`` is given (the kernels' plain
versions: for rehearsal, not a measurement of the port).

``--mesh PxG`` runs the CLIs over a mesh of P page rows by G glyph shards
(``--mesh auto`` with ``--glyph-shards G`` for focr and prop; ncc deals its
pages over all P*G slots). The slots are the list in FOCR_TORCH_MESH_DEVICES
when it is set, else the visible cards taken in turn until there are P*G (on
one card: ``cuda:0`` P*G times, each slot with its own stream), and the JSON
line names them and the number of physical cards under them. Without the
option the CLIs run with ``--mesh off``: one card, today's path.

``--fresh`` explains a fresh process's start-up instead: for each corpus it
times a ``python -m focr_tpu_torch.cli.<tool>`` run of the 16 pages, and the
same run's stages in a second fresh process (importing torch, importing the
CLI, the CUDA context, loading the two native libraries, ``main()``), with
``python -X importtime``'s totals for torch and for the package beside them;
one JSON line a corpus.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
# the fonts the fixtures' banks were rendered from; only their names are checked
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
SANS_FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
GRID = ["-x", "45", "-y", "39", "-w", "608", "--line-height", "12", "--line-advance", "15"]
CORPORA = ("focr", "prop", "ncc")
FIXTURE_PAGES = 16


def fixture(corpus: str) -> str:
    return os.path.join(FIXTURES, f"torch_{corpus}_golden.npz")


def cli_argv(corpus: str, paths: list[str], device: str, glyph_shards: int = 0) -> list[str]:
    """``glyph_shards``: 0 runs --mesh off; G > 0 runs --mesh auto, with
    --glyph-shards G where the CLI has the flag."""
    dev = ["--device", "cpu"] if device == "cpu" else []
    if glyph_shards == 0:
        dev += ["--mesh", "off"]
    elif corpus != "ncc":
        dev += ["--mesh", "auto", "--glyph-shards", str(glyph_shards)]
    if corpus == "ncc":
        return ["-i", *paths, "-f", FONT, "-t", "13", "--x-bits", "2", "--needle-bank",
                fixture(corpus), *dev]
    if corpus == "focr":
        return ["-i", *paths, "-f", FONT, "-t", "13", *GRID, "--grid-bank", fixture(corpus), *dev]
    from focr_tpu_torch.fonts.bank import load_grid_bank

    alphabet = load_grid_bank(fixture(corpus))[1]["alphabet"]
    return ["-i", *paths, "-f", SANS_FONT, "-t", "13", "-a", alphabet, *GRID, "--grid-bank",
            fixture(corpus), *dev]


def cli_main(corpus: str):
    if corpus == "ncc":
        from focr_tpu_torch.cli.ncc import main
    else:
        from focr_tpu_torch.cli.focr import main
    return main


@contextlib.contextmanager
def corpus_pages(corpus: str):
    """The corpus' 16 pages as PGM files in a temporary directory, with the
    fixture's lines and truths."""
    import numpy as np

    from focr_tpu_torch.io.images import save_gray

    with np.load(fixture(corpus), allow_pickle=False) as z:
        pages = z["pages"]
        lines = json.loads(str(z["lines"]))
        truths = json.loads(str(z["truths"])) if "truths" in z.files else None
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k, p in enumerate(pages):
            paths.append(os.path.join(tmp, f"page{k:02d}.pgm"))
            save_gray(paths[-1], p)
        yield paths, lines, truths


def run_cli(main, argv) -> tuple[float, str]:
    """(wall seconds, stdout) of one in-process run; the wall ends after the
    card has finished everything the run launched."""
    import torch

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the CLI exited {rc}")
    return wall, buf.getvalue()


def check_warmup(corpus: str, out: str, lines, truths) -> None:
    """The 16-page warm-up's stdout against the fixture."""
    got = out.splitlines()
    if corpus in ("focr", "prop"):
        want = [text for page in lines for text, _ in page]
        if got != want:
            raise AssertionError(f"{corpus}: stdout differs from the fixture's lines")
        return
    from focr_tpu_torch.models.post import line_matches_truth

    golden = [ln for page in lines for ln in page]
    if got[: len(golden)] != golden:
        raise AssertionError("ncc: the golden pages' lines differ from the fixture's")
    # bench.py's acceptance rule: every line of text is found among the lines
    missing = [t for page in truths for t in page
               if not any(line_matches_truth(g, t) for g in got)]
    if missing:
        raise AssertionError(f"ncc: text lines not decoded: {missing[:2]}")


def bank_load_ms(corpus: str) -> float:
    """Median of 3 loads of what a canonical run loads: the needle bank, or
    the two crop heights the grid takes (12 and the 3-pixel bottom row)."""
    from focr_tpu_torch.fonts.bank import load_grid_bank, load_needle_bank

    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        if corpus == "ncc":
            load_needle_bank(fixture(corpus))
        else:
            banks, _ = load_grid_bank(fixture(corpus))
            banks[12], banks[3]
            banks.close()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[1]


def mesh_slots(shape: str, device: str) -> tuple[int, list[str]]:
    """(glyph shards, slot names) for ``--mesh PxG``: the environment's list
    if it is set (it must name P*G slots), else the visible cards in turn."""
    import torch

    from focr_tpu_torch.parallel.mesh import MESH_DEVICES_ENV

    p, g = (int(v) for v in shape.lower().split("x"))
    env = os.environ.get(MESH_DEVICES_ENV)
    if env:
        slots = [s.strip() for s in env.split(",") if s.strip()]
        if len(slots) != p * g:
            raise SystemExit(f"{MESH_DEVICES_ENV} names {len(slots)} slots, --mesh {shape} "
                             f"needs {p * g}")
    elif device == "cpu":
        slots = ["cpu"] * (p * g)
    else:
        slots = [f"cuda:{i % torch.cuda.device_count()}" for i in range(p * g)]
    return g, slots


def bench(corpus: str, reps: int, n_pages: int, device: str, card: str,
          mesh: str | None = None) -> dict:
    import numpy as np

    from focr_tpu_torch.parallel.mesh import MESH_DEVICES_ENV

    main = cli_main(corpus)
    glyph_shards, slots = mesh_slots(mesh, device) if mesh else (0, [])
    if mesh:  # the CLI's auto_mesh reads its slots from the environment
        os.environ[MESH_DEVICES_ENV] = ",".join(slots)
    with corpus_pages(corpus) as (paths, lines, truths):
        _, warm = run_cli(main, cli_argv(corpus, paths, device, glyph_shards))
        check_warmup(corpus, warm, lines, truths)
        want = warm * (n_pages // FIXTURE_PAGES)
        argv = cli_argv(corpus, paths * (n_pages // FIXTURE_PAGES), device, glyph_shards)
        rates = []
        for _ in range(reps):
            wall, out = run_cli(main, argv)
            if out != want:
                raise AssertionError(f"{corpus}: a timed run's stdout differs from the warm-up's")
            rates.append(n_pages / wall)
    p05, med, p95 = np.percentile(rates, [5, 50, 95])
    return {"metric": f"{corpus}_pages_per_sec", "value": float(med), "unit": "pages/sec",
            "extra": {"spread": [float(p05), float(p95)], "pages": n_pages, "reps": reps,
                      "card": card, "bank_load_ms": bank_load_ms(corpus), "device": device,
                      "mesh": mesh or "off", "slots": slots,
                      "physical_cards": len(set(slots)) if mesh else 1}}


_STAGES = """
import json, sys, time
t = [time.perf_counter()]
def lap(): t.append(time.perf_counter()); return t[-1] - t[-2]
out = {}
import torch
out["import_torch_s"] = lap()
sys.path.insert(0, sys.argv[1])
from focr_tpu_torch.cli.%(tool)s import main
from focr_tpu_torch.native import build
out["import_cli_s"] = lap()
torch.zeros(1, device="cuda"); torch.cuda.synchronize()
out["cuda_context_s"] = lap()
build.load(); build.load_host()
out["load_libraries_s"] = lap()
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):
    rc = main(sys.argv[2:])
torch.cuda.synchronize()
out["main_s"] = lap()
out["total_s"] = t[-1] - t[0]
assert rc == 0
print(json.dumps(out))
"""


def _importtime_s(module: str) -> float:
    """Cumulative seconds `python -X importtime` reports for ``module``."""
    res = subprocess.run([sys.executable, "-X", "importtime", "-c", f"import {module}"],
                         cwd=HERE, capture_output=True, text=True, check=True, timeout=600)
    for line in reversed(res.stderr.splitlines()):
        parts = line.split("|")
        if len(parts) == 3 and parts[2].strip() == module:
            return int(parts[1]) / 1e6
    raise RuntimeError(f"no importtime line for {module}")


def fresh(corpus: str, card: str) -> dict:
    """A fresh process's 16-page run, whole and by stage."""
    from focr_tpu_torch.native import build

    build.load(), build.load_host()  # built once, as a second run finds them
    tool = "ncc" if corpus == "ncc" else "focr"
    with corpus_pages(corpus) as (paths, _, _):
        argv = cli_argv(corpus, paths, "cuda")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", f"focr_tpu_torch.cli.{tool}", *argv], cwd=HERE,
                       capture_output=True, text=True, check=True, timeout=600)
        wall = time.perf_counter() - t0
        res = subprocess.run([sys.executable, "-c", _STAGES % {"tool": tool}, HERE, *argv],
                             cwd=HERE, capture_output=True, text=True, check=True, timeout=600)
    stages = json.loads(res.stdout.splitlines()[-1])
    return {"metric": f"{corpus}_fresh_process_s", "value": wall, "unit": "s",
            "extra": {"pages": FIXTURE_PAGES, "stages": stages,
                      "importtime_torch_s": _importtime_s("torch"),
                      "importtime_cli_s": _importtime_s(f"focr_tpu_torch.cli.{tool}"),
                      "bank_load_ms": bank_load_ms(corpus), "card": card}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("--pages", type=int, default=FIXTURE_PAGES)
    ap.add_argument("--corpus", action="append", choices=CORPORA, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="PxG",
                    help="run over a mesh of P page rows by G glyph shards (default: --mesh off)")
    args = ap.parse_args()
    if args.pages <= 0 or args.pages % FIXTURE_PAGES:
        raise SystemExit(f"--pages must be a positive multiple of {FIXTURE_PAGES}")
    sys.path.insert(0, HERE)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("needs a CUDA card (--device cpu rehearses on the plain versions)")
        from focr_tpu_torch.utils.device import card_label

        card = card_label()
    else:
        if args.fresh:
            raise SystemExit("--fresh times the card's start-up: it takes no --device cpu")
        card = "cpu (the kernels' plain versions: not a measurement of the port)"
    for corpus in args.corpus or CORPORA:
        line = fresh(corpus, card) if args.fresh else bench(
            corpus, args.reps, args.pages, args.device, card, args.mesh)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
