"""One run of one cell: set-up, the measured (or traced) window, the check of
every call's output against the plain reference, and the result's line.

Everything a cell is made of is found by name: the cell in BENCHMARK.json
names its configuration (the file that entry gives) and its traffic mix
(traffic/<name>.json); the configuration names the CLI that serves it
(drivers/<tool>.py), its plain reference (reference/<name>.py) and its data;
each metric is read by metrics/<name>.py. A new cell, mix or metric is new
files and new entries, and no edit.

The window calls the CLI's ``main(argv)`` in a closed loop, one client and
one document a call: the next call starts when the last has returned and the
card has synchronised. stdout and stderr are captured. Calls start while the
window is open; the window ends when the last one has returned. Where the
driver can record what the program computed underneath its text (ncc's hits
and their float32 similarities), it does so in a few calls drawn from the
seed, and the check holds those to the reference's too.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import io
import json
import os
import shutil
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np

from portbench.lib import pages as P
from portbench.lib import trace as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_SECONDS = 3.0  # the traced window: a few steady calls
TRACES = 4  # traces taken at most, until one holds every kernel the wrappers counted
RECORD_FROM, RECORDED = 4, 2  # the window's calls whose hits are recorded: 2 of its first 4
FORBIDDEN = ("jax", "jaxlib", "flax", "focr_tpu")  # top-level module names


def load_cell(name: str, manifest: dict | None = None) -> SimpleNamespace:
    """The cell ``name`` of BENCHMARK.json with its configuration, traffic mix,
    driver, reference and metrics."""
    if manifest is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            manifest = json.load(f)
    wl = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    entry = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return SimpleNamespace(
        name=name, workload=wl, config=config, traffic=traffic, end_to_end=e2e, per_layer=layer,
        driver=importlib.import_module(f"portbench.drivers.{config['tool']}"),
        reference=importlib.import_module(f"portbench.reference.{config['reference']}"),
        bank=os.path.join(ROOT, config["bank"]),
    )


def make_pool(cell: SimpleNamespace, seed: int) -> np.ndarray:
    """The cell's pool of pages for ``seed``, from its configuration's data."""
    with np.load(os.path.join(ROOT, cell.config["data"]), allow_pickle=False) as z:
        source = z["pages"]
    return P.make_pool(source, cell.config["bands"], cell.traffic, seed)


def recorded_calls(seed: int) -> set[int]:
    """The window's calls (counted from 0, the warm-up left out) in which the
    driver records the program's hits, drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    return {int(i) for i in rng.choice(RECORD_FROM, size=RECORDED, replace=False)}


def forbidden_modules() -> list[str]:
    import sys

    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Runner:
    """The CLI of one cell on the pool's page files."""

    def __init__(self, cell: SimpleNamespace, paths: list[str], device: str, tmp: str,
                 record: set[int] = frozenset()):
        self.cell, self.paths, self.device, self.tmp = cell, paths, device, tmp
        self.cuda = device == "cuda"
        self.record = record if hasattr(cell.driver, "recording") else frozenset()
        self.n = -1  # the next call's number: the warm-up is -1, the window's from 0

    def recording_due(self) -> bool:
        """A call whose hits are to be recorded has not run yet."""
        return bool(self.record) and self.n <= max(self.record)

    def call(self, doc: np.ndarray, metrics: bool = False) -> dict:
        mj = os.path.join(self.tmp, "metrics.json") if metrics else None
        argv = self.cell.driver.argv(self.cell.config, self.cell.bank,
                                     [self.paths[i] for i in doc], self.device, mj)
        out, err = io.StringIO(), io.StringIO()
        rec_ctx = (self.cell.driver.recording() if self.n in self.record
                   else contextlib.nullcontext())
        self.n += 1
        t = time.perf_counter()
        try:
            with (contextlib.redirect_stdout(out), contextlib.redirect_stderr(err),
                  rec_ctx as hits):
                rc = self.cell.driver.main(argv)
        except Exception:  # a call that raises is a failed call; the run goes on
            rc = "raised"
            err.write(traceback.format_exc())
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        rec = {"doc": doc, "seconds": time.perf_counter() - t, "rc": rc,
               "stdout": out.getvalue(), "stderr": err.getvalue()}
        if hits is not None:
            rec["hits"] = hits
        if mj is not None and os.path.exists(mj):
            with open(mj) as f:
                rec["metrics"] = json.load(f)
            os.remove(mj)
        return rec


def traced_window(runner: Runner, docs, seconds: float):
    """Calls under the profiler for ``seconds`` (at least two, and on to the
    last call whose hits are recorded), the trace read
    back, and the kernels the wrappers counted against those the trace holds."""
    from torch.profiler import record_function

    recs: list[dict] = []
    before = runner.cell.driver.launches()

    def body():
        t0 = time.perf_counter()
        while len(recs) < 2 or runner.recording_due() or time.perf_counter() - t0 < seconds:
            with record_function(T.CALL_SPAN):
                recs.append(runner.call(next(docs), metrics=True))

    path = os.path.join(runner.tmp, "trace.json")
    T.profiled(body, path)
    tr = T.Trace(path)
    os.remove(path)
    counted = {k: v - before[k] for k, v in runner.cell.driver.launches().items()}
    held = {k: len(tr.kernels(p)) for k, p in runner.cell.driver.KERNELS.items()}
    return recs, tr, counted, held


def _keys(nid, x, y) -> np.ndarray:
    """A hit's (needle, y, x) as one sortable integer."""
    nid, x, y = (np.asarray(v, np.int64) for v in (nid, x, y))
    return (nid << 32) | (y << 16) | x


def hits_wrong(doc, recorded: list[tuple], ref_hits: dict[int, tuple]) -> int:
    """The hits of one call's pages that the program and the reference do not
    share: each (needle, x, y) that one side has and the other lacks, and each
    shared one whose float32 similarity differs. A recorded page is matched to
    the document's page whose reference hits hold most of it; a page that
    nothing matched counts all its reference hits."""
    left = {int(i): 1 for i in doc}
    ref = {}
    for i in left:
        k = _keys(*ref_hits[i][:3])
        order = np.argsort(k)
        ref[i] = (k[order], np.asarray(ref_hits[i][3], np.float32)[order])
    wrong = 0
    for nid, x, y, sim in recorded:
        k = _keys(nid, x, y)
        probe = k[:: max(1, len(k) // 256)]
        best, score = None, None
        for i, (rk, _) in ref.items():
            pos = np.minimum(np.searchsorted(rk, probe), max(len(rk) - 1, 0))
            found = int((rk[pos] == probe).sum()) if len(rk) else 0
            sc = (left[i] > 0, found, -abs(len(rk) - len(k)))
            if score is None or sc > score:
                best, score = i, sc
        left[best] -= 1
        rk, rs = ref[best]
        shared, a, b = np.intersect1d(k, rk, return_indices=True)
        wrong += len(k) + len(rk) - 2 * len(shared)
        wrong += int((np.asarray(sim, np.float32)[a] != rs[b]).sum())
    wrong += sum(len(ref[i][0]) for i, n in left.items() if n > 0)
    return wrong


def check(calls: list[dict], expected: dict[int, list[str]], limits: dict,
          ref_hits: dict[int, tuple] | None = None) -> dict:
    """The numbers compared, each with its limit: calls whose stdout is not
    the reference's, byte for byte; lines that differ position by position,
    and each line missing or extra; calls that exited non-zero or raised;
    and, where the cell compares them (``hits_wrong`` in its checks), the
    recorded calls' hits that differ from the reference's."""
    wrong = lines = failed = hits = 0
    for c in calls:
        want = [ln for i in c["doc"] for ln in expected[int(i)]]
        got = c["stdout"].split("\n")
        if got and got[-1] == "":
            got.pop()
        if c["stdout"] != "".join(ln + "\n" for ln in want):
            wrong += 1
        lines += sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        failed += c["rc"] != 0
        if "hits" in c and "hits_wrong" in limits:
            hits += hits_wrong(c["doc"], c["hits"], ref_hits)
    values = {"calls_wrong": wrong, "lines_wrong": lines, "calls_failed": failed}
    if "hits_wrong" in limits:
        if not any("hits" in c for c in calls):
            raise RuntimeError("the cell compares hits, and no call recorded any")
        values["hits_wrong"] = hits
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def run_cell(cell: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None, log=print) -> dict:
    """One run; returns the result's line as a dict (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    cuda = device == "cuda"
    log(f"set-up: {time.perf_counter() - t_start:.2f} s to torch and the program imported")
    pool = make_pool(cell, seed)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        runner = Runner(cell, P.write_pool(pool, tmp), device, tmp, recorded_calls(seed))
        log(f"set-up: {time.perf_counter() - t_start:.2f} s to the pool's pages written")
        docs = P.documents(cell.traffic, seed)
        checked = [runner.call(next(docs))]  # the warm-up: every shape the cell uses
        log(f"set-up: {time.perf_counter() - t_start:.2f} s to the warm-up call's end "
            f"({checked[0]['seconds']:.2f} s)")
        ctx = SimpleNamespace(cell=cell, pool=pool, device=device)
        if not trace:
            cpu0 = time.process_time()
            ctx.setup_s = (t0 := time.perf_counter()) - t_start
            calls = []
            while runner.recording_due() or time.perf_counter() - t0 < seconds:
                calls.append(runner.call(next(docs)))
            ctx.window_s = time.perf_counter() - t0
            # the process's CPU time (every thread) beside the window's: where it
            # stays the same while the rate moves, the host ran slower per instruction
            log(f"window: {ctx.window_s:.3f} s, the process's CPU {time.process_time() - cpu0:.3f} s")
            ctx.calls = calls
            checked += calls
        else:
            for k in range(TRACES):
                recs, tr, counted, held = traced_window(runner, docs, min(seconds, TRACE_SECONDS))
                checked += recs
                log(f"trace {k + 1}: kernels counted {counted}, held {held}")
                if held == counted:
                    break
            else:
                # a trace that dropped kernels reads too little device time:
                # the rooflines and the idle share would read high
                raise RuntimeError(f"none of {TRACES} traces held every kernel launched")
            ctx.calls, ctx.trace = recs, tr
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        del runner
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        used = sorted({int(i) for c in checked for i in c["doc"]})
        t_ref = time.perf_counter()
        lines, stats = cell.reference.expected_lines(pool[used], cell.bank, cell.config, device)
        expected = dict(zip(used, lines))
        ctx.ref_stats = dict(zip(used, stats))
        checks = check(checked, expected, cell.config["checks"],
                       {i: s["hits"] for i, s in ctx.ref_stats.items() if "hits" in s})
        log(f"the reference: {len(used)} pages in {time.perf_counter() - t_ref:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = sorted(c["seconds"] for c in ctx.calls)
    log(f"{len(secs)} calls in the window, seconds a call: min {secs[0]:.4f}, median "
        f"{secs[len(secs) // 2]:.4f}, max {secs[-1]:.4f}")
    for c in checked:
        if c["stderr"]:
            log(f"a call wrote to stderr: {c['stderr'][-500:]}")
            break
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.workload["chips"] if cuda else 1, "memory_peak_bytes": peak}
    result = {
        "correct": all(v["value"] <= v["limit"] for v in checks.values()),
        "attempted": len(ctx.calls),
        "failed": sum(c["rc"] != 0 for c in ctx.calls),
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = checks
    return result
