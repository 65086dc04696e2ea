"""Observability: profiler traces, named spans, counters and opt-in
structured metrics.

Counterpart of focr_tpu/utils/metrics.py: the stdout-is-data /
stderr-is-diagnostics contract stays, with (a) a `torch.profiler` trace
behind --profile and (b) JSON metrics behind --metrics-json. Neither is on by
default, so default output is byte-identical to the reference contract.

Spans (``span``) are torch.profiler ``record_function`` regions, so a trace
holds them on the same clock as the card's kernels and copies; with no
profiler running a span is a shared null context (well under a microsecond).
Counters (``count``) are always on: one add under a lock.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from dataclasses import dataclass

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

TRACE_NAME = "focr_torch_trace.json"  # the Chrome trace profiling writes into its dir

_NULL_SPAN = contextlib.nullcontext()

COUNTERS: dict[str, int] = {}
_COUNTERS_LOCK = threading.Lock()


def span(name: str):
    """A named region of the host's work: ``record_function(name)`` while a
    torch.profiler trace runs, else a shared null context. The module flag
    reads True on every thread, worker threads started before the trace
    included; where this torch has no such flag, every span records."""
    if getattr(_autograd_profiler, "_is_profiler_enabled", True):
        return record_function(name)
    return _NULL_SPAN


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (from any thread)."""
    with _COUNTERS_LOCK:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


def reset_counters(*names: str) -> None:
    """Forget every counter, and start each of ``names`` at 0."""
    with _COUNTERS_LOCK:
        COUNTERS.clear()
        COUNTERS.update(dict.fromkeys(names, 0))


@dataclass
class MetricsRun:
    seconds: float = 0.0


def _all_threads_config():
    """The profiler's option to record the host-side spans of every thread,
    not only of the one that starts the trace (the ncc pipeline's dispatch
    and fetch stages run on threads of their own); None where this torch has
    no such option. Device activity is recorded from every thread either
    way."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def profiling(profile_dir: str | None = None, cuda: bool = False):
    """With ``profile_dir``, wrap the region in a torch.profiler trace (CPU
    activity always, CUDA activity when ``cuda``: the run's device is a
    card), written into ``profile_dir`` as a Chrome trace on exit; without
    it, nothing."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    trace = profile(activities=acts, experimental_config=_all_threads_config())
    trace.__enter__()
    try:
        yield
    finally:
        trace.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        trace.export_chrome_trace(os.path.join(profile_dir, TRACE_NAME))


@contextlib.contextmanager
def metrics_run(profile_dir: str | None = None, cuda: bool = False):
    """Time a region; optionally wrap it in a torch.profiler trace
    (``profiling``)."""
    run = MetricsRun()
    with profiling(profile_dir, cuda):
        t0 = time.perf_counter()
        try:
            yield run
        finally:
            run.seconds = time.perf_counter() - t0


def write_metrics(path: str, **fields) -> None:
    """One JSON object per run; '-' writes to stderr (stdout stays data-only)."""
    blob = json.dumps(fields, sort_keys=True)
    if path == "-":
        print(blob, file=sys.stderr)
    else:
        with open(path, "w") as f:
            f.write(blob + "\n")
