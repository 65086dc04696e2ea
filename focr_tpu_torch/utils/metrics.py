"""Observability: profiler traces + opt-in structured metrics.

Counterpart of focr_tpu/utils/metrics.py: the stdout-is-data /
stderr-is-diagnostics contract stays, with (a) a `torch.profiler` trace
behind --profile and (b) JSON metrics behind --metrics-json. Neither is on by
default, so default output is byte-identical to the reference contract.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

TRACE_NAME = "focr_torch_trace.json"  # the Chrome trace metrics_run writes into its dir


@dataclass
class MetricsRun:
    seconds: float = 0.0
    extra: dict = field(default_factory=dict)


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
def metrics_run(profile_dir: str | None = None, cuda: bool = False):
    """Time a decode region; optionally wrap it in a torch.profiler trace
    (CPU activity always, CUDA activity when ``cuda``: the run's device is a
    card), written into ``profile_dir`` as a Chrome trace on exit."""
    run = MetricsRun()
    trace = None
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        trace = profile(activities=acts, experimental_config=_all_threads_config())
        trace.__enter__()
    t0 = time.perf_counter()
    try:
        yield run
    finally:
        run.seconds = time.perf_counter() - t0
        if trace is not None:
            trace.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            trace.export_chrome_trace(os.path.join(profile_dir, TRACE_NAME))


def write_metrics(path: str, **fields) -> None:
    """One JSON object per run; '-' writes to stderr (stdout stays data-only)."""
    blob = json.dumps(fields, sort_keys=True)
    if path == "-":
        print(blob, file=sys.stderr)
    else:
        with open(path, "w") as f:
            f.write(blob + "\n")
