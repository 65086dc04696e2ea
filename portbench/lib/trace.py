"""The traced window: calls under the benchmark's own torch.profiler (CPU and
CUDA activity, host spans of every thread), read back from its Chrome trace.

Each call runs inside a ``portbench_call`` span, so the window on the trace's
clock is the first call's start to the last call's end. Device activity is
every kernel, copy and fill on the card; its union over the window is the
busy time. Spans are the program's ``record_function`` regions (and the
benchmark's own), as the trace names them.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass

CALL_SPAN = "portbench_call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Event:
    name: str
    start: float  # us, the trace's clock
    dur: float  # us
    kind: str = ""  # the trace's category

    @property
    def end(self) -> float:
        return self.start + self.dur


def _all_threads_config():
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def profiled(fn, path: str):
    """Run ``fn`` under torch.profiler and write the Chrome trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_all_threads_config())
    with prof:
        fn()
    prof.export_chrome_trace(path)


class Trace:
    def __init__(self, path: str):
        with open(path) as f:
            raw = json.load(f)
        events = raw["traceEvents"] if isinstance(raw, dict) else raw
        self.device: list[Event] = []
        self.spans: list[Event] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ev = Event(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)), cat)
            if cat in DEVICE_CATS:
                self.device.append(ev)
            elif cat == "user_annotation":
                self.spans.append(ev)
        calls = [s for s in self.spans if s.name == CALL_SPAN]
        if not calls:
            raise ValueError("the trace holds no call span")
        self.t0 = min(s.start for s in calls)
        self.t1 = max(s.end for s in calls)
        self.device.sort(key=lambda e: e.start)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernels(self, pattern: str) -> list[Event]:
        """Kernels in the window whose function is named ``pattern``."""
        rx = re.compile(rf"\b{pattern}\b(?!_)")
        return [e for e in self.device if e.kind == "kernel" and rx.search(e.name)
                and self.t0 <= e.start <= self.t1]

    def span_seconds(self, name: str) -> float:
        return sum(s.dur for s in self.spans if s.name == name and self.t0 <= s.start <= self.t1) / 1e6

    def busy(self) -> list[tuple[float, float]]:
        """The union of device activity, clipped to the window."""
        out: list[list[float]] = []
        for e in self.device:
            a, b = max(e.start, self.t0), min(e.end, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        tot: dict[str, float] = defaultdict(float)
        for e in self.device:
            if self.t0 <= e.start <= self.t1:
                tot[short_name(e)] += e.dur / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The device's idle time by what the host was doing: each gap between
        device activity is put under the program spans open at its middle
        (the benchmark's call span alone: the CLI outside any program span;
        none: between calls), summed by that name: [name, seconds]."""
        spans = [s for s in self.spans if s.name != CALL_SPAN]
        calls = [s for s in self.spans if s.name == CALL_SPAN]
        edges = [self.t0] + [t for iv in self.busy() for t in iv] + [self.t1]
        tot: dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            open_ = sorted({s.name for s in spans if s.start <= mid <= s.end})
            if open_:
                name = "+".join(open_)
            elif any(c.start <= mid <= c.end for c in calls):
                name = "cli_outside_program_spans"
            else:
                name = "between_calls"
            tot[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def short_name(e: Event) -> str:
    if e.kind != "kernel":
        return e.name
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", e.name)
    depth, out = 0, []
    for ch in name:  # the name up to its argument list, template arguments kept
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()
