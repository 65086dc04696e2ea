"""The program's own spans and counters in a traced run: each span's time in
the traced window, whole or less the spans it holds, and each counter summed
over the traced calls. Where the program has no such span or counter (a
version that predates it), the readers find nothing and give None."""

from __future__ import annotations


def _in_window(trace, name: str) -> list:
    return [s for s in trace.spans if s.name == name and trace.t0 <= s.start <= trace.t1]


def seconds(trace, *names: str) -> float:
    """The time of every span named one of ``names`` in the window."""
    return sum(s.dur for n in names for s in _in_window(trace, n)) / 1e6


def self_seconds(trace, name: str) -> float:
    """The time of the spans named ``name`` in the window, each less the
    union of the spans it holds (its children, on the one thread that the
    program's focr path runs on)."""
    total = 0.0
    for s in _in_window(trace, name):
        inner = sorted((c.start, c.end) for c in trace.spans
                       if c is not s and s.start <= c.start and c.end <= s.end)
        covered, reach = 0.0, s.start
        for a, b in inner:
            a = max(a, reach)
            if b > a:
                covered += b - a
                reach = b
        total += s.dur - covered
    return total / 1e6


def pages(ctx) -> int:
    return sum(len(c["doc"]) for c in ctx.calls)


def per_page_ms(ctx, name: str) -> float | None:
    s = self_seconds(ctx.trace, name)
    return 1e3 * s / pages(ctx) if s else None


def counter(ctx, name: str) -> int | None:
    """The counter ``name`` of --metrics-json summed over the traced calls;
    None where a call reports none."""
    counts = [c.get("metrics", {}).get("counters", {}).get(name) for c in ctx.calls]
    if not counts or any(n is None for n in counts):
        return None
    return sum(counts)
