"""The share of the traced window in which no kernel, copy or fill ran on the
card (the union of the trace's device intervals)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
