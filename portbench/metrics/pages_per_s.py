"""Pages of every call in the window, over the window's time (host clock)."""


def read(ctx):
    return sum(len(c["doc"]) for c in ctx.calls) / ctx.window_s
