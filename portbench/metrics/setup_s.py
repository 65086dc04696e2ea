"""The run's set-up: from the harness's start (the interpreter's imports and
the program's, the kernel libraries' load, the pool's pages, the warm-up call)
to the window's start (host clock)."""


def read(ctx):
    return ctx.setup_s
