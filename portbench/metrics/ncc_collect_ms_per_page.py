"""ncc's collect stage (assembly in reference order and post-processing):
the program's focr_ncc_collect_wave spans in the trace, over the traced
calls' pages."""


def read(ctx):
    s = ctx.trace.span_seconds("focr_ncc_collect_wave")
    return 1e3 * s / sum(len(c["doc"]) for c in ctx.calls) if s else None
