"""ncc's dispatch stage (invert, crop, upload, K1, K2, K3): the program's
focr_ncc_dispatch_wave spans in the trace, over the traced calls' pages."""


def read(ctx):
    s = ctx.trace.span_seconds("focr_ncc_dispatch_wave")
    return 1e3 * s / sum(len(c["doc"]) for c in ctx.calls) if s else None
