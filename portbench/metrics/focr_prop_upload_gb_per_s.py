"""focr's proportional decoder's strip upload rate: the bytes the program
counts as uploaded (--metrics-json's strip_bytes_uploaded) over the time of
its focr_prop_upload spans, in the traced calls."""

from portbench.lib import spans as S


def read(ctx):
    n, s = S.counter(ctx, "strip_bytes_uploaded"), S.seconds(ctx.trace, "focr_prop_upload")
    return n / s / 1e9 if n and s else None
