"""focr's bank decompression rate: the bytes of the arrays the program counts
as loaded from the bank set (--metrics-json's bank_bytes_loaded) over the
time of its focr_bank_height_load spans, in the traced calls."""

from portbench.lib import spans as S


def read(ctx):
    n, s = S.counter(ctx, "bank_bytes_loaded"), S.seconds(ctx.trace, "focr_bank_height_load")
    return n / s / 1e6 if n and s else None
