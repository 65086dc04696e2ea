"""focr's bank cache: the share of crop heights that the program read from
their raw copies in the bank cache (--metrics-json's bank_cache_hits) among
all it loaded from the bank set (bank_cache_hits + bank_cache_misses), in
the traced calls."""

from portbench.lib import spans as S


def read(ctx):
    hits, misses = S.counter(ctx, "bank_cache_hits"), S.counter(ctx, "bank_cache_misses")
    if hits is None or misses is None or not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
