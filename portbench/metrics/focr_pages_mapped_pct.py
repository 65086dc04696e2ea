"""focr's page reads: the share of page files that the program mapped
read-only instead of reading them (--metrics-json's pages_mapped) among all
it loaded (pages_mapped + pages_decoded), in the traced calls."""

from portbench.lib import spans as S


def read(ctx):
    mapped, decoded = S.counter(ctx, "pages_mapped"), S.counter(ctx, "pages_decoded")
    if mapped is None or decoded is None or not mapped + decoded:
        return None
    return 100.0 * mapped / (mapped + decoded)
