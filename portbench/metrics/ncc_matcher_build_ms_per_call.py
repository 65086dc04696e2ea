"""Building ncc's matcher a call (the needles' size groups, K1's packing and
the banks' upload to the card): the program's ncc_matcher_build spans less
any span inside them, over the traced calls."""

from portbench.lib import spans as S


def read(ctx):
    s = S.self_seconds(ctx.trace, "ncc_matcher_build")
    return 1e3 * s / len(ctx.calls) if s else None
