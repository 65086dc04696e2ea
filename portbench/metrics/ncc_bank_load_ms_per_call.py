"""ncc's bank load a call: opening the saved needle bank and checking its
settings against the flags (the program's ncc_bank_load span), over the
traced calls."""

from portbench.lib import spans as S


def read(ctx):
    s = S.seconds(ctx.trace, "ncc_bank_load")
    return 1e3 * s / len(ctx.calls) if s else None
