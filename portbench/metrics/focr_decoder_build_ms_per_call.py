"""Building focr's grid decoder a call (the device templates' upload and K4's
fragment packing): the program's focr_decoder_build spans less the height
loads inside them, over the traced calls."""

from portbench.lib import spans as S


def read(ctx):
    s = S.self_seconds(ctx.trace, "focr_decoder_build")
    return 1e3 * s / len(ctx.calls) if s else None
