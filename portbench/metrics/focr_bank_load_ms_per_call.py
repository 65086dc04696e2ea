"""focr's bank load a call: opening the saved bank set and checking its
settings (the program's focr_bank_open span) and decompressing each crop
height the decoder asks for (focr_bank_height_load), over the traced calls."""

from portbench.lib import spans as S


def read(ctx):
    s = S.seconds(ctx.trace, "focr_bank_open", "focr_bank_height_load")
    return 1e3 * s / len(ctx.calls) if s else None
