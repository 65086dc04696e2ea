"""focr, turning glyph ids into text lines (the program's focr_assemble spans),
less any span inside them, over the traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "focr_assemble")
