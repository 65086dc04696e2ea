"""focr's proportional decoder, waiting for K5's glyph ids and copying them
back (the program's focr_prop_fetch spans), less any span inside them, over
the traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "focr_prop_fetch")
