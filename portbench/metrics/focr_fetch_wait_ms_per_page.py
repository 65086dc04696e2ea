"""focr, waiting for the card's ids and white flags and copying them back (the
program's focr_fetch spans), less any span inside them, over the traced
calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "focr_fetch")
