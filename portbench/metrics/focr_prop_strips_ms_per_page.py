"""focr's proportional decoder, inverting the pages, stacking the line strips
and testing them for ink on the host (the program's focr_prop_strips spans),
less any span inside them, over the traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "focr_prop_strips")
