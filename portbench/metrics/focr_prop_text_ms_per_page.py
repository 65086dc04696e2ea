"""focr's proportional decoder, trimming the ids at the end marker and
turning them into text lines in row order (the program's focr_prop_text
spans), less any span inside them, over the traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "focr_prop_text")
