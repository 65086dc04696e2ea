"""focr, copying the strips to the card (the program's focr_upload spans), less
any span inside them, over the traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "focr_upload")
