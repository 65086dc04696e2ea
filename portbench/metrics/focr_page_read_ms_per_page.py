"""focr, reading the call's page files (the program's focr_page_read span), less
any span inside them, over the traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "focr_page_read")
