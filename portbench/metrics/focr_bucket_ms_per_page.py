"""focr, stacking the call's pages into one array by shape (the program's
focr_bucket span; the batched path only), less any span inside them, over the
traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "focr_bucket")
