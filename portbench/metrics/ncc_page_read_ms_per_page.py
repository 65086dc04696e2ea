"""ncc, reading the call's page files (the program's ncc_page_read span: the
maps, then the pool for pages left), less any span inside them, over the
traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "ncc_page_read")
