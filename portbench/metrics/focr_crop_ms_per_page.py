"""focr, cropping the line strips on the host (the program's focr_crop spans),
less any span inside them, over the traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    return S.per_page_ms(ctx, "focr_crop")
