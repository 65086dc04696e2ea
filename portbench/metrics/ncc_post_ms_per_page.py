"""ncc's post-processing of each page's hits into text lines, inside the
collect tasks (the program's ncc_post_ns counter: nanoseconds summed over
the collect threads), over the traced calls' pages."""

from portbench.lib import spans as S


def read(ctx):
    ns = S.counter(ctx, "ncc_post_ns")
    return ns / 1e6 / S.pages(ctx) if ns else None
