"""K1, the ncc sweep: its bound over the traced window's calls, over the
device time of its kernels in the trace."""

from portbench.lib import roofline as R
from portbench.reference.ncc import NeedleFile


def read(ctx):
    drv = ctx.cell.driver
    dev_ms = sum(e.dur for k in drv.K1 for e in ctx.trace.kernels(drv.KERNELS[k])) / 1e3
    if not dev_ms:
        return None
    groups = NeedleFile(ctx.cell.bank).groups
    bound = 0.0
    for c in ctx.calls:
        for _, B, Hc, Wc in R.ncc_waves(ctx.pool[c["doc"]], list(groups)):
            for (nh, nw), ids in groups.items():
                if nh < Hc and nw < Wc:
                    bound += R.bound_ms(*R.k1_work(B, Hc, Wc, len(ids), nh, nw))[0]
    return 100.0 * bound / dev_ms
