"""K2, the ncc compaction: its bound over the traced window's calls (the mask
rows that hold the reference's hits, every row count, the outputs), over the
device time of its count and emit kernels in the trace."""

from portbench.lib import roofline as R
from portbench.lib.ncc_compact_roofline import group_rows, k2_work
from portbench.reference.ncc import NeedleFile


def read(ctx):
    drv = ctx.cell.driver
    dev_ms = sum(e.dur for k in ("compact_count", "compact_hits")
                 for e in ctx.trace.kernels(drv.KERNELS[k])) / 1e3
    if not dev_ms:
        return None
    groups = NeedleFile(ctx.cell.bank).groups
    bound = 0.0
    for c in ctx.calls:
        doc = [int(i) for i in c["doc"]]
        for s, B, Hc, Wc in R.ncc_waves(ctx.pool[doc], list(groups)):
            for (nh, nw), ids in groups.items():
                if not (nh < Hc and nw < Wc):
                    continue
                rows = cands = 0
                for i in doc[s : s + B]:
                    r, n = group_rows(ctx.ref_stats[i]["hits"], ids)
                    rows, cands = rows + r, cands + n
                bound += R.bound_ms(*k2_work(B, Hc, Wc, len(ids), nh, nw, rows, cands))[0]
    return 100.0 * bound / dev_ms
