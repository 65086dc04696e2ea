"""K3, the ncc exact replay: its bound over the traced window's calls (every
hit the reference finds on their pages), over the device time of its kernels
in the trace."""

from portbench.lib import roofline as R
from portbench.reference.ncc import NeedleFile


def read(ctx):
    drv = ctx.cell.driver
    dev_ms = sum(e.dur for k in drv.K3 for e in ctx.trace.kernels(drv.KERNELS[k])) / 1e3
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
                hits = kept = 0
                for i in doc[s : s + B]:
                    for g in ctx.ref_stats[i]["groups"]:
                        if (g["nh"], g["nw"]) == (nh, nw):
                            hits, kept = hits + g["hits"], kept + g["kept"]
                bound += R.bound_ms(*R.k3_work(B, Hc, Wc, len(ids), nh, nw, hits, kept))[0]
    return 100.0 * bound / dev_ms
