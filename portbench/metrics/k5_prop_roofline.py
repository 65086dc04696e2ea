"""K5, focr's proportional cursor scan: its bound over the traced window's
calls (their pages in batches of 16, a launch a row group that holds ink, the
steps the reference's scan takes on each line), over the device time of its
kernels in the trace."""

from portbench.lib import roofline as R
from portbench.lib.prop_roofline import k5_work
from portbench.reference.focr_prop import PropBankFile


def read(ctx):
    drv = ctx.cell.driver
    dev_ms = sum(e.dur for k in drv.K5 for e in ctx.trace.kernels(drv.KERNELS[k])) / 1e3
    if not dev_ms:
        return None
    grid = ctx.cell.config["grid"]
    bank = PropBankFile(ctx.cell.bank)
    W = ctx.pool.shape[2]
    crop_w = max(min(grid["width"], W - min(grid["x"], W)), 0)
    bound = 0.0
    for c in ctx.calls:
        doc = [int(i) for i in c["doc"]]
        for s in range(0, len(doc), R.FOCR_BATCH):
            groups: dict[int, list[int]] = {}  # crop height -> [lines, steps]
            for i in doc[s : s + R.FOCR_BATCH]:
                for _, h, steps in ctx.ref_stats[i]["rows"]:
                    g = groups.setdefault(h, [0, 0])
                    g[0], g[1] = g[0] + 1, g[1] + steps
            for h, (L, steps) in groups.items():
                G, _, _, wbank = bank.bank(h)[0].shape
                work = k5_work(L, h, crop_w, G, wbank, bank.n_steps(h, crop_w), steps)
                bound += R.bound_ms(*work)[0]
    return 100.0 * bound / dev_ms
