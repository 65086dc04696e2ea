"""K4, focr's SSD-argmin: its bound over the traced window's calls (their
pages in batches of 16, a launch a row group), over the device time of its
kernels in the trace."""

from portbench.lib import roofline as R
from portbench.reference.focr_grid import GridBankFile


def row_groups(grid: dict, H: int) -> dict[int, int]:
    """Rows of the scan grid by crop height."""
    rows: dict[int, int] = {}
    i = 0
    while (h := min(grid["line_height"], H - min(grid["y"] + i * grid["line_advance"], H))) > 0:
        rows[h] = rows.get(h, 0) + 1
        i += 1
    return rows


def read(ctx):
    drv = ctx.cell.driver
    dev_ms = sum(e.dur for k in drv.K4 for e in ctx.trace.kernels(drv.KERNELS[k])) / 1e3
    if not dev_ms:
        return None
    grid = ctx.cell.config["grid"]
    bank = GridBankFile(ctx.cell.bank)
    H, W = ctx.pool.shape[1:]
    crop_w = max(min(grid["width"], W - min(grid["x"], W)), 0)
    bound = 0.0
    for c in ctx.calls:
        n = len(c["doc"])
        for s in range(0, n, R.FOCR_BATCH):
            B = min(R.FOCR_BATCH, n - s)
            for h, rows in row_groups(grid, H).items():
                C, G, _, win_w = bank.bank(h)[0].shape
                bound += R.bound_ms(*R.k4_work(B, rows, h, crop_w, C, G, win_w))[0]
    return 100.0 * bound / dev_ms
