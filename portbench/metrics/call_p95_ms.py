"""The 95th percentile of the window's call times, each from its start to the
card's synchronise after ``main()`` returns (host clock)."""

import numpy as np


def read(ctx):
    return float(np.percentile([c["seconds"] for c in ctx.calls], 95)) * 1e3
