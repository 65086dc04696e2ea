"""Driving the `focr` CLI (focr_tpu_torch/cli/focr.py) in process on a
proportional font: the same command line and entry point as drivers/focr.py,
and the kernel-launch counter of the proportional decoder's scan, K5, with the
name its kernel has in a trace."""

from __future__ import annotations

from portbench.drivers.focr import CLI, argv, main  # noqa: F401

# the wrapper's LAUNCHES key -> the kernel function's name in a trace; K5's
# reader (metrics/k5_prop_roofline.py) takes its name from here
K5 = ("prop_scan",)
KERNELS = {"prop_scan": r"focr_prop_scan_kernel"}


def launches() -> dict[str, int]:
    from focr_tpu_torch.ops import prop_kernels

    return {k: prop_kernels.LAUNCHES[k] for k in KERNELS}
