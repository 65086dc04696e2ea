"""Driving the `focr` CLI (focr_tpu_torch/cli/focr.py) in process: its command
line, its entry point, and the kernel-launch counters its wrappers keep, each
with the name its kernel has in a trace."""

from __future__ import annotations

CLI = "focr_tpu_torch.cli.focr"
# the wrapper's LAUNCHES key -> the kernel function's name in a trace; K4's
# reader (metrics/k4_ssd_roofline.py) takes its name from here
K4 = ("ssd_argmin",)
KERNELS = {"ssd_argmin": r"focr_ssd_argmin_(?:mma|int64)"}


def argv(config: dict, bank: str, paths: list[str], device: str,
         metrics_json: str | None = None) -> list[str]:
    out = ["-i", *paths, *config["argv"], "--grid-bank", bank]
    if device == "cpu":
        out += ["--device", "cpu"]
    if metrics_json is not None:
        out += ["--metrics-json", metrics_json]
    return out


def main(args: list[str]) -> int:
    from focr_tpu_torch.cli.focr import main as cli_main

    return cli_main(args)


def launches() -> dict[str, int]:
    from focr_tpu_torch.ops import ssd_kernels

    return {k: ssd_kernels.LAUNCHES[k] for k in KERNELS}
