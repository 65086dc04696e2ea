"""Driving the `ncc` CLI (focr_tpu_torch/cli/ncc.py) in process: its command
line, its entry point, the kernel-launch counters its wrappers keep, each
with the name its kernel has in a trace, and the hits its pipeline hands to
post-processing."""

from __future__ import annotations

import contextlib

CLI = "focr_tpu_torch.cli.ncc"
# the wrappers' LAUNCHES keys -> the kernel functions' names in a trace; the
# kernels' readers (metrics/k*_roofline.py) take their names from here
K1 = ("ncc_sweep", "ncc_sweep_mma")
K3 = ("ncc_replay",)
KERNELS = {
    "ncc_sweep": "focr_ncc_sweep_kernel",
    "ncc_sweep_mma": "focr_ncc_sweep_mma_kernel",
    "compact_count": "focr_ncc_count_kernel",
    "compact_hits": "focr_ncc_emit_kernel",
    "ncc_replay": "focr_ncc_replay_kernel",
}


def argv(config: dict, bank: str, paths: list[str], device: str,
         metrics_json: str | None = None) -> list[str]:
    out = ["-i", *paths, *config["argv"], "--needle-bank", bank]
    if device == "cpu":
        out += ["--device", "cpu"]
    if metrics_json is not None:
        out += ["--metrics-json", metrics_json]
    return out


def main(args: list[str]) -> int:
    from focr_tpu_torch.cli.ncc import main as cli_main

    return cli_main(args)


def launches() -> dict[str, int]:
    from focr_tpu_torch.ops import ncc_kernels, replay_kernels

    counts = {**ncc_kernels.LAUNCHES, **replay_kernels.LAUNCHES}
    return {k: counts[k] for k in KERNELS}


@contextlib.contextmanager
def recording():
    """While open, every page's hits that the CLI's text post-processing
    (models/post.py::process_hits_text, called from the collect threads)
    receives are appended to the list yielded: (needle id, x, y, float32
    similarity) arrays, one tuple a page, in no set order."""
    from focr_tpu_torch.models import post

    seen: list[tuple] = []
    inner = post.process_hits_text

    def process_hits_text(hs, *args, **kwargs):
        seen.append((hs.needle_id, hs.x, hs.y, hs.sim))
        return inner(hs, *args, **kwargs)

    post.process_hits_text = process_hits_text
    try:
        yield seen
    finally:
        post.process_hits_text = inner
