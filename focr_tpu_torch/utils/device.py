"""Device selection: explicit, never a silent fallback.

Every device-touching function of the port takes a ``device`` argument; this
module turns a user's name for one into a torch.device and says which card a
measurement ran on.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) needs a visible CUDA card and raises
    without one; ``"cpu"`` runs the kernels' plain PyTorch versions and must
    be asked for by name."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False "
                "(use --device cpu to run the plain PyTorch versions)"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r}: expected cuda or cpu")


def card_label() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (a card set below its
    maximum power runs slower: every measurement carries this label)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def note_single_card(tool: str, mesh: str, device: torch.device) -> None:
    """The CLIs' ``--mesh auto`` policy on this package: with one visible
    card it does nothing, as focr_tpu's auto_mesh does on one device
    (focr_tpu/parallel/mesh.py:51-58). With more than one card visible the
    run still takes one card and says so in one stderr line: the multi-card
    path is not part of this package yet."""
    if mesh == "auto" and device.type == "cuda" and torch.cuda.device_count() > 1:
        import sys

        print(f"{tool}: {torch.cuda.device_count()} CUDA cards are visible; this run uses "
              f"one ({device}), sharding over cards is not available yet", file=sys.stderr)
