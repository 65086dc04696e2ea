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
