"""Device selection: explicit, never a silent fallback.

Every device-touching function of the port takes a ``device`` argument; this
module turns a user's name for one into a torch.device and says which card a
measurement ran on.
"""

from __future__ import annotations

import contextlib
import subprocess
import threading
from collections import Counter

import torch

# (mesh slot's index, kernel wrapper's name) -> kernel launches made while
# that slot was the thread's current one (parallel/mesh.py::Slot.context):
# counted by count_launch, where a wrapper has launched, and nowhere else
SLOT_LAUNCHES: Counter = Counter()
_slot_lock = threading.Lock()
_current = threading.local()


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


class launch_stream:
    """The guard every kernel wrapper launches under: ``with
    launch_stream(t) as stream``. ``t``'s card is made the current device for
    the block (the launchers in csrc/ act on the current device: the launch
    itself, cudaFuncSetAttribute, the events a wrapper records), and the raw
    handle of the current stream on that card is given for the launcher's
    ``stream`` argument. With the slots of a mesh on several cards the
    caller's current device is whichever it touched last, so nothing may
    rely on it. Where ``t``'s card is current already (one card: every
    call), nothing is switched: two C calls of torch's (the current device,
    the current raw stream), no stream object and no generator, since a
    wrapper's host time is most of a small launch's cost."""

    __slots__ = ("_t", "_guard")

    def __init__(self, t: torch.Tensor):
        self._t = t
        self._guard = None

    def __enter__(self) -> int:
        idx = self._t.get_device()
        if torch._C._cuda_getDevice() != idx:
            self._guard = torch.cuda.device(idx)
            self._guard.__enter__()
        return torch._C._cuda_getCurrentRawStream(idx)

    def __exit__(self, *exc) -> None:
        if self._guard is not None:
            self._guard.__exit__(*exc)


@contextlib.contextmanager
def slot_scope(index: int):
    """Make mesh slot ``index`` this thread's current slot for the block."""
    before = current_slot()
    _current.slot = index
    try:
        yield
    finally:
        _current.slot = before


def current_slot() -> int | None:
    """The mesh slot this thread is issuing work for, or None outside one."""
    return getattr(_current, "slot", None)


def count_launch(launches: dict, kernel: str) -> None:
    """Called by a kernel wrapper right after it has launched ``kernel``: one
    more in the wrapper's own ``launches`` and, when the thread works for a
    mesh slot, one more for that slot in SLOT_LAUNCHES."""
    launches[kernel] += 1
    slot = current_slot()
    if slot is not None:
        with _slot_lock:
            SLOT_LAUNCHES[(slot, kernel)] += 1


def reset_slot_launches() -> None:
    with _slot_lock:
        SLOT_LAUNCHES.clear()
