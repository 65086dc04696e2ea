"""The pages x glyphs mesh for multi-card scale-out, on PyTorch.

Counterpart of focr_tpu/parallel/mesh.py. The reference's only parallelism is
a rayon thread pool over page images (main.rs:442-471; ncc.rs:839-847);
focr_tpu maps it onto a 2-D ``jax.sharding.Mesh``. The port keeps the two axes
and focr_tpu's single-controller shape, with no SPMD compiler under it:

  * ``pages``  axis — data parallelism: page batches are dealt over the
    slots; each slot decodes its block, results come back in page order.
  * ``glyphs`` axis — tensor parallelism over the focr template bank: each
    slot of a glyph group scores its slice of the glyphs (K4's partial
    first-minimum), and the group's first slot combines the partials (K6)
    with the reference's first-minimum tie-break: in place when the group
    shares one device (``share_group``), else copied to it first
    (``gather_group``).

In one process a mesh is a [pages, glyphs] grid of *slots*. A slot is a
``torch.device`` with a stream of its own on it. Two slots may name the same
device: that is how a 2x2 mesh runs on one card and how ``["cpu"] * 8`` runs
the CPU tests. Collectives between the slots of one process are events, and
copies where the slots sit on different cards (``share_group``,
``gather_group``), not ``torch.distributed``.

Across processes ``torch.distributed`` over gloo carries host arrays only
(ids, white flags, the ncc matcher's packed hits): every process drives its
own slots and all-gathers what it computed, so each returns the whole result
(``fetch_global``, ``all_gather_bytes``). A glyph group may span processes,
as focr_tpu's may span hosts: the processes that hold a row's later slots
send their keys to the process of its first slot, point to point
(``send_group``, ``recv_group``, ``upload_group``).

``FOCR_TORCH_MESH_DEVICES`` (a comma list, e.g. ``cuda:0,cuda:0,cuda:0,
cuda:0`` or ``cpu,cpu``) replaces ``auto_mesh``'s slot list, which is
otherwise every visible card once. It is the port's stand-in for XLA's
``--xla_force_host_platform_device_count``: a setting for tests and smoke
runs, read by ``mesh_devices`` and nowhere else.
``FOCR_TORCH_DISTRIBUTED=1`` makes ``auto_mesh`` join the process group that
torch's own ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
describe.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from focr_tpu_torch.utils.device import slot_scope

PAGES_AXIS = "pages"
GLYPHS_AXIS = "glyphs"
SLOTS = "slots"  # put_global's other split: over every slot, both axes alike
MESH_DEVICES_ENV = "FOCR_TORCH_MESH_DEVICES"
DISTRIBUTED_ENV = "FOCR_TORCH_DISTRIBUTED"


class Slot:
    """One place of a mesh: a device and, on a card, a stream of its own
    (made when first asked for, so a mesh can be built and compared with no
    card present). ``rank`` is the process that drives it."""

    def __init__(self, device, index: int, rank: int = 0):
        self.device = torch.device(device) if device is not None else None
        self.index = index
        self.rank = rank
        self._stream = None
        self._lock = threading.Lock()

    @property
    def stream(self):
        if self.device.type != "cuda":
            return None
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            return self._stream

    @contextlib.contextmanager
    def context(self):
        """Work issued inside runs on this slot: it is the thread's current
        slot (a kernel launched inside counts for it in SLOT_LAUNCHES) and,
        on a card, its card is the current device (launches, events and
        allocations follow it) and its stream the current stream."""
        with slot_scope(self.index):
            if self.device.type != "cuda":
                yield
                return
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                yield

    def __repr__(self) -> str:
        return f"Slot({self.index}, {self.device}, rank {self.rank})"


class Mesh:
    """A [pages, glyphs] grid of slots, row-major: slot i sits at (i //
    glyphs, i % glyphs), so a glyph group is adjacent devices. ``devices``
    names every slot of every process in rank order, ``ranks`` the process
    that drives each (all 0 in one process); ``rank`` is this process.

    Equal and hashable by value (device names, their order, the owning
    ranks and the axis sizes), as jax.sharding.Mesh is: two equal meshes are
    one key, and a new mesh at a dead one's address is not taken for it."""

    def __init__(self, devices, glyph_shards: int = 1, ranks=None, rank: int = 0):
        names = [str(d) for d in devices]
        n = len(names)
        if n == 0 or glyph_shards < 1 or n % glyph_shards:
            raise ValueError(f"glyph_shards={glyph_shards} must divide device count {n}")
        ranks = [0] * n if ranks is None else [int(r) for r in ranks]
        self.shape = {PAGES_AXIS: n // glyph_shards, GLYPHS_AXIS: glyph_shards}
        self.size = n
        self.rank = rank
        self.slots = [Slot(d if r == rank else None, i, r)
                      for i, (d, r) in enumerate(zip(names, ranks))]
        self.local_slots = [s for s in self.slots if s.rank == rank]
        self.grid = [self.slots[p * glyph_shards : (p + 1) * glyph_shards]
                     for p in range(n // glyph_shards)]
        self.owners = sorted(set(ranks))  # the processes that drive a slot
        self._key = (tuple(names), tuple(ranks), rank, glyph_shards)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices {list(self._key[0])}, ranks {list(self._key[1])})"

    def blocks(self, over: str, n: int) -> list[tuple[Slot, slice]]:
        """How a batch of ``n`` is dealt: (slot, rows) in batch order. Over
        the pages axis a block belongs to its page row (its first glyph slot
        stands for it; every slot of the row gets the same rows); over SLOTS
        every slot has its own. Contiguous blocks of ceil(n / blocks) rows;
        the last ones may be short or empty."""
        heads = [row[0] for row in self.grid] if over == PAGES_AXIS else self.slots
        b = -(-n // len(heads))
        return [(s, slice(min(k * b, n), min((k + 1) * b, n))) for k, s in enumerate(heads)]


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init_distributed(init_method: str, world_size: int, rank: int) -> None:
    """Join ``world_size`` processes over gloo at an explicit address
    (``tcp://host:port``). Gloo because only host arrays cross processes;
    nothing here needs a device collective."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init_method, world_size=world_size, rank=rank)


def maybe_init_distributed() -> bool:
    """Multi-process bring-up for the CLIs: with FOCR_TORCH_DISTRIBUTED=1,
    join the group that MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK describe
    (torch's ``env://``). A no-op for the common single-process case, and when
    the group is already up."""
    if os.environ.get(DISTRIBUTED_ENV) != "1":
        return False
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method="env://")
        atexit.register(shutdown_distributed)  # a CLI process leaves the group as it exits
    return True


def shutdown_distributed() -> None:
    """Leave the process group (a process that exits with it up can hang its
    peers, and pytest's worker with them)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def mesh_devices(device) -> list[str]:
    """The slots ``auto_mesh`` builds on for ``device``'s kind: the comma list
    in FOCR_TORCH_MESH_DEVICES when set (every entry of that kind), else every
    visible card once, or the CPU once."""
    dev = torch.device(device)
    env = os.environ.get(MESH_DEVICES_ENV)
    if env:
        names = [s.strip() for s in env.split(",") if s.strip()]
        if any(torch.device(s).type != dev.type for s in names):
            raise ValueError(f"{MESH_DEVICES_ENV}={env!r} names devices that are not {dev.type}")
        return names
    if dev.type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(dev)]


def page_mesh(devices: list | None = None, glyph_shards: int = 1) -> Mesh:
    """Build the (pages x glyphs) mesh over ``devices``, this process's slots
    (default: mesh_devices of a card when one is visible, else of the CPU).
    ``glyph_shards`` must divide the slot count over every process, as
    focr_tpu's must divide the global device count; the pages axis takes the
    rest. With one slot this is a 1x1 mesh, which every decoder runs
    unpartitioned.

    Under an initialised process group the mesh spans every process's slots
    in rank order, and each process must bring the same number. A glyph
    group may then span processes (parallel/decode.py sends its keys to the
    process of its first slot)."""
    if devices is None:
        devices = mesh_devices("cuda" if torch.cuda.is_available() else "cpu")
    names = [str(d) for d in devices]
    n = len(names)
    world, rank = process_count(), process_index()
    if n == 0 or glyph_shards < 1 or n * world % glyph_shards != 0:
        of = f" ({world} processes of {n})" if world > 1 else ""
        raise ValueError(f"glyph_shards={glyph_shards} must divide device count "
                         f"{n * world}{of}")
    if world == 1:
        return Mesh(names, glyph_shards)
    counts = [int(c[0]) for c in all_gather_host(np.array([n], np.int64))]
    if any(c != n for c in counts):
        raise ValueError(f"every process must bring the same number of slots, got {counts}")
    everyone = [f"rank{r}/{d}" if r != rank else d for r in range(world) for d in names]
    return Mesh(everyone, glyph_shards, [r for r in range(world) for _ in names], rank)


def auto_mesh(device, glyph_shards: int = 1) -> Mesh | None:
    """The CLIs' --mesh auto policy: join the process group if one is
    configured, then return the mesh over every slot (mesh_devices, times the
    processes) when there is more than one; None = the single-card path,
    identical results."""
    maybe_init_distributed()
    names = mesh_devices(device)
    if len(names) * process_count() > 1:
        return page_mesh(names, glyph_shards)
    return None


def all_gather_host(arr: np.ndarray) -> list[np.ndarray]:
    """Every process's ``arr`` (one shape and dtype everywhere), in rank
    order: a fixed-shape gloo all_gather of its bytes."""
    import torch.distributed as dist

    arr = np.ascontiguousarray(arr)
    world = process_count()
    if world == 1 or arr.size == 0:
        return [arr.copy() for _ in range(world)]
    flat = torch.from_numpy(arr.reshape(-1).view(np.uint8))
    outs = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(outs, flat)
    return [o.numpy().view(arr.dtype).reshape(arr.shape) for o in outs]


def all_gather_bytes(payload: bytes) -> list[bytes]:
    """Every process's byte string, in rank order: the lengths all-gathered
    first, then one u8 buffer padded to the longest."""
    lens = [int(a[0]) for a in all_gather_host(np.array([len(payload)], np.int64))]
    buf = np.zeros(max(lens), np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    return [b[:n].tobytes() for b, n in zip(all_gather_host(buf), lens)]


def send_group(dst_rank: int, tag: int, parts: list[tuple[Slot, torch.Tensor]]):
    """Start sending this process's part of a glyph row that spans processes
    to ``dst_rank``, the process of the row's first slot: the slots' tensors
    (one shape) in slot order, copied once to one host buffer [len(parts),
    ...] (pinned, each copy on its slot's stream, the streams waited on),
    over gloo with ``tag``. Returns (the send's work, the buffer): wait on
    the work before the buffer may go."""
    import torch.distributed as dist

    first = parts[0][1]
    if first.device.type == "cuda":
        host = torch.empty((len(parts), *first.shape), dtype=first.dtype, pin_memory=True)
        for j, (slot, t) in enumerate(parts):
            with slot.context():
                host[j].copy_(t, non_blocking=True)
        for slot in {s.index: s for s, _ in parts}.values():
            slot.stream.synchronize()
    else:
        host = torch.stack([t for _, t in parts])
    return dist.isend(host, dst_rank, tag=tag), host


def recv_group(src_rank: int, tag: int, k: int, shape: tuple, dtype: torch.dtype, dst: Slot):
    """Post the receive of ``k`` tensors of ``shape`` that ``src_rank`` sends
    with send_group for a row whose first slot is ``dst``, into a host buffer
    (pinned when dst is on a card). Returns (the receive's work, the
    buffer): wait on the work, then upload_group."""
    import torch.distributed as dist

    host = torch.empty((k, *shape), dtype=dtype, pin_memory=dst.device.type == "cuda")
    return dist.irecv(host, src_rank, tag=tag), host


def upload_group(dst: Slot, host: torch.Tensor) -> list[torch.Tensor]:
    """A received buffer's tensors on ``dst``, uploaded on its stream (so
    dst's work reads them with no other wait), each contiguous."""
    if dst.device.type != "cuda":
        return list(host.unbind(0))
    with dst.context():
        return list(host.to(dst.device, non_blocking=True).unbind(0))


def merge_shards(shards, shape, dtype) -> np.ndarray:
    """Ordered merge of ``(global_index, ndarray)`` shards into the dense
    global array. The global index (a tuple of slices) places each shard at
    its batch position, so the merged result reproduces the reference's
    sort-by-page-order contract (main.rs:468) no matter which slot produced
    which shard; replicated shards overwrite with identical values."""
    out = np.empty(shape, dtype)
    for idx, data in shards:
        out[idx] = data
    return out


@dataclass
class Sharded:
    """A [B, ...] array dealt over a mesh (``over``: PAGES_AXIS or SLOTS):
    this process's blocks as (slot, rows, tensor on the slot), each tensor
    produced on its slot's stream."""

    mesh: Mesh
    shape: tuple
    dtype: torch.dtype
    shards: list[tuple[Slot, slice, torch.Tensor]]
    over: str


def put_global(arr: np.ndarray, mesh: Mesh, over: str = PAGES_AXIS) -> Sharded:
    """Place a host batch on this process's slots by global index. Every
    process holds the FULL host batch (the CLI model: each loads the same
    corpus) and uploads exactly the rows of its own slots, each on that
    slot's stream. Over the pages axis every slot of a page row gets the
    row's block (a glyph group shares its pages); over SLOTS each slot gets
    its own block."""
    n_g = mesh.shape[GLYPHS_AXIS]
    by_head = {s.index: idx for s, idx in mesh.blocks(over, arr.shape[0])}
    shards = []
    for slot in mesh.local_slots:
        idx = by_head[slot.index - slot.index % n_g if over == PAGES_AXIS else slot.index]
        block = torch.from_numpy(np.ascontiguousarray(arr[idx]))
        with slot.context():
            shards.append((slot, idx, block.to(slot.device, non_blocking=True)))
    dtype = shards[0][2].dtype if shards else torch.from_numpy(arr[:0]).dtype
    return Sharded(mesh, tuple(arr.shape), dtype, shards, over)


def gather_group(dst: Slot, parts: list[tuple[Slot, torch.Tensor]]) -> torch.Tensor:
    """Stack one tensor from every slot of a group on ``dst``: [len(parts),
    ...]. Each producer's stream records an event behind its tensor, the
    destination's stream waits for it and then copies, and the source is
    marked as in use by that stream so that the allocator keeps it until the
    copy has run. Two slots on one card make a missing wait a silent race,
    not an error: the order here is the contract."""
    first = parts[0][1]
    with dst.context():
        out = torch.empty((len(parts), *first.shape), dtype=first.dtype, device=dst.device)
    for k, (src, t) in enumerate(parts):
        if dst.device.type != "cuda":
            out[k].copy_(t)
            continue
        with src.context():
            done = torch.cuda.Event()
            done.record()
        with dst.context():
            dst.stream.wait_event(done)
            out[k].copy_(t, non_blocking=True)
        t.record_stream(dst.stream)
    return out


def on_one_device(devices: list[torch.device]) -> bool:
    """Whether a group's slots name one device (the one-card mesh, or cpu
    slots): then the group's tensors are read where they lie (share_group),
    else they are copied to one place (gather_group)."""
    return all(d == devices[0] for d in devices)


def share_group(dst: Slot, parts: list[tuple[Slot, torch.Tensor]]) -> list[torch.Tensor]:
    """The group's tensors, readable in place on ``dst``'s stream: every slot
    of the group on dst's device (on_one_device). Each other producer's
    stream records an event behind its tensor, the destination's stream
    waits for it, and the tensor is marked as in use by that stream so that
    the allocator keeps it until dst's work on it has run. The order is
    gather_group's contract without the copy: on one card a missing wait is
    a silent race, not an error."""
    for src, t in parts:
        if src is dst or dst.device.type != "cuda":
            continue
        with src.context():
            done = torch.cuda.Event()
            done.record()
        dst.stream.wait_event(done)
        t.record_stream(dst.stream)
    return [t for _, t in parts]


def _map_tree(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, t) for k, t in tree.items()}
    return fn(tree)


def fetch_global(tree):
    """Bring a tree of results (Sharded arrays, plain tensors, anything else
    as it is) back to host numpy, sharded ones whole and in batch order.

    One process: every copy is issued first, each on its slot's stream into
    pinned memory, then the streams are waited on once each — one round of
    waits for the whole tree. Several processes: each merges its own blocks
    (merge_shards), the arrays are all-gathered over gloo at their fixed
    global shape, and every block is taken from the process that owns it, so
    every process returns the full global value."""
    pending: list[tuple[Sharded | None, list]] = []
    waits: dict[int, Slot] = {}  # the slots whose streams carry a copy

    def issue(x):
        if isinstance(x, Sharded):
            copies = []
            for slot, idx, t in x.shards:
                if t.device.type == "cuda":
                    with slot.context():
                        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        host.copy_(t, non_blocking=True)
                        waits[slot.index] = slot
                else:
                    host = t
                copies.append((idx, host))
            pending.append((x, copies))
        elif isinstance(x, torch.Tensor):
            pending.append((None, [x.cpu()]))  # the caller's stream: a blocking copy
        else:
            pending.append((None, [x]))
        return len(pending) - 1

    slots_tree = _map_tree(issue, tree)
    for slot in waits.values():
        slot.stream.synchronize()

    def finish(i):
        x, copies = pending[i]
        if x is None:
            v = copies[0]
            return v.numpy() if isinstance(v, torch.Tensor) else v
        dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
        full = merge_shards(((idx, h.numpy()) for idx, h in copies), x.shape, dtype)
        if process_count() > 1:
            theirs = all_gather_host(full)
            for slot, idx in x.mesh.blocks(x.over, x.shape[0]):
                if slot.rank != x.mesh.rank:
                    full[idx] = theirs[slot.rank][idx]
        return full

    return _map_tree(finish, slots_tree)


def pad_batch(pages: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the batch axis up to ``multiple`` (padded pages are all-white, so
    the all-white row skip makes them decode to nothing). Returns (padded,
    original_count)."""
    B = pages.shape[0]
    rem = (-B) % multiple
    if rem == 0:
        return pages, B
    pad = np.full((rem,) + pages.shape[1:], 255, dtype=pages.dtype)
    return np.concatenate([pages, pad], axis=0), B
