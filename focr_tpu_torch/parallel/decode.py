"""The mesh-sharded focr grid step, on PyTorch.

Counterpart of focr_tpu/parallel/decode.py. Replaces the reference's rayon
page fan-out (main.rs:442-471) with a (pages x glyphs) mesh of slots
(parallel/mesh.py):

  * pages axis: each page row of the mesh takes a block of the page batch.
  * glyphs axis: the template bank's glyph dimension is sliced over the
    slots of a row. Each slot runs K4p (ops/ssd_kernels.py::
    ssd_argmin_partial) on its slice: one packed key a cell, the minimum
    metric above the bank's glyph number (only the row's first slot also
    gives the white flags, the only ones read). The row's first slot runs K6
    (first_min_combine), the smallest key over the shards, and keeps its
    glyph. Shards hold contiguous ascending glyph ranges, so the smallest key
    is the reference's first-minimum tie-break (min_by_key, main.rs:159-172)
    exactly. When the row's slots share a device (one card, or cpu slots),
    K6 reads the shards' keys where they lie after an event wait
    (mesh.share_group); across devices they are copied to the first slot
    first (mesh.gather_group).

A glyph row may span processes, as focr_tpu's glyph group may span hosts.
Its first slot, the head, lies in the lowest of its processes, so the white
flags never cross. Each other process runs K4p on its own slots of the row,
copies the keys to one pinned buffer after its streams' work and sends it
to the head's process over gloo, point to point (mesh.send_group); the
head's process receives them (mesh.recv_group, posted before any wait),
uploads them on the head's stream (mesh.upload_group) and runs K6 over its
own keys, read in place, and the uploaded ones, in glyph-shard order. Point
to point rather than an all-gather: only the row's processes take part, the
keys cross once, and a process holding none of the row waits on nothing.

Glyph padding: when the glyph count doesn't divide the shard count, the bank
is padded with copies of glyph 0. A padded duplicate can never win: its
metric equals glyph 0's and its glyph number is higher, so its key is larger.

focr_tpu's ``make_sharded_ncc_fn`` (its decode.py:101-129) is the sharded
form of the ``device_kernel="xla"`` engine. The port has one sweep kernel and
no second engine (--device-kernel is accepted and unused), so it has no
counterpart here: the ncc matcher's mesh path is the scatter of waves over
the slots (models/ncc.py::get_hits_many_sharded), each slot running K1 and
K2 on its own pages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from focr_tpu_torch.fonts.bank import GridBank
from focr_tpu_torch.ops.ssd_kernels import first_min_combine, shard_bank, ssd_argmin_partial
from focr_tpu_torch.parallel.mesh import (
    GLYPHS_AXIS, PAGES_AXIS, Mesh, Sharded, gather_group, on_one_device, put_global, recv_group,
    send_group, share_group, upload_group,
)


def _pad_glyph_axis(arr: np.ndarray, g_mult: int) -> np.ndarray:
    """Pad axis 1 (glyphs) to a multiple of g_mult with copies of glyph 0."""
    G = arr.shape[1]
    rem = (-G) % g_mult
    if rem == 0:
        return arr
    fill = np.repeat(arr[:, :1], rem, axis=1)
    return np.concatenate([arr, fill], axis=1)


def shard_grid_bank(
    templates: np.ndarray, tsq: np.ndarray, n_g: int
) -> list[tuple[np.ndarray, np.ndarray]]:
    """A grid bank's arrays (templates [C, G, h, win] u8, tsq [C, G]) cut
    into ``n_g`` glyph slices, padded as _pad_glyph_axis pads: slice g holds
    glyphs g·Gl to (g+1)·Gl of the padded bank (focr_tpu/parallel/
    decode.py:53-55). What carries focr_tpu's bank to the port's slots."""
    tmpl = _pad_glyph_axis(templates, n_g)
    tsq_p = _pad_glyph_axis(tsq[..., None], n_g)[..., 0]
    Gl = tmpl.shape[1] // n_g
    return [(np.ascontiguousarray(tmpl[:, g * Gl : (g + 1) * Gl]),
             np.ascontiguousarray(tsq_p[:, g * Gl : (g + 1) * Gl])) for g in range(n_g)]


def make_sharded_grid_fn(bank: GridBank, ys: tuple[int, ...], x0: int, mesh: Mesh):
    """[B, H, W] u8 pages -> (ids [B, R, C] i32, white [B, R] bool), each a
    mesh.Sharded over the pages axis (mesh.fetch_global brings them back).

    The single-slot equivalent is models/focr.py::StripForward on cropped
    strips. Here the strips are cropped on the host once for the batch, each
    page row's block goes up to every slot of the row, every slot scores its
    glyph slice, and the row's first slot combines, with the keys of the
    row's slots in other processes received first. With one glyph shard a
    slot runs plain K4 and nothing is combined. B must be a multiple of the
    pages-axis size (use mesh.pad_batch)."""
    from focr_tpu_torch.models.focr import StripForward, crop_strips

    n_p, n_g = mesh.shape[PAGES_AXIS], mesh.shape[GLYPHS_AXIS]
    slices = shard_grid_bank(bank.templates, bank.tsq, n_g)
    Gl = slices[0][0].shape[1]
    fwd = {}  # a StripForward a slot with one glyph shard, else the slot's ShardBank
    for slot in mesh.local_slots:
        g = slot.index % n_g
        tmpl, tsq = slices[g]
        with slot.context():  # the slice goes up on the slot's own stream
            f = StripForward(dataclasses.replace(bank, templates=tmpl, tsq=tsq), slot.device)
            fwd[slot.index] = f if n_g == 1 else shard_bank(
                f.templates, f.tsq, f.wx0, bank.crop_w, g * Gl, bfrag=f.bfrag)
    # a row's own slots, and whether they name one device (a slot of another
    # process has none)
    mine = {p: [s for s in row if s.rank == mesh.rank] for p, row in enumerate(mesh.grid)}
    in_place = {p: bool(own) and on_one_device([s.device for s in own])
                for p, own in mine.items()}
    R, C = len(ys), bank.n_cells

    def fn(pages: np.ndarray):
        B = pages.shape[0]
        if B % n_p:
            raise ValueError(f"a batch of {B} pages does not divide over {n_p} page rows")
        strips = crop_strips(pages, ys, bank.crop_h, x0, bank.crop_w)
        placed = {slot.index: t for slot, _, t in put_global(strips, mesh, PAGES_AXIS).shards}
        rows = dict((s.index, idx) for s, idx in mesh.blocks(PAGES_AXIS, B))
        b = B // n_p
        ids_out, white_out = [], []
        combines, sends = [], []  # (p, head, own parts, posted receives); the sends to make
        for p, row in enumerate(mesh.grid):
            head, own = row[0], mine[p]
            if not own:
                continue
            if n_g == 1:
                with head.context():
                    ids, white = fwd[head.index](placed[head.index])
                ids_out.append((head, rows[head.index], ids))
                white_out.append((head, rows[head.index], white))
                continue
            parts = []
            for slot in own:
                with slot.context():  # white flags from the first shard only
                    key, w = ssd_argmin_partial(placed[slot.index], fwd[slot.index],
                                                white=slot is head)
                parts.append((slot, key))
                if slot is head:
                    white_out.append((head, rows[head.index], w))
            if head.rank != mesh.rank:  # a later part of a row that spans processes
                if b:
                    sends.append((head.rank, p, parts))
                continue
            theirs = sorted({s.rank for s in row} - {mesh.rank})  # the row's later processes
            pending = [recv_group(r, p, sum(s.rank == r for s in row), (b, R, C), torch.int64,
                                  head) for r in theirs] if b else []
            combines.append((p, head, parts, pending))
        # the keys go out once this process's K4p launches are all issued
        sends = [send_group(r, p, parts) for r, p, parts in sends]
        for p, head, parts, pending in combines:
            if in_place[p]:
                keys = share_group(head, parts)
            else:
                keys = list(gather_group(head, parts))
            for work, host in pending:  # the processes in rank order: glyph-shard order
                work.wait()
                keys += upload_group(head, host)
            with head.context():
                ids = first_min_combine(keys)  # the bank's glyph numbers
            ids_out.append((head, rows[head.index], ids))
        for work, _ in sends:
            work.wait()
        return (Sharded(mesh, (B, R, C), torch.int32, ids_out, PAGES_AXIS),
                Sharded(mesh, (B, R), torch.bool, white_out, PAGES_AXIS))

    return fn
