"""The focr grid decoder on PyTorch + CUDA.

Counterpart of focr_tpu/models/focr.py. Replaces the reference's per-page
sequential decode (decode_image/decode_line/score_glyph, main.rs:87-239) with
one device step per batch and row group:

  pages: B same-shape [H, W] u8 (a mapped page is cropped in its map)
    -> crop the line strips on the host       (crop_strips, one upload)
    -> K4 ssd_argmin: invert, all-white flag, per-cell windows,
       exact-integer SSD metric, first-min argmin (ops/ssd_kernels.py)
    -> ids [B, R, C] i32 + white [B, R]        (main.rs:208-211)

Host-side assembly applies the row-loop semantics (white skip, bottom stop)
and maps glyph ids back to characters. Monospace fonts take this path (the
cursor grid is static); proportional fonts take the sequential device
decoder (models/focr_prop.py, K5), with the NumPy oracle
(oracle/focr_oracle.py) only for degenerate metrics (a non-positive advance),
as in focr_tpu. Batches are synchronous. With a mesh (parallel/mesh.py) the
batch is dealt over its slots: monospace row groups run parallel/decode.py's
sharded step (pages over the pages axis, the glyph bank over the glyphs
axis), proportional lines are dealt over every slot; the results are the
single-slot path's, bit for bit.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from dataclasses import dataclass

import numpy as np
import torch

from focr_tpu_torch.fonts.bank import (
    FocrBank, GridBank, PropBank, build_grid_bank, build_prop_bank, is_monospace,
)
from focr_tpu_torch.fonts.ft import Face
from focr_tpu_torch.io.images import bucket_pages
from focr_tpu_torch.models.focr_prop import PropDecoder
from focr_tpu_torch.models.types import DecodedLine, DecodeOptions, RenderOptions
from focr_tpu_torch.ops.ssd_kernels import pack_template_fragments, ssd_argmin, ssd_plan
from focr_tpu_torch.oracle import focr_oracle
from focr_tpu_torch.parallel.mesh import fetch_global, pad_batch
from focr_tpu_torch.utils.device import resolve_device
from focr_tpu_torch.utils.metrics import count, span


@dataclass(frozen=True)
class _RowGroup:
    crop_h: int
    ys: tuple[int, ...]  # page-space y of each row in this group, ascending


def _row_groups(dopts: DecodeOptions, H: int) -> list[_RowGroup]:
    """Rows of the scan grid grouped by crop height, in ascending y: the
    full-height rows, then each partial bottom row (shorter the lower it is)
    in a group of its own. Mirrors the crop clamp of image::crop_imm
    (main.rs:199-207)."""
    groups: dict[int, list[int]] = {}
    i = 0
    while True:
        y = dopts.y_start + i * dopts.line_advance
        i += 1
        ch = min(dopts.line_height, H - min(y, H))
        if ch <= 0:
            break
        groups.setdefault(ch, []).append(y)
    return [_RowGroup(crop_h=ch, ys=tuple(ys)) for ch, ys in sorted(groups.items(), reverse=True)]


class StripForward(torch.nn.Module):
    """[B, R, crop_h, crop_w] u8 strips -> (ids int32 [B, R, C], white bool
    [B, R]) for one row group: make_strip_forward (focr_tpu/models/focr.py
    :60-80) as a module whose buffers are the bank on ``device``, with the
    templates also packed once in K4's tensor-core fragment order where the
    bank's shape takes that instance (ssd_plan)."""

    def __init__(self, bank: GridBank, device: torch.device):
        super().__init__()
        if (bank.wx0 < 0).any():
            raise ValueError("grid bank: window starts must be >= 0")
        templates = torch.from_numpy(np.ascontiguousarray(bank.templates))
        self.register_buffer("templates", templates.to(device))
        self.register_buffer("tsq", torch.from_numpy(bank.tsq.astype(np.int64)).to(device))
        self.register_buffer("wx0", torch.from_numpy(bank.wx0.astype(np.int32)).to(device))
        mma = ssd_plan(bank.crop_h, bank.crop_w, templates.shape[3])[0] == "mma"
        self.register_buffer("bfrag", pack_template_fragments(templates).to(device) if mma
                             else None)

    def forward(self, strips: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return ssd_argmin(strips, self.templates, self.tsq, self.wx0, bfrag=self.bfrag)


def _grid_view(page: np.ndarray, ys: tuple[int, ...], crop_h: int, x0: int,
               crop_w: int) -> np.ndarray | None:
    """The strips of rows ``ys`` on one [H, W] page as one read-only strided
    view [R, crop_h, crop_w], where the rows are evenly spaced (as _row_groups
    makes each group's) and every strip lies inside the page; else None."""
    H, W = page.shape
    step = ys[1] - ys[0] if len(ys) > 1 else 0
    if (min(min(ys), x0) < 0 or max(ys) + crop_h > H or x0 + crop_w > W
            or ys != tuple(ys[0] + i * step for i in range(len(ys)))):
        return None
    base = page[ys[0]:, x0 : x0 + crop_w]
    sy, sx = base.strides
    return np.lib.stride_tricks.as_strided(
        base, (len(ys), crop_h, crop_w), (step * sy, sy, sx), writeable=False)


def crop_strips(
    pages: Sequence[np.ndarray], ys: tuple[int, ...], crop_h: int, x0: int, crop_w: int,
    out: np.ndarray | None = None,
):
    """Host-side scan-rectangle crop: B same-shape [H, W] pages (a [B, H, W]
    array, or a list) -> [B, R, crop_h, crop_w] u8, one copy a page from its
    strided view of the rows (_grid_view), where the pages lie.

    Rows whose rectangle hangs past the page bottom are white-padded — the
    caller only passes ys whose crop height equals crop_h (see _row_groups),
    so padding never actually materializes for grouped rows. ``out`` lets the
    caller fill a view of a preallocated buffer."""
    if out is None:
        out = np.empty((len(pages), len(ys), crop_h, crop_w), dtype=np.uint8)
    for b, page in enumerate(pages):
        view = _grid_view(page, ys, crop_h, x0, crop_w)
        if view is not None:
            out[b] = view
            continue
        H = page.shape[0]
        for ri, y in enumerate(ys):
            h = min(crop_h, H - y)
            out[b, ri, :h] = page[y : y + h, x0 : x0 + crop_w]
            if h < crop_h:
                out[b, ri, h:] = 255
    return out


def inked_strips(
    pages: Sequence[np.ndarray], grp: _RowGroup, x0: int, crop_w: int,
) -> tuple[np.ndarray, np.ndarray]:
    """One row group's inked strips, inverted, straight from the pages:
    B same-shape [H, W] u8 pages -> (page-major indices b * R + r of the
    inked strips, [L, crop_h, crop_w] u8 of 255 - pixel), and counts the
    white strips the ink test dropped. The group's ys are evenly spaced
    (_row_groups: the full-height rows in one group, each partial bottom
    height alone), so a page's strips are one strided view of it
    (_grid_view); a strip holds ink exactly when its least pixel is below
    255, so the test copies nothing, and only the inked strips are gathered,
    into one array, then inverted in place."""
    R = len(grp.ys)
    views = [_grid_view(page, grp.ys, grp.crop_h, x0, crop_w) for page in pages]
    if any(v is None for v in views):
        H, W = pages[0].shape
        raise ValueError(f"focr prop strips: rows {grp.ys} of height {grp.crop_h} at x {x0}, "
                         f"width {crop_w}, are not an even grid inside a {H}x{W} page")
    rows = [np.flatnonzero(v.min(axis=(1, 2)) < 255) for v in views]
    n = sum(len(r) for r in rows)
    count("prop_strips_white", len(pages) * R - n)
    lines = np.empty((n, grp.crop_h, crop_w), np.uint8)
    off = 0
    for v, r in zip(views, rows):
        # one copy a run of consecutive inked rows, straight into ``lines``
        # (a fancy index would gather into a temporary first)
        inked = r.tolist()
        start = 0
        for k in range(1, len(inked) + 1):
            if k == len(inked) or inked[k] != inked[k - 1] + 1:
                lines[off : off + k - start] = v[inked[start] : inked[k - 1] + 1]
                off += k - start
                start = k
    np.subtract(255, lines, out=lines)
    idx = [b * R + r for b, r in enumerate(rows)]
    return (np.concatenate(idx) if idx else np.zeros(0, np.int64)), lines


def make_grid_forward(bank: GridBank, ys: tuple[int, ...], x0: int, device):
    """The [B, H, W] u8 pages -> (ids [B, R, C], white [B, R]) step of one
    row group: crop on the host, then StripForward on ``device``."""
    dev = resolve_device(device)
    fwd = StripForward(bank, dev)

    def fn(pages: Sequence[np.ndarray]):
        strips = crop_strips(pages, ys, bank.crop_h, x0, bank.crop_w)
        return fwd(torch.from_numpy(strips).to(dev))

    return fn


class GridDecoder:
    """Batched focr decoder for one (page shape, grid, font) configuration.

    ``device`` is explicit ("cuda" runs K4 or K5, "cpu" their plain
    versions). ``banks``: a preloaded bank set {crop_h: GridBank or PropBank}
    (fonts/bank.py::load_grid_bank, which loads each height when it is first
    asked for, or a plain dict) for the alphabet; with it no glyph is
    rendered, ``face`` may be None, and the set's kind decides the path (a
    saved grid bank is monospace by construction). ``mesh``: an optional
    parallel/mesh.py::Mesh; batches are then dealt over its slots (a mesh of
    one slot is the same as none), ``device`` stays the first slot's, and the
    results are identical either way."""

    def __init__(
        self,
        face: Face | None,
        alphabet: str,
        dopts: DecodeOptions,
        ropts: RenderOptions,
        page_shape: tuple[int, int],
        device: str | torch.device,
        banks: Mapping[int, FocrBank] | None = None,
        mesh=None,
    ):
        with span("focr_decoder_build"):  # the whole build, its height loads included
            if face is None and banks is None:
                raise ValueError("GridDecoder: needs a face or a preloaded bank set")
            self.face = face
            self.alphabet = alphabet
            self.dopts = dopts
            self.ropts = ropts
            self.page_shape = page_shape
            self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
            self.device = resolve_device(
                device if self.mesh is None else self.mesh.local_slots[0].device)
            self.bank_set = banks
            H, W = page_shape
            self.x0 = min(dopts.x_start, W)
            self.crop_w = max(min(dopts.width, W - self.x0), 0)
            if not alphabet:
                self.monospace = True
            elif banks is not None:
                # a loaded set names its kind; walking its values would decompress
                # every crop height
                kind = getattr(banks, "kind", None)
                self.monospace = (
                    kind == "grid" if kind is not None
                    else not any(isinstance(b, PropBank) for b in banks.values())
                )
            else:
                self.monospace = is_monospace(face, alphabet, ropts)
            self._codes = np.array([ord(c) for c in alphabet], dtype=np.uint32)
            self._ascii = bool(alphabet) and max(map(ord, alphabet)) < 128
            # per row group its step: a StripForward, or with a mesh the sharded fn
            self.groups: list[tuple[_RowGroup, object]] = []
            self.prop_groups: list[tuple[_RowGroup, PropDecoder]] = []
            self.banks: list[GridBank] = []
            if self.crop_w > 0 and self.monospace:
                for grp in _row_groups(dopts, H):
                    bank = self._bank(grp.crop_h)
                    self.banks.append(bank)
                    if self.mesh is not None:
                        from focr_tpu_torch.parallel.decode import make_sharded_grid_fn

                        fn = make_sharded_grid_fn(bank, grp.ys, self.x0, self.mesh)
                    else:
                        fn = StripForward(bank, self.device)
                    self.groups.append((grp, fn))
            if self.crop_w > 0 and not self.monospace:
                prop = [(grp, self._bank(grp.crop_h)) for grp in _row_groups(dopts, H)]
                if all(float(b.advances.min()) > 0 for _, b in prop):
                    self.prop_groups = [
                        (grp, PropDecoder(b, self.crop_w, self.device, mesh=self.mesh))
                        for grp, b in prop
                    ]
                elif face is None:
                    # focr_tpu's route for a non-positive advance is the oracle,
                    # which renders every glyph
                    raise ValueError("a bank with a non-positive advance needs the font itself")

    def _bank(self, crop_h: int) -> FocrBank:
        if self.bank_set is None:
            if self.monospace:
                return build_grid_bank(self.face, self.alphabet, self.ropts, self.crop_w, crop_h)
            return build_prop_bank(self.face, self.alphabet, self.ropts, crop_h)
        bank = self.bank_set.get(crop_h)
        if (
            bank is None
            or bank.alphabet != self.alphabet
            or (isinstance(bank, GridBank) and bank.crop_w != self.crop_w)
        ):
            raise ValueError(
                f"focr bank set: no bank of alphabet {self.alphabet!r} for a "
                f"{self.crop_w}x{crop_h} line crop (page {self.page_shape}); it holds "
                f"crop heights {sorted(self.bank_set)}"
            )
        return bank

    def decode_batch(self, pages: Sequence[np.ndarray]) -> list[list[DecodedLine]]:
        """B [H, W] u8 pages of the decoder's shape (a [B, H, W] array, or a
        list) -> per-page decoded lines in row order."""
        if any(p.shape != self.page_shape for p in pages):
            raise ValueError(f"GridDecoder: pages of shapes {sorted({p.shape for p in pages})}, "
                             f"not {self.page_shape}")
        B = len(pages)
        if self.crop_w == 0:
            # zero-width crop: the all-white skip fires on every row
            # (empty-iterator all() == true), so no lines are ever emitted.
            return [[] for _ in range(B)]
        if self.monospace and not self.groups:
            # empty row grid (y_start at/past the page bottom): the
            # reference's row loop breaks immediately (main.rs:205-207)
            return [[] for _ in range(B)]
        if not self.monospace:
            if self.prop_groups:
                return self._decode_prop(pages)
            return [
                focr_oracle.decode_image(p, self.face, self.alphabet, self.dopts, self.ropts)
                for p in pages
            ]
        return self._finish(self._dispatch(pages))

    def _decode_prop(self, pages: Sequence[np.ndarray]) -> list[list[DecodedLine]]:
        """Proportional-font batch decode through K5, one launch per row
        group that holds ink (focr_tpu/models/focr.py:241-268). All-white
        strips are dropped on the pages, before any copy: the row loop drops
        their text (main.rs:208-211)."""
        B = len(pages)
        with span("focr_prop_strips"):
            work = [(grp, dec, B * len(grp.ys), *inked_strips(pages, grp, self.x0, self.crop_w))
                    for grp, dec in self.prop_groups]
        ids = [dec.scan(lines) if len(lines) else None for _, dec, _, _, lines in work]
        with span("focr_prop_text"):
            per_row: dict[int, list[str | None]] = {}  # y -> text per page, None if white
            for (grp, dec, n, inked, _), got in zip(work, ids):
                texts: list[str | None] = [None] * n
                if got is not None:
                    for i, t in zip(inked, dec.texts(got)):
                        texts[i] = t
                R = len(grp.ys)
                for ri, y in enumerate(grp.ys):
                    per_row[y] = [texts[b * R + ri] for b in range(B)]
            ys_sorted = sorted(per_row)
            return [
                [DecodedLine(text=per_row[y][b], y=int(y)) for y in ys_sorted
                 if per_row[y][b] is not None]
                for b in range(B)
            ]

    def _dispatch(self, pages: Sequence[np.ndarray], groups=None) -> tuple[list, int, list]:
        """Crop the strips of ``groups`` (row groups and their steps, by
        default every one) from each page into ONE flat host buffer (filled
        in place), upload it once, and run each group's step on its slice.
        With a mesh: stack the batch, pad it with white pages to a multiple
        of its size and run each group's sharded step on the padded pages.
        Returns (the groups, pages in the batch, each group's outputs)."""
        groups = self.groups if groups is None else groups
        B = len(pages)
        if self.mesh is not None:
            padded, _ = pad_batch(np.stack(pages), self.mesh.size)
            with span("focr_launch"):
                return groups, B, [fn(padded) for _, fn in groups]
        sizes = [B * len(g.ys) * g.crop_h * self.crop_w for g, _ in groups]
        with span("focr_crop"):
            flat = np.empty(sum(sizes), dtype=np.uint8)
            off = 0
            for (grp, _), sz in zip(groups, sizes):
                view = flat[off : off + sz].reshape(B, len(grp.ys), grp.crop_h, self.crop_w)
                crop_strips(pages, grp.ys, grp.crop_h, self.x0, self.crop_w, out=view)
                off += sz
        with span("focr_upload"):
            flat_d = torch.from_numpy(flat).to(self.device)
        count("strip_bytes_uploaded", flat.nbytes)
        outs = []
        off = 0
        with span("focr_launch"):
            for (grp, fwd), sz in zip(groups, sizes):
                strips = flat_d[off : off + sz].view(B, len(grp.ys), grp.crop_h, self.crop_w)
                outs.append(fwd(strips))
                off += sz
        return groups, B, outs

    def _finish(self, outs) -> list[list[DecodedLine]]:
        """Fetch one batch's results and assemble text lines in ascending y
        across the row groups it ran."""
        groups, n, group_outs = outs
        # one round of copies for every group; a mesh's blocks come back in
        # page order, from every process that holds some
        with span("focr_fetch"):
            fetched = fetch_global(group_outs)
        with span("focr_assemble"):
            # row groups come in ascending y (_row_groups: the full-height rows,
            # then each shorter bottom row), so their rows join in page order;
            # [:n] drops a mesh's white filler pages
            ys = [y for grp, _ in groups for y in grp.ys]
            ids_all = np.concatenate([ids[:n] for ids, _ in fetched], axis=1)  # [B, R, C]
            white_all = np.concatenate([white[:n] for _, white in fetched], axis=1)  # [B, R]
            return self._assemble(ids_all, white_all, ys)

    def _assemble(
        self, ids_all: np.ndarray, white_all: np.ndarray, ys_sorted: list[int]
    ) -> list[list[DecodedLine]]:
        """Map glyph ids to text lines, skipping all-white rows
        (main.rs:208-211). ASCII alphabets decode rows via a single bytes()
        pass per page."""
        B = ids_all.shape[0]
        codes = self._codes[ids_all]  # [B, R, C] u32 of unicode codepoints
        ys_arr = np.asarray(ys_sorted)
        out: list[list[DecodedLine]] = []
        for b in range(B):
            keep = ~white_all[b]
            rows = codes[b][keep]
            if self._ascii:
                blob = rows.astype(np.uint8).tobytes().decode("ascii")
                C = rows.shape[1]
                texts = [blob[i * C : (i + 1) * C] for i in range(rows.shape[0])]
            else:
                texts = ["".join(map(chr, r)) for r in rows]
            out.append(
                [DecodedLine(text=t, y=int(y)) for t, y in zip(texts, ys_arr[keep])]
            )
        return out


def decode_pages(
    pages: list[np.ndarray],
    face: Face | None,
    alphabet: str,
    dopts: DecodeOptions,
    ropts: RenderOptions,
    device: str | torch.device,
    batch_size: int = 16,
    banks: Mapping[int, FocrBank] | None = None,
    mesh=None,
) -> list[list[DecodedLine]]:
    """Decode a heterogeneous page list: bucket by shape, batch, reassemble.

    Replaces the rayon page fan-out (main.rs:442-471); page order is restored
    exactly as the reference's sort-by-index does (main.rs:468). ``mesh``
    deals each batch over a mesh of slots (several cards, or one card's
    streams)."""
    results: list[list[DecodedLine] | None] = [None] * len(pages)
    with span("focr_bucket"):
        buckets = bucket_pages(pages)
    for bucket in buckets:
        dec = GridDecoder(face, alphabet, dopts, ropts, bucket.shape, device, banks, mesh)
        for s, decoded in decode_stream(dec, bucket.pages, batch_size):
            for j, lines in enumerate(decoded):
                results[bucket.indices[s + j]] = lines
    return results  # type: ignore[return-value]


def decode_single_stream(dec: GridDecoder, page: np.ndarray, rows_per_chunk: int = 16):
    """Yield DecodedLine for ONE page in row order, each row chunk's lines as
    soon as its results land.

    Mirrors the reference's single-image fast path, which prints every line
    the moment it is decoded (main.rs:427-440). Chunks of ``rows_per_chunk``
    rows go through decode_batch's own stages (_dispatch, _finish), one after
    another; the output equals ``decode_batch(page[None])[0]``."""
    for lines in decode_single_chunks(dec, page, rows_per_chunk):
        yield from lines


def decode_single_chunks(dec: GridDecoder, page: np.ndarray, rows_per_chunk: int = 16):
    """decode_single_stream a row chunk at a time: yield each chunk's list of
    DecodedLine (possibly empty) as soon as its results land."""
    if dec.mesh is not None or not dec.monospace or dec.crop_w == 0 or not dec.groups:
        yield dec.decode_batch(page[None])[0]
        return
    # groups are ordered full-height-first = ascending y (partial rows are
    # at the page bottom), so chunk order is row order
    for grp, fwd in dec.groups:
        for s in range(0, len(grp.ys), rows_per_chunk):
            chunk = _RowGroup(grp.crop_h, grp.ys[s : s + rows_per_chunk])
            yield dec._finish(dec._dispatch(page[None], [(chunk, fwd)]))[0]


def decode_stream(dec: GridDecoder, pages: Sequence[np.ndarray], batch_size: int):
    """Yield (start_index, decoded_lines) per batch of ``pages`` (a list, or a
    [B, H, W] array), one batch at a time."""
    for s in range(0, len(pages), batch_size):
        yield s, dec.decode_batch(pages[s : s + batch_size])
