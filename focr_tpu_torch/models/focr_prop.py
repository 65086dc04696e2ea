"""Sequential greedy focr decode for proportional fonts, on PyTorch + CUDA.

Counterpart of focr_tpu/models/focr_prop.py. The reference's cursor advance
is data-dependent (main.rs:176-178: the cursor moves by the CHOSEN glyph's
advance), so proportional fonts cannot use the static-grid path. Every line
of a batch runs its own greedy scan, all lines at once: K5 (ops/
prop_kernels.py::prop_scan) loops over the cursor steps on the card with no
host round trip, and the host trims each line at the END_ID sentinel.

The decode is exact, not an approximation: the 64-phase bank
(fonts/bank.py::PropBank) reproduces FreeType's 1/64-px quantization, the
cursor is IEEE f32 in the oracle's op order, the score is exact integer SSD
with the canvas clipping of ‖T‖², and the first minimum wins ties.

focr_tpu's chunked while_loop, fetch-prefix guess, refetch counter and
warm-up ladder served the TPU's remote transport and are not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from focr_tpu_torch.fonts.bank import PropBank
from focr_tpu_torch.ops.prop_kernels import END_ID, check_bank, prop_scan, template_words
from focr_tpu_torch.parallel.mesh import SLOTS, Sharded, fetch_global, put_global
from focr_tpu_torch.utils.metrics import count, span


def max_steps(bank: PropBank, crop_w: int) -> int:
    """Upper bound on emitted cells per line (loop runs while pos < w)."""
    min_adv = float(bank.advances.min())
    if min_adv <= 0:
        raise ValueError("non-positive glyph advance: sequential decode would not terminate")
    return int(np.ceil(crop_w / min_adv)) + 1


class PropForward(torch.nn.Module):
    """[L, crop_h, crop_w] u8 inverted strips -> ids u8 [L, n_steps]:
    make_prop_forward (focr_tpu/models/focr_prop.py:49-160) as a module whose
    buffers are the bank on ``device`` (its templates also in K5's word
    layout, made once here). Refuses the banks focr_tpu refuses
    (:79, :84-86)."""

    def __init__(self, bank: PropBank, crop_w: int, n_steps: int, device: torch.device):
        super().__init__()
        G, _, crop_h, wbank = bank.templates.shape
        check_bank(G, crop_h * wbank)
        self.register_buffer(
            "templates", torch.from_numpy(np.ascontiguousarray(bank.templates)).to(device))
        self.register_buffer("words", template_words(self.templates))
        self.register_buffer(
            "colsq_cum", torch.from_numpy(bank.colsq_cum.astype(np.int32)).to(device))
        self.register_buffer(
            "advances", torch.from_numpy(bank.advances.astype(np.float32)).to(device))
        self.base = int(bank.base)
        self.ox = float(np.float32(bank.ox))
        self.crop_w = crop_w
        self.n_steps = n_steps

    def forward(self, strips: torch.Tensor) -> torch.Tensor:
        if strips.shape[-1] != self.crop_w:
            raise ValueError(f"prop forward: strips of width {strips.shape[-1]}, not {self.crop_w}")
        return prop_scan(strips, self.templates, self.colsq_cum, self.advances, self.base,
                         self.ox, self.n_steps, words=self.words)


class PropDecoder:
    """Device-side sequential decoder for one (crop_h, crop_w) line shape on
    one device ("cuda" runs K5, "cpu" its plain version).

    With a mesh (parallel/mesh.py) the line batch is dealt in contiguous
    blocks over every slot, pages and glyphs axes alike (each line's scan is
    independent: pure data parallelism over the lines, focr_tpu/models/
    focr_prop.py:195-210), each slot with its own PropForward and one K5
    launch, and the texts come back in line order. The caller has dropped
    the white strips, so a slot may get no line: it then launches nothing."""

    def __init__(self, bank: PropBank, crop_w: int, device: torch.device, mesh=None):
        self.bank = bank
        self.crop_w = crop_w
        self.device = device
        self.n_steps = max_steps(bank, crop_w)
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        if self.mesh is None:
            self.fwd = PropForward(bank, crop_w, self.n_steps, device)
            return
        self.fwds: dict[int, PropForward] = {}
        for slot in self.mesh.local_slots:
            with slot.context():  # the bank goes up on the slot's own stream
                self.fwds[slot.index] = PropForward(bank, crop_w, self.n_steps, slot.device)
        self.fwd = self.fwds[self.mesh.local_slots[0].index]

    def scan(self, strips: np.ndarray) -> np.ndarray:
        """[L, crop_h, crop_w] u8 -> ids u8 [L, n_steps] on the host. Counts
        the lines sent to K5 and the bytes this process uploads."""
        strips = np.ascontiguousarray(strips)
        count("prop_lines_scanned", strips.shape[0])
        if self.mesh is None:
            with span("focr_prop_upload"):
                strips_d = torch.from_numpy(strips).to(self.device)
            count("strip_bytes_uploaded", strips.nbytes)
            with span("focr_prop_launch"):
                ids = self.fwd(strips_d)
            with span("focr_prop_fetch"):
                return ids.cpu().numpy()
        with span("focr_prop_upload"):
            placed = put_global(strips, self.mesh, SLOTS)
        count("strip_bytes_uploaded", sum(block.numel() for _, _, block in placed.shards))
        outs = []
        with span("focr_prop_launch"):
            for slot, idx, block in placed.shards:
                if block.shape[0] == 0:
                    continue
                with slot.context():
                    outs.append((slot, idx, self.fwds[slot.index](block)))
        with span("focr_prop_fetch"):
            return fetch_global(
                Sharded(self.mesh, (strips.shape[0], self.n_steps), torch.uint8, outs, SLOTS))

    def texts(self, ids: np.ndarray) -> list[str]:
        """ids u8 [L, n_steps] -> each line's text, trimmed at END_ID. Counts
        the cursor steps that emitted a glyph."""
        ends = ids == END_ID
        lens = np.where(ends.any(axis=1), ends.argmax(axis=1), ids.shape[1])
        count("prop_steps", int(lens.sum()))
        alphabet = self.bank.alphabet
        if alphabet.isascii():  # one table lookup for the batch, then bytes per line
            chars = np.frombuffer(alphabet.encode("ascii"), np.uint8)[np.where(ends, 0, ids)]
            return [chars[i, :n].tobytes().decode("ascii") for i, n in enumerate(lens)]
        return ["".join(alphabet[g] for g in row[:n]) for row, n in zip(ids, lens)]

    def decode_lines(self, strips: np.ndarray) -> list[str]:
        """strips: [L, crop_h, crop_w] INVERTED line crops -> decoded texts."""
        ids = self.scan(strips)
        with span("focr_prop_text"):
            return self.texts(ids)
