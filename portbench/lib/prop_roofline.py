"""The work of K5, the proportional decoder's cursor scan, for its roofline
share: operations and bytes counted from the shapes of the lines it is given
and the steps the plain reference takes on them, divided by
lib/roofline.py::bound_ms as the other kernels' work is.

The count follows the kernel's main-path caller, frozen here: the CLI's
pages go in batches of 16 (lib/roofline.py::FOCR_BATCH), and each batch
launches K5 once a row group that holds ink, on that group's inked lines
alone (an all-white strip is dropped on the host).
"""

from __future__ import annotations

PHASES = 64


def k5_work(L: int, h: int, crop_w: int, G: int, wbank: int, n_steps: int,
            steps: int) -> tuple[int, int]:
    """K5, one launch on L line strips of crop height h whose scans take
    ``steps`` cursor steps in all: each step scores every glyph's template
    at the line's phase against the window (G·h·wbank multiply-adds). In:
    the strips, the phase bank (u8), its i32 column prefix sums and the f32
    advances; out: a u8 glyph id a step slot, n_steps a line."""
    ops = 2 * steps * G * h * wbank
    nbytes = (L * h * crop_w + G * PHASES * h * wbank + 4 * G * PHASES * (wbank + 1) + 4 * G
              + L * n_steps)
    return ops, nbytes
