"""Test support, not on any path: synthetic inputs for K3
(focr_tpu_torch/ops/replay_kernels.py) that reach each case of its design,
made from a seed: (page, needle) segments of 1, 31, 32, 33, 255, 256, 257,
383, 384, 385 and 769 candidates and an empty one (around a warp's step of
32, its piece of 128 and a round of WARPS = 3 warps, 384), a window on the
last byte of the crop's last page (a crop whose size is not a multiple of 4,
so the kernel's last word is partial), a zero-variance needle and a flat
patch (NaN and infinite similarities), and needles of any width (the
instances compiled for 4..16 and the generic one).

The CPU tests (tests/test_torch_replay_edges.py) hold K3's plain version
against the host replays on them; tests/test_torch_cuda_kernels.py and
chip_smoke.py hold the kernel against both on the card.
"""

from __future__ import annotations

import numpy as np

from focr_tpu_torch.ops.ncc import word_stride

# segment lengths of the two pages, in (page, needle) order; the last
# segment holds the window on the crop's last byte
SEGMENT_LENGTHS = ((1, 31, 32, 33, 383, 385), (255, 256, 0, 257, 384, 769))
EDGE_WIDTHS = (2, 4, 8, 9, 16, 17, 24)


def replay_case(nw: int, seed: int, nh: int = 11, lengths=SEGMENT_LENGTHS) -> dict:
    """One wave of len(lengths) cropped pages and T = len(lengths[0]) needles
    nh × nw, with K2-style candidates: segment (b, t) holds lengths[b][t]
    distinct windows in scan order. Returns numpy arrays imgs u8 [B, Hc, Wc],
    bank u8 [T, nh, nw], s_n, s2_n i64 [T], pos i32 (crop-local y·row_len +
    x), off i64 [B+1], hcnt i32 [B, T], and thr_f64 and row_len."""
    rng = np.random.default_rng(seed)
    B, T = len(lengths), len(lengths[0])
    # odd sides: B·Hc·Wc is 2 mod 4, the crop's last word has 2 bytes
    Hc, Wc = (nh + 24) | 1, (nw + 37) | 1
    imgs = rng.integers(0, 256, (B, Hc, Wc), dtype=np.uint8)
    bank = rng.integers(0, 256, (T, nh, nw), dtype=np.uint8)
    bank[2] = 77  # zero variance: rnorm_n is +inf
    row_len = word_stride(Wc, nw) * 32  # K2's position row length
    ny, nx = Hc - nh + 1, Wc - nw + 1
    hcnt = np.asarray(lengths, np.int32)
    pos = []
    for b in range(B):
        for t in range(T):
            k = int(hcnt[b, t])
            last = b == B - 1 and t == T - 1 and k  # the window on the crop's last byte
            pick = rng.choice(ny * nx - 1, size=k - 1, replace=False) if last else rng.choice(
                ny * nx, size=k, replace=False)
            ys, xs = np.divmod(np.sort(np.append(pick, ny * nx - 1) if last else pick), nx)
            # a quarter of the windows hold the needle itself: kept hits
            for y, x in zip(ys[::4], xs[::4]):
                imgs[b, y : y + nh, x : x + nw] = bank[t]
            pos.append((ys * row_len + xs).astype(np.int32))
    imgs[0, 3 : 3 + nh + 4, 2 : 2 + nw + 6] = 140  # flat windows: NaN
    off = np.concatenate([[0], np.cumsum(hcnt.sum(1, dtype=np.int64))])
    wide = bank.reshape(T, -1).astype(np.int64)
    return dict(imgs=imgs, bank=bank, s_n=wide.sum(1), s2_n=(wide**2).sum(1),
                pos=np.concatenate(pos), off=off, hcnt=hcnt,
                thr_f64=float(np.float32(0.05)), row_len=row_len)


def host_args(case: dict, b: int, max_matches: int) -> tuple:
    """The host replays' arguments (native/ncc_cpu.py::replay_group) for page
    b of ``case``, the crop taken as the whole page."""
    hcnt = case["hcnt"][b].astype(np.int64)
    ends = np.cumsum(hcnt)
    off = case["off"]
    return (case["imgs"][b], case["pos"][off[b] : off[b + 1]], ends - hcnt, ends, case["bank"],
            case["s_n"], case["s2_n"], case["thr_f64"], case["row_len"], max_matches)
