"""K3's design cases (tests/replay_cases.py) on the CPU: the wrapper (its plain
version, for CPU tensors) against focr_tpu's host replay
(focr_tpu/native/ncc_cpu.py::replay_group) and the port's host library
(native/ncc_cpu.py::replay_group), bit for bit: coordinates, the f32
similarities' bits, counts and WARN flags. Segments of 0 to 769 candidates
(around a step of 32, a warp's piece of 128 and a round of three warps),
caps of 32 and 33 (a rank that crosses a step of 32), a window on the last
byte of the crop's last page, needle widths 2 to 24 (the generic instance and
those compiled for one width); and the plan that picks the kernel's instance,
held against csrc/ncc_replay.cu. The kernel itself runs on these cases in
tests/test_torch_cuda_kernels.py and chip_smoke.py (a card only)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from focr_tpu.native import ncc_cpu as jax_native
from focr_tpu_torch.models.types import MAX_MATCHES
from focr_tpu_torch.native import ncc_cpu
from focr_tpu_torch.ops import replay_kernels
import replay_cases  # tests/replay_cases.py, beside this file

SOURCE = Path(replay_kernels.__file__).resolve().parent.parent / "csrc" / "ncc_replay.cu"


def _tensors(case: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}


def _page_keys(x, y, sim, counts, warn, starts):
    """Each needle's hits of one page: (count, warn, x, y, f32 sim bytes)."""
    out = []
    for t, k in enumerate(np.asarray(counts).tolist()):
        s = slice(int(starts[t]), int(starts[t]) + k)
        out.append((k, int(warn[t]), np.asarray(x[s]).astype(np.int64).tolist(),
                    np.asarray(y[s]).astype(np.int64).tolist(),
                    np.asarray(sim[s], np.float32).tobytes()))
    return out


def _replay(case: dict, max_matches: int, cy0: int = 0, cx0: int = 0):
    """K3's output (the wrapper on CPU tensors) split by page into
    _page_keys."""
    t = _tensors(case)
    needles = replay_kernels.replay_needles(t["bank"], t["s_n"], t["s2_n"])
    buf = replay_kernels.ncc_replay(t["imgs"], t["pos"], t["off"], t["hcnt"], needles,
                                    case["thr_f64"], cy0, cx0, max_matches)
    B, T = case["hcnt"].shape
    x, y, sim, counts, warn = (v.numpy() for v in replay_kernels.split_replay(
        buf, len(case["pos"]), B, T))
    starts = case["off"][:-1, None] + np.cumsum(case["hcnt"], 1, dtype=np.int64) - case["hcnt"]
    return [_page_keys(x, y, sim, counts[b], warn[b], starts[b]) for b in range(B)]


@pytest.mark.parametrize("max_matches", [MAX_MATCHES, 33, 32])
@pytest.mark.parametrize("nw", replay_cases.EDGE_WIDTHS)
def test_edge_cases_match_host_replays(nw, max_matches):
    case = replay_cases.replay_case(nw, seed=nw)
    got = _replay(case, max_matches)
    n_kept = n_warned = 0
    for b, page in enumerate(got):
        args = replay_cases.host_args(case, b, max_matches)
        want = _page_keys(*ncc_cpu.replay_group(*args), args[2])
        assert page == want
        assert _page_keys(*jax_native.replay_group(*args), args[2]) == want
        n_kept += sum(k for k, *_ in want)
        n_warned += sum(w for _, w, *_ in want)
    assert n_kept > 0
    # the caps bite in the long segments, the full cap in none
    assert (n_warned > 0) == (max_matches < MAX_MATCHES)


def test_edge_case_shapes():
    """The generator gives what the cases need: the segment lengths, an
    empty segment, a crop whose size is 2 mod 4, the last page's last window
    among the candidates, and the needle kept there."""
    for nw in replay_cases.EDGE_WIDTHS:
        case = replay_cases.replay_case(nw, seed=nw)
        B, Hc, Wc = case["imgs"].shape
        T, nh, _ = case["bank"].shape
        assert case["hcnt"].tolist() == [list(r) for r in replay_cases.SEGMENT_LENGTHS]
        assert case["imgs"].size % 4 == 2
        assert int(case["pos"][-1]) == (Hc - nh) * case["row_len"] + (Wc - nw)
        per_needle = _replay(case, MAX_MATCHES)[B - 1][T - 1]
        assert (Wc - nw, Hc - nh) == (per_needle[2][-1], per_needle[3][-1])


def test_crop_origin_moves_every_hit():
    """The crop's origin is added to every kept hit's coordinates and changes
    nothing else."""
    case = replay_cases.replay_case(9, seed=3)
    at0, moved = _replay(case, 33), _replay(case, 33, cy0=7, cx0=5)
    for p0, p1 in zip(at0, moved, strict=True):
        for (k0, w0, x0, y0, s0), (k1, w1, x1, y1, s1) in zip(p0, p1, strict=True):
            assert (k0, w0, s0) == (k1, w1, s1)
            assert [v + 5 for v in x0] == x1 and [v + 7 for v in y0] == y1


@pytest.mark.parametrize("nw", [1, 3, 4, 9, 16, 17, 24, 60])
def test_plan_instance_by_width(nw):
    """The instance is the needle's width for 4..16 (compiled for it) and
    the generic one (0) for any other."""
    assert replay_kernels.replay_plan(nw) == (nw if 4 <= nw <= 16 else 0)


def test_plan_mirrors_the_kernel_source():
    """The wrapper's constants and instances are the kernel's: the warps it
    gives a segment within RMAXW, and a launcher case for 0 and each of
    WIDTHS."""
    src = SOURCE.read_text()
    maxw = int(re.search(r"constexpr int RMAXW = (\d+);", src).group(1))
    assert replay_kernels.MAX_WARPS == maxw
    assert 1 <= replay_kernels.WARPS <= maxw
    cases = sorted(int(v) for v in re.findall(r"^\s*FOCR_REPLAY_CASE\((\d+)\)$", src, re.M))
    assert cases == [0, *replay_kernels.WIDTHS]
