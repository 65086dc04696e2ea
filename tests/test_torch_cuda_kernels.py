"""K1 and K2 on a CUDA card against their plain PyTorch versions, exactly.

Marked ``cuda``: each test skips without a card. On a machine with one, run

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py configures jax, which the card's machine
need not have; this file imports neither jax nor focr_tpu).
"""

import numpy as np
import pytest
import torch

from focr_tpu_torch.ops import ncc_kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(B, H, W, T, nh, nw, seed, density):
    """Sparse noise pages with needles planted, a flat block, a
    zero-variance needle; T not a multiple of the kernel's needle tile."""
    rng = np.random.default_rng(seed)
    imgs = ((rng.random((B, H, W)) < density) * rng.integers(0, 256, (B, H, W))).astype(np.uint8)
    needles = rng.integers(0, 256, (T, nh, nw), dtype=np.uint8)
    needles[0] = 7
    for b in range(B):
        for _ in range(5):
            t, y, x = rng.integers(T), rng.integers(0, H - nh), rng.integers(0, W - nw)
            imgs[b, y : y + nh, x : x + nw] = needles[t]
    imgs[:, 5 : 5 + nh, 20 : 20 + nw] = 128
    s_n = needles.reshape(T, -1).astype(np.int64).sum(1)
    s2_n = (needles.reshape(T, -1).astype(np.int64) ** 2).sum(1)
    return imgs, needles, s_n, s2_n


CASES = {  # (B, H, W, T, nh, nw, threshold, seed, density)
    "small-13x9": (2, 60, 100, 11, 13, 9, 0.5, 0, 0.3),
    "dense-13x8": (3, 97, 333, 17, 13, 8, 0.3, 1, 0.3),
    "wide-5x17": (1, 40, 70, 5, 5, 17, 0.4, 2, 0.3),
    "tall-16x15": (2, 50, 600, 9, 16, 15, 0.6, 3, 0.3),
    "page-13x9": (8, 792, 662, 222, 13, 9, 0.8, 4, 0.1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_versions(cuda, case):
    B, H, W, T, nh, nw, thr, seed, density = CASES[case]
    args = [
        torch.from_numpy(a).to(cuda)
        for a in _inputs(B, H, W, T, nh, nw, seed, density)
    ]
    ncc_kernels.reset_launches()
    mask, rcnt = ncc_kernels.ncc_sweep(*args, thr)
    out = ncc_kernels.compact_hits(mask, rcnt)
    torch.cuda.synchronize()
    assert ncc_kernels.LAUNCHES == {"ncc_sweep": 1, "compact_hits": 1}
    mask_r, rcnt_r = ncc_kernels.ncc_sweep_reference(*args, thr)
    assert torch.equal(mask, mask_r) and torch.equal(rcnt, rcnt_r)
    out_r = ncc_kernels.compact_hits_reference(mask, rcnt)
    assert all(torch.equal(a, b) for a, b in zip(out, out_r))
    assert int(out[3].sum()) > 0
