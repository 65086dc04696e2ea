"""K1 (both tiers), K2 (count and emit), K3, K4 (both instances), K4p, K6 and
K5 on a CUDA card against their plain PyTorch versions, exactly.

Marked ``cuda``: each test skips without a card. On a machine with one, run

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py configures jax, which the card's machine
need not have; this file imports neither jax nor focr_tpu).
"""

import os

import numpy as np
import pytest
import torch

from focr_tpu_torch.ops import ncc_kernels, prop_kernels, replay_kernels, ssd_kernels

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
    if T > 1:
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
    # the wide tier: n·65025 >= 2²⁴, thr−ε <= 0, needle words in device memory
    "t20-21x13": (4, 300, 662, 74, 21, 13, 0.8, 5, 0.2),
    "thr0-13x9": (2, 80, 120, 9, 13, 9, 0.0, 6, 0.3),
    "neg-17x12": (1, 70, 90, 5, 17, 12, -0.4, 7, 0.3),
    "huge-150x150": (1, 330, 300, 3, 150, 150, 0.7, 8, 0.2),
    # tile edges of the tensor-core sweep: window columns W-nw+1 not a
    # multiple of 8 or 32, a page narrower than one 8-column N-tile, T
    # around the 16-needle M-tile, needle widths around the 4-byte k-word
    "edge-T1-nw1": (2, 30, 45, 1, 5, 1, 0.3, 9, 0.3),
    "edge-T16-nw4": (2, 40, 70, 16, 7, 4, 0.4, 10, 0.3),
    "edge-T17-nw5-narrow-page": (2, 35, 9, 17, 4, 5, 0.2, 11, 0.3),
    "edge-T17-nw17": (2, 50, 300, 17, 5, 17, 0.5, 12, 0.3),
    "edge-T16-wide": (1, 60, 100, 16, 13, 9, -0.1, 13, 0.3),
    # groups past one block's 16 M-tiles spread over grid.z: 3 blocks, 2
    # blocks of the wide tier, and a 28,000-needle group (110 blocks)
    "many-T600-13x9": (2, 40, 60, 600, 13, 9, 0.3, 14, 0.3),
    "many-T300-wide": (1, 50, 60, 300, 21, 13, 0.8, 15, 0.3),
    "many-T28000-13x9": (1, 30, 40, 28000, 13, 9, 0.5, 16, 0.3),
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
    assert ncc_kernels.LAUNCHES == {"ncc_sweep": 1, "compact_count": 1, "compact_hits": 1}
    mask_r, rcnt_r = ncc_kernels.ncc_sweep_reference(*args, thr)
    assert torch.equal(mask, mask_r) and torch.equal(rcnt, rcnt_r)
    out_r = ncc_kernels.compact_hits_reference(mask, rcnt)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(out, out_r))
    assert int(out[3].sum()) > 0


@pytest.mark.parametrize("max_matches", [1024, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_replay_matches_plain_version(cuda, case, max_matches):
    """K3 on K1's and K2's candidates of each case (a crop origin of (3, 5)
    added to the coordinates) against its plain version on the card: the
    kept hits (x, y, the f32 similarities' bits), counts and WARN flags
    identical, at MAX_MATCHES and at a cap of 3."""
    B, H, W, T, nh, nw, thr, seed, density = CASES[case]
    imgs, needles, s_n, s2_n = (torch.from_numpy(a).to(cuda)
                                for a in _inputs(B, H, W, T, nh, nw, seed, density))
    mask, rcnt = ncc_kernels.ncc_sweep(imgs, needles, s_n, s2_n, thr)
    pos, off, hcnt, _ = ncc_kernels.compact_hits(mask, rcnt)
    args = (imgs, pos, off, hcnt, needles, s_n, s2_n, float(np.float32(thr)), 3, 5, max_matches)
    replay_kernels.reset_launches()
    got = replay_kernels.replay_hits(replay_kernels.ncc_replay(*args), off, hcnt)
    torch.cuda.synchronize()
    assert replay_kernels.LAUNCHES == {"ncc_replay": 1}
    want = replay_kernels.replay_hits(replay_kernels.ncc_replay_reference(*args), off, hcnt)
    for a, b in zip(got, want, strict=True):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert a.dtype == b.dtype and torch.equal(a, b)
    if max_matches == 3:  # a needle warns exactly when it reaches the cap
        assert torch.equal(got[4].bool(), got[3] == 3)


@pytest.mark.parametrize("case", ["no-candidates", "blank-page", "dense", "many-chunks"])
def test_compaction_edge_cases(cuda, case):
    """K2's count and emit kernels against their plain versions, bit for bit:
    a wave with no candidate at all (the count runs, the emit has nothing to
    write), a wave with one blank page among inked ones, a dense wave, and
    row counts over many of the count kernel's chunks."""
    rng = np.random.default_rng(len(case))
    B, T, Hs, NW = {"no-candidates": (3, 5, 40, 3), "blank-page": (4, 17, 60, 4),
                    "dense": (2, 9, 70, 5), "many-chunks": (8, 222, 614, 2)}[case]
    density = {"no-candidates": 0.0, "blank-page": 0.05, "dense": 0.9, "many-chunks": 0.01}[case]
    bits = rng.random((B, T, Hs, NW * 32)) < density
    if case == "blank-page":
        bits[1] = False
    words = (bits.reshape(B, T, Hs, NW, 32).astype(np.int64) << np.arange(32)).sum(-1)
    mask = torch.from_numpy(np.where(words >= 2**31, words - 2**32, words).astype(np.int32))
    rcnt = torch.from_numpy(bits.sum(-1).astype(np.int32))
    mask, rcnt = mask.to(cuda), rcnt.to(cuda)
    ncc_kernels.reset_launches()
    row_off, head = ncc_kernels.compact_counts(rcnt)
    out = ncc_kernels.compact_hits(mask, rcnt)
    torch.cuda.synchronize()
    row_off_r, head_r = ncc_kernels.compact_counts_reference(rcnt)
    assert torch.equal(row_off, row_off_r) and torch.equal(head, head_r)
    out_r = ncc_kernels.compact_hits_reference(mask, rcnt)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(out, out_r))
    total = int(bits.sum())
    assert ncc_kernels.LAUNCHES == {"ncc_sweep": 0, "compact_count": 2,
                                    "compact_hits": 1 if total else 0}
    assert (total == 0) == (case == "no-candidates")
    if case == "blank-page":
        assert int(out[3][1]) == 0 and int(out[1][2]) == int(out[1][1])


FOCR_FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_focr_golden.npz"
)


def _ssd_inputs(case, seed):
    """(strips, templates, tsq, wx0) for K4 as numpy arrays."""
    rng = np.random.default_rng(seed)
    if case == "corpus":
        from focr_tpu_torch.fonts.bank import load_grid_bank
        from focr_tpu_torch.models.focr import crop_strips

        banks, _ = load_grid_bank(FOCR_FIXTURE)
        with np.load(FOCR_FIXTURE, allow_pickle=False) as z:
            pages = z["pages"]
        bank = banks[12]
        ys = tuple(39 + 15 * i for i in range(50))
        strips = crop_strips(pages, ys, 12, 45, 608)
        return strips, bank.templates, bank.tsq.astype(np.int64), bank.wx0
    if case.startswith(("tiles-", "strips-", "columns-")) or case == "ties":
        # the cases of tests/test_torch_ssd_tiles.py, which models this walk
        from test_torch_ssd_tiles import _case, columns_case

        if case.startswith("columns-"):
            arrays = columns_case(case[8:])
        elif case.startswith("strips-"):
            arrays = _case(int(case[7:]), 12, 40, 4, 11, 9, seed=seed)
        elif case == "ties":
            strips, templates, tsq, wx0 = _case(18, 12, 60, 6, 30, 9, seed=7)
            templates[:, 20] = templates[:, 28] = templates[:, 3]
            templates[:, [5, 12, 17, 25]] = 0
            strips[4:9] = 255
            arrays = strips, templates, (templates.astype(np.int64) ** 2).sum(axis=(2, 3)), wx0
        else:
            G, win_w = (int(v[1:]) for v in case.split("-")[1:])
            h, crop_w = (1, 3, 12)[(G + win_w) % 3], 4 * win_w + 7
            arrays = _case(21, h, crop_w, 5, G, win_w, seed=G * 100 + win_w,
                           wx0=[0, 3, crop_w - win_w, crop_w - 2, crop_w])
        return (arrays[0][None],) + tuple(arrays[1:])
    B, R, h, crop_w, C, G, win_w = {
        "noise": (4, 9, 12, 608, 78, 67, 9),
        "wide-page": (2, 9, 12, 3000, 40, 67, 9),
        "dup-glyph": (2, 5, 12, 200, 24, 40, 9),
        "narrow": (3, 4, 5, 20, 4, 7, 9),
        "wide-window": (2, 3, 16, 300, 10, 70, 40),
        "i64-dot": (1, 2, 1, 40000, 2, 33, 34000),
    }[case]
    strips = rng.integers(0, 256, (B, R, h, crop_w)).astype(np.uint8)
    strips[0, 0] = 255
    if case == "noise":
        strips[1] = np.clip(rng.integers(250, 262, (R, h, crop_w)), 0, 255)
    templates = rng.integers(0, 256, (C, G, h, win_w), dtype=np.uint8)
    templates[templates < 140] = 0
    wx0 = np.minimum(np.arange(C) * (crop_w // C), crop_w - 1).astype(np.int32)
    if case == "narrow":
        wx0 = np.array([0, 7, 14, 19], np.int32)  # windows hang past crop_w
    tsq = (templates.astype(np.int64) ** 2).sum(axis=(2, 3))
    if case == "dup-glyph":
        templates[:, 30] = templates[:, 3]
        templates[:, [5, 12, 20]] = 0  # empty glyphs: exact ties on white windows
        tsq = (templates.astype(np.int64) ** 2).sum(axis=(2, 3))
        strips[:, :, :, :] = 255
        strips[0, 1] = rng.integers(0, 256, (h, crop_w))
    return strips, templates, tsq, wx0


SSD_CASES = (["corpus", "noise", "dup-glyph", "narrow", "wide-window", "i64-dot", "wide-page",
              "ties", "columns-ascending", "columns-shuffled"]
             + [f"strips-{n}" for n in (1, 15, 16, 17, 33)]
             + [f"tiles-G{g}-w{w}" for g in (1, 8, 9, 67, 200) for w in (1, 3, 4, 5, 9, 13)])


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_argmin_matches_plain_version(cuda, case):
    """Both instances (the shape picks one: i64-dot and wide-page take the
    int64 kernel, the rest the tensor cores) against the plain version."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in _ssd_inputs(case, seed=len(case))]
    h, crop_w, win_w = args[0].shape[2], args[0].shape[3], args[1].shape[3]
    want = "int64" if case in ("i64-dot", "wide-page") else "mma"
    assert ssd_kernels.ssd_plan(h, crop_w, win_w)[0] == want
    ssd_kernels.reset_launches()
    ids, white = ssd_kernels.ssd_argmin(*args)
    torch.cuda.synchronize()
    assert ssd_kernels.LAUNCHES == {"ssd_argmin": 1, "ssd_argmin_partial": 0, "ssd_combine": 0}
    ids_r, white_r = ssd_kernels.ssd_argmin_reference(*args)
    assert torch.equal(ids, ids_r) and torch.equal(white, white_r)
    assert case == "strips-1" or not bool(white.all())  # its one strip is white
    assert case == "corpus" or bool(white[0, 0])


@pytest.mark.parametrize("n_g", [2, 4, 8])
@pytest.mark.parametrize("case", ["corpus", "noise", "dup-glyph", "narrow", "i64-dot", "ties",
                                  "strips-17", "tiles-G9-w5", "tiles-G67-w9"])
def test_partial_and_combine_match_plain_versions(cuda, case, n_g):
    """K4p (both instances) on every glyph slice of the bank and K6 on the
    gathered partials against their plain versions, bit for bit; the combined
    ids are unsharded K4's (duplicated and padded glyphs tie across shards:
    the lowest shard must win)."""
    from focr_tpu_torch.parallel.decode import shard_grid_bank

    strips, templates, tsq, wx0 = _ssd_inputs(case, seed=len(case))
    dev = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (strips, wx0)]
    ssd_kernels.reset_launches()
    vals, lids = [], []
    slices = shard_grid_bank(templates, tsq, n_g)
    Gl = slices[0][0].shape[1]
    for tmpl, tq in slices:
        args = (dev[0], torch.from_numpy(tmpl).to(cuda), torch.from_numpy(tq).to(cuda), dev[1])
        ids, val, white = ssd_kernels.ssd_argmin_partial(*args)
        ids_r, val_r, white_r = ssd_kernels.ssd_argmin_partial_reference(*args)
        torch.cuda.synchronize()
        assert val.dtype == torch.int64 and torch.equal(val, val_r)
        assert torch.equal(ids, ids_r) and torch.equal(white, white_r)
        vals.append(val), lids.append(ids)
    vals, lids = torch.stack(vals), torch.stack(lids)
    out = ssd_kernels.first_min_combine(vals, lids, Gl)
    torch.cuda.synchronize()
    assert ssd_kernels.LAUNCHES == {"ssd_argmin": 0, "ssd_argmin_partial": n_g, "ssd_combine": 1}
    assert torch.equal(out, ssd_kernels.first_min_combine_reference(vals, lids, Gl))
    full, _ = ssd_kernels.ssd_argmin(dev[0], torch.from_numpy(templates).to(cuda),
                                     torch.from_numpy(tsq).to(cuda), dev[1])
    assert torch.equal(out, full)


@pytest.mark.parametrize("n_g,n", [(1, 1), (2, 255), (4, 256), (8, 257), (3, 62400), (8, 1 << 20)])
def test_first_min_combine_ties(cuda, n_g, n):
    """K6 on few distinct values (most columns tie), on values past f64's
    exact integers, with the minimum in the last shard, and all equal."""
    rng = np.random.default_rng(n)
    vals = rng.integers(-2, 3, (n_g, n)).astype(np.int64) * 2**40 + 2**61
    vals[:, : n // 4] = 7
    vals[-1, n // 4 : n // 2] = -(2**62)
    ids = rng.integers(0, 1 << 20, (n_g, n)).astype(np.int32)
    v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    ssd_kernels.reset_launches()
    Gl = 1 + n % 97  # glyphs a shard: the local ids become the bank's
    out = ssd_kernels.first_min_combine(v, i, Gl)
    torch.cuda.synchronize()
    assert ssd_kernels.LAUNCHES["ssd_combine"] == 1
    gids = ids + (np.arange(n_g, dtype=np.int32) * Gl)[:, None]
    want = np.take_along_axis(gids, np.argmin(vals, axis=0)[None], axis=0)[0]
    assert np.array_equal(out.cpu().numpy(), want)
    assert torch.equal(out, ssd_kernels.first_min_combine_reference(v, i, Gl))


PROP_FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_prop_golden.npz"
)


def _prop_inputs(case, seed):
    """(strips, templates, colsq_cum, advances, base, ox, n_steps) for K5 as
    numpy arrays and numbers, from the prop golden's bank."""
    from focr_tpu_torch.fonts.bank import load_grid_bank
    from focr_tpu_torch.models.focr import crop_strips
    from focr_tpu_torch.models.focr_prop import max_steps

    banks, _ = load_grid_bank(PROP_FIXTURE)
    rng = np.random.default_rng(seed)
    h = 3 if case == "corpus-h3" else 12
    bank = banks[h]
    templates, colsq, adv = bank.templates, bank.colsq_cum, bank.advances
    if case.startswith("corpus"):
        with np.load(PROP_FIXTURE, allow_pickle=False) as z:
            pages = z["pages"]
        ys = (789,) if h == 3 else tuple(39 + 15 * i for i in range(50))
        strips = 255 - crop_strips(pages, ys, h, 45, 608).reshape(-1, h, 608)
        if h == 3:  # the corpus' bottom row is white: give it ink
            strips = rng.integers(0, 256, strips.shape).astype(np.uint8)
    elif case == "noise":
        strips = rng.integers(0, 256, (40, 12, 608)).astype(np.uint8)
    elif case.startswith("synthetic"):
        # G glyphs of h x wbank: G around the kernel's 32-glyph warp groups,
        # wbank not a multiple of 4, L not a multiple of anything
        G, h, wbank, L, crop_w = {"synthetic-G1": (1, 5, 7, 5, 90),
                                  "synthetic-G33": (33, 12, 19, 7, 300),
                                  "synthetic-G67-wbank6": (67, 4, 6, 13, 200),
                                  "synthetic-G200": (200, 3, 11, 3, 150)}[case]
        templates = rng.integers(0, 256, (G, 64, h, wbank)).astype(np.uint8)
        templates[templates < 150] = 0
        sq = (templates.astype(np.int64) ** 2).sum(axis=2)
        colsq = np.zeros((G, 64, wbank + 1), np.int32)
        colsq[..., 1:] = np.cumsum(sq, axis=-1)
        adv = rng.uniform(2.5, 9.0, G).astype(np.float32)
        strips = rng.integers(0, 256, (L, h, crop_w)).astype(np.uint8)
        return strips, templates, colsq, adv, 3, 0.4, crop_w // 2
    elif case == "dup-glyphs":
        order = np.r_[np.arange(67), [3, 17, 40]]
        templates, colsq, adv = templates[order], colsq[order], adv[order]
        strips = rng.integers(0, 256, (9, 12, 300)).astype(np.uint8)
        strips[:3] = 0
    else:  # narrow: windows hang past the strip's edge
        strips = rng.integers(0, 256, (6, 12, 20)).astype(np.uint8)
    crop_w = strips.shape[2]
    n_steps = max_steps(bank, crop_w)
    return (np.ascontiguousarray(strips), templates, colsq, adv, bank.base, float(bank.ox),
            n_steps)


@pytest.mark.parametrize("case", ["corpus-h12", "corpus-h3", "noise", "dup-glyphs", "narrow",
                                  "synthetic-G1", "synthetic-G33", "synthetic-G67-wbank6",
                                  "synthetic-G200"])
def test_prop_scan_matches_plain_version(cuda, case):
    *arrays, base, ox, n_steps = _prop_inputs(case, seed=len(case))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays]
    prop_kernels.reset_launches()
    ids = prop_kernels.prop_scan(*args, base, ox, n_steps)
    torch.cuda.synchronize()
    assert prop_kernels.LAUNCHES == {"prop_scan": 1}
    ids_r = prop_kernels.prop_scan_reference(*args, base, ox, n_steps)
    assert torch.equal(ids, ids_r)
    assert bool((ids != prop_kernels.END_ID).any(dim=1).all())
    if case == "dup-glyphs":
        assert not bool((ids >= 67).logical_and(ids != prop_kernels.END_ID).any())
