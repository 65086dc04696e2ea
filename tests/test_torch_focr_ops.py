"""focr_tpu_torch's SSD ops and the plain K4 (ssd_argmin_reference) against
focr_tpu/ops/ssd.py and make_strip_forward, on the CPU, exactly: equal
windows, correlations, metrics and first-minimum ids."""

import numpy as np
import pytest
import torch

from focr_tpu.fonts.bank import GridBank as JGridBank
from focr_tpu.models.focr import make_strip_forward
from focr_tpu.ops import ssd as jssd
from focr_tpu_torch.ops import ssd, ssd_kernels

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("ys", [(2, 9, 16), (0, 3, 11), (5,)], ids=["uniform", "irregular", "one"])
def test_extract_strips_matches_jax(ys):
    rng = np.random.default_rng(len(ys))
    inv = rng.integers(0, 256, (2, 30, 40)).astype(np.int32)
    want = np.asarray(jssd.extract_strips(inv, ys, 6, 3, 31))
    assert np.array_equal(ssd.extract_strips(t(inv), ys, 6, 3, 31).numpy(), want)


def test_extract_windows_zero_pad_matches_jax():
    """Windows that hang past crop_w read zeros in both packages."""
    rng = np.random.default_rng(3)
    strips = rng.integers(0, 256, (2, 3, 5, 20)).astype(np.int32)
    wx0 = np.array([0, 4, 11, 15, 19], dtype=np.int32)
    want = np.asarray(jssd.extract_windows(strips, wx0, 9))
    got = ssd.extract_windows(t(strips), wx0, 9).numpy()
    assert np.array_equal(got, want)
    assert (got[:, :, 4, :, 1:] == 0).all()


# window sizes on both sides of focr_tpu's ladder bounds (258: one bf16
# matmul; 4385: template nibbles; above: both nibbles), of its i32 metric
# bound (11008), of its i32 dot combine (33026) and of its accepted maximum
@pytest.mark.parametrize("K", [258, 259, 4385, 4386, 11008, 11009, 33100, 74565])
def test_exact_corr_mat_matches_jax_and_numpy(K):
    rng = np.random.default_rng(K)
    wins = rng.integers(0, 256, (4, K)).astype(np.int32)
    tmpl = rng.integers(0, 256, (5, K), dtype=np.uint8)
    wins[0] = 255
    tmpl[0] = 255
    want = wins.astype(np.int64) @ tmpl.T.astype(np.int64)
    got = ssd.exact_corr_mat(t(wins), t(tmpl))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(np.asarray(jssd.exact_corr_mat(wins, tmpl)).astype(np.int64), want)


@pytest.mark.parametrize(
    "h,w", [(6, 43), (7, 37), (5, 877), (2, 2193), (16, 688), (1, 11009)],
    ids=["n258", "n259", "n4385", "n4386", "n11008", "n11009"],
)
def test_ssd_metric_and_argmin_match_jax(h, w):
    """The metric in int64 equals focr_tpu's (i32 below n = 11008, i64 from
    there on), and the first-minimum ids agree, with duplicated templates
    making exact ties."""
    rng = np.random.default_rng(h * w)
    C, G = 2, 6
    wins = rng.integers(0, 256, (1, 2, C, h, w)).astype(np.int32)
    wins[0, 0, 0] = 255
    tmpl = rng.integers(0, 256, (C, G, h, w), dtype=np.uint8)
    tmpl[:, 4] = tmpl[:, 1]  # duplicate glyph: ties everywhere glyph 1 is best
    tmpl[0, 0] = 255
    tsq = (tmpl.astype(np.int64) ** 2).sum(axis=(2, 3))
    want = np.asarray(jssd.ssd_metric(wins, tmpl, tsq)).astype(np.int64)
    got = ssd.ssd_metric(t(wins), t(tmpl), t(tsq))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    ids = ssd.argmin_glyph(got)
    assert ids.dtype == torch.int32
    assert np.array_equal(ids.numpy(), np.asarray(jssd.argmin_glyph(want)))


def test_argmin_glyph_first_minimum():
    metric = torch.tensor([[5, 3, 3, 9], [1, 1, 1, 1], [7, 8, 2, 2], [-4, 0, -4, -5]])
    assert ssd.argmin_glyph(metric).tolist() == [1, 0, 2, 3]
    assert ssd.argmin_glyph(metric).tolist() == np.asarray(
        jssd.argmin_glyph(metric.numpy())).tolist()


@pytest.mark.parametrize("fn", ["corr_mat", "metric"])
def test_window_bound_raises_like_jax(fn):
    """A window of more than 74565 pixels is refused by both packages."""
    K = ssd.MAX_WINDOW + 1
    w = np.zeros((1, K), np.int32)
    tm = np.zeros((1, K), np.uint8)
    with pytest.raises(AssertionError, match="74565"):
        jssd.exact_corr_mat(w, tm)
    with pytest.raises(ValueError, match="74565"):
        if fn == "corr_mat":
            ssd.exact_corr_mat(t(w), t(tm))
        else:
            ssd.ssd_metric(t(w.reshape(1, 1, 1, 1, K)), t(tm.reshape(1, 1, 1, K)),
                           torch.zeros((1, 1), dtype=torch.int64))


def _bank(rng, C, G, h, win_w, crop_w, dup=()):
    templates = rng.integers(0, 256, (C, G, h, win_w), dtype=np.uint8)
    templates[templates < 150] = 0  # glyph-like sparse ink
    for a, b in dup:
        templates[:, b] = templates[:, a]
    wx0 = np.minimum(np.arange(C) * 7, crop_w - 1).astype(np.int32)
    extra = rng.integers(0, 10**5, (C, G))  # the ink outside each window
    extra[:, [b for _, b in dup]] = extra[:, [a for a, _ in dup]]
    tsq = ((templates.astype(np.int64) ** 2).sum(axis=(2, 3)) + extra).astype(np.int32)
    return templates, tsq, wx0


STRIP_CASES = {  # (B, R, h, crop_w, C, G, win_w, strip maker, duplicated glyphs)
    "noise": (2, 3, 12, 40, 6, 11, 9, "noise", ()),
    "near-white": (2, 4, 12, 40, 6, 11, 9, "near-white", ()),
    "dup-glyphs": (1, 3, 7, 30, 4, 9, 8, "noise", ((2, 5), (0, 8))),
    "hang-past-crop": (2, 2, 5, 20, 4, 7, 9, "noise", ()),
    "white-rows": (3, 3, 3, 25, 4, 5, 6, "white", ()),
}


def _strips(kind, rng, B, R, h, crop_w):
    if kind == "noise":
        s = rng.integers(0, 256, (B, R, h, crop_w))
    elif kind == "near-white":
        s = np.clip(rng.integers(250, 262, (B, R, h, crop_w)), 0, 255)
    else:
        s = np.full((B, R, h, crop_w), 255)
        s[0, 1, 0, 3] = 0
    s = s.astype(np.uint8)
    s[0, 0] = 255  # an all-white strip
    return s


@pytest.mark.parametrize("case", list(STRIP_CASES))
def test_ssd_argmin_reference_matches_strip_forward(case):
    B, R, h, crop_w, C, G, win_w, kind, dup = STRIP_CASES[case]
    rng = np.random.default_rng(len(case))
    templates, tsq, wx0 = _bank(rng, C, G, h, win_w, crop_w, dup)
    strips = _strips(kind, rng, B, R, h, crop_w)
    jbank = JGridBank(alphabet="x" * G, templates=templates, tsq=tsq, wx0=wx0,
                      positions=np.zeros(C, np.float32), crop_w=crop_w, crop_h=h,
                      monospace=True)
    want_ids, want_white = (np.asarray(a) for a in make_strip_forward(jbank)(strips))
    args = (t(strips), t(templates), t(tsq.astype(np.int64)), t(wx0))
    ids, white = ssd_kernels.ssd_argmin_reference(*args)
    assert ids.dtype == torch.int32 and white.dtype == torch.bool
    assert np.array_equal(ids.numpy(), want_ids.astype(np.int32))
    assert np.array_equal(white.numpy(), want_white)
    assert white[0, 0] and (not dup or not np.isin(ids.numpy(), [b for _, b in dup]).any())
    ssd_kernels.reset_launches()
    ids2, white2 = ssd_kernels.ssd_argmin(*args)  # CPU tensors: the plain version
    assert torch.equal(ids2, ids) and torch.equal(white2, white)
    assert ssd_kernels.LAUNCHES == {"ssd_argmin": 0, "ssd_argmin_partial": 0,
                                    "ssd_combine": 0, "ssd_combine_fold": 0}


@pytest.mark.parametrize(
    "bad", ["height", "tsq", "wx0", "empty-alphabet", "window"],
)
def test_ssd_argmin_rejects_bad_shapes(bad):
    strips = torch.zeros((1, 2, 4, 10), dtype=torch.uint8)
    tm = torch.zeros((3, 5, 4, 6), dtype=torch.uint8)
    tsq = torch.zeros((3, 5), dtype=torch.int64)
    wx0 = torch.zeros(3, dtype=torch.int32)
    if bad == "height":
        tm = torch.zeros((3, 5, 3, 6), dtype=torch.uint8)
    elif bad == "tsq":
        tsq = torch.zeros((3, 4), dtype=torch.int64)
    elif bad == "wx0":
        wx0 = torch.zeros(2, dtype=torch.int32)
    elif bad == "empty-alphabet":
        tm, tsq = tm[:, :0], tsq[:, :0]
    else:
        strips = torch.zeros((1, 1, 1, 80000), dtype=torch.uint8)
        tm = torch.zeros((3, 5, 1, 74566), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ssd_kernels.ssd_argmin(strips, tm, tsq, wx0)
