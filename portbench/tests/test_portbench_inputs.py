"""The generator: pages from the seed, every band's ink inside it."""

import numpy as np
import pytest

from portbench import harness
from portbench.lib import pages as P
import portbench_cells


def _cell(name):
    cell = portbench_cells.load_cell(name)
    with np.load(f"{harness.ROOT}/{cell.config['data']}") as z:
        return cell, z["pages"]


@pytest.mark.parametrize("name", ["focr-b64-mono13.doc64", "ncc-b64-mono13.doc64"])
def test_pool_is_deterministic_by_seed(name):
    cell, source = _cell(name)
    traffic = {**cell.traffic, "pool_pages": 6}
    a = P.make_pool(source, cell.config["bands"], traffic, 2**31 + 17)
    b = P.make_pool(source, cell.config["bands"], traffic, 2**31 + 17)
    c = P.make_pool(source, cell.config["bands"], traffic, 2**31 + 18)
    assert (a == b).all() and not (a == c).all()
    assert len({p.tobytes() for p in a}) == len(a)  # distinct pages
    docs = P.documents(cell.traffic, 5), P.documents(cell.traffic, 5)
    for _ in range(3):
        assert (next(docs[0]) == next(docs[1])).all()


@pytest.mark.parametrize("name", ["focr-b64-mono13.doc64", "ncc-b64-mono13.doc64"])
def test_bands_keep_their_ink_inside(name):
    cell, source = _cell(name)
    bands = cell.config["bands"]
    cut = P.cut_bands(source, bands)
    assert cut.shape == (len(source) * bands["lines"], bands["pitch"], source.shape[2])
    # every band of a made page is a band of the source, and nothing else is inked
    pool = P.make_pool(source, bands, {**cell.traffic, "pool_pages": 3}, 9)
    have = {b.tobytes() for b in cut}
    for page in pool:
        y0, y1 = bands["y0"], bands["y0"] + bands["pitch"] * bands["lines"]
        assert (page[:y0] == 255).all() and (page[y1:] == 255).all()
        for band in P.cut_bands(page[None], bands):
            assert band.tobytes() in have


def test_a_band_whose_ink_leaks_is_refused():
    cell, source = _cell("focr-b64-mono13.doc64")
    bands = cell.config["bands"]
    bad = source[:1].copy()
    bad[0, bands["y0"] + bands["ink_rows"], 100] = 0  # ink in the gap between two lines
    with pytest.raises(ValueError, match="reaches past"):
        P.cut_bands(bad, bands)
    bad = source[:1].copy()
    bad[0, 2, 100] = 0  # ink above the first band
    with pytest.raises(ValueError, match="outside"):
        P.cut_bands(bad, bands)


def test_sparse_pages_ink_the_first_last_and_four_more():
    cell, source = _cell("ncc-b64-mono13.sparse64")
    bands = cell.config["bands"]
    pool = P.make_pool(source, bands, {**cell.traffic, "pool_pages": 5}, 31)
    for page in pool:
        rows = page[bands["y0"]:bands["y0"] + bands["pitch"] * bands["lines"]]
        inked = (rows.reshape(bands["lines"], bands["pitch"], -1) != 255).any(axis=(1, 2))
        assert inked.sum() == 6 and inked[0] and inked[-1]


def test_pgm_round_trip(tmp_path):
    page = np.random.default_rng(0).integers(0, 256, (7, 5), dtype=np.uint8)
    P.write_pgm(str(tmp_path / "p.pgm"), page)
    data = (tmp_path / "p.pgm").read_bytes()
    assert data.startswith(b"P5\n5 7\n255\n")
    assert np.frombuffer(data[len(b"P5\n5 7\n255\n"):], np.uint8).reshape(7, 5).tolist() == page.tolist()
