"""ncc's CLI (--device cpu) on the benchmark's pages: seeded P5 pages of real
line renders (portbench/lib/pages.py) and the saved needle bank of the
ncc-b64-mono13 configuration.

The pages are read through the shared loaders (a raw 8-bit P5 page mapped
read-only): stdout is the plain reference's, and stdout and stderr are what
reading every page with load_gray, one after another, gave, with an
unreadable page among them and under --strict. --metrics-json reports the
call's counters, zeroed at each call's start, and a profiler sees the call's
stages once a call, and nothing once a page."""

import json
import os

import numpy as np
import pytest
import torch

from focr_tpu_torch.cli.ncc import main as torch_main
from focr_tpu_torch.io import images as timages
from focr_tpu_torch.models import ncc as torch_ncc
from focr_tpu_torch.utils.metrics import TRACE_NAME
from portbench.drivers import ncc as driver
from portbench.lib import pages as P
from portbench.reference import ncc as reference

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "portbench", "configs", "ncc-b64-mono13.json")) as f:
    CONFIG = json.load(f)
BANK = os.path.join(REPO, CONFIG["bank"])
# two inked lines a page keep the plain sweep's crop, and the test, small
TRAFFIC = {"pool_pages": 3, "pages_per_call": 3, "inked": {"always": [0, 1], "random": 0}}
NEW_SPANS = ("ncc_bank_load", "ncc_matcher_build", "ncc_page_read", "ncc_print")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """Three pool pages as P5 files, an unreadable page, and the reference's
    lines of each readable page."""
    with np.load(BANK, allow_pickle=False) as z:
        source = z["pages"]
    pages = P.make_pool(source, CONFIG["bands"], TRAFFIC, 2**31 + 41)
    d = tmp_path_factory.mktemp("ncc_reads")
    paths = P.write_pool(pages, str(d))
    bad = d / "bad.pgm"
    bad.write_bytes(b"P5\n10 10\n255\n\x00")
    lines, _ = reference.expected_lines(pages, BANK, CONFIG, "cpu")
    return paths, str(bad), lines


def _argv(paths, metrics=None, *extra):
    return [*driver.argv(CONFIG, BANK, paths, "cpu", metrics), *extra]


def _text(lines):
    """The stdout of pages whose lines are ``lines``."""
    return "".join(ln + "\n" for page in lines for ln in page)


def _run(argv, capsys):
    rc = torch_main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _serial_reads(monkeypatch):
    """The page reads as the CLI made them before the shared loaders: every
    page by load_gray, one after another, a writable copy each."""

    def isolated(paths):
        pages, errors = [], []
        for i, path in enumerate(paths):
            try:
                pages.append(timages.load_gray(path))
            except Exception as e:  # noqa: BLE001 - per-page isolation, as the CLI does
                pages.append(None)
                errors.append((i, f"{type(e).__name__}: {e}"))
        return pages, errors

    monkeypatch.setattr(timages, "load_gray_many_isolated", isolated)
    monkeypatch.setattr(timages, "load_gray_many", lambda paths: [timages.load_gray(p)
                                                                  for p in paths])


def test_stdout_and_stderr_with_a_bad_page(pool, capsys, monkeypatch, tmp_path):
    """A bad page among the pool's: the reference's lines for the others in
    page order, the same ERROR line, and the bytes of the serial reads."""
    paths, bad, lines = pool
    docs = [paths[0], bad, paths[1], paths[2]]
    rc, out, err = _run(_argv(docs, str(tmp_path / "m.json")), capsys)
    assert rc == 0
    assert out == _text(lines) and out
    assert err.startswith(f"ERROR {bad}: ValueError: ") and err.count("\n") == 1
    counters = json.loads((tmp_path / "m.json").read_text())["counters"]
    # the readable pages are mapped; the bad one is left to load_gray, which fails
    assert (counters["pages_mapped"], counters["pages_decoded"]) == (3, 0)
    with monkeypatch.context() as m:
        _serial_reads(m)
        assert _run(_argv(docs), capsys) == (0, out, err)


def test_strict_raises_what_the_serial_reads_raised(pool, capsys, monkeypatch):
    paths, bad, _ = pool
    argv = _argv([paths[0], bad, paths[1]], None, "--strict")
    with pytest.raises(ValueError) as new:
        torch_main(argv)
    with monkeypatch.context() as m:
        _serial_reads(m)
        with pytest.raises(ValueError) as old:
            torch_main(argv)
    assert str(new.value) == str(old.value) and bad in str(new.value)
    assert capsys.readouterr().out == ""


def test_the_pages_reach_the_pipeline_read_only(pool, capsys, monkeypatch):
    """Nothing downstream writes into a page: the pipeline is handed the
    maps themselves."""
    paths, _, lines = pool
    seen = []
    inner = torch_ncc.NccMatcher.get_hits_many

    def spy(self, pages, *a, **k):
        seen.extend(pages)
        return inner(self, pages, *a, **k)

    monkeypatch.setattr(torch_ncc.NccMatcher, "get_hits_many", spy)
    rc, out, _ = _run(_argv(paths), capsys)
    assert rc == 0 and out == _text(lines)
    assert len(seen) == 3 and not any(p.flags.writeable for p in seen)


def test_counters_and_spans_once_a_call(pool, capsys, tmp_path):
    """--metrics-json's counters, the same in a second call of the process
    but for the post's time; under --profile the call's new stages open once
    a call, and no ncc span opens more often than the call has waves."""
    paths, _, _ = pool
    runs = []
    for k in range(2):
        mj, prof = tmp_path / f"m{k}.json", tmp_path / f"tr{k}"
        rc, out, _ = _run(_argv(paths, str(mj), "--profile", str(prof)), capsys)
        assert rc == 0 and out
        runs.append((json.loads(mj.read_text())["counters"],
                     json.loads((prof / TRACE_NAME).read_text())["traceEvents"]))
    (first, events), (second, _) = runs
    assert set(first) == {"ncc_candidates", "ncc_hits", "ncc_host_waits", "ncc_post_ns",
                          "ncc_post_native", "pages_mapped", "pages_decoded"}
    assert first["pages_mapped"] == 3 and first["pages_decoded"] == 0
    assert first["ncc_post_native"] == 3  # each page posted in one host-library call
    assert first["ncc_candidates"] >= first["ncc_hits"] > 0
    waves = -(-3 // torch_ncc.WAVE)
    assert first["ncc_host_waits"] == waves * (len(CONFIG["needles"]["groups"]) + 1)
    assert first["ncc_post_ns"] > 0 and second["ncc_post_ns"] > 0
    assert {k: v for k, v in first.items() if k != "ncc_post_ns"} == {
        k: v for k, v in second.items() if k != "ncc_post_ns"}
    names = [e.get("name", "") for e in events if e.get("ph") == "X"]
    for name in NEW_SPANS:
        assert names.count(name) == 1, name
    assert names.count("focr_ncc_dispatch_wave") == waves
    assert all(names.count(n) <= waves for n in set(names) if n.startswith(("ncc_", "focr_ncc")))


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_the_collect_pool_size_changes_nothing(pool, capsys, monkeypatch, threads):
    """The collect pool at 1, at its compiled-in 2 and at 4 threads: the
    reference's stdout, and nothing on stderr."""
    paths, _, lines = pool
    monkeypatch.setattr(torch_ncc, "COLLECT_THREADS", threads)
    assert _run(_argv(paths), capsys) == (0, _text(lines), "")
