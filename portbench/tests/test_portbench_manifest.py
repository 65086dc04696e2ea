"""BENCHMARK.json and the benchmark's files against the contract's form, and
the benchmark's imports."""

import ast
import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_form(manifest):
    assert set(manifest) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= manifest["run_seconds"] <= 51
    assert all(_line(w) for w in manifest["command"])
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    names = [c["name"] for c in manifest["configs"]]
    assert len(set(names)) == len(names)
    cells = manifest["workloads"]
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", f"{w['traffic']}.json"))
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert {w["config"] for w in cells} == set(names)
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", [])) <= {w["name"] for w in cells}
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in manifest["end_to_end"])


def test_every_cell_reports_what_it_must(manifest):
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"], manifest)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)


def _modules():
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_nothing_imports_jax_or_focr_tpu():
    for path in _modules():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "focr_tpu"}, path


def test_the_references_import_nothing_of_the_program():
    for f in os.listdir(os.path.join(ROOT, "portbench", "reference")):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ROOT, "portbench", "reference", f))}
            assert "focr_tpu_torch" not in tops and "focr_tpu" not in tops, f


def test_file_names_use_a_names_characters():
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        if "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
