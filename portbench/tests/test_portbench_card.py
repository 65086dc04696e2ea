"""On the card: one short run of each cell, end to end through
`portbench/run.py`; ``correct`` must hold. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "focr-b64-mono13.doc64", "focr-b64-mono13.page1"])
def test_a_short_run_is_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.splitlines()[-1])["correct"] is True
