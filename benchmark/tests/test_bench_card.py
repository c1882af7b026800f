"""On the card: one short run of each cell through the command, as the
check runs it (skips without a card; the benchmark's own runs are the
full measurement)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    done = subprocess.run(
        [sys.executable] + SPEC["command"][1:] + [
            "--workload", cell, "--seed", "2147483713", "--seconds", "3",
            "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=1200)
    assert done.returncode == 0, done.stderr[-3000:]
    assert json.loads(done.stdout.strip().splitlines()[-1])["correct"]
