"""The benchmark on the card: one cell for a few seconds through its
command, and the control of ``correct`` at the cell's own size. Marked
``cuda``; each test skips where there is no CUDA device. On a machine with
one: ``python -m pytest -m cuda portbench/tests/test_portbench_cuda.py``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.control import readings
from portbench.driver import HERE, load

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels have no CPU mode)")


def test_one_cell_runs(card):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "boston-hmc-c8",
                          "--seed", "2147483907", "--seconds", "3", "--trace", "0"],
                         cwd=os.path.dirname(HERE), capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-3000:]
    assert res["device"]["platform"] == "gpu" and res["metrics"]["draws_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"


def test_control_fails_and_program_passes(card):
    name = "boston-hmc-c8"
    w = load("workloads", name)
    cfg, mix = load("configs", w["config"]), load("traffic", w["traffic"])
    for seed in (101, 102, 103):
        r = readings(w, cfg, mix, seed, control=w["control"])
        assert r["program_correct"] and not r["control_correct"], r
