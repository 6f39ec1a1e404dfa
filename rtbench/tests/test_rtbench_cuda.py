"""The benchmark's command on the card: each cell for a short window
(``python -m pytest rtbench/tests -m cuda`` on a machine with a GPU)."""

import json
import subprocess
import sys

import pytest
import torch

from rtbench import core

CELLS = tuple(w["name"] for w in core.load_json(core.CHECKOUT / "BENCHMARK.json")["workloads"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    proc = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload", cell, "--seed",
                           "2147483659", "--seconds", "1", "--trace", str(trace)],
                          cwd=core.CHECKOUT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    proc = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload",
                           "builtin_1080p.anim64", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=core.CHECKOUT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
