"""On the card: the control, the program at its TF32 precision
(--matmul_precision default), must come out not correct at the cell's
own size; a sound run at the same size must come out correct."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(workload, seed, control):
    out = subprocess.run(
        [sys.executable, "-m", "speedbench", "--workload", workload,
         "--seed", str(seed), "--seconds", "4", "--trace", "0",
         "--control", str(int(control))],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["dap_v1.offline_b16",
                                      "agap_v1.offline_b16"])
def test_control_is_not_correct(card, workload):
    assert not run(workload, 91, True)["correct"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["dap_v1.offline_b16"])
def test_sound_run_is_correct(card, workload):
    assert run(workload, 92, False)["correct"]
