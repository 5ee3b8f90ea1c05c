"""On the card (marked `cuda`; skips without one): the control, the port
with its `high` (TF32) products switched on, comes out not correct on the
cells at their own sizes, while the program as configured passes.
Run with `python -m pytest portbench/tests -q -m cuda` on a machine with a
card."""
import json
import subprocess
import sys

import pytest
import torch

from pb_helpers import BENCH, REPO


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU form")


def readings(workload, precisions, seeds, seconds=1.0):
    r = subprocess.run([sys.executable, str(BENCH / "control.py"), "--workload", workload,
                        "--seeds", seeds, "--seconds", str(seconds), "--precisions", precisions],
                       capture_output=True, text=True, cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["siso64_awgn", "siso64_peda", "siso64_awgn_wide"])
def test_control_fails_where_the_program_passes(card, workload):
    out = readings(workload, "highest,high", "7001,7002,7003")
    program = [o for o in out if o["precision"] == "highest"]
    control = [o for o in out if o["precision"] == "high"]
    assert len(program) == 3 and len(control) == 3
    assert all(o["correct"] for o in program)
    assert not any(o["correct"] for o in control)
