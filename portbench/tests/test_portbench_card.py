"""On the card (marked `cuda`; skips without one): the control (the port
with its `high` (TF32) products switched on; for the HARQ cell also the
reference with its decoder in bfloat16 in the program's place) comes out
not correct on the cells at their own sizes, while the program as
configured passes; and so does each of harness/faults.py's faults planted
under the HARQ cell's timed path.
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


def readings(workload, precisions, seeds, seconds=1.0, faults=""):
    r = subprocess.run([sys.executable, str(BENCH / "control.py"), "--workload", workload,
                        "--seeds", seeds, "--seconds", str(seconds), "--precisions", precisions,
                        "--faults", faults],
                       capture_output=True, text=True, cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", [("siso64_awgn", "high"), ("siso64_peda", "high"),
                                              ("siso64_awgn_wide", "high"),
                                              ("harq75376_awgn", "high"),
                                              ("harq75376_awgn", "reference-bf16")])
def test_control_fails_where_the_program_passes(card, workload, control):
    out = readings(workload, f"highest,{control}", "7001,7002,7003")
    program = [o for o in out if o["precision"] == "highest"]
    controls = [o for o in out if o["precision"] == control]
    assert len(program) == 3 and len(controls) == 3
    assert all(o["correct"] for o in program)
    assert not any(o["correct"] for o in controls)


@pytest.mark.cuda
def test_harq_faults_are_not_correct(card):
    out = readings("harq75376_awgn", "", "7004,7005,7006", faults="stale,half,answer,crc")
    assert len(out) == 12 and not any(o["correct"] for o in out)
