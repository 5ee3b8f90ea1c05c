"""Readings of the comparison that decides `correct`, over many seeds, for
the program as its configuration states it and for the control: the port
with its next lower matmul precision switched on (`high`, one TF32
product, below the configuration's `highest`). The benchmark's own runs
never run this; the limits in limits/<cell>.json are set from its
readings (PERF.md gives them).

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 2 [--precisions highest,high]

Every seed and precision runs in one process (the precision is read at
each call). Prints one JSON line a reading.
"""
import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--precisions", default="highest,high")
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(HERE))
    from harness import check, core, inputs
    seeds = [int(s) for s in a.seeds.split(",")]
    precisions = a.precisions.split(",")
    cell = core.Cell(a.workload, ROOT)
    prog = core.Program(cell, {"seed": seeds[0], "device_type": "cuda"})
    shape = cell.shape()
    for i in range(core.WARMUP_CALLS):
        prog.call(inputs.WARMUP, i)
    for precision in precisions:
        os.environ["OFDM_LTE_TPU_TORCH_MATMUL_PRECISION"] = precision
        prog.call(inputs.WARMUP, 0)
        for seed in seeds:
            prog.seed = seed
            lat, res, _ = core.loop(prog, a.seconds)
            sample = core.sample_calls(seed, res, [], int(cell.traffic.get("check_calls", 8)))
            readings = core.reference_readings(cell, shape, prog, seed, sample)
            ok, failed, checks = check.verdict(readings, cell.limits)
            print(json.dumps({"workload": a.workload, "precision": precision, "seed": seed,
                              "calls": len(res), "checked": len(readings), "correct": ok,
                              "worst": check.worst(readings), "each": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
