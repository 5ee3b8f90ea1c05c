"""Readings of the comparison that decides `correct`, over many seeds, for
the program as its configuration states it, for the controls, and for the
program with a fault planted under its timed path. The controls: the port
with its next lower matmul precision switched on (`high`, one TF32
product, below the configuration's `highest`), and, for an entry whose
reference takes a `decoder_dtype` (the HARQ entry), that reference with
its combining and decoder in bfloat16 in the program's place
(`reference-bf16`, below the configuration's float32 decoder). The faults
are harness/faults.py's (the HARQ entry). The benchmark's own runs never
run this; the limits in limits/<cell>.json are set from its readings
(PERF.md gives them).

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 2 [--precisions highest,high,reference-bf16] \\
        [--faults stale,half,answer,crc --fault-seeds 21,22,23]

Every seed, precision and fault runs in one process (the precision is read
at each call). Prints one JSON line a reading.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
REFERENCE_CONTROL = "reference-bf16"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--precisions", default="highest,high")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(HERE))
    import torch
    from harness import check, core, faults, inputs
    seeds = [int(s) for s in a.seeds.split(",")]
    cell = core.Cell(a.workload, ROOT)
    prog = core.Program(cell, {"seed": seeds[0], "device_type": "cuda"})
    shape = cell.shape()
    for i in range(core.WARMUP_CALLS):
        prog.call(inputs.WARMUP, i)
    runs = [(p, None, seeds) for p in a.precisions.split(",") if p]
    fault_seeds = [int(s) for s in (a.fault_seeds or a.seeds).split(",")]
    runs += [(cell.config["precision"], f, fault_seeds) for f in a.faults.split(",") if f]
    for precision, fault, run_seeds in runs:
        os.environ["OFDM_LTE_TPU_TORCH_MATMUL_PRECISION"] = (
            cell.config["precision"] if precision == REFERENCE_CONTROL else precision)
        prog.call(inputs.WARMUP, 0)
        for seed in run_seeds:
            undo = faults.plant(fault) if fault else None
            prog.seed = seed
            lat, res, _ = core.loop(prog, a.seconds)
            if undo:
                undo()
            sample = core.sample_calls(seed, res, [], int(cell.traffic.get("check_calls", 8)))
            if precision == REFERENCE_CONTROL:      # the control's results in the port's place
                sample = [(stream, i, cell.entry.reference(
                    cell.reference, cell.config, cell.traffic, prog.snr,
                    cell.entry.call_inputs(shape, seed, stream, i, prog.device), shape,
                    decoder_dtype=torch.bfloat16))
                    for stream, i, _ in sample]
            t_ref = time.perf_counter()
            readings = core.reference_readings(cell, shape, prog, seed, sample)
            t_ref = time.perf_counter() - t_ref
            ok, failed, checks = check.verdict(readings, cell.limits)
            print(json.dumps({"workload": a.workload, "precision": precision, "fault": fault,
                              "seed": seed, "calls": len(res), "checked": len(readings),
                              "correct": ok, "reference_s": round(t_ref, 3),
                              "worst": check.worst(readings), "each": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
