"""Run one cell of the ofdm_lte_tpu_torch benchmark once, on CUDA cards:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It warms the cell's sweep up, runs a closed
loop of sweep calls for --seconds (or, with --trace 1, a short loop and a
profiled window of steady calls), checks a sample of the calls against the
plain reference, and prints one JSON line last on standard output: the
end-to-end metrics with --trace 0, the per-layer ones with --trace 1.
The numbers compared for `correct` and their limits are the last lines of
standard error and the last key of the result. The cell's files are found
by name (harness/core.py). Exits non-zero, printing no result, without
enough CUDA cards, or when JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "portbench_cache"     # fixed, inside the checkout


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    one host thread for the host's tensor ops (the loop's host work is
    one Python thread; idle OpenMP threads would spin beside it)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(HERE))
    import torch
    torch.set_num_threads(1)
    from harness import core
    chips = core.Cell(a.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    out = core.run({"workload": a.workload, "seed": a.seed, "seconds": a.seconds,
                    "trace": a.trace, "t0": T0, "root": str(ROOT), "device_type": "cuda"})
    found = core.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; nothing of JAX or the JAX package may "
              "be loaded", file=sys.stderr)
        return 3
    for line in out.pop("_notes"):
        print(line, file=sys.stderr)
    if a.trace:
        print(f"card and power limit: {_power_limit()}; peaks: H100 SXM data sheet at 700 W",
              file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
