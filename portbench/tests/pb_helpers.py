"""Shared set-up of the benchmark's tests: a temporary checkout holding a
copy of portbench/, BENCHMARK.json with tiny 1.25 MHz cells added as new
files, and the port linked in; and a subprocess runner of one cell on the
CPU (the harness's look for a card skipped)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_LIMITS = {"error_gap_bits": 10, "papr_gap_db": 1e-3, "bits_gap": 0}


def tiny_checkout(tmp: Path) -> Path:
    """A checkout under tmp with the cells t_awgn, t_peda (14 symbols) and
    t_wide (28) at 1.25 MHz, 2 frames a point, added as files."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "ofdm_lte_tpu_torch").symlink_to(REPO / "ofdm_lte_tpu_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "lte20_64qam_siso.json").read_text())
    cfg.update(name="tiny", bandwidth_mhz=1.25, fft_size=128, cp_length=9, num_prb=6)
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                            "file": "portbench/configs/tiny.json", "reduced": [], "why": "test"})
    for name, src in (("t_awgn", "ber_awgn_8x32"), ("t_peda", "ber_peda_8x32"),
                      ("t_wide", "ber_awgn_8x64")):
        traffic = json.loads((pb / "traffic" / f"{src}.json").read_text())
        traffic.update(frames=2, check_calls=4)
        (pb / "traffic" / f"{name}_mix.json").write_text(json.dumps(traffic))
        (pb / "limits" / f"{name}.json").write_text(json.dumps(TINY_LIMITS))
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": f"{name}_mix",
                                  "chips": 1, "why": "test"})
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["t_awgn", "t_peda", "t_wide"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


RUN_ONE = """
import json, sys, time
T0 = time.perf_counter()
root, workload, seed, seconds, prelude = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    float(sys.argv[4]), sys.argv[5]
sys.path.insert(0, root); sys.path.insert(0, root + "/portbench")
exec(prelude)
from harness import core
out = core.run({"workload": workload, "seed": seed, "seconds": seconds, "trace": 0, "t0": T0,
                "root": root, "device_type": "cpu"})
out.pop("_notes")
out["forbidden"] = core.forbidden_modules()
print(json.dumps(out))
"""


def run_cpu(root: Path, workload: str, seed: int = 2 ** 33 + 5, seconds: float = 0.5,
            prelude: str = "", env_extra=None, timeout: int = 240) -> dict:
    """One run of `workload` on the CPU in a fresh interpreter; its result."""
    env = dict(os.environ, OMP_NUM_THREADS="2", **(env_extra or {}))
    r = subprocess.run([sys.executable, "-c", RUN_ONE, str(root), workload, str(seed),
                        str(seconds), prelude], capture_output=True, text=True, env=env,
                       timeout=timeout, cwd=str(root))
    if r.returncode != 0:
        raise AssertionError(f"run failed ({r.returncode}):\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])
