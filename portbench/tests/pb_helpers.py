"""Shared set-up of the benchmark's tests: a temporary checkout holding a
copy of portbench/, BENCHMARK.json with tiny 1.25 MHz cells (three of
`ber_sweep`, one of the batched HARQ entry) added as new files, and the port linked
in; and a subprocess runner of one cell on the CPU (the harness's look for
a card skipped)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_LIMITS = {"error_gap_bits": 10, "papr_gap_db": 1e-3, "bits_gap": 0}
# a 1,000-bit transport block (one code block of K = 1,024) at 1.25 MHz
TINY_HARQ = {"snr_db": [15.5, 16.0], "frames": 4, "tb_bits": 1000, "check_calls": 2}
TINY_HARQ_LIMITS = {"stage_fail_gap": 0, "tx_gap": 0, "error_gap_bits": 400,
                    "crc_mismatch_lanes": 0, "papr_gap_db": 1e-3}


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
    coded = json.loads((pb / "configs" / "lte20_64qam_coded.json").read_text())
    coded.update(name="tiny_coded", bandwidth_mhz=1.25, fft_size=128, cp_length=9, num_prb=6)
    (pb / "configs" / "tiny_coded.json").write_text(json.dumps(coded))
    spec["configs"].append({"name": "tiny_coded", "source": "https://example.org/tiny",
                            "file": "portbench/configs/tiny_coded.json", "reduced": [],
                            "why": "test"})
    traffic = json.loads((pb / "traffic" / "harq_awgn_4x64.json").read_text())
    traffic.update(TINY_HARQ)
    (pb / "traffic" / "t_harq_mix.json").write_text(json.dumps(traffic))
    (pb / "limits" / "t_harq.json").write_text(json.dumps(TINY_HARQ_LIMITS))
    spec["workloads"].append({"name": "t_harq", "config": "tiny_coded", "traffic": "t_harq_mix",
                              "chips": 1, "why": "test"})
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["t_awgn", "t_peda", "t_wide", "t_harq"]
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
