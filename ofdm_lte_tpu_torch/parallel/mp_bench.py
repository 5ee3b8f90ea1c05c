"""N-process sweeps over torch.distributed: the workers, the scaling
measurement, and the cases that hold an N-process sweep to the one-process
one.

Port of ofdm_lte_tpu/parallel/mp_bench.py. `spawn(n, jobs, device)` starts
n fresh interpreters (`python -m ofdm_lte_tpu_torch.parallel.mp_bench
worker SPEC`; never a fork of a process that may hold a CUDA context),
brings them up as one group over a `file://` rendezvous under the
repository's build/ directory (NCCL when every rank has a card of its own,
else gloo), runs the same list of jobs in every rank,
reads each rank's `WORKER_RESULT` lines and kills the workers in a
`finally`. On the CPU every worker is pinned to a core of its own with
`taskset`, as in the JAX package, so that the 1-process baseline and each
of N processes get one core; on a card the ranks share the host's cores,
and several ranks may share one card (gloo then carries the counts; NCCL
refuses two ranks on one card). The jobs:

- "bench": the steady-state frames/s of one sweep a step (best of
  n_steps; CUDA events on a card, the host clock on the CPU), also printed
  as one `WORKER_RATE rank rate ber` line;
- "case": one sweep of `run_case`, with the launches of the hand kernels;
- "dryrun": distributed.dryrun_checks;
- "cli": `cli.main(argv)` on the rank's device, its standard output.

`measure(process_counts, frames, n_steps, retries, device, link)` is the
JAX package's measure: per-process and total rates at each count, the
efficiency against the first.

    python -m ofdm_lte_tpu_torch.parallel.mp_bench [--device cpu] [--counts 1,2]
        [--link tiny|flagship|coded_6000_awgn] [--frames F]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .._build import BUILD_DIR
from ..device import resolve_device
from . import distributed

ROOT = BUILD_DIR.parent         # the workers' working directory

# the links the scaling measurement drives: the JAX package's mp_bench link
# (1.25 MHz QPSK), the flagship (20 MHz 64-QAM over AWGN, device-bound) and
# the 6,000-bit coded link (one transport block a frame, host-bound), at
# their working SNR
LINKS = {
    "tiny": dict(bandwidth=1.25, modulation="QPSK", pipeline="siso", symbols=14, snr=10.0),
    "flagship": dict(bandwidth=20.0, modulation="64-QAM", pipeline="siso", symbols=14,
                     snr=15.0),
    "coded_6000_awgn": dict(bandwidth=20.0, modulation="64-QAM", pipeline="coded",
                            symbols=14, snr=20.85, tb_bits=6000),
}


def _config(spec: dict):
    from ..config import LTEConfig
    return LTEConfig(spec["bandwidth"], modulation=spec["modulation"],
                     cp_type=spec.get("cp_type", "normal"))


def _launches() -> dict:
    from ..ops import bcjr
    from ..ops.cmatmul import cmatmul
    return {"tf32x3": cmatmul.launches_by_kernel["tf32x3"], "turbo_bcjr": bcjr.bcjr_half.launches}


def _zero_launches() -> None:
    from ..ops import bcjr
    from ..ops.cmatmul import cmatmul
    cmatmul.launches = cmatmul.copies = 0
    for k in cmatmul.launches_by_kernel:
        cmatmul.launches_by_kernel[k] = 0
    bcjr.bcjr_app.launches = bcjr.bcjr_half.launches = 0


def _normals(rng, *shape):
    return (rng.standard_normal(shape, np.float32), rng.standard_normal(shape, np.float32))


def case_inputs(case: dict, mc_size: int = 1, device=None):
    """The global bits (S, frames·mc_size, n_bits) and seams (S·frames·
    mc_size lanes, point-major) of a case over AWGN, from NumPy seeded by
    case["seed"]; (None, None) when the case draws (case["seams"] false).
    `device` (None: the card) holds the coded link whose sizes the seams
    take."""
    from ..rx.estimation import SLOT_SIZE
    from ..sim import coded, diversity, siso
    from .sweep import _bits_per_frame
    device = resolve_device(device)
    if not case.get("seams", True):
        return None, None
    cfg = _config(case)
    pipeline, Sy = case["pipeline"], case.get("symbols", 14)
    S, F = len(case["snr"]), case["frames"] * mc_size
    lanes = S * F
    tb_bits = case.get("tb_bits", 6000)
    num_tx, num_rx = case.get("num_tx", 2), case.get("num_rx", 2)
    rng = np.random.default_rng(case["seed"])
    n_bits = tb_bits if pipeline == "harq" else _bits_per_frame(cfg, Sy, "lte", pipeline,
                                                                 tb_bits)
    bits = torch.from_numpy(rng.integers(0, 2, (S, F, n_bits), dtype=np.int8))
    g = siso.grid_for(cfg)
    n_slots = -(-Sy // SLOT_SIZE)
    if pipeline == "siso":
        return bits, {"noise": (_normals(rng, lanes, Sy, g.num_data),
                                _normals(rng, lanes, n_slots, g.num_pilot))}
    if pipeline == "simo":
        T = Sy * cfg.samples_per_ofdm_symbol
        return bits, {"draws": {"noise": _normals(rng, num_rx, lanes, T)}}
    if pipeline == "sfbc":
        n_even = len(diversity.sfbc_data_bins(cfg))
        return bits, {"draws": {"noise": (_normals(rng, num_rx, lanes, Sy, n_even),
                                          _normals(rng, num_rx, lanes, n_slots, g.num_pilot))}}
    if pipeline == "spatial":
        rank = case.get("rank") or min(num_tx, num_rx)
        m = -(-g.num_data // rank)
        return bits, {"draws": {"fading": _normals(rng, lanes, num_rx, num_tx),
                                "noise": (_normals(rng, num_rx, lanes, Sy, m),
                                          _normals(rng, num_rx, lanes, Sy, g.num_pilot))}}
    if pipeline == "beamforming":
        return bits, {"draws": {"H": _normals(rng, lanes, num_rx, num_tx),
                                "noise": _normals(rng, lanes, num_rx,
                                                  n_bits // cfg.bits_per_symbol)}}
    link = coded.link_for(cfg, tb_bits, device)
    n_sym = -(-link.coded_len // cfg.bits_per_symbol)
    samples = -(-n_sym // g.num_data) * cfg.samples_per_ofdm_symbol
    if pipeline == "coded":
        return bits, {"draws": {"noise": _normals(rng, lanes, samples)}}
    return bits, {"draws": {"noise": _normals(rng, len(case["rv"]), lanes, samples)}}


def run_case(case: dict, layout=None, device=None) -> dict:
    """One sweep of a case: the pipeline's ber_sweep ("harq": harq_sweep),
    `case["frames"]` frames a point (per rank under a layout), under the
    global inputs of case_inputs or, with case["seams"] false, drawn from a
    generator seeded case["seed"] alike on every rank. Returns the exact
    counts and the result's SNR points and frames; under a layout also the
    hand kernels' launches of its sweep and, over more than one process
    with seams, "share": the counts of this rank's lanes run as one
    one-device sweep, and the rows they belong to. Without a layout it
    runs on `device`: the card when none is given."""
    from .sweep import _Part
    mc = layout.mc_size if layout is not None else 1
    dev = layout.device if layout is not None else resolve_device(device)
    bits, seams = case_inputs(case, mc, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(case["seed"])
    out = _sweep(case, case["snr"], bits, seams, gen, layout, dev)
    if layout is not None:
        out["launches"] = _launches()                  # the sweep's own, not the share's
    if layout is not None and layout.world_size > 1 and seams is not None:
        part = _Part(case["snr"], case["frames"], layout, None, gen)
        harq = case["pipeline"] == "harq"
        share = _sweep(case, part.snr, part.bits(bits),
                       part.seams(seams, "coded" if harq else case["pipeline"],
                                  case.get("num_tx", 2), case.get("num_rx", 2), int(harq)),
                       gen, None, dev)
        out["share"] = {"rows": [part.rows.start, part.rows.stop],
                        **{k: v for k, v in share.items() if k not in ("snr_db", "frames")}}
    return out


def _sweep(case: dict, snr, bits, seams, gen, layout, dev) -> dict:
    from .sweep import ber_sweep, harq_sweep
    cfg = _config(case)
    kw = dict(generator=gen, bits=bits, seams=seams, layout=layout,
              device=None if layout is not None else dev)
    if case["pipeline"] == "harq":
        r = harq_sweep(cfg, snr, frames=case["frames"], tb_bits=case["tb_bits"],
                       rv_sequence=tuple(case["rv"]), num_iterations=case.get("iterations", 8),
                       **kw)
        counts = {"stage_failures": r.stage_failures.tolist(), "tx_sum": r.tx_sum.tolist(),
                  "bit_errors": r.bit_errors.tolist(), "tb_failures": r.tb_failures.tolist()}
    else:
        extra = {k: case[k] for k in ("num_tx", "num_rx", "rank") if k in case}
        if case["pipeline"] == "coded":
            extra["coded_tb_bits"] = case.get("tb_bits", 6000)
        r = ber_sweep(cfg, snr, frames=case["frames"], num_ofdm_symbols=case.get("symbols", 14),
                      pipeline=case["pipeline"], **extra, **kw)
        counts = {"bit_errors": r.bit_errors.tolist(), "total_bits": r.total_bits.tolist(),
                  "papr_db": r.papr_db.tolist()}
    return {**counts, "snr_db": np.asarray(r.snr_db).tolist(), "frames": r.frames}


def sum_of_shares(results: list, key: str, n_points: int) -> list:
    """The counts `key` of every rank's one-device share, each added into
    its rows, the padding trimmed: what the world's reduction must give."""
    shares = [r["share"] for r in results]
    width = np.shape(shares[0][key])[1:]
    full = np.zeros((max(s["rows"][1] for s in shares),) + width, np.int64)
    for s in shares:
        full[s["rows"][0]:s["rows"][1]] += np.asarray(s[key], np.int64)
    return full[:n_points].tolist()


def _bench(spec: dict, layout, frames: int, n_steps: int) -> dict:
    """Best-of-n_steps seconds of one sweep of `frames` frames at one SNR
    point, bits and seed new every step; frames/s of this process."""
    from .sweep import ber_sweep
    cfg, dev = _config(spec), layout.device
    gen = torch.Generator(device=dev)
    kw = dict(frames=frames, num_ofdm_symbols=spec["symbols"], pipeline=spec["pipeline"],
              coded_tb_bits=spec.get("tb_bits", 6000), generator=gen, layout=layout)
    gen.manual_seed(0)
    r = ber_sweep(cfg, [spec["snr"]], **kw)                    # warm-up: tables, links
    dt = float("inf")
    for i in range(n_steps):
        gen.manual_seed(1 + i)
        if dev.type == "cuda":
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            r = ber_sweep(cfg, [spec["snr"]], **kw)
            t1.record()
            torch.cuda.synchronize(dev)
            dt = min(dt, t0.elapsed_time(t1) / 1e3)
        else:
            t0 = time.perf_counter()
            r = ber_sweep(cfg, [spec["snr"]], **kw)
            dt = min(dt, time.perf_counter() - t0)
    return {"rate": frames / dt, "ber": float(r.ber[0])}


def _run_job(job: dict, device) -> dict:
    kind = job["job"]
    _zero_launches()
    if kind == "bench":
        spec = LINKS[job["link"]] if isinstance(job["link"], str) else job["link"]
        out = _bench(spec, distributed.layout(1, device), job["frames"], job["n_steps"])
    elif kind == "case":
        lay = distributed.layout(job["case"].get("shards", 1), device)
        out = run_case(job["case"], lay)
    elif kind == "dryrun":
        out = distributed.dryrun_checks(device)
    elif kind == "cli":
        from .. import cli
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(list(job["argv"]) + ["--device", str(device)])
        out = {"stdout": buf.getvalue()}
    else:
        raise ValueError(f"unknown job {kind!r}")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"launches": _launches(), **out}


def worker_main(argv) -> None:
    """One rank: bring up the group (none for one process), run the jobs in
    order, print one `WORKER_RESULT rank JSON` line each."""
    spec = json.loads(argv[0])
    rank, world = spec["rank"], spec["world"]
    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    if world > 1:
        distributed.initialize(spec["init"], world, rank, spec["backend"], retries=1,
                               timeout_s=spec["timeout_s"])
    try:
        device = distributed.rank_device(spec["device"])
        for job in spec["jobs"]:
            out = _run_job(job, device)
            if job["job"] == "bench":
                print(f"WORKER_RATE {rank} {out['rate']:.4f} {out['ber']:.6f}", flush=True)
            print(f"WORKER_RESULT {rank} {json.dumps(out)}", flush=True)
    finally:
        distributed.shutdown()


def spawn(num_processes: int, jobs: list, device=None, timeout_s: float = 600.0) -> list:
    """Run `jobs` in num_processes fresh interpreters, ranks 0..n-1 of one
    group, each on `device` (None: the cards, `cuda:{rank % cards}`; the
    ranks may share one): NCCL when every rank has a card of its own, else
    gloo. Returns, for each rank, its jobs' results.
    Raises RuntimeError when a worker fails, prints no result or outlives
    timeout_s; every worker is killed before this returns."""
    device = distributed.resolve_device(device)
    on_cpu = device.type == "cpu"
    backend = distributed.backend_for(device, num_processes)
    ncpu = os.cpu_count() or 1
    taskset = shutil.which("taskset") if on_cpu else None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        try:
            for rank in range(num_processes):
                dev = device if on_cpu or device.index is not None else \
                    torch.device("cuda", rank % torch.cuda.device_count())
                spec = {"rank": rank, "world": num_processes, "device": str(dev),
                        "init": f"file://{tmp}/rdzv", "timeout_s": timeout_s, "jobs": jobs,
                        "backend": backend,
                        "threads": 1 if on_cpu else 0}
                cmd = [sys.executable, "-m", "ofdm_lte_tpu_torch.parallel.mp_bench", "worker",
                       json.dumps(spec)]
                if taskset:
                    cmd = [taskset, "-c", str(rank % ncpu)] + cmd
                env = dict(os.environ, LOCAL_RANK=str(rank), RANK=str(rank),
                           WORLD_SIZE=str(num_processes))
                env.setdefault("GLOO_SOCKET_IFNAME", "lo")
                procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True, env=env,
                                              cwd=str(ROOT)))
            deadline = time.monotonic() + timeout_s
            results = []
            for rank, p in enumerate(procs):
                try:
                    out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired as e:
                    raise RuntimeError(f"worker {rank} of {num_processes} did not finish in "
                                       f"{timeout_s} s") from e
                if p.returncode != 0:
                    raise RuntimeError(f"worker {rank} of {num_processes} failed "
                                       f"(exit {p.returncode}):\n{out[-4000:]}")
                tag = f"WORKER_RESULT {rank} "
                res = [json.loads(line[len(tag):]) for line in out.splitlines()
                       if line.startswith(tag)]
                if len(res) != len(jobs):
                    raise RuntimeError(f"worker {rank} printed {len(res)} results for "
                                       f"{len(jobs)} jobs:\n{out[-4000:]}")
                results.append(res)
            return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    with contextlib.suppress(subprocess.TimeoutExpired):
                        p.communicate(timeout=10.0)


def measure(process_counts=(1, 2), frames: int = 4, n_steps: int = 3, retries: int = 3,
            device=None, link="tiny") -> dict:
    """Per-process and total frames/s of `link` (a name of LINKS or a spec
    of the same keys) at each process count, `frames` frames a process a
    step: {n: {"per_process", "rates", "total", "efficiency"}}. Each count
    keeps its best attempt (the slowest process's rate, the most of up to
    `retries` spawns; 2 for the first count), an attempt past 85% of the
    first count's per-process rate ends the retries, as in the JAX
    package; efficiency is per-process rate over the first count's."""
    base_n = process_counts[0]
    results = {}
    for n in process_counts:
        best = None
        for _ in range(max(1, min(2, retries) if n == base_n else retries)):
            rates = [r[0]["rate"] for r in spawn(n, [{"job": "bench", "link": link,
                                                      "frames": frames,
                                                      "n_steps": n_steps}], device)]
            if best is None or min(rates) > best["per_process"]:
                best = {"per_process": min(rates), "rates": rates, "total": sum(rates)}
            if n != base_n and best["per_process"] / results[base_n]["per_process"] >= 0.85:
                break
        results[n] = best
    base = results[base_n]["per_process"]
    for n in process_counts:
        results[n]["efficiency"] = results[n]["per_process"] / base
    return results


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "worker":
        worker_main(argv[1:])
        return
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cpu, or the card (the default)")
    p.add_argument("--counts", default="1,2", help="process counts, comma-separated")
    p.add_argument("--link", default="tiny", choices=sorted(LINKS))
    p.add_argument("--frames", type=int, default=4, help="frames a process a step")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--retries", type=int, default=3)
    args = p.parse_args(argv)
    counts = tuple(int(c) for c in args.counts.split(","))
    r = measure(counts, args.frames, args.steps, args.retries, args.device, args.link)
    print(json.dumps({str(k): v for k, v in r.items()}, indent=2))


if __name__ == "__main__":
    main()
