"""The runner: one cell of BENCHMARK.json, one seed, one card.

`run(job)` is a whole run: it brings the program up, warms it up, drives a
closed loop of sweep calls for `seconds`, optionally traces a few tens of
steady calls, reads the peak memory, frees the program's state, checks a
sample of the calls against the plain reference and returns the result
line. Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file the runner finds by name:

    <config file of BENCHMARK.json>       numerology, precision, `reference`
    portbench/traffic/<traffic>.json      the entry and its arguments
    portbench/entries/<entry>.py          the adapter of the traffic's entry
    portbench/limits/<cell>.json          the limit of each number compared
    portbench/reference/<reference>.py    the plain reference
    portbench/metrics/<metric>.py         read(ctx) -> a number or None

The adapter of an entry (a function of ofdm_lte_tpu_torch, named by its
dotted path under the package in `ENTRY`) gives what differs between
entries: the call's input sizes (`shape`), its draws (`call_inputs`,
through harness/inputs.py), the entry's arguments and its call (`kwargs`,
`sweep_args`, `call`), its results as host numbers (`results`,
`info_bits`), its complex products (`products`, for the kernel and device
metrics), the reference's results for the same inputs (`reference`) and
the numbers compared (`compare`). A configuration whose entry takes other
arguments enters the benchmark as files alone.

A call draws its inputs, waits for the draw, and then calls the sweep: its
latency is the sweep's alone, from the call until its results are host
numbers; the window's rate holds the draws too.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent           # portbench/
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from harness import check, costs, devtrace, inputs, peaks  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ofdm_lte_tpu")
WARMUP_CALLS = 5
TRACED_CALLS = 40           # the metrics' window (the card alone)
BREAKDOWN_CALLS = 20        # the breakdown's window (host ops too)
TRACE_LOOP_S = 3.0          # the closed loop before a traced window, in a --trace 1 run
SETTLE = 5                  # unrecorded calls under the profiler before each traced window
DRAW, SWEEP = "portbench.draw", "portbench.sweep"     # the host spans of a call
# the program's own counters, by dotted path under ofdm_lte_tpu_torch
COUNTERS = {"cmatmul.launches": ("ops.cmatmul", "cmatmul", "launches"),
            "cmatmul.copies": ("ops.cmatmul", "cmatmul", "copies"),
            "bcjr_half.launches": ("ops.bcjr", "bcjr_half", "launches"),
            "bcjr_app.launches": ("ops.bcjr", "bcjr_app", "launches")}


class LostTrace(RuntimeError):
    """The profiler lost what the program's counters say ran."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A workload of BENCHMARK.json with its files, found by name."""

    def __init__(self, name: str, root: Path):
        self.root = Path(root)
        spec = json.loads((self.root / "BENCHMARK.json").read_text())
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        w = found[0]
        self.name, self.chips = name, int(w["chips"])
        conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
        self.config = json.loads((self.root / conf["file"]).read_text())
        bench = self.root / "portbench"
        self.traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        self.limits = json.loads((bench / "limits" / f"{name}.json").read_text())
        self.reference = load_module(bench / "reference" / f"{self.config['reference']}.py",
                                     f"portbench_reference_{self.config['reference']}")
        entry = self.traffic["entry"]
        self.entry = load_module(bench / "entries" / f"{entry}.py", f"portbench_entry_{entry}")

        def mine(m):
            return "workloads" not in m or name in m["workloads"]
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]
        self.metric_files = {m["name"]: bench / "metrics" / f"{m['name']}.py"
                             for m in self.per_layer}

    def shape(self):
        """The sizes of a call's inputs, as the entry's adapter gives them."""
        return self.entry.shape(self.config, self.traffic, self.reference)


class Context:
    """What a per-layer reader reads: the cell, its input sizes, the metrics'
    traced window (the card alone), the breakdown's (host ops too), and the
    results of the metrics window's calls, one a call, in order."""

    def __init__(self, cell: Cell, shape, trace: devtrace.Reduced,
                 host_trace: devtrace.Reduced = None, results=()):
        self.cell, self.shape, self.trace, self.host_trace = cell, shape, trace, host_trace
        self.results = list(results)
        self.costs, self.peaks, self.LostTrace = costs, peaks.H100_SXM, LostTrace
        self.draw_span = DRAW


def _no_span(name: str):
    return contextlib.nullcontext()


class Program:
    """The port, brought up for one cell."""

    def __init__(self, cell: Cell, job: dict):
        precision = job.get("precision") or cell.config["precision"]
        os.environ["OFDM_LTE_TPU_TORCH_MATMUL_PRECISION"] = precision
        import torch
        from ofdm_lte_tpu_torch import LTEConfig
        self.torch = torch
        self.adapter = cell.entry
        self.shape = cell.shape()
        c, t = cell.config, cell.traffic
        self.cfg = LTEConfig(float(c["bandwidth_mhz"]), modulation=c["modulation"],
                             cp_type=c["cp_type"])
        self.device = torch.device(job["device_type"])
        module, fn = self.adapter.ENTRY.rsplit(".", 1)
        self.sweep = getattr(importlib.import_module(f"ofdm_lte_tpu_torch.{module}"), fn)
        self.kwargs = self.adapter.kwargs(c, t)
        self.snr = [float(s) for s in t["snr_db"]]
        self.seed = int(job["seed"])

    def call(self, stream: int, i: int, spans: bool = False) -> tuple:
        """One sweep call: its inputs drawn and waited for, then the sweep,
        its results as host numbers. Returns (results, the sweep's seconds).
        `spans` marks the draw and the sweep for a profiler that records
        the host (what an idle gap is named by)."""
        span = self.torch.profiler.record_function if spans else _no_span
        with span(DRAW):
            arrays = self.adapter.call_inputs(self.shape, self.seed, stream, i, self.device)
            args = self.adapter.sweep_args(self.shape, arrays)
            self.sync()
        with span(SWEEP):
            a = time.perf_counter()
            r = self.adapter.call(self.sweep, self.cfg, self.snr, self.shape, args,
                                  self.kwargs, self.device)
            res = self.adapter.results(self.shape, r)
            b = time.perf_counter()
        return res, b - a

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def counters(self) -> dict:
        out = {}
        for name, (mod, fn, attr) in COUNTERS.items():
            m = importlib.import_module(f"ofdm_lte_tpu_torch.{mod}")
            out[name] = int(getattr(getattr(m, fn), attr))
        return out

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        """Drop the program's links and tables and return the memory."""
        from ofdm_lte_tpu_torch.sim.links import clear_link_cache
        clear_link_cache()
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def loop(prog: Program, seconds: float, stream: int = inputs.WINDOW):
    """The closed loop: calls until `seconds` have passed. Returns (sweep
    latencies, results, window seconds)."""
    lat, res = [], []
    t0 = time.perf_counter()
    while True:
        r, dt = prog.call(stream, len(res))
        res.append(r)
        lat.append(dt)
        if time.perf_counter() - t0 >= seconds:
            return lat, res, time.perf_counter() - t0


def _measure(job: dict, cell: Cell) -> dict:
    """Set-up, warm-up, the window and the traced windows."""
    prog = Program(cell, job)
    for i in range(WARMUP_CALLS):
        prog.call(inputs.WARMUP, i)
    prog.sync()
    t_go = time.perf_counter()
    seconds = min(job["seconds"], TRACE_LOOP_S) if job["trace"] else job["seconds"]
    lat, res, window_s = loop(prog, seconds)
    out = {"prog": prog, "t_go": t_go, "lat": lat, "res": res, "window_s": window_s,
           "traced_res": [], "trace": None}
    if job["trace"]:
        traced = []

        def one(_, spans=False):       # call k of the stream is traced[k]
            traced.append(prog.call(inputs.TRACED, len(traced), spans)[0])
        out["trace"] = devtrace.trace_calls(one, TRACED_CALLS, prog.counters, host=False,
                                            settle=SETTLE)
        out["host_trace"] = devtrace.trace_calls(lambda i: one(i, True), BREAKDOWN_CALLS,
                                                 settle=SETTLE)
        out["traced_res"] = traced
        out["window_res"] = traced[SETTLE:SETTLE + TRACED_CALLS]    # the metrics window's
    prog.sync()
    out["memory_peak"] = prog.memory_peak()
    return out


def _sample(seed: int, n_calls: int, k: int) -> list:
    """k call indices of the window drawn from the seed, the last one always
    among them."""
    if n_calls <= 0:
        return []
    rng = np.random.default_rng(inputs.seed_word(seed, 99))
    pick = set(rng.choice(n_calls, size=min(k, n_calls), replace=False).tolist())
    pick.add(n_calls - 1)
    return sorted(pick)


def sample_calls(seed: int, res: list, traced_res: list, n_check: int) -> list:
    """(stream, index, port result) of the calls to check, drawn from the seed."""
    return ([(inputs.WINDOW, i, res[i]) for i in _sample(seed, len(res), n_check)]
            + [(inputs.TRACED, i, traced_res[i])
               for i in _sample(seed + 1, len(traced_res), 2)])


def reference_readings(cell: Cell, shape, prog: Program, seed: int, calls: list) -> list:
    """The comparison numbers of each (stream, index, port result)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry, readings = cell.entry, []
    for stream, i, port in calls:
        arrays = entry.call_inputs(shape, seed, stream, i, prog.device)
        ref = entry.reference(cell.reference, cell.config, cell.traffic, prog.snr, arrays, shape)
        readings.append(entry.compare(port, ref))
        del arrays
    return readings


def run(job: dict) -> dict:
    """A whole run of one cell; returns the result line's object.
    job: workload, seed, seconds, trace, t0 (the process's start on
    perf_counter), root, device_type, and optionally precision."""
    root = Path(job.get("root") or HERE.parent)
    cell = Cell(job["workload"], root)
    job = dict(job, root=str(root))
    m = _measure(job, cell)
    prog = m["prog"]
    prog.free()
    shape = cell.shape()
    n_check = int(cell.traffic.get("check_calls", 8))
    sample = sample_calls(job["seed"], m["res"], m["traced_res"], n_check)
    t_ref = time.perf_counter()
    readings = reference_readings(cell, shape, prog, job["seed"], sample)
    t_ref = time.perf_counter() - t_ref
    correct, failed, checks = check.verdict(readings, cell.limits)
    out = _result(job, cell, shape, m, correct, failed, checks)
    out["_notes"].append(f"reference: {len(sample)} calls checked in {t_ref:.3f} s "
                         f"({t_ref / max(len(sample), 1):.3f} s a call)")
    return out


def _device(job: dict, mem_peak: int) -> dict:
    if job["device_type"] == "cuda":
        import torch
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    return {"platform": "gpu" if job["device_type"] == "cuda" else "cpu", "kind": kind,
            "count": 1, "memory_peak_bytes": mem_peak}


def _result(job, cell, shape, m, correct, failed, checks) -> dict:
    lat = np.asarray(m["lat"])
    calls = len(lat)
    info_bits = float(sum(cell.entry.info_bits(r) for r in m["res"]))
    device = _device(job, m["memory_peak"])
    notes = [f"calls in the window: {calls} over {m['window_s']:.6f} s "
             f"({shape.lanes} lanes, {cell.entry.info_bits(m['res'][0]) if calls else 0} "
             "information bits a call)",
             f"sweep latency: median {np.median(lat) * 1e3:.6f} ms, p95 "
             f"{np.percentile(lat, 95) * 1e3:.6f} ms over {calls} samples"]
    out = {"correct": correct, "attempted": calls, "failed": failed, "metrics": {},
           "device": device}
    if not job["trace"]:
        values = {"info_Mbit_per_s": info_bits / m["window_s"] / 1e6,
                  "sweep_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                  "setup_s": m["t_go"] - job["t0"]}
        for metric in cell.end_to_end:
            out["metrics"][metric["name"]] = {"value": values[metric["name"]],
                                              "unit": metric["unit"]}
    else:
        trace, host = m["trace"], m["host_trace"]
        if not trace.kernels:
            raise LostTrace("the traced window shows no device kernel")
        ctx = Context(cell, shape, trace, host, m["window_res"])
        for metric in cell.per_layer:
            mod = load_module(cell.metric_files[metric["name"]], "portbench_metric_"
                              + metric["name"].replace(".", "_"))
            v = mod.read(ctx)
            if v is not None:
                out["metrics"][metric["name"]] = {"value": float(v), "unit": metric["unit"]}
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": host.idle_gaps()}
        draw = sum(host.kernels_each_span(DRAW))
        notes.append(f"traced window: {trace.calls} calls, {len(trace.kernels)} kernels, "
                     f"counters {trace.counters}; breakdown window: {host.calls} calls, "
                     f"the draw's kernels {draw} ({host.kernel_time_in_span_s(DRAW):.6f} "
                     "device s)")
    out["checks"] = checks
    out["_notes"] = notes
    return out
