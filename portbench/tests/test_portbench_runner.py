"""The runner on the CPU at 1.25 MHz: it finds a configuration, traffic
mix, limits and per-layer metric added as files in a copy without edits;
nothing of JAX or the JAX package is imported by the harness or loaded by
a run; the plain reference agrees with the port under fixed seams; and a
run whose timed path is broken comes out not correct, once for each fault
the cells can have."""
import ast
import json
import textwrap

import numpy as np
import pytest
import torch

from harness import check, core, inputs
from pb_helpers import BENCH, REPO, run_cpu, tiny_checkout

FORBIDDEN = {"jax", "jaxlib", "flax", "ofdm_lte_tpu"}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("pb"))


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not imported_top_names(f) & FORBIDDEN, f
    # the reference takes nothing of the program either
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert "ofdm_lte_tpu_torch" not in imported_top_names(f), f


def test_top_level_names_compare_whole():
    import sys
    sys.modules.setdefault("ofdm_lte_tpu_torch_probe", type(sys)("x"))
    try:
        assert "ofdm_lte_tpu" not in core.forbidden_modules()
    finally:
        del sys.modules["ofdm_lte_tpu_torch_probe"]


def test_runner_finds_added_files_and_loads_no_jax(checkout):
    out = run_cpu(checkout, "t_awgn")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["forbidden"] == []
    assert set(out["metrics"]) == {"info_Mbit_per_s", "sweep_p95_ms", "setup_s"}
    assert list(out)[-2] == "checks"        # last before the test's own key
    assert out["checks"]["bits_gap"] == {"value": 0.0, "limit": 0}


def test_runner_finds_an_added_metric_file(checkout):
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "demo.calls_traced", "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "link",
                              "moves": "info_Mbit_per_s", "workloads": ["t_peda"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    (checkout / "portbench" / "metrics" / "demo.calls_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace.calls\n")
    cell = core.Cell("t_peda", checkout)
    assert "demo.calls_traced" in cell.metric_files
    assert "demo.calls_traced" not in core.Cell("t_awgn", checkout).metric_files
    mod = core.load_module(cell.metric_files["demo.calls_traced"], "t_demo")
    from harness import devtrace
    ctx = core.Context(cell, cell.shape(), devtrace.Reduced([], [], (0, 1), 7))
    assert mod.read(ctx) == 7
    assert cell.shape().taps == 4 and cell.shape().channel == "rayleigh_mp"


@pytest.mark.parametrize("workload", ["t_awgn", "t_peda", "t_wide"])
def test_reference_agrees_with_the_port(checkout, workload):
    """The port's ber_sweep on the CPU and the float64 reference, under the
    same drawn bits and seams."""
    from ofdm_lte_tpu_torch import LTEConfig
    from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep
    cell = core.Cell(workload, checkout)
    shape = cell.shape()
    c, t = cell.config, cell.traffic
    cfg = LTEConfig(c["bandwidth_mhz"], modulation=c["modulation"])
    kw = {} if shape.channel == "awgn" else {"itu_profile": t["itu_profile"]}
    for call in range(3):
        arrays = inputs.call_inputs(shape, 12345, inputs.WINDOW, call, "cpu")
        bits, seams = inputs.sweep_args(shape, arrays)
        r = ber_sweep(cfg, t["snr_db"], frames=shape.frames, num_ofdm_symbols=shape.symbols,
                      channel_type=shape.channel, device="cpu", bits=bits, seams=seams, **kw)
        port = {"bit_errors": r.bit_errors, "total_bits": r.total_bits, "papr_db": r.papr_db}
        ref = cell.reference.sweep(c, t, t["snr_db"], arrays, shape.frames)
        assert ref["bit_errors"].sum() > 0
        got = check.compare(port, ref)
        assert got["error_gap_bits"] <= 2 and got["bits_gap"] == 0
        assert got["papr_gap_db"] < 1e-4


def test_inputs_repeat_for_a_seed_and_differ_between_calls():
    shape = inputs.Shape(2, 2, 12, 14, 128, 9, 60, 12, "awgn", 0)
    a = inputs.call_inputs(shape, 2 ** 33 + 1, 0, 5, "cpu")
    b = inputs.call_inputs(shape, 2 ** 33 + 1, 0, 5, "cpu")
    c = inputs.call_inputs(shape, 2 ** 33 + 1, 0, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["data_re"], c["data_re"])
    assert inputs.seed_word(2 ** 33 + 1) != inputs.seed_word(1)
    assert a["bits"].shape == (4, 12) and a["pilot_re"].shape == (4, 1, 12)


# faults planted under the timed path, each in the process that runs it
STALE = textwrap.dedent("""
    from ofdm_lte_tpu_torch.parallel import sweep
    _orig, _first = sweep.ber_sweep, []
    def stale(*a, **k):
        r = _orig(*a, **k)
        if not _first:
            _first.append(r)
        return _first[0]
    sweep.ber_sweep = stale
""")
HALF = textwrap.dedent("""
    import torch
    from ofdm_lte_tpu_torch.sim import siso
    _orig = siso.SisoLink.forward
    def half(self, bits, snr_db, generator=None, noise=None, draws=None):
        n = bits.shape[0] // 2
        sl = lambda x: x[:n] if isinstance(x, torch.Tensor) and x.ndim and x.shape[0] == 2 * n else x
        cut = lambda v: tuple(cut(x) for x in v) if isinstance(v, tuple) else (
            {k: cut(x) for k, x in v.items()} if isinstance(v, dict) else sl(v))
        r = _orig(self, bits[:n], cut(snr_db), generator, cut(noise), cut(draws))
        return r._replace(bit_errors=torch.cat([r.bit_errors, r.bit_errors]),
                          papr_db=torch.cat([r.papr_db, r.papr_db]))
    siso.SisoLink.forward = half
""")
ALTERED = textwrap.dedent("""
    from ofdm_lte_tpu_torch.sim import siso
    _orig = siso.SisoLink.forward
    def altered(self, bits, *a, **k):
        r = _orig(self, bits, *a, **k)
        e = r.bit_errors.clone()
        e[0] = bits.shape[-1] - e[0]      # one lane's decisions inverted
        return r._replace(bit_errors=e)
    siso.SisoLink.forward = altered
""")


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(checkout, fault):
    prelude = {"stale": STALE, "half": HALF, "altered": ALTERED}[fault]
    out = run_cpu(checkout, "t_awgn", prelude=prelude)
    assert out["correct"] is False and out["failed"] > 0
