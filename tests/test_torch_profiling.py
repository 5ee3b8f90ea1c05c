"""The H100 cost model (ofdm_lte_tpu_torch/utils/profiling.py) against the
JAX package's (ofdm_lte_tpu/utils/profiling.py): every stage's FLOPs and
bytes equal, the units and peaks the card's, the report fractions in (0, 1]
for a step the model cannot beat, and chip_smoke.py's bounds unchanged now
that their peaks come from this module."""
import json
import pathlib

import numpy as np
import pytest
import torch

from ofdm_lte_tpu import LTEConfig as JConfig
from ofdm_lte_tpu.utils import profiling as jpr

import chip_smoke
from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.utils import profiling as pr

CONFIGS = {"20MHz-64QAM": (20.0, "64-QAM"), "5MHz-QPSK": (5.0, "QPSK")}
MODELS = {
    "siso_freq": lambda m, c: m.siso_frame_cost(c, 14, 256, "highest", 1, "freq"),
    "siso_time": lambda m, c: m.siso_frame_cost(c, 14, 256, "highest", 4, "time"),
    "spatial_bins": lambda m, c: m.spatial_frame_cost(c, 14, 256, 4, 2, 2, "highest",
                                                      channel_impl="bins"),
    "spatial_time": lambda m, c: m.spatial_frame_cost(c, 14, 256, 4, 4, 4, "highest",
                                                      channel_impl="time"),
    "simo": lambda m, c: m.simo_frame_cost(c, 14, 256, num_rx=2, precision="highest"),
    "sfbc": lambda m, c: m.sfbc_frame_cost(c, 14, 256, num_rx=2, precision="highest"),
}


# the same models at the other two precisions (the GEMMs' unit changes; their
# operations and bytes, and every other stage, do not)
MODELS_AT = {
    "siso_freq": lambda m, c, p: m.siso_frame_cost(c, 14, 256, p, 1, "freq"),
    "spatial_time": lambda m, c, p: m.spatial_frame_cost(c, 14, 256, 4, 4, 4, p,
                                                         channel_impl="time"),
    "simo": lambda m, c, p: m.simo_frame_cost(c, 14, 256, num_rx=2, precision=p),
    "sfbc": lambda m, c, p: m.sfbc_frame_cost(c, 14, 256, num_rx=2, precision=p),
}


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("model", list(MODELS_AT))
def test_every_stage_equals_the_jax_model_at_high_and_default(model, precision):
    cfg = LTEConfig(20.0, modulation="64-QAM")
    ours = MODELS_AT[model](pr, cfg, precision)
    ref = MODELS_AT[model](jpr, JConfig(bandwidth=20.0, modulation="64-QAM"), precision)
    assert list(ours) == list(ref)
    for name, cost in ref.items():
        assert (ours[name].name, ours[name].flops, ours[name].bytes) == \
            (cost.name, cost.flops, cost.bytes), name
        gemm = name in ("tx_idft", "rx_dft_data", "rx_dft_pilot", "rx_dft", "jakes_matmul")
        assert ours[name].unit == (pr.GEMM_UNITS[precision] if gemm else "fp32"), name


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_every_stage_equals_the_jax_model(model, config):
    bw, mod = CONFIGS[config]
    ours = MODELS[model](pr, LTEConfig(bw, modulation=mod))
    ref = MODELS[model](jpr, JConfig(bandwidth=bw, modulation=mod))
    assert list(ours) == list(ref)
    for name, cost in ref.items():
        assert ours[name].name == cost.name
        assert ours[name].flops == cost.flops, (name, "flops")
        assert ours[name].bytes == cost.bytes, (name, "bytes")


def test_units_and_peaks_are_the_cards():
    assert pr.DATASHEET == {"tf32": 495e12, "bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12}
    assert 324e12 <= pr.CEILINGS["tf32"] <= 328e12
    assert 0 < pr.CEILINGS["bf16"] <= pr.DATASHEET["bf16"]
    assert pr.CEILINGS["fp32"] == pr.DATASHEET["fp32"]
    assert 0 < pr.CEILINGS["hbm"] <= pr.DATASHEET["hbm"]
    assert "H100" in pr.CARD
    cfg = LTEConfig(20.0, modulation="64-QAM")
    for model in MODELS.values():
        for name, cost in model(pr, cfg).items():
            assert cost.unit in pr.UNITS
            gemm = name in ("tx_idft", "rx_dft_data", "rx_dft_pilot", "rx_dft", "jakes_matmul")
            assert (cost.unit == "tc_highest") == gemm, name
    # the `tc` kernels: three TF32 products per fp32 product at `highest`,
    # one at `high`, one bf16 product at `default`
    assert pr.unit_rate("tc_highest", pr.DATASHEET) == 495e12 / 3
    assert pr.unit_rate("tc_high", pr.DATASHEET) == 495e12
    assert pr.unit_rate("tc_default", pr.DATASHEET) == 989e12
    assert pr.unit_rate("tc_default") == pr.CEILINGS["bf16"]
    for precision, unit in (("high", "tc_high"), ("default", "tc_default")):
        costs = pr.siso_frame_cost(cfg, 14, 256, precision)
        assert costs["tx_idft"].unit == unit and costs["awgn_sigma"].unit == "fp32"
    with pytest.raises(ValueError, match="precision"):
        pr.siso_frame_cost(cfg, precision="bf17")


def test_no_tpu_figure_and_nothing_read_from_results():
    source = pathlib.Path(pr.__file__).read_text()
    assert "results" not in source and "open(" not in source and "import json" not in source
    tpu = json.loads((pathlib.Path(jpr.__file__).parents[2] / "results"
                      / "machine_peaks.json").read_text())
    tables = set(pr.DATASHEET.values()) | set(pr.CEILINGS.values())
    for v in tpu.values():
        if isinstance(v, (int, float)):
            assert not {v, v * 1e9, v * 1e12} & tables, v
    assert not {jpr.PEAK_HBM_BYTES_S, jpr.PEAK_BF16_FLOPS, jpr.PEAK_F32_FLOPS} & tables


@pytest.mark.parametrize("report", ["siso", "spatial", "fir_simo", "fir_sfbc"])
def test_fractions_lie_in_0_1_for_a_step_the_model_cannot_beat(report):
    cfg = LTEConfig(20.0, modulation="64-QAM")
    costs = {"siso": pr.siso_frame_cost(cfg, 14, 256),
             "spatial": pr.spatial_frame_cost(cfg, 14, 256, 4, 2, 2),
             "fir_simo": pr.simo_frame_cost(cfg, 14, 256, num_rx=2),
             "fir_sfbc": pr.sfbc_frame_cost(cfg, 14, 256, num_rx=2)}[report]
    step = 1.3 * pr._total_roofline_s(costs)          # slower than the model allows
    rep = {"siso": lambda: pr.roofline_report(cfg, 14, 256, step),
           "spatial": lambda: pr.spatial_roofline_report(cfg, 14, 256, step, 4, 2, 2),
           "fir_simo": lambda: pr.fir_roofline_report(costs, step),
           "fir_sfbc": lambda: pr.fir_roofline_report(costs, step)}[report]()
    for key in ("roofline_fraction", "roofline_fraction_datasheet_peaks",
                "roofline_fraction_excl_floor"):
        assert 0.0 < rep[key] <= 1.0, key
    assert rep["roofline_fraction_datasheet_peaks"] <= rep["roofline_fraction"]
    assert rep["roofline_fraction"] == pytest.approx(1 / 1.3)
    assert rep["hoisted_stages"] == [] and set(rep["per_kernel_us"]) == set(costs)
    if report.startswith("fir"):
        assert 0 < rep["channel_fir_roofline_s"] < rep["roofline_s"]
    # the host's dispatch floor bounds a step from below as well
    floored = pr.roofline_report(cfg, 14, 256, step, dispatch_floor_s=2 * step)
    assert floored["roofline_fraction"] == 1.0


def test_chip_smoke_bounds_are_unchanged():
    """The peaks chip_smoke.py reads from this module are the ones it held
    before: 3.35 TB/s, TF32 495 and fp32 67 TFLOP/s; so every bound in
    PERF.md stands."""
    assert chip_smoke.HBM_BYTES_PER_S == 3.35e12
    assert chip_smoke.PEAK_FLOPS == {"tf32": 495e12, "bf16": 989e12, "fp32": 67e12}
    assert (chip_smoke.BCJR_BYTES_PER_STEP, chip_smoke.BCJR_SCRATCH_BYTES_PER_STEP) == (16, 64)
    assert chip_smoke.BCJR_OPS_PER_STEP == {"app": 107, "extrinsic": 109}
    expected = {("tf32x3", 3584, 999, 2192): (0.3805, "operations"),
                ("tf32x3_gauss", 3584, 999, 2192): (0.2854, "operations"),
                ("tf32x3", 1024, 999, 2192): (0.1087, "operations"),
                ("tf32x3", 16384, 16, 30688): (1.2025, "bytes"),
                # `high`: one TF32 product; `default`: one bf16 product
                ("tf32", 3584, 999, 2192): (0.1268, "operations"),
                ("tf32_gauss", 3584, 999, 2192): (0.0951, "operations"),
                ("bf16", 3584, 999, 2192): (0.0635, "operations"),
                ("bf16_gauss", 3584, 999, 2192): (0.0476, "operations"),
                ("bf16", 256, 2048, 200): (0.0024, "bytes")}
    for (kernel, M, K, N), (ms, by) in expected.items():
        got, got_by = chip_smoke.bound_ms(kernel, M, K, N)
        assert (round(got, 4), got_by) == (ms, by), kernel


def test_bcjr_pass_cost_is_chip_smokes_bound():
    for n, kp, ms in ((256, 6083, 0.0074), (3328, 5827, 0.0926)):
        cost = pr.bcjr_pass_cost(n, kp)
        assert cost.bytes == 16 * n * kp and cost.flops == 109 * n * kp
        assert round(1e3 * cost.roofline_time_s(pr.DATASHEET), 4) == ms


def test_trace_writes_a_chrome_trace_with_the_link_spans(tmp_path):
    from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep
    path = tmp_path / "t.json"
    with pr.trace(path):
        ber_sweep(LTEConfig(1.25, modulation="QPSK"), [0.0, 30.0], frames=2,
                  num_ofdm_symbols=14, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e["name"] for e in events if e.get("cat") == "cpu_op"]
    assert spans.count("link.sweep") == 1
    assert {"link.forward", "modem.tx", "channel.awgn", "link.host_sync"} <= set(spans)
    assert np.isfinite(pr.bcjr_pass_cost(1, 1).roofline_time_s())
