"""The cell sic4x4_peda: its adapter (ber_sweep's spatial pipeline) finds
its files by name, draws in a fixed order the shapes that SpatialLink's
seams take, counts the complex products the link launches; its three
detector readers read synthetic breakdown windows (sums, counts, the
roofline's count at the cell's sizes, the lost-trace rule, silence on a
program without the detector layer); and a tiny 1.25 MHz copy of the cell
runs through the runner on the CPU, correct, while the MMSE detector in
SIC's place is not."""
import json

import numpy as np
import pytest
import torch

from harness import core, devtrace, inputs, peaks
from pb_helpers import BENCH, REPO, run_cpu, tiny_checkout

CELL = "sic4x4_peda"


def adapter():
    return core.Cell(CELL, REPO).entry


def metric(name):
    return core.load_module(BENCH / "metrics" / f"{name}.py", "t_sp_" + name.replace(".", "_"))


def tiny_shape(frames=1):
    return core.Cell(CELL, REPO).entry.Shape(
        points=2, frames=frames, n_bits=5208, symbols=14, n_fft=128, cp=9, n_data=62, m=16,
        n_pilot=13, taps=4, num_tx=4, num_rx=4, rank=4)


def tiny_config():
    cfg = dict(core.Cell(CELL, REPO).config)
    cfg.update(name="tiny_sic", bandwidth_mhz=1.25, fft_size=128, cp_length=9, num_prb=6)
    return cfg


def test_the_cell_finds_its_adapter_configuration_and_reference():
    cell = core.Cell(CELL, REPO)
    assert cell.traffic["entry"] == "ber_sweep_spatial"
    assert cell.entry.ENTRY == "parallel.sweep.ber_sweep"
    assert cell.reference.__name__ == "portbench_reference_lte_spatial"
    assert cell.shape() == cell.entry.Shape(8, 32, 83916, 14, 2048, 144, 999, 250, 200, 4, 4, 4,
                                            4)
    assert cell.entry.kwargs(cell.config, cell.traffic) == dict(
        frames=32, num_ofdm_symbols=14, channel_type="rayleigh_mp", itu_profile="Pedestrian_A",
        velocity_kmh=3.0, pipeline="spatial", num_tx=4, num_rx=4, detector_type="SIC", rank=4)
    assert set(cell.limits) == {"error_gap_bits", "papr_gap_db", "bits_gap"}
    assert {m["name"] for m in cell.per_layer} >= {
        "detector.device_ms", "detector.kernels_per_call", "detector_roofline",
        "channel.device_ms", "modem.device_ms", "link.kernels_per_call", "device.idle_share"}
    assert not {"cmatmul_roofline", "call_mfu", "link.host_syncs"} & set(cell.metric_files)


def test_a_program_without_the_detector_layer_cannot_run_the_cell(monkeypatch):
    import ofdm_lte_tpu_torch.utils.profiling as prof
    cell = core.Cell(CELL, REPO)
    monkeypatch.setattr(prof, "LAYERS", ("link", "modem", "channel", "coding"))
    with pytest.raises(RuntimeError, match="detector"):
        cell.entry.kwargs(cell.config, cell.traffic)
    monkeypatch.delattr(prof, "LAYERS")
    with pytest.raises(RuntimeError, match="detector"):
        cell.entry.kwargs(cell.config, cell.traffic)


def test_the_draws_come_in_order_in_the_shapes_of_the_links_seams():
    entry, small = adapter(), tiny_shape()
    a = entry.call_inputs(small, 2 ** 35 + 7, 1, 3, "cpu")
    gen = torch.Generator().manual_seed(inputs.seed_word(2 ** 35 + 7, 1, 3))
    assert torch.equal(a["bits"], torch.randint(0, 2, (2, 5208), generator=gen,
                                                 dtype=torch.int8))
    assert torch.equal(a["phases"], torch.rand((4 * 4 * 2 * 4, 16), generator=gen) * (2 * np.pi))
    for name, shape in (("data_re", (4, 2, 14, 16)), ("data_im", (4, 2, 14, 16)),
                        ("pilot_re", (4, 2, 14, 13)), ("pilot_im", (4, 2, 14, 13))):
        assert torch.equal(a[name], torch.randn(shape, generator=gen)), name
    args = entry.sweep_args(small, a)
    assert args["bits"].shape == (2, 1, 5208)
    draws = args["seams"]["draws"]
    assert draws["phases"] is a["phases"]
    assert draws["noise"][0][0] is a["data_re"] and draws["noise"][1][1] is a["pilot_im"]
    # the link takes them as they are: its own draws have these shapes
    from ofdm_lte_tpu_torch import LTEConfig
    from ofdm_lte_tpu_torch.parallel.sweep import sweep_link
    from ofdm_lte_tpu_torch.sim.spatial import SpatialLink
    cfg = LTEConfig(1.25, modulation="64-QAM")
    link = sweep_link(cfg, "spatial", torch.device("cpu"), channel_type="rayleigh_mp",
                      num_tx=4, num_rx=4, detector_type="SIC", rank=4, velocity_kmh=3.0)
    assert isinstance(link, SpatialLink) and link.m == small.m
    assert link.profile.num_taps == small.taps
    kw = entry.kwargs(tiny_config(), core.Cell(CELL, REPO).traffic)
    kw["frames"] = 1
    r = entry.call(_sweep(), cfg, [10.0, 30.0], small, args, kw, "cpu")
    res = entry.results(small, r)
    assert res["total_bits"].tolist() == [5208, 5208] and entry.info_bits(res) == 10416


def _sweep():
    from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep
    return ber_sweep


def test_the_products_are_the_links_launches(monkeypatch):
    import ofdm_lte_tpu_torch.ops.ofdm as ofdm
    seen, plain = [], ofdm.cmatmul

    def counting(a, b, *k, **kw):
        seen.append((int(np.prod(a.shape[:-1])), a.shape[-1], b.shape[-1]))
        return plain(a, b, *k, **kw)
    monkeypatch.setattr(ofdm, "cmatmul", counting)
    entry, small = adapter(), tiny_shape()
    from ofdm_lte_tpu_torch import LTEConfig
    a = entry.call_inputs(small, 5, 0, 0, "cpu")
    kw = entry.kwargs(tiny_config(), core.Cell(CELL, REPO).traffic)
    kw["frames"] = 1
    entry.call(_sweep(), LTEConfig(1.25, modulation="64-QAM"), [10.0, 30.0], small,
               entry.sweep_args(small, a), kw, "cpu")
    from harness import costs
    assert seen == [(m, k, n) for _, m, k, n in entry.products(small, costs)]
    assert [p[0] for p in entry.products(small, costs)] == ["tx", "jakes", "rx_data", "rx_pilot"]


def cell_shape():
    return core.Cell(CELL, REPO).shape()


class FakeCell:
    traffic = {}
    entry = core.load_module(BENCH / "entries" / "ber_sweep_spatial.py", "t_sp_entry")


def ctx_of(host, shape=None):
    return core.Context(FakeCell(), shape or cell_shape(), None, host)


def window(spans, kernels, calls=2):
    """A breakdown window: host spans [(name, start, dur)], kernels [(name,
    launched_at, dur)] running 1000 µs after their launch."""
    ks = [(n, t + 1000.0, d) for n, t, d in kernels]
    return devtrace.Reduced(ks, ks, (0.0, 9000.0), calls, spans, {}, [t for _, t, _ in kernels])


SPANS = [(core.SWEEP, 0, 3000), ("link.forward", 10, 2900), ("modem.tx", 20, 100),
         ("channel.multipath", 130, 100), ("modem.estimate", 240, 50),
         ("detector.heff", 300, 100), ("detector.sic", 410, 1000), ("modem.demap", 1420, 50)]
KERNELS = [("draw", -5, 50.0), ("gemm", 30, 300.0), ("fir", 140, 900.0), ("interp", 250, 20.0),
           ("mul", 310, 4.0), ("mul", 320, 4.0), ("gram", 420, 6.0), ("argmax", 800, 2.0),
           ("solve", 1200, 8.0), ("demap", 1430, 30.0)]


def test_the_detector_readers_sum_and_count_the_detector_spans():
    spans = SPANS + [(n, s + 4000, d) for n, s, d in SPANS]
    kernels = KERNELS + [(n, t + 4000, d) for n, t, d in KERNELS]
    w = window(spans, kernels)
    assert metric("detector.device_ms").read(ctx_of(w)) == pytest.approx(24e-3)
    assert metric("detector.kernels_per_call").read(ctx_of(w)) == 5.0
    m = metric("detector_roofline")
    shape = cell_shape()
    assert m.detector_bytes(shape) == 256 * 14 * 250 * 160 == 143_360_000
    assert m.detector_flops(shape) == 256 * 14 * 250 * 448
    assert m.bound_s(shape, peaks.H100_SXM) == pytest.approx(143.36e6 / 3.35e12)
    assert m.read(ctx_of(w)) == pytest.approx(100 * (143.36e6 / 3.35e12) / 24e-6)
    # the modem and channel readers read the spatial link's spans too
    assert metric("modem.device_ms").read(ctx_of(w)) == pytest.approx(350e-3)
    assert metric("channel.device_ms").read(ctx_of(w)) == pytest.approx(900e-3)


@pytest.mark.parametrize("name", ["detector.device_ms", "detector.kernels_per_call",
                                  "detector_roofline"])
def test_a_window_with_no_detector_span_is_a_lost_trace(name):
    spans = [s for s in SPANS if not s[0].startswith("detector.")]
    with pytest.raises(core.LostTrace):
        metric(name).read(ctx_of(window(spans, KERNELS, calls=1)))
    assert metric(name).read(ctx_of(window(spans, [], calls=1))) is None
    assert metric(name).read(ctx_of(None)) is None


@pytest.mark.parametrize("name", ["detector.device_ms", "detector.kernels_per_call",
                                  "detector_roofline"])
def test_a_program_without_the_detector_layer_reads_nothing(name, monkeypatch):
    import ofdm_lte_tpu_torch.utils.profiling as prof
    monkeypatch.setattr(prof, "LAYERS", ("link", "modem", "channel", "coding"))
    spans = [s for s in SPANS if not s[0].startswith("detector.")]
    assert metric(name).read(ctx_of(window(spans, KERNELS, calls=1))) is None


def test_the_roofline_cannot_pass_100_percent():
    # the least time of the reads alone: a detector at the HBM rate reads 100%
    m, shape = metric("detector_roofline"), cell_shape()
    t = m.detector_bytes(shape) / peaks.H100_SXM["hbm_bytes_per_s"]
    assert m.detector_flops(shape) / peaks.H100_SXM["fp32_flops"] < t
    kernels = [("detector", 320, t * 1e6)]
    w = window([("detector.sic", 300, 100)], kernels, calls=1)
    assert m.read(ctx_of(w)) == pytest.approx(100.0)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A tiny checkout with t_sic, sic4x4_peda at 1.25 MHz and 1 frame a
    point, and t_sic_mmse, the same with the MMSE detector, added as files."""
    root = tiny_checkout(tmp_path_factory.mktemp("pb_sic"))
    pb = root / "portbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((pb / "traffic" / "ber_sic4x4_peda_8x32.json").read_text())
    traffic.update(frames=1, check_calls=2)
    (pb / "traffic" / "t_sic_mix.json").write_text(json.dumps(traffic))
    for name, det in (("t_sic", "SIC"), ("t_sic_mmse", "MMSE")):
        cfg = dict(tiny_config(), name=f"{name}_cfg", detector=det)
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": f"{name}_cfg", "source": "https://example.org/tiny",
                                "file": f"portbench/configs/{name}.json", "reduced": [],
                                "why": "test"})
        (pb / "limits" / f"{name}.json").write_text(json.dumps(
            {"error_gap_bits": 30, "papr_gap_db": 1e-4, "bits_gap": 0}))
        spec["workloads"].append({"name": name, "config": f"{name}_cfg", "traffic": "t_sic_mix",
                                  "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_a_tiny_sic_cell_runs_through_the_runner_correct(checkout):
    out = run_cpu(checkout, "t_sic", seconds=0.3)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["forbidden"] == []
    assert set(out["metrics"]) == {"info_Mbit_per_s", "sweep_p95_ms", "setup_s"}
    assert out["checks"]["bits_gap"] == {"value": 0.0, "limit": 0}
    assert out["checks"]["error_gap_bits"]["value"] <= 30


def test_the_mmse_detector_in_sics_place_is_not_correct(checkout):
    out = run_cpu(checkout, "t_sic_mmse", seconds=0.3)
    assert not out["correct"]
    assert out["checks"]["error_gap_bits"]["value"] > 30


def test_the_cells_limits_are_what_its_adapter_compares():
    cell = core.Cell(CELL, REPO)
    sample = {"bit_errors": np.zeros(8), "total_bits": np.ones(8), "papr_db": np.zeros(8)}
    assert set(cell.limits) <= set(cell.entry.compare(sample, sample))
    assert cell.limits["bits_gap"] == 0
