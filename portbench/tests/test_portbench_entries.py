"""The entry adapters: a cell finds its adapter by the traffic's `entry`;
`ber_sweep`'s draws, arguments and call are those of the harness before
adapters; the HARQ entry's draws come in a fixed order and shape, and its
`compare` reads each lane's outcome; the verdict takes its numbers from the
limits file's keys, which each adapter's `compare` produces."""
import importlib
import json

import numpy as np
import pytest
import torch

from harness import check, core, inputs
from pb_helpers import REPO

HARQ = "simulate_siso_coded_harq_batched"


@pytest.mark.parametrize("workload,entry", [("siso64_awgn", "ber_sweep"),
                                            ("siso64_peda", "ber_sweep"),
                                            ("siso64_awgn_wide", "ber_sweep"),
                                            ("harq75376_awgn", HARQ)])
def test_a_cell_finds_its_adapter_by_the_entry(workload, entry):
    cell = core.Cell(workload, REPO)
    assert cell.traffic["entry"] == entry and cell.entry.ENTRY.endswith("." + entry)
    module, fn = cell.entry.ENTRY.rsplit(".", 1)
    assert callable(getattr(importlib.import_module(f"ofdm_lte_tpu_torch.{module}"), fn))
    for fn in ("shape", "kwargs", "call_inputs", "sweep_args", "call", "results", "info_bits",
               "products", "reference", "compare"):
        assert callable(getattr(cell.entry, fn)), fn


def test_ber_adapter_keeps_the_harness_draws_and_arguments():
    cell = core.Cell("siso64_peda", REPO)
    shape = cell.shape()
    assert shape == inputs.Shape(8, 32, 83916, 14, 2048, 144, 999, 200, "rayleigh_mp", 4)
    assert cell.entry.kwargs(cell.config, cell.traffic) == dict(
        frames=32, num_ofdm_symbols=14, mode="lte", channel_type="rayleigh_mp", pipeline="siso",
        itu_profile="Pedestrian_A", velocity_kmh=None)
    assert set(cell.entry.kwargs(core.Cell("siso64_awgn", REPO).config,
                                 core.Cell("siso64_awgn", REPO).traffic)) == {
        "frames", "num_ofdm_symbols", "mode", "channel_type", "pipeline"}
    small = inputs.Shape(2, 2, 12, 14, 128, 9, 60, 12, "awgn", 0)
    a = cell.entry.call_inputs(small, 2 ** 33 + 3, 0, 1, "cpu")
    # the draws of the harness before adapters: one generator, bits then
    # each array lane-leading, in Shape.arrays() order
    gen = torch.Generator().manual_seed(inputs.seed_word(2 ** 33 + 3, 0, 1))
    assert torch.equal(a["bits"], torch.randint(0, 2, (4, 12), generator=gen, dtype=torch.int8))
    for name, per, _ in small.arrays():
        assert torch.equal(a[name], torch.randn((4,) + per, generator=gen)), name
    args = cell.entry.sweep_args(small, a)
    assert args["bits"].shape == (2, 2, 12) and set(args["seams"]) == {"noise"}
    # the call: ber_sweep(cfg, snr, device=, bits=, seams=, **kwargs), as before
    seen = []
    kw = cell.entry.kwargs(cell.config, cell.traffic)
    cell.entry.call(lambda *p, **k: seen.append((p, k)), "cfg", [1.0], small, args, kw, "cpu")
    assert seen == [(("cfg", [1.0]), dict(device="cpu", **args, **kw))]


def test_harq_adapter_draws_in_order_and_shape():
    cell = core.Cell("harq75376_awgn", REPO)
    shape = cell.shape()
    assert (shape.points, shape.frames, shape.tb_bits, shape.transmissions) == (4, 64, 75376, 4)
    assert shape.samples == 38 * (2048 + 144) and shape.block_sizes == (5824,) * 13
    assert (shape.symbols, shape.n_fft, shape.cp, shape.n_data, shape.n_pilot) == (
        38, 2048, 144, 999, 200)
    assert [a[0] for a in shape.arrays()] == ["bits", "noise_re", "noise_im"]
    kw = cell.entry.kwargs(cell.config, cell.traffic)
    assert kw == dict(rv_sequence=(0, 1, 2, 3), num_iterations=8, channel_type="awgn")
    small = shape._replace(points=2, frames=3, tb_bits=40, samples=7)
    a = cell.entry.call_inputs(small, 2 ** 40 + 9, 2, 5, "cpu")
    gen = torch.Generator().manual_seed(inputs.seed_word(2 ** 40 + 9, 2, 5))
    assert torch.equal(a["bits"], torch.randint(0, 2, (2, 3, 40), generator=gen,
                                                 dtype=torch.int8))
    assert torch.equal(a["noise_re"], torch.randn((4, 6, 7), generator=gen))
    assert torch.equal(a["noise_im"], torch.randn((4, 6, 7), generator=gen))
    args = cell.entry.sweep_args(small, a)
    assert torch.equal(args["bits"], a["bits"].reshape(6, 40))
    assert args["draws"]["noise"][0] is a["noise_re"]
    # the call: bits and the lanes' SNRs, point-major, then the config
    seen = []
    cell.entry.call(lambda *p, **k: seen.append((p, k)), "cfg", [15.7, 16.2], small, args, kw,
                    "cpu")
    (bits, snr, cfg), k = seen[0]
    assert bits is args["bits"] and cfg == "cfg"
    assert snr.tolist() == np.repeat(np.float32([15.7, 16.2]), 3).tolist()
    assert k == dict(device="cpu", draws=args["draws"], **kw)


def harq_result(fail, ntx, errs, papr):
    from ofdm_lte_tpu_torch.sim.coded import HarqBatchResult
    passed = torch.as_tensor(fail) == 0
    errs = torch.as_tensor(errs, dtype=torch.int32)
    return HarqBatchResult(None, errs, errs / 40.0, passed[:, -1],
                           torch.as_tensor(ntx, dtype=torch.int32), passed,
                           torch.as_tensor(papr, dtype=torch.float32))


def test_harq_compare_reads_each_lanes_outcome():
    entry = core.Cell("harq75376_awgn", REPO).entry
    shape = core.Cell("harq75376_awgn", REPO).shape()._replace(points=2, frames=2, tb_bits=40,
                                                               transmissions=2)
    port = entry.results(shape, harq_result([[1, 0], [1, 1], [1, 1], [0, 0]], [2, 2, 2, 1],
                                            [0, 7, 3, 0], [8.5, 9.0, 7.25, 8.0]))
    assert port["info_bits"] == 160 and entry.info_bits(port) == 160
    assert port["fail"].tolist() == [[1, 0], [1, 1], [1, 1], [0, 0]]
    assert port["ntx"].tolist() == [2, 2, 2, 1] and port["errs"].tolist() == [0, 7, 3, 0]
    ref = {"fail": np.array([[1, 0], [1, 1], [1, 0], [1, 0]]), "ntx": np.array([2, 2, 2, 2]),
           "errs": np.array([0, 5, 0, 0]), "papr_db": np.array([8.5, 9.0, 7.25, 8.001])}
    gaps = entry.compare(port, ref)
    assert gaps == pytest.approx({"stage_fail_gap": 2.0, "tx_gap": 1.0, "error_gap_bits": 2.0,
                                  "crc_mismatch_lanes": 0.0, "papr_gap_db": 0.001})
    # a lane passed with errors, another failed with none: CRC-24A mismatches
    odd = dict(port, errs=np.array([1, 0, 3, 0]))
    assert entry.compare(odd, ref)["crc_mismatch_lanes"] == 2.0
    short = {k: v[:2] for k, v in ref.items()}
    assert entry.compare(port, short)["stage_fail_gap"] == float("inf")


def test_verdict_takes_its_numbers_from_the_limits():
    limits = {"tx_gap": 2, "bits_gap": 0}
    ok = [{"tx_gap": 1.0, "bits_gap": 0.0, "error_gap_bits": 1e9}]
    correct, failed, checks = check.verdict(ok, limits)
    assert correct and failed == 0 and list(checks) == ["tx_gap", "bits_gap"]
    assert checks["tx_gap"] == {"value": 1.0, "limit": 2}
    over = ok + [{"tx_gap": 3.0, "bits_gap": 0.0}]
    assert check.verdict(over, limits)[:2] == (False, 1)
    # a number that the adapter does not produce fails the call
    missing = [{"tx_gap": 0.0}]
    correct, failed, checks = check.verdict(missing, limits)
    assert not correct and failed == 1 and checks["bits_gap"]["value"] == float("inf")
    assert check.verdict([], limits) == (False, 0, {})


SAMPLES = {"ber_sweep": {"bit_errors": np.zeros(2), "total_bits": np.ones(2),
                        "papr_db": np.zeros(2)},
           HARQ: {"fail": np.zeros((2, 4), np.int64), "ntx": np.ones(2, np.int64),
                  "errs": np.zeros(2, np.int64), "papr_db": np.zeros(2)}}


def test_every_cells_limits_are_what_its_adapter_compares():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = core.Cell(w["name"], REPO)
        sample = SAMPLES[cell.traffic["entry"]]
        assert set(cell.limits) <= set(cell.entry.compare(sample, sample)), w["name"]
