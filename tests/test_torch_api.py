"""The facade against the JAX package's: the same dict keys for every
method, clean links at 60 dB (the coded ones at 30 dB), the presets and the
metrics."""
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import api as japi
from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.utils import metrics as jmetrics

from ofdm_lte_tpu_torch import LTEConfig, OFDMModule, OFDMSimulator, create_simulator
from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

BITS = np.random.default_rng(0).integers(0, 2, 1500)


def _sims(**kw):
    return (japi.OFDMSimulator(jcfg.LTEConfig(1.25, modulation="16-QAM"), seed=0, **kw),
            OFDMSimulator(LTEConfig(1.25, modulation="16-QAM"), seed=0, device="cpu", **kw))


@pytest.mark.parametrize("kw", [{"mode": "lte"}, {"enable_sc_fdm": True}, {"mode": "simple"},
                                {"channel_type": "rayleigh_mp", "itu_profile": "Pedestrian_A",
                                 "velocity_kmh": 3.0}, {"channel_type": "fading"}],
                         ids=["lte", "sc-fdm", "simple", "rayleigh_mp", "fading"])
def test_simulate_siso_keys_equal(kw):
    j, t = _sims(**kw)
    ref, out = j.simulate_siso(BITS, 60.0), t.simulate_siso(BITS, 60.0)
    assert set(out) == set(ref)
    assert (t.mode, t.enable_sc_fdm, t.velocity_kmh) == (j.mode, j.enable_sc_fdm, j.velocity_kmh)
    assert out["symbols_rx"].shape == ref["symbols_rx"].shape
    assert out["signal_tx"].shape == ref["signal_tx"].shape
    np.testing.assert_allclose(out["signal_tx"], ref["signal_tx"], atol=1e-4)
    assert out["transmitted_bits"] == 1500 and t.last_results is out
    if kw.get("channel_type") != "fading":
        assert out["ber"] == ref["ber"] == 0.0
        np.testing.assert_array_equal(out["bits_received_array"], BITS)


@pytest.mark.parametrize("method,kw", [("simulate_simo", {"num_rx": 2}), ("simulate_miso", {}),
                                       ("simulate_mimo", {"num_rx": 2})])
@pytest.mark.parametrize("channel_type", ["awgn", "rayleigh_mp"])
def test_diversity_methods_keys_equal(method, kw, channel_type):
    j, t = _sims(channel_type=channel_type)
    ref, out = getattr(j, method)(BITS, 60.0, **kw), getattr(t, method)(BITS, 60.0, **kw)
    assert set(out) == set(ref)
    for k in set(ref) - {"bits_received_array", "papr_db", "ber", "bit_errors", "errors"}:
        assert out[k] == ref[k], k
    assert abs(out["papr_db"] - ref["papr_db"]) < 1e-3
    if channel_type == "awgn" or method == "simulate_simo":
        assert out["ber"] == 0.0
    # one link per (pipeline, num_rx), built once and kept
    link = t._link("simo" if method == "simulate_simo" else "sfbc", kw.get("num_rx", 1))
    getattr(t, method)(BITS, 60.0, **kw)
    assert t._link("simo" if method == "simulate_simo" else "sfbc", kw.get("num_rx", 1)) is link
    assert len(t._links) == 1


def test_run_ber_sweep_keys_and_shape():
    j, t = _sims()
    calls = []
    ref = j.run_ber_sweep(BITS, [0.0, 10.0, 60.0], num_trials=2)
    out = t.run_ber_sweep(BITS, [0.0, 10.0, 60.0], num_trials=2,
                          progress_callback=lambda i, n: calls.append((i, n)))
    assert set(out) == set(ref) and calls == [(1, 3), (2, 3), (3, 3)]
    for k in ref:
        assert out[k].shape == ref[k].shape == (3,), k
    np.testing.assert_array_equal(out["snr_values"], ref["snr_values"])
    assert out["ber_values"][0] > out["ber_values"][1] > out["ber_values"][2] == 0.0
    assert abs(out["ber_values"][0] - ref["ber_values"][0]) < 0.03
    assert (out["ber_ci_low"] <= out["ber_values"]).all()
    mod = OFDMModule(LTEConfig(1.25), seed=1, device="cpu", channel_type="awgn")
    assert set(mod.run_ber_sweep(BITS, [5.0], 1)) == set(ref)
    assert (mod.modulation, mod.bandwidth) == ("QPSK", 1.25)


def test_run_ber_sweep_all_modulations():
    _, t = _sims()
    out = t.run_ber_sweep_all_modulations(BITS[:600], [60.0])
    assert list(out) == ["QPSK", "16-QAM", "64-QAM"]
    assert all(v["ber_values"][0] == 0.0 for v in out.values())


def test_module_passes_channel_keywords_through():
    mod = OFDMModule(LTEConfig(1.25), device="cpu", channel_type="rayleigh_mp",
                     itu_profile="Pedestrian_B", velocity_kmh=50.0, frequency_ghz=2.6)
    sim = mod.simulator
    assert sim.link.profile.name.startswith("Pedestrian_B")
    assert abs(sim.link.profile.doppler_hz - (50 / 3.6) * 2.6e9 / 3e8) < 1e-9
    assert 0.0 <= mod.transmit(BITS, 60.0)["ber"] < 0.3     # a selective channel at 1.25 MHz


@pytest.mark.parametrize("preset", ["5MHz_QPSK", "10MHz_16QAM", "10MHz_64QAM", "20MHz_16QAM",
                                    "20MHz_64QAM"])
def test_create_simulator_presets_equal(preset):
    j, t = japi.create_simulator(preset), create_simulator(preset, device="cpu")
    assert (t.config.bandwidth, t.config.modulation, t.config.N, t.config.Nc) == \
           (j.config.bandwidth, j.config.modulation, j.config.N, j.config.Nc)
    with pytest.raises(ValueError, match="Unknown preset"):
        create_simulator("3MHz_QPSK", device="cpu")


@pytest.mark.parametrize("method", ["simulate_siso_coded", "simulate_siso_coded_harq"])
def test_coded_methods_keys_equal_and_clean_at_30_db(method):
    """The coded methods: the JAX facade's keys and values on a clean link (a
    1,500-bit transport block, one block of K 1536, 16-QAM)."""
    j, t = _sims()
    ref, out = getattr(j, method)(BITS, 30.0), getattr(t, method)(BITS, 30.0)
    assert set(out) == set(ref) and t.last_results is out
    for key in set(ref) - {"bits_received_array", "papr_db", "channel_snr_db"}:
        assert out[key] == ref[key], key
    assert out["crc_pass"] is True and out["ber"] == 0.0
    np.testing.assert_array_equal(out["bits_received_array"], BITS)
    if method == "simulate_siso_coded":
        assert out["coded_bits_length"] == 3 * 1536 + 12
        assert abs(out["papr_db"] - ref["papr_db"]) < 1.0          # other noise, same signal
    else:
        assert out["num_transmissions"] == 1 and out["rv_history"] == [0]


def test_coded_harq_retransmits_below_the_waterfall():
    _, t = _sims()
    out = t.simulate_siso_coded_harq(BITS, 2.0, rv_sequence=(0, 2), use_max_log=False)
    n = out["num_transmissions"]
    assert out["rv_history"] == [0, 2][:n] and len(out["crc_history"]) == n
    assert out["crc_history"][0] is False                        # 16-QAM at 2 dB
    assert out["crc_pass"] == out["crc_history"][-1]
    assert t.simulate_siso_coded(BITS, 2.0, rv=1)["crc_pass"] is False


@pytest.mark.parametrize("kw", [dict(num_tx=2, num_rx=2, rank=2),
                                dict(num_tx=4, num_rx=2, rank="adaptive"),
                                dict(num_tx=4, num_rx=4, rank=2, detector_type="SIC")],
                         ids=["2x2_r2", "4x2_adaptive", "4x4_r2_sic"])
def test_simulate_spatial_multiplexing_keys_and_clean_link(kw):
    """The facade's TM4 method: the JAX facade's keys, BER 0 at 60 dB, one
    link kept per (antennas, rank, detector)."""
    j, t = _sims()
    ref = j.simulate_spatial_multiplexing(BITS, 60.0, **kw)
    out = t.simulate_spatial_multiplexing(BITS, 60.0, **kw)
    assert set(out) == set(ref)
    for key in ("transmitted_bits", "received_bits", "num_tx", "num_rx", "detector_type",
                "mode", "snr_db"):
        assert out[key] == ref[key], key
    assert out["ber"] == ref["ber"] == 0.0 and out["bit_errors"] == 0
    np.testing.assert_array_equal(out["bits_received_array"], BITS)
    assert abs(out["papr_db"] - ref["papr_db"]) < 1e-3
    links = dict(t._links)
    assert 0.0 < t.simulate_spatial_multiplexing(BITS, 5.0, **kw)["ber"] < 0.5
    if kw["rank"] != "adaptive":
        assert t._links == links              # the same link served both calls
    assert t.last_results["snr_db"] == 5.0


def test_unknown_mode_or_channel_raises():
    with pytest.raises(ValueError):
        OFDMSimulator(LTEConfig(1.25), mode="nope", device="cpu")
    with pytest.raises(ValueError):
        OFDMSimulator(LTEConfig(1.25), channel_type="nope", device="cpu")


def test_metrics_match_jax(rng):
    tx, rx = rng.integers(0, 2, 500), rng.integers(0, 2, 480)
    assert tmetrics.ber(tx, rx) == jmetrics.ber(tx, rx)
    samples = [0.01, 0.012, 0.008, 0.011]
    assert tmetrics.ber_confidence_interval(samples) == jmetrics.ber_confidence_interval(samples)
    assert tmetrics.ber_confidence_interval([0.1]) == (0.1, 0.1, 0.1)
    a = (rng.standard_normal(400) + 1j * rng.standard_normal(400)) / np.sqrt(2)
    b = a + 0.3 * (rng.standard_normal(400) + 1j * rng.standard_normal(400))
    for mod in ("QPSK", "16-QAM", "64-QAM"):
        assert tmetrics.ser(tcplx.from_numpy(a), tcplx.from_numpy(b), mod) == \
               jmetrics.ser(jcplx.from_numpy(a), jcplx.from_numpy(b), mod)
    assert abs(tmetrics.evm_percent(tcplx.from_numpy(a), tcplx.from_numpy(b))
               - jmetrics.evm_percent(jcplx.from_numpy(a), jcplx.from_numpy(b))) < 1e-3
    for bw in (1.25, 20.0):
        for data in (True, False):
            assert tmetrics.nominal_throughput_mbps(LTEConfig(bw, modulation="64-QAM"), data) == \
                   jmetrics.nominal_throughput_mbps(jcfg.LTEConfig(bw, modulation="64-QAM"), data)
    papr = rng.uniform(4, 12, 300)
    t, j = tmetrics.papr_ccdf(torch.from_numpy(papr)), jmetrics.papr_ccdf(papr)
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
