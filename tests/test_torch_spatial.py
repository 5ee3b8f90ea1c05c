"""The TM4 spatial-multiplexing link against the JAX package under the JAX
package's own draws: the channel matrix, the Jakes phases and the four
noise blocks are drawn by jax.random from the test's key, split as
ofdm_lte_tpu/sim/spatial.py splits it, and handed to the port's seams. Bit
decisions must then agree but for a share of 1e-4 (matmul rounding alone
separates the two), PAPR to 1e-4 dB."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu.channel import rayleigh as jray
from ofdm_lte_tpu.grid import grid_for
from ofdm_lte_tpu.mimo import layer_mapper as jlm
from ofdm_lte_tpu.sim import spatial as jsp

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.sim import spatial as tsp

torch.set_num_threads(2)

MISMATCH_SHARE = 1e-4


def jax_draws(key, cfg, num_tx, num_rx, rank_used, lanes, S, channel_type):
    """What _simulate_spatial_jit draws from `key`, as the port's seams."""
    g = grid_for(cfg)
    m = jlm.padded_length(g.num_data, rank_used) // rank_used
    kch, kd, kp = jax.random.split(key, 3)

    def normals(k, shape):
        kr, ki = jax.random.split(k)
        return (np.array(jax.random.normal(kr, shape, jnp.float32)),
                np.array(jax.random.normal(ki, shape, jnp.float32)))

    draws = {"noise": (normals(kd, (num_rx, lanes, S, m)),
                       normals(kp, (num_rx, lanes, S, g.num_pilot)))}
    if channel_type == "rayleigh_mp":
        taps = jray.make_profile("Pedestrian_A", cfg.fs, 3.0, 2.0).num_taps
        draws["phases"] = np.stack([
            np.array(jax.random.uniform(kk, (lanes * taps, jray.N_SINUSOIDS), jnp.float32,
                                        0.0, 2.0 * np.pi))
            for k in jax.random.split(kch, num_rx)
            for kk in jax.random.split(k, num_tx)]).reshape(-1, jray.N_SINUSOIDS)
    else:
        draws["fading"] = normals(kch, (lanes, num_rx, num_tx))
    return draws


def run_both(bw, modulation, snr_db, lanes=3, S=14, seed=0, impl=None, monkeypatch=None, **kw):
    jc, tc = jcfg.LTEConfig(bw, modulation=modulation), LTEConfig(bw, modulation=modulation)
    key = jax.random.PRNGKey(seed)
    bits = np.random.default_rng(seed).integers(
        0, 2, (lanes, jsp.bits_per_frame(jc, S))).astype(np.int32)
    if impl is not None:
        monkeypatch.setenv("OFDM_LTE_TPU_SPATIAL_CHANNEL", impl)
        monkeypatch.setenv("OFDM_LTE_TPU_TORCH_SPATIAL_CHANNEL", impl)
    snr = np.asarray(snr_db, np.float32)
    # op by op: compiling the whole graph costs more than running it here
    with jax.disable_jit():
        j = jsp.simulate_spatial_multiplexing(key, jnp.asarray(bits), jnp.asarray(snr), jc,
                                              **kw)
    rank = kw.get("rank", "adaptive")
    rank_used, pmi, W = tsp.decide_rank_pmi(kw["num_tx"], kw["num_rx"], float(snr.mean()),
                                           rank, kw.get("seed", 0))
    draws = jax_draws(key, jc, kw["num_tx"], kw["num_rx"], rank_used, lanes, S,
                      kw.get("channel_type", "awgn"))
    t = tsp.simulate_spatial_multiplexing(torch.from_numpy(bits), snr, tc, device="cpu",
                                          draws=draws, **kw)
    return j, t, bits


def check(j, t, bits, ber_range=(0.0, 0.3)):
    mismatch = int(np.sum(t.bits_rx.numpy() != np.asarray(j.bits_rx)))
    assert mismatch <= MISMATCH_SHARE * bits.size, (mismatch, bits.size)
    np.testing.assert_allclose(t.papr_db.numpy(), np.asarray(j.papr_db), atol=1e-4)
    assert t.bits_rx.shape == bits.shape and t.ber.shape == (bits.shape[0],)
    assert t.symbols_rx.shape == tuple(j.symbols_rx.shape)
    lo, hi = ber_range
    assert lo <= t.ber.mean().item() <= hi, t.ber
    return mismatch


FLAT_CASES = {
    "2x2_r2_mmse": dict(num_tx=2, num_rx=2, rank=2, detector_type="MMSE"),
    "4x2_r1_mrc": dict(num_tx=4, num_rx=2, rank=1, detector_type="MRC"),
    "2x2_r2_zf": dict(num_tx=2, num_rx=2, rank=2, detector_type="ZF"),
    "4x4_r3_zf": dict(num_tx=4, num_rx=4, rank=3, detector_type="ZF"),
    "4x4_r3_mmse_u": dict(num_tx=4, num_rx=4, rank=3, detector_type="MMSE-U"),
    "4x2_adaptive_mmse": dict(num_tx=4, num_rx=2, rank="adaptive", detector_type="MMSE",
                              seed=3),
}


@pytest.mark.parametrize("name", list(FLAT_CASES))
def test_flat_bins_same_draws_match_jax(name):
    """The default path of the flat channel (noise and mixing at the bins),
    one SNR per lane."""
    j, t, bits = run_both(5.0, "16-QAM", [12.0, 18.0, 25.0], **FLAT_CASES[name])
    check(j, t, bits, (0.0, 0.45))


def test_adaptive_rank_pmi_and_precoder_equal():
    for num_tx, num_rx, snr, seed in ((4, 2, 18.0, 3), (4, 4, 25.0, 0), (2, 2, 3.0, 1),
                                      (8, 4, 30.0, 5), (4, 4, 7.0, 2)):
        jr, jp, jW = jsp.decide_rank_pmi(num_tx, num_rx, snr, "adaptive", seed)
        tr, tp, tW = tsp.decide_rank_pmi(num_tx, num_rx, snr, "adaptive", seed)
        assert (jr, jp) == (tr, tp)
        np.testing.assert_array_equal(jW, tW)
    for rank in (1, 2, 3, 4):
        j, t = jsp.decide_rank_pmi(4, 4, 0.0, rank), tsp.decide_rank_pmi(4, 4, 0.0, rank)
        assert j[:2] == t[:2] == (rank, 0)
        np.testing.assert_array_equal(j[2], t[2])


@pytest.mark.parametrize("detector_type", ["MMSE", "SIC"])
def test_flat_time_path_same_draws_match_jax(detector_type, monkeypatch):
    """The time path over the flat channel: TX GEMM for all antennas, link
    mixing, data and per-symbol pilot GEMMs, noise at the bins."""
    kw = dict(num_tx=4, num_rx=2, rank=2, detector_type=detector_type)
    j, t, bits = run_both(5.0, "64-QAM", 25.0, impl="time", monkeypatch=monkeypatch, **kw)
    check(j, t, bits)


def test_bins_equal_time_under_the_same_draws(monkeypatch):
    """For a flat channel the two implementations are an algebraic identity."""
    cfg = LTEConfig(5.0, modulation="16-QAM")
    lanes, S = 3, 14
    bits = torch.from_numpy(np.random.default_rng(7).integers(
        0, 2, (lanes, tsp.bits_per_frame(cfg, S))).astype(np.int32))
    draws = jax_draws(jax.random.PRNGKey(11), jcfg.LTEConfig(5.0), 2, 2, 2, lanes, S, "awgn")
    snr = np.array([8.0, 15.0, 30.0], np.float32)
    out = {}
    for impl in ("bins", "time"):
        link = tsp.SpatialLink(cfg, 2, 2, 2, "MMSE", device="cpu", channel_impl=impl)
        out[impl] = link(bits, snr, draws=draws)
    mismatch = int((out["bins"].bits_rx != out["time"].bits_rx).sum())
    assert mismatch <= MISMATCH_SHARE * bits.numel(), mismatch
    np.testing.assert_allclose(out["bins"].papr_db.numpy(), out["time"].papr_db.numpy(),
                               atol=1e-4)
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_SPATIAL_CHANNEL", "nope")
    with pytest.raises(ValueError, match="pick from"):
        tsp.simulate_spatial_multiplexing(bits, 10.0, cfg, num_tx=2, num_rx=2, device="cpu")


def test_clean_at_60_db_flat_2x2_rank_2():
    cfg = LTEConfig(5.0, modulation="64-QAM")
    bits = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2, (4, tsp.bits_per_frame(cfg, 14))).astype(np.int8))
    r = tsp.simulate_spatial_multiplexing(bits, 60.0, cfg, num_tx=2, num_rx=2, rank=2,
                                          generator=torch.Generator().manual_seed(0),
                                          device="cpu")
    assert int(r.bit_errors.sum()) == 0 and r.bits_rx.dtype == torch.int8
    assert torch.isfinite(r.papr_db).all() and r.papr_db.shape == (4,)


def test_link_arguments_and_precoder_seam():
    cfg = LTEConfig(1.25, modulation="QPSK")
    with pytest.raises(ValueError, match="channel_type"):
        tsp.SpatialLink(cfg, 2, 2, 2, device="cpu", channel_type="fading")
    link = tsp.SpatialLink(cfg, 4, 2, 2, device="cpu")
    assert all(b.is_contiguous() for b in link.buffers())
    assert link.mod_b_re.shape == (link.m, cfg.samples_per_ofdm_symbol)
    assert link.pilot_wave_re.shape == (4, cfg.samples_per_ofdm_symbol)
    bits = torch.zeros(tsp.bits_per_frame(cfg, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="precoder"):
        link(bits, 10.0, W=np.ones((4, 3)))
    with pytest.raises(ValueError, match="noise"):
        link(bits, 10.0, draws={"noise": ((np.zeros(3), np.zeros(3)),) * 2})
    # a 1-D frame, and W given as NumPy equals the buffer's PMI 0
    from ofdm_lte_tpu_torch.mimo import codebook
    gen = torch.Generator()
    a = link(bits, 20.0, generator=gen.manual_seed(1))
    b = link(bits, 20.0, W=codebook.get_precoder(0, 4, "TM4", 2), generator=gen.manual_seed(1))
    assert torch.equal(a.bits_rx, b.bits_rx) and a.ber.shape == ()
