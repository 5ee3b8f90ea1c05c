"""TM6/TM4 beamforming with CSI feedback against the JAX package: the
precoders, the gain, the update cadence, CQI, RI, PMI and its statistics
on the same inputs; both simulations under the JAX package's own draws
(the key split as ofdm_lte_tpu/sim/beamforming.py splits it, H or the
Jakes phases and the noise fed to the port's seams): decisions equal but
for a share of 1e-4 of the bits, PMI and its history equal, gains within
1e-5 dB; the facade's dict and the `beamforming` sweep against the JAX
facade and sweep."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import api as japi
from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.mimo import beamforming as jbfp
from ofdm_lte_tpu.mimo import csi as jcsi
from ofdm_lte_tpu.parallel import sweep as jsweep
from ofdm_lte_tpu.sim import beamforming as jbf

from ofdm_lte_tpu_torch import LTEConfig, OFDMSimulator
from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.mimo import beamforming as tbfp
from ofdm_lte_tpu_torch.mimo import codebook as tcb
from ofdm_lte_tpu_torch.mimo import csi as tcsi
from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep
from ofdm_lte_tpu_torch.sim import beamforming as tbf

torch.set_num_threads(2)

MISMATCH_SHARE = 1e-4
GAIN_ATOL_DB = 1e-5


def _channels(rng, lead, num_rx, num_tx):
    H = (rng.standard_normal(lead + (num_rx, num_tx))
         + 1j * rng.standard_normal(lead + (num_rx, num_tx))) / np.sqrt(2)
    return jcplx.from_numpy(H), tcplx.from_numpy(H)


@pytest.mark.parametrize("num_rx,num_tx", [(1, 2), (2, 4), (4, 8)])
def test_precoders_and_gain_match_jax(num_rx, num_tx, rng):
    jH, tH = _channels(rng, (6,), num_rx, num_tx)
    np.testing.assert_allclose(tbfp.mrt_weights(tH).to_numpy(),
                               jbfp.mrt_weights(jH).to_numpy(), rtol=0, atol=1e-6)
    # an eigenvector is unique up to a phase: |<w_jax, w_port>| = 1
    wj = jbfp.eigen_weights(jH).to_numpy()[..., 0]
    wt = tbfp.eigen_weights(tH).to_numpy()[..., 0]
    np.testing.assert_allclose(np.linalg.norm(wt, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(np.abs(np.sum(wj.conj() * wt, axis=-1)), 1.0, atol=1e-5)
    for W in (tbfp.mrt_weights(tH), tbfp.eigen_weights(tH)):
        jW = jcplx.from_numpy(W.to_numpy())
        np.testing.assert_allclose(tbfp.beamforming_gain_db(tH, W).numpy(),
                                   np.asarray(jbfp.beamforming_gain_db(jH, jW)),
                                   rtol=0, atol=GAIN_ATOL_DB)
    s = tcplx.from_numpy(rng.standard_normal((6, 5)) + 1j * rng.standard_normal((6, 5)))
    W = tbfp.mrt_weights(tH)
    np.testing.assert_allclose(
        tbfp.apply_precoding(s, W).to_numpy(),
        np.asarray(jbfp.apply_precoding(jcplx.from_numpy(s.to_numpy()),
                                        jcplx.from_numpy(W.to_numpy())).to_numpy()),
        rtol=0, atol=1e-6)


def test_update_period_matches_jax_over_velocities():
    for v in list(range(0, 501, 5)) + [0.5, 3.0, 7.3, 29.9, 120.0, 350.0]:
        for f in (0.9, 2.0, 3.5):
            assert tbfp.update_period_symbols(v, f) == jbfp.update_period_symbols(v, f), (v, f)
    assert tbfp.update_period_symbols(30.0, 2.0) == 4       # chip_smoke's Jakes path


def test_cqi_rank_indicator_and_feedback_match_jax(rng):
    sinr = np.concatenate([np.arange(-8.0, 25.0, 0.5), [-6.0, 22.0, -6.0001, 21.9999]])
    sinr = sinr.astype(np.float32)
    np.testing.assert_array_equal(tcsi.sinr_to_cqi(torch.from_numpy(sinr)).numpy(),
                                  np.asarray(jcsi.sinr_to_cqi(jnp.asarray(sinr))))
    np.testing.assert_array_equal(tcsi._CQI_EDGES_DB, jcsi._CQI_EDGES_DB)
    for num_rx, num_tx in ((1, 1), (1, 2), (2, 2), (4, 4), (2, 8)):
        jH, tH = _channels(rng, (40,), num_rx, num_tx)
        np.testing.assert_array_equal(tcsi.rank_indicator(tH).numpy(),
                                      np.asarray(jcsi.rank_indicator(jH)))
        if num_tx == 1:
            continue
        jf = jcsi.generate_feedback(jH, num_tx, noise_variance=0.5)
        tf = tcsi.generate_feedback(tH, num_tx, noise_variance=0.5)
        np.testing.assert_array_equal(tf.pmi.numpy(), np.asarray(jf.pmi))
        np.testing.assert_array_equal(tf.cqi.numpy(), np.asarray(jf.cqi))
        np.testing.assert_array_equal(tf.ri.numpy(), np.asarray(jf.ri))
        np.testing.assert_allclose(tf.sinr_db.numpy(), np.asarray(jf.sinr_db), atol=1e-5)
        np.testing.assert_array_equal(tf.precoder.to_numpy(), jf.precoder.to_numpy())


@pytest.mark.parametrize("update_mode", ["static", "adaptive"])
def test_link_feedback_is_generate_feedbacks_pmi_and_precoder(update_mode, rng):
    """The link asks only for the PMI and W: they equal what
    generate_feedback gives (W = MRT under "adaptive")."""
    link = tbf.BeamformingLink(LTEConfig(1.25), 4, 2, update_mode=update_mode, device="cpu")
    _, tH = _channels(rng, (5, 3), 2, 4)
    pmi, W = link.feedback(tH)
    fb = tcsi.generate_feedback(tH, 4)
    assert torch.equal(pmi, fb.pmi) and pmi.dtype == torch.int32
    want = fb.precoder if update_mode == "static" else tbfp.mrt_weights(tH)
    assert torch.equal(W.re, want.re) and torch.equal(W.im, want.im)


def test_pmi_statistics_match_jax(rng):
    for hist in (rng.integers(0, 16, 50), np.array([3, 1, 3, 1, 0]), np.array([7]),
                 rng.integers(0, 16, (4, 14))):
        j, t = jcsi.pmi_statistics(hist, 4), tcsi.pmi_statistics(torch.from_numpy(hist), 4)
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    assert tcsi.pmi_statistics([3, 1, 3, 1], 2)["most_common_pmi"] == 1      # ties: the lower
    assert tcsi.pmi_statistics([], 2) is None and jcsi.pmi_statistics([], 2) is None


def _normals(key, shape):
    kr, ki = jax.random.split(key)
    return (np.array(jax.random.normal(kr, shape, jnp.float32)),
            np.array(jax.random.normal(ki, shape, jnp.float32)))


def jax_draws(key, lanes, num_rx, num_tx, n_syms, S=None, nd=None):
    """What ofdm_lte_tpu/sim/beamforming.py draws from `key`, as the port's
    seams: the static sim's H and noise, or (S given) the time-varying
    sim's Jakes phases and noise."""
    kh, kn = jax.random.split(key)
    if S is None:
        return {"H": _normals(kh, lanes + (num_rx, num_tx)),
                "noise": _normals(kn, lanes + (num_rx, n_syms))}
    L = int(np.prod(lanes, dtype=int)) * num_rx * num_tx
    return {"phases": np.array(jax.random.uniform(kh, (16, L), jnp.float32, 0.0, 2 * np.pi)),
            "noise": _normals(kn, lanes + (S, num_rx, nd))}


def _bits(cfg, lanes, S, seed):
    n = tbf.bits_per_frame(cfg, S)
    return np.random.default_rng(seed).integers(0, 2, lanes + (n,)).astype(np.int32)


def _check(j, t, bits):
    mismatch = int(np.sum(t.bits_rx.numpy() != np.asarray(j.bits_rx)))
    assert mismatch <= MISMATCH_SHARE * bits.size, (mismatch, bits.size)
    assert t.bits_rx.shape == bits.shape and t.ber.shape == bits.shape[:-1]
    assert t.symbols_rx.shape == tuple(j.symbols_rx.shape)
    np.testing.assert_allclose(t.beamforming_gain_db.numpy(),
                               np.asarray(j.beamforming_gain_db), rtol=0, atol=GAIN_ATOL_DB)


@pytest.mark.parametrize("num_tx,num_rx,update_mode,modulation,snr", [
    (4, 2, "static", "64-QAM", 14.0),
    (2, 1, "adaptive", "16-QAM", [4.0, 9.0, 14.0]),
    (8, 4, "codebook", "QPSK", 0.0),
], ids=["4x2_codebook_64qam", "2x1_mrt_16qam_per_lane", "8x4_codebook_qpsk"])
def test_static_sim_matches_jax_under_its_draws(num_tx, num_rx, update_mode, modulation, snr):
    jc, tc = jcfg.LTEConfig(1.25, modulation=modulation), LTEConfig(1.25, modulation=modulation)
    lanes, S = (3,), 14
    bits = _bits(tc, lanes, S, 1)
    snr = np.asarray(snr, np.float32)
    key = jax.random.PRNGKey(5)
    j = jbf.simulate_beamforming(key, jnp.asarray(bits), jnp.asarray(snr), jc, num_tx=num_tx,
                                 num_rx=num_rx, update_mode=update_mode)
    draws = jax_draws(key, lanes, num_rx, num_tx, bits.shape[-1] // tc.bits_per_symbol)
    t = tbf.simulate_beamforming(torch.from_numpy(bits), torch.from_numpy(snr) if snr.ndim
                                 else float(snr), tc, num_tx=num_tx, num_rx=num_rx,
                                 update_mode=update_mode, device="cpu", draws=draws)
    _check(j, t, bits)
    np.testing.assert_array_equal(t.pmi.numpy(), np.asarray(j.pmi))
    assert 0.0 < float(np.mean(np.asarray(j.ber))) < 0.3     # noise enough to count
    np.testing.assert_allclose(t.symbols_rx.to_numpy(), np.asarray(j.symbols_rx.to_numpy()),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("num_tx,num_rx,update_mode,period,velocity", [
    (8, 1, "static", 4, 30.0),
    (4, 2, "adaptive", 3, 60.0),
    (2, 2, "static", 1, 300.0),
], ids=["8x1_codebook_p4", "4x2_mrt_p3", "2x2_codebook_p1"])
def test_time_varying_sim_matches_jax_under_its_draws(num_tx, num_rx, update_mode, period,
                                                      velocity):
    jc, tc = jcfg.LTEConfig(1.25, modulation="16-QAM"), LTEConfig(1.25, modulation="16-QAM")
    lanes, S = (2, 2), 14
    bits = _bits(tc, lanes, S, 2)
    fd = jcfg.doppler_hz(velocity, 2.0)
    snr = np.array([[6.0, 12.0], [18.0, 24.0]], np.float32)
    key = jax.random.PRNGKey(9)
    j = jbf.simulate_beamforming_time_varying(key, jnp.asarray(bits), jnp.asarray(snr), jc,
                                              num_tx=num_tx, num_rx=num_rx,
                                              update_mode=update_mode, update_period=period,
                                              doppler_hz=fd)
    nd = bits.shape[-1] // (S * tc.bits_per_symbol)
    draws = jax_draws(key, lanes, num_rx, num_tx, None, S, nd)
    t = tbf.simulate_beamforming_time_varying(
        torch.from_numpy(bits), torch.from_numpy(snr), tc, num_tx=num_tx, num_rx=num_rx,
        update_mode=update_mode, update_period=period, doppler_hz=fd, device="cpu", draws=draws)
    _check(j, t, bits)
    assert t.update_period == j.update_period == period
    np.testing.assert_array_equal(t.pmi_history.numpy(), np.asarray(j.pmi_history))
    np.testing.assert_allclose(t.gain_history_db.numpy(), np.asarray(j.gain_history_db),
                               rtol=0, atol=GAIN_ATOL_DB)
    # W is held between the update instants
    hist = t.pmi_history.numpy()
    for s in range(S):
        np.testing.assert_array_equal(hist[..., s], hist[..., (s // period) * period])


@pytest.mark.parametrize("channel_model", ["static", "jakes"])
def test_facade_keys_and_clean_link(channel_model):
    bits = np.random.default_rng(0).integers(0, 2, 1500)
    cfg = dict(bandwidth=1.25, modulation="16-QAM")
    j = japi.OFDMSimulator(jcfg.LTEConfig(**cfg), seed=0)
    t = OFDMSimulator(LTEConfig(**cfg), seed=0, device="cpu")
    kw = dict(num_tx=4, num_rx=2, velocity_kmh=30.0, update_mode="static",
              channel_model=channel_model)
    ref, out = j.simulate_beamforming(bits, 60.0, **kw), t.simulate_beamforming(bits, 60.0, **kw)
    assert set(out) == set(ref)
    for key in ("transmitted_bits", "received_bits", "num_tx", "num_rx", "mode",
                "codebook_type", "snr_db", "velocity_kmh"):
        assert out[key] == ref[key], key
    assert out["ber"] == ref["ber"] == 0.0 and out["bit_errors"] == 0
    np.testing.assert_array_equal(out["bits_received_array"], bits)
    assert len(out["pmi_history"]) == len(ref["pmi_history"])
    assert set(out["pmi_statistics"]) == set(ref["pmi_statistics"])
    assert out["pmi_statistics"]["total_feedbacks"] == len(out["pmi_history"])
    if channel_model == "jakes":
        assert out["update_period_symbols"] == ref["update_period_symbols"] == 4
        assert out["gain_history_db"].shape == ref["gain_history_db"].shape
    else:
        assert len(set(out["pmi_history"])) == out["unique_pmis"] == 1
    assert 0.0 < t.simulate_beamforming(bits, 0.0, **kw)["ber"] < 0.5
    assert t.last_results["snr_db"] == 0.0
    with pytest.raises(ValueError, match="channel_model"):
        t.simulate_beamforming(bits, 10.0, channel_model="nope")


def test_beamforming_sweep_equals_the_jax_sweep_on_one_device():
    """ber_sweep(pipeline="beamforming") against the JAX sweep on a
    one-device mesh, under that sweep's bits and per-lane draws: equal error
    counts, PAPR 0."""
    snrs, frames, S, num_tx, num_rx = [3.0, 10.0], 2, 14, 4, 2
    jc, tc = jcfg.LTEConfig(1.25, modulation="16-QAM"), LTEConfig(1.25, modulation="16-QAM")
    key = jax.random.PRNGKey(11)
    j = jsweep.ber_sweep(key, jc, snrs, frames_per_device=frames, num_ofdm_symbols=S,
                         mesh=jsweep.make_mesh(jax.devices()[:1]), pipeline="beamforming",
                         num_tx=num_tx, num_rx=num_rx)
    n_bits = tbf.bits_per_frame(tc, S)
    kb, kc = jax.random.split(jax.random.fold_in(key, 0))
    bits = np.array(jax.random.bernoulli(kb, 0.5, (len(snrs), frames, n_bits)), np.int8)
    per_lane = [jax_draws(k, (), num_rx, num_tx, n_bits // tc.bits_per_symbol)
                for k in jax.random.split(kc, len(snrs) * frames)]
    draws = {name: tuple(np.stack([d[name][i] for d in per_lane]) for i in (0, 1))
             for name in ("H", "noise")}
    t = ber_sweep(tc, snrs, frames=frames, num_ofdm_symbols=S, pipeline="beamforming",
                  num_tx=num_tx, num_rx=num_rx, device="cpu", bits=torch.from_numpy(bits),
                  seams={"draws": draws})
    assert t.total_bits.tolist() == np.asarray(j.total_bits).tolist()
    assert t.bit_errors.tolist() == np.asarray(j.bit_errors).tolist()
    assert t.bit_errors[0] > t.bit_errors[1]
    np.testing.assert_array_equal(t.papr_db, np.asarray(j.papr_db))
    assert t.papr_db.tolist() == [0.0, 0.0]


def test_sweep_on_its_own_generator_and_entry_points_resolve_the_device(monkeypatch):
    cfg = LTEConfig(1.25, modulation="QPSK")
    runs = [ber_sweep(cfg, [0.0, 60.0], frames=4, num_ofdm_symbols=14, pipeline="beamforming",
                      generator=torch.Generator().manual_seed(3), device="cpu")
            for _ in range(2)]
    assert runs[0].bit_errors.tolist() == runs[1].bit_errors.tolist()
    assert runs[0].bit_errors[0] > runs[0].bit_errors[1] == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bits = torch.zeros(tbf.bits_per_frame(cfg, 14), dtype=torch.int32)
    for call in (lambda: tbf.BeamformingLink(cfg),
                 lambda: tbf.simulate_beamforming(bits, 10.0, cfg),
                 lambda: tbf.simulate_beamforming_time_varying(bits, 10.0, cfg),
                 lambda: OFDMSimulator(cfg),
                 lambda: ber_sweep(cfg, [0.0], frames=1, pipeline="beamforming")):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    r = tbf.simulate_beamforming_time_varying(bits, 60.0, cfg, num_tx=4, update_period=3,
                                              doppler_hz=100.0, device="cpu")
    assert int(r.bit_errors) == 0 and r.pmi_history.shape == (14,)


def test_link_arguments_are_checked():
    with pytest.raises(ValueError, match="channel_model"):
        tbf.BeamformingLink(LTEConfig(1.25), channel_model="rayleigh_mp", device="cpu")
    with pytest.raises(ValueError, match="update_mode"):
        tbf.BeamformingLink(LTEConfig(1.25), update_mode="eigen", device="cpu")
    assert torch.equal(tbf.BeamformingLink(LTEConfig(1.25), 8, device="cpu").codebook_re,
                       tcplx.const(tcb.codebook(8, "TM6", 1)).re)
