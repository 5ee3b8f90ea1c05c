"""The whole SISO slice against the JAX package: TX waveform, the receiver
under the same injected noise, BER under each package's own generator, and
the facade."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu.api import OFDMModule as JModule
from ofdm_lte_tpu.cplx import C as JC
from ofdm_lte_tpu.grid import grid_for
from ofdm_lte_tpu.ops import ofdm as jofdm
from ofdm_lte_tpu.rx import estimation as jest
from ofdm_lte_tpu.sim import siso as jsiso

from ofdm_lte_tpu_torch import LTEConfig, OFDMModule
from ofdm_lte_tpu_torch.sim import siso as tsiso

torch.set_num_threads(2)


def _bits(rng, cfg, lanes, symbols):
    return rng.integers(0, 2, (lanes, jsiso.bits_per_frame(cfg, symbols))).astype(np.int32)


@pytest.mark.parametrize("bw,modulation", [(1.25, "QPSK"), (20.0, "64-QAM")])
def test_transmit_matches_jax(bw, modulation, rng):
    jc, tc = jcfg.LTEConfig(bw, modulation=modulation), LTEConfig(bw, modulation=modulation)
    bits = _bits(rng, jc, 2, 2)
    j = jsiso.transmit(jnp.asarray(bits), jc)
    t = tsiso.transmit(torch.from_numpy(bits), tc)
    assert t.shape == (2, 2 * tc.samples_per_ofdm_symbol)
    np.testing.assert_allclose(t.re.numpy(), np.asarray(j.re), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.im.numpy(), np.asarray(j.im), rtol=0, atol=1e-4)
    # the module's buffers give what the functional form gives
    t2 = tsiso.SisoLink(tc, device="cpu").transmit(torch.from_numpy(bits))
    assert torch.equal(t2.re, t.re) and torch.equal(t2.im, t.im)


def _jax_same_noise(bits, snr_db, cfg, noise):
    """The JAX package's own stages with the given standard normals added at
    the bins, scaled as in sim/siso.py:_receive_awgn_freq."""
    sig = jsiso.transmit(jnp.asarray(bits), cfg)
    snr_lin = 10.0 ** (jnp.asarray(snr_db, jnp.float32) / 10.0)
    n0 = (jnp.mean(sig.abs2(), axis=-1) / snr_lin)[..., None, None]
    std = jnp.sqrt(n0 / 2.0)
    g = grid_for(cfg)
    y = jofdm.frame_stream(sig, cfg)
    y_data = jofdm.demodulate_bins(y, cfg, g.data_idx)
    slots = jest.slot_start_indices(y.shape[-2])
    y_pil = jofdm.demodulate_bins(y[..., slots, :], cfg, g.pilot_idx)
    (dr, di), (pr, pi) = noise
    y_data = JC(y_data.re + jnp.asarray(dr, jnp.float32) * std,
                y_data.im + jnp.asarray(di, jnp.float32) * std)
    y_pil = JC(y_pil.re + jnp.asarray(pr, jnp.float32) * std,
               y_pil.im + jnp.asarray(pi, jnp.float32) * std)
    return jsiso._detect_from_bins(y_data, y_pil, cfg, "lte")


def _noise(rng, lanes, symbols, cfg):
    g = grid_for(cfg)
    n_slots = len(jest.slot_start_indices(symbols))
    return ((rng.standard_normal((lanes, symbols, g.num_data)),
             rng.standard_normal((lanes, symbols, g.num_data))),
            (rng.standard_normal((lanes, n_slots, g.num_pilot)),
             rng.standard_normal((lanes, n_slots, g.num_pilot))))


@pytest.mark.parametrize("snr_db", [20.0, 60.0])
def test_same_noise_matches_jax(snr_db, rng):
    """Only fp32 summation order differs, so at most 1e-4 of the decisions may."""
    jc, tc = jcfg.LTEConfig(5.0, modulation="64-QAM"), LTEConfig(5.0, modulation="64-QAM")
    lanes, symbols = 4, 28
    bits = _bits(rng, jc, lanes, symbols)
    noise = _noise(rng, lanes, symbols, jc)
    j_bits, j_xeq, j_psnr = _jax_same_noise(bits, snr_db, jc, noise)
    r = tsiso.simulate_siso(torch.from_numpy(bits), snr_db, tc, noise=noise)
    mismatch = int(np.sum(r.bits_rx.numpy() != np.asarray(j_bits)))
    assert mismatch <= 1e-4 * bits.size, mismatch
    np.testing.assert_allclose(r.pilot_snr_db.numpy(), np.asarray(j_psnr), atol=1e-3)
    np.testing.assert_allclose(r.symbols_rx.re.numpy(), np.asarray(j_xeq.re), atol=1e-3)
    j_errors = int(np.sum(np.asarray(j_bits) != bits))
    if snr_db == 60.0:
        assert j_errors == 0 and int(r.bit_errors.sum()) == 0
    else:
        assert abs(int(r.bit_errors.sum()) - j_errors) <= mismatch
        assert 0.005 < r.ber.mean().item() < 0.02


@pytest.mark.parametrize("modulation,snr_db", [("QPSK", 6.0), ("16-QAM", 14.0),
                                               ("64-QAM", 20.0)])
def test_ber_own_generator_within_mc_bounds(modulation, snr_db, rng):
    """BER at the validation anchors (5 MHz, 28 symbols) within 4σ of the
    JAX package's, each drawing its own noise."""
    jc, tc = jcfg.LTEConfig(5.0, modulation=modulation), LTEConfig(5.0, modulation=modulation)
    bits = _bits(rng, jc, 4, 28)
    j = jsiso.simulate_siso(jax.random.PRNGKey(0), jnp.asarray(bits), snr_db, jc)
    gen = torch.Generator()
    gen.manual_seed(0)
    t = tsiso.simulate_siso(torch.from_numpy(bits), snr_db, tc, generator=gen)
    p = float(np.mean(np.asarray(j.ber)))
    q = t.ber.mean().item()
    sigma = np.sqrt(2 * p * (1 - p) / bits.size)
    assert abs(q - p) <= 4 * sigma, (q, p, sigma)
    assert 0.003 < q < 0.03
    np.testing.assert_allclose(t.papr_db.numpy().mean(), np.asarray(j.papr_db).mean(), atol=1.0)


def test_link_is_reproducible_and_follows_bit_dtype(rng):
    cfg = LTEConfig(1.25, modulation="16-QAM")
    bits = torch.from_numpy(_bits(rng, cfg, 3, 14).astype(np.int8))
    link = tsiso.SisoLink(cfg, device="cpu")
    runs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(5)
        runs.append(link(bits, torch.tensor([10.0, 14.0, 18.0]), generator=gen))
    assert torch.equal(runs[0].bits_rx, runs[1].bits_rx)
    assert runs[0].bits_rx.dtype == torch.int8
    assert runs[0].ber.shape == (3,) and runs[0].ber.dtype == torch.float32
    assert runs[0].ber[0] > runs[0].ber[2]       # per-lane SNR broadcasts
    gen = torch.Generator()
    gen.manual_seed(5)
    f = tsiso.simulate_siso(bits, torch.tensor([10.0, 14.0, 18.0]), cfg, generator=gen)
    assert torch.equal(f.bits_rx, runs[0].bits_rx)


def test_unported_branches_raise(rng):
    cfg = LTEConfig(1.25)
    bits = torch.from_numpy(_bits(rng, cfg, 1, 14))
    for kw in ({"mode": "sc-fdm"}, {"mode": "simple"}, {"enable_equalization": False},
               {"channel_type": "fading"}, {"channel_type": "rayleigh_mp"}):
        with pytest.raises(NotImplementedError):
            tsiso.simulate_siso(bits, 10.0, cfg, **kw)
    with pytest.raises(ValueError):
        tsiso.simulate_siso(bits, 10.0, cfg, channel_type="nope")
    with pytest.raises(ValueError):
        tsiso.simulate_siso(bits, 10.0, cfg, noise=((np.zeros(3), np.zeros(3)),) * 2)


def test_pad_and_frame_helpers():
    jc, tc = jcfg.LTEConfig(5.0, modulation="16-QAM"), LTEConfig(5.0, modulation="16-QAM")
    assert tsiso.bits_per_frame(tc, 28) == jsiso.bits_per_frame(jc, 28)
    assert tsiso.num_symbols_for_bits(tc, 12345) == jsiso.num_symbols_for_bits(jc, 12345)
    bits = np.arange(1000) % 2
    np.testing.assert_array_equal(tsiso.pad_bits(bits, tc), jsiso.pad_bits(bits, jc))


def test_facade_keys_and_clean_link(rng):
    cfg_j = jcfg.LTEConfig(1.25, modulation="16-QAM")
    bits = rng.integers(0, 2, 1500)
    ref = JModule(cfg_j, seed=0).transmit(bits, 60.0)
    out = OFDMModule(LTEConfig(1.25, modulation="16-QAM"), seed=0, device="cpu").transmit(bits, 60.0)
    assert set(out) == set(ref)
    assert out["ber"] == ref["ber"] == 0.0
    assert out["bit_errors"] == 0 and out["transmitted_bits"] == 1500
    np.testing.assert_array_equal(out["bits_received_array"], bits)
    assert out["symbols_rx"].shape == ref["symbols_rx"].shape
    assert out["signal_tx"].shape == ref["signal_tx"].shape
    np.testing.assert_allclose(out["signal_tx"], ref["signal_tx"], atol=1e-4)
    assert abs(out["papr_db"] - ref["papr_db"]) < 1e-3
    assert out["evm_percent"] < 1.0 and abs(out["pilot_snr_db"] - ref["pilot_snr_db"]) < 3.0
