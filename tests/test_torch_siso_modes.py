"""The SISO link's other branches against the JAX package: SC-FDM and simple
transmitters, the time-domain receiver in every form given the same
received stream, SC-FDM over AWGN through the bin seam, BER over the fading
channels within Monte-Carlo bounds, and clean links at 60 dB."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.cplx import C as JC
from ofdm_lte_tpu.grid import grid_for
from ofdm_lte_tpu.ops import ofdm as jofdm
from ofdm_lte_tpu.rx import estimation as jest
from ofdm_lte_tpu.sim import siso as jsiso

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.sim import siso as tsiso

torch.set_num_threads(2)

RX_FORMS = [("lte", True), ("lte", False), ("sc-fdm", True), ("sc-fdm", False),
            ("simple", True)]


def _cfgs(bw, modulation):
    return jcfg.LTEConfig(bw, modulation=modulation), LTEConfig(bw, modulation=modulation)


def _bits(rng, cfg, lanes, symbols, mode="lte"):
    return rng.integers(0, 2, (lanes, jsiso.bits_per_frame(cfg, symbols, mode))).astype(np.int32)


@pytest.mark.parametrize("mode", ["sc-fdm", "simple"])
def test_transmit_modes_match_jax(mode, rng):
    jc, tc = _cfgs(5.0, "16-QAM")
    bits = _bits(rng, jc, 2, 3, mode)
    j = jsiso.transmit(jnp.asarray(bits), jc, mode)
    t = tsiso.transmit(torch.from_numpy(bits), tc, mode)
    assert t.shape == (2, 3 * tc.samples_per_ofdm_symbol)
    np.testing.assert_allclose(t.re.numpy(), np.asarray(j.re), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.im.numpy(), np.asarray(j.im), rtol=0, atol=1e-4)
    # the link's buffers give what the functional form gives
    t2 = tsiso.SisoLink(tc, device="cpu", mode=mode).transmit(torch.from_numpy(bits))
    assert torch.equal(t2.re, t.re) and torch.equal(t2.im, t.im)


@pytest.mark.parametrize("mode,equalize", RX_FORMS)
def test_receive_same_stream_matches_jax(mode, equalize, rng):
    """Both receivers get one received stream (the JAX transmitter's plus
    NumPy noise at 22 dB), so only fp32 summation order differs: at most
    1e-4 of the decisions may."""
    jc, tc = _cfgs(5.0, "16-QAM")
    lanes, symbols = 3, 28
    bits = _bits(rng, jc, lanes, symbols, mode)
    tx = jsiso.transmit(jnp.asarray(bits), jc, mode).to_numpy()
    sigma = np.sqrt(np.mean(np.abs(tx) ** 2) / 10 ** 2.2 / 2)
    rx = tx + sigma * (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
    j_bits, j_x, j_psnr = jsiso.receive(jcplx.from_numpy(rx), jc, mode,
                                        enable_equalization=equalize)
    link = tsiso.SisoLink(tc, device="cpu", mode=mode, enable_equalization=equalize)
    for tables in (None, link.rx_tables):
        t_bits, t_x, t_psnr = tsiso.receive(tcplx.from_numpy(rx), tc, mode,
                                            enable_equalization=equalize, tables=tables)
        mismatch = int(np.sum(t_bits.numpy() != np.asarray(j_bits)))
        assert mismatch <= 1e-4 * bits.size, mismatch
        np.testing.assert_allclose(t_x.re.numpy(), np.asarray(j_x.re), atol=1e-3)
        np.testing.assert_allclose(t_psnr.numpy(), np.asarray(j_psnr), atol=1e-3)
    errors = int(np.sum(t_bits.numpy() != bits))
    assert errors < 0.05 * bits.size
    assert t_psnr.shape == (lanes,)


def test_scfdm_same_bin_noise_matches_jax(rng):
    jc, tc = _cfgs(5.0, "16-QAM")
    lanes, symbols = 3, 28
    g = grid_for(jc)
    bits = _bits(rng, jc, lanes, symbols)
    noise = tuple((rng.standard_normal(s), rng.standard_normal(s))
                  for s in ((lanes, symbols, g.num_data), (lanes, 2, g.num_pilot)))
    sig = jsiso.transmit(jnp.asarray(bits), jc, "sc-fdm")
    std = jnp.sqrt((jnp.mean(sig.abs2(), axis=-1) / 10 ** 1.6)[..., None, None] / 2.0)
    y = jofdm.frame_stream(sig, jc)
    y_data = jofdm.demodulate_bins(y, jc, g.data_idx)
    y_pil = jofdm.demodulate_bins(y[..., jest.slot_start_indices(symbols), :], jc, g.pilot_idx)
    (dr, di), (pr, pi) = noise
    j_bits, j_x, _ = jsiso._detect_from_bins(
        JC(y_data.re + jnp.asarray(dr, jnp.float32) * std,
           y_data.im + jnp.asarray(di, jnp.float32) * std),
        JC(y_pil.re + jnp.asarray(pr, jnp.float32) * std,
           y_pil.im + jnp.asarray(pi, jnp.float32) * std), jc, "sc-fdm")
    r = tsiso.simulate_siso(torch.from_numpy(bits), 16.0, tc, noise=noise, mode="sc-fdm",
                            device="cpu")
    mismatch = int(np.sum(r.bits_rx.numpy() != np.asarray(j_bits)))
    assert mismatch <= 1e-4 * bits.size, mismatch
    np.testing.assert_allclose(r.symbols_rx.re.numpy(), np.asarray(j_x.re), atol=1e-3)
    assert 0.0 < r.ber.mean().item() < 0.05
    # SC-FDM's PAPR lies below OFDM's on the same bits
    ofdm_papr = tsiso.simulate_siso(torch.from_numpy(bits), 60.0, tc, device="cpu").papr_db
    assert r.papr_db.mean() < ofdm_papr.mean()


@pytest.mark.parametrize("channel_type,snr_db", [("rayleigh_mp", 15.0), ("fading", 20.0)])
def test_fading_ber_within_mc_bounds(channel_type, snr_db, rng):
    """Each package draws its own channel; the lanes fade independently, so
    the spread of the per-lane BER gives σ of each mean. 4σ."""
    jc, tc = _cfgs(1.25, "QPSK")
    lanes = 96
    bits = _bits(rng, jc, lanes, 14)
    j = jsiso.simulate_siso(jax.random.PRNGKey(1), jnp.asarray(bits), snr_db, jc,
                            channel_type=channel_type, itu_profile="Pedestrian_A")
    gen = torch.Generator()
    gen.manual_seed(1)
    t = tsiso.simulate_siso(torch.from_numpy(bits), snr_db, tc, generator=gen, device="cpu",
                            channel_type=channel_type, itu_profile="Pedestrian_A")
    jb, tb = np.asarray(j.ber, np.float64), t.ber.double().numpy()
    sigma = np.sqrt(jb.var(ddof=1) / lanes + tb.var(ddof=1) / lanes)
    assert abs(tb.mean() - jb.mean()) <= 4 * sigma, (tb.mean(), jb.mean(), sigma)
    assert 0.0 < tb.mean() < 0.6


def test_fading_link_same_draws_matches_jax(rng):
    """The whole link over flat fading with the JAX package's own draws fed
    to the port's seams: the BER is 0.5 in both (per-sample fading leaves
    nothing to equalize), so only equal decisions say that the channel and
    the receiver behind it are the same. At most 1e-4 of the bits differ."""
    jc, tc = _cfgs(5.0, "16-QAM")
    lanes, symbols = 3, 28
    bits = _bits(rng, jc, lanes, symbols)
    key = jax.random.PRNGKey(8)
    shape = (lanes, symbols * jc.samples_per_ofdm_symbol)
    fading, noise = (tuple(np.array(jax.random.normal(k, shape, jnp.float32))
                           for k in jax.random.split(kk)) for kk in jax.random.split(key))
    j = jsiso.simulate_siso(key, jnp.asarray(bits), 20.0, jc, channel_type="fading")
    t = tsiso.simulate_siso(torch.from_numpy(bits), 20.0, tc, device="cpu",
                            channel_type="fading", draws={"fading": fading, "noise": noise})
    mismatch = int(np.sum(t.bits_rx.numpy() != np.asarray(j.bits_rx)))
    assert mismatch <= 1e-4 * bits.size, mismatch
    assert 0.4 < t.ber.mean().item() < 0.6


@pytest.mark.parametrize("mode,channel_type,equalize", [
    ("sc-fdm", "awgn", True), ("sc-fdm", "awgn", False), ("simple", "awgn", True),
    ("lte", "awgn", False), ("lte", "rayleigh_mp", True), ("sc-fdm", "rayleigh_mp", True)])
def test_clean_at_60_db(mode, channel_type, equalize, rng):
    cfg = LTEConfig(1.25, modulation="QPSK")
    bits = torch.from_numpy(_bits(rng, cfg, 2, 14, mode))
    gen = torch.Generator()
    gen.manual_seed(3)
    r = tsiso.simulate_siso(bits, 60.0, cfg, generator=gen, device="cpu", mode=mode,
                            channel_type=channel_type, enable_equalization=equalize)
    assert int(r.bit_errors.sum()) == 0
    assert r.bits_rx.shape == bits.shape and torch.isfinite(r.papr_db).all()
    assert r.symbols_rx.shape[-1] == (cfg.Nc if mode == "simple" else grid_for(cfg).num_data)


def test_time_domain_draws_seam_is_reproducible(rng):
    """The same phases and noise give the same bits, whatever the generator."""
    cfg = LTEConfig(1.25, modulation="QPSK")
    link = tsiso.SisoLink(cfg, device="cpu", channel_type="rayleigh_mp",
                          itu_profile="Vehicular_A")
    bits = torch.from_numpy(_bits(rng, cfg, 2, 14))
    T = 14 * cfg.samples_per_ofdm_symbol
    draws = {"phases": rng.uniform(0, 2 * np.pi, (2 * link.profile.num_taps, 16)),
             "noise": (rng.standard_normal((2, T)), rng.standard_normal((2, T)))}
    a = link(bits, 25.0, draws=draws)
    b = link(bits, 25.0, generator=torch.Generator().manual_seed(7), draws=draws)
    assert torch.equal(a.bits_rx, b.bits_rx) and link.profile.num_taps == 6
    with pytest.raises(ValueError):
        link(bits, 25.0, noise=draws["noise"])        # the bin-domain seam is not this link's
