"""The diversity links against the JAX package: Alamouti, per-TX estimation,
MRC and link mixing exact under the same inputs; SFBC and SIMO decisions
under the same draws; array and diversity gains as tests/test_diversity.py
states them, on the port's own generator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.channel import mimo as jmimo
from ofdm_lte_tpu.cplx import C as JC
from ofdm_lte_tpu.grid import grid_for
from ofdm_lte_tpu.ops import ofdm as jofdm
from ofdm_lte_tpu.ops import qam as jqam
from ofdm_lte_tpu.rx import alamouti as jala
from ofdm_lte_tpu.rx import estimation as jest
from ofdm_lte_tpu.rx import mimo_estimation as jmest
from ofdm_lte_tpu.sim import diversity as jdiv
from ofdm_lte_tpu.sim import siso as jsiso

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.channel import mimo as tmimo
from ofdm_lte_tpu_torch.rx import alamouti as tala
from ofdm_lte_tpu_torch.rx import estimation as test_
from ofdm_lte_tpu_torch.rx import mimo_estimation as tmest
from ofdm_lte_tpu_torch.sim import diversity as tdiv
from ofdm_lte_tpu_torch.sim import siso as tsiso

torch.set_num_threads(2)


def _pair(rng, shape):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return jcplx.from_numpy(x), tcplx.from_numpy(x)


def _close(t, j, atol=1e-5):
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(t.re.numpy(), np.asarray(j.re), rtol=0, atol=atol)
    np.testing.assert_allclose(t.im.numpy(), np.asarray(j.im), rtol=0, atol=atol)


def _cfgs(bw, modulation):
    return jcfg.LTEConfig(bw, modulation=modulation), LTEConfig(bw, modulation=modulation)


def test_alamouti_encode_decode_match_jax(rng):
    js, ts = _pair(rng, (2, 3, 32))
    for t, j in zip(tala.encode(ts), jala.encode(js)):
        _close(t, j, 0)
    jr, tr = _pair(rng, (2, 3, 32))
    jh0, th0 = _pair(rng, (2, 3, 32))
    jh1, th1 = _pair(rng, (2, 3, 32))
    _close(tala.decode(tr, th0, th1), jala.decode(jr, jh0, jh1), 1e-4)
    # flat channel: decode(h0·tx0 + h1·tx1) == s
    tx0, tx1 = tala.encode(ts)
    h0, h1 = 0.3 - 0.8j, -0.6 + 0.2j
    r = tcplx.from_numpy(tx0.to_numpy() * h0 + tx1.to_numpy() * h1)
    dec = tala.decode(r, tcplx.from_numpy(np.full((2, 3, 32), h0)),
                      tcplx.from_numpy(np.full((2, 3, 32), h1)))
    np.testing.assert_allclose(dec.to_numpy(), ts.to_numpy(), atol=1e-4)


@pytest.mark.parametrize("bw", [1.25, 5.0])
def test_estimate_per_tx_two_tx_matches_jax(bw, rng):
    jc, tc = jcfg.LTEConfig(bw), LTEConfig(bw)
    g = grid_for(jc)
    dbins = jdiv.sfbc_data_bins(jc)
    jp, tp = _pair(rng, (2, 3, 2, g.num_pilot))
    j = jmest.estimate_per_tx(jp, jc, 2, dbins)
    _close(tmest.estimate_per_tx(tp, tc, 2, dbins), j)
    tables = tmest.per_tx_tables(tc, 2, dbins, device="cpu")
    _close(tmest.estimate_per_tx(tp, tc, 2, dbins, tables=tables), j)
    assert j.shape == (2, 3, 2, 2, len(dbins))
    j8 = jmest.estimate_per_tx(jp, jc, 8, dbins, layout="extended")
    _close(tmest.estimate_per_tx(tp, tc, 8, dbins, layout="extended"), j8, 1e-4)
    with pytest.raises(ValueError):
        tmest.estimate_per_tx(tp, tc, 2, dbins, layout="nope")


def test_interpolate_with_pilot_subset_matches_jax(rng):
    jc, tc = jcfg.LTEConfig(2.5), LTEConfig(2.5)
    g = grid_for(jc)
    idx = g.pilot_idx[1::4]
    jh, th = _pair(rng, (3, len(idx)))
    _close(test_.interpolate(th, tc, out_bins=g.data_idx, pilot_idx=idx),
           jest.interpolate(jh, jc, out_bins=g.data_idx, pilot_idx=idx))
    _close(test_.interpolate(th, tc, pilot_idx=idx), jest.interpolate(jh, jc, pilot_idx=idx))


@pytest.mark.parametrize("axis", [0, 1])
def test_mrc_combine_matches_jax(axis, rng):
    jy, ty = _pair(rng, (4, 3, 5, 24))
    jh, th = _pair(rng, (4, 3, 5, 24))
    _close(test_.mrc_combine(ty, th, antenna_axis=axis),
           jest.mrc_combine(jy, jh, antenna_axis=axis))


def test_mix_links_matches_jax(rng):
    jx, tx = _pair(rng, (2, 3, 50))                 # (tx, lanes, T)
    jH, tH = _pair(rng, (4, 2))                     # constant (rx, tx)
    _close(tmimo._mix_links(tH, tx, 4), jmimo._mix_links(jH, jx, 4))
    jH, tH = _pair(rng, (3, 4, 2))                  # per-lane (lanes, rx, tx)
    _close(tmimo._mix_links(tH, tx, 4), jmimo._mix_links(jH, jx, 4))


@pytest.mark.parametrize("num_rx", [1, 2])
def test_mimo_mix_noiseless_awgn_matches_jax(num_rx, rng):
    jx, tx = _pair(rng, (2, 3, 200))
    snr = np.array([5.0, 10.0, 15.0], np.float32)
    jy, jH, jn = jmimo.mimo_mix_noiseless(jax.random.PRNGKey(0), jx, jnp.asarray(snr),
                                          num_rx, "awgn")
    ty, tH, tn = tmimo.mimo_mix_noiseless(tx, snr, num_rx, "awgn")
    _close(ty, jy)
    _close(tH, jH, 1e-7)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    assert tn.shape == (num_rx, 3)
    with pytest.raises(ValueError):
        tmimo.mimo_mix_noiseless(tx, 10.0, num_rx, "fading")


def test_transmit_mimo_and_simo_noise_power(rng):
    """Per-RX noise power (P_rx/num_tx)/snr, one SNR per lane."""
    _, tx = _pair(rng, (2, 2, 40_000))
    gen = torch.Generator()
    gen.manual_seed(0)
    snr = np.array([0.0, 10.0], np.float32)
    y0, _, npow = tmimo.mimo_mix_noiseless(tx, snr, 2, "awgn")
    y, H = tmimo.transmit_mimo(tx, snr, 2, "awgn", generator=gen)
    measured = (y - y0).abs2().mean(dim=-1)
    np.testing.assert_allclose(measured.numpy(), npow.numpy(), rtol=0.05)
    assert H.shape == (2, 2)
    sig = tx[0]
    ys = tmimo.transmit_simo(sig, snr, 3, "awgn", generator=gen)
    want = sig.abs2().mean(dim=-1) / torch.tensor([1.0, 10.0])
    got = (ys - sig).abs2().mean(dim=-1)
    assert ys.shape == (3, 2, 40_000)
    np.testing.assert_allclose(got.numpy(), want.expand(3, 2).numpy(), rtol=0.05)


@pytest.mark.parametrize("bw,modulation", [(1.25, "QPSK"), (5.0, "16-QAM")])
def test_sfbc_transmit_matches_jax(bw, modulation, rng):
    jc, tc = _cfgs(bw, modulation)
    assert tdiv.sfbc_bits_per_frame(tc, 3) == jdiv.sfbc_bits_per_frame(jc, 3)
    np.testing.assert_array_equal(tdiv.sfbc_data_bins(tc), jdiv.sfbc_data_bins(jc))
    bits = rng.integers(0, 2, (2, jdiv.sfbc_bits_per_frame(jc, 3))).astype(np.int32)
    j = jdiv.sfbc_transmit(jnp.asarray(bits), jc)
    t = tdiv.sfbc_transmit(torch.from_numpy(bits), tc)
    _close(t, j, 1e-4)
    assert t.shape == (2, 2, 3 * tc.samples_per_ofdm_symbol)


def test_sfbc_even_data_bins():
    assert len(tdiv.sfbc_data_bins(LTEConfig(20.0))) == 998


def _jax_sfbc_same_noise(bits, snr_db, cfg, num_rx, noise):
    """The JAX package's own stages with the given standard normals added at
    the bins, scaled as in sim/diversity.py:_add_cn."""
    signals = jdiv.sfbc_transmit(jnp.asarray(bits), cfg)
    y, _, npow = jmimo.mimo_mix_noiseless(jax.random.PRNGKey(0), signals, snr_db,
                                          num_rx, "awgn")
    g = grid_for(cfg)
    dbins = jdiv.sfbc_data_bins(cfg)
    yf = jofdm.frame_stream(y, cfg)
    S = yf.shape[-2]
    std = jnp.sqrt(npow[..., None, None] / 2.0)
    y_data = jofdm.demodulate_bins(yf, cfg, dbins)
    y_pil = jofdm.demodulate_bins(yf[..., jest.slot_start_indices(S), :], cfg, g.pilot_idx)
    (dr, di), (pr, pi) = noise
    y_data = JC(y_data.re + jnp.asarray(dr, jnp.float32) * std,
                y_data.im + jnp.asarray(di, jnp.float32) * std)
    y_pil = JC(y_pil.re + jnp.asarray(pr, jnp.float32) * std,
               y_pil.im + jnp.asarray(pi, jnp.float32) * std)
    h_tx = jmest.estimate_per_tx(y_pil, cfg, num_tx=2, out_bins=dbins)
    h_tx = jest.slot_periodic(h_tx.reshape(h_tx.shape[:-2] + (-1,)), S)
    h_tx = h_tx.reshape(h_tx.shape[:-1] + (2, len(dbins)))
    decoded = jala.decode(y_data, h_tx[..., 0, :], h_tx[..., 1, :]).mean(axis=0)
    flat = jqam.detect(decoded, cfg.modulation).reshape(decoded.shape[:-2] + (-1,))
    return jqam.demodulate(flat, cfg.modulation), decoded


@pytest.mark.parametrize("num_rx", [1, 2])
def test_sfbc_same_noise_matches_jax(num_rx, rng):
    jc, tc = _cfgs(5.0, "16-QAM")
    lanes, symbols = 3, 28
    g = grid_for(jc)
    n_even = len(jdiv.sfbc_data_bins(jc))
    bits = rng.integers(0, 2, (lanes, jdiv.sfbc_bits_per_frame(jc, symbols))).astype(np.int32)
    noise = tuple((rng.standard_normal(s), rng.standard_normal(s))
                  for s in ((num_rx, lanes, symbols, n_even), (num_rx, lanes, 2, g.num_pilot)))
    j_bits, j_dec = _jax_sfbc_same_noise(bits, 12.0, jc, num_rx, noise)
    r = tdiv.simulate_sfbc(torch.from_numpy(bits), 12.0, tc, num_rx=num_rx, device="cpu",
                           draws={"noise": noise})
    mismatch = int(np.sum(r.bits_rx.numpy() != np.asarray(j_bits)))
    assert mismatch <= 1e-4 * bits.size, mismatch
    _close(r.symbols_rx, j_dec, 1e-3)
    assert 0.0 < r.ber.mean().item() < 0.1
    # without noise the receivers agree on the decoded symbols too
    y = jmimo.mimo_mix_noiseless(jax.random.PRNGKey(0), jdiv.sfbc_transmit(
        jnp.asarray(bits), jc), 12.0, num_rx, "awgn")[0]
    _close(tdiv.sfbc_receive(tcplx.from_numpy(y.to_numpy()), tc), jdiv.sfbc_receive(y, jc), 1e-3)


def test_simo_same_received_streams_match_jax(rng):
    """Both MRC receivers get the same two noisy legs."""
    jc, tc = _cfgs(5.0, "16-QAM")
    g = grid_for(jc)
    lanes, symbols, num_rx = 3, 28, 2
    bits = rng.integers(0, 2, (lanes, jsiso.bits_per_frame(jc, symbols))).astype(np.int32)
    tx = jsiso.transmit(jnp.asarray(bits), jc).to_numpy()
    h = rng.standard_normal((num_rx, 1, 1)) + 1j * rng.standard_normal((num_rx, 1, 1))
    sigma = np.sqrt(np.mean(np.abs(tx) ** 2) / 10 ** 1.2 / 2)
    shape = (num_rx,) + tx.shape
    y = h * tx + sigma * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))

    jy = jcplx.from_numpy(y)
    yf = jofdm.frame_stream(jy, jc)
    y_data = jofdm.demodulate_bins(yf, jc, g.data_idx)
    y_pil = jofdm.demodulate_bins(yf[..., jest.slot_start_indices(symbols), :], jc, g.pilot_idx)
    h_data = jest.slot_periodic(jest.interpolate(jest.ls_at_pilots(y_pil), jc,
                                                 out_bins=g.data_idx), symbols)
    j_comb = jest.mrc_combine(y_data, h_data, antenna_axis=0)
    j_bits = jqam.demodulate(j_comb.reshape((lanes, -1)), jc.modulation)

    link = tdiv.SimoLink(tc, num_rx, device="cpu")
    for tables in (None, link.siso.rx_tables):
        t_comb = tdiv.simo_receive(tcplx.from_numpy(y), tc, tables)
        _close(t_comb, j_comb, 1e-3)
        t_bits = tdiv._result(t_comb, torch.from_numpy(bits), None, tc).bits_rx
        mismatch = int(np.sum(t_bits.numpy() != np.asarray(j_bits)))
        assert mismatch <= 1e-4 * bits.size, mismatch
    assert 0.0 < np.mean(t_bits.numpy() != bits) < 0.1


def _port_ber(fn, cfg, n_bits, snr_db, seeds=3, **kw):
    e = t = 0
    for s in range(seeds):
        bits = np.random.default_rng(s).integers(0, 2, n_bits).astype(np.int32)
        gen = torch.Generator()
        gen.manual_seed(s)
        r = fn(torch.from_numpy(bits), snr_db, cfg, generator=gen, device="cpu", **kw)
        e += int(r.bit_errors)
        t += n_bits
    return e / t


def test_simo_mrc_array_gain_awgn():
    """MRC of N noisy copies: ~10·log10(N) SNR gain -> lower BER."""
    cfg = LTEConfig(5.0, modulation="QPSK")
    n = tsiso.bits_per_frame(cfg, 28)
    errs = {n_rx: _port_ber(tdiv.simulate_simo, cfg, n, 4.0, num_rx=n_rx) for n_rx in (1, 4)}
    assert errs[4] < errs[1] / 8, errs


def test_simo_two_rx_ber_within_mc_bounds_of_jax(rng):
    jc, tc = _cfgs(5.0, "QPSK")
    bits = rng.integers(0, 2, (4, jsiso.bits_per_frame(jc, 28))).astype(np.int32)
    j = jdiv.simulate_simo(jax.random.PRNGKey(0), jnp.asarray(bits), 2.0, jc, num_rx=2)
    gen = torch.Generator()
    gen.manual_seed(0)
    t = tdiv.simulate_simo(torch.from_numpy(bits), 2.0, tc, num_rx=2, generator=gen,
                           device="cpu")
    p, q = float(np.mean(np.asarray(j.ber))), t.ber.mean().item()
    sigma = np.sqrt(2 * p * (1 - p) / bits.size)
    assert abs(q - p) <= 4 * sigma, (q, p, sigma)
    assert 0.003 < q < 0.05
    np.testing.assert_allclose(t.papr_db.numpy(), np.asarray(j.papr_db), atol=1e-3)


def test_simo_rayleigh_diversity():
    """1→4 RX improves the Rayleigh BER by at least 5×."""
    cfg = LTEConfig(5.0, modulation="QPSK")
    n = tsiso.bits_per_frame(cfg, 28)
    kw = dict(channel_type="rayleigh_mp", itu_profile="Pedestrian_A", velocity_kmh=3.0)
    errs = {n_rx: _port_ber(tdiv.simulate_simo, cfg, n, 12.0, num_rx=n_rx, **kw)
            for n_rx in (1, 4)}
    assert errs[4] < errs[1] / 5, errs


def test_mimo_rx_diversity_beats_miso():
    cfg = LTEConfig(5.0, modulation="16-QAM")
    n = tdiv.sfbc_bits_per_frame(cfg, 28)
    e1 = _port_ber(tdiv.simulate_miso, cfg, n, 10.0)
    e2 = _port_ber(tdiv.simulate_mimo, cfg, n, 10.0, num_rx=2)
    assert e2 < e1, (e1, e2)


@pytest.mark.parametrize("link", ["simo", "miso", "mimo", "simo_mp"])
def test_diversity_clean_at_60_db(link, rng):
    cfg = LTEConfig(1.25, modulation="16-QAM")
    sfbc = link in ("miso", "mimo")
    n = tdiv.sfbc_bits_per_frame(cfg, 14) if sfbc else tsiso.bits_per_frame(cfg, 14)
    bits = torch.from_numpy(rng.integers(0, 2, (2, n)).astype(np.int8))
    fn = {"simo": tdiv.simulate_simo, "miso": tdiv.simulate_miso, "mimo": tdiv.simulate_mimo,
          "simo_mp": tdiv.simulate_simo}[link]
    kw = {"channel_type": "rayleigh_mp"} if link == "simo_mp" else {}
    r = fn(bits, 60.0, cfg, generator=torch.Generator().manual_seed(1), device="cpu", **kw)
    assert int(r.bit_errors.sum()) == 0 and r.bits_rx.dtype == torch.int8
    assert r.ber.shape == (2,) and r.papr_db.shape == (2,)
    assert torch.isfinite(r.papr_db).all()


def test_sfbc_rayleigh_runs_and_link_keeps_its_tables(rng):
    cfg = LTEConfig(5.0, modulation="QPSK")
    link = tdiv.SfbcLink(cfg, 2, device="cpu", channel_type="rayleigh_mp",
                         itu_profile="Pedestrian_A", velocity_kmh=3.0)
    bits = torch.from_numpy(rng.integers(
        0, 2, tdiv.sfbc_bits_per_frame(cfg, 28)).astype(np.int32))
    r = link(bits, 15.0, generator=torch.Generator().manual_seed(0))
    assert 0.0 <= float(r.ber) < 0.5
    assert all(b.is_contiguous() for b in link.buffers())
    assert link.mod_b_re.shape == (len(tdiv.sfbc_data_bins(cfg)), cfg.samples_per_ofdm_symbol)
    assert link.pilot_wave_re.shape == (2, cfg.samples_per_ofdm_symbol)
    with pytest.raises(ValueError):
        tdiv.SfbcLink(cfg, 2, device="cpu", channel_type="fading")
