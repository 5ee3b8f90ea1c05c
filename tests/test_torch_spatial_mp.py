"""The TM4 link over Jakes/ITU multipath against the JAX package under the
JAX package's own draws (see test_torch_spatial.py, whose helpers this file
uses): rank-4 SIC over Pedestrian_A, four links a receive antenna."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_spatial import check, run_both

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.sim import spatial as tsp

torch.set_num_threads(2)



def test_multipath_rank4_sic_same_draws_match_jax():
    kw = dict(num_tx=4, num_rx=4, rank=4, detector_type="SIC", channel_type="rayleigh_mp")
    j, t, bits = run_both(5.0, "16-QAM", 30.0, lanes=2, S=14, seed=4, **kw)
    check(j, t, bits, (0.0, 0.5))


def test_multipath_per_lane_snr_and_seams():
    """One SNR per lane over multipath, and the seams replace every draw:
    two runs with the same phases and noise give the same bits."""
    cfg = LTEConfig(1.25, modulation="QPSK")
    lanes, S = 3, 14
    link = tsp.SpatialLink(cfg, 2, 2, 2, "MMSE", device="cpu", channel_type="rayleigh_mp")
    assert link.channel_impl == "time" and link.profile is not None
    rng = np.random.default_rng(1)
    bits = torch.from_numpy(rng.integers(
        0, 2, (lanes, tsp.bits_per_frame(cfg, S))).astype(np.int32))
    n_pilot = link.demod_pilot_re.shape[1]
    draws = {"phases": rng.uniform(0, 2 * np.pi, (2 * 2 * lanes * link.profile.num_taps, 16)),
             "noise": tuple((rng.standard_normal(s), rng.standard_normal(s))
                            for s in ((2, lanes, S, link.m), (2, lanes, S, n_pilot)))}
    snr = torch.tensor([0.0, 15.0, 40.0])
    a, b = link(bits, snr, draws=draws), link(bits, snr, draws=draws)
    assert torch.equal(a.bits_rx, b.bits_rx)
    assert a.ber[0] > 0.02 and a.ber[0] > a.ber[1] >= a.ber[2]
    with pytest.raises(ValueError, match="phases"):
        link(bits, snr, draws={"phases": np.zeros((3, 16))})


def test_spatial_channel_functions_match_jax(rng):
    """spatial_mix_noiseless under the JAX package's own H (flat) and phases
    (multipath): the same mixed streams and the noise power P_rx/snr, not
    divided by num_tx; transmit_spatial_multiplexing adds noise of that
    power in the time domain."""
    import jax
    import jax.numpy as jnp
    from ofdm_lte_tpu import cplx as jcplx
    from ofdm_lte_tpu.channel import mimo as jmimo
    from ofdm_lte_tpu.channel import rayleigh as jray
    from ofdm_lte_tpu_torch import cplx as tcplx
    from ofdm_lte_tpu_torch.channel import mimo as tmimo
    from ofdm_lte_tpu_torch.channel import rayleigh as tray
    num_tx, num_rx, lanes, T = 3, 2, 2, 4000
    x = rng.standard_normal((num_tx, lanes, T)) + 1j * rng.standard_normal((num_tx, lanes, T))
    snr = np.array([5.0, 15.0], np.float32)
    key = jax.random.PRNGKey(8)
    kr, ki = jax.random.split(key)
    fading = tuple(np.array(jax.random.normal(k, (lanes, num_rx, num_tx), jnp.float32))
                   for k in (kr, ki))
    jy, jH, jn = jmimo.spatial_mix_noiseless(key, jcplx.from_numpy(x), jnp.asarray(snr), num_rx,
                                             "awgn")
    ty, tH, tn = tmimo.spatial_mix_noiseless(tcplx.from_numpy(x), snr, num_rx, "awgn",
                                             fading=fading)
    np.testing.assert_allclose(ty.to_numpy(), jy.to_numpy(), atol=1e-5)
    np.testing.assert_allclose(tH.to_numpy(), jH.to_numpy(), atol=1e-7)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    # multipath: phases in (rx, tx, lane, tap) order
    jp = jray.make_profile("Pedestrian_A", 7.68e6, 3.0, 2.0)
    tp = tray.make_profile("Pedestrian_A", 7.68e6, 3.0, 2.0)
    phases = np.stack([np.array(jax.random.uniform(kk, (lanes * jp.num_taps, 16), jnp.float32,
                                                   0.0, 2.0 * np.pi))
                       for k in jax.random.split(key, num_rx)
                       for kk in jax.random.split(k, num_tx)]).reshape(-1, 16)
    jy, _, jn = jmimo.spatial_mix_noiseless(key, jcplx.from_numpy(x), jnp.asarray(snr), num_rx,
                                            "rayleigh_mp", jp)
    ty, tH, tn = tmimo.spatial_mix_noiseless(tcplx.from_numpy(x), snr, num_rx, "rayleigh_mp",
                                             tp, phases=phases)
    np.testing.assert_allclose(ty.to_numpy(), jy.to_numpy(), atol=2e-4)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-4)
    assert tH.shape == (lanes, num_rx, num_tx) and float(tH.re.min()) == 1.0
    # noise in the time domain: measured power equals P_rx/snr per RX and lane
    y0, _, npow = tmimo.spatial_mix_noiseless(tcplx.from_numpy(x), snr, num_rx, "awgn",
                                              fading=fading)
    y, _ = tmimo.transmit_spatial_multiplexing(
        tcplx.from_numpy(x), snr, num_rx, "awgn", fading=fading,
        generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose((y - y0).abs2().mean(dim=-1).numpy(), npow.numpy(), rtol=0.1)
