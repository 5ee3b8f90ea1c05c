"""The fading channels against the JAX package: profiles equal, the Jakes
taps, the multipath FIR and the responses under the same phases (drawn by
jax.random with the test's key and fed to the port's seam), and the Jakes
statistics of tests/test_channel_stats.py on the port's own generator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import j0

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.channel import rayleigh as jray

from ofdm_lte_tpu_torch import config as tcfg
from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.channel import rayleigh as tray

torch.set_num_threads(2)

FS = 5e4
FD = 200.0
T = 65536          # 1.31 s -> f_D·T ≈ 262 Doppler cycles


def _phases(key, L):
    """What jakes_taps(key, ...) draws for L = batch·taps rows."""
    return np.array(jax.random.uniform(key, (L, jray.N_SINUSOIDS), jnp.float32,
                                       0.0, 2.0 * np.pi))


def _close(t, j, atol):
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(t.re.numpy(), np.asarray(j.re), rtol=0, atol=atol)
    np.testing.assert_allclose(t.im.numpy(), np.asarray(j.im), rtol=0, atol=atol)


def test_itu_tables_equal():
    assert tcfg.ITU_CHANNEL_MODELS == jcfg.ITU_CHANNEL_MODELS
    assert tcfg.ITU_DEFAULT_VELOCITY_KMH == jcfg.ITU_DEFAULT_VELOCITY_KMH
    assert tcfg.doppler_hz(37.0, 2.6) == jcfg.doppler_hz(37.0, 2.6)


@pytest.mark.parametrize("convention", ["reference", "physical"])
@pytest.mark.parametrize("name", list(jcfg.ITU_CHANNEL_MODELS))
def test_make_profile_equal(name, convention):
    for fs, kw in ((7.68e6, {}), (30.72e6, {"velocity_kmh": 3.0, "frequency_ghz": 2.6}),
                   (FS, {"fd": FD})):
        j = jray.make_profile(name, fs, gain_convention=convention, **kw)
        t = tray.make_profile(name, fs, gain_convention=convention, **kw)
        assert tuple(t) == tuple(j) and t.num_taps == j.num_taps
    with pytest.raises(ValueError):
        tray.make_profile(name, FS, gain_convention="nope")


@pytest.mark.parametrize("stride", [1, 4])
def test_jakes_taps_same_phases_match_jax(stride):
    key = jax.random.PRNGKey(5)
    jp = jray.make_profile("Vehicular_A", 7.68e6, velocity_kmh=120.0)
    tp = tray.make_profile("Vehicular_A", 7.68e6, velocity_kmh=120.0)
    j = jray.jakes_taps(key, jp, 4096, (3, 2), sample_stride=stride)
    t = tray.jakes_taps(tp, 4096, (3, 2), sample_stride=stride, device="cpu",
                        phases=_phases(key, 3 * 2 * jp.num_taps))
    _close(t, j, 2e-5)
    with pytest.raises(ValueError):
        tray.jakes_taps(tp, 16, (3,), device="cpu", phases=np.zeros((3, 16)))


@pytest.mark.parametrize("hold", [1, 4, 7])
def test_apply_multipath_same_taps_match_jax(hold, rng):
    """hold 7 does not divide T = 1000 and is rounded down to 5 in both."""
    key = jax.random.PRNGKey(9)
    jp = jray.make_profile("Pedestrian_B", 7.68e6, velocity_kmh=50.0)
    tp = tray.make_profile("Pedestrian_B", 7.68e6, velocity_kmh=50.0)
    x = (rng.standard_normal((3, 1000)) + 1j * rng.standard_normal((3, 1000))) / np.sqrt(2)
    j = jray.apply_multipath(key, jcplx.from_numpy(x), jp, hold=hold)
    t = tray.apply_multipath(tcplx.from_numpy(x), tp, hold=hold,
                             phases=_phases(key, 3 * jp.num_taps))
    _close(t, j, 1e-5)


def test_apply_multipath_links_are_independent_legs(rng):
    tp = tray.make_profile("Pedestrian_A", 7.68e6, velocity_kmh=3.0)
    x = tcplx.from_numpy(rng.standard_normal((2, 600)) + 1j * rng.standard_normal((2, 600)))
    phi = rng.uniform(0, 2 * np.pi, (3 * 2 * tp.num_taps, 16)).astype(np.float32)
    y = tray.apply_multipath(x, tp, phases=phi, links=(3,))
    assert y.shape == (3, 2, 600)
    for leg in range(3):
        one = tray.apply_multipath(x, tp, phases=phi.reshape(3, -1, 16)[leg])
        _close(y[leg], one, 1e-6)


def test_responses_same_phases_match_jax():
    key = jax.random.PRNGKey(0)
    jp = jray.make_profile("Pedestrian_A", 7.68e6, velocity_kmh=3.0)
    tp = tray.make_profile("Pedestrian_A", 7.68e6, velocity_kmh=3.0)
    jd, jt = jray.impulse_response(key, jp)
    td, tt = tray.impulse_response(tp, device="cpu", phases=_phases(key, jp.num_taps))
    np.testing.assert_array_equal(td, jd)
    _close(tt, jt, 2e-5)
    f = np.linspace(0.0, 1e6, 64).astype(np.float32)
    jH = jray.frequency_response(jt, jp, jnp.asarray(f))
    tH = tray.frequency_response(tcplx.from_numpy(jt.to_numpy()), tp, torch.from_numpy(f))
    _close(tH, jH, 1e-4)


def test_flat_mimo_time_varying_same_phases_match_jax():
    key = jax.random.PRNGKey(3)
    phi = np.array(jax.random.uniform(key, (16, 5 * 2 * 3), jnp.float32, 0.0, 2.0 * np.pi))
    j = jray.flat_mimo_time_varying(key, 2, 3, 28, 70.0, batch_shape=(5,))
    t = tray.flat_mimo_time_varying(2, 3, 28, 70.0, batch_shape=(5,), device="cpu", phases=phi)
    assert t.shape == (5, 28, 2, 3)
    _close(t, j, 2e-5)


def _taps(links=64, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    prof = tray.make_profile("Pedestrian_A", FS, fd=FD)
    return tray.jakes_taps(prof, T, (links,), generator=gen, device="cpu")


def test_mean_power_two():
    p = float(_taps().abs2().mean())
    assert abs(p - 2.0) < 0.1, p


def test_rayleigh_envelope():
    """|h| Rayleigh with σ²=1 (E|h|²=2): mean √(π/2), median √(2 ln 2)."""
    env = _taps(links=64).abs().numpy().ravel()
    assert abs(env.mean() - np.sqrt(np.pi / 2)) < 0.05
    assert abs(np.mean(env < np.sqrt(2 * np.log(2))) - 0.5) < 0.05


def test_autocorrelation_tracks_bessel():
    """E[h(t)h*(t+τ)]/E|h|² ≈ J0(2π f_D τ)."""
    h = _taps(links=128)
    x = h.re.numpy()[:, 0, :] + 1j * h.im.numpy()[:, 0, :]
    power = np.mean(np.abs(x) ** 2)
    for lag_s in (0.0, 0.5 / FD, 1.0 / FD, 2.0 / FD):
        lag = int(lag_s * FS)
        ac = np.mean(np.real(x[:, :T - lag] * np.conj(x[:, lag:]))) / power
        expected = j0(2 * np.pi * FD * lag / FS)
        assert abs(ac - expected) < 0.12, (lag, ac, expected)


def test_multipath_power_profile(rng):
    """Output power = E|h|²·Σ g_i² = 2·Σ g_i² for unit-power input."""
    prof = tray.make_profile("Vehicular_A", FS, fd=FD)
    x = tcplx.from_numpy((rng.standard_normal((64, T // 4))
                          + 1j * rng.standard_normal((64, T // 4))) / np.sqrt(2))
    gen = torch.Generator()
    gen.manual_seed(1)
    y = tray.apply_multipath(x, prof, generator=gen)
    p_out = float(y.abs2().mean())
    p_expected = 2.0 * sum(g * g for g in prof.gains_linear)
    assert abs(p_out - p_expected) / p_expected < 0.15, (p_out, p_expected)


def test_flat_fading_and_cn01_statistics(rng):
    gen = torch.Generator()
    gen.manual_seed(2)
    h = tray.flat_mimo_matrix(2, 2, (50_000,), generator=gen, device="cpu")
    assert h.shape == (50_000, 2, 2) and abs(float(h.abs2().mean()) - 1.0) < 0.02
    x = tcplx.from_numpy(np.ones((4, 20_000)) + 0j)
    y = tray.flat_fading(x, 10.0, generator=gen)
    # unit-power fading on a unit signal, then noise at 10 dB below the faded power
    assert abs(float(y.abs2().mean()) - 1.1) < 0.05
    # the seams replace the draws
    fading = (rng.standard_normal((4, 20_000)), rng.standard_normal((4, 20_000)))
    zeros = (np.zeros((4, 20_000)), np.zeros((4, 20_000)))
    y = tray.flat_fading(x, 10.0, fading=fading, noise=zeros)
    np.testing.assert_allclose(y.re.numpy(), fading[0] / np.sqrt(2), atol=1e-6)


@pytest.mark.parametrize("snr_db", [3.0, 20.0])
def test_flat_fading_same_draws_match_jax(snr_db, rng):
    """The port's seams get what flat_fading(key, ...) draws in the JAX
    package (key -> fading, noise; each -> re, im), so the two outputs differ
    by fp32 rounding alone. The noise power is the whole batch's: the lanes
    below differ in power by 16x."""
    key = jax.random.PRNGKey(6)
    shape = (3, 700)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
    x *= np.array([0.5, 1.0, 2.0])[:, None]
    kh, kn = jax.random.split(key)
    fading, noise = (tuple(np.array(jax.random.normal(k, shape, jnp.float32))
                           for k in jax.random.split(kk)) for kk in (kh, kn))
    j = jray.flat_fading(key, jcplx.from_numpy(x), snr_db)
    t = tray.flat_fading(tcplx.from_numpy(x), snr_db, fading=fading, noise=noise)
    _close(t, j, 1e-5)
    # and the formula itself: y = h·x + σ·n with one σ for the batch
    h = (fading[0] + 1j * fading[1]) / np.sqrt(2)
    sigma = np.sqrt(np.mean(np.abs(h * x) ** 2) / 10 ** (snr_db / 10) / 2)
    y = h * x + sigma * (noise[0] + 1j * noise[1])
    np.testing.assert_allclose(t.to_numpy(), y, rtol=0, atol=1e-5)


def test_path_loss_matches_jax_under_same_shadowing():
    key = jax.random.PRNGKey(4)
    d = np.array([100.0, 300.0, 1000.0], np.float32)
    shadow = np.array(jax.random.normal(key, (3,)))
    j = jray.path_loss_linear(key, jnp.asarray(d))
    t = tray.path_loss_linear(d, shadow=shadow)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)
    gen = torch.Generator()
    gen.manual_seed(0)
    a = tray.path_loss_linear(np.full(200, 100.0), generator=gen).mean()
    assert 0.01 < float(a) < 0.1
