"""The fading channels against the JAX package: profiles equal, the Jakes
taps, the multipath FIR and the responses under the same phases (drawn by
jax.random with the test's key and fed to the port's seam), and the Jakes
statistics of tests/test_channel_stats.py on the port's own generator."""
from types import SimpleNamespace

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


# -- the one-pass multipath FIR (ops/multipath_fir) against the unfused path --

from ofdm_lte_tpu_torch.ops import multipath_fir as tfir  # noqa: E402

# (RX legs, TX antennas summed or None, profile, fs, velocity, hold, T, lanes)
FIR_CASES = {
    "1x1_peda": ((), None, "Pedestrian_A", 30.72e6, 3.0, 1, 1200, (3,)),
    "2x1_simo_peda_hold4": ((2,), None, "Pedestrian_A", 30.72e6, 5.0, 4, 1200, (3,)),
    "4x4_tx_sum_veha": ((4,), 4, "Vehicular_A", 7.68e6, 30.0, 1, 900, (2,)),
    "4x4_tx_sum_peda_hold6": ((4,), 4, "Pedestrian_A", 30.72e6, 3.0, 6, 1200, (2,)),
    "1x1_delay_past_T": ((), None, "Pedestrian_A", 30.72e6, 3.0, 1, 12, (5,)),
}


def _fir_case(name, rng):
    links, n_tx, prof_name, fs, v, hold, T, lanes = FIR_CASES[name]
    prof = tray.make_profile(prof_name, fs, velocity_kmh=v)
    shape = ((n_tx,) if n_tx else ()) + lanes + (T,)
    x = tcplx.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    batch = tuple(links) + shape[:-1]
    phi = rng.uniform(0, 2 * np.pi, (int(np.prod(batch)) * prof.num_taps, 16)).astype(np.float32)
    n_rx, B = int(np.prod(links)), int(np.prod(lanes))
    rows = tray.jakes_rows(prof, batch, device="cpu", phases=phi).reshape(
        n_rx, n_tx or 1, B, prof.num_taps, 16)
    x3 = x.reshape(n_tx or 1, B, T)
    fold = tray.jakes_fold(prof.doppler_hz, prof.fs, T // hold, hold, "cpu")
    return prof, x, x3, rows, phi, fold, links, n_tx, hold


def _fir64(x3: tcplx.C, rows: tcplx.C, table: tcplx.C, delays, gains, hold: int):
    """Σ_tx Σ_i g_i·(P @ E)(t // hold)·x(t − d_i) in float64 from the fp32
    operands: the sum the fused and the unfused forms both approximate."""
    x = x3.to_numpy().astype(np.complex128)
    h = rows.to_numpy().astype(np.complex128) @ table.to_numpy().astype(np.complex128)
    h = np.repeat(h, hold, axis=-1)                          # (rx, tx, lanes, taps, T)
    T = x.shape[-1]
    y = np.zeros((h.shape[0],) + x.shape[1:], np.complex128)
    for i, (d, g) in enumerate(zip(delays, gains)):
        if d < T:
            y[..., d:] += g * np.einsum("rtbs,tbs->rbs", h[..., i, d:], x[..., :T - d])
    return y


@pytest.mark.parametrize("name", list(FIR_CASES))
def test_multipath_fir_plain_matches_apply_multipath(name, rng):
    """The plain version of the fused pass against today's unfused path (the
    Jakes product, the addcmul_ taps, the sum over TX) under the same phases,
    and both against float64: the fused pass regroups the same fp32 sum."""
    prof, x, x3, rows, phi, fold, links, n_tx, hold = _fir_case(name, rng)
    unfused = tray.apply_multipath(x, prof, hold, phases=phi, links=links,
                                   sum_tx=n_tx is not None)
    if n_tx:
        legs = tray.apply_multipath(x, prof, hold, phases=phi, links=links)
        assert torch.equal(unfused.re, legs.sum(axis=1).re)
        assert torch.equal(unfused.im, legs.sum(axis=1).im)
    plain = tfir.multipath_fir_plain(x3, rows, fold, prof.delays_samples, prof.gains_linear, hold)
    assert tuple(plain.shape) == (max(1, int(np.prod(links))),) + tuple(x3.shape[1:])
    plain = plain.reshape(*unfused.shape)
    table = tray.jakes_table(prof.doppler_hz, prof.fs, x.shape[-1] // hold, hold, "cpu")
    y64 = _fir64(x3, rows, table, prof.delays_samples, prof.gains_linear, hold).reshape(
        unfused.shape)
    scale = np.abs(y64).max()
    # fp32 sums of some 16·taps·n_tx terms of |P|·|x| ≤ 1.4·5: a few ulps of the scale
    for y in (plain, unfused):
        assert np.abs(y.to_numpy() - y64).max() <= 2e-6 * scale
    assert np.abs(plain.to_numpy() - unfused.to_numpy()).max() <= 2e-6 * scale


@pytest.mark.parametrize("table_of", ["random", "static"])
def test_multipath_fir_plain_holds_any_fold(table_of, rng):
    """A table with no symmetry keeps 16 single rows (D = 16); a static
    channel (f_D = 0) folds into one row, padded to D = 6."""
    T, lanes, taps = 40, 3, 2
    if table_of == "random":
        table = tcplx.from_numpy(np.exp(1j * rng.uniform(0, 2 * np.pi, (16, T))))
    else:
        table = tray.jakes_table(0.0, 1e6, T, device="cpu")
    fold = tfir.sinusoid_fold(table)
    assert (fold.groups, fold.cos.shape[0]) == ((16, 16) if table_of == "random" else (1, 6))
    rows = tcplx.from_numpy(rng.standard_normal((2, 3, lanes, taps, 16))
                            + 1j * rng.standard_normal((2, 3, lanes, taps, 16)))
    x3 = tcplx.from_numpy(rng.standard_normal((3, lanes, T))
                          + 1j * rng.standard_normal((3, lanes, T)))
    delays, gains = (0, 5), (1.1, 0.7)
    y = tfir.multipath_fir_plain(x3, rows, fold, delays, gains)
    y64 = _fir64(x3, rows, table, delays, gains, 1)
    assert np.abs(y.to_numpy() - y64).max() <= 2e-6 * np.abs(y64).max()


# the groups of n = 1..16 (a minus: the conjugate row) at the cells' Dopplers:
# sic4x4_peda at 3 km/h, siso64_peda at Pedestrian A's default 5 km/h
CELL_GROUPS = [[1, -7, -9, 15], [2, -6, -10, 14], [3, -5, -11, 13], [4], [8, -16], [12]]


@pytest.mark.parametrize("velocity", [3.0, None])
def test_sinusoid_fold_finds_the_cells_groups(velocity):
    prof = tray.make_profile("Pedestrian_A", 30.72e6, velocity_kmh=velocity)
    T = 14 * 2192
    fold = tray.jakes_fold(prof.doppler_hz, prof.fs, T, device="cpu")
    groups = [[(n + 1) * s for n, (g, s) in enumerate(zip(fold.group, fold.sign)) if g == k]
              for k in range(fold.groups)]
    assert groups == CELL_GROUPS and fold.cos.shape == (6, T)
    table = tray.jakes_table(prof.doppler_hz, prof.fs, T, device="cpu")
    for n, (k, s) in enumerate(zip(fold.group, fold.sign)):
        assert torch.equal(table.re[n], fold.cos[k]) and torch.equal(table.im[n], s * fold.sin[k])
    assert tray.jakes_fold(prof.doppler_hz, prof.fs, T, device="cpu") is fold


def test_multipath_fir_on_cpu_is_its_plain_version(rng):
    prof, x, x3, rows, phi, fold, links, n_tx, hold = _fir_case("4x4_tx_sum_peda_hold6", rng)
    before = tfir.multipath_fir.launches
    args = (prof.delays_samples, prof.gains_linear, hold)
    got = tfir.multipath_fir(x3, rows, fold, *args)
    want = tfir.multipath_fir_plain(x3, rows, fold, *args)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert tfir.multipath_fir.launches == before
    with pytest.raises(ValueError):
        tfir.multipath_fir(x3[:2], rows, fold, *args)         # a TX antenna short
    with pytest.raises(ValueError):
        tfir.multipath_fir(x3, rows, fold, prof.delays_samples[:2], prof.gains_linear, hold)
    with pytest.raises(ValueError):
        tfir.multipath_fir(x3, rows, fold, prof.delays_samples, prof.gains_linear, 4)


@pytest.mark.parametrize("precision,form", [("highest", "fma4"), ("highest", "gauss"),
                                            ("high", "fma4"), ("default", "fma4")])
def test_apply_multipath_routes_by_device_alone(precision, form, rng, monkeypatch):
    """Under every GEMM policy and form a CPU tensor takes multipath_unfused
    (bit for bit, no fused launch) and a CUDA tensor multipath_fused."""
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", precision)
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_CMATMUL", form)
    prof, x, x3, rows, phi, fold, links, n_tx, hold = _fir_case("2x1_simo_peda_hold4", rng)
    before = tfir.multipath_fir.launches
    got = tray.apply_multipath(x, prof, hold, phases=phi, links=links)
    want = tray.multipath_unfused(x, prof, hold, phases=phi, links=links)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert tfir.multipath_fir.launches == before
    taken = []
    monkeypatch.setattr(tray, "multipath_fused", lambda *a: taken.append("fused"))
    monkeypatch.setattr(tray, "multipath_unfused", lambda *a: taken.append("unfused"))
    on_card = SimpleNamespace(re=SimpleNamespace(device=torch.device("cuda", 0)))
    tray.apply_multipath(on_card, prof)
    tray.apply_multipath(x, prof)
    assert taken == ["fused", "unfused"]


@pytest.mark.parametrize("name", list(FIR_CASES))
def test_apply_multipath_fused_route_matches_unfused(name, rng):
    """The fused route (multipath_fused: its reshapes around multipath_fir,
    here the plain version on the CPU) against multipath_unfused, same
    phases; the generator's draws are the same on both routes."""
    prof, x, x3, rows, phi, fold, links, n_tx, hold = _fir_case(name, rng)
    sum_tx = n_tx is not None
    fused = tray.multipath_fused(x, prof, hold, phases=phi, links=links, sum_tx=sum_tx)
    unfused = tray.multipath_unfused(x, prof, hold, phases=phi, links=links, sum_tx=sum_tx)
    assert fused.shape == unfused.shape
    scale = unfused.abs().max().item()
    assert (fused.re - unfused.re).abs().max().item() <= 2e-6 * scale
    assert (fused.im - unfused.im).abs().max().item() <= 2e-6 * scale
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    fused = tray.multipath_fused(x, prof, hold, generator=g1, links=links, sum_tx=sum_tx)
    unfused = tray.multipath_unfused(x, prof, hold, generator=g2, links=links, sum_tx=sum_tx)
    assert (fused.re - unfused.re).abs().max().item() <= 2e-6 * scale
