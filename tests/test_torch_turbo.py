"""The turbo codec against the JAX package: the QPP and trellis tables, the
encoder bit for bit, the BCJR pass (max-log equal as floats, log-MAP within
a stated tolerance) and the decoder's hard bits on noisy codewords."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu.coding import turbo as jturbo

from ofdm_lte_tpu_torch.coding import turbo as tturbo
from ofdm_lte_tpu_torch.ops import bcjr

torch.set_num_threads(2)

# log-MAP: expf/logf and the order of the 8-state sums differ from XLA's by a
# few ulps of the path metrics, which grow without renormalisation to
# Σ_k (|L_sys| + |L_par| + |L_apr|)/2: the bound is 1e-6 of that sum
LOGMAP_TOL = 1e-6


def _llrs(rng, n, kp, scale=3.0):
    return [(rng.standard_normal((n, kp)) * scale).astype(np.float32) for _ in range(3)]


def _noisy_codewords(rng, n, K, sigma=0.55):
    """Codewords of n random blocks as LLRs (> 0 for a 0 bit) at noise σ."""
    b = rng.integers(0, 2, (n, K)).astype(np.int32)
    enc = np.asarray(jturbo.turbo_encode(jnp.asarray(b), K))
    llr = (2.0 / sigma ** 2) * ((1.0 - 2.0 * enc) + sigma * rng.standard_normal(enc.shape))
    return b, llr.astype(np.float32)


def test_qpp_tables_equal_for_every_K():
    assert tturbo.QPP_PARAMS == jturbo.QPP_PARAMS and len(tturbo.QPP_PARAMS) == 188
    for K in tturbo.QPP_PARAMS:
        np.testing.assert_array_equal(tturbo.qpp_indices(K), jturbo.qpp_indices(K))
        np.testing.assert_array_equal(tturbo.qpp_inverse_indices(K),
                                      jturbo.qpp_inverse_indices(K))
    with pytest.raises(ValueError):
        tturbo.qpp_indices(41)


def test_qpp_interleave_round_trip(rng):
    x = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32))
    y = tturbo.qpp_interleave(x, 1024)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jturbo.qpp_interleave(
        jnp.asarray(x.numpy()), 1024)))
    assert torch.equal(tturbo.qpp_deinterleave(y, 1024), x)


def test_trellis_tables_equal():
    for got, want in zip(tturbo.trellis_tables(), jturbo.trellis_tables()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tturbo.reverse_trellis(), jturbo.reverse_trellis()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K", [40, 48, 1024, 5824, 6080, 6144])
def test_turbo_encode_bit_for_bit(K, rng):
    bits = rng.integers(0, 2, (3, 2, K)).astype(np.int8)
    want = np.asarray(jturbo.turbo_encode(jnp.asarray(bits), K))
    got = tturbo.turbo_encode(torch.from_numpy(bits), K)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 2, 3 * K + 12)
    np.testing.assert_array_equal(got.numpy(), want)
    sys1, par1 = tturbo.rsc_encode(torch.from_numpy(bits))
    jsys, jpar = jturbo.rsc_encode(jnp.asarray(bits))
    np.testing.assert_array_equal(sys1.numpy(), np.asarray(jsys))
    np.testing.assert_array_equal(par1.numpy(), np.asarray(jpar))


@pytest.mark.parametrize("kp", [43, 1027])
def test_bcjr_plain_max_log_equals_jax_scan_as_floats(kp, rng):
    ls, lp, la = _llrs(rng, 5, kp)
    want = np.asarray(jturbo._bcjr(jnp.asarray(ls), jnp.asarray(lp), jnp.asarray(la),
                                   impl="scan", use_max_log=True))
    got = bcjr.bcjr_plain(*map(torch.from_numpy, (ls, lp, la)), use_max_log=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kp", [43, 1027])
def test_bcjr_plain_log_map_within_tolerance(kp, rng):
    ls, lp, la = _llrs(rng, 5, kp)
    want = np.asarray(jturbo._bcjr(jnp.asarray(ls), jnp.asarray(lp), jnp.asarray(la),
                                   impl="scan", use_max_log=False))
    got = bcjr.bcjr_plain(*map(torch.from_numpy, (ls, lp, la)), use_max_log=False).numpy()
    metric = 0.5 * (np.abs(ls) + np.abs(lp) + np.abs(la)).sum(axis=-1).max()
    assert np.abs(got - want).max() <= LOGMAP_TOL * metric
    # and it is not max-log
    assert np.abs(got - np.asarray(jturbo._bcjr(jnp.asarray(ls), jnp.asarray(lp),
                                                jnp.asarray(la), impl="scan"))).max() > 1e-3


def test_bcjr_impls_other_than_scan_raise(rng):
    ls, lp, la = map(torch.from_numpy, _llrs(rng, 1, 43))
    for impl in ("block", "assoc", None):
        with pytest.raises(ValueError, match="scan"):
            tturbo._bcjr(ls, lp, la, impl=impl)
    assert torch.equal(tturbo._bcjr(ls, lp, la), bcjr.bcjr_app(ls, lp, la))


def test_bcjr_app_on_cpu_is_the_plain_version_and_launches_nothing(rng):
    ls, lp, la = map(torch.from_numpy, _llrs(rng, 2, 43))
    before = bcjr.bcjr_app.launches
    assert torch.equal(bcjr.bcjr_app(ls, lp, la, False), bcjr.bcjr_plain(ls, lp, la, False))
    assert bcjr.bcjr_app.launches == before


@pytest.mark.parametrize("use_max_log", [True, False], ids=["max_log", "log_map"])
@pytest.mark.parametrize("K,iterations", [(40, 8), (1024, 8), (6144, 2)])
def test_turbo_decode_hard_bits_equal(K, iterations, use_max_log, rng):
    n = 2 if K == 6144 else 3
    bits, llr = _noisy_codewords(rng, n, K)
    want = np.asarray(jturbo.turbo_decode(jnp.asarray(llr), K, iterations, use_max_log))
    got = tturbo.turbo_decode(torch.from_numpy(llr), K, iterations, use_max_log)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != bits).mean() < 0.01       # σ 0.55: past the waterfall


def test_set_decoder_mode_switches_both(rng):
    _, llr = _noisy_codewords(rng, 2, 40, sigma=1.3)
    x = torch.from_numpy(llr)
    try:
        for mode in (False, True):
            tturbo.set_decoder_mode(mode)
            jturbo.set_decoder_mode(mode)
            assert tturbo.USE_MAX_LOG_MAP is mode and jturbo.USE_MAX_LOG_MAP is mode
            np.testing.assert_array_equal(
                tturbo.turbo_decode(x, 40, 3).numpy(),
                np.asarray(jturbo.turbo_decode(jnp.asarray(llr), 40, 3)))
            assert torch.equal(tturbo.turbo_decode(x, 40, 3),
                               tturbo.turbo_decode(x, 40, 3, use_max_log=mode))
    finally:
        tturbo.set_decoder_mode(True)
        jturbo.set_decoder_mode(True)
