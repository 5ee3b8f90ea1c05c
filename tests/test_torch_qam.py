"""QAM map and hard demap: the port bit-exact against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu.cplx import C as JC
from ofdm_lte_tpu.ops import qam as jqam

from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.ops import qam as tqam

torch.set_num_threads(2)

MODULATIONS = ["QPSK", "16-QAM", "64-QAM"]


def _both(re, im):
    re = np.asarray(re, np.float32)
    im = np.asarray(im, np.float32)
    return JC(jnp.asarray(re), jnp.asarray(im)), C(torch.from_numpy(re), torch.from_numpy(im))


@pytest.mark.parametrize("modulation", MODULATIONS)
def test_modulate_bit_exact(modulation, rng):
    bps = jqam.spec(modulation).bits_per_symbol
    bits = rng.integers(0, 2, (3, 50 * bps)).astype(np.int32)
    j = jqam.modulate(jnp.asarray(bits), modulation)
    t = tqam.modulate(torch.from_numpy(bits), modulation)
    assert t.re.dtype == torch.float32
    np.testing.assert_array_equal(t.re.numpy(), np.asarray(j.re))
    np.testing.assert_array_equal(t.im.numpy(), np.asarray(j.im))
    np.testing.assert_array_equal(
        tqam.bits_to_indices(torch.from_numpy(bits), modulation).numpy(),
        np.asarray(jqam.bits_to_indices(jnp.asarray(bits), modulation)))


@pytest.mark.parametrize("modulation", MODULATIONS)
def test_every_constellation_point_round_trips(modulation):
    s = jqam.spec(modulation)
    idx = np.arange(2 ** s.bits_per_symbol)
    bits = ((idx[:, None] >> np.arange(s.bits_per_symbol - 1, -1, -1)) & 1).reshape(-1)
    t = tqam.modulate(torch.from_numpy(bits.astype(np.int8)), modulation)
    np.testing.assert_allclose(t.re.numpy() + 1j * t.im.numpy(),
                               jqam.constellation(modulation), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tqam.hard_indices(t, modulation).numpy(), idx)
    np.testing.assert_array_equal(tqam.demodulate(t, modulation).numpy(), bits)


def _boundary_values(modulation):
    """Points on and next to every decision boundary, the levels, zero and
    values beyond the outer levels, all as float32."""
    s = jqam.spec(modulation)
    L = len(s.levels)
    edges = np.arange(-(L - 2), L - 1, 2, dtype=np.float64)      # between levels
    lv = np.asarray(s.levels, np.float64)
    vals = np.concatenate([edges, lv, [-9.0, 9.0, 1e3, -1e3]]) / s.norm
    vals = vals.astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    out = np.concatenate([vals, np.nextafter(vals, np.float32(np.inf)),
                          np.nextafter(vals, np.float32(-np.inf)),
                          np.array([tiny, -tiny], np.float32)])
    # zero's neighbours are the smallest normal floats: XLA on the CPU
    # flushes subnormals to zero, torch does not
    return out[(out == 0) | (np.abs(out) >= tiny)]


@pytest.mark.parametrize("modulation", MODULATIONS)
def test_hard_demap_bit_exact_at_boundaries(modulation, rng):
    v = _boundary_values(modulation)
    re, im = np.meshgrid(v, v)
    noise = rng.standard_normal((2, 4000)).astype(np.float32)
    re = np.concatenate([re.ravel(), noise[0]])
    im = np.concatenate([im.ravel(), noise[1]])
    j, t = _both(re, im)
    np.testing.assert_array_equal(tqam.hard_indices(t, modulation).numpy(),
                                  np.asarray(jqam.hard_indices(j, modulation)))
    jd, td = jqam.detect(j, modulation), tqam.detect(t, modulation)
    np.testing.assert_array_equal(td.re.numpy(), np.asarray(jd.re))
    np.testing.assert_array_equal(td.im.numpy(), np.asarray(jd.im))
    tb = tqam.demodulate(t, modulation)
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jqam.demodulate(j, modulation)))


def test_round_half_to_even():
    """torch.round and jnp.round both round half to even."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


@pytest.mark.parametrize("modulation", MODULATIONS)
def test_indices_to_bits_batched(modulation, rng):
    s = jqam.spec(modulation)
    idx = rng.integers(0, 2 ** s.bits_per_symbol, (2, 3, 7))
    np.testing.assert_array_equal(
        tqam.indices_to_bits(torch.from_numpy(idx), modulation).numpy(),
        np.asarray(jqam.indices_to_bits(jnp.asarray(idx.astype(np.int32)), modulation)))
