"""AWGN with an explicit torch.Generator, and EVM, against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu.channel import awgn as jawgn
from ofdm_lte_tpu.cplx import C as JC
from ofdm_lte_tpu.utils import metrics as jmetrics

from ofdm_lte_tpu_torch.channel import awgn as tawgn
from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)


def _signal(rng, shape, scale):
    re = (rng.standard_normal(shape) * scale).astype(np.float32)
    im = (rng.standard_normal(shape) * scale).astype(np.float32)
    return JC(jnp.asarray(re), jnp.asarray(im)), C(torch.from_numpy(re), torch.from_numpy(im))


@pytest.mark.parametrize("measure_axes", [None, -1])
def test_awgn_noise_power_matches_jax(measure_axes, rng):
    """Both packages scale unit normals by the same measured σ²: the empirical
    noise power per lane agrees within Monte-Carlo error (2e5 samples a lane,
    relative σ ≈ 0.3%)."""
    j_sig, t_sig = _signal(rng, (3, 200_000), np.array([[0.5], [1.0], [2.0]]))
    snr = np.array([[0.0], [10.0], [20.0]], np.float32) if measure_axes == -1 else 10.0
    j_out = jawgn.awgn(jax.random.PRNGKey(0), j_sig, jnp.asarray(snr), measure_axes=measure_axes)
    gen = torch.Generator()
    gen.manual_seed(0)
    t_out = tawgn.awgn(t_sig, torch.as_tensor(snr), measure_axes=measure_axes, generator=gen)
    j_pow = np.asarray((j_out - j_sig).abs2()).mean(axis=-1)
    t_pow = (t_out - t_sig).abs2().numpy().mean(axis=-1)
    np.testing.assert_allclose(t_pow, j_pow, rtol=0.03)
    # and the generator makes it reproducible
    gen.manual_seed(0)
    again = tawgn.awgn(t_sig, torch.as_tensor(snr), measure_axes=measure_axes, generator=gen)
    assert torch.equal(again.re, t_out.re)


def test_noise_like_variance():
    gen = torch.Generator()
    gen.manual_seed(1)
    n = tawgn.noise_like((400_000,), 0.25, generator=gen)
    assert abs(n.abs2().mean().item() - 0.25) < 0.01 * 0.25 * 3
    assert abs(n.re.var().item() - n.im.var().item()) < 0.005


def test_evm_matches_jax(rng):
    j_tx, t_tx = _signal(rng, (4, 50), 1.0)
    j_err, t_err = _signal(rng, (4, 50), 0.1)
    ref = jmetrics.evm_percent(j_tx, j_tx + j_err)
    out = tmetrics.evm_percent(t_tx, t_tx + t_err)
    assert isinstance(out, float)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
