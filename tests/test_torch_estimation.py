"""CRS estimation and ZF: the port against ofdm_lte_tpu/rx/estimation.py,
same numpy inputs, atol 1e-6 (float32 elementwise arithmetic in the same
order; only library rounding of log10/division may differ)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu.cplx import C as JC
from ofdm_lte_tpu.grid import grid_for
from ofdm_lte_tpu.rx import estimation as jest

from ofdm_lte_tpu_torch import config as tcfg
from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.rx import estimation as test_

torch.set_num_threads(2)

ATOL = 1e-6


def _pair(rng, shape, scale=1.0):
    re = (rng.standard_normal(shape) * scale).astype(np.float32)
    im = (rng.standard_normal(shape) * scale).astype(np.float32)
    return JC(jnp.asarray(re), jnp.asarray(im)), C(torch.from_numpy(re), torch.from_numpy(im))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.re.numpy(), np.asarray(j.re), rtol=0, atol=atol)
    np.testing.assert_allclose(t.im.numpy(), np.asarray(j.im), rtol=0, atol=atol)


@pytest.mark.parametrize("bw", [1.25, 5.0])
def test_ls_and_pilot_snr(bw, rng):
    n_pil = grid_for(jcfg.LTEConfig(bw)).num_pilot
    j, t = _pair(rng, (3, 2, n_pil))
    _close(test_.ls_at_pilots(t, 0), jest.ls_at_pilots(j, 0))
    _close(test_.ls_at_pilots(t, 5), jest.ls_at_pilots(j, 5))
    for axis in (None, (-2, -1), -1):
        np.testing.assert_allclose(test_.pilot_snr_db(t, 0, axis=axis).numpy(),
                                   np.asarray(jest.pilot_snr_db(j, 0, axis=axis)),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("bw", [1.25, 5.0, 20.0])
def test_interpolate(bw, rng):
    jc, tc = jcfg.LTEConfig(bw), tcfg.LTEConfig(bw)
    g = grid_for(jc)
    j, t = _pair(rng, (2, 3, g.num_pilot))
    _close(test_.interpolate(t, tc, out_bins=g.data_idx),
           jest.interpolate(j, jc, out_bins=g.data_idx))
    _close(test_.interpolate(t, tc), jest.interpolate(j, jc))
    table = test_.interp_tables(tc, g.data_idx)
    _close(test_.interpolate(t, tc, out_bins=g.data_idx, table=table),
           jest.interpolate(j, jc, out_bins=g.data_idx))


@pytest.mark.parametrize("S", [14, 20, 28])
def test_slot_periodic(S, rng):
    n_slots = len(jest.slot_start_indices(S))
    np.testing.assert_array_equal(test_.slot_start_indices(S), jest.slot_start_indices(S))
    j, t = _pair(rng, (2, n_slots, 9))
    _close(test_.slot_periodic(t, S), jest.slot_periodic(j, S), atol=0)


def test_zf_equalize(rng):
    jy, ty = _pair(rng, (2, 5, 40))
    jh, th = _pair(rng, (2, 5, 40))
    _close(test_.zf_equalize(ty, th), jest.zf_equalize(jy, jh))
    # near-zero channel estimates: ε keeps the quotient finite, in both
    z = np.zeros((1, 4), np.float32)
    out_t = test_.zf_equalize(C(torch.ones(1, 4), torch.ones(1, 4)),
                              C(torch.from_numpy(z), torch.from_numpy(z)))
    out_j = jest.zf_equalize(JC(jnp.ones((1, 4)), jnp.ones((1, 4))),
                             JC(jnp.asarray(z), jnp.asarray(z)))
    np.testing.assert_allclose(out_t.re.numpy(), np.asarray(out_j.re), rtol=1e-6)
    np.testing.assert_allclose(out_t.im.numpy(), np.asarray(out_j.im), rtol=1e-6)
