"""The modem's new GEMM call sites against the JAX package, same inputs:
SC-FDM precoding, the custom-layout and multi-antenna modulators, the full
grid IDFT/DFT and the per-symbol PAPR. Tolerances are tests/test_ofdm.py's
(atol 1e-4 on the time signal, 1e-5 on unit-scale planes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.grid import grid_for, orthogonal_pilot_indices
from ofdm_lte_tpu.ops import ofdm as jofdm
from ofdm_lte_tpu.ops import scfdm as jscfdm

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.ops import ofdm as tofdm
from ofdm_lte_tpu_torch.ops import scfdm as tscfdm

torch.set_num_threads(2)


def _pair(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale
    return jcplx.from_numpy(x), tcplx.from_numpy(x)


def _close(t, j, atol):
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(t.re.numpy(), np.asarray(j.re), rtol=0, atol=atol)
    np.testing.assert_allclose(t.im.numpy(), np.asarray(j.im), rtol=0, atol=atol)


@pytest.mark.parametrize("M", [72, 249, 999])
def test_scfdm_precode_decode_match_jax(M, rng):
    j, t = _pair(rng, (2, 3, M), scale=1 / np.sqrt(2))
    jp, tp = jscfdm.precode(j, M), tscfdm.precode(t, M)
    _close(tp, jp, 1e-5)
    _close(tscfdm.decode(tp, M), jscfdm.decode(jp, M), 1e-5)
    # unitary round trip
    _close(tscfdm.decode(tp, M), j, 2e-5)
    for inverse in (False, True):
        for a, b in zip(tscfdm._dft_consts(M, inverse), jscfdm._dft_consts(M, inverse)):
            np.testing.assert_array_equal(a, b)


def test_scfdm_tables_argument_gives_the_same(rng):
    _, t = _pair(rng, (4, 72))
    tab = tscfdm.dft_tables(72, False, "cpu")
    out, own = tscfdm.precode(t, 72, tab), tscfdm.precode(t, 72)
    assert torch.equal(out.re, own.re) and torch.equal(out.im, own.im)
    assert tab.re.is_contiguous() and tab.im.is_contiguous()


@pytest.mark.parametrize("bw", [1.25, 5.0])
def test_modulate_custom_matches_jax(bw, rng):
    jc, tc = jcfg.LTEConfig(bw), LTEConfig(bw)
    g = grid_for(jc)
    dbins = g.data_idx[:len(g.data_idx) - len(g.data_idx) % 2]
    j, t = _pair(rng, (2, 3, len(dbins)), scale=1 / np.sqrt(2))
    for tx in (0, 1):
        pil = g.pilot_idx[tx::2]
        _close(tofdm.modulate_custom(t, tc, dbins, pil, tx),
               jofdm.modulate_custom(j, jc, dbins, pil, tx), 1e-4)
    # no pilots: the 'simple' mode's layout, first Nc bins
    j, t = _pair(rng, (2, jc.Nc))
    _close(tofdm.modulate_custom(t, tc, np.arange(tc.Nc), (), 0),
           jofdm.modulate_custom(j, jc, np.arange(jc.Nc), (), 0), 1e-4)
    for a, b in zip(tofdm._mod_consts_custom(tc.N, tc.cp_length, tuple(map(int, dbins)),
                                             tuple(map(int, g.pilot_idx[1::2])), 1),
                    jofdm._mod_consts_custom(jc.N, jc.cp_length, tuple(map(int, dbins)),
                                             tuple(map(int, g.pilot_idx[1::2])), 1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_tx", [2, 4])
def test_modulate_custom_multi_matches_jax(num_tx, rng):
    jc, tc = jcfg.LTEConfig(2.5), LTEConfig(2.5)
    g = grid_for(jc)
    pilots = orthogonal_pilot_indices(jc, num_tx)
    cells = [tx % 4 for tx in range(num_tx)]
    j, t = _pair(rng, (2, 3, num_tx, g.num_data), scale=1 / np.sqrt(2))
    # the port leads with the antenna axis, the JAX package keeps it at -2
    out = tofdm.modulate_custom_multi(t.transpose(2, 0, 1, 3), tc, g.data_idx, pilots, cells)
    assert out.shape == (num_tx, 2, 3, tc.samples_per_ofdm_symbol)
    _close(out.transpose(1, 2, 0, 3),
           jofdm.modulate_custom_multi(j, jc, g.data_idx, pilots, cells), 1e-4)


@pytest.mark.parametrize("bw", [1.25, 5.0])
def test_modulate_grid_and_demodulate_full_match_jax(bw, rng):
    jc, tc = jcfg.LTEConfig(bw), LTEConfig(bw)
    j, t = _pair(rng, (2, 3, jc.N), scale=1 / np.sqrt(2))
    jt, tt = jofdm.modulate_grid(j, jc), tofdm.modulate_grid(t, tc)
    _close(tt, jt, 1e-4)
    back = tofdm.demodulate_full(tt, tc)
    _close(back, jofdm.demodulate_full(jt, jc), 1e-4)
    _close(back, j, 1e-4)                       # IDFT then DFT is the identity
    # the Nc-row form that the 'simple' link uses equals the scattered full grid
    syms = t[..., :tc.Nc]
    full = tcplx.scatter_set(tcplx.czeros((2, 3, tc.N)), (..., slice(0, tc.Nc)), syms)
    rows = tofdm.modulate_custom(syms, tc, np.arange(tc.Nc), (), 0)
    _close(rows, tofdm.modulate_grid(full, tc), 1e-5)


@pytest.mark.parametrize("include_cp", [True, False])
def test_papr_per_symbol_matches_jax(include_cp, rng):
    jc, tc = jcfg.LTEConfig(1.25), LTEConfig(1.25)
    j, t = _pair(rng, (3, 5 * jc.samples_per_ofdm_symbol + 7))
    out = tofdm.papr_per_symbol_db(t, tc, include_cp)
    ref = jofdm.papr_per_symbol_db(j, jc, include_cp)
    assert out.shape == (3, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_cplx_helpers_match_jax(rng):
    j, t = _pair(rng, (2, 3, 4))
    _close(t.transpose(2, 0, 1), j.transpose(2, 0, 1), 0)
    _close(t.sum(axis=1), j.sum(axis=1), 1e-6)
    _close(t.mean(axis=-1, keepdims=True), j.mean(axis=-1, keepdims=True), 1e-6)
    np.testing.assert_allclose(t.abs().numpy(), np.asarray(j.abs()), atol=1e-6)
    _close(tcplx.stack([t, t], axis=-1), jcplx.stack([j, j], axis=-1), 0)
    _close(tcplx.concatenate([t, t], axis=1), jcplx.concatenate([j, j], axis=1), 0)
    pw = ((0, 0), (2, 0), (1, 3))
    _close(tcplx.pad(t, pw), jcplx.pad(j, pw), 0)
    theta = rng.standard_normal(7).astype(np.float32)
    _close(tcplx.expi(torch.from_numpy(theta)), jcplx.expi(jnp.asarray(theta)), 1e-6)
    _close(tcplx.cones((2, 2)), jcplx.cones((2, 2)), 0)
    _close(tcplx.const(np.array([1 + 2j, 3 - 1j])), jcplx.const(np.array([1 + 2j, 3 - 1j])), 0)
    base = tcplx.czeros((2, 3, 6))
    out = tcplx.scatter_set(base, (..., slice(0, 4)), t)
    _close(out, jcplx.scatter_set(jcplx.czeros((2, 3, 6)), (..., slice(0, 4)), j), 0)
    assert float(base.re.abs().sum()) == 0.0        # the base is left as it was
