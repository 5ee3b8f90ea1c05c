"""The small-matrix algebra of the port's cplx.py against ofdm_lte_tpu.cplx on
the same NumPy inputs, 1e-5 relative: `solve` in its closed forms (n = 1 to
4) and through the real embedding (n = 6, matrix right-hand sides),
`matmul_small`, `einsum`, `take_along`, `vdot`, `where`, `scatter_add`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import cplx as jcplx

from ofdm_lte_tpu_torch import cplx as tcplx

torch.set_num_threads(2)


def _pair(rng, shape):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return jcplx.from_numpy(x), tcplx.from_numpy(x)


def _close(t, j, rel=1e-5):
    assert tuple(t.shape) == tuple(j.shape)
    jn = np.asarray(j.re) + 1j * np.asarray(j.im)
    np.testing.assert_allclose(t.to_numpy(), jn, rtol=0, atol=rel * np.abs(jn).max())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_solve_vector_rhs_matches_jax(n, rng):
    a = rng.standard_normal((5, 7, n, n)) + 1j * rng.standard_normal((5, 7, n, n))
    a = a + 3 * np.eye(n)                                   # well conditioned
    b = rng.standard_normal((5, 7, n)) + 1j * rng.standard_normal((5, 7, n))
    t = tcplx.solve(tcplx.from_numpy(a), tcplx.from_numpy(b))
    _close(t, jcplx.solve(jcplx.from_numpy(a), jcplx.from_numpy(b)))
    np.testing.assert_allclose(t.to_numpy(), np.linalg.solve(a, b[..., None])[..., 0],
                               atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_solve_matrix_rhs_matches_jax(n, rng):
    a = rng.standard_normal((6, n, n)) + 1j * rng.standard_normal((6, n, n)) + 3 * np.eye(n)
    b = rng.standard_normal((6, n, 3)) + 1j * rng.standard_normal((6, n, 3))
    _close(tcplx.solve(tcplx.from_numpy(a), tcplx.from_numpy(b)),
           jcplx.solve(jcplx.from_numpy(a), jcplx.from_numpy(b)))


def test_solve_closed_forms_reach_no_library(rng, monkeypatch):
    """n ≤ 4 with a vector right-hand side never reaches torch.linalg or a
    library matmul."""
    def boom(*a, **k):
        raise AssertionError("library call")
    monkeypatch.setattr(torch.linalg, "solve", boom)
    monkeypatch.setattr(torch, "matmul", boom)
    for n in (1, 2, 3, 4):
        _, a = _pair(rng, (3, n, n))
        _, b = _pair(rng, (3, n))
        assert tcplx.solve(a, b).shape == (3, n)
    _, a = _pair(rng, (3, 2, 4))
    _, b = _pair(rng, (3, 4, 2))
    assert tcplx.matmul_small(a, b).shape == (3, 2, 2)


@pytest.mark.parametrize("sa,sb", [((4, 2), (5, 3, 2, 9)), ((5, 3, 2, 4), (5, 3, 4, 2)),
                                   ((7, 1, 4, 4), (6, 4, 3))])
def test_matmul_small_matches_jax(sa, sb, rng):
    ja, ta = _pair(rng, sa)
    jb, tb = _pair(rng, sb)
    t = tcplx.matmul_small(ta, tb)
    _close(t, jcplx.matmul_small(ja, jb))
    np.testing.assert_allclose(t.to_numpy(), ta.to_numpy() @ tb.to_numpy(), atol=1e-5)


def test_einsum_matches_jax_and_rejects_other_specs(rng):
    jH, tH = _pair(rng, (6, 5, 2, 4))
    jcb, tcb = _pair(rng, (16, 4, 2))
    spec = "...rt,ptl->...prl"
    t = tcplx.einsum(spec, tH, tcb)
    _close(t, jcplx.einsum(spec, jH, jcb))
    assert t.shape == (6, 5, 16, 2, 2)
    with pytest.raises(NotImplementedError, match="ij,jk->ik"):
        tcplx.einsum("ij,jk->ik", tH, tcb)


def test_take_along_vdot_where_scatter_add_match_jax(rng):
    jx, tx = _pair(rng, (4, 6, 3))
    idx = rng.integers(0, 3, (4, 6))
    _close(tcplx.take_along(tx, torch.from_numpy(idx)), jcplx.take_along(jx, jnp.asarray(idx)))
    idx1 = rng.integers(0, 6, (4, 3))
    _close(tcplx.take_along(tx, torch.from_numpy(idx1), axis=1),
           jcplx.take_along(jx, jnp.asarray(idx1), axis=1))
    jy, ty = _pair(rng, (4, 6, 3))
    _close(tcplx.vdot(tx, ty), jcplx.vdot(jx, jy))
    _close(tcplx.vdot(tx, ty, axis=1, keepdims=True), jcplx.vdot(jx, jy, axis=1, keepdims=True))
    mask = rng.integers(0, 2, (4, 6, 3)).astype(bool)
    _close(tcplx.where(torch.from_numpy(mask), tx, ty), jcplx.where(jnp.asarray(mask), jx, jy), 0)
    rows = np.array([0, 2, 2, 3])
    jv, tv = _pair(rng, (4, 6, 3))
    _close(tcplx.scatter_add(tx, rows, tv), jcplx.scatter_add(jx, jnp.asarray(rows), jv))


def test_from_numpy_takes_planar_pairs_of_either_package(rng):
    jx, tx = _pair(rng, (3, 4))
    for given in (jx, tx):
        back = tcplx.from_numpy(given)
        assert torch.equal(back.re, tx.re) and torch.equal(back.im, tx.im)
    real = tcplx.from_numpy(np.ones((2, 2)))
    assert real.im.abs().sum() == 0 and real.re.dtype == torch.float32
