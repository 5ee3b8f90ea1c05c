"""The decoder's half-iteration (ops.bcjr.bcjr_half and its plain version)
against the JAX package: each mode equal as floats under max-log to the same
half computed from the JAX "scan" BCJR and its QPP gathers; the int32 QPP
tables; and the wrapper on a CPU tensor."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu.coding import turbo as jturbo

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.coding import turbo as tturbo
from ofdm_lte_tpu_torch.ops import bcjr
from ofdm_lte_tpu_torch.sim import coded

torch.set_num_threads(2)


def _planes(rng, n, K):
    """L_sys, L_par (n, K+3) and a step-major extrinsic plane (K, n), float32."""
    ls, lp = ((rng.standard_normal((n, K + 3)) * 3.0).astype(np.float32) for _ in range(2))
    return ls, lp, (rng.standard_normal((K, n)) * 3.0).astype(np.float32)


def _jax_half(ls, lp, apr_body, hard):
    """The JAX package's half-iteration (ofdm_lte_tpu/coding/turbo.py:505-512)
    around its "scan" BCJR, max-log, from the a-priori (n, K) in this
    decoder's order: the extrinsic (n, K) or the hard bits."""
    apr = jnp.concatenate([apr_body, jnp.zeros(apr_body.shape[:-1] + (3,), jnp.float32)], -1)
    app = jturbo._bcjr(jnp.asarray(ls), jnp.asarray(lp), apr, impl="scan", use_max_log=True)
    K = apr_body.shape[-1]
    if hard:
        return np.asarray((app[..., :K] < 0).astype(jnp.int32))
    return np.asarray((app - apr - jnp.asarray(ls))[..., :K])


# a-priori of the half: the other decoder's extrinsic through π (decoder 2),
# through π⁻¹ (decoder 1), or the first iteration's zeros; output extrinsic
# or hard bits
CASES = [("pi", False), ("pi_inv", False), ("none", False), ("pi_inv", True), ("none", True)]


@pytest.mark.parametrize("K", [40, 1024])
@pytest.mark.parametrize("apriori,hard", CASES,
                         ids=["ext_pi", "ext_pi_inv", "ext_none", "hard_pi_inv", "hard_none"])
def test_bcjr_half_plain_equals_jax_half_as_floats(K, apriori, hard, rng):
    ls, lp, ext = _planes(rng, 3, K)
    perm, inv = tturbo.qpp_tables(K, "cpu")
    if apriori == "pi":
        body, index = jturbo.qpp_interleave(jnp.asarray(ext.T), K), perm
    elif apriori == "pi_inv":
        body, index = jturbo.qpp_deinterleave(jnp.asarray(ext.T), K), inv
    else:
        body, index = jnp.zeros((3, K), jnp.float32), inv
    got = bcjr.bcjr_half_plain(torch.from_numpy(ls), torch.from_numpy(lp),
                               None if apriori == "none" else torch.from_numpy(ext), index, hard)
    # the extrinsic is step-major (K, n), the bits block-major (n, K)
    assert got.dtype == (torch.int32 if hard else torch.float32)
    assert tuple(got.shape) == ((3, K) if hard else (K, 3)) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy() if hard else got.numpy().T,
                                  _jax_half(ls, lp, body, hard))


def test_bcjr_half_plain_null_apriori_is_a_zero_plane(rng):
    """A null a-priori reads +0.0 exactly, as a zero plane does: the same
    floats, and the same hard decisions at an APP of -0."""
    ls, lp, _ = _planes(rng, 2, 40)
    zeros = torch.zeros((40, 2))
    t = (torch.from_numpy(ls), torch.from_numpy(lp))
    for hard in (False, True):
        assert torch.equal(bcjr.bcjr_half_plain(*t, None, None, hard),
                           bcjr.bcjr_half_plain(*t, zeros, None, hard))
    app = bcjr.bcjr_plain(*t, torch.zeros((2, 43)))
    assert torch.equal(bcjr.bcjr_half_plain(*t, None, None, True), (app[:, :40] < 0).int())


def test_bcjr_half_plain_app_mode_is_bcjr_plain(rng):
    """The APP the half subtracts from is bcjr_app's on the same a-priori plane."""
    ls, lp, ext = _planes(rng, 2, 40)
    perm = tturbo.qpp_tables(40, "cpu")[0]
    t = (torch.from_numpy(ls), torch.from_numpy(lp))
    apr = torch.cat([torch.from_numpy(ext)[perm.long()].T, torch.zeros((2, 3))], -1)
    app = bcjr.bcjr_app(*t, apr)
    want = (app - apr - t[0])[:, :40].T
    assert torch.equal(bcjr.bcjr_half_plain(*t, torch.from_numpy(ext), perm), want)


@pytest.mark.parametrize("K", [40, 1024, 6144])
def test_int32_qpp_tables_equal_jax(K):
    perm, inv = tturbo.qpp_tables(K, "cpu")
    assert perm.dtype == inv.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), jturbo.qpp_indices(K))
    np.testing.assert_array_equal(inv.numpy(), jturbo.qpp_inverse_indices(K))


def test_coded_link_keeps_int32_qpp_buffers():
    link = coded.CodedLink(LTEConfig(5.0, modulation="QPSK"), 12000, device="cpu")
    for K, _ in link.groups:
        np.testing.assert_array_equal(link._t("qpp", K).numpy(), jturbo.qpp_indices(K))
        np.testing.assert_array_equal(link._t("qpp_inv", K).numpy(),
                                      jturbo.qpp_inverse_indices(K))
        assert link._t("qpp", K).dtype == link._t("qpp_inv", K).dtype == torch.int32


def test_bcjr_half_on_cpu_is_the_plain_version_and_launches_nothing(rng):
    ls, lp, ext = map(torch.from_numpy, _planes(rng, 2, 40))
    inv = tturbo.qpp_tables(40, "cpu")[1]
    before = (bcjr.bcjr_half.launches, bcjr.bcjr_app.launches)
    for hard in (False, True):
        for e in (None, ext):
            assert torch.equal(bcjr.bcjr_half(ls, lp, e, inv, hard, False),
                               bcjr.bcjr_half_plain(ls, lp, e, inv, hard, False))
    assert (bcjr.bcjr_half.launches, bcjr.bcjr_app.launches) == before


def test_turbo_decode_runs_2n_plus_1_halves(rng, monkeypatch):
    """The decode is 2·iterations + 1 half-iterations: decoder 1 reads
    decoder 2's extrinsic through π⁻¹, decoder 2 decoder 1's through π, the
    last one hard."""
    calls = []
    real = tturbo.bcjr_half

    def spy(ls, lp, ext, index, hard=False, use_max_log=True):
        calls.append((ext is None, index.numpy().tolist(), hard))
        return real(ls, lp, ext, index, hard, use_max_log)

    monkeypatch.setattr(tturbo, "bcjr_half", spy)
    llr = torch.from_numpy((rng.standard_normal((2, 3 * 40 + 12)) * 4).astype(np.float32))
    tturbo.turbo_decode(llr, 40, 3)
    pi, pi_inv = (t.tolist() for t in (jturbo.qpp_indices(40), jturbo.qpp_inverse_indices(40)))
    assert calls == [(True, pi_inv, False), (False, pi, False), (False, pi_inv, False),
                     (False, pi, False), (False, pi_inv, False), (False, pi, False),
                     (False, pi_inv, True)]
