"""The MIMO stack's tables and host-side decisions, element-exact against
the JAX package: TM6/TM4 codebooks (all 11 antenna/mode/rank combinations),
the layer mapper, rank adaptation, the union pilot values of the spatial
link, and the delay-domain tap-basis projection of the extended CRS layout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.grid import grid_for
from ofdm_lte_tpu.mimo import codebook as jcb
from ofdm_lte_tpu.mimo import layer_mapper as jlm
from ofdm_lte_tpu.mimo import rank_adaptation as jra
from ofdm_lte_tpu.rx import mimo_estimation as jmest
from ofdm_lte_tpu.sim import spatial as jsp

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.mimo import codebook as tcb
from ofdm_lte_tpu_torch.mimo import layer_mapper as tlm
from ofdm_lte_tpu_torch.mimo import rank_adaptation as tra
from ofdm_lte_tpu_torch.rx import mimo_estimation as tmest
from ofdm_lte_tpu_torch.sim import spatial as tsp

torch.set_num_threads(2)

BOOKS = [(2, "TM6", 1), (4, "TM6", 1), (8, "TM6", 1), (2, "TM4", 1), (2, "TM4", 2),
         (4, "TM4", 2), (4, "TM4", 3), (4, "TM4", 4), (8, "TM4", 2), (8, "TM4", 3),
         (8, "TM4", 4)]


@pytest.mark.parametrize("num_tx,mode,rank", BOOKS)
def test_codebook_equal(num_tx, mode, rank):
    j, t = jcb.codebook(num_tx, mode, rank), tcb.codebook(num_tx, mode, rank)
    np.testing.assert_array_equal(t, j)
    assert tcb.codebook_size(num_tx, mode, rank) == len(j)
    np.testing.assert_array_equal(tcb.get_precoder(len(j) - 1, num_tx, mode, rank), j[-1])
    with pytest.raises(ValueError):
        tcb.get_precoder(len(j), num_tx, mode, rank)


def test_codebook_rejects_what_jax_rejects():
    for args in ((4, "TM6", 2), (2, "TM4", 3), (4, "TM4", 5), (3, "TM4", 1)):
        with pytest.raises(ValueError):
            jcb.codebook(*args)
        with pytest.raises(ValueError):
            tcb.codebook(*args)


@pytest.mark.parametrize("num_tx,mode,rank", [(2, "TM6", 1), (4, "TM4", 2), (8, "TM4", 4)])
@pytest.mark.parametrize("metric", ["capacity", "frobenius"])
def test_select_best_pmi_matches_jax(num_tx, mode, rank, metric, rng):
    H = rng.standard_normal((9, 5, 2, num_tx)) + 1j * rng.standard_normal((9, 5, 2, num_tx))
    jp, jbest = jcb.select_best_pmi(jcplx.from_numpy(H), num_tx, mode, rank, metric)
    tp, tbest = tcb.select_best_pmi(tcplx.from_numpy(H), num_tx, mode, rank, metric)
    assert tp.dtype == torch.int32
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), rtol=1e-5)
    # the 4-TX rank-2 book holds precoders that differ by a unitary mixing of
    # the layers (PMI i+8 and i+12): their powers tie exactly and rounding
    # picks; everywhere else the PMIs are equal
    book = jcb.codebook(num_tx, mode, rank)
    power = np.sum(np.abs(H[..., None, :, :] @ book) ** 2, axis=(-2, -1))
    differ = tp.numpy() != np.asarray(jp)
    if (num_tx, rank) != (4, 2):
        assert not differ.any()
    picked = np.take_along_axis(power, tp.numpy()[..., None].astype(np.int64), -1)[..., 0]
    np.testing.assert_allclose(picked, power.max(axis=-1), rtol=1e-6)
    jp = jnp.asarray(tp.numpy())
    W = tcb.precoder_for_pmi(tp, num_tx, mode, rank)
    jW = jcb.precoder_for_pmi(jp, num_tx, mode, rank)
    np.testing.assert_array_equal(W.re.numpy(), np.asarray(jW.re))
    np.testing.assert_array_equal(W.im.numpy(), np.asarray(jW.im))
    with pytest.raises(ValueError):
        tcb.select_best_pmi(tcplx.from_numpy(H), num_tx, mode, rank, "nope")


def test_select_best_pmi_tie_goes_to_the_first(rng):
    """H = 0 makes every precoder's power equal: PMI 0 in both packages."""
    H = np.zeros((3, 2, 4))
    jp, _ = jcb.select_best_pmi(jcplx.from_numpy(H), 4, "TM4", 2)
    tp, _ = tcb.select_best_pmi(tcplx.from_numpy(H), 4, "TM4", 2)
    assert tp.tolist() == np.asarray(jp).tolist() == [0, 0, 0]
    assert tcb.quantization_error(rng.standard_normal((3, 4)) + 0j, 5, 4) == \
        jcb.quantization_error(np.random.default_rng(1234).standard_normal((3, 4)) + 0j, 5, 4)


@pytest.mark.parametrize("layers", [1, 2, 3, 4])
def test_layer_mapper_equal(layers, rng):
    n = 50
    padded = tlm.padded_length(n, layers)
    assert padded == jlm.padded_length(n, layers) and padded % layers == 0
    x = rng.standard_normal((3, 2, padded)) + 1j * rng.standard_normal((3, 2, padded))
    j = jlm.map_to_layers(jcplx.from_numpy(x), layers)
    t = tlm.map_to_layers(tcplx.from_numpy(x), layers)
    assert t.shape == (3, 2, layers, padded // layers)
    np.testing.assert_array_equal(t.re.numpy(), np.asarray(j.re))
    np.testing.assert_array_equal(t.im.numpy(), np.asarray(j.im))
    back = tlm.demap_from_layers(t, original_length=n)
    jback = jlm.demap_from_layers(j, original_length=n)
    np.testing.assert_array_equal(back.re.numpy(), np.asarray(jback.re))
    np.testing.assert_array_equal(back.to_numpy(), x[..., :n].astype(np.complex64))


@pytest.mark.parametrize("num_tx,num_rx", [(2, 2), (4, 2), (4, 4), (8, 4)])
def test_rank_adaptation_equal(num_tx, num_rx, rng):
    for snr in (2.0, 7.0, 15.0, 30.0):
        H = (rng.standard_normal((num_rx, num_tx))
             + 1j * rng.standard_normal((num_rx, num_tx))) / np.sqrt(2 * num_tx)
        for method in ("eigenvalue", "capacity"):
            assert tra.optimal_rank(H, snr, method=method) == jra.optimal_rank(H, snr,
                                                                                method=method)
        j, t = jra.get_feedback(H, snr), tra.get_feedback(H, snr)
        assert (t["ri"], t["pmi"], t["condition_number"]) == \
            (j["ri"], j["pmi"], j["condition_number"])
        np.testing.assert_array_equal(t["W"], j["W"])
        np.testing.assert_array_equal(t["eigenvalues"], j["eigenvalues"])
        for metric in ("capacity", "frobenius", "sinr"):
            jp, jW = jra.select_precoder_for_rank(H, 2, snr, metric)
            tp, tW = tra.select_precoder_for_rank(H, 2, snr, metric)
            assert jp == tp
            np.testing.assert_array_equal(tW, jW)
    H3 = np.stack([H, H], axis=2)
    assert tra.optimal_rank(H3, 20.0) == jra.optimal_rank(H3, 20.0)
    with pytest.raises(ValueError):
        tra.optimal_rank(H, 10.0, method="nope")


@pytest.mark.parametrize("num_tx,layout", [(2, "reference"), (4, "reference"),
                                           (8, "reference"), (8, "extended")])
def test_union_pilot_values_equal(num_tx, layout):
    jc = jcfg.LTEConfig(5.0)
    j = jsp._pilot_bin_union_values(jc.N, jc.Nc, num_tx, layout)
    t = tsp._pilot_bin_union_values(jc.N, jc.Nc, num_tx, layout)
    assert len(t) == num_tx
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    union = np.sum([np.abs(v) > 0 for v in t], axis=0)
    assert union.max() == (2 if (num_tx, layout) == (8, "reference") else 1)
    assert tsp.bits_per_frame(LTEConfig(5.0, modulation="16-QAM"), 3) == \
        jsp.bits_per_frame(jcfg.LTEConfig(5.0, modulation="16-QAM"), 3)


@pytest.mark.parametrize("bw,num_taps", [(5.0, None), (10.0, None), (5.0, 5)])
def test_tap_basis_projection_equal(bw, num_taps):
    jc = jcfg.LTEConfig(bw)
    g = grid_for(jc)
    idx = tuple(int(b) for b in g.pilot_idx[3::8])
    out = tuple(int(b) for b in g.data_idx[:120])
    j = jmest._tap_basis_projection(idx, out, jc.N, num_taps)
    t = tmest._tap_basis_projection(idx, out, jc.N, num_taps)
    np.testing.assert_array_equal(t, j)
    assert t.shape == (len(idx), 120) and t.dtype == np.complex64 and t.flags.c_contiguous


@pytest.mark.parametrize("num_tx,layout", [(4, "extended"), (8, "extended"), (8, "reference")])
def test_estimate_per_tx_layouts_match_jax(num_tx, layout, rng):
    jc, tc = jcfg.LTEConfig(5.0), LTEConfig(5.0)
    g = grid_for(jc)
    out = g.data_idx[:100]
    p = rng.standard_normal((2, 3, g.num_pilot)) + 1j * rng.standard_normal((2, 3, g.num_pilot))
    j = jmest.estimate_per_tx(jcplx.from_numpy(p), jc, num_tx, out, layout)
    tables = tmest.per_tx_tables(tc, num_tx, out, layout, device="cpu")
    assert all((e.basis is not None) == (layout == "extended" and num_tx > 4) for e in tables)
    for tab in (None, tables):
        t = tmest.estimate_per_tx(tcplx.from_numpy(p), tc, num_tx, out, layout, tab)
        assert t.shape == (2, 3, num_tx, 100)
        np.testing.assert_allclose(t.to_numpy(), np.asarray(j.re) + 1j * np.asarray(j.im),
                                   atol=2e-5)
