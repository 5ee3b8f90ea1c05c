"""The batched coded chain against the JAX package under the JAX package's
own draws (its AWGN noise, fed through the `draws` seam): the coded stream
bit for bit, the LLRs within GEMM rounding, and the decoded bits and CRC
outcomes at SNRs where the decode converges. 5 MHz QPSK, 2 lanes, a
1,000-bit transport block (one block of K 1024, 8 iterations) and a
12,000-bit one (two blocks, K 6016 and 6080, 2 iterations)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu.sim import coded as jcoded

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.grid import grid_for
from ofdm_lte_tpu_torch.sim import coded as tcoded

torch.set_num_threads(2)

JCFG, CFG = jcfg.LTEConfig(5.0, modulation="QPSK"), LTEConfig(5.0, modulation="QPSK")
CASES = {1000: 8, 12000: 2}          # transport-block bits -> decoder iterations
# the LLRs differ by the GEMMs' fp32 rounding (the CPU plain products against
# XLA's dots), amplified by ZF where |Ĥ| is small: this share of max|LLR|
LLR_TOL = 1e-4


def samples(link) -> int:
    """Samples of one transmission's signal."""
    n_sym = -(-link.coded_len // CFG.bits_per_symbol)
    return -(-n_sym // grid_for(CFG).num_data) * CFG.samples_per_ofdm_symbol


def jax_noise(key, shape):
    """What the JAX package's awgn(key, ...) draws, as the `noise` seam."""
    kr, ki = jax.random.split(key)
    return (np.array(jax.random.normal(kr, shape, jnp.float32)),
            np.array(jax.random.normal(ki, shape, jnp.float32)))


def _bits(n, lanes=2, seed=0):
    return np.random.default_rng(seed).integers(0, 2, (lanes, n)).astype(np.int32)


@pytest.mark.parametrize("n", list(CASES))
def test_layout_and_tables(n):
    link = tcoded.link_for(CFG, n, "cpu")
    sizes = [K for K, m in link.groups for _ in range(m)]
    assert sizes == ([1024] if n == 1000 else [6016, 6080])
    assert link.coded_len == sum(3 * K + 12 for K in sizes)
    assert all(b.device.type == "cpu" for b in link.buffers())
    assert tcoded.link_for(CFG, n, "cpu") is link           # kept


@pytest.mark.parametrize("n", list(CASES))
def test_coded_stream_and_llrs_match_jax(n):
    bits = _bits(n)
    link = tcoded.link_for(CFG, n, "cpu")
    lay = jcoded.segmentation.segment_layout(n + 24)
    jtb = jnp.concatenate([jnp.asarray(bits), jcoded.crc.crc_jax(jnp.asarray(bits))], axis=-1)
    blk, groups = jcoded._blocks_from_tb(jtb, lay, (2,))
    for rv in (0, 2):
        want = np.asarray(jcoded._rate_match_groups(jcoded._turbo_encode_groups(blk, groups),
                                                     groups, lay, rv))
        got = link.rate_match(link.encode(link.blocks(torch.from_numpy(bits))), rv)
        np.testing.assert_array_equal(got.numpy(), want)
    key = jax.random.PRNGKey(5)
    j_llr, j_papr = jcoded._link_llrs(key, jnp.asarray(want), link.coded_len, 3.0, JCFG,
                                      "awgn", "Pedestrian_A", None)
    t_llr, t_papr, _ = link.link_llrs(got, 3.0, draws={"noise": jax_noise(key, (2, samples(link)))})
    j_llr = np.asarray(j_llr)
    assert t_llr.shape == j_llr.shape == (2, link.coded_len)
    assert np.abs(t_llr.numpy() - j_llr).max() <= LLR_TOL * np.abs(j_llr).max()
    np.testing.assert_allclose(t_papr.numpy(), np.asarray(j_papr), atol=1e-4)


@pytest.mark.parametrize("n", list(CASES))
def test_batched_chain_matches_jax(n):
    bits, key = _bits(n, seed=1), jax.random.PRNGKey(11)
    link = tcoded.link_for(CFG, n, "cpu")
    # lane 0 at 5 dB, past the waterfall; lane 1 at -3 dB, where CRC fails
    snr = np.array([5.0, -3.0], np.float32)
    j = jcoded.simulate_siso_coded_batched(key, jnp.asarray(bits), jnp.asarray(snr), JCFG,
                                           num_iterations=CASES[n])
    t = tcoded.simulate_siso_coded_batched(torch.from_numpy(bits), torch.from_numpy(snr), CFG,
                                           num_iterations=CASES[n], device="cpu",
                                           draws={"noise": jax_noise(key, (2, samples(link)))})
    assert isinstance(t, tcoded.CodedBatchResult)
    assert t.crc_pass.tolist() == np.asarray(j.crc_pass).tolist() == [True, False]
    np.testing.assert_array_equal(t.bits_rx[0].numpy(), np.asarray(j.bits_rx)[0])
    assert int(t.bit_errors[0]) == 0 and int(t.bit_errors[1]) > 0
    assert t.bits_rx.dtype == torch.int32 and t.ber.dtype == torch.float32
    np.testing.assert_allclose(t.papr_db.numpy(), np.asarray(j.papr_db), atol=1e-4)


def test_rv_and_decoder_mode_reach_the_chain():
    n, key = 1000, jax.random.PRNGKey(13)
    bits = _bits(n, seed=2)
    link = tcoded.link_for(CFG, n, "cpu")
    draws = {"noise": jax_noise(key, (2, samples(link)))}
    for rv, max_log in ((3, False), (1, True)):
        j = jcoded.simulate_siso_coded_batched(key, jnp.asarray(bits), 5.0, JCFG, rv=rv,
                                               use_max_log=max_log)
        t = link(torch.from_numpy(bits), 5.0, rv=rv, use_max_log=max_log, draws=draws)
        np.testing.assert_array_equal(t.bits_rx.numpy(), np.asarray(j.bits_rx))
        assert t.crc_pass.tolist() == np.asarray(j.crc_pass).tolist() == [True, True]


def test_bits_must_fit_the_link():
    link = tcoded.link_for(CFG, 1000, "cpu")
    with pytest.raises(ValueError, match="1000-bit"):
        link(torch.zeros((2, 999), dtype=torch.int32), 5.0)


@pytest.mark.parametrize("entry", ["CodedLink", "simulate_siso_coded_batched",
                                   "simulate_siso_coded_harq_batched", "simulate_siso_coded",
                                   "simulate_siso_coded_harq", "ber_sweep", "harq_sweep"])
def test_coded_entry_points_take_the_card_or_raise(entry, monkeypatch):
    """With no device given and no card every coded entry point raises; it
    never carries on on the CPU."""
    from ofdm_lte_tpu_torch.parallel import sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bits = np.zeros((1, 40), np.int32)
    calls = {
        "CodedLink": lambda: tcoded.CodedLink(CFG, 40),
        "simulate_siso_coded_batched": lambda: tcoded.simulate_siso_coded_batched(
            torch.from_numpy(bits), 30.0, CFG),
        "simulate_siso_coded_harq_batched": lambda: tcoded.simulate_siso_coded_harq_batched(
            torch.from_numpy(bits), 30.0, CFG),
        "simulate_siso_coded": lambda: tcoded.simulate_siso_coded(bits[0], 30.0, CFG),
        "simulate_siso_coded_harq": lambda: tcoded.simulate_siso_coded_harq(bits[0], 30.0, CFG),
        "ber_sweep": lambda: sweep.ber_sweep(CFG, [30.0], frames=1, pipeline="coded",
                                             coded_tb_bits=40),
        "harq_sweep": lambda: sweep.harq_sweep(CFG, [30.0], frames=1, tb_bits=40),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
