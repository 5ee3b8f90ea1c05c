"""HARQ and the host paths of the coded chain against the JAX package under
its own draws (a leading axis of transmissions in the `draws` seam): the
batched HARQ's decoded bits, crc_pass_stage and num_transmissions, the host
single-TB chain and the host HARQ loop with its early break, and the
batched HARQ against the host loop on the same draws. 5 MHz QPSK, the
1,000-bit (8 iterations) and 12,000-bit (2 iterations) transport blocks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu.sim import coded as jcoded

from ofdm_lte_tpu_torch.sim import coded as tcoded

from test_torch_coded import CASES, CFG, JCFG, jax_noise, samples

torch.set_num_threads(2)

# per lane: stage 1 fails, and the lane passes at stage 2 or 3 (JAX package)
HARQ_SNR = {1000: [-1.0, 1.0], 12000: [0.0, 1.0]}


def harq_draws(key, link, lanes, T=4):
    """The noise of the JAX package's HARQ: transmission t under fold_in(key, t)."""
    shape = (lanes, samples(link)) if lanes else (samples(link),)
    per_t = [jax_noise(jax.random.fold_in(key, t), shape) for t in range(T)]
    return {"noise": tuple(np.stack([d[part] for d in per_t]) for part in (0, 1))}


@pytest.mark.parametrize("n", list(CASES))
def test_batched_harq_matches_jax(n):
    bits = np.random.default_rng(3).integers(0, 2, (2, n)).astype(np.int32)
    key, snr = jax.random.PRNGKey(17), np.asarray(HARQ_SNR[n], np.float32)
    link = tcoded.link_for(CFG, n, "cpu")
    j = jcoded.simulate_siso_coded_harq_batched(key, jnp.asarray(bits), jnp.asarray(snr), JCFG,
                                                num_iterations=CASES[n])
    t = tcoded.simulate_siso_coded_harq_batched(
        torch.from_numpy(bits), torch.from_numpy(snr), CFG, num_iterations=CASES[n],
        device="cpu", draws=harq_draws(key, link, 2))
    assert isinstance(t, tcoded.HarqBatchResult)
    stages = np.asarray(j.crc_pass_stage)
    assert not stages[:, 0].any() and stages[:, -1].all()     # the case is what it says
    np.testing.assert_array_equal(t.crc_pass_stage.numpy(), stages)
    np.testing.assert_array_equal(t.num_transmissions.numpy(), np.asarray(j.num_transmissions))
    np.testing.assert_array_equal(t.bits_rx.numpy(), np.asarray(j.bits_rx))
    assert t.crc_pass.all() and int(t.bit_errors.sum()) == 0
    assert t.num_transmissions.dtype == torch.int32
    np.testing.assert_allclose(t.papr_db.numpy(), np.asarray(j.papr_db), atol=1e-4)


def test_batched_harq_latches_and_freezes():
    """A lane that never passes keeps the last stage's decode and counts T;
    a clean lane passes at stage 1; the stages are cumulative."""
    n = 1000
    bits = np.random.default_rng(4).integers(0, 2, (2, n)).astype(np.int32)
    r = tcoded.simulate_siso_coded_harq_batched(
        torch.from_numpy(bits), torch.tensor([30.0, -10.0]), CFG, rv_sequence=(0, 1, 3),
        device="cpu", generator=torch.Generator().manual_seed(5))
    assert r.crc_pass_stage.tolist() == [[True, True, True], [False, False, False]]
    assert r.num_transmissions.tolist() == [1, 3] and r.crc_pass.tolist() == [True, False]
    assert int(r.bit_errors[0]) == 0 and int(r.bit_errors[1]) > 0


@pytest.mark.parametrize("n", list(CASES))
def test_host_chain_matches_jax(n):
    bits = np.random.default_rng(5).integers(0, 2, n).astype(np.uint8)
    key = jax.random.PRNGKey(19)
    link = tcoded.link_for(CFG, n, "cpu")
    j = jcoded.simulate_siso_coded(key, bits, 5.0, JCFG, num_iterations=CASES[n])
    t = tcoded.simulate_siso_coded(bits, 5.0, CFG, num_iterations=CASES[n], device="cpu",
                                   draws={"noise": jax_noise(key, (samples(link),))})
    assert isinstance(t, tcoded.CodedResult)
    assert t.crc_pass == j.crc_pass is True and t.bit_errors == j.bit_errors == 0
    np.testing.assert_array_equal(t.bits_rx, j.bits_rx)
    assert t.coded_bits_length == j.coded_bits_length == link.coded_len
    assert abs(t.papr_db - j.papr_db) < 1e-4 and abs(t.channel_snr_db - j.channel_snr_db) < 1e-3


@pytest.mark.parametrize("n", list(CASES))
def test_host_harq_matches_jax_and_breaks_at_the_first_pass(n):
    bits = np.random.default_rng(6).integers(0, 2, n).astype(np.uint8)
    key = jax.random.PRNGKey(23)
    link = tcoded.link_for(CFG, n, "cpu")
    snr = HARQ_SNR[n][0]
    j = jcoded.simulate_siso_coded_harq(key, bits, snr, JCFG, num_iterations=CASES[n])
    t = tcoded.simulate_siso_coded_harq(bits, snr, CFG, num_iterations=CASES[n], device="cpu",
                                        draws=harq_draws(key, link, 0))
    assert isinstance(t, tcoded.HarqResult)
    assert t.crc_history == j.crc_history and t.crc_history[-1] is True
    assert 1 < t.num_transmissions == j.num_transmissions < 4
    assert t.rv_history == j.rv_history
    np.testing.assert_array_equal(t.bits_rx, j.bits_rx)


def test_batched_harq_equals_the_host_loop_on_the_same_draws():
    n = 1000
    bits = np.random.default_rng(7).integers(0, 2, (2, n)).astype(np.int32)
    link = tcoded.link_for(CFG, n, "cpu")
    rng = np.random.default_rng(8)
    noise = (rng.standard_normal((4, 2, samples(link))), rng.standard_normal((4, 2, samples(link))))
    snr = [-1.0, 1.0]
    batched = link.harq(torch.from_numpy(bits), torch.tensor(snr), draws={"noise": noise})
    for lane in range(2):
        host = tcoded.simulate_siso_coded_harq(
            bits[lane], snr[lane], CFG, device="cpu",
            draws={"noise": (noise[0][:, lane], noise[1][:, lane])})
        T = host.num_transmissions
        assert int(batched.num_transmissions[lane]) == T
        assert batched.crc_pass_stage[lane, :T].tolist() == list(host.crc_history)
        np.testing.assert_array_equal(batched.bits_rx[lane].numpy(), host.bits_rx)
