"""The plain coded reference (reference/lte_coded.py) against textbook
forms and against the port on the CPU at a small size (a 1,000-bit
transport block: one code block of K = 1,024; 2 points × 4 frames; rv
0-3; the harness's seeded draws), and the runner on a tiny HARQ cell:
correct as the port stands, not correct with each of harness/faults.py's
faults planted under its timed path."""
import json
import textwrap

import numpy as np
import pytest
import torch

from harness import core
from pb_helpers import BENCH, TINY_HARQ, TINY_HARQ_LIMITS, run_cpu, tiny_checkout

REF = core.load_module(BENCH / "reference" / "lte_coded.py", "t_lte_coded")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("pbc"))


@pytest.fixture(scope="module")
def small(checkout):
    """The tiny cell, one call's seeded draws, and the port's CodedLink."""
    from ofdm_lte_tpu_torch import LTEConfig
    from ofdm_lte_tpu_torch.sim import coded
    cell = core.Cell("t_harq", checkout)
    shape = cell.shape()
    arrays = cell.entry.call_inputs(shape, 2 ** 35 + 11, 0, 0, "cpu")
    cfg = LTEConfig(cell.config["bandwidth_mhz"], modulation=cell.config["modulation"])
    return cell, shape, arrays, coded.CodedLink(cfg, shape.tb_bits, device="cpu")


def crc_long_division(bits, poly, L=24):
    """The textbook CRC: the message times x^L divided by g(x), bit by bit."""
    reg = list(bits) + [0] * L
    g = [(poly >> (L - i)) & 1 for i in range(L + 1)]
    for i in range(len(bits)):
        if reg[i]:
            for j in range(L + 1):
                reg[i + j] ^= g[j]
    return reg[-L:]


@pytest.mark.parametrize("n", [1, 40, 1000, 5800])
def test_crc_is_the_remainder_of_the_division(n):
    from ofdm_lte_tpu_torch.coding import crc as port_crc
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (3, n))
    got = REF.crc(torch.as_tensor(bits), REF.CRC24A).numpy()
    for row, c in zip(bits, got):
        assert c.tolist() == crc_long_division(row.tolist(), REF.CRC24A)
        assert c.tolist() == port_crc.crc_bits_plain(row, REF.CRC24A, 24).tolist()
    assert REF.crc(torch.as_tensor(bits), REF.CRC24B)[0].tolist() == crc_long_division(
        bits[0].tolist(), REF.CRC24B)


@pytest.mark.parametrize("tb,C,K", [(75376, 13, 5824), (1000, 1, 1024), (6120, 1, 6144)])
def test_segmentation_of_the_cells(tb, C, K):
    from ofdm_lte_tpu_torch.coding import segmentation
    seg = REF.segmentation(tb + 24)
    assert (seg["C"], seg["sizes"], seg["F"]) == (C, [K] * C, 0)
    assert seg["sizes"] == segmentation.segment_layout(tb + 24)["sizes"]


def test_blocks_code_and_rate_matching_equal_the_ports(small):
    cell, shape, arrays, link = small
    bits = arrays["bits"].reshape(-1, shape.tb_bits)
    chain = REF.Chain(cell.config, shape.tb_bits)
    tb = torch.cat([bits.long(), REF.crc(bits, REF.CRC24A)], dim=1)
    blocks = link.blocks(bits)
    assert torch.equal(blocks[1024].reshape(-1, 1024).long(), REF.code_blocks(tb, chain.seg)[0])
    enc = link.encode(blocks)
    ref_enc = chain.encode(bits)
    assert torch.equal(enc[1024], ref_enc[0].to(torch.int32))
    for rv in range(4):
        assert torch.equal(link.rate_match(enc, rv), chain.rate_match(ref_enc, rv).to(torch.int32))


def test_bit_sliced_encoder_is_the_step_by_step_one():
    rng = np.random.default_rng(3)
    c = rng.integers(0, 2, (13, 40)).astype(np.uint8)       # 13 blocks: a partial byte
    a, z = REF.rsc(c)
    for blk in range(13):
        s0 = s1 = s2 = 0
        for k in range(43):
            fb = (int(c[blk, k]) ^ s1 ^ s2) if k < 40 else 0
            assert (a[blk, k], z[blk, k]) == (fb, fb ^ s0 ^ s2)
            s0, s1, s2 = fb, s0, s1


def bcjr_step_by_step(l_sys, l_par, l_apr):
    """The textbook max-log BCJR, one trellis step at a time, in float64."""
    n, kp = l_sys.shape
    ns, sys_out, par_out = np.zeros((8, 2), int), np.zeros((8, 2), int), np.zeros((8, 2), int)
    for s in range(8):
        s0, s1, s2 = s >> 2, (s >> 1) & 1, s & 1
        for c in range(2):
            a = c ^ s1 ^ s2
            ns[s, c], sys_out[s, c], par_out[s, c] = (a << 2) | (s >> 1), a, a ^ s0 ^ s2
    g = 0.5 * (l_sys[..., None, None] * (1 - 2 * sys_out) + l_par[..., None, None]
               * (1 - 2 * par_out) + l_apr[..., None, None] * np.array([1.0, -1.0]))
    alpha = np.full((n, kp + 1, 8), -np.inf)
    beta = np.full((n, kp + 1, 8), -np.inf)
    alpha[:, 0, 0] = beta[:, kp, 0] = 0.0
    for k in range(kp):
        for s in range(8):
            for c in range(2):
                alpha[:, k + 1, ns[s, c]] = np.maximum(alpha[:, k + 1, ns[s, c]],
                                                       alpha[:, k, s] + g[:, k, s, c])
    for k in range(kp - 1, -1, -1):
        beta[:, k] = np.max(g[:, k] + beta[:, k + 1][:, ns], axis=-1)
    val = alpha[:, :kp, :, None] + g + beta[:, 1:][:, :, ns]
    return val[..., 0].max(-1) - val[..., 1].max(-1)


@pytest.mark.parametrize("kp,chunk", [(67, 8), (67, 64), (64, 8), (11, 64), (131, 16)])
def test_chunked_bcjr_is_the_step_by_step_recursion(kp, chunk, monkeypatch):
    monkeypatch.setattr(REF, "CHUNK", chunk)
    rng = np.random.default_rng(kp + chunk)
    ls, lp, la = (rng.normal(0, 4, (5, kp)) for _ in range(3))
    want = bcjr_step_by_step(ls, lp, la)
    got = REF.bcjr(*(torch.as_tensor(x) for x in (ls, lp, la))).numpy()
    assert np.abs(got - want).max() < 1e-9 * max(1.0, np.abs(want).max())


def test_bcjr_agrees_with_the_ports_plain_pass():
    from ofdm_lte_tpu_torch.ops.bcjr import bcjr_plain
    g = torch.Generator().manual_seed(5)
    ls, lp, la = (torch.randn(4, 1027, generator=g) * 3 for _ in range(3))
    want = REF.bcjr(ls.double(), lp.double(), la.double())
    got = bcjr_plain(ls, lp, la).double()
    # fp32 metrics of up to some 1e4 in the port: rounding of a few 1e-3
    assert (got - want).abs().max() < 1e-2 and (got > 0).eq(want > 0).float().mean() > 0.999


def test_llrs_equal_the_ports(small):
    cell, shape, arrays, link = small
    bits = arrays["bits"].reshape(-1, shape.tb_bits)
    chain = REF.Chain(cell.config, shape.tb_bits)
    snr = torch.tensor(np.repeat(np.float32(cell.traffic["snr_db"]), shape.frames))
    enc, ref_enc = link.encode(link.blocks(bits)), chain.encode(bits)
    for t, rv in enumerate((0, 2)):
        port, _, _ = link.link_llrs(link.rate_match(enc, rv), snr, None,
                                    {"noise": (arrays["noise_re"][t], arrays["noise_im"][t])})
        x = chain.transmit(chain.rate_match(ref_enc, rv))
        s = snr.double()
        std = torch.sqrt((x.abs() ** 2).mean(-1, keepdim=True) / (10.0 ** (s / 10))[:, None] / 2)
        y = x + std * torch.complex(arrays["noise_re"][t].double(), arrays["noise_im"][t].double())
        ref = chain.receive(y, s)
        assert (port.double() - ref).abs().max() < 1e-3 * REF.LLR_CLIP


def test_reference_outcomes_agree_with_the_ports(small):
    """The HARQ entry on the CPU and the float64 reference, under the same
    drawn bits and noise, within the tiny cell's limits."""
    from ofdm_lte_tpu_torch import LTEConfig
    from ofdm_lte_tpu_torch.sim.coded import simulate_siso_coded_harq_batched
    cell, shape, arrays, _ = small
    cfg = LTEConfig(cell.config["bandwidth_mhz"], modulation=cell.config["modulation"])
    snr = cell.traffic["snr_db"]
    r = cell.entry.call(simulate_siso_coded_harq_batched, cfg, snr, shape,
                        cell.entry.sweep_args(shape, arrays),
                        cell.entry.kwargs(cell.config, cell.traffic), "cpu")
    port = cell.entry.results(shape, r)
    ref = cell.entry.reference(cell.reference, cell.config, cell.traffic, snr, arrays, shape)
    assert 0 < int(ref["ntx"].sum()) < shape.lanes * shape.transmissions   # the waterfall
    assert ref["fail"][:, -1].any() and not ref["fail"][:, -1].all()
    assert np.all(ref["errs"][ref["fail"][:, -1] == 0] == 0)
    assert np.all(ref["errs"][ref["fail"][:, -1] == 1] > 0)
    gaps = cell.entry.compare(port, ref)
    assert all(gaps[k] <= TINY_HARQ_LIMITS[k] for k in TINY_HARQ_LIMITS), gaps
    assert 0 < gaps["papr_gap_db"] < 1e-4


def test_the_bf16_decoder_control_is_not_correct(small):
    """The reference with its combining and decoder in bfloat16, in the
    program's place, fails the tiny cell's limits."""
    from harness import check
    cell, shape, arrays, _ = small
    snr = cell.traffic["snr_db"]
    ctl = cell.entry.reference(cell.reference, cell.config, cell.traffic, snr, arrays, shape,
                               decoder_dtype=torch.bfloat16)
    ref = cell.entry.reference(cell.reference, cell.config, cell.traffic, snr, arrays, shape)
    gaps = cell.entry.compare(ctl, ref)
    assert gaps["stage_fail_gap"] > 0 and gaps["papr_gap_db"] == 0
    assert check.verdict([gaps], TINY_HARQ_LIMITS)[0] is False


def test_tiny_cell_is_what_the_helper_says(checkout):
    traffic = json.loads((checkout / "portbench" / "traffic" / "t_harq_mix.json").read_text())
    assert {k: traffic[k] for k in TINY_HARQ} == TINY_HARQ
    assert core.Cell("t_harq", checkout).shape().block_sizes == (1024,)


def test_runner_runs_the_harq_cell(checkout):
    out = run_cpu(checkout, "t_harq", timeout=600)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["forbidden"] == []
    assert list(out["checks"]) == list(TINY_HARQ_LIMITS)
    assert out["checks"]["crc_mismatch_lanes"] == {"value": 0.0, "limit": 0}


@pytest.mark.parametrize("fault", ["stale", "half", "answer", "crc"])
def test_a_broken_timed_path_is_not_correct(checkout, fault):
    prelude = f"from harness import faults; faults.plant({fault!r})"
    out = run_cpu(checkout, "t_harq", prelude=prelude, timeout=600)
    assert out["correct"] is False and out["failed"] > 0
