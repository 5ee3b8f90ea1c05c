"""The coded chain's deterministic front end against the JAX package, exact:
the CRC tables and checksums (host and device), code block segmentation,
the rate-matching tables and both gathers (repetition and puncturing, rv
0-3), and the max-log LLRs (within 1e-6 of max|LLR|, scalar and
per-symbol noise)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.coding import crc as jcrc
from ofdm_lte_tpu.coding import rate_matching as jrm
from ofdm_lte_tpu.coding import segmentation as jseg
from ofdm_lte_tpu.ops import qam as jqam

from ofdm_lte_tpu_torch.coding import crc as tcrc
from ofdm_lte_tpu_torch.coding import rate_matching as trm
from ofdm_lte_tpu_torch.coding import segmentation as tseg
from ofdm_lte_tpu_torch.coding import tables
from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.ops import qam as tqam

torch.set_num_threads(2)

POLYS = [(tcrc.CRC24A_POLY, 24), (tcrc.CRC24B_POLY, 24), (tcrc.CRC16_POLY, 16)]
LLR_TOL = 1e-6          # of max|LLR|


def test_crc_constants_and_byte_tables_equal():
    assert (tcrc.CRC24A_POLY, tcrc.CRC24B_POLY, tcrc.CRC16_POLY) == \
           (jcrc.CRC24A_POLY, jcrc.CRC24B_POLY, jcrc.CRC16_POLY)
    for poly, nbits in POLYS:
        np.testing.assert_array_equal(tcrc._byte_table(poly, nbits),
                                      jcrc._byte_table(poly, nbits))


@pytest.mark.parametrize("n", [0, 1, 40, 6144, 100000])
def test_crc_bits_equal(n, rng):
    bits = rng.integers(0, 2, n)
    for poly, nbits in POLYS:
        want = jcrc._crc_bits_numpy(bits, poly, nbits)
        np.testing.assert_array_equal(jcrc.crc_bits(bits, poly, nbits), want)
        got = tcrc.crc_bits(bits, poly, nbits)
        assert got.dtype == np.uint8 and got.shape == (nbits,)
        np.testing.assert_array_equal(got, want)
    for name in ("24a", "24b", "16"):
        with_crc = getattr(tcrc, f"attach_crc{name}")(bits)
        np.testing.assert_array_equal(with_crc, getattr(jcrc, f"attach_crc{name}")(bits))
        assert getattr(tcrc, f"check_crc{name}")(with_crc)
        if n:
            with_crc[0] ^= 1
            assert not getattr(tcrc, f"check_crc{name}")(with_crc)


@pytest.mark.parametrize("n", [0, 1, 40, 6144])
def test_crc_torch_equals_the_host_crc(n, rng):
    bits = rng.integers(0, 2, (3, 2, n)).astype(np.int32)
    if n:
        np.testing.assert_array_equal(tcrc.crc_matrix(n), jcrc.crc_matrix(n))
    for poly, nbits in POLYS:
        got = tcrc.crc_torch(torch.from_numpy(bits), poly, nbits)
        assert got.dtype == torch.int32 and got.shape == (3, 2, nbits)
        want = np.stack([tcrc.crc_bits(b, poly, nbits) for b in bits.reshape(6, n)])
        np.testing.assert_array_equal(got.numpy().reshape(-1, nbits), want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jcrc.crc_jax(jnp.asarray(bits), poly, nbits)))


def test_device_tables_are_kept_and_bounded(rng):
    tables._tables.clear()
    bits = torch.from_numpy(rng.integers(0, 2, (2, 40)).astype(np.int32))
    tcrc.crc_torch(bits)
    (key, M), = tables._tables.items()
    tcrc.crc_torch(bits)
    assert len(tables._tables) == 1 and tables._tables[key] is M
    for n in range(1, tables.MAX_TABLES + 3):
        tcrc.crc_torch(bits[:, :n])
    assert len(tables._tables) == tables.MAX_TABLES


@pytest.mark.parametrize("B", [40, 6144, 6145, 75376])
def test_segmentation_equals(B, rng):
    assert tseg.TURBO_INTERLEAVER_SIZES == jseg.TURBO_INTERLEAVER_SIZES
    assert tseg.Z_MAX == jseg.Z_MAX
    tb = rng.integers(0, 2, B).astype(np.uint8)
    jb, jm = jseg.segment_code_blocks(tb)
    tb_, tm = tseg.segment_code_blocks(tb)
    assert tm == jm and len(tb_) == len(jb)
    for a, b in zip(tb_, jb):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert tseg.segment_layout(B) == jseg.segment_layout(B)
    np.testing.assert_array_equal(tseg.desegment_code_blocks(tb_, tm), tb)
    np.testing.assert_array_equal(tseg.desegment_code_blocks(tb_, tm),
                                  jseg.desegment_code_blocks(jb, jm))
    if tm["segmented"]:
        assert all(tcrc.check_crc24b(blk) for blk in tb_)
    for size in (1, 40, 41, 6144):
        assert tseg.find_interleaver_size(size) == jseg.find_interleaver_size(size)
    with pytest.raises(ValueError):
        tseg.find_interleaver_size(6145)


def _E_cases(K):
    N_cb = 3 * (K + 6)
    # puncturing well below and just below N_cb, repetition just over and
    # more than twice over
    return [N_cb // 3, N_cb - 5, N_cb + 7, 2 * N_cb + 101]


@pytest.mark.parametrize("K", [40, 6144])
def test_rate_matching_tables_equal(K):
    for K_pi in (K + 3, K + 6):
        np.testing.assert_array_equal(trm.subblock_perm_indices(K_pi),
                                      jrm.subblock_perm_indices(K_pi))
    np.testing.assert_array_equal(trm.SUBBLOCK_PERM, jrm.SUBBLOCK_PERM)
    np.testing.assert_array_equal(trm._cb_source(K), jrm._cb_source(K))
    for E in _E_cases(K):
        for rv in range(4):
            np.testing.assert_array_equal(trm.forward_indices(K, E, rv),
                                          jrm.forward_indices(K, E, rv))
            for a, b in zip(trm.dematch_tables(K, E, rv), jrm.dematch_tables(K, E, rv)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("K", [40, 6144])
def test_rate_match_and_dematch_equal(K, rng):
    for E in _E_cases(K):
        for rv in range(4):
            enc = rng.integers(0, 2, (2, 3 * K + 12)).astype(np.int32)
            got = trm.rate_match(torch.from_numpy(enc), E, K, rv)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                jrm.rate_match(jnp.asarray(enc), E, K, rv)))
            llr = (rng.standard_normal((2, E)) * 4).astype(np.float32)
            got = trm.rate_dematch(torch.from_numpy(llr), K, rv).numpy()
            want = np.asarray(jrm.rate_dematch(jnp.asarray(llr), K, rv))
            # bit for bit: the repeats are summed in the JAX package's order
            np.testing.assert_array_equal(got, want)


def test_dematch_undoes_match_without_repetition(rng):
    K = 40
    enc = rng.integers(0, 2, 3 * K + 12).astype(np.float32)
    N_cb = 3 * (K + 6)
    out = trm.rate_dematch(trm.rate_match(torch.from_numpy(enc), N_cb, K, 2), K, 2).numpy()
    kept = trm._cb_source(K)
    kept = kept[kept >= 0]
    np.testing.assert_array_equal(out[kept], enc[kept])


@pytest.mark.parametrize("modulation", ["QPSK", "16-QAM", "64-QAM"])
@pytest.mark.parametrize("per_symbol", [False, True], ids=["scalar_noise", "per_symbol_noise"])
def test_llrs_equal(modulation, per_symbol, rng):
    shape = (3, 4, 61)
    y = (rng.standard_normal(shape) * 0.7).astype(np.float32)
    z = (rng.standard_normal(shape) * 0.7).astype(np.float32)
    nv = rng.uniform(0.02, 0.5, shape).astype(np.float32) if per_symbol else 0.07
    want = np.asarray(jqam.llrs(jcplx.C(jnp.asarray(y), jnp.asarray(z)), nv, modulation))
    got = tqam.llrs(C(torch.from_numpy(y), torch.from_numpy(z)),
                    torch.from_numpy(nv) if per_symbol else nv, modulation)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= LLR_TOL * scale
    if modulation != "QPSK":
        assert np.abs(want).max() == 10.0 and got.abs().max().item() == 10.0     # clipped
    # LLR > 0 means bit 0: hard decisions from the signs are the hard demap
    bits = tqam.demodulate(C(torch.from_numpy(y), torch.from_numpy(z)), modulation)
    sure = got.abs() > 1e-3
    assert torch.equal((got < 0).to(torch.int32)[sure], bits[sure])
