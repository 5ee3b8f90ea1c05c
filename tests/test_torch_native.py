"""The port's binding of the native bit library (ofdm_lte_tpu_torch/
native_ext.py over native/bitops.cc) against its plain versions: the CRC
register against crc_bits_plain and the JAX package's crc_bits, pack,
unpack and bit_errors against NumPy; the library lands in build/, never in
native/, and a failed build raises."""
import os

import numpy as np
import pytest

from ofdm_lte_tpu.coding import crc as jcrc

from ofdm_lte_tpu_torch import native_ext
from ofdm_lte_tpu_torch._build import BUILD_DIR
from ofdm_lte_tpu_torch.coding import crc

POLYS = [(crc.CRC24A_POLY, 24), (crc.CRC24B_POLY, 24), (crc.CRC16_POLY, 16)]


def test_builds_into_build_and_never_into_native():
    native = native_ext.SOURCE.parent
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    path = native_ext.build()
    native_ext.library()
    assert path.parent == BUILD_DIR and path.name.startswith("libbitops_") and path.exists()
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before
    assert native_ext.CXXFLAGS == ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
    assert "-O3 -fPIC -shared -std=c++17 -Wall" in (native / "Makefile").read_text()


@pytest.mark.parametrize("n", [0, 1, 7, 40, 6144, 75376])
@pytest.mark.parametrize("poly,nbits", POLYS, ids=["24a", "24b", "16"])
def test_crc_register_equals_the_plain_and_the_jax_crc(n, poly, nbits):
    bits = np.random.default_rng(n).integers(0, 2, n).astype(np.uint8)
    want = crc.crc_bits_plain(bits, poly, nbits)
    np.testing.assert_array_equal(want, jcrc.crc_bits(bits, poly, nbits))
    reg = native_ext.crc_register(bits, poly, nbits)
    assert reg == int("".join(map(str, want)), 2)
    np.testing.assert_array_equal(crc.crc_bits(bits, poly, nbits), want)


@pytest.mark.parametrize("n", [0, 1, 1003, 75376])
def test_pack_unpack_and_bit_errors_equal_numpy(n):
    rng = np.random.default_rng(n + 1)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    packed = native_ext.pack_bits(bits)
    np.testing.assert_array_equal(packed, np.packbits(bits))
    np.testing.assert_array_equal(native_ext.unpack_bits(packed, n), bits)
    np.testing.assert_array_equal(native_ext.unpack_bits(packed), np.unpackbits(packed))
    other = bits.copy()
    flip = rng.choice(n, min(n, 37), replace=False) if n else []
    other[flip] ^= 1
    assert native_ext.bit_errors(bits, other) == int(np.count_nonzero(bits != other))
    assert native_ext.bit_errors(bits, other[: n // 2]) == \
        int(np.count_nonzero(bits[: n // 2] != other[: n // 2]))
    with pytest.raises(ValueError):
        native_ext.unpack_bits(packed, 8 * len(packed) + 1)


def test_crc_bits_takes_the_native_register(monkeypatch):
    calls = []
    register = native_ext.crc_register

    def spy(bits, poly, nbits):
        calls.append((len(bits), poly, nbits))
        return register(bits, poly, nbits)

    monkeypatch.setattr(native_ext, "crc_register", spy)
    bits = np.random.default_rng(3).integers(0, 2, 3000)
    np.testing.assert_array_equal(crc.calculate_crc24a(bits),
                                  crc.crc_bits_plain(bits, crc.CRC24A_POLY, 24))
    assert calls == [(3000, crc.CRC24A_POLY, 24)]


def test_a_broken_compiler_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setenv("CXX", "/nonexistent/bin/g++")
    assert not native_ext.library_path().exists()
    with pytest.raises(RuntimeError, match="building the bit library failed"):
        native_ext.crc_register(np.ones(8, np.uint8), crc.CRC24A_POLY, 24)
    with pytest.raises(RuntimeError, match="building the bit library failed"):
        crc.crc_bits(np.ones(8, np.uint8), crc.CRC24A_POLY, 24)
    monkeypatch.setenv("CXX", "false")            # a compiler that runs and fails
    with pytest.raises(RuntimeError, match="building the bit library failed"):
        native_ext.build()
    assert not any(BUILD_DIR.glob(f"libbitops_*.{os.getpid()}.tmp"))
