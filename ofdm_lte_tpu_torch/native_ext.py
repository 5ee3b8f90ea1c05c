"""ctypes binding of the native host bit library (native/bitops.cc).

Port of ofdm_lte_tpu/native_ext.py, NumPy only. The first call builds
`native/bitops.cc` with the flags of `native/Makefile` (the compiler from
$CXX, else g++) into the repository's git-ignored build/ directory, as
`build/libbitops_<hash of source, compiler and flags>.so`, through a
temporary file and os.replace (several test workers may build at once);
nothing is written into native/. A failed build raises with the compiler's
output: unlike the JAX package's shim there is no silent NumPy fallback,
the NumPy forms stay in the tests as the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ._build import BUILD_DIR

SOURCE = BUILD_DIR.parent / "native" / "bitops.cc"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")    # native/Makefile's

_libs = {}      # compiler -> loaded CDLL (a lookup a call: hashing the source is not)


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    h = hashlib.sha256(" ".join((_compiler(),) + CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbitops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/bitops.cc unless the library of this source, compiler
    and flags exists; raises RuntimeError with the compiler's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the bit library failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    except OSError as e:
        raise RuntimeError(f"building the bit library failed: {' '.join(cmd)}: {e}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    lib = _libs.get(_compiler())
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.olt_pack_bits.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.olt_pack_bits.restype = None
        lib.olt_unpack_bits.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.olt_unpack_bits.restype = None
        lib.olt_crc_bits.argtypes = [u8p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int]
        lib.olt_crc_bits.restype = ctypes.c_uint32
        lib.olt_bit_errors.argtypes = [u8p, u8p, ctypes.c_int64]
        lib.olt_bit_errors.restype = ctypes.c_int64
        _libs[_compiler()] = lib
    return lib


def _bits(x) -> np.ndarray:
    """A 1-D contiguous uint8 array (a copy where x is not one)."""
    x = np.ascontiguousarray(x, np.uint8)
    if x.ndim != 1:
        raise ValueError(f"a bit array is 1-D, got shape {x.shape}")
    return x


def _u8p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def pack_bits(bits) -> np.ndarray:
    """Bits, one a byte, packed MSB first (np.packbits)."""
    bits = _bits(bits)
    out = np.empty((len(bits) + 7) // 8, np.uint8)
    library().olt_pack_bits(_u8p(bits), len(bits), _u8p(out))
    return out


def unpack_bits(data, n_bits: int = None) -> np.ndarray:
    """The first n_bits (all, when None) bits of packed bytes, MSB first."""
    data = _bits(data)
    n = len(data) * 8 if n_bits is None else int(n_bits)
    if not 0 <= n <= len(data) * 8:
        raise ValueError(f"{n} bits asked of {len(data)} bytes")
    out = np.empty(n, np.uint8)
    library().olt_unpack_bits(_u8p(data), n, _u8p(out))
    return out


def crc_register(bits, poly: int, nbits: int) -> int:
    """The CRC register over an MSB-first bit array (poly with its leading
    x^nbits term, 8 <= nbits <= 32)."""
    if not 8 <= nbits <= 32:
        raise ValueError(f"a CRC of {nbits} bits: the byte table needs 8 to 32")
    bits = _bits(bits)
    return int(library().olt_crc_bits(_u8p(bits), len(bits), poly, nbits))


def bit_errors(a, b) -> int:
    """Positions where two bit arrays differ, over the shorter length."""
    a, b = _bits(a), _bits(b)
    return int(library().olt_bit_errors(_u8p(a), _u8p(b), min(len(a), len(b))))
