"""CRC-24A / CRC-24B / CRC-16 (3GPP TS 36.212 §5.1.1).

Port of ofdm_lte_tpu/coding/crc.py, with its own copy of the tables:

- host path: the byte-table CRC register of the native library
  (native/bitops.cc through native_ext), with the same table over packed
  bits in NumPy as its plain version (`crc_bits_plain`);
- device path: a CRC is GF(2)-linear, so for a fixed message length n the
  checksum is (bits @ M) mod 2 with a constant (n, nbits) 0/1 matrix M.
  `crc_torch` makes that one real fp32 product, exact for n < 2²⁴ (the sums
  are integers below 2²⁴, and 0/1 operands are exact in TF32 too). M is
  cached as NumPy and kept on the device by coding.tables, or passed in by
  a link that holds it as a buffer. The product is torch.matmul, a library
  GEMM on a card, as the JAX package leaves it to a plain XLA dot outside
  any kernel: each call adds one to `crc_torch.launches`, so that a profile
  of a coded path can tell these GEMMs from any other.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .tables import on_device

CRC24A_POLY = 0x1864CFB
CRC24B_POLY = 0x1800063
CRC16_POLY = 0x11021


@functools.lru_cache(maxsize=None)
def _byte_table(poly: int, nbits: int) -> np.ndarray:
    """256-entry table: state update for one input byte (MSB first)."""
    table = np.zeros(256, np.uint32)
    top = 1 << (nbits - 1)
    mask = (1 << nbits) - 1
    for b in range(256):
        reg = b << (nbits - 8)
        for _ in range(8):
            if reg & top:
                reg = ((reg << 1) ^ poly) & mask
            else:
                reg = (reg << 1) & mask
        table[b] = reg
    return table


def _reg_to_bits(reg: int, nbits: int) -> np.ndarray:
    out = np.zeros(nbits, np.uint8)
    for i in range(nbits):
        out[nbits - 1 - i] = (int(reg) >> i) & 1
    return out


def crc_bits(data_bits, poly: int, nbits: int) -> np.ndarray:
    """CRC of a bit array (MSB first), as nbits bits (uint8), by the native
    library's byte-table register (native_ext.crc_register), as the JAX
    package's crc_bits takes it for megabit transport blocks."""
    from .. import native_ext
    return _reg_to_bits(native_ext.crc_register(data_bits, poly, nbits), nbits)


def crc_bits_plain(data_bits, poly: int, nbits: int) -> np.ndarray:
    """crc_bits in NumPy and Python, a byte-table loop over the packed bits:
    the plain version that the native register is held to."""
    data_bits = np.asarray(data_bits, np.uint8)
    # pad to a byte multiple at the FRONT with zeros: leading zeros do not
    # change the CRC of an MSB-first message
    padded = np.concatenate([np.zeros((-len(data_bits)) % 8, np.uint8), data_bits])
    table = _byte_table(poly, nbits)
    reg = 0
    shift = nbits - 8
    mask = (1 << nbits) - 1
    for b in np.packbits(padded).tolist():
        reg = ((reg << 8) ^ int(table[((reg >> shift) ^ b) & 0xFF])) & mask
    return _reg_to_bits(reg, nbits)


def calculate_crc24a(bits) -> np.ndarray:
    return crc_bits(bits, CRC24A_POLY, 24)


def calculate_crc24b(bits) -> np.ndarray:
    return crc_bits(bits, CRC24B_POLY, 24)


def calculate_crc16(bits) -> np.ndarray:
    return crc_bits(bits, CRC16_POLY, 16)


def attach_crc24a(bits) -> np.ndarray:
    return np.concatenate([np.asarray(bits, np.uint8), calculate_crc24a(bits)])


def attach_crc24b(bits) -> np.ndarray:
    return np.concatenate([np.asarray(bits, np.uint8), calculate_crc24b(bits)])


def attach_crc16(bits) -> np.ndarray:
    return np.concatenate([np.asarray(bits, np.uint8), calculate_crc16(bits)])


def check_crc24a(bits_with_crc) -> bool:
    b = np.asarray(bits_with_crc, np.uint8)
    return bool(np.array_equal(calculate_crc24a(b[:-24]), b[-24:]))


def check_crc24b(bits_with_crc) -> bool:
    b = np.asarray(bits_with_crc, np.uint8)
    return bool(np.array_equal(calculate_crc24b(b[:-24]), b[-24:]))


def check_crc16(bits_with_crc) -> bool:
    b = np.asarray(bits_with_crc, np.uint8)
    return bool(np.array_equal(calculate_crc16(b[:-16]), b[-16:]))


@functools.lru_cache(maxsize=None)
def crc_matrix(n: int, poly: int = CRC24A_POLY, nbits: int = 24) -> np.ndarray:
    """M (n, nbits) float32 0/1 such that crc = (bits @ M) mod 2.

    Row i is the CRC of message bit i alone: x^(n-1-i+nbits) mod g, built by
    one sweep of the shift recurrence from the last bit up."""
    mask = (1 << nbits) - 1
    top = 1 << (nbits - 1)
    M = np.zeros((n, nbits), np.float32)
    r = poly & mask                     # x^nbits mod g, since g = x^nbits + (poly & mask)
    for i in range(n - 1, -1, -1):
        for b in range(nbits):
            M[i, nbits - 1 - b] = (r >> b) & 1
        r = ((r << 1) ^ poly) & mask if r & top else (r << 1) & mask
    return M


def crc_torch(bits: torch.Tensor, poly: int = CRC24A_POLY, nbits: int = 24,
              M: torch.Tensor = None) -> torch.Tensor:
    """CRC of fixed-length messages on their device: (..., n) integer bits ->
    (..., nbits) int32, as (bits @ M) mod 2. `M` is crc_matrix(n, poly,
    nbits) on the bits' device (kept by coding.tables when None)."""
    n = bits.shape[-1]
    if M is None:
        M = on_device(("crc", n, poly, nbits), lambda: crc_matrix(n, poly, nbits), bits.device)
    acc = torch.matmul(bits.to(torch.float32), M)
    crc_torch.launches += 1
    return torch.remainder(acc, 2.0).to(torch.int32)


crc_torch.launches = 0
