"""SC-FDM DFT precoding / decoding as complex GEMMs.

Port of ofdm_lte_tpu/ops/scfdm.py: the M-point unitary DFT of the data
symbols before grid mapping, W[k, n] = exp(-2πi·k·n/M)/√M, and the inverse
at the receiver, batched over all OFDM symbols. Both are the modem's
planar complex product and go through `ops.ofdm._cmm`: the hand-written
kernel on a CUDA tensor, its plain version on a CPU tensor. The tables
are cached as NumPy; a link holds them on its device and passes them in.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from ..cplx import C
from .ofdm import _cmm, _planes


@functools.lru_cache(maxsize=None)
def _dft_consts(M: int, inverse: bool):
    k = np.arange(M, dtype=np.float64)
    sign = 2j if inverse else -2j
    W = np.exp(sign * np.pi * np.outer(k, k) / M) / np.sqrt(M)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def dft_tables(M: int, inverse: bool, device=None) -> C:
    """W (or its inverse) on `device`."""
    return _planes(*_dft_consts(M, inverse), device)


def precode(symbols: C, M: int, tables: Optional[C] = None) -> C:
    """Unitary M-point DFT along the last axis: (..., M) -> (..., M)."""
    if tables is None:
        tables = dft_tables(M, False, symbols.re.device)
    return _cmm(symbols, tables)


def decode(symbols: C, M: int, tables: Optional[C] = None) -> C:
    """Unitary M-point IDFT along the last axis (receiver side)."""
    if tables is None:
        tables = dft_tables(M, True, symbols.re.device)
    return _cmm(symbols, tables)
