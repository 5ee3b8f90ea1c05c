"""QAM modulation / hard demodulation as branch-free tensor arithmetic.

Port of ofdm_lte_tpu/ops/qam.py. The constellations are square grids with
binary row-major (non-Gray) index mapping — index = r_idx·L + i_idx with
the top half of the bits selecting the real level — so mapping and
nearest-point detection factorize per axis:

- map:   bits -> integer index -> (r_idx, i_idx) -> (level[r_idx], level[i_idx]) / norm
- demap: r_idx = clip(round((re·norm + L-1)/2)), independently per axis

torch.round, like jnp.round, rounds half to even, so decisions on exact
boundaries match the JAX package.

Constellation tables:
- QPSK:   levels per axis indexed [+1, -1]  (index 0 -> +1), norm √2
- 16-QAM: levels [-3,-1,1,3] ascending, norm √10
- 64-QAM: levels [-7..7] ascending, norm √42
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cplx import C


class QamSpec(NamedTuple):
    name: str
    bits_per_symbol: int     # 2k
    half_bits: int           # k bits per axis
    levels: tuple            # level value by axis-index (un-normalized)
    norm: float              # divide by this


_SPECS = {
    "QPSK": QamSpec("QPSK", 2, 1, (1.0, -1.0), float(np.sqrt(2))),
    "16-QAM": QamSpec("16-QAM", 4, 2, (-3.0, -1.0, 1.0, 3.0), float(np.sqrt(10))),
    "64-QAM": QamSpec("64-QAM", 6, 3,
                      (-7.0, -5.0, -3.0, -1.0, 1.0, 3.0, 5.0, 7.0),
                      float(np.sqrt(42))),
}


def spec(modulation: str) -> QamSpec:
    return _SPECS[modulation]


def _level(q: torch.Tensor, s: QamSpec) -> torch.Tensor:
    """Level value of axis index q, as float32 (levels are small integers,
    so this equals the table lookup exactly and needs no host-to-device
    copy of the table)."""
    if s.name == "QPSK":
        return (1 - 2 * q).to(torch.float32)
    return (2 * q - (len(s.levels) - 1)).to(torch.float32)


def _shifts(s: QamSpec, device) -> torch.Tensor:
    """Bit positions MSB first, as int32 (indices stay int32, as in the JAX
    package, so no int64 pass over the bit stream is made)."""
    return torch.arange(s.bits_per_symbol - 1, -1, -1, dtype=torch.int32, device=device)


def bits_to_indices(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """Pack groups of bits (MSB first) into constellation indices.

    bits: (..., n_sym · bits_per_symbol) integer tensor -> (..., n_sym) int32.
    """
    s = _SPECS[modulation]
    b = bits.reshape(bits.shape[:-1] + (-1, s.bits_per_symbol)).to(torch.int32)
    return (b << _shifts(s, bits.device)).sum(dim=-1, dtype=torch.int32)


def modulate(bits: torch.Tensor, modulation: str) -> C:
    """bits (..., n·2k) -> complex symbols (..., n)."""
    s = _SPECS[modulation]
    idx = bits_to_indices(bits, modulation)
    L = len(s.levels)
    return C(_level(idx // L, s) / s.norm, _level(idx % L, s) / s.norm)


def _axis_index(x: torch.Tensor, s: QamSpec) -> torch.Tensor:
    """Nearest level index along one axis (closed-form quantizer)."""
    if s.name == "QPSK":
        # index 0 -> +1, index 1 -> -1; a tie at 0 resolves to index 0
        return (x < 0).to(torch.int32)
    L = len(s.levels)
    # ascending odd levels: level = 2·q - (L-1), q in [0, L)
    q = torch.round((x * s.norm + (L - 1)) / 2.0)
    return torch.clamp(q, 0, L - 1).to(torch.int32)


def hard_indices(symbols: C, modulation: str) -> torch.Tensor:
    """Nearest-constellation index per received symbol (no search)."""
    s = _SPECS[modulation]
    L = len(s.levels)
    return _axis_index(symbols.re, s) * L + _axis_index(symbols.im, s)


def detect(symbols: C, modulation: str) -> C:
    """Hard decision to the nearest constellation point."""
    s = _SPECS[modulation]
    return C(_level(_axis_index(symbols.re, s), s) / s.norm,
             _level(_axis_index(symbols.im, s), s) / s.norm)


def indices_to_bits(idx: torch.Tensor, modulation: str) -> torch.Tensor:
    """Unpack constellation indices to bits (MSB first), last axis expanded."""
    s = _SPECS[modulation]
    bits = (idx[..., None] >> _shifts(s, idx.device)) & 1
    if idx.ndim == 0:
        return bits.to(torch.int32)
    return bits.reshape(idx.shape[:-1] + (-1,)).to(torch.int32)


def demodulate(symbols: C, modulation: str) -> torch.Tensor:
    """Hard demap received symbols -> bit tensor (..., n·2k), int32."""
    return indices_to_bits(hard_indices(symbols, modulation), modulation)
