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

import functools
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


@functools.lru_cache(maxsize=None)
def constellation(modulation: str) -> np.ndarray:
    """Full constellation by index (NumPy complex128), for tests and plots,
    in the JAX package's index order: point r·L + i is (level r, level i)."""
    s = _SPECS[modulation]
    L = len(s.levels)
    pts = np.empty(L * L, dtype=np.complex128)
    for r in range(L):
        for i in range(L):
            # Python's complex division, as the JAX package rounds it
            pts[r * L + i] = (s.levels[r] + 1j * s.levels[i]) / s.norm
    return pts


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


def ser(tx: C, rx_detected: C, modulation: str) -> torch.Tensor:
    """Symbol error rate, a float32 scalar tensor: the share of symbols whose
    nearest constellation index differs (utils.metrics.ser is its float
    form on the host)."""
    ti = hard_indices(tx, modulation)
    ri = hard_indices(rx_detected, modulation)
    return (ti != ri).to(torch.float32).mean()


# ---------------------------------------------------------------------------
# Soft demodulation: max-log LLRs (for the turbo-coded chain)
# ---------------------------------------------------------------------------

def llrs(symbols: C, noise_var, modulation: str, clip: float = 10.0) -> torch.Tensor:
    """Max-log LLRs, interleaved [b_{2k-1} .. b_0] per symbol (MSB first);
    LLR > 0 means bit 0.

    The mapping is separable per axis, so the 2-D max-log minimization over
    the constellation reduces exactly to 1-D minimizations over each axis's
    levels (the other axis cancels in the difference). The levels are in
    binary order, so the axis of L = 2^k levels reshapes into k axes of 2,
    one per bit, and the minimum over the levels whose bit b is 1 is a
    `select` on axis b and a min over the rest: no mask tables.

    QPSK uses the closed form (2/σ²)·y·√2, unclipped; 16/64-QAM the
    min-distance differences clipped to ±clip. symbols C (..., n);
    noise_var a scalar or a tensor (..., n); returns (..., n·2k) float32.
    """
    s = _SPECS[modulation]
    dev = symbols.re.device
    if isinstance(noise_var, torch.Tensor):
        nv = noise_var.to(device=dev, dtype=torch.float32)
    else:
        nv = float(np.float32(noise_var))      # a Python float: no copy to the device
    lead = symbols.re.shape[:-1]

    if modulation == "QPSK":
        g = 2.0 / nv if isinstance(nv, torch.Tensor) else float(np.float32(2.0) / np.float32(nv))
        scale = float(np.sqrt(2.0))
        return torch.stack([g * symbols.re * scale, g * symbols.im * scale],
                           dim=-1).reshape(lead + (-1,))

    k, L = s.half_bits, len(s.levels)
    lv = (2.0 * torch.arange(L, dtype=torch.float32, device=dev) - (L - 1)) / s.norm
    two_nv = 2.0 * nv[..., None] if isinstance(nv, torch.Tensor) else 2.0 * nv

    def axis_llrs(y: torch.Tensor) -> torch.Tensor:
        d2 = (y[..., None] - lv) ** 2                         # (..., L)
        bits = d2.reshape(d2.shape[:-1] + (2,) * k)           # one axis of 2 a bit
        out = []
        for b in range(k):
            ax = d2.ndim - 1 + b
            d1, d0 = bits.select(ax, 1), bits.select(ax, 0)
            if k > 1:
                d1, d0 = d1.flatten(-(k - 1)).amin(-1), d0.flatten(-(k - 1)).amin(-1)
            out.append(d1 - d0)
        return torch.stack(out, dim=-1)                       # (..., n, k)

    lr = torch.clamp(axis_llrs(symbols.re) / two_nv, -clip, clip)
    li = torch.clamp(axis_llrs(symbols.im) / two_nv, -clip, clip)
    # symbol bit order: the real axis's bits (MSB) then the imaginary axis's
    return torch.cat([lr, li], dim=-1).reshape(lead + (-1,))
