"""Beamforming precoders: MRT, dominant eigenvector, update cadence.

Port of ofdm_lte_tpu/mimo/beamforming.py:

- MRT: W = conj(h̄)/‖h̄‖ with h̄ the RX-averaged channel row;
- eigenbeamforming: the dominant eigenvector of HᴴH, from
  torch.linalg.eigh on the complex Hermitian matrix (a library
  eigensolver; no link of the package calls it). An eigenvector is unique
  only up to a phase, so it is compared with the JAX package's through
  |⟨w_jax, w_port⟩|, never entry by entry;
- apply_precoding x = W @ s;
- beamforming gain ‖HW‖²/(‖H‖²_F/num_tx) in dB;
- the update period from the 90% coherence time T_c = 9/(16π f_D),
  updating every 0.1·T_c, clipped to [1, 140] symbols.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import cplx
from ..config import doppler_hz
from ..cplx import C


def _unit_column(w: C) -> C:
    """w (..., n) scaled to unit norm, as a column (..., n, 1)."""
    norm = torch.sqrt(w.abs2().sum(dim=-1, keepdim=True))
    return C((w.re / norm)[..., None], (w.im / norm)[..., None])


def mrt_weights(H: C) -> C:
    """H (..., rx, tx) -> W (..., tx, 1)."""
    return _unit_column(H.mean(axis=-2).conj())


def hermitian_gram(H: C) -> C:
    """HᴴH (..., tx, tx) as a broadcast multiply-sum."""
    return cplx.matmul_small(C(H.re.transpose(-1, -2), -H.im.transpose(-1, -2)), H)


def eigen_weights(H: C) -> C:
    """Dominant eigenvector of HᴴH -> W (..., tx, 1)."""
    A = hermitian_gram(H)
    _, vecs = torch.linalg.eigh(torch.complex(A.re, A.im))    # ascending
    v = vecs[..., -1]                                        # (..., tx)
    return _unit_column(C(v.real.contiguous(), v.imag.contiguous()))


def apply_precoding(symbols: C, W: C) -> C:
    """x = W @ s: s (..., L, n) or (..., n) with L = 1 -> (..., tx, n)."""
    if symbols.ndim == W.ndim - 1:
        symbols = C(symbols.re[..., None, :], symbols.im[..., None, :])
    return cplx.matmul_small(W, symbols)


def beamforming_gain_db(H: C, W: C, He: Optional[C] = None) -> torch.Tensor:
    """10·log10(‖HW‖² / (‖H‖²_F / num_tx)); `He`, if given, is HW already
    formed (by matmul_small, so the same numbers)."""
    num_tx = H.shape[-1]
    He = cplx.matmul_small(H, W) if He is None else He
    p_bf = He.abs2().sum(dim=(-2, -1))
    p_no = H.abs2().sum(dim=(-2, -1)) / num_tx
    return 10.0 * torch.log10(p_bf / p_no)


def update_period_symbols(velocity_kmh: float, frequency_ghz: float = 2.0,
                          delta_f_khz: float = 15.0) -> int:
    """Precoder update cadence in OFDM symbols."""
    fd = doppler_hz(velocity_kmh, frequency_ghz)
    if fd == 0:
        return 100
    tc = 9.0 / (16.0 * np.pi * fd)
    update_time = 0.1 * tc
    symbol_duration = 1.0 / (delta_f_khz * 1e3)
    return int(np.clip(int(update_time / symbol_duration), 1, 140))
