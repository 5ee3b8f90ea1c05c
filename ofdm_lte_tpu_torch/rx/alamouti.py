"""SFBC Alamouti space-frequency block coding (2 TX), vectorized.

Port of ofdm_lte_tpu/rx/alamouti.py.

encode, pairs over adjacent subcarriers:
    TX0: [ s0, -conj(s1) ]      TX1: [ s1, conj(s0) ]

decode, MRC-style combining with per-subcarrier channel estimates and
normalization by the pair-averaged channel power:
    s0 = (conj(h0_k)·r_k + h1_{k+1}·conj(r_{k+1})) / norm
    s1 = (conj(h1_k)·r_k - h0_{k+1}·conj(r_{k+1})) / norm
    norm = |h0_avg|² + |h1_avg|² + eps,  h_avg = (h_k + h_{k+1})/2

All pair arithmetic is a reshape to (..., n/2, 2) plus elementwise algebra
on the planes.
"""
from __future__ import annotations

from typing import Tuple

from .. import cplx
from ..cplx import C


def _pairs(x: C) -> Tuple[C, C]:
    """x (..., n) -> its even and odd bins, each (..., n/2)."""
    p = x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // 2, 2))
    return p[..., 0], p[..., 1]


def encode(symbols: C) -> Tuple[C, C]:
    """symbols (..., n) with n even -> (tx0, tx1) each (..., n)."""
    shape = tuple(symbols.shape)
    s0, s1 = _pairs(symbols)
    tx0 = cplx.stack([s0, -s1.conj()], axis=-1).reshape(shape)
    tx1 = cplx.stack([s1, s0.conj()], axis=-1).reshape(shape)
    return tx0, tx1


def decode(rx: C, h0: C, h1: C, regularization: float = 1e-10) -> C:
    """rx/h0/h1 (..., n) with n even -> decoded symbols (..., n)."""
    r_k, r_k1 = _pairs(rx)
    h0_k, h0_k1 = _pairs(h0)
    h1_k, h1_k1 = _pairs(h1)

    s0 = h0_k.conj() * r_k + h1_k1 * r_k1.conj()
    s1 = h1_k.conj() * r_k - h0_k1 * r_k1.conj()

    h0_avg = (h0_k + h0_k1) * 0.5
    h1_avg = (h1_k + h1_k1) * 0.5
    norm = h0_avg.abs2() + h1_avg.abs2() + regularization

    out = cplx.stack([C(s0.re / norm, s0.im / norm),
                      C(s1.re / norm, s1.im / norm)], axis=-1)
    return out.reshape(tuple(rx.shape))
