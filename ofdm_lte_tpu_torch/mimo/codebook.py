"""LTE TM6/TM4 precoding codebooks as constant arrays + vectorized PMI search.

Port of ofdm_lte_tpu/mimo/codebook.py; the NumPy tables are a copy, held
element-exact against the JAX package's by tests/test_torch_mimo_tables.py:
- TM6 rank-1: 2TX {[1,1],[1,-1],[1,j],[1,-j]}/√2; 4TX/8TX: 16 linear-phase
  DFT vectors;
- TM4 rank-1 = TM6; rank-2/3/4 per antenna count.

PMI selection is one small contraction over the stacked codebook (a
broadcast multiply-sum, cplx.einsum) and an argmax.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import cplx
from ..cplx import C


@functools.lru_cache(maxsize=None)
def codebook(num_tx: int, transmission_mode: str = "TM6",
             rank: int = 1) -> np.ndarray:
    """Stacked codebook, shape (P, num_tx, rank), complex128 NumPy."""
    if transmission_mode == "TM6" and rank != 1:
        raise ValueError(f"TM6 only supports rank=1, got {rank}")
    if transmission_mode == "TM4" and not (1 <= rank <= min(num_tx, 4)):
        raise ValueError(
            f"TM4 with {num_tx} TX supports rank 1-{min(num_tx, 4)}, got {rank}")

    if rank == 1:
        return _rank1(num_tx)
    if rank == 2:
        return _rank2(num_tx)
    if rank == 3:
        return _rank3(num_tx)
    if rank == 4:
        return _rank4(num_tx)
    raise ValueError(f"rank {rank} not supported")


def _rank1(num_tx):
    if num_tx == 2:
        ws = [[1, 1], [1, -1], [1, 1j], [1, -1j]]
        return np.asarray(ws, complex).reshape(4, 2, 1) / np.sqrt(2)
    if num_tx == 4:
        return np.stack([
            np.exp(1j * 2 * np.pi * i * np.arange(4) / 16).reshape(4, 1) / 2
            for i in range(16)])
    if num_tx == 8:
        return np.stack([
            np.exp(1j * 2 * np.pi * i * np.arange(8) / 16).reshape(8, 1)
            / np.sqrt(8) for i in range(16)])
    raise ValueError(f"num_tx={num_tx} not supported for rank-1")


def _rank2(num_tx):
    if num_tx == 2:
        return np.stack([
            np.array([[1, 0], [0, 1]], complex),
            np.array([[1, 1], [1, -1]], complex) / np.sqrt(2),
            np.array([[1, 1], [1j, -1j]], complex) / np.sqrt(2),
        ])
    if num_tx == 4:
        cb = []
        for i in range(4):
            th = np.exp(1j * 2 * np.pi * i / 4)
            cb.append(np.array([[1, 0], [th, 0], [0, 1], [0, th]]) / np.sqrt(2))
        for i in range(4):
            th = np.exp(1j * 2 * np.pi * i / 4)
            cb.append(np.array([[1, 1], [th, -th], [1, -1], [th, th]]) / 2)
        for i in range(4):
            th = np.exp(1j * 2 * np.pi * i / 4)
            cb.append(np.array([[1, 0], [0, 1], [th, 0], [0, th]]) / np.sqrt(2))
        for i in range(4):
            th = np.exp(1j * 2 * np.pi * i / 4)
            cb.append(np.array([[1, 1], [1, -1], [th, th], [th, -th]]) / 2)
        return np.stack(cb)
    if num_tx == 8:
        cb = []
        for i in range(16):
            th = 2 * np.pi * i / 16
            W = np.zeros((8, 2), complex)
            W[0:4, 0] = np.exp(1j * th * np.arange(4)) / np.sqrt(4)
            W[4:8, 1] = np.exp(1j * th * np.arange(4)) / np.sqrt(4)
            cb.append(W)
        return np.stack(cb)
    raise ValueError(f"num_tx={num_tx} not supported for rank-2")


def _rank3(num_tx):
    if num_tx == 4:
        cb = []
        for i in range(8):
            th = np.exp(1j * 2 * np.pi * i / 8)
            W = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1],
                          [th, th, th]]) / np.sqrt(2)
            cb.append(W)
        return np.stack(cb)
    if num_tx == 8:
        cb = []
        for i in range(16):
            th = 2 * np.pi * i / 16
            v = np.exp(1j * th * np.arange(3)) / np.sqrt(3)
            W = np.zeros((8, 3), complex)
            W[0:3, 0] = v
            W[3:6, 1] = v
            W[5:8, 2] = v
            cb.append(W)
        return np.stack(cb)
    raise ValueError(f"num_tx={num_tx} requires >=4 TX for rank-3")


def _rank4(num_tx):
    if num_tx == 4:
        dft = np.array([[np.exp(-2j * np.pi * i * j / 4) for j in range(4)]
                        for i in range(4)])
        return np.stack([
            np.eye(4, dtype=complex),
            dft / 2,
            np.array([[1, 1, 1, 1], [1, -1, 1, -1],
                      [1, 1, -1, -1], [1, -1, -1, 1]], complex) / 2,
            np.array([[1, 1, 1, 1], [1, 1j, -1, -1j],
                      [1, -1, 1, -1], [1, -1j, -1, 1j]], complex) / 2,
        ])
    if num_tx == 8:
        cb = []
        for i in range(8):
            th = 2 * np.pi * i / 8
            W = np.zeros((8, 4), complex)
            for layer in range(4):
                a = layer * 2
                W[a:a + 2, layer] = np.array(
                    [1, np.exp(1j * th * (layer + 1))]) / np.sqrt(2)
            cb.append(W)
        return np.stack(cb)
    raise ValueError(f"num_tx={num_tx} requires >=4 TX for rank-4")


def codebook_size(num_tx: int, transmission_mode: str = "TM6",
                  rank: int = 1) -> int:
    return codebook(num_tx, transmission_mode, rank).shape[0]


def get_precoder(pmi: int, num_tx: int, transmission_mode: str = "TM6",
                 rank: int = 1) -> np.ndarray:
    cb = codebook(num_tx, transmission_mode, rank)
    if not 0 <= pmi < len(cb):
        raise ValueError(f"PMI {pmi} out of range [0, {len(cb) - 1}]")
    return cb[pmi]


def select_best_pmi(H: C, num_tx: int, transmission_mode: str = "TM6",
                    rank: int = 1, metric: str = "capacity", table: Optional[C] = None):
    """Vectorized PMI search over the whole codebook.

    H: C (..., num_rx, num_tx). Returns (pmi (...,) int32, metric value).
    'capacity' and 'sinr' both reduce to Σ|H·W|²; 'frobenius' is its square
    root. Ties go to the lowest PMI. `table` is the stacked codebook already
    on H's device (a link's buffer); without it the codebook is copied there.
    """
    cb = table if table is not None else cplx.const(
        codebook(num_tx, transmission_mode, rank), H.re.device)   # (P, t, l)
    He = cplx.einsum("...rt,ptl->...prl", H, cb)                # (..., P, r, l)
    power = He.abs2().sum(dim=(-2, -1))                         # (..., P)
    if metric == "frobenius":
        power = torch.sqrt(power)
    elif metric not in ("capacity", "sinr"):
        raise ValueError(f"metric '{metric}' not supported")
    pmi = torch.argmax(power, dim=-1)
    best = torch.take_along_dim(power, pmi[..., None], dim=-1)[..., 0]
    return pmi.to(torch.int32), best


def precoder_for_pmi(pmi, num_tx: int, transmission_mode: str = "TM6",
                     rank: int = 1, device=None, table: Optional[C] = None) -> C:
    """Gather W for a PMI tensor: (...,) -> C (..., num_tx, rank), on the
    PMI's device (or `device` for a Python integer). `table` as in
    select_best_pmi."""
    if isinstance(pmi, torch.Tensor):
        device = pmi.device
    cb = table if table is not None else cplx.const(
        codebook(num_tx, transmission_mode, rank), device)
    idx = torch.as_tensor(pmi, dtype=torch.int64, device=device)
    return C(cb.re[idx], cb.im[idx])


def quantization_error(H: np.ndarray, pmi: int, num_tx: int,
                       transmission_mode: str = "TM6") -> float:
    """1 - |<W_MRT, W_pmi>|². NumPy, diagnostic."""
    h_avg = np.mean(H, axis=0)
    w_opt = np.conj(h_avg) / np.linalg.norm(h_avg)
    w_q = get_precoder(pmi, num_tx, transmission_mode, 1).flatten()
    return float(1 - np.abs(np.vdot(w_opt, w_q)) ** 2)
