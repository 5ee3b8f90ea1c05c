"""Rank adaptation (RI) + per-rank TM4 PMI selection.

A NumPy-only copy of ofdm_lte_tpu/mimo/rank_adaptation.py. The chosen rank
sets downstream array shapes (layers per OFDM symbol), so the decision is
made on the host, once per simulation call, on an initial channel draw.

- RI (eigenvalue method): count eigenvalues of HᴴH above 0.15·λmax, clamp by
  SNR (<5 dB -> 1, <10 dB -> ≤2), cap at min(tx, rx, 4)
- RI (capacity method): argmax over rank of Σ log2(1 + SNR·σᵢ²/rank)
- PMI: argmax over the rank's TM4 codebook of log2 det(I + SNR/rank·H_eff
  H_effᴴ)
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from . import codebook as cb


def optimal_rank(H: np.ndarray, snr_db: float, rank_threshold: float = 0.15,
                 method: str = "eigenvalue", max_rank: int = None) -> int:
    """H: NumPy complex (num_rx, num_tx) (averaged over subcarriers if 3-D)."""
    if H.ndim == 3:
        H = H.mean(axis=2)
    num_rx, num_tx = H.shape
    if max_rank is None:
        max_rank = min(num_tx, num_rx, 4)

    if method == "eigenvalue":
        ev = np.sort(np.linalg.eigvalsh(H.conj().T @ H))[::-1]
        if ev[0] < 1e-10:
            return 1
        ri = int(np.sum(ev / ev[0] > rank_threshold))
        ri = min(ri, max_rank)
        if snr_db < 5:
            ri = 1
        elif snr_db < 10:
            ri = min(ri, 2)
        return max(1, ri)

    if method == "capacity":
        s = np.linalg.svd(H, compute_uv=False)[:max_rank]
        snr_lin = 10 ** (snr_db / 10)
        best_rank, best_c = 1, -np.inf
        for rank in range(1, max_rank + 1):
            c = sum(np.log2(1 + snr_lin * s[i] ** 2 / rank)
                    for i in range(min(rank, len(s))))
            if c > best_c:
                best_c, best_rank = c, rank
        return best_rank

    raise ValueError(f"method '{method}' not supported")


def select_precoder_for_rank(H: np.ndarray, rank: int, snr_db: float,
                             metric: str = "capacity"):
    """Best TM4 precoder for a given rank. NumPy (host side).

    Returns (pmi, W (num_tx, rank))."""
    if H.ndim == 3:
        H = H.mean(axis=2)
    num_rx, num_tx = H.shape
    book = cb.codebook(num_tx, "TM4", rank)
    snr_lin = 10 ** (snr_db / 10)

    best_pmi, best_v = 0, -np.inf
    for pmi, W in enumerate(book):
        He = H @ W
        if metric == "capacity":
            M = np.eye(num_rx) + (snr_lin / rank) * (He @ He.conj().T)
            sign, logdet = np.linalg.slogdet(M)
            v = logdet / np.log(2) if sign > 0 else 0.0
        elif metric == "frobenius":
            v = float(np.linalg.norm(He, "fro") ** 2)
        elif metric == "sinr":
            v = float(np.sum(np.abs(He) ** 2))
        else:
            raise ValueError(f"metric '{metric}' not supported")
        if v > best_v:
            best_v, best_pmi = v, pmi
    return best_pmi, book[best_pmi]


def get_feedback(H: np.ndarray, snr_db: float, rank_method: str = "eigenvalue",
                 pmi_metric: str = "capacity") -> Dict:
    """RI + PMI + W + diagnostics."""
    if H.ndim == 3:
        H_avg = H.mean(axis=2)
    else:
        H_avg = H
    ri = optimal_rank(H_avg, snr_db, method=rank_method)
    pmi, W = select_precoder_for_rank(H_avg, ri, snr_db, metric=pmi_metric)
    ev = np.sort(np.linalg.eigvalsh(H_avg.conj().T @ H_avg))[::-1]
    s = np.linalg.svd(H_avg, compute_uv=False)
    return {
        "ri": ri, "pmi": pmi, "W": W, "eigenvalues": ev,
        "condition_number": float(s[0] / (s[-1] + 1e-10)),
    }
