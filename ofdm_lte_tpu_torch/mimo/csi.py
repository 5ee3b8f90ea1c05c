"""CSI feedback: PMI / CQI / RI generation (perfect feedback: no delay, no
quantization error beyond the codebook itself).

Port of ofdm_lte_tpu/mimo/csi.py:

- PMI: best codebook index by Σ|HW|² (mimo.codebook.select_best_pmi);
- CQI: post-precoding SINR mapped through the 16-level table of lower
  edges below;
- RI: 2 if λ2/λ1 > 0.2 else 1, from the eigenvalues of HᴴH
  (torch.linalg.eigvalsh on the complex Hermitian matrix).

`generate_feedback` computes all of it. The beamforming link returns the
PMI and W alone, so it asks for those two (select_best_pmi and
precoder_for_pmi) and runs no eigensolver and no CQI table.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cplx import C
from . import codebook as cb
from .beamforming import hermitian_gram

# CQI table lower edges in dB: CQI i is assigned when sinr_db >= edge[i]
# and < edge[i+1].
_CQI_EDGES_DB = np.array(
    [-6.0, -4.0, -2.0, 0.0, 2.0, 4.0, 6.0, 8.0, 10.0,
     12.0, 14.0, 16.0, 18.0, 20.0, 22.0], np.float32)


class Feedback(NamedTuple):
    pmi: torch.Tensor
    cqi: torch.Tensor
    ri: torch.Tensor
    sinr_db: torch.Tensor
    precoder: C           # (..., num_tx, 1)


def sinr_to_cqi(sinr_db: torch.Tensor) -> torch.Tensor:
    """Map SINR (dB) to CQI 0-15 by table lookup."""
    edges = torch.as_tensor(_CQI_EDGES_DB, device=sinr_db.device)
    return (sinr_db[..., None] >= edges).sum(dim=-1, dtype=torch.int32)


def rank_indicator(H: C) -> torch.Tensor:
    """RI from the ratio of the two largest eigenvalues of HᴴH."""
    A = hermitian_gram(H)
    lam = torch.linalg.eigvalsh(torch.complex(A.re, A.im)).flip(-1)   # descending
    if lam.shape[-1] < 2:
        return torch.ones(lam.shape[:-1], dtype=torch.int32, device=lam.device)
    ratio = lam[..., 1] / (lam[..., 0] + 1e-12)
    return torch.where(ratio > 0.2, 2, 1).to(torch.int32)


def generate_feedback(H: C, num_tx: int, noise_variance=1.0,
                      codebook_type: str = "TM6") -> Feedback:
    """Full CSI feedback {pmi, cqi, ri, sinr, W}."""
    pmi, power = cb.select_best_pmi(H, num_tx, codebook_type, rank=1, metric="capacity")
    sinr_db = 10.0 * torch.log10(power / noise_variance)
    W = cb.precoder_for_pmi(pmi, num_tx, codebook_type, rank=1)
    return Feedback(pmi, sinr_to_cqi(sinr_db), rank_indicator(H), sinr_db, W)


def pmi_statistics(pmi_history, num_tx: int, codebook_type: str = "TM6") -> dict:
    """PMI-usage statistics over a feedback history: any array of PMI
    values (the `pmi` field over Monte-Carlo lanes, a per-symbol history).
    NumPy. Returns {total_feedbacks, unique_pmis, most_common_pmi,
    pmi_distribution}, `most_common_pmi` breaking ties toward the lower
    index; None for an empty history."""
    if isinstance(pmi_history, torch.Tensor):
        pmi_history = pmi_history.cpu().numpy()
    hist = np.asarray(pmi_history).ravel().astype(np.int64)
    if hist.size == 0:
        return None
    dist = np.bincount(hist, minlength=cb.codebook_size(num_tx, codebook_type, rank=1))
    return {
        "total_feedbacks": int(hist.size),
        "unique_pmis": int(np.count_nonzero(dist)),
        "most_common_pmi": int(np.argmax(dist)),
        "pmi_distribution": dist,
    }
