"""Link-quality metrics: BER/SER/EVM, confidence intervals, throughput, CCDF.

Port of ofdm_lte_tpu/utils/metrics.py: NumPy and scipy on the host; the
symbol metrics take the port's planar `C` tensors.

- BER with t-distribution confidence intervals over per-trial BERs
- SER from hard constellation indices
- EVM = rms(error)/rms(reference)
- nominal LTE throughput bits/(symbols·(N+cp)·Ts)
- PAPR CCDF
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..cplx import C
from ..config import LTEConfig
from ..grid import grid_for


def ber(tx_bits, rx_bits) -> Dict:
    tx = np.asarray(tx_bits)
    rx = np.asarray(rx_bits)
    n = min(len(tx), len(rx))
    errors = int(np.sum(tx[:n] != rx[:n]))
    return {"ber": errors / n if n else 0.0, "errors": errors, "total_bits": n}


def ber_confidence_interval(ber_samples, confidence: float = 0.95
                            ) -> Tuple[float, float, float]:
    """(mean, lo, hi) via the t distribution over per-trial BERs."""
    from scipy import stats
    x = np.asarray(ber_samples, np.float64)
    m = float(np.mean(x))
    if len(x) < 2:
        return m, m, m
    sem = stats.sem(x)
    half = sem * stats.t.ppf((1 + confidence) / 2, len(x) - 1)
    return m, m - half, m + half


def ser(tx_symbols: C, rx_symbols: C, modulation: str) -> float:
    from ..ops import qam
    ti = qam.hard_indices(tx_symbols, modulation)
    ri = qam.hard_indices(rx_symbols, modulation)
    return float((ti != ri).double().mean())


def evm_percent(tx_symbols: C, rx_symbols: C) -> float:
    """EVM = rms(rx - tx)/rms(tx) · 100%."""
    err = (rx_symbols - tx_symbols).abs2()
    ref = tx_symbols.abs2()
    return float(100.0 * torch.sqrt(err.double().mean() / ref.double().mean()))


def nominal_throughput_mbps(config: LTEConfig, use_data_bins: bool = True) -> float:
    """bits per OFDM symbol / symbol duration."""
    n = grid_for(config).num_data if use_data_bins else config.Nc
    bits_per_symbol = n * config.bits_per_symbol
    t_symbol = config.samples_per_ofdm_symbol * config.Ts
    return bits_per_symbol / t_symbol / 1e6


def papr_ccdf(papr_db_samples, thresholds_db=None) -> Dict:
    """CCDF P(PAPR > x) over per-symbol PAPR samples."""
    if isinstance(papr_db_samples, torch.Tensor):
        papr_db_samples = papr_db_samples.detach().cpu().numpy()
    x = np.asarray(papr_db_samples, np.float64).ravel()
    if thresholds_db is None:
        thresholds_db = np.arange(4.0, 13.0, 0.25)
    thresholds_db = np.asarray(thresholds_db)
    ccdf = np.array([np.mean(x > t) for t in thresholds_db])
    return {"thresholds_db": thresholds_db, "ccdf": ccdf,
            "mean_db": float(x.mean()), "p99_db": float(np.quantile(x, 0.99))}
