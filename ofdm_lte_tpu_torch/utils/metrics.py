"""Link-quality metrics. Port of ofdm_lte_tpu/utils/metrics.py (EVM only)."""
from __future__ import annotations

import torch

from ..cplx import C


def evm_percent(tx_symbols: C, rx_symbols: C) -> float:
    """EVM = rms(rx - tx)/rms(tx) · 100%."""
    err = (rx_symbols - tx_symbols).abs2()
    ref = tx_symbols.abs2()
    return float(100.0 * torch.sqrt(err.double().mean() / ref.double().mean()))
