"""CRS channel estimation + ZF equalization, batched over OFDM symbols.

Port of ofdm_lte_tpu/rx/estimation.py:

- LS at pilots Ĥp = Yp / Xp (pilots have unit modulus: Yp·conj(Xp))
- linear interpolation between pilots with constant edge extrapolation,
  as two gathers and a lerp from grid.interp_table
- pilot-SNR estimate mean|Yp|²/mean|Yp-Xp|²
- slot-periodic estimation: one estimate per 14-symbol slot, reused within
  the slot
- ZF equalization X̂ = Y/(Ĥ+ε), ε=1e-6 added to the real part
- maximum-ratio combining over an antenna axis

The functions take their constant tables (`known` pilots, interpolation
`table`) from the caller's device buffers, or build them from the NumPy
tables on the input's device when none are given.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import cplx
from ..cplx import C
from ..config import LTEConfig
from ..grid import pilot_sequence, interp_table, interp_table_custom

SLOT_SIZE = 14  # OFDM symbols per LTE slot


def known_pilots(cell_id: int, n: int, device=None) -> C:
    """The CRS pilot sequence as a C pair on `device`."""
    return cplx.from_numpy(pilot_sequence(cell_id, n), device)


def ls_at_pilots(rx_pilot_bins: C, cell_id: int = 0, known: Optional[C] = None) -> C:
    """LS estimate Ĥ = Y/X at pilot bins. rx_pilot_bins: (..., num_pilot)."""
    if known is None:
        known = known_pilots(cell_id, rx_pilot_bins.shape[-1], rx_pilot_bins.re.device)
    return rx_pilot_bins * known.conj()


def pilot_snr_db(rx_pilot_bins: C, cell_id: int = 0, axis=None,
                 known: Optional[C] = None) -> torch.Tensor:
    if known is None:
        known = known_pilots(cell_id, rx_pilot_bins.shape[-1], rx_pilot_bins.re.device)
    p = rx_pilot_bins.abs2()
    n = (rx_pilot_bins - known).abs2()
    p, n = (p.mean(), n.mean()) if axis is None else (p.mean(dim=axis), n.mean(dim=axis))
    return 10.0 * torch.log10(p / (n + 1e-10) + 1e-10)


def interp_tables(config: LTEConfig, out_bins: Optional[np.ndarray] = None,
                  device=None, pilot_idx: Optional[np.ndarray] = None) -> tuple:
    """(left, right, w) of grid.interp_table (or, for a pilot subset
    `pilot_idx`, of grid.interp_table_custom) restricted to `out_bins`, as
    tensors on `device` (int64, int64, float32)."""
    if pilot_idx is None:
        left, right, w = interp_table(config.N, config.Nc)
    else:
        left, right, w = interp_table_custom(tuple(int(i) for i in pilot_idx), config.N)
    if out_bins is not None:
        left, right, w = left[out_bins], right[out_bins], w[out_bins]
    return (torch.tensor(left, dtype=torch.int64, device=device),
            torch.tensor(right, dtype=torch.int64, device=device),
            torch.tensor(w, device=device))


def interpolate(h_pilots: C, config: LTEConfig, out_bins: Optional[np.ndarray] = None,
                table: Optional[tuple] = None, pilot_idx: Optional[np.ndarray] = None) -> C:
    """Linear interp of pilot estimates to `out_bins` (default: all N bins).

    h_pilots: (..., num_pilot) -> (..., len(out_bins)). `pilot_idx` names the
    bins of h_pilots when they are a subset of the CRS grid. `table` is the
    (left, right, w) of interp_tables for the same out_bins and pilot_idx.
    """
    if table is None:
        table = interp_tables(config, out_bins, h_pilots.re.device, pilot_idx)
    left, right, w = table
    wl = 1.0 - w
    hl = cplx.take(h_pilots, left, axis=-1)
    hr = cplx.take(h_pilots, right, axis=-1)
    return C(wl * hl.re + w * hr.re, wl * hl.im + w * hr.im)


def slot_periodic(values: C, num_symbols: int, slot_size: int = SLOT_SIZE) -> C:
    """Broadcast slot-start estimates to every symbol in the slot.

    values: (..., num_slots, K) with num_slots = ceil(S/slot_size)
    -> (..., S, K).
    """
    sym2slot = torch.arange(num_symbols, device=values.re.device) // slot_size
    return cplx.take(values, sym2slot, axis=values.ndim - 2)


def slot_start_indices(num_symbols: int, slot_size: int = SLOT_SIZE) -> np.ndarray:
    return np.arange(0, num_symbols, slot_size)


def zf_equalize(y: C, h: C, regularization: float = 1e-6) -> C:
    """Zero-forcing X̂ = Y/(Ĥ+ε) with a real-added ε."""
    return y / C(h.re + regularization, h.im)


def mrc_combine(y: C, h: C, antenna_axis: int = 0, regularization: float = 1e-10) -> C:
    """Frequency-domain maximum-ratio combining over an antenna axis:
        Ŝ = Σ_i conj(H_i)·Y_i / (Σ_i |H_i|² + ε)."""
    num = (h.conj() * y).sum(axis=antenna_axis)
    den = h.abs2().sum(dim=antenna_axis) + regularization
    return C(num.re / den, num.im / den)
