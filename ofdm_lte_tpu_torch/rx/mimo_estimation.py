"""Per-TX CRS channel estimation for MIMO with FDM-orthogonal pilots.

Port of ofdm_lte_tpu/rx/mimo_estimation.py:

- TX t transmits CRS on every step-th pilot bin with offset t, using the
  cell_id = t%4 pilot sequence. layout="reference": step = min(num_tx, 4),
  so with 8 TX the antennas t and t+4 collide; layout="extended": step =
  num_tx, every TX on its own comb.
- Per (rx, tx): LS at that TX's pilot bins, then linear interpolation to
  the selected bins; on the sparse combs of more than 4 TX under
  "extended" a delay-domain LS basis instead (`_tap_basis_projection`),
  one small complex GEMM h_p (..., P) @ A (P, n_out) through `_cmm`.
- The caller chooses the symbols: the SFBC link estimates once per
  14-symbol slot, the spatial link on every symbol.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import numpy as np

from .. import cplx
from ..cplx import C
from ..config import LTEConfig
from ..grid import grid_for, pilot_sequence, pilot_step
from ..ops.ofdm import _cmm, _planes
from . import estimation as est


@functools.lru_cache(maxsize=None)
def _tap_basis_projection(pilot_idx: tuple, out_bins: tuple, N: int,
                          num_taps: Optional[int] = None) -> np.ndarray:
    """Delay-domain LS projection matrix A (P, n_out): Ĥ[out] = Ĥ[pilots]·A.

    Models the channel as H[k] = Σ_d h_d·exp(-2πi·k·d/N) over the delays
    d = 0..D-1 (D = num_taps), solves the LS fit at the pilot comb and
    reconstructs H at the output bins:
        A = pinv(F_p)ᵀ @ F_outᵀ,  F[k, d] = exp(-2πi·k·d/N).
    Exact for a channel whose delay spread is under D samples, where linear
    interpolation across a sparse comb (step 8: gaps of about 48 bins)
    breaks down. Default D = max(4, 3P//5): an over-determined fit that
    averages the pilot noise by about P/D and covers pedestrian-class delay
    spreads; pass num_taps to trade noise for reach."""
    p = np.asarray(pilot_idx, np.float64)
    k = np.asarray(out_bins, np.float64)
    P = len(p)
    D = num_taps if num_taps is not None else max(4, (3 * P) // 5)
    D = min(D, P)
    d = np.arange(D)
    F_p = np.exp(-2j * np.pi * p[:, None] * d[None, :] / N)    # (P, D)
    F_o = np.exp(-2j * np.pi * k[:, None] * d[None, :] / N)    # (n_out, D)
    A = np.linalg.pinv(F_p).T @ F_o.T                          # (P, n_out)
    return np.ascontiguousarray(A.astype(np.complex64))


class TxEstTables(NamedTuple):
    """Device tables of one TX antenna's estimate."""
    known: C            # that TX's CRS pilot sequence
    interp: Optional[tuple]                # (left, right, w), comb -> output bins
    basis: Optional[C] = None              # the tap-basis A (P, n_out), row-major


def _uses_tap_basis(num_tx: int, layout: str) -> bool:
    return layout == "extended" and pilot_step(num_tx, layout) > 4


def per_tx_tables(config: LTEConfig, num_tx: int, out_bins: np.ndarray,
                  layout: str = "reference", device=None) -> List[TxEstTables]:
    g = grid_for(config)
    step = pilot_step(num_tx, layout)
    tables = []
    for tx in range(num_tx):
        idx = g.pilot_idx[tx % step::step]
        known = cplx.const(pilot_sequence(tx % 4, len(idx)), device)
        if _uses_tap_basis(num_tx, layout):
            A = _tap_basis_projection(tuple(int(b) for b in idx),
                                      tuple(int(b) for b in out_bins), config.N)
            tables.append(TxEstTables(known, None, _planes(A.real, A.imag, device)))
        else:
            tables.append(TxEstTables(
                known, est.interp_tables(config, out_bins, device, pilot_idx=idx)))
    return tables


def estimate_per_tx_planes(pilot_bins_rx: C, config: LTEConfig, num_tx: int,
                           out_bins: np.ndarray, layout: str = "reference",
                           tables: Optional[List[TxEstTables]] = None) -> List[C]:
    """Per-TX estimates as a list of planes (no trailing tx axis).

    pilot_bins_rx: C (..., n_pilot_all), the received values at ALL CRS
    pilot bins (the union over TX) of one RX. Returns [num_tx] C planes of
    shape (..., len(out_bins))."""
    if tables is None:
        tables = per_tx_tables(config, num_tx, out_bins, layout, pilot_bins_rx.re.device)
    step = pilot_step(num_tx, layout)
    per_tx = []
    for tx in range(num_tx):
        rx_p = pilot_bins_rx[..., tx % step::step]
        h_p = rx_p * tables[tx].known.conj()     # unit-modulus pilots: Y/X = Y·X*
        if tables[tx].basis is not None:
            # sparse comb: reconstruct through the delay-domain LS basis
            per_tx.append(_cmm(h_p, tables[tx].basis))
        else:
            per_tx.append(est.interpolate(h_p, config, table=tables[tx].interp))
    return per_tx


def estimate_per_tx(pilot_bins_rx: C, config: LTEConfig, num_tx: int,
                    out_bins: np.ndarray, layout: str = "reference",
                    tables: Optional[List[TxEstTables]] = None) -> C:
    """Estimate H for each TX from the full received pilot-bin vector.

    pilot_bins_rx: C (..., n_pilot_all). Returns C (..., num_tx, len(out_bins)).
    """
    return cplx.stack(
        estimate_per_tx_planes(pilot_bins_rx, config, num_tx, out_bins, layout, tables),
        axis=-2)
