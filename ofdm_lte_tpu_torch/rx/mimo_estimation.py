"""Per-TX CRS channel estimation for MIMO with FDM-orthogonal pilots.

Port of ofdm_lte_tpu/rx/mimo_estimation.py for layout="reference":

- TX t transmits CRS on every step-th pilot bin with offset t (step =
  min(num_tx, 4)), using the cell_id = t%4 pilot sequence.
- Per (rx, tx): LS at that TX's pilot bins, linear interpolation to the
  selected bins, estimated once per 14-symbol slot and reused inside it.

layout="extended" (disjoint combs for more than 4 TX, reconstructed
through a delay-domain LS basis) comes with spatial multiplexing.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from .. import cplx
from ..cplx import C
from ..config import LTEConfig
from ..grid import grid_for, pilot_sequence, pilot_step
from . import estimation as est


class TxEstTables(NamedTuple):
    """Device tables of one TX antenna's estimate."""
    known: C            # that TX's CRS pilot sequence
    interp: tuple       # (left, right, w) from its pilot comb to the output bins


def per_tx_tables(config: LTEConfig, num_tx: int, out_bins: np.ndarray,
                  layout: str = "reference", device=None) -> List[TxEstTables]:
    _check_layout(layout)
    g = grid_for(config)
    step = pilot_step(num_tx, layout)
    tables = []
    for tx in range(num_tx):
        idx = g.pilot_idx[tx % step::step]
        tables.append(TxEstTables(
            cplx.const(pilot_sequence(tx % 4, len(idx)), device),
            est.interp_tables(config, out_bins, device, pilot_idx=idx)))
    return tables


def _check_layout(layout: str) -> None:
    if layout == "extended":
        raise NotImplementedError(
            "estimate_per_tx layout='extended' (the delay-domain LS basis): ROADMAP item A14")
    if layout != "reference":
        raise ValueError(f"unknown pilot layout {layout!r}")


def estimate_per_tx_planes(pilot_bins_rx: C, config: LTEConfig, num_tx: int,
                           out_bins: np.ndarray, layout: str = "reference",
                           tables: Optional[List[TxEstTables]] = None) -> List[C]:
    """Per-TX estimates as a list of planes (no trailing tx axis).

    pilot_bins_rx: C (..., n_pilot_all), the received values at ALL CRS
    pilot bins (the union over TX) of one RX. Returns [num_tx] C planes of
    shape (..., len(out_bins))."""
    if tables is None:
        tables = per_tx_tables(config, num_tx, out_bins, layout, pilot_bins_rx.re.device)
    _check_layout(layout)
    step = pilot_step(num_tx, layout)
    per_tx = []
    for tx in range(num_tx):
        rx_p = pilot_bins_rx[..., tx % step::step]
        h_p = rx_p * tables[tx].known.conj()     # unit-modulus pilots: Y/X = Y·X*
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
