"""LTE resource grid: static index tables and CRS pilot sequences.

A NumPy-only copy of ofdm_lte_tpu/grid.py; tests/test_torch_tables.py
holds its tables element-exact against the JAX package's. Layout rules (as
the JAX package):

- symmetric guards: left = (N-Nc)//2, right = N-Nc-left
- DC null at k = N//2
- pilots where (k - guard_left) % 6 == 3 inside the useful band, excluding DC
- data = remaining useful bins

CRS pilots are (1+1j)/√2 · ±1 with the ±1 drawn from a local MT19937
stream seeded by cell_id, so the global NumPy RNG is never touched.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from .config import LTEConfig


class GridIndex(NamedTuple):
    """Static index tables for one numerology (NumPy arrays)."""

    N: int
    Nc: int
    guard_left: int
    guard_right: int
    dc_index: int
    data_idx: np.ndarray     # (num_data,)  int32
    pilot_idx: np.ndarray    # (num_pilot,) int32
    guard_idx: np.ndarray    # (num_guard,) int32

    @property
    def num_data(self) -> int:
        return len(self.data_idx)

    @property
    def num_pilot(self) -> int:
        return len(self.pilot_idx)


@functools.lru_cache(maxsize=None)
def make_grid(N: int, Nc: int) -> GridIndex:
    guard_left = (N - Nc) // 2
    guard_right = N - Nc - guard_left
    dc = N // 2

    k = np.arange(N)
    in_band = (k >= guard_left) & (k < N - guard_right)
    is_dc = k == dc
    is_pilot = in_band & ~is_dc & ((k - guard_left) % 6 == 3)
    is_data = in_band & ~is_dc & ~is_pilot
    is_guard = ~in_band

    return GridIndex(
        N=N, Nc=Nc, guard_left=guard_left, guard_right=guard_right, dc_index=dc,
        data_idx=np.nonzero(is_data)[0].astype(np.int32),
        pilot_idx=np.nonzero(is_pilot)[0].astype(np.int32),
        guard_idx=np.nonzero(is_guard)[0].astype(np.int32),
    )


def grid_for(config: LTEConfig) -> GridIndex:
    return make_grid(config.N, config.Nc)


@functools.lru_cache(maxsize=None)
def pilot_sequence(cell_id: int, num_pilots: int) -> np.ndarray:
    """CRS pilot symbols (1+1j)/√2 · choice([1,-1]) from MT19937(cell_id)."""
    rs = np.random.RandomState(cell_id)
    phases = rs.choice([1, -1], size=num_pilots)
    return ((1 + 1j) / np.sqrt(2) * phases).astype(np.complex128)


@functools.lru_cache(maxsize=None)
def interp_table(N: int, Nc: int) -> tuple:
    """Linear-interpolation table for CRS channel estimation.

    For every bin k in [0, N): the indices (into the pilot array) of the
    left/right bracketing pilots and the weight w in [0, 1], with constant
    extrapolation at the edges:

        H[k] = (1-w)·Hp[left] + w·Hp[right]

    Returns (left, right, w) NumPy arrays of shape (N,).
    """
    return _interp_table_for(make_grid(N, Nc).pilot_idx, N)


def _interp_table_for(pilot_idx, N: int) -> tuple:
    p = np.asarray(pilot_idx, dtype=np.int64)
    k = np.arange(N)

    right = np.searchsorted(p, k, side="left")          # first pilot >= k
    left = right - 1
    left_c = np.clip(left, 0, len(p) - 1)
    right_c = np.clip(right, 0, len(p) - 1)

    denom = np.maximum(p[right_c] - p[left_c], 1)
    w = (k - p[left_c]) / denom
    # edges: before first pilot -> pilot 0 (w=0); at/after last pilot -> last
    w = np.where(right == 0, 0.0, w)
    w = np.where(left >= len(p) - 1, 0.0, w)
    w = np.clip(w, 0.0, 1.0)

    return (left_c.astype(np.int32), right_c.astype(np.int32), w.astype(np.float32))


@functools.lru_cache(maxsize=None)
def interp_table_custom(pilot_idx_tuple: tuple, N: int) -> tuple:
    """The same table for an arbitrary static pilot index set: the MIMO
    estimator's per-TX orthogonal pilots are subsets of the CRS grid."""
    return _interp_table_for(pilot_idx_tuple, N)


def pilot_step(num_tx: int, layout: str = "reference") -> int:
    """CRS FDM step for `num_tx` antennas.

    layout="reference": step = min(num_tx, 4), so that with 8 TX the
    antennas t and t+4 share pilot bins. layout="extended": step = num_tx,
    every TX on its own disjoint comb."""
    if layout == "reference":
        return num_tx if num_tx <= 4 else 4
    if layout == "extended":
        return num_tx
    raise ValueError(f"unknown pilot layout {layout!r}")


def orthogonal_pilot_indices(config: LTEConfig, num_tx: int,
                             layout: str = "reference") -> list:
    """FDM-orthogonal CRS allocation for MIMO: every `step`-th pilot bin
    with a per-TX offset (see pilot_step)."""
    g = grid_for(config)
    step = pilot_step(num_tx, layout)
    return [g.pilot_idx[tx % step::step] for tx in range(num_tx)]
