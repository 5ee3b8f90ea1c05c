"""Rate matching for turbo codes (TS 36.212 §5.1.4) as precomputed gathers.

Port of ofdm_lte_tpu/coding/rate_matching.py. For a fixed (K, E, rv) the
whole forward rate matching is one gather, out = src[fwd_idx], and the LLR
de-matching is a sum over the circular buffer's wraps and one gather. The
index tables are NumPy, built once and cached; their device copies are kept
by coding.tables.

Conventions kept from the JAX package:
- a 32-column sub-block interleaver with the fixed permutation P,
  column-major fill, NULLs at the tail of the column-major order, row-major
  readout with the NULLs removed;
- streams d0 = sys + tail1 + tail2 (K+6), d1/d2 = parity + tail (K+3),
  zero-padded to one length and interlaced into the circular buffer as
  [v0_i, v1_i, v2_i] (the strict 36.212 layout keeps v0 contiguous);
- RV start offsets {0, ¼, ½, ¾}·N_cb;
- de-matching sums repeated LLRs (soft combining) and leaves punctured
  positions at LLR 0.

The sum over repeats does not scatter-add (on a card `index_add_` adds
repeats by atomics, in no fixed order). Position i of the E LLRs lands at
(start + i) mod N_cb, so the LLRs laid end to end from `start` fill
⌈(start + E)/N_cb⌉ rows of N_cb, and the rows are added in order: the
order of the JAX package's sequential scatter-add, bit for bit, on every
device.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .tables import on_device

SUBBLOCK_PERM = np.array([
    0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31], np.int64)


@functools.lru_cache(maxsize=None)
def subblock_perm_indices(K_pi: int) -> np.ndarray:
    """perm such that v[j] = d[perm[j]] for a K_pi-length stream."""
    R = -(-K_pi // 32)
    src = SUBBLOCK_PERM[None, :] * R + np.arange(R)[:, None]    # (row, column), row-major
    src = src.ravel()
    return src[src < K_pi].astype(np.int64)


@functools.lru_cache(maxsize=None)
def _stream_maps(K: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each d-stream position's index in the encoder's interlaced output
    (3K+12), following turbo_encode's layout."""
    d0 = np.concatenate([3 * np.arange(K), 3 * K + np.arange(3), 3 * K + 6 + np.arange(3)])
    d1 = np.concatenate([3 * np.arange(K) + 1, 3 * K + 3 + np.arange(3)])
    d2 = np.concatenate([3 * np.arange(K) + 2, 3 * K + 9 + np.arange(3)])
    return d0, d1, d2


@functools.lru_cache(maxsize=None)
def _cb_source(K: int) -> np.ndarray:
    """For each circular-buffer position: its source index in the encoder
    output (3K+12), or -1 for a zero pad."""
    d0m, d1m, d2m = _stream_maps(K)
    streams = (d0m[subblock_perm_indices(K + 6)], d1m[subblock_perm_indices(K + 3)],
               d2m[subblock_perm_indices(K + 3)])
    max_len = K + 6
    cb = np.full(3 * max_len, -1, np.int64)
    for j, v in enumerate(streams):
        cb[j:3 * max_len:3][:len(v)] = v
    return cb


def _start(N_cb: int, rv_idx: int) -> int:
    return [0, N_cb // 4, N_cb // 2, 3 * N_cb // 4][rv_idx % 4]


@functools.lru_cache(maxsize=None)
def forward_indices(K: int, E: int, rv_idx: int = 0) -> np.ndarray:
    """Gather index: rate_matched[i] = padded_encoded[fwd[i]], where
    padded_encoded is the 3K+12 encoder bits and one zero at index 3K+12
    (for the pads)."""
    cb = _cb_source(K)
    src = cb[(_start(len(cb), rv_idx) + np.arange(E)) % len(cb)]
    return np.where(src < 0, 3 * K + 12, src).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _enc_from_cb(K: int) -> np.ndarray:
    """Each encoder bit's circular-buffer position (N_cb, a zero slot, for a
    bit the buffer lacks)."""
    cb = _cb_source(K)
    enc_from_cb = np.full(3 * K + 12, len(cb), np.int32)
    kept = np.flatnonzero(cb >= 0)
    enc_from_cb[cb[kept]] = kept          # each source occurs once in the buffer
    return enc_from_cb


@functools.lru_cache(maxsize=None)
def dematch_tables(K: int, E: int, rv_idx: int = 0):
    """(cb_positions (E,), enc_from_cb (3K+12,)) for LLR de-matching: where
    each LLR lands in the circular buffer, and where each encoder bit is."""
    N_cb = 3 * (K + 6)
    pos = ((_start(N_cb, rv_idx) + np.arange(E)) % N_cb).astype(np.int32)
    return pos, _enc_from_cb(K)


def rate_match(encoded: torch.Tensor, E: int, K: int, rv_idx: int = 0,
               fwd: torch.Tensor = None) -> torch.Tensor:
    """encoded (..., 3K+12) -> (..., E). One gather; `fwd` is
    forward_indices(K, E, rv_idx) as int64 on the device (kept by
    coding.tables when None)."""
    if fwd is None:
        fwd = on_device(("rm_fwd", K, E, rv_idx), lambda: forward_indices(K, E, rv_idx).astype(
            np.int64), encoded.device)
    padded = torch.cat([encoded, encoded.new_zeros(encoded.shape[:-1] + (1,))], dim=-1)
    return torch.index_select(padded, -1, fwd)


def rate_dematch(llrs: torch.Tensor, K: int, rv_idx: int = 0,
                 enc_from_cb: torch.Tensor = None) -> torch.Tensor:
    """llrs (..., E) -> encoder-order LLRs (..., 3K+12).

    Repetitions soft-combine (a sum, wrap by wrap in order); punctured
    positions stay 0. `enc_from_cb` is _enc_from_cb(K) as int64 on the
    device (kept by coding.tables when None)."""
    E = llrs.shape[-1]
    N_cb = 3 * (K + 6)
    start = _start(N_cb, rv_idx)
    wraps = max(1, -(-(start + E) // N_cb))
    lead = llrs.shape[:-1]
    laid = torch.nn.functional.pad(llrs, (start, wraps * N_cb - start - E))
    laid = laid.reshape(lead + (wraps, N_cb))
    cb = laid[..., 0, :]
    for w in range(1, wraps):
        cb = cb + laid[..., w, :]
    cb = torch.cat([cb, llrs.new_zeros(lead + (1,))], dim=-1)       # the zero slot N_cb
    if enc_from_cb is None:
        enc_from_cb = on_device(("rm_dematch", K), lambda: _enc_from_cb(K).astype(np.int64),
                                llrs.device)
    return torch.index_select(cb, -1, enc_from_cb)
