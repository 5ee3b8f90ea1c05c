"""TS 36.211 §6.3.3 layer mapping as reshapes.

Port of ofdm_lte_tpu/mimo/layer_mapper.py. Round-robin symbols -> rank
layers: symbols s0, s1, s2, ... map to layers[l][i] = s[i·L + l], i.e.
reshape(n/L, L) transposed.
"""
from __future__ import annotations

from typing import Optional

from ..cplx import C


def padded_length(n: int, num_layers: int) -> int:
    """Length after zero-padding to a multiple of num_layers."""
    if num_layers == 1:
        return n
    r = n % num_layers
    return n if r == 0 else n + num_layers - r


def _swap_last_two(x: C) -> C:
    nd = x.ndim
    return x.transpose(*range(nd - 2), nd - 1, nd - 2)


def map_to_layers(symbols: C, num_layers: int) -> C:
    """(..., n) -> (..., num_layers, n/num_layers). n must already be padded
    to a multiple of num_layers (use padded_length)."""
    n = symbols.shape[-1]
    lead = tuple(symbols.shape[:-1])
    return _swap_last_two(symbols.reshape(lead + (n // num_layers, num_layers)))


def demap_from_layers(layers: C, original_length: Optional[int] = None) -> C:
    """Inverse: (..., L, m) -> (..., L·m), truncated to original_length."""
    lead = tuple(layers.shape[:-2])
    L, m = layers.shape[-2], layers.shape[-1]
    out = _swap_last_two(layers).reshape(lead + (L * m,))
    if original_length is not None:
        out = out[..., :original_length]
    return out
