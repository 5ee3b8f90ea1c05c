"""The spatial link's SIC detector in one pass: the CUDA kernel's wrapper and
its plain version.

From the received planes y (num_rx, ...) of the layer bins, the per-TX
channel estimates h_tx[t] (num_rx, ...) and the precoder W (num_tx, L):

    heff[rx, l] = Σ_t h_tx[t][rx] · W[t, l]          (summed in t order)
    ŝ           = mimo/detector.sic_stacked(y, heff, σ², modulation)

returned as the L hard decisions of each (…, S, m) site in the (…, S, m, L)
layout, whose layer axis the layer demap folds into symbol order.

On a CPU tensor `sic_detect` runs `sic_detect_plain`, which is that product
and `sic_stacked`. On a CUDA tensor it launches csrc/sic_detect.cu (built on
first use, _build.py), which repeats the same operations in registers, one
thread a site, with the same rounding and tie rule, or raises; it never falls
back. Each launch adds one to `sic_detect.launches`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch

from ..cplx import C
from ..mimo import detector
from . import qam

MAX_TX = 8          # the kernel's most TX antennas
MAX_LAYERS = 4      # and layers: detector._solve_s's closed forms


def sic_detect_plain(y: C, h_tx: Sequence[C], W: C, sigma2, modulation: str) -> C:
    """The decisions (..., L) in plain PyTorch: the effective channel, then
    mimo/detector.sic_stacked."""
    s = detector.sic_stacked(y, detector.effective_planes(h_tx, W), sigma2, modulation)
    return C(s.re.movedim(0, -1), s.im.movedim(0, -1))


def _check(y: C, h_tx: Sequence[C], W: C) -> None:
    if y.ndim < 1 or any(tuple(h.shape) != tuple(y.shape) for h in h_tx):
        raise ValueError(f"sic_detect: y {tuple(y.shape)} and h_tx "
                         f"{[tuple(h.shape) for h in h_tx]} must share one (num_rx, ...) shape")
    if W.ndim != 2 or W.shape[0] != len(h_tx) or not 1 <= W.shape[1] <= MAX_LAYERS:
        raise ValueError(f"sic_detect: W {tuple(W.shape)}, expected ({len(h_tx)}, L) with "
                         f"L in 1..{MAX_LAYERS}")
    if not 1 <= len(h_tx) <= MAX_TX:
        raise ValueError(f"sic_detect: {len(h_tx)} TX antennas, the kernel takes 1..{MAX_TX}")


def sic_detect(y: C, h_tx: Sequence[C], W: C, sigma2, modulation: str) -> C:
    """The L hard decisions (..., L) of SIC over the effective channel h_tx·W:
    `sic_detect_plain` on a CPU tensor, one launch of csrc/sic_detect.cu on a
    CUDA tensor. σ² is a scalar or one value per lane (a prefix of the site
    axes, as sic_stacked aligns it)."""
    _check(y, h_tx, W)
    dev = y.re.device
    if dev.type == "cpu":
        return sic_detect_plain(y, h_tx, W, sigma2, modulation)
    if dev.type != "cuda":
        raise ValueError(f"sic_detect: no kernel for device {dev}")
    num_rx, num_tx, L = y.shape[0], len(h_tx), W.shape[1]
    plane = tuple(y.shape[1:])
    sites = math.prod(plane)
    planes = (y.re, y.im, W.re, W.im, *(p for h in h_tx for p in h))
    for p in planes:
        if p.dtype != torch.float32 or p.device != dev or not p.is_contiguous():
            raise ValueError(f"sic_detect: the kernel reads contiguous float32 planes on "
                             f"{dev}, got {p.dtype} {tuple(p.stride())} on {p.device}")
    if num_rx * sites >= 2 ** 31:
        raise ValueError("sic_detect: the planes exceed int32 indexing")
    out = C(torch.empty(plane + (L,), dtype=torch.float32, device=dev),
            torch.empty(plane + (L,), dtype=torch.float32, device=dev))
    if sites == 0:
        return out
    s2 = detector._as_sigma(sigma2, dev)
    if isinstance(s2, torch.Tensor):
        # one value for each run of sites that shares the leading indices
        s2 = s2.expand(plane[:s2.ndim]).contiguous()
        s2_ptr, s2_scalar, s2_per = s2.data_ptr(), 0.0, sites // s2.numel()
    else:
        s2_ptr, s2_scalar, s2_per = None, s2, 1
    spec = qam.spec(modulation)
    # torch divides by a Python scalar on the card as a multiply by its fp32
    # reciprocal (qam.detect's `/ norm`): the kernel takes that reciprocal
    norm = np.float32(spec.norm)
    inv_norm = np.float32(1.0) / norm
    from .._build import library
    lib = library()
    ptrs = ctypes.c_void_p * num_tx
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sic_detect(y.re.data_ptr(), y.im.data_ptr(),
                            ptrs(*(h.re.data_ptr() for h in h_tx)),
                            ptrs(*(h.im.data_ptr() for h in h_tx)), W.re.data_ptr(),
                            W.im.data_ptr(), s2_ptr, s2_scalar, s2_per, out.re.data_ptr(),
                            out.im.data_ptr(), num_rx, num_tx, L, len(spec.levels), sites,
                            float(norm), float(inv_norm), stream)
    if rc != 0:
        raise RuntimeError(f"sic_detect launch failed: CUDA error {rc} (num_rx={num_rx}, "
                           f"num_tx={num_tx}, L={L}, {modulation}, sites={sites})")
    sic_detect.launches += 1
    return out


sic_detect.launches = 0
