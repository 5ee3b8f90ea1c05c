"""AWGN channel with an explicit torch.Generator.

Port of ofdm_lte_tpu/channel/awgn.py: the SNR is defined against the
measured mean power of the input signal, and complex noise has variance
σ²/2 per I/Q component. A `torch.Generator` takes the place of the JAX
key; the two give different numbers from the same seed.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..cplx import C


def _normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def awgn(signal: C, snr_db, measure_axes=None,
         generator: Optional[torch.Generator] = None) -> C:
    """Add complex white Gaussian noise at the given SNR.

    snr_db may be a scalar or a tensor broadcastable against the leading
    axes (e.g. one SNR per Monte-Carlo lane). measure_axes: axes over which
    signal power is averaged to define the SNR (default: all).
    """
    snr_lin = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32,
                                       device=signal.re.device) / 10.0)
    p = signal.abs2()
    if measure_axes is None:
        sig_power = p.mean()
    else:
        sig_power = p.mean(dim=measure_axes, keepdim=True)
    # align per-lane SNR (leading axes) against the kept-dims power shape
    if 0 < snr_lin.ndim < sig_power.ndim:
        snr_lin = snr_lin.reshape(tuple(snr_lin.shape)
                                  + (1,) * (sig_power.ndim - snr_lin.ndim))
    std = torch.sqrt(sig_power / snr_lin / 2.0)
    nr = _normal(signal.re.shape, generator, signal.re.device) * std
    ni = _normal(signal.im.shape, generator, signal.im.device) * std
    return C(signal.re + nr, signal.im + ni)


def noise_like(shape, noise_power, generator: Optional[torch.Generator] = None,
               device=None) -> C:
    """Complex Gaussian noise with total variance noise_power (σ²/2 per leg)."""
    std = torch.sqrt(torch.as_tensor(noise_power, dtype=torch.float32, device=device) / 2.0)
    return C(_normal(shape, generator, device) * std,
             _normal(shape, generator, device) * std)
