"""AWGN channel with an explicit torch.Generator.

Port of ofdm_lte_tpu/channel/awgn.py: the SNR is defined against the
measured mean power of the input signal, and complex noise has variance
σ²/2 per I/Q component. A `torch.Generator` takes the place of the JAX
key; the two give different numbers from the same seed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..cplx import C


def _normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def standard_normals(shape, generator: Optional[torch.Generator], device,
                     given=None, what: str = "noise") -> C:
    """A planar pair of standard normals of `shape` on `device`: the
    generator's draws, or the caller's `given` (re, im) pair (the seam
    through which a test feeds both packages the same numbers)."""
    if given is None:
        return C(_normal(shape, generator, device), _normal(shape, generator, device))
    re, im = (torch.as_tensor(v, dtype=torch.float32, device=device) for v in given)
    if tuple(re.shape) != tuple(shape) or tuple(im.shape) != tuple(shape):
        raise ValueError(f"{what} planes {tuple(re.shape)}/{tuple(im.shape)}, "
                         f"expected {tuple(shape)}")
    return C(re, im)


# the base of snr_linear's power as a CPU scalar tensor, which a card's pow
# kernel reads on the host: a Python float base is first made a tensor on the
# card, one launch more a call for the same values
_TEN = torch.tensor(10.0)


def snr_linear(snr_db, device):
    """10^(snr/10) in float32: a Python float for a scalar (no host-to-device
    copy on the hot path), else a tensor on `device`."""
    if isinstance(snr_db, torch.Tensor):
        return torch.pow(_TEN, snr_db.to(device=device, dtype=torch.float32) / 10.0)
    snr = np.asarray(snr_db, np.float32)
    if snr.ndim == 0:
        return float(np.float32(10.0) ** (snr / np.float32(10.0)))
    return torch.pow(_TEN, torch.as_tensor(snr, device=device) / 10.0)


def awgn(signal: C, snr_db, measure_axes=None,
         generator: Optional[torch.Generator] = None, noise=None) -> C:
    """Add complex white Gaussian noise at the given SNR.

    snr_db may be a scalar or a tensor broadcastable against the leading
    axes (e.g. one SNR per Monte-Carlo lane). measure_axes: axes over which
    signal power is averaged to define the SNR (default: all). `noise`, a
    (re, im) pair of standard normals shaped like the signal, replaces the
    generator's draws; the scale stays σ/√2 per leg.
    """
    snr_lin = torch.as_tensor(snr_linear(snr_db, signal.re.device), dtype=torch.float32,
                              device=signal.re.device)
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
    n = standard_normals(signal.shape, generator, signal.re.device, noise)
    return C(signal.re + n.re * std, signal.im + n.im * std)


def noise_like(shape, noise_power, generator: Optional[torch.Generator] = None,
               device=None) -> C:
    """Complex Gaussian noise with total variance noise_power (σ²/2 per leg)."""
    std = torch.sqrt(torch.as_tensor(noise_power, dtype=torch.float32, device=device) / 2.0)
    return C(_normal(shape, generator, device) * std,
             _normal(shape, generator, device) * std)
