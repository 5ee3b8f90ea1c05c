"""MIMO channel legs: per-(tx, rx)-link fading + one noise injection per RX.

Port of ofdm_lte_tpu/channel/mimo.py:

- transmit_simo: one TX signal through num_rx independent channels.
- mimo_mix_noiseless / transmit_mimo:
  * 'awgn' mode: fixed unit taps with 90°/TX phase separation,
    h[rx, tx] = exp(i·tx·π/2);
  * 'rayleigh_mp' mode: independent multipath fading per link (no noise),
    summed at each RX;
  * one AWGN injection per RX with power (P_rx/num_tx)/snr.
- spatial_mix_noiseless / transmit_spatial_multiplexing (TM4):
  * flat mode: one iid CN(0,1) scalar per link and lane;
  * 'rayleigh_mp' mode: independent multipath fading per link;
  * noise power P_rx/snr per RX, not divided by num_tx.

Antennas are a leading array axis: where the JAX package maps a function
over per-leg keys, the port makes one draw with a leading antenna axis
from one generator, and all links go through one Jakes product and FIR
(or, on the card at `highest`, one launch of the fused multipath pass, which
also sums the TX antennas).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import cplx
from ..cplx import C
from .awgn import snr_linear, standard_normals
from .rayleigh import MultipathProfile, apply_multipath, flat_mimo_matrix


def _mix_links(H: C, signals_tx: C, num_rx: int) -> C:
    """y[rx] = Σ_tx H[..., rx, tx] · x[tx] as elementwise multiply-adds.

    H: (rx, tx) constant or (lanes..., rx, tx); signals_tx: (tx, lanes..., T)
    -> (rx, lanes..., T)."""
    num_tx = signals_tx.shape[0]
    ys = []
    for r in range(num_rx):
        acc_re, acc_im = 0.0, 0.0
        for t in range(num_tx):
            hre, him = H.re[..., r, t], H.im[..., r, t]
            if hre.ndim:                     # per-lane H: append the sample axis
                hre, him = hre[..., None], him[..., None]
            xr, xi = signals_tx.re[t], signals_tx.im[t]
            acc_re = acc_re + (hre * xr - him * xi)
            acc_im = acc_im + (hre * xi + him * xr)
        ys.append(C(acc_re, acc_im))
    return cplx.stack(ys, axis=0)


def _lane_snr(snr_db, p: torch.Tensor, lead: int):
    """10^(snr/10) aligned against a power `p` of shape (*lead axes,
    lanes..., 1): a per-lane SNR follows the leading LANE axes."""
    snr_lin = snr_linear(snr_db, p.device)
    if isinstance(snr_lin, torch.Tensor) and snr_lin.ndim:
        snr_lin = snr_lin.reshape(tuple(snr_lin.shape) + (1,) * (p.ndim - lead - snr_lin.ndim))
    return snr_lin


def _per_rx_noise(y: C, snr_db, power_scale: float = 1.0,
                  generator: Optional[torch.Generator] = None, noise=None) -> C:
    """Add AWGN per RX leg: noise_power = power_scale·P_rx/snr, measured over
    the last axis per leg and lane. y: (rx, lanes..., T); `noise` is the
    (re, im) seam of standard normals shaped like y."""
    p = y.abs2().mean(dim=-1, keepdim=True)
    std = torch.sqrt(power_scale * p / _lane_snr(snr_db, p, 1) / 2.0)
    n = standard_normals(y.shape, generator, y.re.device, noise)
    return C(y.re + n.re * std, y.im + n.im * std)


def transmit_simo(signal: C, snr_db, num_rx: int, channel_type: str,
                  profile: Optional[MultipathProfile] = None,
                  generator: Optional[torch.Generator] = None, phases=None,
                  noise=None) -> C:
    """One TX signal through num_rx independent channels.

    signal (..., T) -> (num_rx, ..., T). Each leg's noise power is measured
    on that leg (and lane) after fading. Seams: `phases` (num_rx·lanes·taps,
    16) Jakes phases, `noise` standard normals shaped like the output."""
    if channel_type == "awgn":
        y = C(signal.re.expand((num_rx,) + tuple(signal.shape)),
              signal.im.expand((num_rx,) + tuple(signal.shape)))
    elif channel_type == "rayleigh_mp":
        y = apply_multipath(signal, profile, generator=generator, phases=phases,
                            links=(num_rx,))
    else:
        raise ValueError(f"unknown channel_type {channel_type}")
    return _per_rx_noise(y, snr_db, 1.0, generator, noise)


def _mix(signals_tx: C, num_rx: int, channel_type: str,
         profile: Optional[MultipathProfile], generator, phases) -> Tuple[C, C]:
    num_tx = signals_tx.shape[0]
    dev = signals_tx.re.device
    if channel_type == "awgn":
        H = cplx.const(np.tile(np.exp(1j * np.arange(num_tx) * np.pi / 2)[None, :],
                               (num_rx, 1)), dev)
        return _mix_links(H, signals_tx, num_rx), H
    if channel_type != "rayleigh_mp":
        raise ValueError(f"unknown channel_type {channel_type}")
    # independent multipath fading per (rx, tx) link, summed over tx
    return _multipath_links(signals_tx, num_rx, profile, generator, phases), \
        cplx.cones((num_rx, num_tx), dev)


def _multipath_links(signals_tx: C, num_rx: int, profile: MultipathProfile, generator,
                     phases) -> C:
    """Independent multipath fading per (rx, tx) link, summed over tx:
    signals_tx (tx, ..., T) -> (rx, ..., T). `phases` is
    (num_rx·num_tx·lanes·taps, 16), the links in (rx, tx, lane, tap) order."""
    return apply_multipath(signals_tx, profile, generator=generator, phases=phases,
                           links=(num_rx,), sum_tx=True)


def mimo_mix_noiseless(signals_tx: C, snr_db, num_rx: int, channel_type: str,
                       profile: Optional[MultipathProfile] = None,
                       generator: Optional[torch.Generator] = None, phases=None):
    """transmit_mimo's fading/mixing without the noise: returns
    (y (num_rx, ..., T), H, noise_power (num_rx, ...)) with noise power
    (P_rx/num_tx)/snr. `phases`: (num_rx·num_tx·lanes·taps, 16)."""
    num_tx = signals_tx.shape[0]
    y, H = _mix(signals_tx, num_rx, channel_type, profile, generator, phases)
    p = y.abs2().mean(dim=-1)                                  # (rx, ...)
    return y, H, (p / num_tx) / snr_linear(snr_db, p.device)


def transmit_mimo(signals_tx: C, snr_db, num_rx: int, channel_type: str,
                  profile: Optional[MultipathProfile] = None,
                  generator: Optional[torch.Generator] = None, phases=None,
                  noise=None) -> Tuple[C, C]:
    """signals_tx (num_tx, ..., T) -> (y (num_rx, ..., T), H (num_rx, num_tx)).

    H is the fixed AWGN-mode tap matrix (exact) or ones (multipath mode: the
    receiver's CRS estimation supplies the CSI)."""
    num_tx = signals_tx.shape[0]
    y, H = _mix(signals_tx, num_rx, channel_type, profile, generator, phases)
    return _per_rx_noise(y, snr_db, 1.0 / num_tx, generator, noise), H


def spatial_mix_noiseless(signals_tx: C, snr_db, num_rx: int, channel_type: str,
                          profile: Optional[MultipathProfile] = None,
                          generator: Optional[torch.Generator] = None, phases=None,
                          fading=None):
    """The spatial-multiplexing channel's fading/mixing without the noise:
    returns (y (num_rx, ..., T), H, noise_power (num_rx, ...)).

    Flat mode (any channel_type but 'rayleigh_mp'): H (lanes..., rx, tx) iid
    CN(0,1), one matrix a lane, applied as scalars; `fading` is the (re, im)
    seam of its standard normals. Multipath: per-link Jakes fading, `phases`
    (num_rx·num_tx·lanes·taps, 16), H returned as ones (CRS estimation
    supplies the CSI). noise_power is P_rx/snr measured per RX and lane on
    the faded signal, not divided by num_tx (unlike mimo_mix_noiseless);
    the caller injects CN noise of that variance where it observes the
    signal."""
    num_tx = signals_tx.shape[0]
    lanes = tuple(signals_tx.shape[1:-1])
    dev = signals_tx.re.device
    if channel_type == "rayleigh_mp":
        y = _multipath_links(signals_tx, num_rx, profile, generator, phases)
        H = cplx.cones(lanes + (num_rx, num_tx), dev)
    else:
        H = flat_mimo_matrix(num_rx, num_tx, lanes, generator, dev, fading)
        y = _mix_links(H, signals_tx, num_rx)
    p = y.abs2().mean(dim=-1)                                  # (rx, ...)
    return y, H, p / snr_linear(snr_db, p.device)


def transmit_spatial_multiplexing(signals_tx: C, snr_db, num_rx: int, channel_type: str,
                                  profile: Optional[MultipathProfile] = None,
                                  generator: Optional[torch.Generator] = None,
                                  phases=None, fading=None, noise=None) -> Tuple[C, C]:
    """TM4 spatial-multiplexing channel with the noise injected in the time
    domain: signals_tx (num_tx, ..., T) -> (y (num_rx, ..., T), H). The
    spatial link itself uses spatial_mix_noiseless and noise at the bins.
    `noise` is the (re, im) seam of standard normals shaped like y."""
    y, H, noise_power = spatial_mix_noiseless(signals_tx, snr_db, num_rx, channel_type,
                                              profile, generator, phases, fading)
    std = torch.sqrt(noise_power[..., None] / 2.0)
    n = standard_normals(y.shape, generator, y.re.device, noise)
    return C(y.re + n.re * std, y.im + n.im * std), H
