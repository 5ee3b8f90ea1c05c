"""Monte-Carlo BER/PAPR sweeps on one device.

Port of ofdm_lte_tpu/parallel/sweep.py's `ber_sweep` for one GPU: the SNR
points and the Monte-Carlo frames are the lanes of ONE call of a link's
`forward` (one SNR per lane), the bits are drawn on the device, the error
counts are summed there in int64, and one copy brings the per-point sums
to the host. There is no mesh and no frame chunking here; the N-process
form is a separate piece of work. The "beamforming" pipeline is the
frequency-domain TM6 link, which makes no time signal: its PAPR is
reported as 0, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import LTEConfig
from ..device import resolve_device
from ..sim import beamforming, diversity, siso, spatial
from ..sim.links import cached_link

PIPELINES = ("siso", "simo", "sfbc", "spatial", "beamforming")
_NOT_PORTED = {"coded": "A17-A18"}


class SweepResult(NamedTuple):
    snr_db: np.ndarray        # (S,)
    ber: np.ndarray           # (S,)
    bit_errors: np.ndarray    # (S,) int64, summed over the frames
    total_bits: np.ndarray    # (S,) int64
    papr_db: np.ndarray       # (S,) mean over the frames
    frames: int


def _check_pipeline(pipeline: str) -> None:
    if pipeline in _NOT_PORTED:
        raise NotImplementedError(f"ber_sweep pipeline {pipeline!r}: ROADMAP items "
                                  f"{_NOT_PORTED[pipeline]}")
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; pick from {PIPELINES}")


def _bits_per_frame(config: LTEConfig, num_ofdm_symbols: int, mode: str, pipeline: str) -> int:
    _check_pipeline(pipeline)
    if pipeline in ("siso", "simo"):
        return siso.bits_per_frame(config, num_ofdm_symbols, mode)
    if pipeline == "sfbc":
        return diversity.sfbc_bits_per_frame(config, num_ofdm_symbols)
    if pipeline == "beamforming":
        return beamforming.bits_per_frame(config, num_ofdm_symbols)
    return spatial.bits_per_frame(config, num_ofdm_symbols)


def sweep_link(config: LTEConfig, pipeline: str, device, mode: str = "lte",
               channel_type: str = "awgn", itu_profile: str = "Pedestrian_A",
               velocity_kmh: Optional[float] = None, num_tx: int = 2, num_rx: int = 2,
               detector_type: str = "MMSE", rank: Optional[int] = None):
    """The link object that a sweep of these arguments drives, built once and
    kept (sim.links)."""
    _check_pipeline(pipeline)
    if pipeline == "siso":
        return cached_link(siso.SisoLink, config, device, 0, mode, channel_type, True,
                           itu_profile, velocity_kmh, 2.0)
    if pipeline == "simo":
        return cached_link(diversity.SimoLink, config, num_rx, device, channel_type,
                           itu_profile, velocity_kmh, 2.0)
    if pipeline == "sfbc":
        return cached_link(diversity.SfbcLink, config, num_rx, device, channel_type,
                           itu_profile, velocity_kmh, 2.0)
    if pipeline == "beamforming":
        # TM6 rank 1 over the static flat channel, W by MRT: the JAX sweep's
        # call of simulate_beamforming with its defaults
        return beamforming.link_for(config, num_tx, num_rx, device=device)
    rank_used = min(num_tx, num_rx) if rank is None else int(rank)
    return cached_link(spatial.SpatialLink, config, num_tx, num_rx, rank_used, detector_type,
                       device, channel_type, "reference", spatial._channel_impl(channel_type),
                       itu_profile, velocity_kmh or 3.0, 2.0)


def ber_sweep(config: LTEConfig, snr_points, frames: int = 8, num_ofdm_symbols: int = 28,
              mode: str = "lte", channel_type: str = "awgn",
              itu_profile: str = "Pedestrian_A", velocity_kmh: Optional[float] = None,
              pipeline: str = "siso", num_tx: int = 2, num_rx: int = 2,
              detector_type: str = "MMSE", rank: Optional[int] = None,
              generator: Optional[torch.Generator] = None, device=None,
              bits: Optional[torch.Tensor] = None, seams: Optional[dict] = None) -> SweepResult:
    """A BER sweep: `frames` frames of `num_ofdm_symbols` symbols at each SNR
    point, all S·frames lanes in one step of the pipeline's link.

    pipeline: "siso" (`mode` applies), "simo", "sfbc", "spatial" or
    "beamforming" (num_tx and num_rx apply; PAPR 0); detector_type and rank
    apply to "spatial" alone (rank=None means
    min(num_tx, num_rx); a fixed rank, PMI 0). Runs on `device`: the CUDA
    card when none is given. `generator` (on that device) draws the bits and
    the channel. Two seams for tests: `bits` (S, frames, n_bits) replaces the
    drawn bits, and `seams` is passed to the link's forward as keyword
    arguments (`noise=` or `draws=`, with S·frames lanes, point-major).
    """
    device = resolve_device(device)
    n_bits = _bits_per_frame(config, num_ofdm_symbols, mode, pipeline)
    link = sweep_link(config, pipeline, device, mode, channel_type, itu_profile, velocity_kmh,
                      num_tx, num_rx, detector_type, rank)
    snr = torch.as_tensor(np.asarray(snr_points, np.float32), device=device).reshape(-1)
    S, F = snr.shape[0], int(frames)
    if bits is None:
        bits = torch.randint(0, 2, (S * F, n_bits), generator=generator, device=device,
                             dtype=torch.int8)
    else:
        if tuple(bits.shape) != (S, F, n_bits):
            raise ValueError(f"bits {tuple(bits.shape)}, expected {(S, F, n_bits)}")
        bits = bits.to(device).reshape(S * F, n_bits)
    r = link(bits, snr.repeat_interleave(F), generator=generator, **(seams or {}))
    errors = r.bit_errors.reshape(S, F).sum(dim=1, dtype=torch.int64).cpu().numpy()
    papr = (np.zeros(S, np.float32) if pipeline == "beamforming"
            else r.papr_db.reshape(S, F).mean(dim=1).cpu().numpy())
    total = np.full((S,), np.int64(n_bits) * F, np.int64)
    return SweepResult(snr.cpu().numpy(), errors / total, errors, total, papr, F)
