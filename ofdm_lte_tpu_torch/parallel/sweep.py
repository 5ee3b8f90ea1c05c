"""Monte-Carlo BER/PAPR sweeps on one device.

Port of ofdm_lte_tpu/parallel/sweep.py's `ber_sweep` and `harq_sweep` for
one GPU: the SNR points and the Monte-Carlo frames are the lanes of ONE call
of a link's `forward` (one SNR per lane), the bits are drawn on the device,
the counts are summed there in int64, and one copy brings the per-point
sums to the host. There is no mesh and no frame chunking here; the
N-process form is a separate piece of work. The "beamforming" pipeline is
the frequency-domain TM6 link, which makes no time signal: its PAPR is
reported as 0, as in the JAX package. The "coded" pipeline runs one
`coded_tb_bits` transport block a frame through the TS 36.212 chain
(sim.coded.CodedLink); `harq_sweep` runs its HARQ schedule.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import LTEConfig
from ..device import resolve_device
from ..sim import beamforming, coded, diversity, siso, spatial
from ..sim.links import cached_link

PIPELINES = ("siso", "simo", "sfbc", "spatial", "beamforming", "coded")


class SweepResult(NamedTuple):
    snr_db: np.ndarray        # (S,)
    ber: np.ndarray           # (S,)
    bit_errors: np.ndarray    # (S,) int64, summed over the frames
    total_bits: np.ndarray    # (S,) int64
    papr_db: np.ndarray       # (S,) mean over the frames
    frames: int


def _check_pipeline(pipeline: str) -> None:
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; pick from {PIPELINES}")


def _bits_per_frame(config: LTEConfig, num_ofdm_symbols: int, mode: str, pipeline: str,
                    coded_tb_bits: int = 6000) -> int:
    _check_pipeline(pipeline)
    if pipeline == "coded":
        return coded_tb_bits        # one transport block a frame
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
               detector_type: str = "MMSE", rank: Optional[int] = None,
               coded_tb_bits: int = 6000):
    """The link object that a sweep of these arguments drives, built once and
    kept (sim.links)."""
    _check_pipeline(pipeline)
    if pipeline == "coded":
        return coded.link_for(config, coded_tb_bits, device, channel_type, itu_profile,
                              velocity_kmh)
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
              coded_tb_bits: int = 6000, generator: Optional[torch.Generator] = None,
              device=None, bits: Optional[torch.Tensor] = None,
              seams: Optional[dict] = None) -> SweepResult:
    """A BER sweep: `frames` frames of `num_ofdm_symbols` symbols at each SNR
    point, all S·frames lanes in one step of the pipeline's link.

    pipeline: "siso" (`mode` applies), "simo", "sfbc", "spatial",
    "beamforming" (num_tx and num_rx apply; PAPR 0) or "coded" (one
    `coded_tb_bits` transport block a frame, 8 max-log iterations);
    detector_type and rank apply to "spatial" alone (rank=None means
    min(num_tx, num_rx); a fixed rank, PMI 0). Runs on `device`: the CUDA
    card when none is given. `generator` (on that device) draws the bits and
    the channel. Two seams for tests: `bits` (S, frames, n_bits) replaces the
    drawn bits, and `seams` is passed to the link's forward as keyword
    arguments (`noise=` or `draws=`, with S·frames lanes, point-major).
    """
    device = resolve_device(device)
    n_bits = _bits_per_frame(config, num_ofdm_symbols, mode, pipeline, coded_tb_bits)
    link = sweep_link(config, pipeline, device, mode, channel_type, itu_profile, velocity_kmh,
                      num_tx, num_rx, detector_type, rank, coded_tb_bits)
    snr, bits = _lanes(snr_points, frames, n_bits, generator, device, bits)
    S, F = snr.shape[0], int(frames)
    r = link(bits, snr.repeat_interleave(F), generator=generator, **(seams or {}))
    errors = r.bit_errors.reshape(S, F).sum(dim=1, dtype=torch.int64).cpu().numpy()
    papr = (np.zeros(S, np.float32) if pipeline == "beamforming"
            else r.papr_db.reshape(S, F).mean(dim=1).cpu().numpy())
    total = np.full((S,), np.int64(n_bits) * F, np.int64)
    return SweepResult(snr.cpu().numpy(), errors / total, errors, total, papr, F)


def _lanes(snr_points, frames: int, n_bits: int, generator, device, bits):
    """The SNR points on the device and the bits of their S·frames lanes,
    point-major: drawn, or the caller's (S, frames, n_bits)."""
    snr = torch.as_tensor(np.asarray(snr_points, np.float32), device=device).reshape(-1)
    S, F = snr.shape[0], int(frames)
    if bits is None:
        return snr, torch.randint(0, 2, (S * F, n_bits), generator=generator, device=device,
                                  dtype=torch.int8)
    if tuple(bits.shape) != (S, F, n_bits):
        raise ValueError(f"bits {tuple(bits.shape)}, expected {(S, F, n_bits)}")
    return snr, bits.to(device).reshape(S * F, n_bits)


class HarqSweepResult(NamedTuple):
    snr_db: np.ndarray              # (S,)
    bler: np.ndarray                # (S,) CRC-fail share after the whole rv schedule
    avg_transmissions: np.ndarray   # (S,) mean transmissions a transport block
    bler_per_stage: np.ndarray      # (S, T) BLER after each combined decode
    ber: np.ndarray                 # (S,) residual information-bit error rate
    tb_failures: np.ndarray         # (S,) int64
    frames: int                     # transport blocks a point
    # the exact integer counters, of which the ratios above are views
    stage_failures: np.ndarray      # (S, T) int64, blocks failing at every stage <= t
    tx_sum: np.ndarray              # (S,) int64, transmissions
    bit_errors: np.ndarray          # (S,) int64, residual information-bit errors


def harq_sweep(config: LTEConfig, snr_points, frames: int = 4, tb_bits: int = 6000,
               rv_sequence=(0, 1, 2, 3), channel_type: str = "awgn",
               itu_profile: str = "Pedestrian_A", velocity_kmh: Optional[float] = None,
               num_iterations: int = 8, generator: Optional[torch.Generator] = None,
               device=None, bits: Optional[torch.Tensor] = None,
               seams: Optional[dict] = None) -> HarqSweepResult:
    """A HARQ sweep on one device: `frames` transport blocks of `tb_bits` at
    each SNR point, every (point, frame) a lane of one batched HARQ call
    (sim.coded.CodedLink.harq), with the exact integer counters summed on
    the device. Seams as in ber_sweep: `bits` (S, frames, tb_bits), and
    `seams` passed to the HARQ call (`draws=` with a leading axis of
    len(rv_sequence) transmissions, then S·frames lanes, point-major)."""
    device = resolve_device(device)
    link = coded.link_for(config, tb_bits, device, channel_type, itu_profile, velocity_kmh)
    snr, bits = _lanes(snr_points, frames, tb_bits, generator, device, bits)
    S, F, T = snr.shape[0], int(frames), len(rv_sequence)
    r = link.harq(bits, snr.repeat_interleave(F), tuple(int(v) for v in rv_sequence),
                  num_iterations, generator=generator, **(seams or {}))
    counts = torch.cat([
        (~r.crc_pass_stage).reshape(S, F, T).sum(dim=1, dtype=torch.int64),
        (~r.crc_pass).reshape(S, F, 1).sum(dim=1, dtype=torch.int64),
        r.num_transmissions.reshape(S, F, 1).sum(dim=1, dtype=torch.int64),
        r.bit_errors.reshape(S, F, 1).sum(dim=1, dtype=torch.int64)], dim=1).cpu().numpy()
    fails_stage, fails, ntx, errs = counts[:, :T], counts[:, T], counts[:, T + 1], counts[:, T + 2]
    return HarqSweepResult(snr.cpu().numpy(), fails / F, ntx / F, fails_stage / F,
                           errs / (np.int64(tb_bits) * F), fails, F, fails_stage, ntx, errs)
