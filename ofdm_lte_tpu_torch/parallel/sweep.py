"""Monte-Carlo BER/PAPR sweeps on one device or over N processes.

Port of ofdm_lte_tpu/parallel/sweep.py's `ber_sweep` and `harq_sweep`. On
one device the SNR points and the Monte-Carlo frames are the lanes of ONE
call of a link's `forward` (one SNR per lane), the bits are drawn on the
device, the counts are summed there in int64, and one copy brings the
per-point sums to the host. There is no frame chunking. The "beamforming"
pipeline is the frequency-domain TM6 link, which makes no time signal: its
PAPR is reported as 0, as in the JAX package. The "coded" pipeline runs one
`coded_tb_bits` transport block a frame through the TS 36.212 chain
(sim.coded.CodedLink); `harq_sweep` runs its HARQ schedule.

Over N processes (`layout=`, a parallel.distributed.Layout of the default
torch.distributed group) each rank runs its block of SNR points, padded to
a multiple of the shards with the last point, with `frames` frames a point
of its own (the JAX package's frames_per_device), as one call of the link;
every rank writes its block's counts into a zero (points, ...) tensor and
one all_reduce sums them over the world, on the card under NCCL and on the
host under gloo. The result is the JAX sweep's: counts over every process,
`frames` times the processes of an SNR shard a point, padding trimmed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import LTEConfig
from ..device import resolve_device
from ..sim import beamforming, coded, diversity, siso, spatial
from ..sim.links import cached_link
from .distributed import Layout, rank_generator

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
              seams: Optional[dict] = None, layout: Optional[Layout] = None) -> SweepResult:
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

    `layout` (parallel.distributed.layout) runs the sweep over the default
    process group on the layout's device: `frames` frames a point on each
    rank, `frames` × mc_size in the result; the caller's generator, seeded
    alike on every rank, seeds each rank's own (distributed.rank_generator);
    `bits` (S, frames·mc_size, n_bits) and `seams` (S·frames·mc_size lanes)
    are the global ones, of which each rank takes its lanes (rank_seams). A
    world of one is the one-device call, bit for bit.
    """
    part = _Part(snr_points, frames, layout, device, generator)
    n_bits = _bits_per_frame(config, num_ofdm_symbols, mode, pipeline, coded_tb_bits)
    link = sweep_link(config, pipeline, part.device, mode, channel_type, itu_profile,
                      velocity_kmh, num_tx, num_rx, detector_type, rank, coded_tb_bits)
    snr, bits = _lanes(part.snr, frames, n_bits, part.generator, part.device, part.bits(bits))
    S, F = snr.shape[0], int(frames)
    r = link(bits, snr.repeat_interleave(F), generator=part.generator,
             **part.seams(seams, pipeline, num_tx, num_rx))
    errors = part.reduce(r.bit_errors.reshape(S, F).sum(dim=1, dtype=torch.int64)).cpu().numpy()
    if pipeline == "beamforming":
        papr = np.zeros(part.S, np.float32)
    else:
        # the JAX sweep's pmean: each rank's mean, summed and over mc_size
        # (the mean itself where there is no layout)
        papr = (part.reduce(r.papr_db.reshape(S, F).mean(dim=1).double()) / part.mc) \
            .float().cpu().numpy()
    F_all = F * part.mc
    total = np.full((part.S,), np.int64(n_bits) * F_all, np.int64)
    return SweepResult(part.snr_all, errors / total, errors, total, papr, F_all)


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


def take_lanes(x, axis: int, lanes: int, idx, before: int = 1):
    """Lanes `idx` of an array whose axis `axis` holds before·lanes·after
    entries in (before, lane, after) order: the axis unfolded, the lanes
    taken, folded back. A NumPy array gives a NumPy array, a tensor a
    tensor."""
    shape = tuple(x.shape)
    if shape[axis] % (before * lanes):
        raise ValueError(f"a seam of shape {shape} holds no {before}·{lanes}·n entries "
                         f"on axis {axis}")
    unfolded = shape[:axis] + (before, lanes, shape[axis] // (before * lanes)) + shape[axis + 1:]
    if isinstance(x, torch.Tensor):
        y = x.reshape(unfolded).index_select(
            axis + 1, torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=x.device))
    else:
        y = np.take(np.asarray(x).reshape(unfolded), np.asarray(idx), axis=axis + 1)
    return y.reshape(shape[:axis] + (-1,) + shape[axis + 1:])


def _lane_axis(pipeline: str, key: str, num_tx: int, num_rx: int) -> tuple:
    """(axis, links before the lanes on it) of the arrays of a seam named
    `key`: the links' own docstrings give the shapes. The Jakes phases fold
    the links, lanes and taps into one axis, (links·lanes·taps, 16); the
    SIMO, SFBC and spatial noise leads with the RX axis; everything else
    leads with the lanes."""
    if pipeline in ("simo", "sfbc", "spatial"):
        if key == "phases":
            return 0, {"simo": num_rx, "sfbc": 2 * num_rx, "spatial": num_rx * num_tx}[pipeline]
        if key != "fading":
            return 1, 1
    return 0, 1


def rank_seams(seams: Optional[dict], pipeline: str, lanes: int, idx, num_tx: int = 2,
               num_rx: int = 2, lead: int = 0) -> dict:
    """The seams of lanes `idx` out of `lanes`, every array cut along its
    lane axis (_lane_axis), after `lead` leading axes (1 for the HARQ
    draws, whose first axis is the transmission)."""
    def cut(x, key):
        if isinstance(x, dict):
            return {k: cut(v, k) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(cut(v, key) for v in x)
        axis, before = _lane_axis(pipeline, key, num_tx, num_rx)
        return take_lanes(x, axis + lead, lanes, idx, before)
    return cut(seams or {}, None)


class _Part:
    """This process's part of a sweep: every point and frame on one device,
    or, under a layout, the rank's block of points (padded with the last
    point), its share of their frames, its generator and the reduction of
    its counts over the world."""

    def __init__(self, snr_points, frames: int, layout: Optional[Layout], device, generator):
        self.snr_all = np.asarray(snr_points, np.float32).reshape(-1)
        self.S = S = self.snr_all.shape[0]
        self.frames, self.layout = int(frames), layout
        if layout is None:
            self.device, self.generator, self.mc = resolve_device(device), generator, 1
            self.snr = self.snr_all
            return
        if device is not None and torch.device(device) != layout.device:
            raise ValueError(f"device {device} is not the layout's {layout.device}")
        if layout.world_size > 1 and not dist.is_initialized():
            raise RuntimeError(f"a layout of {layout.world_size} processes needs the "
                               f"default process group (distributed.initialize)")
        self.device, self.mc = layout.device, layout.mc_size
        S_local = -(-S // layout.num_snr_shards)
        start = layout.snr_block * S_local
        self.rows, self.S_pad = slice(start, start + S_local), S_local * layout.num_snr_shards
        self.points = np.minimum(np.arange(start, start + S_local), S - 1)
        self.snr = self.snr_all[self.points]
        self.generator = (generator if layout.world_size == 1
                          else rank_generator(generator, layout.rank, self.device))

    def bits(self, bits):
        """The rank's (S_local, frames, n_bits) of the global bits."""
        if bits is None or self.layout is None:
            return bits
        F, n = self.frames, bits.shape[-1]
        if tuple(bits.shape) != (self.S, F * self.mc, n):
            raise ValueError(f"bits {tuple(bits.shape)}, expected {(self.S, F * self.mc, n)}")
        j = self.layout.frame_index
        return bits[torch.as_tensor(self.points)][:, j * F:(j + 1) * F]

    def seams(self, seams, pipeline: str, num_tx: int, num_rx: int, lead: int = 0) -> dict:
        """The rank's lanes of the global seams."""
        if not seams or self.layout is None:
            return seams or {}
        F, F_all = self.frames, self.frames * self.mc
        idx = (self.points[:, None] * F_all + self.layout.frame_index * F
               + np.arange(F)[None, :]).reshape(-1)
        return rank_seams(seams, pipeline, self.S * F_all, idx, num_tx, num_rx, lead)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x (points of the rank, ...) -> (S, ...), the sums over the world
        of every rank's rows: a zero (S_pad, ...) tensor a rank, its block
        written in, one all_reduce (on the device under NCCL, on the host
        under gloo), the padding trimmed. Counts are int64, so unlike the
        JAX sweep's int32 psum they need no split into 16-bit halves."""
        if self.layout is None or not dist.is_initialized():
            return x
        dev = x.device if dist.get_backend() == "nccl" else torch.device("cpu")
        full = torch.zeros((self.S_pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
        full[self.rows] = x.to(dev)
        dist.all_reduce(full)
        return full[:self.S]


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
               seams: Optional[dict] = None, layout: Optional[Layout] = None) -> HarqSweepResult:
    """A HARQ sweep on one device: `frames` transport blocks of `tb_bits` at
    each SNR point, every (point, frame) a lane of one batched HARQ call
    (sim.coded.CodedLink.harq), with the exact integer counters summed on
    the device. Seams as in ber_sweep: `bits` (S, frames, tb_bits), and
    `seams` passed to the HARQ call (`draws=` with a leading axis of
    len(rv_sequence) transmissions, then S·frames lanes, point-major).
    `layout` as in ber_sweep: the counters are summed over the world."""
    part = _Part(snr_points, frames, layout, device, generator)
    link = coded.link_for(config, tb_bits, part.device, channel_type, itu_profile, velocity_kmh)
    snr, bits = _lanes(part.snr, frames, tb_bits, part.generator, part.device, part.bits(bits))
    S, F, T = snr.shape[0], int(frames), len(rv_sequence)
    r = link.harq(bits, snr.repeat_interleave(F), tuple(int(v) for v in rv_sequence),
                  num_iterations, generator=part.generator,
                  **part.seams(seams, "coded", 2, 2, lead=1))
    counts = part.reduce(torch.cat([
        (~r.crc_pass_stage).reshape(S, F, T).sum(dim=1, dtype=torch.int64),
        (~r.crc_pass).reshape(S, F, 1).sum(dim=1, dtype=torch.int64),
        r.num_transmissions.reshape(S, F, 1).sum(dim=1, dtype=torch.int64),
        r.bit_errors.reshape(S, F, 1).sum(dim=1, dtype=torch.int64)], dim=1)).cpu().numpy()
    fails_stage, fails, ntx, errs = counts[:, :T], counts[:, T], counts[:, T + 1], counts[:, T + 2]
    F_all = F * part.mc
    return HarqSweepResult(part.snr_all, fails / F_all, ntx / F_all, fails_stage / F_all,
                           errs / (np.int64(tb_bits) * F_all), fails, F_all, fails_stage, ntx,
                           errs)
