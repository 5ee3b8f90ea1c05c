"""N-process bring-up, the SNR × frames layout, the scaling measurement and
the dry run, over torch.distributed.

Port of ofdm_lte_tpu/parallel/distributed.py and of
__graft_entry__.dryrun_multichip. The JAX package spans every device of
every host with one mesh and one shard_map program; here one process drives
one device, and the processes form one torch.distributed group:

- `initialize(...)`: `init_process_group` with retry, a no-op for one
  process; with no arguments it reads the environment `torchrun` sets;
- `layout(num_snr_shards)`: this rank's place in the (SNR shard, frame
  share) grid, the counterpart of `global_mesh` and `sweep.make_mesh_2d`,
  which `parallel.sweep.ber_sweep(layout=)` and `harq_sweep(layout=)` run on;
- `scaling_efficiency(...)`: frames/s at several process counts, through
  parallel.mp_bench (one process drives one device, so the process is the
  unit here);
- `dryrun(n)`: the JAX package's multi-chip dry run over n spawned
  processes, with its configuration and thresholds.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def seed_of(*parts: int) -> int:
    """A 63-bit generator seed for a tuple of integers (the port's
    counterpart of folding them into a JAX key): equal tuples give equal
    seeds, different ones independent streams."""
    words = [int(p) % 2 ** 32 for p in parts]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None, retries: int = 3,
               retry_delay_s: float = 5.0, timeout_s: float = 600.0) -> bool:
    """Bring up the default process group, retrying `retries` times.

    With no arguments it reads what `torchrun` sets (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR/MASTER_PORT, through `env://`). One process and
    no `init_method` is a no-op (returns False), as is a group that is up
    already; an explicit `init_method` brings up even a world of one.
    `backend=None` takes NCCL when every local rank has a card of its own,
    else gloo (CPU ranks, or ranks sharing a card). Raises RuntimeError
    after the last failed attempt: it never carries on as one process."""
    if dist.is_initialized():
        return False
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else int(world_size)
    if init_method is None and world_size == 1:
        return False
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    if backend is None:
        backend = backend_for("cuda" if torch.cuda.is_available() else "cpu",
                              _env_int("LOCAL_WORLD_SIZE", world_size))
    if backend == "nccl":
        # NCCL works on the current card: this rank's own
        torch.cuda.set_device(_env_int("LOCAL_RANK", 0) % torch.cuda.device_count())
    last = None
    for attempt in range(max(1, retries)):
        try:
            dist.init_process_group(backend, init_method=init_method or "env://",
                                    world_size=world_size, rank=rank,
                                    timeout=datetime.timedelta(seconds=timeout_s))
            return True
        except (RuntimeError, ValueError, OSError) as e:
            last = e
            if attempt + 1 < retries:
                time.sleep(retry_delay_s)
    raise RuntimeError(f"torch.distributed bring-up failed after {retries} attempts "
                       f"(backend {backend}, world {world_size}, rank {rank}): {last}")


def backend_for(device, local_world_size: int) -> str:
    """The backend of `local_world_size` ranks of this host on `device`:
    NCCL when each has a card of its own (a CUDA device named without an
    index, no more ranks than cards), else gloo (CPU ranks, or ranks that
    share a card, which NCCL refuses)."""
    device = torch.device(device)
    own_cards = (device.type == "cuda" and device.index is None and torch.cuda.is_available()
                 and local_world_size <= torch.cuda.device_count())
    return "nccl" if own_cards and dist.is_nccl_available() else "gloo"


def shutdown() -> None:
    """Tear the default process group down, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` as given, a CUDA device without an
    index (and None, which means the card) as `cuda:{LOCAL_RANK % cards}`."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())
    return device


class Layout(NamedTuple):
    """One rank's place in the (SNR shard, frame share) grid: the world's
    ranks in `num_snr_shards` rows of `mc_size`, rank r in row
    r // mc_size (its block of SNR points) and column r % mc_size (its share
    of each point's frames), as the JAX package's 2-D ('snr', 'mc') mesh
    lays out its devices."""
    world_size: int
    rank: int
    num_snr_shards: int
    mc_size: int
    snr_block: int
    frame_index: int
    device: torch.device


def layout(num_snr_shards: int = 1, device=None) -> Layout:
    """This process's Layout over the default group (a world of one
    without it). Raises ValueError, as `sweep.make_mesh_2d` does, when the
    world does not divide into the shards."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    k = int(num_snr_shards)
    if k < 1 or world % k:
        raise ValueError(f"{world} devices not divisible into {k} SNR shards")
    mc = world // k
    return Layout(world, rank, k, mc, rank // mc, rank % mc, rank_device(device))


def rank_generator(generator: Optional[torch.Generator], rank: int,
                   device) -> torch.Generator:
    """A generator of this rank's own on `device`: one 63-bit word drawn
    from the caller's generator (seeded alike on every rank), mixed with
    the global rank, as the JAX sweep folds the device index into a
    replicated key."""
    word = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                             device=generator.device if generator is not None else "cpu"))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(word, word >> 32, rank))
    return gen


def scaling_efficiency(config, process_counts: Sequence[int], frames_per_device: int = 8,
                       num_ofdm_symbols: int = 14, snr_db: float = 10.0, n_steps: int = 3,
                       device=None) -> Dict:
    """Frames/s of the SISO sweep at each process count (parallel.mp_bench:
    fresh interpreters, one process a device), with `frames_per_device`
    frames a process: {n: {"frames_per_s", "per_device", "efficiency"}},
    per-device rates normalized to the first count."""
    from . import mp_bench
    link = {"bandwidth": config.bandwidth, "modulation": config.modulation,
            "cp_type": config.cp_type, "pipeline": "siso", "symbols": num_ofdm_symbols,
            "snr": snr_db}
    r = mp_bench.measure(process_counts, frames_per_device, n_steps, 1, device, link)
    return {n: {"frames_per_s": v["total"], "per_device": v["per_process"],
                "efficiency": v["efficiency"]} for n, v in r.items()}


# the dry run's checks, in the JAX package's order: (name, pipeline, SNR
# points, seed, arguments, check of the BER (or BLER) per point)
DRYRUN_CASES = (
    ("siso", "siso", [6.0, 60.0], 0, {}, lambda b: b[1] == 0.0),
    ("spatial2x2", "spatial", [40.0], 1, {"num_tx": 2, "num_rx": 2}, lambda b: b[0] < 0.1),
    ("snr_x_mc", "siso", [6.0, 60.0], 2, {}, lambda b: b[1] == 0.0),
    ("sfbc2x1", "sfbc", [40.0], 3, {"num_rx": 1}, lambda b: b[0] < 0.05),
    ("simo1x4", "simo", [40.0], 6, {"num_rx": 4}, lambda b: b[0] < 0.05),
    ("coded", "coded", [20.0], 4, {"coded_tb_bits": 104}, lambda b: b[0] == 0.0),
    ("beamforming4x2", "beamforming", [30.0], 7, {"num_tx": 4, "num_rx": 2},
     lambda b: b[0] < 0.05),
)


def dryrun_checks(device) -> Dict:
    """The dry run on this process's group: each check of DRYRUN_CASES, one
    frame a process at 1.25 MHz QPSK (the 2-D layout of 2 SNR shards when
    the world is even), and the HARQ sweep (104 bits, rv (0, 1), 2
    iterations): BLER 0 and 1.0 transmissions at 20 dB. Returns the
    reduced BERs by name; raises AssertionError on a failed check."""
    from ..config import LTEConfig
    from .sweep import ber_sweep, harq_sweep
    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    world = dist.get_world_size() if dist.is_initialized() else 1
    out = {}
    for name, pipeline, snrs, seed, kw, check in DRYRUN_CASES:
        if name == "snr_x_mc" and world % 2:
            continue
        lay = layout(2 if name == "snr_x_mc" else 1, device)
        gen = torch.Generator(device=lay.device)
        gen.manual_seed(seed)
        r = ber_sweep(cfg, snrs, frames=1, num_ofdm_symbols=14, pipeline=pipeline,
                      generator=gen, layout=lay, **kw)
        ber = [float(b) for b in r.ber]
        if len(ber) != len(snrs) or not check(ber):
            raise AssertionError(f"dry run {name} on {world} processes: BER {ber}")
        out[name] = ber
    lay = layout(1, device)
    gen = torch.Generator(device=lay.device)
    gen.manual_seed(5)
    h = harq_sweep(cfg, [20.0], frames=1, tb_bits=104, rv_sequence=(0, 1), num_iterations=2,
                   generator=gen, layout=lay)
    if h.bler.tolist() != [0.0] or float(h.avg_transmissions[0]) != 1.0:
        raise AssertionError(f"dry run harq on {world} processes: BLER {h.bler}, "
                             f"transmissions {h.avg_transmissions}")
    out["harq_bler"] = h.bler.tolist()
    return out


def dryrun(n_processes: int, device=None, timeout_s: float = 600.0) -> Dict:
    """The JAX package's multi-chip dry run (siso, spatial 2×2, the 2-D
    layout, SFBC 2×1, SIMO 1×4, coded, beamforming 4×2, HARQ) over
    n_processes fresh interpreters in one gloo group, each on `device`
    (the card by default; the ranks share it). Every rank must pass and
    report the same reduced BERs; returns rank 0's."""
    from . import mp_bench
    results = mp_bench.spawn(n_processes, [{"job": "dryrun"}], device, timeout_s)
    first = results[0][0]
    for rank, res in enumerate(results):
        if res[0] != first:
            raise AssertionError(f"dry run: rank {rank} reduced {res[0]}, rank 0 {first}")
    return first
