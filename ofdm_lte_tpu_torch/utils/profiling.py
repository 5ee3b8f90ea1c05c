"""Profiling and the roofline cost model of one NVIDIA H100.

Port of ofdm_lte_tpu/utils/profiling.py:

- `trace(path)`: torch.profiler over the CPU and the card, a Chrome trace;
- `span(name)`: the program's layer spans, `<layer>.<stage>`, recorded on
  the profiler's clock while one records, and free when none does;
- analytic FLOP/byte models of every stage of the SISO, TM4 spatial
  (bins and time), SIMO and SFBC steps, with the JAX package's counts stage
  by stage, and of the turbo decoder's BCJR pass; roofline reports of a
  measured step against the card's units.

Every stage is charged at max(operations / its unit's rate, bytes / HBM
rate). The units are the card's:

- "tc_highest", "tc_high", "tc_default": a complex GEMM through the
  tensor-core kernels at each precision (ops/cmatmul.py), in the 8·m·k·n
  convention: `highest` three TF32 products per fp32 product, so a third
  of the TF32 rate; `high` one TF32 product, the TF32 rate; `default` one
  bf16 product, the bf16 rate. The operands are fp32 in device memory at
  every precision, and a GEMM is charged their bytes read once and C's
  written once, whatever the precision (the `default` kernels' bf16 copies
  of A and B are their own traffic, not the product's least);
- "fp32": the CUDA cores (elementwise passes, the RNG, demapping, the BCJR
  pass);
- "hbm": device memory.

Two tables of rates. DATASHEET: NVIDIA's for the H100 SXM at 700 W (TF32
tensor cores 495 TFLOP/s, bf16 989 TFLOP/s dense, fp32 67 TFLOP/s, HBM
3.35 TB/s); chip_smoke.py's bounds read these. CEILINGS: the best the card
was seen to reach, on an NVIDIA H100 80GB HBM3 at 700.00 W: `mma.sync`
TF32 324–328 TFLOP/s and `mma.sync` m16n8k16 bf16 645.4 TFLOP/s (the
probes of a tuning tool since removed: `git show
b2cc899:ofdm_lte_tpu_torch/tools/tune_cmatmul_tc.py`), HBM 3.0488 TB/s read
and written by one 2 GiB device-to-device copy (the highest of chip_smoke.py
phase 8's readings, 3.0273–3.0488); fp32 is not measured and stays the
data sheet's. A fraction against CEILINGS is the primary one; against
DATASHEET a lower bound of it.

Nothing is hoisted: the port's timed steps change the bits and the seed
every step, so every stage is paid every step and `hoisted_stages` is
empty (the JAX package's loop-invariant accounting describes XLA hoisting
a fixed codeword out of its step loop).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import torch

from .._build import BUILD_DIR
from ..config import LTEConfig
from ..grid import grid_for

DATASHEET = {"tf32": 495e12, "bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12}
# the best seen on an NVIDIA H100 80GB HBM3 at 700.00 W: tf32 and bf16 by the
# mma.sync probes of `git show b2cc899:ofdm_lte_tpu_torch/tools/tune_cmatmul_tc.py`,
# hbm by chip_smoke.py phase 8 (a 2 GiB copy_, read and write counted: the
# highest reading); fp32 not measured
CEILINGS = {"tf32": 328e12, "bf16": 645.4e12, "fp32": 67e12, "hbm": 3.0488e12}
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# a complex GEMM's unit at each precision
GEMM_UNITS = {"highest": "tc_highest", "high": "tc_high", "default": "tc_default"}
UNITS = (*GEMM_UNITS.values(), "fp32")

# what a BCJR pass must move and do a step a code block: 3 LLRs in (in the
# extrinsic mode the third is the other decoder's extrinsic, gathered through
# the QPP table that every block shares), 1 out (16 B); 4 branch metrics (3
# ops each), α and β (16 adds and 8 ⊕ each), APP (32 adds, 2 × 7 ⊕ and a
# subtraction), and in the extrinsic mode two more subtractions. The
# kernel's scratch, 8 floats of α or β written and read (64 B), is this
# design's own cost, reported beside it.
BCJR_BYTES_PER_STEP = 16
BCJR_SCRATCH_BYTES_PER_STEP = 64
BCJR_OPS_PER_STEP = {"app": 4 * 3 + 2 * (16 + 8) + 32 + 14 + 1,
                     "extrinsic": 4 * 3 + 2 * (16 + 8) + 32 + 14 + 3}


def unit_rate(unit: str, peaks: Dict[str, float] = CEILINGS) -> float:
    """Operations a second of a unit under a table of peaks."""
    if unit == "tc_highest":
        return peaks["tf32"] / 3.0
    if unit == "tc_high":
        return peaks["tf32"]
    if unit == "tc_default":
        return peaks["bf16"]
    if unit == "fp32":
        return peaks["fp32"]
    raise ValueError(f"unknown unit {unit!r}; the card's are {UNITS}")


def _gemm_unit(precision: str) -> str:
    if precision not in GEMM_UNITS:
        raise ValueError(f"precision {precision!r}; pick from {list(GEMM_UNITS)}")
    return GEMM_UNITS[precision]


@dataclass
class KernelCost:
    name: str
    flops: float
    bytes: float
    unit: str = "fp32"

    def roofline_time_s(self, peaks: Dict[str, float] = CEILINGS) -> float:
        return max(self.flops / unit_rate(self.unit, peaks), self.bytes / peaks["hbm"])


def _total_roofline_s(costs: Dict[str, KernelCost], peaks: Dict[str, float] = CEILINGS) -> float:
    return sum(c.roofline_time_s(peaks) for c in costs.values())


def _fraction_fields(costs: Dict[str, KernelCost], measured_step_s: float,
                     dispatch_floor_s: float = 0.0) -> Dict:
    """Roofline fields of a cost dict against a measured step: the least time
    of the whole step at the ceilings (or the host's dispatch floor, where
    that is larger: the card computes while the host enqueues, so a step
    takes no less than either), over the measured time; the same against
    the data sheet, which is no larger."""
    floor_eff = min(dispatch_floor_s, measured_step_s)
    t_ceil = max(floor_eff, _total_roofline_s(costs, CEILINGS))
    t_ds = max(floor_eff, _total_roofline_s(costs, DATASHEET))
    return {
        "roofline_s": t_ceil,
        "roofline_fraction": t_ceil / measured_step_s if measured_step_s else 0.0,
        "roofline_fraction_datasheet_peaks": t_ds / measured_step_s if measured_step_s else 0.0,
        "hoisted_stages": [],
    }


_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


# the layers whose stages `span` marks as `<layer>.<stage>`: the sweeps'
# link, the modem, the channel, the spatial link's detector, the coded chain
LAYERS = ("link", "modem", "channel", "detector", "coding")


def span(name: str):
    """A host span named `name` (`<layer>.<stage>`) around a stage of the
    program: while a torch.profiler records, a RecordFunction, which lands
    on the profiler's clock beside the kernels it launches and nests in the
    span around it; otherwise one shared null context, which allocates,
    reads and counts nothing.

    The RecordFunction is torch's C++ context manager, the one under
    `torch.profiler.record_function` without its two dispatcher ops: the
    span is an event like an op's (`cpu_op` in a Chrome trace), costs a
    profiler that records host ops about a µs, and one that records the
    card alone next to nothing, where `record_function` cost tens of µs a
    span and stretched a traced sweep call by 0.4-0.9 ms on an H100's host."""
    if _profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(path=None):
    """torch.profiler over the CPU and the card around the block; the Chrome
    trace is written to `path` (build/trace.json by default) on exit."""
    from torch.profiler import ProfilerActivity, profile
    path = Path(path) if path is not None else BUILD_DIR / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))


def _cmatmul_cost(name: str, m, k, n, unit: str = "tc_highest",
                  dtype_bytes: int = 4) -> KernelCost:
    """Complex matmul in the 8·m·k·n convention; operands and result as
    re/im planes."""
    return KernelCost(name, 8.0 * m * k * n, dtype_bytes * 2 * (m * k + k * n + m * n), unit)


def bcjr_pass_cost(n_blocks: int, k_prime: int, mode: str = "extrinsic") -> KernelCost:
    """One BCJR pass over n_blocks blocks of K' trellis steps (ops/bcjr,
    csrc/turbo_bcjr.cu): the LLRs in and out, BCJR_BYTES_PER_STEP a step a
    block (the kernel's own scratch, BCJR_SCRATCH_BYTES_PER_STEP, is not
    charged), BCJR_OPS_PER_STEP[mode] operations on the CUDA cores."""
    steps = float(n_blocks) * k_prime
    return KernelCost(f"bcjr_{mode}", BCJR_OPS_PER_STEP[mode] * steps,
                      BCJR_BYTES_PER_STEP * steps, "fp32")


def siso_frame_cost(config: LTEConfig, num_symbols: int = 14, lanes: int = 1,
                    precision: str = "highest", bits_dtype_bytes: int = 1,
                    awgn_mode: str = "freq") -> Dict[str, KernelCost]:
    """Every stage of one SISO step (sim/siso.SisoLink) at its unit's speed
    of light, the JAX package's counts: T time samples, D data symbols.

    - tx_idft, rx_dft_data, rx_dft_pilot: the modem's complex GEMMs;
    - awgn_sigma: the power pass (3 flops, 8 B a sample);
    - awgn_rng_add: two normals a noisy sample (24 flops each) and the
      scaled add (4); "freq" (the link's AWGN form) draws at the data and
      slot-start pilot bins and writes no time signal, "time" draws every
      time sample and writes it;
    - papr: one read of the TX signal; qam_map and qam_demap (10 and 30
      flops a symbol, bits at the caller's width); estimate_zf (14 flops
      and one H read a data bin); bit_error_count (two bit reads).
    """
    unit = _gemm_unit(precision)
    g = grid_for(config)
    S = lanes * num_symbols
    sps = config.samples_per_ofdm_symbol
    T = S * sps
    D = S * g.num_data
    n_slots = max(1, num_symbols // 7)
    Tb = (D + lanes * n_slots * g.num_pilot) if awgn_mode == "freq" else T
    bps = config.bits_per_symbol
    bB = bits_dtype_bytes
    return {
        "tx_idft": _cmatmul_cost("tx_idft", S, g.num_data, sps, unit),
        "rx_dft_data": _cmatmul_cost("rx_dft_data", S, config.N, g.num_data, unit),
        "rx_dft_pilot": _cmatmul_cost("rx_dft_pilot", lanes * max(1, num_symbols // 14),
                                      config.N, g.num_pilot, unit),
        "awgn_sigma": KernelCost("awgn_sigma", 3.0 * T, 8.0 * T),
        "awgn_rng_add": KernelCost("awgn_rng_add", (2 * 24 + 4) * Tb,
                                   (0 if awgn_mode == "freq" else 16) * Tb),
        "papr": KernelCost("papr", 4.0 * T, 8.0 * T),
        "qam_map": KernelCost("qam_map", 10.0 * D, bB * bps * D + 8.0 * D),
        "qam_demap": KernelCost("qam_demap", 30.0 * D, 8.0 * D + bB * bps * D),
        "estimate_zf": KernelCost("estimate_zf", 14.0 * D, 8.0 * D),
        "bit_error_count": KernelCost("bit_error_count", 2.0 * bps * D, 2.0 * bB * bps * D),
    }


def spatial_frame_cost(config: LTEConfig, num_symbols: int = 14, lanes: int = 1,
                       num_tx: int = 2, num_rx: int = 2, rank: int = 2,
                       precision: str = "highest", bits_dtype_bytes: int = 1,
                       channel_impl: str = "bins") -> Dict[str, KernelCost]:
    """Every stage of the TM4 step (sim/spatial.SpatialLink), the JAX
    package's counts: the flat channel at the bins ("bins"), or through the
    time domain and the RX GEMMs ("time"). B = lanes·S symbols, m data bins
    a layer, T time samples an antenna, Dq QAM symbols, E channel-estimate
    points, Nb noisy bin samples."""
    from ..mimo.layer_mapper import padded_length
    unit = _gemm_unit(precision)
    g = grid_for(config)
    S = num_symbols
    B = lanes * S
    sps = config.samples_per_ofdm_symbol
    nd = g.num_data
    m = padded_length(nd, rank) // rank
    n_pil = g.num_pilot
    Dq = lanes * S * nd
    T = B * sps
    E = num_rx * num_tx * B * m
    Nb = num_rx * B * (m + n_pil)
    bps = config.bits_per_symbol
    bB = bits_dtype_bytes
    costs = {
        "qam_map_precode": KernelCost(
            "qam_map_precode", (10.0 + 8.0 * rank) * Dq,
            bB * bps * Dq + 8.0 * Dq + 8.0 * num_tx * lanes * S * m),
        "tx_idft": KernelCost("tx_idft", 8.0 * (B * num_tx) * m * sps,
                              8.0 * B * num_tx * (m + sps), unit),
        "papr_corr": KernelCost("papr_corr", 8.0 * num_tx * T, 8.0 * num_tx * T),
        "channel_bins": KernelCost("channel_bins", (8.0 * num_tx + 2 * 24 + 4) * Nb,
                                   8.0 * Nb + 8.0 * num_rx * B * m),
        "estimate_per_tx": KernelCost("estimate_per_tx", 14.0 * E, 8.0 * E),
        "detect_mmse2": KernelCost(
            "detect_mmse2", (30.0 + 16.0 * num_rx * rank) * B * m,
            8.0 * B * (m * (num_rx + num_rx * num_tx + rank))),
        "demap_count": KernelCost("demap_count", (30.0 + 2.0 * bps) * Dq,
                                  8.0 * 2 * Dq + 2.0 * bB * bps * Dq),
    }
    if channel_impl == "time":
        costs["channel_bins"] = KernelCost(
            "channel_time", (8.0 * num_tx + 3) * num_rx * T + (2 * 24 + 4) * Nb,
            8.0 * (num_tx + 2 * num_rx) * T)
        costs["rx_dft"] = KernelCost(
            "rx_dft", 8.0 * (B * num_rx) * config.N * (m + n_pil),
            8.0 * B * num_rx * (config.N + m + n_pil), unit)
    return costs


def _jakes_channel_costs(T_samples: float, links: float, num_taps: int,
                         precision: str = "highest", x_reads: float = 1.0,
                         tap_hold: int = 1) -> Dict[str, KernelCost]:
    """The channel-FIR family (channel/rayleigh): the Jakes sum of sinusoids
    as one complex GEMM P (L, 16) @ E (16, Tg) through the `tc` kernel, and
    the per-tap delayed multiply-add y(t) = Σ_i g_i·h_i(t)·x(t − d_i) on the
    CUDA cores. tap_hold: taps made every `tap_hold` samples (the port's
    apply_multipath(hold=), 1 by default: a tap value a sample)."""
    ns = 16
    L = links * num_taps
    Tg = T_samples / max(1, tap_hold)
    return {
        "jakes_matmul": KernelCost("jakes_matmul", 8.0 * L * ns * Tg, 8.0 * L * Tg,
                                   _gemm_unit(precision)),
        "tap_fma": KernelCost("tap_fma", 8.0 * L * T_samples,
                              8.0 * (L * Tg / max(T_samples, 1.0) + links * x_reads + links)
                              * T_samples),
    }


def simo_frame_cost(config: LTEConfig, num_symbols: int = 14, lanes: int = 1,
                    num_rx: int = 4, num_taps: int = 4, precision: str = "highest",
                    bits_dtype_bytes: int = 1) -> Dict[str, KernelCost]:
    """Every stage of the SIMO 1×N MRC step over multipath
    (sim/diversity.SimoLink), the JAX package's counts: the SISO TX GEMM,
    per-leg Jakes multipath, per-leg time-domain AWGN, per-RX data and
    slot-start pilot DFTs, LS, MRC, demap."""
    unit = _gemm_unit(precision)
    g = grid_for(config)
    S = num_symbols
    B = lanes * S
    sps = config.samples_per_ofdm_symbol
    nd = g.num_data
    n_pil = g.num_pilot
    n_slots = max(1, S // 14)
    T = B * sps
    D = B * nd
    M = num_rx * T
    bps = config.bits_per_symbol
    bB = bits_dtype_bytes
    return {
        "qam_map": KernelCost("qam_map", 10.0 * D, bB * bps * D + 8.0 * D),
        "tx_idft": KernelCost("tx_idft", 8.0 * B * nd * sps, 8.0 * B * (nd + sps), unit),
        "papr": KernelCost("papr", 4.0 * T, 8.0 * T),
        **_jakes_channel_costs(S * sps, num_rx * lanes, num_taps, precision),
        "awgn_legs": KernelCost("awgn_legs", (3.0 + 2 * 24 + 4) * M, 16.0 * M),
        "rx_dft_data": KernelCost("rx_dft_data", 8.0 * num_rx * B * config.N * nd,
                                  8.0 * num_rx * B * (config.N + nd), unit),
        "rx_dft_pilot": KernelCost(
            "rx_dft_pilot", 8.0 * num_rx * lanes * n_slots * config.N * n_pil,
            8.0 * num_rx * lanes * n_slots * (config.N + n_pil), unit),
        "estimate_mrc": KernelCost(
            "estimate_mrc", 14.0 * num_rx * lanes * n_slots * nd + 16.0 * num_rx * D + 6.0 * D,
            8.0 * num_rx * D * 2 + 8.0 * D),
        "qam_demap_count": KernelCost("qam_demap_count", (30.0 + 2.0 * bps) * D,
                                      8.0 * D + 2.0 * bB * bps * D),
    }


def sfbc_frame_cost(config: LTEConfig, num_symbols: int = 14, lanes: int = 1,
                    num_rx: int = 1, num_taps: int = 4, precision: str = "highest",
                    bits_dtype_bytes: int = 1) -> Dict[str, KernelCost]:
    """Every stage of the 2×N Alamouti SFBC step over multipath
    (sim/diversity.SfbcLink), the JAX package's counts: both TX antennas'
    GEMM, 2·num_rx Jakes legs, per-RX bin noise, data and slot-start pilot
    DFTs, per-TX estimation, the Alamouti decode, demap."""
    from ..sim.diversity import sfbc_data_bins
    unit = _gemm_unit(precision)
    g = grid_for(config)
    S = num_symbols
    B = lanes * S
    sps = config.samples_per_ofdm_symbol
    ne = len(sfbc_data_bins(config))
    n_pil = g.num_pilot
    n_slots = max(1, S // 14)
    D = B * ne
    Nb = num_rx * (D + lanes * n_slots * n_pil)
    bps = config.bits_per_symbol
    bB = bits_dtype_bytes
    return {
        "qam_map_alamouti": KernelCost("qam_map_alamouti", 16.0 * D,
                                       bB * bps * D + 8.0 * 2 * D),
        "tx_idft": KernelCost("tx_idft", 8.0 * 2 * B * ne * sps, 8.0 * 2 * B * (ne + sps), unit),
        "papr": KernelCost("papr", 4.0 * 2 * B * sps, 8.0 * 2 * B * sps),
        **_jakes_channel_costs(S * sps, 2 * num_rx * lanes, num_taps, precision),
        "bin_noise": KernelCost("bin_noise", (2 * 24 + 4) * Nb + 3.0 * num_rx * B * sps,
                                8.0 * Nb + 8.0 * num_rx * B * sps),
        "rx_dft_data": KernelCost("rx_dft_data", 8.0 * num_rx * B * config.N * ne,
                                  8.0 * num_rx * B * (config.N + ne), unit),
        "rx_dft_pilot": KernelCost(
            "rx_dft_pilot", 8.0 * num_rx * lanes * n_slots * config.N * n_pil,
            8.0 * num_rx * lanes * n_slots * (config.N + n_pil), unit),
        "estimate_decode": KernelCost(
            "estimate_decode", 14.0 * 2 * num_rx * lanes * n_slots * ne + 24.0 * num_rx * D,
            8.0 * 2 * num_rx * D + 8.0 * D),
        "qam_demap_count": KernelCost("qam_demap_count", (30.0 + 2.0 * bps) * D,
                                      8.0 * D + 2.0 * bB * bps * D),
    }


def _report(costs: Dict[str, KernelCost], measured_step_s: float, precision: str,
            dispatch_floor_s: float) -> Dict:
    over_floor = max(measured_step_s - dispatch_floor_s, 1e-9)
    return {
        "precision": precision,
        "card": CARD,
        "modeled_gflops": sum(c.flops for c in costs.values()) / 1e9,
        "modeled_gbytes": sum(c.bytes for c in costs.values()) / 1e9,
        "measured_s": measured_step_s,
        "dispatch_floor_s": dispatch_floor_s,
        **_fraction_fields(costs, measured_step_s, dispatch_floor_s),
        "roofline_fraction_excl_floor": _total_roofline_s(costs) / over_floor,
        "per_kernel_us": {k: round(c.roofline_time_s() * 1e6, 1) for k, c in costs.items()},
    }


def roofline_report(config: LTEConfig, num_symbols: int, lanes: int, measured_step_s: float,
                    precision: str = "highest", bits_dtype_bytes: int = 1,
                    awgn_mode: str = "freq", dispatch_floor_s: float = 0.0) -> Dict:
    """Roofline fractions of a measured SISO step (siso_frame_cost)."""
    costs = siso_frame_cost(config, num_symbols, lanes, precision, bits_dtype_bytes, awgn_mode)
    return _report(costs, measured_step_s, precision, dispatch_floor_s)


def spatial_roofline_report(config: LTEConfig, num_symbols: int, lanes: int,
                            measured_step_s: float, num_tx: int = 2, num_rx: int = 2,
                            rank: int = 2, precision: str = "highest",
                            dispatch_floor_s: float = 0.0, channel_impl: str = "bins") -> Dict:
    """Roofline fractions of a measured TM4 step (spatial_frame_cost);
    `roofline_fraction_excl_floor` holds the model against the step time
    above the host's dispatch floor."""
    costs = spatial_frame_cost(config, num_symbols, lanes, num_tx, num_rx, rank, precision,
                               channel_impl=channel_impl)
    return {**_report(costs, measured_step_s, precision, dispatch_floor_s),
            "channel_impl": channel_impl}


def fir_roofline_report(costs: Dict[str, KernelCost], measured_step_s: float,
                        precision: str = "highest", dispatch_floor_s: float = 0.0) -> Dict:
    """Roofline fractions of a measured SIMO or SFBC step, with the
    channel-FIR family's share (jakes_matmul, tap_fma) apart."""
    fir_s = sum(c.roofline_time_s() for k, c in costs.items()
                if k in ("jakes_matmul", "tap_fma"))
    return {**_report(costs, measured_step_s, precision, dispatch_floor_s),
            "channel_fir_roofline_s": fir_s}
