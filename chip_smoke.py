"""Drive the PyTorch port's paths once on one CUDA card and check them.

    python3 chip_smoke.py

The main path is the 20 MHz 64-QAM SISO link over AWGN with CRS
estimation and ZF, at 256 Monte-Carlo lanes of 14-symbol frames
(21.5 M bits per step), as ofdm_lte_tpu_torch.sim.siso.SisoLink runs it.
Beside it run the other SISO branches (SC-FDM, simple mode, Jakes/ITU
multipath, flat fading), the diversity links (SIMO 1×2 MRC, 2×2 Alamouti
SFBC) and TM4 spatial multiplexing (4×2 rank 2 MMSE over the flat channel
at the bins and in the time domain, 4×4 rank 4 SIC and 8×4 rank 2 with the
extended CRS layout over multipath) and TM6 beamforming with PMI feedback
(4×2 over the static flat channel, 8×1 over the Jakes channel at 30 km/h
with W recomputed every 4 symbols) and the TS 36.212 coded chain (a 6,000-bit
transport block a lane, one transmission; a 75,376-bit one with HARQ over
rv 0-3; 8 max-log iterations), see PATHS. Every complex GEMM of every path goes through
the tensor-core kernel `cmatmul_tf32x3` (`tc`, 4-dot form, `highest`); the
tensor-core Gauss kernel `cmatmul_tf32x3_gauss` and the CUDA-core kernel
`cmatmul_f32` (`ffma`: 4-dot and Gauss forms) are driven beside it on the
main path, and the kernels of the `high` and `default` precisions on the
paths of phase 9; every half-iteration of the turbo decoder (the a-priori's QPP
gather, the BCJR pass, the extrinsic) is one launch of `turbo_bcjr`
(csrc/turbo_bcjr.cu), 17 a decode. Phases, each of which raises on failure:

1. require a CUDA card; print its name and power limit;
2. build the CUDA kernels from ofdm_lte_tpu_torch/csrc into build/;
3. hold the four kernels against their plain PyTorch versions (fp32, TF32
   off) at every GEMM shape of every path, with the strided operands the
   paths make (CP-stripped and slot-start views, a leading antenna axis),
   (the coded paths' TX, RX data and RX pilot products too) and at two
   small ragged shapes and one whose A starts 4 bytes off 16-byte
   alignment: `tc` against `cmatmul_plain` and
   `cmatmul_plain_tf32x3`, the tensor-core Gauss kernel against
   `cmatmul_plain(gauss=True)` and `cmatmul_plain_gauss_tf32x3`, `ffma`
   4-dot and Gauss against `cmatmul_plain` of the same form. Print each
   one's error against a float64 product (a yardstick). Run the split-K
   pilot GEMM twice through each tensor-core kernel and require identical
   bits. Hold `turbo_bcjr` on the card at K' 43, 1027, 5827, 6083 and
   6147, batches of 1, 7 and 64 blocks (odd counts leave a half-warp
   alone), non-zero a-priori LLRs, in every mode: APP (`bcjr_app`) against
   `bcjr_plain`, and the half-iteration (`bcjr_half`: the extrinsic with
   the a-priori through the QPP π, through π⁻¹ and null, and the hard
   bits) against `bcjr_half_plain`: max-log equal as floats, log-MAP within
   BCJR_LOGMAP_TOL (hard bits equal wherever the APP is farther than that
   from 0), two launches bit-identical;
4. run the facade once per method: OFDMModule.transmit, simulate_simo,
   simulate_mimo, simulate_spatial_multiplexing, simulate_beamforming over
   either channel model, simulate_siso_coded, simulate_siso_coded_harq and
   a 3-point run_ber_sweep, a 3-point `ber_sweep` of the spatial, the
   SFBC, the beamforming and the coded pipelines, and a 2-point
   `harq_sweep`;
5. run the main path at 60 dB (BER must be 0) and 15 dB (BER in
   [0.0836, 0.0880], around the JAX package's 0.08586), once per kernel,
   counting kernel launches (3 per step); run every other path at 60 dB
   (BER 0 where the link is clean, under a ceiling where it is not) and at
   its working SNR (mean BER within 4σ of the JAX package's, JAX_BER), with
   the launches the code implies and no operand copied by the wrapper; and
   hold the CUDA path against the CPU path on small inputs with the same
   injected draws (main path, SC-FDM, multipath, flat fading, SIMO 1×2
   over multipath, SFBC 2×2 over AWGN and over multipath, spatial 4×2 MMSE
   and 4×4 SIC over multipath, beamforming 4×2 static and 8×1 Jakes), the
   spatial link at the bins against its time path on the card under the
   same draws, and the time-varying flat MIMO channel's one product through
   the kernel; run the coded chain's front end (CRC, rate matching and
   de-matching at K 40 and 6144, rv 0-3, with repetition and puncturing,
   max-log LLRs of a 20 MHz 64-QAM frame of 256 lanes) on the card and
   demand the CPU's results: equal bits, LLRs within 1e-6 of max|LLR|; the
   coded paths give BLER 0 and BER 0 at 30 dB and, at their working SNR,
   BLER (per HARQ stage) within 4σ of the JAX package's (binomial σ² =
   p(1−p)(1/256 + 1/64), one-sided where the JAX BLER is 0 or 1: see
   bler_band) and BER in its band; the batched HARQ on the card
   equals the CPU's under the same draws at 5 MHz QPSK (1,000- and
   12,000-bit transport blocks, 4 lanes): bits, CRC outcomes, transmissions;
6. time each path (CUDA events, bits and seed changed every step), the main
   one through each of the four kernels in turns, and each GEMM shape
   through the four kernels, the plain versions and one library call
   (torch.matmul on complex64 operands made before the timed window),
   beside its bound: the larger of bytes moved over 3.35 TB/s and
   operations over the peak rate of their type (TF32 tensor cores 495
   TFLOP/s for the two tensor-core kernels, which do three TF32 products
   per fp32 product: 3 x 8·M·K·N for `tc`, 3 x 6·M·K·N for Gauss; fp32
   CUDA cores 67 TFLOP/s for `ffma`); the coded paths' transport blocks
   and information bits a second, and the BCJR kernel's time a pass at the
   paths' shapes (256 × K' 6083, 3,328 × K' 5827) in its APP and extrinsic
   modes, there equal to its plain versions as floats, beside its bound
   (16 B a step a block over 3.35 TB/s, the LLRs in and out; the design's
   scratch printed apart), its registers and spills (from the build log),
   its plain versions' times and its log-MAP time; no single PyTorch call
   computes a BCJR pass, so its library time is null; and a whole decode
   (8 max-log iterations, 17 launches) at both shapes through the kernel
   and through the plain half-iteration, with equal bits required and the
   BER inside the JAX package's band at that σ (JAX_DECODE_BER);
7. drive the command-line interface (ofdm_lte_tpu_torch/cli.py) in-process
   with no --device, so on the card, at 20 MHz 64-QAM, each command timed
   on the host's clock with its kernel launches counted: `info` (the CPU's
   lines); `run` of each of the eight pipelines at 60 dB on one 14-symbol
   frame (BER 0, the GEMMs of CLI_RUN_GEMMS, 17 turbo_bcjr launches a
   decode); `sweep` at 15 and 60 dB, 256 frames a point, twice into one
   checkpoint (BER in the main path's band, 0 at 60 dB; the resumed run
   banks a second, new round); the HARQ `sweep` of the 75,376-bit
   transport block at 16.2 and 30 dB (BLER by stage in the JAX bands, 0 at
   30 dB); `fullsweep` over 1 and 2 RX (BER 0 at 60 dB); the image
   workflow's array part (cli.transmit_image: a 128x128x3 image back
   exactly at 60 dB); `bfcompare` at its defaults (12 rows; the SFBC rows
   within the JAX band, JAX_BFCOMPARE_SFBC_BER; each beamforming row's
   spread beside the published value); `papr` against `papr --device cpu`
   (within 1e-3 dB);
8. the N-process sweeps over torch.distributed (parallel.distributed,
   parallel.mp_bench), the native bit library and the H100 cost model:
   (a) native/bitops.cc built into build/: CRC-24A of a 75,376-bit
   transport block and CRC-24B of its 13 code blocks equal to
   crc_bits_plain, pack, unpack and bit_errors equal to NumPy, host times;
   (b) the HBM rate of one 2 GiB device-to-device copy (CUDA events) beside
   utils.profiling's; (c) a world-1 NCCL group in this process: the
   flagship sweep (15 and 60 dB, 256 frames) with its counts reduced on the
   card equal to the one-device sweep's, under the same bits and seams and
   drawn; (d) two fresh interpreters in one gloo group, both on cuda:0,
   one job list: the flagship sweep drawn at 128 frames a rank (BER in the
   main path's band, 0 at 60 dB), under global bits and seams (counts equal
   to the one-device sweep's), on 2 SNR shards over 3 points (padding),
   the HARQ sweep of the 75,376-bit block at 16.2 and 30 dB (BLER by stage
   in phase 7's bands), `cli sweep --snr-shards 2` (rank 0 alone prints);
   both ranks' reduced counts equal, each rank's launches in
   `mp2/<path>/rank<r>`; (e) distributed.dryrun(2), the JAX package's dry
   run; (f) mp_bench's frames/s at 1 and 2 processes sharing the card, for
   the flagship and the coded 6,000-bit link; (g) the flagship step of
   phase 6 against utils.profiling.roofline_report, every fraction in
   (0, 1].

9. the GEMMs at the JAX package's other two precisions, set in-process
   through OFDM_LTE_TPU_TORCH_MATMUL_PRECISION for each reading and restored
   after: `high`, one TF32 product of the operands' TF32 heads
   (`cmatmul_tf32`, `cmatmul_tf32_gauss`: csrc/cmatmul_wgmma_tf32.cu), and
   `default`, bf16 operands with fp32 sums (`cmatmul_bf16`,
   `cmatmul_bf16_gauss`, csrc/cmatmul_bf16.cu), all four on wgmma fed by TMA
   (csrc/wgmma_cmatmul.cuh; their registers and spills from the build log
   and their shared memory printed):
   (a) the four kernels against the plain versions that round as they do
   (ops.cmatmul.PLAIN; TOL) at every GEMM shape of phase 3 with its strides,
   the ragged shapes and the Jakes products, and against a float64
   product of the unrounded operands within the bound that their rounding
   allows (ops.cmatmul.rounding_bound, elementwise); the split-K pilot GEMM
   twice through each, identical bits; each kernel's workspace query
   against ops.cmatmul.wgmma_workspace_floats at every shape; each kernel
   against its plain version at the flagship's own TX and RX data operands
   over 8 draws of its bits (draw_errors, within TOL); (b) under
   `default` in the 4-dot
   form the flagship and every path of PATHS at their clean and working SNR
   (phase 5's bits, draws and bands; DEFAULT_EXCLUDED names a path left out
   of its band, none), and under `high` in both forms and `default` in the
   Gauss form the flagship, `lte_rayleigh_mp` and `coded_6000_awgn`, each
   with its launches of the one kernel of its precision and form; the
   flagship at 15 and 60 dB under the same bits and draws at each
   precision, with the share of bit decisions that differ from `highest`'s
   (0 at 60 dB); (c) VALIDATION.md's anchors (ANCHORS) at each precision
   under the same bits and draws, with the BER's move in Monte-Carlo σ
   (within 4); (d) the flagship step at each precision and form, and each
   GEMM shape through each of the four kernels beside its bound (TF32 495,
   bf16 989 TFLOP/s), its plain version and one library call
   (torch.matmul on complex64 with allow_tf32 for `high`; for `default`
   under float32 matmul precision "medium", or, where that ran no bf16
   kernel, the faster of two bf16 stand-ins with bf16 out, four real
   products and one product of the real block form (bf16_stand_ins): the
   kernels they ran are printed).

The second-to-last line is a JSON object describing each kernel (its times
are sums over all timed GEMM shapes, `by_shape` has each; `launches_by_path`
has the launches of each path, of each CLI command, `cli/<command>`, of
each N-process path, `nccl1/<path>` and `mp2/<path>/rank<r>`, and of phase
9's paths, `prec/<precision>/<path>`); the last is
{"ok": true, "device": {...}}. Needs one card and no network.

    python3 chip_smoke.py --profile [PATH[,PATH...]]

also traces 10 steps of each PATH (`main`, the default, or names of PATHS)
with torch.profiler before those two lines and prints where a step's
device time goes: all kernels, the GEMM kernels, the number of kernels a
step (for the coded paths: 17 BCJR launches a decode and the rest), and
the device's idle share of the traced wall time. It fails if a
device kernel whose name holds `gemm` or `cutlass` ran (every product of a
driven path belongs to the four hand-written kernels) beyond the CRC
products of the coded paths (`coding.crc.crc_torch`, a torch.matmul as the
JAX package's plain XLA dot: as many library GEMM kernels as its launches
in the window times the kernels one call launches), or an eigensolver's
(EIGENSOLVER_KERNELS: the beamforming paths ask the feedback for the PMI
and W alone, not for RI).
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the GEMM kernels with the variant, precision and form of each
from ofdm_lte_tpu_torch.ops.cmatmul import KERNELS as CMATMUL_KERNELS
# the card's peaks, and what a BCJR pass moves and does a step a block
from ofdm_lte_tpu_torch.utils.profiling import (BCJR_BYTES_PER_STEP, BCJR_OPS_PER_STEP,
                                                BCJR_SCRATCH_BYTES_PER_STEP, DATASHEET)

LANES = 256
SYMBOLS = 14
STEPS = 20
BER_15DB = (0.0836, 0.0880)

# The other paths, 20 MHz 64-QAM like the main one. kind: which link runs it;
# kw: the link's arguments; snr: the working SNR of the BER check; ber60: the
# most the mean BER may be at 60 dB (0 where the link is clean; over multipath
# the CRS interpolation leaves a floor in deep fades, in the JAX package too;
# None where per-sample fading leaves nothing to detect); launches:
# complex-GEMM launches a step that the code implies (TX, Jakes taps, RX data,
# RX pilot, SC-FDM precode and decode).
PATHS = {
    "scfdm_awgn": dict(kind="siso", kw=dict(mode="sc-fdm"), snr=15.0, ber60=0.0, launches=5),
    "simple_awgn": dict(kind="siso", kw=dict(mode="simple"), snr=15.0, ber60=0.0, launches=2),
    "lte_rayleigh_mp": dict(kind="siso", kw=dict(channel_type="rayleigh_mp",
                                                 itu_profile="Pedestrian_A"),
                            snr=25.0, ber60=1e-2, launches=4),
    "lte_fading": dict(kind="siso", kw=dict(channel_type="fading"), snr=20.0, ber60=None,
                       launches=3),
    "simo_1x2_rayleigh_mp": dict(kind="simo", kw=dict(num_rx=2, channel_type="rayleigh_mp",
                                                      itu_profile="Pedestrian_A"),
                                 snr=20.0, ber60=1e-3, launches=4),
    "sfbc_2x2_awgn": dict(kind="sfbc", kw=dict(num_rx=2), snr=15.0, ber60=0.0, launches=3),
    "sfbc_2x2_rayleigh_mp": dict(kind="sfbc", kw=dict(num_rx=2, channel_type="rayleigh_mp",
                                                      itu_profile="Pedestrian_A"),
                                 snr=15.0, ber60=1e-3, launches=4),
    # TM4 spatial multiplexing (kind "spatial": sim.spatial.SpatialLink). The
    # flat channel at the bins launches the TX GEMM alone; the time path adds
    # RX data and the per-symbol RX pilot GEMM; multipath adds the Jakes
    # product; the extended CRS layout one tap-basis GEMM per TX antenna.
    "spatial_4x2_r2_mmse": dict(kind="spatial", kw=dict(
        num_tx=4, num_rx=2, rank_used=2, detector_type="MMSE"),
        snr=25.0, ber60=0.0, launches=1),
    "spatial_4x2_r2_mmse_time": dict(kind="spatial", kw=dict(
        num_tx=4, num_rx=2, rank_used=2, detector_type="MMSE", channel_impl="time"),
        snr=25.0, ber60=0.0, launches=3),
    "spatial_4x4_r4_sic_rayleigh_mp": dict(kind="spatial", kw=dict(
        num_tx=4, num_rx=4, rank_used=4, detector_type="SIC", channel_type="rayleigh_mp",
        itu_profile="Pedestrian_A"), snr=20.0, ber60=8e-2, launches=4),
    "spatial_8x4_r2_mmse_ext_rayleigh_mp": dict(kind="spatial", kw=dict(
        num_tx=8, num_rx=4, rank_used=2, detector_type="MMSE", channel_type="rayleigh_mp",
        itu_profile="Pedestrian_A", pilot_layout="extended"),
        snr=25.0, ber60=1e-3, launches=12),
    # TM6 rank-1 beamforming with PMI feedback (kind "beamforming":
    # sim.beamforming.BeamformingLink), the frequency-domain link y = H·W s + n
    # with MRC: the static flat channel launches no GEMM; the Jakes channel
    # (30 km/h at 2 GHz: f_D = 55.6 Hz, W recomputed every 4 symbols) its one
    # E (S, 16) @ P (16, lanes·rx·tx) product
    "bf_4x2_tm6_codebook": dict(kind="beamforming", kw=dict(
        num_tx=4, num_rx=2, update_mode="static"), snr=15.0, ber60=0.0, launches=0),
    "bf_8x1_tm6_jakes_30kmh": dict(kind="beamforming", kw=dict(
        num_tx=8, num_rx=1, update_mode="static", channel_model="jakes", update_period=4,
        doppler_hz=30.0 / 3.6 * 2e9 / 3e8), snr=15.0, ber60=0.0, launches=1),
    # the TS 36.212 coded chain (kind "coded": sim.coded.CodedLink), AWGN in the
    # time domain, 8 max-log iterations, clean at 30 dB. One 6,000-bit
    # transport block a lane (one block, K 6080, 56 fillers; 4 symbols), rv 0:
    # ber_sweep's coded default; and the largest single-layer transport block
    # at 100 PRBs (TS 36.213 Table 7.1.7.2.1-1, I_TBS 26), 75,376 bits (13
    # blocks of K 5824, 38 symbols), with HARQ over rv 0-3. Launches a step:
    # 3 GEMMs and 17 BCJR passes a block size a transmission; the 38-symbol
    # frame's slot-start view does not fold into rows, so its RX pilot
    # operand (two planes) is copied each transmission.
    "coded_6000_awgn": dict(kind="coded", kw=dict(tb_bits=6000, rv_sequence=(0,)), snr=20.85,
                            ber60=0.0, launches=3, bcjr=17, copies=0),
    "harq_75376_awgn": dict(kind="coded", kw=dict(tb_bits=75376, rv_sequence=(0, 1, 2, 3)),
                            snr=16.2, ber60=0.0, launches=12, bcjr=68, copies=8),
}
PATH_STEPS = 10     # timed steps of each of those paths
CODED_CLEAN_SNR = 30.0   # the coded paths' clean point (their ber60)

# The JAX package's BER on each path at its working SNR: mean, standard
# deviation of the per-lane BER, lanes and bits. Run on the CPU, 20 MHz 64-QAM,
# 14 symbols, by `JAX_PLATFORMS=cpu python tests/test_torch_chip_bands.py`;
# what it printed is kept in tests/test_torch_chip_bands.txt, with the BER at
# 60 dB over 8 lanes. Over flat fading the BER is 0.5 in both packages
# (per-sample fading leaves nothing to equalize), so that path's band holds
# little: its check is the comparison with the CPU path under the same
# draws, below.
JAX_BER = {
    "scfdm_awgn": dict(mean=0.0967074, lane_std=0.00355533, lanes=64, bits=5370624),
    "simple_awgn": dict(mean=0.0498255, lane_std=0.00116837, lanes=64, bits=6451200),
    "lte_rayleigh_mp": dict(mean=0.0219969, lane_std=0.0160059, lanes=64,
                            bits=5370624),
    "lte_fading": dict(mean=0.49964, lane_std=0.00135759, lanes=64,
                       bits=5370624),
    "simo_1x2_rayleigh_mp": dict(mean=0.0125064, lane_std=0.00712447, lanes=64,
                                 bits=5370624),
    "sfbc_2x2_awgn": dict(mean=0.0126015, lane_std=0.00142068, lanes=64, bits=5365248),
    "sfbc_2x2_rayleigh_mp": dict(mean=0.039381, lane_std=0.00977599, lanes=64,
                                 bits=5365248),
    # one H a lane over the flat MIMO channel: the per-lane BER has a heavy tail
    "spatial_4x2_r2_mmse": dict(mean=0.0289572, lane_std=0.0597472, lanes=64, bits=5370624),
    "spatial_4x2_r2_mmse_time": dict(mean=0.0289572, lane_std=0.0597473, lanes=64,
                                     bits=5370624),
    # 20 dB: three times the CRS interpolation's floor (0.034 at 60 dB), so that
    # the band holds the noise power and not the floor alone
    "spatial_4x4_r4_sic_rayleigh_mp": dict(mean=0.121784, lane_std=0.0310226, lanes=64,
                                           bits=5370624),
    "spatial_8x4_r2_mmse_ext_rayleigh_mp": dict(mean=0.00704108, lane_std=0.00203682,
                                                lanes=64, bits=5370624),
    # one H a lane for the whole frame (static) or one Jakes trajectory a
    # lane: heavy-tailed per-lane BER, as over the flat MIMO channel
    "bf_4x2_tm6_codebook": dict(mean=0.0155658, lane_std=0.015778, lanes=64, bits=5370624),
    "bf_8x1_tm6_jakes_30kmh": dict(mean=0.0234718, lane_std=0.0216076, lanes=64,
                                   bits=5370624),
    # one transport block a lane: the per-lane BER is 0 or a failed decode's,
    # and `bler` is the BLER after each transmission. At 16.2 dB no single
    # transmission of 13 blocks decodes (the waterfall of one 6,000-bit
    # transmission runs from 20.6 to 21.25 dB), two combined decode a third
    # of the time (rv 2 adds nothing to rv 0 and 1 there) and four nearly
    # always: stage 2 sits on the waterfall
    "coded_6000_awgn": dict(mean=0.127799, lane_std=0.13063, lanes=64, bits=384000,
                            bler=[0.5]),
    "harq_75376_awgn": dict(mean=0.00113224, lane_std=0.00442563, lanes=64, bits=4824064,
                            bler=[1, 0.34375, 0.34375, 0.0625]),
}

# A whole turbo decode in phase 6: DECODE_ITERATIONS max-log iterations on
# BPSK codewords (±1 plus Gaussian noise of σ DECODE_SIGMA, LLR 2y/σ²), at the
# coded paths' block shapes. σ 0.7 lies on the waterfall of the JAX
# package's trellis: some blocks decode, some fail (at σ 0.75 every block
# fails, BER about 0.35). JAX_DECODE_BER, per K, is the JAX package's BER
# there (mean and standard deviation of the per-block BER, blocks, bits),
# from `JAX_PLATFORMS=cpu python tests/test_torch_chip_bands.py turbo_decode`
# (kept in tests/test_torch_chip_bands.txt); the card's decode must lie
# within ber_band of it. The comparison with the plain decode, which runs
# the same turbo_decode, cannot see a fault in the decoder's wiring (π, π⁻¹,
# the extrinsic); this band can.
DECODE_SIGMA = 0.7
DECODE_ITERATIONS = 8
DECODE_SHAPES = (("coded_6000_awgn", LANES, 6080), ("harq_75376_awgn", 13 * LANES, 5824))
JAX_DECODE_BER = {
    6080: dict(mean=0.133794, lane_std=0.147296, lanes=256, bits=1556480),
    5824: dict(mean=0.145484, lane_std=0.164245, lanes=256, bits=1490944),
}

# Phase 7's `bfcompare` at its defaults (10 MHz 64-QAM, 15 dB, 1,620,000
# bits): the JAX package's BER on the 2×num_rx SFBC row, which runs the whole
# payload as one frame over the fixed-phase AWGN channel (mean and standard
# deviation over 64 runs), from `JAX_PLATFORMS=cpu python
# tests/test_torch_chip_bands.py bfcompare_sfbc` (kept in
# tests/test_torch_chip_bands.txt); the card's one run must lie within
# ber_band(·, 1) of it. The beamforming rows are one random H a lane: their
# spread is printed beside the published value, not held.
JAX_BFCOMPARE_SFBC_BER = {
    1: dict(mean=0.0503926, lane_std=0.000752162, lanes=64, bits=103680000),
    2: dict(mean=0.0122999, lane_std=0.000297536, lanes=64, bits=103680000),
    4: dict(mean=0.0011314, lane_std=6.45842e-05, lanes=64, bits=103680000),
}
# GEMM launches of one `cli run` at one 14-symbol frame, by pipeline: the
# TX, RX data and RX pilot products of the SISO link and of the SIMO and
# SFBC links over AWGN, the spatial link's TX product at the bins, none for
# the frequency-domain beamforming link; the coded pipelines decode once a
# transmission per code-block size, 17 turbo_bcjr launches a decode.
CLI_RUN_GEMMS = {"siso": 3, "siso-coded": 3, "harq": 3, "simo": 3, "miso": 3, "mimo": 3,
                 "beamforming": 0, "spatial": 1}

# max|Δ| / max|C| against the plain version of the same form. tc and ffma
# 4-dot: the same products in another sum order; Gauss (either kernel): one
# extra rounding and a fold, t3 − t1 − t2, that cancels. The kernels at
# `high` (tf32) and `default` (bf16) against the plain versions that round
# the operands as they do (ops.cmatmul.PLAIN): the same exact products in
# another sum order, so the same tolerances.
TOL = {"tf32x3": 1e-5, "tf32x3_gauss": 1e-4, "f32_fma4": 1e-5, "f32_gauss": 1e-4,
       "tf32": 1e-5, "tf32_gauss": 1e-4, "bf16": 1e-5, "bf16_gauss": 1e-4}
# the kernels of `highest`, which phases 3, 5 and 6 drive; phase 9 drives the
# kernels of `high` and `default`
HIGHEST = ("tf32x3", "tf32x3_gauss", "f32_fma4", "f32_gauss")
PRECISION_KERNELS = ("tf32", "tf32_gauss", "bf16", "bf16_gauss")
PRECISION = {kernel: CMATMUL_KERNELS[kernel][1] for kernel in TOL}
# turbo_bcjr against bcjr_plain under log-MAP, max|Δ| over the largest path
# metric Σ_k (|L_sys| + |L_par| + |L_apr|)/2 (the metrics are not renormalised;
# expf/logf and the 8-state sum order differ by ulps). Max-log: equal.
BCJR_LOGMAP_TOL = 1e-6
# phase 8: the largest share of a point's bits whose decision may differ
# between an N-process sweep and the one-device sweep of all its lanes under
# the same bits and seams: the GEMMs of a rank's M rows split K otherwise
# than those of all rows, so bins on the decision boundary round either way
# (3 of 21.5 M bits in a first run on the card)
MAX_SPLIT_ORDER_FLIPS = 1e-6
GAUSS = {kernel: CMATMUL_KERNELS[kernel][2] for kernel in TOL}
TENSOR_CORE = {kernel: CMATMUL_KERNELS[kernel][0] == "tc" for kernel in TOL}
HBM_BYTES_PER_S = DATASHEET["hbm"]
# name fragments of cuSOLVER's and MAGMA's Hermitian eigensolver kernels
# (Jacobi, and the tridiagonal reduction, solve and back-transform of syevd)
EIGENSOLVER_KERNELS = ("syev", "heev", "sytrd", "hetrd", "steqr", "stedc", "ormtr", "unmtr",
                       "eigh", "eigval", "jacobi")
PEAK_FLOPS = {"tf32": DATASHEET["tf32"], "bf16": DATASHEET["bf16"], "fp32": DATASHEET["fp32"]}
# phase 9: the paths whose BER leaves its band under `default` while its
# kernels hold their plain versions and the rounding bound; each is still
# run and printed with its BER and σ, but not held to the band (none)
DEFAULT_EXCLUDED = ()
# phase 9 (c): the anchors of VALIDATION.md's precision study, (modulation,
# bandwidth MHz, SNR dB, symbols)
ANCHORS = (("QPSK", 5.0, 6.0, 28), ("16-QAM", 5.0, 14.0, 28), ("64-QAM", 5.0, 20.0, 28),
           ("64-QAM", 20.0, 15.0, 14))


def ber_band(ref: dict, lanes: int) -> tuple:
    """(lo, hi): 4σ around the JAX package's mean BER for a run of `lanes`
    lanes, σ² = lane_std²·(1/ref lanes + 1/lanes). A coded path whose JAX
    lanes all decoded after the last transmission (lane_std 0) gets the
    one-sided [0, hi·½], hi the upper BLER limit of that stage: a lane that
    fails has a BER below one half."""
    if "bler" in ref and ref["lane_std"] == 0.0:
        return 0.0, 0.5 * bler_band(ref["bler"][-1], lanes, ref["lanes"])[1]
    half = 4.0 * ref["lane_std"] * np.sqrt(1.0 / ref["lanes"] + 1.0 / lanes)
    return max(0.0, ref["mean"] - half), ref["mean"] + half


def bler_band(p: float, lanes: int, ref_lanes: int = 64) -> tuple:
    """(lo, hi): 4σ around the JAX package's BLER p, σ² = q(1−q)(1/lanes +
    1/ref_lanes), with q = p held inside [1/(2·ref_lanes), 1 − 1/(2·ref_lanes)]:
    a BLER of 0 (or 1) over ref_lanes lanes gets a one-sided band of about
    3/ref_lanes, the rule of three, not a band of width 0."""
    q = min(max(p, 0.5 / ref_lanes), 1.0 - 0.5 / ref_lanes)
    half = 4.0 * np.sqrt(q * (1.0 - q) * (1.0 / lanes + 1.0 / ref_lanes))
    return max(0.0, p - half), min(1.0, p + half)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, run_ahead: bool = False) -> float:
    """Mean device time of fn() over reps runs after 3 warm-up runs.

    run_ahead=True first parks the device on a spin kernel, so that the host
    has every launch enqueued before the first one runs and the events see
    device time alone (for kernels shorter than their launch)."""
    for _ in range(3):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if run_ahead:
        torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def is_library_gemm(name: str) -> bool:
    return "gemm" in name.lower() or "cutlass" in name.lower()


def profile_steps(step, steps: int = 10, crc_gemm_kernels: int = 0) -> None:
    """Print the split of a step's device time from a torch.profiler trace.

    crc_gemm_kernels: the library GEMM kernels one CRC product
    (coding.crc.crc_torch) launches; the trace may hold that many for each
    crc_torch call in its window, and no other."""
    from torch.profiler import ProfilerActivity, profile
    from ofdm_lte_tpu_torch.coding import crc
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        crc.crc_torch.launches = 0
        t1 = time.perf_counter()
        for _ in range(steps):
            step()
        enqueue_ms = 1e3 * (time.perf_counter() - t1) / steps
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1) / steps
        crc_calls = crc.crc_torch.launches
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity")
    library = [e.name for e in kernels if is_library_gemm(e.name)]
    allowed = crc_calls * crc_gemm_kernels
    if len(library) > allowed:
        raise AssertionError(f"a library GEMM ran on a driven path: {len(library)} kernels "
                             f"{sorted(set(library))}, {crc_calls} CRC products allow {allowed}")
    if library:
        print(f"library GEMM kernels: {len(library)} in {crc_calls} CRC products "
              f"({crc_gemm_kernels} a product allowed): {sorted(set(library))}")
    solvers = sorted({e.name for e in kernels
                      if any(w in e.name.lower() for w in EIGENSOLVER_KERNELS)})
    if solvers:
        raise AssertionError(f"an eigensolver ran on a driven path: {solvers}")
    dev_ms = sum(e.device_time for e in kernels) / 1e3 / steps
    gemm = [e for e in kernels if "cmatmul" in e.name or "splitk" in e.name]
    gemm_ms = sum(e.device_time for e in gemm) / 1e3 / steps
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.device_time / 1e3 / steps
    print(f"profile over {steps} steps: wall {wall_ms:.3f} ms/step, host enqueue "
          f"{enqueue_ms:.3f} ms/step, device kernels {dev_ms:.3f} ms/step in "
          f"{len(kernels) / steps:.1f} kernels, of which GEMM kernels {gemm_ms:.3f} ms/step "
          f"in {len(gemm) / steps:.1f}; device idle share {1 - dev_ms / wall_ms:.3f} "
          f"(set-up of the trace {1e3 * (t1 - t0):.0f} ms, outside)")
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:.4f} ms/step  {name[:110]}")


def count_kernels(fn, which=None) -> int:
    """Device kernels that one call of fn() launches (torch.profiler); with
    `which`, those whose name it accepts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and (which is None or which(e.name)))


def crc_gemm_kernels(link, lanes: int) -> int:
    """The most library GEMM kernels one of a coded link's CRC products
    launches: CRC-24A over (lanes, n) and, segmented, CRC-24B over
    (lanes, blocks, K - 24)."""
    from ofdm_lte_tpu_torch.coding import crc
    dev = link.device
    bits = torch.randint(0, 2, (lanes, link.tb_bits), device=dev, dtype=torch.int32)
    calls = [lambda: crc.crc_torch(bits, M=link.crc_tb)]
    if link.segmented:
        for K, n in link.groups:
            body = torch.randint(0, 2, (lanes, n, K - 24), device=dev, dtype=torch.int32)
            M = getattr(link, f"crc_body_{K}")
            calls.append(lambda body=body, M=M: crc.crc_torch(body, crc.CRC24B_POLY, 24, M=M))
    return max(count_kernels(fn, is_library_gemm) for fn in calls)


def bound_ms(kernel: str, M: int, K: int, N: int):
    """(ms, which) — the least time the card could take: every plane of A and
    B read once (and the CUDA-core Gauss kernel's `bsum` plane) and C written
    once, against the operations at their peak: fp32 CUDA cores for `ffma`;
    on the tensor cores three TF32 products per fp32 product at `highest`,
    one at `high`, one bf16 product at `default`. The planes are fp32 in
    device memory at every precision."""
    planes = 2 * M * K + 2 * K * N + 2 * M * N + (K * N if kernel == "f32_gauss" else 0)
    t_bytes = 4 * planes / HBM_BYTES_PER_S
    flops = (6 if GAUSS[kernel] else 8) * M * K * N
    if not TENSOR_CORE[kernel]:
        t_ops = flops / PEAK_FLOPS["fp32"]
    elif PRECISION[kernel] == "default":
        t_ops = flops / PEAK_FLOPS["bf16"]
    else:
        t_ops = (3 if PRECISION[kernel] == "highest" else 1) * flops / PEAK_FLOPS["tf32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


@contextlib.contextmanager
def precision_knobs(precision: str, form=None):
    """Within the block the complex GEMMs run at `precision`
    (OFDM_LTE_TPU_TORCH_MATMUL_PRECISION) and, where `form` is given, in that
    form (OFDM_LTE_TPU_TORCH_CMATMUL: fma4 or gauss); both knobs are what they
    were when the block ends."""
    knobs = {"OFDM_LTE_TPU_TORCH_MATMUL_PRECISION": precision}
    if form is not None:
        knobs["OFDM_LTE_TPU_TORCH_CMATMUL"] = form
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def draw_errors(kernels, seeds: int, card: str, dev) -> dict:
    """Each kernel of `kernels` (at its own precision) against its plain
    version at the flagship's TX and RX data GEMMs (20 MHz 64-QAM, 256 lanes
    of 14 symbols: K = 999 and 2048, the largest K of any path; the modem's own
    tables and signals), each of `seeds` draws of the bits a seed. Prints the
    largest max|d|/max|C| of each (GEMM, kernel) beside its tolerance and
    returns them."""
    from ofdm_lte_tpu_torch.config import LTEConfig
    from ofdm_lte_tpu_torch.ops import cmatmul as cm
    from ofdm_lte_tpu_torch.ops import ofdm, qam
    from ofdm_lte_tpu_torch.sim import siso
    cfg = LTEConfig(20.0, modulation="64-QAM")
    link = siso.SisoLink(cfg, device=dev)
    gen = torch.Generator(device=dev)
    errs = {(name, kernel): [] for name in ("tx", "rx_data") for kernel in kernels}
    shapes = {}
    for seed in range(seeds):
        gen.manual_seed(100 + seed)
        bits = torch.randint(0, 2, (256, siso.bits_per_frame(cfg, 14)), generator=gen,
                             device=dev, dtype=torch.int8)
        y = ofdm.frame_stream(link.transmit(bits), cfg)
        gemms = {"tx": (qam.modulate(bits, cfg.modulation).reshape(256, 14, -1),
                        link.mod_tables.b),
                 "rx_data": (y[..., cfg.cp_length:], link.rx_tables.data.g)}
        for name, (a, b) in gemms.items():
            shapes[name] = (a.re.numel() // a.shape[-1], a.shape[-1], b.re.shape[1])
            for kernel in kernels:
                with precision_knobs(PRECISION[kernel]):
                    out = cm.cmatmul(a, b, gauss=GAUSS[kernel])
                ref = cm.PLAIN[kernel](a, b)
                scale = max(ref.re.abs().max().item(), ref.im.abs().max().item())
                errs[name, kernel].append(max((out.re - ref.re).abs().max().item(),
                                              (out.im - ref.im).abs().max().item()) / scale)
    for (name, kernel), e in errs.items():
        M, K, N = shapes[name]
        print(f"[{card}] {name} ({M}x{K})@({K}x{N}) {kernel} vs plain over {seeds} draws of "
              f"bits: max {max(e):.3e}, mean {sum(e) / len(e):.3e}, tolerance "
              f"{TOL[kernel]:.0e}, margin {TOL[kernel] / max(e):.2f}x "
              f"({', '.join(f'{x:.3e}' for x in e)})")
    return {key: max(e) for key, e in errs.items()}


# phase 9 (d): the kernels that torch.matmul runs for the library calls,
# traced in a fresh interpreter on the card
LIBRARY_PROBE = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
M, K, N = map(int, sys.argv[1:4])
g = torch.Generator(device="cuda").manual_seed(0)
a = torch.randn((M, K), dtype=torch.complex64, device="cuda", generator=g)
b = torch.randn((K, N), dtype=torch.complex64, device="cuda", generator=g)
r = [x.to(torch.bfloat16) for x in (a.real, a.imag, b.real, b.imag)]


def names(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


out = {"complex64 at highest": names(lambda: a @ b)}
torch.backends.cuda.matmul.allow_tf32 = True
out["complex64 at high (allow_tf32)"] = names(lambda: a @ b)
torch.set_float32_matmul_precision("medium")
out["complex64 at default"] = names(lambda: a @ b)
out["four real bf16 products"] = names(
    lambda: [r[i] @ r[j] for i, j in ((0, 2), (1, 3), (0, 3), (1, 2))])
kp, np_ = -(-K // 8) * 8, -(-N // 8) * 8
ab = torch.zeros((M, 2 * kp), dtype=torch.bfloat16, device="cuda")
bb = torch.zeros((2 * kp, 2 * np_), dtype=torch.bfloat16, device="cuda")
out["one bf16 product of the real block form"] = names(lambda: ab @ bb)
print(json.dumps(out))
"""


def bf16_stand_ins(a, b) -> dict:
    """The library's bf16 products of a (M, K) @ b (K, N), bf16 out, their
    operands made here, outside any timed window: four real products of the
    rounded planes (library_four), and one product of the real block form
    [Ar | Ai] (M, 2K') @ [[Br, Bi], [-Bi, Br]] (2K', 2N') with K and N padded
    to K', N', multiples of 8, with zeros (library_block), which cuBLAS can
    run on its aligned kernels."""
    (M, K), N = a.re.shape, b.re.shape[1]
    kp, np_ = -(-K // 8) * 8, -(-N // 8) * 8
    r = [x.to(torch.bfloat16) for x in (a.re, a.im, b.re, b.im)]
    ab = torch.zeros((M, 2 * kp), dtype=torch.bfloat16, device=a.re.device)
    ab[:, :K], ab[:, kp:kp + K] = r[0], r[1]
    bb = torch.zeros((2 * kp, 2 * np_), dtype=torch.bfloat16, device=a.re.device)
    bb[:K, :N], bb[:K, np_:np_ + N] = r[2], r[3]
    bb[kp:kp + K, :N], bb[kp:kp + K, np_:np_ + N] = -r[3], r[2]
    return {"library_four": lambda: [r[i] @ r[j] for i, j in ((0, 2), (1, 3), (0, 3), (1, 2))],
            "library_block": lambda: ab @ bb}


def library_kernel_names(M: int, K: int, N: int) -> dict:
    """The device kernels of each library call at (M, K) @ (K, N), by setting."""
    run = subprocess.run([sys.executable, "-c", LIBRARY_PROBE, str(M), str(K), str(N)],
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        raise RuntimeError(f"the library probe failed:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def kernel_registers(log: str, pattern: str, label) -> str:
    """Registers and spill of each instantiation of a kernel whose mangled name
    matches `pattern`, from nvcc's -Xptxas -v log; label(match) names one."""
    import re
    lines, found = log.splitlines(), []
    for i, line in enumerate(lines):
        m = re.search(pattern, line)
        if "Compiling entry function" in line and m:
            info = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                            if "Used" in x or "spill" in x)
            found.append(f"{label(m)}: {info}")
    return "; ".join(found) or "not in the build log"


def bcjr_registers(log: str) -> str:
    """turbo_bcjr's instantiations: max-log or log-MAP, mode 0 APP, 1
    extrinsic, 2 hard."""
    return kernel_registers(log, r"bcjr_kernelILb([01])ELi([0-2])E",
                            lambda m: f"{'max-log' if m[1] == '1' else 'log-MAP'} mode {m[2]}")


# the wgmma kernels of each precision: their source and their name in the build log
WGMMA_SOURCES = {"high": ("cmatmul_wgmma_tf32.cu", "cmatmul_wgmma_tf32_kernel"),
                 "default": ("cmatmul_bf16.cu", "cmatmul_wgmma_bf16_kernel")}


def wgmma_registers(log: str, precision: str) -> str:
    """The two instantiations, 4-dot and Gauss, of the wgmma kernel of
    `precision` (`high` or `default`)."""
    return kernel_registers(log, WGMMA_SOURCES[precision][1] + r"ILb([01])E",
                            lambda m: "gauss" if m[1] == "1" else "4-dot")


def profile_targets() -> set:
    """The paths named after --profile (comma-separated), "main" when none
    is, the empty set without the flag."""
    args = sys.argv[1:]
    if "--profile" not in args:
        return set()
    rest = args[args.index("--profile") + 1:]
    names = set(rest[0].split(",")) if rest else {"main"}
    for name in names:
        if name != "main" and name not in PATHS:
            raise SystemExit(f"--profile {name}: pick from main, {', '.join(PATHS)}")
    return names


def coding_front_on_card(rng, dev, cfg) -> None:
    """CRC, rate matching and de-matching, and max-log LLRs on the card
    against the CPU on the same inputs: equal bits, LLRs within 1e-6 of
    max|LLR| over a frame of `cfg`. Raises on any difference."""
    from ofdm_lte_tpu_torch.coding import crc, rate_matching
    from ofdm_lte_tpu_torch.cplx import C
    from ofdm_lte_tpu_torch.grid import grid_for
    from ofdm_lte_tpu_torch.ops import qam
    bits = torch.as_tensor(rng.integers(0, 2, (64, 6144)).astype(np.int32))
    for poly, nbits in ((crc.CRC24A_POLY, 24), (crc.CRC24B_POLY, 24), (crc.CRC16_POLY, 16)):
        on_card = crc.crc_torch(bits.to(dev), poly, nbits)
        host = np.stack([crc.crc_bits(b, poly, nbits) for b in bits[:4].numpy()])
        if not torch.equal(on_card.cpu(), crc.crc_torch(bits, poly, nbits)) \
                or not np.array_equal(on_card[:4].cpu().numpy(), host):
            raise AssertionError(f"crc_torch {poly:#x}: the card disagrees")
    checked = 0
    for K in (40, 6144):
        N_cb = 3 * (K + 6)
        for E in (N_cb // 3, N_cb - 5, N_cb + 7, 2 * N_cb + 101):
            for rv in range(4):
                enc = torch.as_tensor(rng.integers(0, 2, (16, 3 * K + 12)).astype(np.int32))
                llr = torch.as_tensor((rng.standard_normal((16, E)) * 4).astype(np.float32))
                if not torch.equal(rate_matching.rate_match(enc.to(dev), E, K, rv).cpu(),
                                   rate_matching.rate_match(enc, E, K, rv)) \
                        or not torch.equal(rate_matching.rate_dematch(llr.to(dev), K, rv).cpu(),
                                           rate_matching.rate_dematch(llr, K, rv)):
                    raise AssertionError(f"rate matching K={K} E={E} rv={rv}: the card disagrees")
                checked += 1
    n_sym = SYMBOLS * grid_for(cfg).num_data    # the data bins of a frame
    y = C(torch.as_tensor(rng.standard_normal((LANES, n_sym)).astype(np.float32) * 0.7),
          torch.as_tensor(rng.standard_normal((LANES, n_sym)).astype(np.float32) * 0.7))
    worst = 0.0
    for nv in (0.02, torch.as_tensor(rng.uniform(0.01, 0.3, (LANES, n_sym)).astype(np.float32))):
        on_cpu = qam.llrs(y, nv, cfg.modulation)
        on_card = qam.llrs(C(y.re.to(dev), y.im.to(dev)),
                           nv.to(dev) if isinstance(nv, torch.Tensor) else nv, cfg.modulation)
        rel = (on_card.cpu() - on_cpu).abs().max().item() / on_cpu.abs().max().item()
        worst = max(worst, rel)
        if on_card.shape != (LANES, n_sym * cfg.bits_per_symbol) or rel > 1e-6:
            raise AssertionError(f"llrs: the card differs by {rel:.2e} of max|LLR|")
    print(f"coding front end on the card vs the CPU: CRC-24A/24B/16 of 64 x 6144 bits equal; "
          f"rate_match and rate_dematch equal in {checked} (K, E, rv) cases; llrs of "
          f"{LANES} x {n_sym} 64-QAM symbols within {worst:.2e} of max|LLR|")


def coded_on_card(rng, dev) -> None:
    """The batched coded chain with HARQ on the card against the CPU under
    the same noise, 5 MHz QPSK, 4 lanes at -1, 1, 3 and 30 dB, a 1,000-bit
    (one block, 8 iterations) and a 12,000-bit transport block (K 6016 and
    6080, 2 iterations): equal bits, CRC outcomes by stage and transmissions.
    Raises on any difference."""
    from ofdm_lte_tpu_torch import LTEConfig
    from ofdm_lte_tpu_torch.grid import grid_for
    from ofdm_lte_tpu_torch.ops import bcjr
    from ofdm_lte_tpu_torch.sim import coded
    cfg = LTEConfig(5.0, modulation="QPSK")
    snr = torch.tensor([-1.0, 1.0, 3.0, 30.0])
    for n, iterations in ((1000, 8), (12000, 2)):
        link = coded.CodedLink(cfg, n, device=dev)
        n_sym = -(-link.coded_len // cfg.bits_per_symbol)
        samples = -(-n_sym // grid_for(cfg).num_data) * cfg.samples_per_ofdm_symbol
        noise = (rng.standard_normal((4, 4, samples)), rng.standard_normal((4, 4, samples)))
        bits = torch.as_tensor(rng.integers(0, 2, (4, n)).astype(np.int32))
        before = bcjr.bcjr_half.launches
        on_card = link.harq(bits, snr, num_iterations=iterations, draws={"noise": noise})
        launched = bcjr.bcjr_half.launches - before
        on_cpu = coded.CodedLink(cfg, n, device="cpu").harq(
            bits, snr, num_iterations=iterations, draws={"noise": noise})
        same = [torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f))
                for f in ("bits_rx", "crc_pass", "crc_pass_stage", "num_transmissions")]
        print(f"coded HARQ cuda vs cpu, same draws, 5 MHz QPSK, {n} bits ({len(link.groups)} "
              f"block sizes), {iterations} iterations, lanes at {snr.tolist()} dB: bits, "
              f"crc_pass, crc_pass_stage, num_transmissions equal {same}; transmissions "
              f"{on_card.num_transmissions.tolist()}, {launched} BCJR launches")
        if not all(same) or not on_card.bits_rx.is_cuda \
                or launched != 4 * (2 * iterations + 1) * len(link.groups):
            raise AssertionError(f"coded {n}: the card disagrees with the CPU")


def cli_on_card(card: str, zero_counts) -> tuple:
    """Phase 7: the port's command-line interface, in-process (cli.main) with
    no --device, so on the card, at 20 MHz 64-QAM unless a command's own
    defaults say otherwise. Each command runs with the kernel counts set to
    0 just before it and read just after; returns ({command: tf32x3
    launches}, {command: turbo_bcjr launches}) and raises on any failed
    check. The CPU runs it is compared with (info, papr) launch nothing."""
    from ofdm_lte_tpu_torch import LTEConfig, cli
    from ofdm_lte_tpu_torch._build import BUILD_DIR
    from ofdm_lte_tpu_torch.coding import segmentation
    from ofdm_lte_tpu_torch.device import resolve_device
    from ofdm_lte_tpu_torch.ops import bcjr
    from ofdm_lte_tpu_torch.ops.cmatmul import cmatmul
    from ofdm_lte_tpu_torch.sim import siso

    gemms, passes = {}, {}
    wide = ["--bandwidth", "20", "--modulation", "64-QAM"]

    def capture(argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return buf.getvalue()

    def run(name, call):
        zero_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gemms[name] = cmatmul.launches_by_kernel["tf32x3"]
        passes[name] = bcjr.bcjr_half.launches
        print(f"[{card}] cli {name}: {wall:.3f} s wall, launches tf32x3 {gemms[name]}, "
              f"turbo_bcjr {passes[name]}")
        return out

    # info: the numerology, as printed on the CPU
    info = run("info", lambda: capture(["info"] + wide))
    if info != capture(["info", "--device", "cpu"] + wide) or "Data Subcarriers: 999" not in info:
        raise AssertionError(f"cli info on the card differs from the CPU's:\n{info}")

    # run: each pipeline at 60 dB, one 14-symbol frame of bits, 2x2 where
    # antennas apply, spatial rank 2 MMSE; every link is clean over AWGN there
    n = siso.bits_per_frame(LTEConfig(20.0, modulation="64-QAM"), SYMBOLS)
    decodes = len(set(segmentation.segment_layout(n + 24)["sizes"]))
    for pipeline, per_run in CLI_RUN_GEMMS.items():
        name = f"run/{pipeline}"
        res = json.loads(run(name, lambda: capture(
            ["run", "--snr", "60", "--num-bits", str(n), "--pipeline", pipeline, "--num-tx", "2",
             "--num-rx", "2", "--rank", "2", "--detector", "MMSE"] + wide)))
        coded = pipeline in ("siso-coded", "harq")
        print(f"cli {name}, {n} bits at 60 dB: ber {res['ber']}, bit errors {res['bit_errors']}"
              + (f", crc_pass {res['crc_pass']}" if coded else ""))
        if res["ber"] != 0.0 or res["transmitted_bits"] != n or gemms[name] != per_run \
                or passes[name] != (17 * decodes if coded else 0):
            raise AssertionError(f"cli {name}: {res}, launches {gemms[name]} GEMM + "
                                 f"{passes[name]} BCJR (expected {per_run} + "
                                 f"{17 * decodes if coded else 0})")

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # sweep: the main path's configuration, 256 frames a point, twice
        # into one checkpoint: the second run resumes and banks a new round
        ckpt = os.path.join(tmp, "sweep.json")
        argv = ["sweep", "--snr-min", "15", "--snr-max", "60", "--snr-step", "45", "--frames",
                str(LANES), "--num-symbols", str(SYMBOLS), "--checkpoint", ckpt] + wide
        for name in ("sweep", "sweep-resumed"):
            res = json.loads(run(name, lambda: capture(argv)))
            with open(ckpt) as f:
                state = json.load(f)
            print(f"cli {name}: snr {res['snr_db']} ber {res['ber']} total bits "
                  f"{res['total_bits']} rounds {state['rounds']} (round BERs "
                  f"{state['round_bers']})")
            rounds = 1 if name == "sweep" else 2
            if res["snr_db"] != [15.0, 60.0] or not BER_15DB[0] <= res["ber"][0] <= BER_15DB[1] \
                    or res["ber"][1] != 0.0 or state["rounds"] != rounds \
                    or res["total_bits"] != [rounds * LANES * n] * 2 or gemms[name] != 3:
                raise AssertionError(f"cli {name}: {res}, {state['rounds']} rounds, "
                                     f"launches {gemms[name]}")
        if state["round_bers"][0] == state["round_bers"][1]:
            raise AssertionError("cli sweep: the resumed round redrew the banked one")

    # the HARQ sweep: the 75,376-bit path's transport block at its working
    # SNR and clean point, 256 transport blocks a point
    harq = PATHS["harq_75376_awgn"]
    res = json.loads(run("sweep-harq", lambda: capture(
        ["sweep", "--pipeline", "harq", "--tb-bits", str(harq["kw"]["tb_bits"]), "--snr-min",
         "16.2", "--snr-max", "30", "--snr-step", "13.8", "--frames", str(LANES)] + wide)))
    ref = JAX_BER["harq_75376_awgn"]["bler"]
    bands = [bler_band(p, LANES, JAX_BER["harq_75376_awgn"]["lanes"]) for p in ref]
    print(f"cli sweep-harq: snr {res['snr_db']} bler {res['bler']} by stage "
          f"{res['bler_per_stage']} (JAX at 16.2 dB {ref}, bands "
          f"{[(round(float(a), 4), round(float(b), 4)) for a, b in bands]}) avg transmissions "
          f"{res['avg_transmissions']} TBs a point {res['tbs_per_point']}")
    stages = res["bler_per_stage"][0]
    if res["snr_db"] != [16.2, 30.0] or res["bler"][1] != 0.0 or res["ber"][1] != 0.0 \
            or any(res["bler_per_stage"][1]) or res["tbs_per_point"] != LANES \
            or not all(a <= p <= b for p, (a, b) in zip(stages, bands)) \
            or (gemms["sweep-harq"], passes["sweep-harq"]) != (3 * 4, 17 * 4):
        raise AssertionError(f"cli sweep-harq: {res}, launches {gemms['sweep-harq']} GEMM + "
                             f"{passes['sweep-harq']} BCJR")

    # fullsweep: 64-QAM over 1 and 2 RX, SISO then SIMO, one call each
    res = json.loads(run("fullsweep", lambda: capture(
        ["fullsweep", "--bandwidth", "20", "--modulations", "64-QAM", "--rx-list", "1,2",
         "--snr-min", "0", "--snr-max", "60", "--snr-step", "30", "--iterations", "64"])))
    print(f"cli fullsweep: {[(k, c['ber']) for k, c in res['curves'].items()]}, frames a point "
          f"{res['frames_per_point']}")
    if list(res["curves"]) != ["64-QAM/1rx", "64-QAM/2rx"] or gemms["fullsweep"] != 6 \
            or any(c["ber"][-1] != 0.0 or c["snr_db"] != [0.0, 30.0, 60.0]
                   for c in res["curves"].values()):
        raise AssertionError(f"cli fullsweep: {res}")

    # the image workflow through its array part: a seeded 128x128x3 image,
    # SISO at 60 dB, comes back as it went
    args = cli.build_parser().parse_args(["image", "--input", "unused", "--snr", "60"] + wide)
    args.device = resolve_device(args.device)
    original = np.random.default_rng(7).integers(0, 256, (128, 128, 3), dtype=np.uint8)
    received, res = run("image", lambda: cli.transmit_image(cli._mk_sim(args), original,
                                                             "siso", 60.0, args))
    print(f"cli image 128x128x3 through siso at 60 dB: ber {res['ber']} psnr {res['psnr_db']} "
          f"ssim {res['ssim']}")
    if not np.array_equal(received, original) or res["psnr_db"] != float("inf") \
            or res["ssim"] != 1.0 or gemms["image"] != 3:
        raise AssertionError(f"cli image: {res}")

    # bfcompare at its defaults: 12 rows; the SFBC rows in the JAX band
    res = json.loads(run("bfcompare", lambda: capture(["bfcompare"])))
    rows = res["rows"]
    for row in rows:
        if row["kind"] == "sfbc":
            lo, hi = ber_band(JAX_BFCOMPARE_SFBC_BER[row["num_rx"]], 1)
            print(f"cli bfcompare {row['name']}: ber {row['ber']:.6g} (JAX "
                  f"{JAX_BFCOMPARE_SFBC_BER[row['num_rx']]['mean']:.6g}, band [{lo:.6g}, "
                  f"{hi:.6g}]; published {row['published_ber']:.4e})")
            if not lo <= row["ber"] <= hi:
                raise AssertionError(f"cli bfcompare {row['name']}: BER {row['ber']} outside "
                                     f"the JAX band [{lo}, {hi}]")
            continue
        print(f"cli bfcompare {row['name']}: ber {row['ber']:.6g}, spread [{row['ber_min']:.4e}, "
              f"{row['ber_max']:.4e}] over 16 channels, published "
              f"{row['published_ber']:.4e}, in spread {row['published_in_spread']}, gain "
              f"{row['gain_db']:.3f} dB")
        if not (row["ber_min"] <= row["ber"] <= row["ber_max"] and np.isfinite(row["gain_db"])):
            raise AssertionError(f"cli bfcompare {row['name']}: {row}")
    if len(rows) != 12 or gemms["bfcompare"] != 3 * 3:
        raise AssertionError(f"cli bfcompare: {len(rows)} rows, {gemms['bfcompare']} GEMMs")

    # papr: the card's CCDF summary against the CPU's on the same bits
    argv = ["papr", "--bandwidth", "20", "--num-symbols", "200"]
    card_res = json.loads(run("papr", lambda: capture(argv)))
    cpu_res = json.loads(capture(argv + ["--device", "cpu"]))
    worst = max(abs(card_res[k][m] - v) for k, row in cpu_res.items() for m, v in row.items())
    print(f"cli papr: {card_res}; max |card - cpu| {worst:.2e} dB")
    if list(card_res) != list(cpu_res) or worst > 1e-3 or gemms["papr"] != 2 * (1 + 2):
        raise AssertionError(f"cli papr: {card_res} against the CPU's {cpu_res}")

    if not sum(gemms.values()) or not sum(passes.values()):
        raise AssertionError(f"cli phase: launches {gemms} GEMM, {passes} BCJR")
    return gemms, {k: v for k, v in passes.items() if v}


def host_ms(fn, reps: int) -> float:
    """Mean host-clock time of fn() over reps runs after one warm-up run."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def native_on_host(card: str) -> None:
    """Phase 8 (a): the native bit library, built from native/bitops.cc into
    build/, against its plain versions on a 75,376-bit transport block: its
    CRC-24A and the CRC-24B of its 13 code blocks against crc_bits_plain,
    pack, unpack and bit_errors against NumPy; equal bits, host times."""
    from ofdm_lte_tpu_torch import native_ext
    from ofdm_lte_tpu_torch.coding import crc, segmentation
    t0 = time.perf_counter()
    path = native_ext.build()
    native_ext.library()
    print(f"native: {path.name} in {time.perf_counter() - t0:.2f} s")
    tb = np.random.default_rng(12).integers(0, 2, PATHS["harq_75376_awgn"]["kw"]["tb_bits"],
                                           dtype=np.uint8)
    blocks, _ = segmentation.segment_code_blocks(crc.attach_crc24a(tb))
    bodies = [b[:-24] for b in blocks]
    if len(bodies) != 13 or not all(np.array_equal(crc.crc_bits(b, crc.CRC24B_POLY, 24),
                                                   blk[-24:]) for b, blk in zip(bodies, blocks)):
        raise AssertionError(f"segmentation gave {len(bodies)} blocks or a wrong CRC-24B")
    packed = np.packbits(tb)
    checks = {
        "crc24a": (lambda: crc.crc_bits(tb, crc.CRC24A_POLY, 24),
                   lambda: crc.crc_bits_plain(tb, crc.CRC24A_POLY, 24)),
        f"crc24b of {len(bodies)} code blocks": (
            lambda: np.stack([crc.crc_bits(b, crc.CRC24B_POLY, 24) for b in bodies]),
            lambda: np.stack([crc.crc_bits_plain(b, crc.CRC24B_POLY, 24) for b in bodies])),
        "pack_bits": (lambda: native_ext.pack_bits(tb), lambda: np.packbits(tb)),
        "unpack_bits": (lambda: native_ext.unpack_bits(packed, len(tb)),
                        lambda: np.unpackbits(packed)[:len(tb)]),
        "bit_errors": (lambda: native_ext.bit_errors(tb, tb[::-1]),
                       lambda: int(np.count_nonzero(tb != tb[::-1]))),
    }
    for name, (native, plain) in checks.items():
        if not np.array_equal(native(), plain()):
            raise AssertionError(f"native {name} differs from its plain version")
        print(f"[{card}] native {name}, {len(tb)} bits: {host_ms(native, 20):.4f} ms on the "
              f"host, plain {host_ms(plain, 3):.4f} ms, equal")


def multiprocess_on_card(card: str, zero_counts, main_ms: float) -> tuple:
    """Phase 8 (b)-(g): the HBM stream, the N-process sweeps over
    torch.distributed (a world-1 NCCL group in this process; two fresh
    interpreters in a gloo group sharing the card), the dry run, the
    scaling measurement and the flagship step against the cost model.
    Returns ({path: tf32x3 launches}, {path: turbo_bcjr launches}); raises
    on any failed check."""
    import socket
    import torch.distributed as dist
    from ofdm_lte_tpu_torch import LTEConfig
    from ofdm_lte_tpu_torch.parallel import distributed, mp_bench
    from ofdm_lte_tpu_torch.sim import siso
    from ofdm_lte_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    cfg = LTEConfig(20.0, modulation="64-QAM")
    n_bits = siso.bits_per_frame(cfg, SYMBOLS)
    gemms, passes = {}, {}
    t_phase = time.perf_counter()

    # (b) the HBM stream: one 2 GiB device-to-device copy, read and write
    src = torch.empty(2 ** 29, device=dev)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), 10)
    rate = 2 * src.numel() * 4 / (ms / 1e3)
    print(f"[{card}] HBM stream: copy_ of 2 GiB {ms:.4f} ms, {rate / 1e12:.4f} TB/s read and "
          f"written; utils.profiling CEILINGS hbm {profiling.CEILINGS['hbm'] / 1e12:.4f} TB/s, "
          f"DATASHEET {profiling.DATASHEET['hbm'] / 1e12:.4f}")
    del src, dst
    torch.cuda.empty_cache()

    wide = {"bandwidth": 20.0, "modulation": "64-QAM", "symbols": SYMBOLS, "pipeline": "siso"}

    def bers_in_band(res):
        """(ok, BERs): the first point in the flagship's 15 dB band, the
        last 0."""
        ber = [e / t for e, t in zip(res["bit_errors"], res["total_bits"])]
        return ber[-1] == 0.0 and BER_15DB[0] <= ber[0] <= BER_15DB[1], ber

    # (c) a world-1 NCCL group in this process: the flagship sweep with its
    # counts reduced on the card, equal to the one-device sweep under the
    # same bits and seams, and drawn under the same generator seed
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0, "nccl", retries=1, timeout_s=120)
    try:
        lay = distributed.layout(1, dev)
        for name, seams in (("flagship_seams", True), ("flagship", False)):
            case = {**wide, "snr": [15.0, 60.0], "frames": LANES, "seed": 31, "seams": seams}
            zero_counts()
            nccl = mp_bench.run_case(case, lay)
            gemms[f"nccl1/{name}"] = nccl.pop("launches")["tf32x3"]
            one = mp_bench.run_case(case, None, dev)
            ok, ber = bers_in_band(nccl)
            print(f"[{card}] world-1 {dist.get_backend()} group, {name} at 15 and 60 dB x "
                  f"{LANES} frames: BER {ber}, counts reduced on the card {nccl['bit_errors']}, "
                  f"one-device sweep {one['bit_errors']}, launches {gemms[f'nccl1/{name}']}")
            if dist.get_backend() != "nccl" or nccl != one or not ok \
                    or gemms[f"nccl1/{name}"] != 3:
                raise AssertionError(f"world-1 NCCL {name}: {nccl} against {one}")
    finally:
        distributed.shutdown()
    torch.cuda.empty_cache()

    # (d) two fresh interpreters in one gloo group, both ranks on cuda:0
    harq = PATHS["harq_75376_awgn"]
    cases = {
        "flagship": {**wide, "snr": [15.0, 60.0], "frames": LANES // 2, "seed": 41,
                     "seams": False},
        "flagship_seams": {**wide, "snr": [15.0, 60.0], "frames": LANES // 2, "seed": 42},
        "flagship_2d": {**wide, "snr": [15.0, 30.0, 60.0], "frames": LANES // 2, "seed": 43,
                        "shards": 2},
        "harq_75376": {"bandwidth": 20.0, "modulation": "64-QAM", "pipeline": "harq",
                       "snr": [harq["snr"], CODED_CLEAN_SNR], "frames": LANES // 2,
                       "tb_bits": harq["kw"]["tb_bits"], "rv": list(harq["kw"]["rv_sequence"]),
                       "seed": 44, "seams": False},
    }
    cli_argv = ["sweep", "--bandwidth", "20", "--modulation", "64-QAM", "--snr-min", "15",
                "--snr-max", "60", "--snr-step", "45", "--frames", str(LANES),
                "--num-symbols", str(SYMBOLS), "--snr-shards", "2"]
    names = list(cases) + ["cli_sweep_2shards"]
    jobs = [{"job": "case", "case": c} for c in cases.values()] + [{"job": "cli",
                                                                   "argv": cli_argv}]
    t0 = time.perf_counter()
    ranks = mp_bench.spawn(2, jobs, "cuda:0", timeout_s=600)
    print(f"[{card}] 2 processes on cuda:0 (gloo): {len(jobs)} jobs in "
          f"{time.perf_counter() - t0:.2f} s wall, start-up included")
    for rank, results in enumerate(ranks):
        for name, res in zip(names, results):
            gemms[f"mp2/{name}/rank{rank}"] = res["launches"]["tf32x3"]
            if res["launches"]["turbo_bcjr"]:
                passes[f"mp2/{name}/rank{rank}"] = res["launches"]["turbo_bcjr"]
    for i, (name, case) in enumerate(cases.items()):
        r0, r1 = ({k: v for k, v in ranks[r][i].items() if k not in ("launches", "share")}
                  for r in (0, 1))
        mc = 1 if case.get("shards") == 2 else 2
        if r0 != r1 or r0["snr_db"] != np.float32(case["snr"]).tolist() \
                or r0["frames"] != case["frames"] * mc:
            raise AssertionError(f"2 processes, {name}: rank 0 {r0}, rank 1 {r1}")
        launched = ranks[0][i]["launches"]
        if name == "harq_75376":
            F = r0["frames"]
            stages = [f / F for f in r0["stage_failures"][0]]
            ref = JAX_BER["harq_75376_awgn"]["bler"]
            bands = [bler_band(p, F, JAX_BER["harq_75376_awgn"]["lanes"]) for p in ref]
            print(f"[{card}] 2 processes, {name}: BLER by stage at {harq['snr']} dB {stages} "
                  f"(JAX {ref}), failures at {CODED_CLEAN_SNR} dB {r0['stage_failures'][1]}, "
                  f"{F} TBs a point, launches a rank {launched}")
            if not all(a <= p <= b for p, (a, b) in zip(stages, bands)) \
                    or any(r0["stage_failures"][1]) or r0["bit_errors"][1] \
                    or launched != {"tf32x3": 12, "turbo_bcjr": 68}:
                raise AssertionError(f"2 processes, {name}: {r0}, launches {launched}")
        elif case.get("seams", True):
            # exact against each rank's lanes run as one one-device sweep; the
            # sweep of all lanes in one call sums its GEMMs in another order
            # (the kernels' split-K follows M), so decisions on the boundary
            # may differ: held to MAX_SPLIT_ORDER_FLIPS of the bits
            shares = mp_bench.sum_of_shares([ranks[0][i], ranks[1][i]], "bit_errors",
                                            len(case["snr"]))
            one = mp_bench.run_case({**case, "frames": case["frames"] * mc}, None, dev)
            flips = max(abs(a - b) / t for a, b, t in zip(r0["bit_errors"], one["bit_errors"],
                                                         one["total_bits"]))
            print(f"[{card}] 2 processes, {name}: counts {r0['bit_errors']} over "
                  f"{r0['frames']} frames a point, the ranks' shares one-device {shares}, all "
                  f"lanes in one one-device call {one['bit_errors']} ({flips:.3g} of the bits "
                  f"apart)")
            if r0["bit_errors"] != shares or flips > MAX_SPLIT_ORDER_FLIPS \
                    or any(r0[k] != one[k] for k in ("total_bits", "snr_db", "frames")) \
                    or launched["tf32x3"] != 3:
                raise AssertionError(f"2 processes, {name}: {r0} against {shares} and {one}")
        else:
            ok, ber = bers_in_band(r0)
            print(f"[{card}] 2 processes, {name}: BER {ber} over {r0['frames']} frames a point")
            if not ok or launched["tf32x3"] != 3:
                raise AssertionError(f"2 processes, {name}: BER {ber} outside 0 / {BER_15DB}")
    out0, out1 = (ranks[r][-1]["stdout"] for r in (0, 1))
    res = json.loads(out0)
    print(f"[{card}] 2 processes, cli sweep --snr-shards 2: snr {res['snr_db']} ber {res['ber']} "
          f"total bits {res['total_bits']}; rank 1 printed {len(out1)} characters")
    if out1 or res["snr_db"] != [15.0, 60.0] or res["total_bits"] != [LANES * n_bits] * 2 \
            or not BER_15DB[0] <= res["ber"][0] <= BER_15DB[1] or res["ber"][1] != 0.0:
        raise AssertionError(f"cli sweep --snr-shards 2: {res}, rank 1 {out1!r}")

    # (e) the JAX package's multi-chip dry run over two processes
    t0 = time.perf_counter()
    dry = distributed.dryrun(2)
    print(f"[{card}] dryrun(2): {dry} in {time.perf_counter() - t0:.2f} s wall")

    # (f) frames/s at 1 and 2 processes sharing the card, LANES frames a
    # process a step: the device-bound flagship and the host-bound coded link
    for link in ("flagship", "coded_6000_awgn"):
        t0 = time.perf_counter()
        r = mp_bench.measure((1, 2), frames=LANES, n_steps=5, retries=1, link=link)
        print(f"[{card}] mp_bench {link}, {LANES} frames a process a step: 1 process "
              f"{r[1]['total']:.1f} frames/s; 2 processes {r[2]['total']:.1f} frames/s in all "
              f"({', '.join(f'{x:.1f}' for x in r[2]['rates'])}), a process "
              f"{r[2]['efficiency']:.4f} of 1 alone, in all {r[2]['total'] / r[1]['total']:.4f} "
              f"({time.perf_counter() - t0:.2f} s wall)")
        if not all(v["per_process"] > 0 for v in r.values()):
            raise AssertionError(f"mp_bench {link}: {r}")

    # (g) phase 6's untraced flagship step against the H100 cost model
    rep = profiling.roofline_report(cfg, SYMBOLS, LANES, main_ms / 1e3)
    print(f"[{card}] roofline of the flagship step {main_ms:.4f} ms: model "
          f"{1e3 * rep['roofline_s']:.4f} ms at the ceilings, fraction "
          f"{rep['roofline_fraction']:.4f} (data sheet "
          f"{rep['roofline_fraction_datasheet_peaks']:.4f}); {rep['modeled_gflops']:.2f} GFLOP, "
          f"{rep['modeled_gbytes']:.4f} GB; per stage (us) {rep['per_kernel_us']}")
    fractions = (rep["roofline_fraction"], rep["roofline_fraction_datasheet_peaks"],
                 rep["roofline_fraction_excl_floor"])
    if not all(0.0 < f <= 1.0 for f in fractions) or fractions[1] > fractions[0]:
        raise AssertionError(f"roofline fractions {fractions}")
    print(f"[{card}] phase 8: {time.perf_counter() - t_phase:.2f} s wall")
    return gemms, passes


def main() -> None:
    to_profile = profile_targets()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ofdm_lte_tpu_torch import LTEConfig, OFDMModule, OFDMSimulator, _build, cplx
    from ofdm_lte_tpu_torch.channel import mimo, rayleigh
    from ofdm_lte_tpu_torch.mimo import detector
    from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep, harq_sweep
    from ofdm_lte_tpu_torch.coding import crc, turbo
    from ofdm_lte_tpu_torch.cplx import C
    from ofdm_lte_tpu_torch.ops import bcjr, ofdm, qam
    from ofdm_lte_tpu_torch.ops.cmatmul import (PLAIN, _kernel_for, _ld, cmatmul, cmatmul_plain,
                                                cmatmul_plain_gauss_tf32x3,
                                                cmatmul_plain_tf32x3, default_variant,
                                                rounding_bound, wgmma_a_needs_copy,
                                                wgmma_workspace_floats)
    from ofdm_lte_tpu_torch.rx import alamouti
    from ofdm_lte_tpu_torch.rx.estimation import SLOT_SIZE
    from ofdm_lte_tpu_torch.sim import beamforming, coded, diversity, siso, spatial
    from ofdm_lte_tpu_torch.sim.links import clear_link_cache

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    print(_build.build_log.strip())

    dev = torch.device("cuda")
    cfg = LTEConfig(20.0, modulation="64-QAM")
    link = siso.SisoLink(cfg, device=dev)
    gen = torch.Generator(device=dev)
    n_bits = siso.bits_per_frame(cfg, SYMBOLS)

    def random_bits(lanes: int, seed: int, n: int = n_bits) -> torch.Tensor:
        gen.manual_seed(seed)
        return torch.randint(0, 2, (lanes, n), generator=gen, device=dev, dtype=torch.int8)

    def zero_counts() -> None:
        cmatmul.launches = cmatmul.copies = 0
        for k in cmatmul.launches_by_kernel:
            cmatmul.launches_by_kernel[k] = 0
        bcjr.bcjr_app.launches = bcjr.bcjr_half.launches = crc.crc_torch.launches = 0

    def path_link(name: str):
        spec = PATHS[name]
        if spec["kind"] == "siso":
            return siso.SisoLink(cfg, device=dev, **spec["kw"])
        if spec["kind"] == "spatial":
            return spatial.SpatialLink(cfg, device=dev, **spec["kw"])
        if spec["kind"] == "beamforming":
            return beamforming.BeamformingLink(cfg, device=dev, **spec["kw"])
        if spec["kind"] == "coded":
            return coded.CodedLink(cfg, spec["kw"]["tb_bits"], device=dev)
        cls = diversity.SimoLink if spec["kind"] == "simo" else diversity.SfbcLink
        kw = dict(spec["kw"])
        return cls(cfg, kw.pop("num_rx"), device=dev, **kw)

    def path_bits(name: str) -> int:
        spec = PATHS[name]
        if spec["kind"] == "sfbc":
            return diversity.sfbc_bits_per_frame(cfg, SYMBOLS)
        if spec["kind"] == "spatial":
            return spatial.bits_per_frame(cfg, SYMBOLS)
        if spec["kind"] == "beamforming":
            return beamforming.bits_per_frame(cfg, SYMBOLS)
        if spec["kind"] == "coded":
            return spec["kw"]["tb_bits"]
        return siso.bits_per_frame(cfg, SYMBOLS, spec["kw"].get("mode", "lte"))

    def run_path(plink, name: str, bits, snr, **kw):
        """One step of a path's link; a coded path with several redundancy
        versions runs its batched HARQ schedule."""
        spec = PATHS[name]
        if spec["kind"] != "coded":
            return plink(bits, snr, generator=gen, **kw)
        rvs = spec["kw"]["rv_sequence"]
        if len(rvs) == 1:
            return plink(bits, snr, rv=rvs[0], generator=gen, **kw)
        return plink.harq(bits, snr, rvs, generator=gen, **kw)

    # -- 3. kernel vs plain at the paths' shapes ----------------------------
    bits = random_bits(LANES, 1)
    data = qam.modulate(bits, cfg.modulation).reshape(LANES, SYMBOLS, -1)
    y = ofdm.frame_stream(link.transmit(bits), cfg)                 # (L, S, N+cp)
    rx = link.rx_tables
    gemms = {
        "tx": (data, link.mod_tables.b, link.mod_tables.bsum),
        "rx_data": (y[..., cfg.cp_length:], rx.data.g, rx.data.gsum),
        "rx_pilot": (y[..., ::SLOT_SIZE, cfg.cp_length:], rx.pilot.g, rx.pilot.gsum),
    }
    # the other paths' call sites: SFBC TX (both antennas folded into M), SFBC
    # and SIMO RX under a leading antenna axis (data on the CP-stripped view,
    # pilots on the slot-start view, which is one shape for both links),
    # SC-FDM precoding, the simple mode's Nc-row IDFT and its Nc-bin DFT, and
    # the Jakes taps of 1, 2 (SIMO 1x2) and 4 (SFBC 2x2) links
    sfbc = diversity.SfbcLink(cfg, 2, device=dev)
    st = sfbc.tables
    sfbc_bits = random_bits(LANES, 2, diversity.sfbc_bits_per_frame(cfg, SYMBOLS))
    sfbc_syms = cplx.stack(alamouti.encode(qam.modulate(sfbc_bits, cfg.modulation).reshape(
        LANES, SYMBOLS, -1)), axis=0)                               # (2, L, S, n_even)
    y2 = ofdm.frame_stream(diversity.sfbc_transmit(sfbc_bits, cfg, st), cfg)  # (2, L, S, N+cp)
    scfdm_link = siso.SisoLink(cfg, device=dev, mode="sc-fdm")
    simple_link = siso.SisoLink(cfg, device=dev, mode="simple")
    simple_syms = qam.modulate(random_bits(LANES, 3, siso.bits_per_frame(cfg, SYMBOLS, "simple")),
                               cfg.modulation).reshape(LANES, SYMBOLS, cfg.Nc)
    profile = rayleigh.make_profile("Pedestrian_A", cfg.fs)
    T = SYMBOLS * cfg.samples_per_ofdm_symbol
    gen.manual_seed(4)
    y_simo = ofdm.frame_stream(mimo.transmit_simo(link.transmit(bits), 20.0, 2, "awgn",
                                                  generator=gen), cfg)  # (2, L, S, N+cp)

    def jakes_rows(links: int) -> C:
        return cplx.expi(torch.rand((links * LANES * profile.num_taps, rayleigh.N_SINUSOIDS),
                                    generator=gen, device=dev) * (2 * np.pi)) \
            * float(np.sqrt(2.0 / rayleigh.N_SINUSOIDS))

    jakes_e = rayleigh.jakes_table(profile.doppler_hz, cfg.fs, T, device=dev)
    scfdm_w = scfdm_link._gemm("scfdm_w")
    simple_rx = simple_link.rx_tables.data
    new_gemms = {
        "sfbc_tx": (sfbc_syms, st.mod.b, st.mod.bsum),
        "sfbc_rx_data": (y2[..., cfg.cp_length:], st.data.g, st.data.gsum),
        "sfbc_rx_pilot": (y2[..., ::SLOT_SIZE, cfg.cp_length:], st.pilot.g, st.pilot.gsum),
        "scfdm": (data, scfdm_w.g, scfdm_w.gsum),
        "simple_tx": (simple_syms, simple_link.mod_tables.b, simple_link.mod_tables.bsum),
        "simple_rx": (y[..., cfg.cp_length:], simple_rx.g, simple_rx.gsum),
        "simo_rx_data": (y_simo[..., cfg.cp_length:], rx.data.g, rx.data.gsum),
        "jakes": (jakes_rows(1), jakes_e, None),
        "simo_jakes": (jakes_rows(2), jakes_e, None),
        "sfbc_mp_jakes": (jakes_rows(4), jakes_e, None),
    }
    # the spatial paths' call sites, each with the operands one step of that
    # path makes: the TX GEMM over num_tx antennas and m = 500 (rank 2) or 250
    # (rank 4) layer bins; on the time path the RX data GEMM and the
    # per-symbol pilot GEMM (the CP-stripped view over all symbols, under the
    # RX axis) after the path's own channel; over multipath the Jakes product
    # of num_rx·num_tx links; and the K = 25 tap-basis product of the extended
    # CRS layout. The bins path launches the TX GEMM alone, with the time
    # path's operands.
    sp_gemms = {}
    for short, name in (("spatial_4x2", "spatial_4x2_r2_mmse_time"),
                        ("spatial_4x4_mp", "spatial_4x4_r4_sic_rayleigh_mp"),
                        ("spatial_8x4_ext_mp", "spatial_8x4_r2_mmse_ext_rayleigh_mp")):
        sl = path_link(name)
        x_tx = sl.precode(bits)                                     # (tx, L, S, m)
        sp_gemms[f"{short}_tx"] = (x_tx, sl.mod_tables.b, sl.mod_tables.bsum)
        sig = ofdm.modulate_custom_multi(x_tx, cfg, None, None, None, sl.mod_tables)
        gen.manual_seed(5)
        y_sp, _, _ = mimo.spatial_mix_noiseless(
            sig.reshape(sl.num_tx, LANES, -1), PATHS[name]["snr"], sl.num_rx, sl.channel_type,
            sl.profile, generator=gen)
        y_sp = ofdm.frame_stream(y_sp, cfg)[..., cfg.cp_length:]    # (rx, L, S, N)
        sp_gemms[f"{short}_rx_data"] = (y_sp, *sl._gemm("demod_data"))
        sp_gemms[f"{short}_rx_pilot"] = (y_sp, *sl._gemm("demod_pilot"))
        if sl.profile is not None:
            sp_gemms[f"{short}_jakes"] = (jakes_rows(sl.num_rx * sl.num_tx), jakes_e, None)
        if sl.pilot_layout == "extended":
            n_comb = sl.pilot_seq0_re.shape[0]
            gen.manual_seed(6)
            h_comb = C(torch.randn((sl.num_rx, LANES, SYMBOLS, n_comb), generator=gen,
                                   device=dev),
                       torch.randn((sl.num_rx, LANES, SYMBOLS, n_comb), generator=gen,
                                   device=dev))
            sp_gemms[f"{short}_tap_basis"] = (h_comb, *sl._gemm("tap_basis0"))
        del sl, sig
        torch.cuda.empty_cache()      # the multipath tap planes run to gigabytes
    new_gemms.update(sp_gemms)
    # the beamforming Jakes path's channel: E (S, 16) @ P (16, lanes·rx·tx),
    # E the kept symbol table, P the phases' exponentials
    bf_kw = PATHS["bf_8x1_tm6_jakes_30kmh"]["kw"]
    bf_links = LANES * bf_kw["num_tx"] * 1
    new_gemms["bf_jakes_8x1"] = (
        rayleigh.symbol_table(bf_kw["doppler_hz"], SYMBOLS, 1.0 / 15000.0, dev),
        cplx.expi(torch.rand((rayleigh.N_SINUSOIDS, bf_links), generator=gen, device=dev)
                  * (2 * np.pi)), None)

    g = torch.Generator(device=dev)
    g.manual_seed(7)

    def randc(*shape):
        return C(torch.randn(shape, generator=g, device=dev),
                 torch.randn(shape, generator=g, device=dev))

    unaligned = randc(28, 999)          # A 4 bytes past a 16-byte boundary, lda 999
    ragged = {"ragged_28x999x300": (randc(28, 999), randc(999, 300), None),
              "ragged_5x7x3": (randc(5, 7), randc(7, 3), None),
              "unaligned_28x998x300": (C(unaligned.re[:, 1:], unaligned.im[:, 1:]),
                                       randc(998, 300), None)}

    # the coded paths' call sites: TX over the frame of S symbols the
    # transport block fills, RX data on the CP-stripped view and RX pilot on
    # the slot-start symbols, which the wrapper copies when S (38) is not a
    # multiple of 14 and which are passed here as that copy
    def coded_symbols(name: str) -> int:
        link_c = coded.link_for(cfg, PATHS[name]["kw"]["tb_bits"], dev)
        n_sym = -(-link_c.coded_len // cfg.bits_per_symbol)
        return -(-n_sym // siso.grid_for(cfg).num_data)

    coded_gemms = {}
    for name in [n for n, spec in PATHS.items() if spec["kind"] == "coded"]:
        S_c = coded_symbols(name)
        y_c = ofdm.frame_stream(randc(LANES, S_c * cfg.samples_per_ofdm_symbol), cfg)
        pil = y_c[..., ::SLOT_SIZE, cfg.cp_length:]
        coded_gemms[f"{name}_tx"] = (randc(LANES, S_c, siso.grid_for(cfg).num_data),
                                     link.mod_tables.b, link.mod_tables.bsum)
        coded_gemms[f"{name}_rx_data"] = (y_c[..., cfg.cp_length:], rx.data.g, rx.data.gsum)
        coded_gemms[f"{name}_rx_pilot"] = (C(pil.re.contiguous(), pil.im.contiguous()),
                                           rx.pilot.g, rx.pilot.gsum)
    clear_link_cache()

    def c128(x: C) -> torch.Tensor:
        return torch.complex(x.re.double(), x.im.double())

    def max_diff(x, y) -> float:
        return max((x.re - y.re).abs().max().item(), (x.im - y.im).abs().max().item())

    def run_kernel(kernel, a, b, bsum):
        # only the CUDA-core Gauss kernel reads the tables' bsum plane
        with precision_knobs(PRECISION[kernel]):
            return cmatmul(a, b, gauss=GAUSS[kernel],
                           bsum=bsum if kernel == "f32_gauss" else None,
                           variant="tc" if TENSOR_CORE[kernel] else "ffma")

    def mkn(a, b):
        return int(np.prod(a.shape[:-1])), b.shape[0], b.shape[1]

    def plane_max(x: C) -> float:
        return max(x.re.abs().max().item(), x.im.abs().max().item())

    max_err = dict.fromkeys(TOL, 0.0)
    zero_counts()
    for name, (a, b, bsum) in {**gemms, **new_gemms, **coded_gemms, **ragged}.items():
        M, K, N = mkn(a, b)
        a2 = C(a.re.reshape(M, K), a.im.reshape(M, K))
        # each kernel once at the whole shape, the operand with the strides the
        # path gives it; the plain versions and the float64 product follow in
        # blocks of rows, so that the largest outputs (8 GB) fit beside them
        outs = {kernel: run_kernel(kernel, a, b, bsum).reshape(M, N) for kernel in HIGHEST}
        torch.cuda.synchronize()
        rows = max(1, min(M, (1 << 27) // N))
        errs, ref_max, err64, scale = {}, {}, {}, 0.0
        for r0 in range(0, M, rows):
            ab = C(a2.re[r0:r0 + rows], a2.im[r0:r0 + rows])
            plain = {False: cmatmul_plain(ab, b), True: cmatmul_plain(ab, b, gauss=True)}
            exact = c128(ab) @ c128(b)
            scale = max(scale, exact.abs().max().item())
            err64["plain"] = max(err64.get("plain", 0.0),
                                 (c128(plain[False]) - exact).abs().max().item())
            for kernel in HIGHEST:
                out = C(outs[kernel].re[r0:r0 + rows], outs[kernel].im[r0:r0 + rows])
                refs = {"plain": plain[GAUSS[kernel]]}
                if kernel == "tf32x3":
                    refs["plain_tf32x3"] = cmatmul_plain_tf32x3(ab, b)
                elif kernel == "tf32x3_gauss":
                    refs["plain_gauss_tf32x3"] = cmatmul_plain_gauss_tf32x3(ab, b)
                for ref_name, ref in refs.items():
                    key = (kernel, ref_name)
                    errs[key] = max(errs.get(key, 0.0), max_diff(out, ref))
                    ref_max[key] = max(ref_max.get(key, 0.0), plane_max(ref))
                err64[kernel] = max(err64.get(kernel, 0.0),
                                    (c128(out) - exact).abs().max().item())
            del plain, exact, out, refs, ref
        for (kernel, ref_name), err in errs.items():
            rel, tol = err / ref_max[(kernel, ref_name)], TOL[kernel]
            print(f"check {name} {kernel} vs {ref_name} (M={M}, K={K}, N={N}, "
                  f"a strides {tuple(a.re.stride())}): max|d| {err:.3e}  "
                  f"max|d|/max|C| {rel:.3e}  tol {tol:.0e}")
            if not (rel <= tol):
                raise AssertionError(f"kernel {kernel} disagrees with {ref_name} at "
                                     f"{name}: {rel:.3e} > {tol:.0e}")
            if ref_name == "plain":
                max_err[kernel] = max(max_err[kernel], err)
        print(f"accuracy {name} against float64, max|d|/max|C|: " +
              "  ".join(f"{k} {v / scale:.3e}" for k, v in err64.items()))
        del outs
        torch.cuda.empty_cache()
    if cmatmul.copies:
        raise AssertionError(f"the wrapper copied {cmatmul.copies} operand planes in phase 3")

    # the pilot GEMM's grid is split along K; its partial sums are added in a
    # fixed order, so two runs give the same bits
    a, b, _ = gemms["rx_pilot"]
    M, K, N = mkn(a, b)
    for kernel in ("tf32x3", "tf32x3_gauss"):
        splits = getattr(_build.library(), f"cmatmul_{kernel}_splits")(
            M, N, K, torch.cuda.get_device_properties(dev).multi_processor_count)
        first, second = run_kernel(kernel, a, b, None), run_kernel(kernel, a, b, None)
        torch.cuda.synchronize()
        same = torch.equal(first.re, second.re) and torch.equal(first.im, second.im)
        print(f"determinism rx_pilot {kernel}: K split {splits} ways, two runs identical: "
              f"{same}")
        if splits < 2 or not same:
            raise AssertionError(f"the split-K pilot GEMM through {kernel} is not split or "
                                 f"not reproducible")

    # the BCJR kernel against its plain version on the card
    def bcjr_inputs(n: int, kp: int, seed: int):
        g.manual_seed(seed)
        return [torch.randn((n, kp), generator=g, device=dev) * 3.0 for _ in range(3)]

    bcjr_err = {True: 0.0, False: 0.0}
    for kp in (43, 1027, 5827, 6083, 6147):
        worst = {True: 0.0, False: 0.0}
        for n in (1, 7, 64):
            ls, lp, la = bcjr_inputs(n, kp, 100 * kp + n)
            metric = 0.5 * (ls.abs() + lp.abs() + la.abs()).sum(dim=-1).max().item()
            for max_log in (True, False):
                got = bcjr.bcjr_app(ls, lp, la, max_log)
                again = bcjr.bcjr_app(ls, lp, la, max_log)
                want = bcjr.bcjr_plain(ls, lp, la, max_log)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                worst[max_log] = max(worst[max_log], err / metric)
                bcjr_err[max_log] = max(bcjr_err[max_log], err)
                if not torch.equal(got, again) or (max_log and not torch.equal(got, want)) \
                        or err > BCJR_LOGMAP_TOL * metric:
                    raise AssertionError(f"turbo_bcjr at n={n} K'={kp} max_log={max_log}: "
                                         f"max|d| {err:.3e}, path metric {metric:.1f}, "
                                         f"launches identical {torch.equal(got, again)}")
        print(f"check turbo_bcjr vs bcjr_plain, K'={kp}, 1/7/64 blocks, a-priori LLRs non-zero: "
              f"max-log equal as floats, log-MAP max|d|/path metric {worst[False]:.3e} "
              f"(tol {BCJR_LOGMAP_TOL:.0e}); two launches identical")

    # the half-iteration modes against bcjr_half_plain: the extrinsic with the
    # a-priori through the QPP π, through π⁻¹ and null, and the hard bits
    # (K' − 3 is a QPP size at each of these K')
    for kp in (43, 1027, 5827, 6083, 6147):
        K = kp - 3
        perm, inv = turbo.qpp_tables(K, dev)
        worst = 0.0
        for n in (1, 7, 64):
            ls, lp, la = bcjr_inputs(n, kp, 100 * kp + n + 1)
            ext = la[:, :K].t().contiguous()                  # step-major (K, n)
            metric = 0.5 * (ls.abs() + lp.abs() + la.abs()).sum(dim=-1).max().item()
            for max_log in (True, False):
                for mode, e, idx, hard in (("extrinsic/pi", ext, perm, False),
                                           ("extrinsic/pi_inv", ext, inv, False),
                                           ("extrinsic/none", None, None, False),
                                           ("hard/pi_inv", ext, inv, True)):
                    got = bcjr.bcjr_half(ls, lp, e, idx, hard, max_log)
                    again = bcjr.bcjr_half(ls, lp, e, idx, hard, max_log)
                    want = bcjr.bcjr_half_plain(ls, lp, e, idx, hard, max_log)
                    torch.cuda.synchronize()
                    if hard:
                        off = got != want
                        if not max_log:
                            # bits may differ only where the APP is within
                            # the tolerance of 0
                            apr = torch.cat([ext.index_select(0, idx.long()).t(),
                                             torch.zeros_like(ls[:, :3])], -1)
                            app = bcjr.bcjr_plain(ls, lp, apr, False)[:, :K]
                            off &= app.abs() > BCJR_LOGMAP_TOL * metric
                        err = off.sum().item()
                        ok = err == 0
                    else:
                        err = (got - want).abs().max().item()
                        worst = max(worst, err / metric)
                        bcjr_err[max_log] = max(bcjr_err[max_log], err)
                        ok = err <= BCJR_LOGMAP_TOL * metric
                    if not torch.equal(got, again) or (max_log and not torch.equal(got, want)) \
                            or not ok:
                        raise AssertionError(f"turbo_bcjr {mode} at n={n} K'={kp} max_log="
                                             f"{max_log}: max|d| or bits off {err:.3e}, path "
                                             f"metric {metric:.1f}, launches identical "
                                             f"{torch.equal(got, again)}")
        print(f"check turbo_bcjr half-iteration modes vs bcjr_half_plain, K'={kp}, 1/7/64 "
              f"blocks: extrinsic through pi, pi_inv and a null a-priori, hard bits; max-log "
              f"equal as floats, log-MAP max|d|/path metric {worst:.3e} (tol "
              f"{BCJR_LOGMAP_TOL:.0e}), hard bits equal off the tolerance; two launches identical")

    # -- 4. the facade, once per method --------------------------------------
    zero_counts()
    host_bits = np.random.default_rng(3).integers(0, 2, n_bits)
    res = OFDMModule(cfg, seed=3).transmit(host_bits, 60.0)
    if res["ber"] != 0 or cmatmul.launches != 3 or not np.isfinite(res["papr_db"]):
        raise AssertionError(f"facade: ber {res['ber']} launches {cmatmul.launches} "
                             f"papr {res['papr_db']}")
    print(f"facade OFDMModule.transmit at 60 dB: ber {res['ber']} papr_db "
          f"{res['papr_db']:.3f} evm% {res['evm_percent']:.4f} launches {cmatmul.launches}")
    sim = OFDMSimulator(cfg, channel_type="rayleigh_mp", seed=4)
    # whole 14-symbol slots of each link's frame, so that the slot-start view folds
    sfbc_host_bits = host_bits[:diversity.sfbc_bits_per_frame(cfg, SYMBOLS)]
    for method, per_call, tx_bits in (
            ("simulate_simo", PATHS["simo_1x2_rayleigh_mp"]["launches"], host_bits),
            ("simulate_mimo", PATHS["sfbc_2x2_rayleigh_mp"]["launches"], sfbc_host_bits)):
        zero_counts()
        res = getattr(sim, method)(tx_bits, 30.0, num_rx=2)
        print(f"facade OFDMSimulator.{method} over rayleigh_mp at 30 dB: ber {res['ber']:.6g} "
              f"papr_db {res['papr_db']:.3f} launches {cmatmul.launches} copies {cmatmul.copies}")
        if not (0 <= res["ber"] < 0.1) or cmatmul.launches != per_call or cmatmul.copies:
            raise AssertionError(f"facade {method}: {res['ber']}, launches {cmatmul.launches}")
    zero_counts()
    res = sim.simulate_spatial_multiplexing(host_bits, 30.0, num_tx=4, num_rx=4, rank=2,
                                            detector_type="SIC")
    print(f"facade OFDMSimulator.simulate_spatial_multiplexing 4x4 rank 2 SIC over rayleigh_mp "
          f"at 30 dB: ber {res['ber']:.6g} papr_db {res['papr_db']:.3f} launches "
          f"{cmatmul.launches} copies {cmatmul.copies}")
    if not (0 <= res["ber"] < 0.1) or cmatmul.launches != 4 or cmatmul.copies \
            or res["mode"] != "Spatial Multiplexing TM4":
        raise AssertionError(f"facade simulate_spatial_multiplexing: {res['ber']}, launches "
                             f"{cmatmul.launches}")
    for model, per_call in (("static", 0), ("jakes", 1)):
        zero_counts()
        res = sim.simulate_beamforming(host_bits, 15.0, num_tx=4, num_rx=2, velocity_kmh=30.0,
                                       update_mode="static", channel_model=model)
        print(f"facade OFDMSimulator.simulate_beamforming 4x2 TM6 {model} at 15 dB: ber "
              f"{res['ber']:.6g} gain {res['beamforming_gain_db']:.4f} dB, PMIs "
              f"{res['unique_pmis']} of {len(res['pmi_history'])} symbols, launches "
              f"{cmatmul.launches}")
        if not (0 <= res["ber"] < 0.2) or cmatmul.launches != per_call or cmatmul.copies \
                or res["mode"] != "Beamforming" or len(res["pmi_history"]) != SYMBOLS \
                or (model == "jakes" and res["update_period_symbols"] != 4):
            raise AssertionError(f"facade simulate_beamforming {model}: {res['ber']}, launches "
                                 f"{cmatmul.launches}")
    # one-device sweeps: 3 SNR points x 16 frames as the 48 lanes of one step
    # (beamforming's MRT gain leaves few errors at 20 dB: its points are lower)
    for pipeline, per_step, points, kw in (
            ("spatial", 1, [10.0, 20.0, 60.0], dict(num_tx=4, num_rx=2, rank=2)),
            ("sfbc", 3, [10.0, 20.0, 60.0], dict(num_rx=2)),
            ("beamforming", 0, [5.0, 12.0, 60.0], dict(num_tx=4, num_rx=2))):
        zero_counts()
        gen.manual_seed(8)
        sw = ber_sweep(cfg, points, frames=16, num_ofdm_symbols=SYMBOLS,
                       pipeline=pipeline, generator=gen, **kw)
        print(f"ber_sweep {pipeline} at {sw.snr_db.tolist()} dB, {sw.frames} frames a point: "
              f"ber {sw.ber.tolist()} papr_db {sw.papr_db.tolist()} launches "
              f"{cmatmul.launches} copies {cmatmul.copies}")
        if not (sw.ber[0] > sw.ber[1] > sw.ber[2] >= 0.0) or sw.ber[2] > 1e-3 \
                or cmatmul.launches != per_step or cmatmul.copies \
                or sw.bit_errors.dtype != np.int64 or not np.isfinite(sw.papr_db).all() \
                or (pipeline == "beamforming" and sw.papr_db.tolist() != [0.0] * 3):
            raise AssertionError(f"ber_sweep {pipeline}: {sw}")
    clear_link_cache()
    zero_counts()
    sweep = OFDMSimulator(cfg, seed=5).run_ber_sweep(host_bits, [5.0, 15.0, 60.0])
    print(f"facade run_ber_sweep at {sweep['snr_values'].tolist()} dB: ber "
          f"{sweep['ber_values'].tolist()} launches {cmatmul.launches}")
    b5, b15, b60 = sweep["ber_values"]
    if not (b5 > b15 > b60 == 0.0) or cmatmul.launches != 9 or cmatmul.copies:
        raise AssertionError(f"facade run_ber_sweep: {sweep['ber_values']}")
    del sim

    # the coded facade: one 6,000-bit transport block, then HARQ below the
    # single-transmission waterfall; 3 GEMMs and 17 BCJR passes a transmission
    coded_sim = OFDMSimulator(cfg, seed=6)
    tb = np.random.default_rng(6).integers(0, 2, PATHS["coded_6000_awgn"]["kw"]["tb_bits"])
    zero_counts()
    res = coded_sim.simulate_siso_coded(tb, CODED_CLEAN_SNR)
    print(f"facade OFDMSimulator.simulate_siso_coded, 6000 bits at {CODED_CLEAN_SNR:g} dB: "
          f"crc_pass {res['crc_pass']} ber {res['ber']} coded bits {res['coded_bits_length']} "
          f"papr_db {res['papr_db']:.3f} pilot snr {res['channel_snr_db']:.2f} dB, launches "
          f"{cmatmul.launches} GEMM + {bcjr.bcjr_half.launches} BCJR")
    if not res["crc_pass"] or res["ber"] != 0 or res["coded_bits_length"] != 3 * 6080 + 12 \
            or (cmatmul.launches, bcjr.bcjr_half.launches) != (3, 17) or cmatmul.copies:
        raise AssertionError(f"facade simulate_siso_coded: {res}")
    zero_counts()
    res = coded_sim.simulate_siso_coded_harq(tb, 17.0)
    n_tx = res["num_transmissions"]
    print(f"facade OFDMSimulator.simulate_siso_coded_harq, 6000 bits at 17 dB: transmissions "
          f"{n_tx}, crc history {res['crc_history']}, rv {res['rv_history']}, ber {res['ber']}, "
          f"launches {cmatmul.launches} GEMM + {bcjr.bcjr_half.launches} BCJR")
    if not 1 <= n_tx <= 4 or res["rv_history"] != [0, 1, 2, 3][:n_tx] \
            or res["crc_history"][:-1] != [False] * (n_tx - 1) \
            or (res["crc_pass"] and res["ber"] != 0) or (not res["crc_pass"] and n_tx != 4) \
            or (cmatmul.launches, bcjr.bcjr_half.launches) != (3 * n_tx, 17 * n_tx):
        raise AssertionError(f"facade simulate_siso_coded_harq: {res}")
    del coded_sim
    clear_link_cache()
    zero_counts()
    gen.manual_seed(9)
    coded_snr = PATHS["coded_6000_awgn"]["snr"]
    sw = ber_sweep(cfg, [15.0, coded_snr, CODED_CLEAN_SNR], frames=16, pipeline="coded",
                   generator=gen)
    print(f"ber_sweep coded (6000-bit transport blocks) at {sw.snr_db.tolist()} dB, "
          f"{sw.frames} frames a point: ber {sw.ber.tolist()} papr_db {sw.papr_db.tolist()} "
          f"launches {cmatmul.launches} GEMM + {bcjr.bcjr_half.launches} BCJR")
    if not (sw.ber[0] > sw.ber[1] > sw.ber[2] == 0.0) or sw.total_bits.tolist() != [96000] * 3 \
            or (cmatmul.launches, bcjr.bcjr_half.launches) != (3, 17) or cmatmul.copies \
            or not np.isfinite(sw.papr_db).all():
        raise AssertionError(f"ber_sweep coded: {sw}")
    zero_counts()
    hs = harq_sweep(cfg, [16.0, CODED_CLEAN_SNR], frames=16, generator=gen)
    print(f"harq_sweep (6000-bit transport blocks, rv 0-3) at {hs.snr_db.tolist()} dB, "
          f"{hs.frames} frames a point: stage failures {hs.stage_failures.tolist()} "
          f"transmissions {hs.tx_sum.tolist()} bit errors {hs.bit_errors.tolist()} "
          f"bler {hs.bler.tolist()}, launches {cmatmul.launches} GEMM + "
          f"{bcjr.bcjr_half.launches} BCJR")
    stages = hs.stage_failures
    if stages.dtype != np.int64 or (np.diff(stages, axis=1) > 0).any() \
            or stages[1].tolist() != [0] * 4 or hs.tx_sum[1] != 16 or hs.bit_errors[1] != 0 \
            or hs.tx_sum[0] <= 16 or hs.tb_failures.tolist() != stages[:, -1].tolist() \
            or (cmatmul.launches, bcjr.bcjr_half.launches) != (12, 68):
        raise AssertionError(f"harq_sweep: {hs}")
    clear_link_cache()

    # -- 5. the main path, once per kernel ----------------------------------
    def main_path_through(kernel):
        """Context in which the link's GEMMs go to `kernel`."""
        os.environ["OFDM_LTE_TPU_TORCH_CMATMUL"] = "gauss" if GAUSS[kernel] else "fma4"
        return contextlib.nullcontext() if TENSOR_CORE[kernel] else default_variant("ffma")

    launches = {}
    launches_by_path = {}
    for kernel in HIGHEST:
        with main_path_through(kernel):
            zero_counts()
            bers = {}
            for step, snr in enumerate((60.0, 15.0)):
                bits = random_bits(LANES, 100 + step)
                gen.manual_seed(200 + step)
                # no device named: the functional form takes the card and moves
                # the bits there, from the host too
                r = siso.simulate_siso(bits.cpu() if step else bits, snr, cfg, generator=gen)
                if r.bits_rx.shape != bits.shape or r.bits_rx.dtype != bits.dtype:
                    raise AssertionError(f"bits_rx {r.bits_rx.shape} {r.bits_rx.dtype}")
                if not r.bits_rx.is_cuda or r.ber.shape != (LANES,) \
                        or not torch.isfinite(r.papr_db).all():
                    raise AssertionError("device, ber shape or non-finite PAPR")
                bers[snr] = r.ber.mean().item()
            counts = dict(cmatmul.launches_by_kernel)
        launches[kernel] = counts[kernel]
        launches_by_path[f"main/{kernel}"] = counts[kernel]
        print(f"main path {kernel}: {LANES} lanes x {SYMBOLS} symbols, BER@60dB "
              f"{bers[60.0]:.6g}, BER@15dB {bers[15.0]:.6g}, launches {counts}, "
              f"copies {cmatmul.copies}")
        if bers[60.0] != 0.0 or not (BER_15DB[0] <= bers[15.0] <= BER_15DB[1]):
            raise AssertionError(f"{kernel}: BER {bers} outside 0 / {BER_15DB}")
        if counts[kernel] != 3 * 2 or sum(counts.values()) != 3 * 2 or cmatmul.copies:
            raise AssertionError(f"{kernel}: launches {counts}, expected 6 of {kernel} alone")
    os.environ["OFDM_LTE_TPU_TORCH_CMATMUL"] = "fma4"
    main_papr = r.papr_db.mean().item()

    # every other path, through the default kernel
    print(f"paths: {LANES} lanes x {SYMBOLS} symbols each")
    paprs = {}
    bcjr_launches_by_path = {}
    for name, spec in PATHS.items():
        plink = path_link(name)
        is_coded = spec["kind"] == "coded"
        clean = CODED_CLEAN_SNR if is_coded else 60.0
        zero_counts()
        bers, blers = {}, {}
        for step, snr in enumerate((clean, spec["snr"])):
            bits = random_bits(LANES, 300 + step, path_bits(name))
            gen.manual_seed(400 + step)
            r = run_path(plink, name, bits, snr)
            # the beamforming link makes no time signal and has no PAPR
            papr = getattr(r, "papr_db", torch.zeros(LANES, device=dev))
            if r.bits_rx.shape != bits.shape or r.bits_rx.dtype != bits.dtype \
                    or r.ber.shape != (LANES,) or not torch.isfinite(papr).all():
                raise AssertionError(f"{name}: bits_rx {r.bits_rx.shape} {r.bits_rx.dtype}, "
                                     f"ber {r.ber.shape} or non-finite PAPR")
            bers[snr] = r.ber.mean().item()
            if is_coded:
                passed = r.crc_pass_stage if hasattr(r, "crc_pass_stage") else r.crc_pass[:, None]
                blers[snr] = (1.0 - passed.float().mean(dim=0)).tolist()
        counts = dict(cmatmul.launches_by_kernel)
        launches["tf32x3"] += counts["tf32x3"]
        launches_by_path[name] = counts["tf32x3"]
        n_bcjr = bcjr.bcjr_half.launches
        if is_coded:
            bcjr_launches_by_path[name] = n_bcjr
        paprs[name] = papr.mean().item()
        lo, hi = ber_band(JAX_BER[name], LANES)
        extra = ""
        if spec["kind"] == "beamforming":
            pmi = r.pmi_history if hasattr(r, "pmi_history") else r.pmi
            extra = (f", gain {r.beamforming_gain_db.mean().item():.4f} dB, PMIs used "
                     f"{torch.unique(pmi).numel()}")
            if not torch.isfinite(r.beamforming_gain_db).all():
                raise AssertionError(f"{name}: non-finite beamforming gain")
        if is_coded:
            bands = [bler_band(p, LANES, JAX_BER[name]["lanes"]) for p in JAX_BER[name]["bler"]]
            extra = (f", BLER@{clean:g}dB {blers[clean]}, BLER@{spec['snr']:g}dB by stage "
                     f"{[round(b, 6) for b in blers[spec['snr']]]} (JAX {JAX_BER[name]['bler']}, "
                     f"bands {[(round(float(a), 4), round(float(b), 4)) for a, b in bands]}), BCJR launches "
                     f"{n_bcjr}")
            if any(blers[clean]) or bers[clean] != 0.0:
                raise AssertionError(f"{name}: BLER {blers[clean]} BER {bers[clean]} at {clean} dB")
            if len(bands) != len(blers[spec["snr"]]) or not all(
                    a <= p <= b for p, (a, b) in zip(blers[spec["snr"]], bands)):
                raise AssertionError(f"{name}: BLER {blers[spec['snr']]} outside {bands}")
            if n_bcjr != 2 * spec["bcjr"] or bcjr.bcjr_app.launches:
                raise AssertionError(f"{name}: {n_bcjr} BCJR launches, expected {2 * spec['bcjr']}")
        print(f"path {name}: BER@{clean:g}dB {bers[clean]:.6g} (at most {spec['ber60']}), "
              f"BER@{spec['snr']:g}dB {bers[spec['snr']]:.6g} (JAX {JAX_BER[name]['mean']:.6g}, "
              f"band [{lo:.6g}, {hi:.6g}]), PAPR {paprs[name]:.3f} dB{extra}, launches {counts}, "
              f"copies {cmatmul.copies}")
        if spec["ber60"] is not None and not bers[clean] <= spec["ber60"]:
            raise AssertionError(f"{name}: BER {bers[clean]} at {clean} dB, over {spec['ber60']}")
        if not (lo <= bers[spec["snr"]] <= hi):
            raise AssertionError(f"{name}: BER {bers[spec['snr']]} outside [{lo}, {hi}]")
        if counts["tf32x3"] != 2 * spec["launches"] or sum(counts.values()) != counts["tf32x3"]:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{2 * spec['launches']} of tf32x3 alone")
        if cmatmul.copies != 2 * spec.get("copies", 0):
            raise AssertionError(f"{name}: the wrapper copied {cmatmul.copies} operand planes, "
                                 f"expected {2 * spec.get('copies', 0)}")
        del plink, r
        torch.cuda.empty_cache()      # the multipath tap planes run to gigabytes
    print(f"PAPR: OFDM {main_papr:.3f} dB, SC-FDM {paprs['scfdm_awgn']:.3f} dB")
    if not paprs["scfdm_awgn"] < main_papr:
        raise AssertionError("SC-FDM's PAPR is not below OFDM's")

    # CUDA path vs CPU path on small inputs with the same injected draws
    small = LTEConfig(5.0, modulation="64-QAM")
    rng = np.random.default_rng(11)
    sg = siso.grid_for(small)
    lanes, S = 4, 28

    def normals(*shape):
        return rng.standard_normal(shape), rng.standard_normal(shape)

    n_even = len(diversity.sfbc_data_bins(small))
    bin_noise = (normals(lanes, S, sg.num_data), normals(lanes, 2, sg.num_pilot))
    small_profile = rayleigh.make_profile("Pedestrian_A", small.fs)
    sfbc_noise = (normals(2, lanes, S, n_even), normals(2, lanes, 2, sg.num_pilot))
    cases = {
        "main": (siso.simulate_siso, siso.bits_per_frame(small, S), dict(noise=bin_noise)),
        "sc-fdm": (siso.simulate_siso, siso.bits_per_frame(small, S),
                   dict(mode="sc-fdm", noise=bin_noise)),
        "rayleigh_mp": (siso.simulate_siso, siso.bits_per_frame(small, S), dict(
            channel_type="rayleigh_mp",
            draws={"phases": rng.uniform(0, 2 * np.pi, (lanes * small_profile.num_taps, 16)),
                   "noise": normals(lanes, S * small.samples_per_ofdm_symbol)})),
        "fading": (siso.simulate_siso, siso.bits_per_frame(small, S), dict(
            channel_type="fading",
            draws={"fading": normals(lanes, S * small.samples_per_ofdm_symbol),
                   "noise": normals(lanes, S * small.samples_per_ofdm_symbol)})),
        "simo_1x2_rayleigh_mp": (diversity.simulate_simo, siso.bits_per_frame(small, S), dict(
            num_rx=2, channel_type="rayleigh_mp",
            draws={"phases": rng.uniform(0, 2 * np.pi,
                                         (2 * lanes * small_profile.num_taps, 16)),
                   "noise": normals(2, lanes, S * small.samples_per_ofdm_symbol)})),
        "sfbc_2x2": (diversity.simulate_sfbc, diversity.sfbc_bits_per_frame(small, S), dict(
            num_rx=2, draws={"noise": sfbc_noise})),
        "sfbc_2x2_rayleigh_mp": (diversity.simulate_sfbc,
                                 diversity.sfbc_bits_per_frame(small, S), dict(
            num_rx=2, channel_type="rayleigh_mp",
            draws={"phases": rng.uniform(0, 2 * np.pi,
                                         (4 * lanes * small_profile.num_taps, 16)),
                   "noise": sfbc_noise})),
    }
    m2, m4 = -(-sg.num_data // 2), -(-sg.num_data // 4)
    sp_n = spatial.bits_per_frame(small, S)
    sp_flat = {"fading": normals(lanes, 2, 4),
               "noise": (normals(2, lanes, S, m2), normals(2, lanes, S, sg.num_pilot))}
    cases["spatial_4x2_r2_mmse"] = (spatial.simulate_spatial_multiplexing, sp_n, dict(
        num_tx=4, num_rx=2, rank=2, detector_type="MMSE", draws=sp_flat))
    cases["spatial_4x4_r4_sic_rayleigh_mp"] = (spatial.simulate_spatial_multiplexing, sp_n, dict(
        num_tx=4, num_rx=4, rank=4, detector_type="SIC", channel_type="rayleigh_mp",
        draws={"phases": rng.uniform(0, 2 * np.pi, (16 * lanes * small_profile.num_taps, 16)),
               "noise": (normals(4, lanes, S, m4), normals(4, lanes, S, sg.num_pilot))}))
    bf_n, bf_nd = beamforming.bits_per_frame(small, S), sg.num_data
    cases["bf_4x2_tm6_codebook"] = (beamforming.simulate_beamforming, bf_n, dict(
        num_tx=4, num_rx=2, update_mode="static",
        draws={"H": normals(lanes, 2, 4), "noise": normals(lanes, 2, S * bf_nd)}))
    jk = {k: v for k, v in PATHS["bf_8x1_tm6_jakes_30kmh"]["kw"].items() if k != "channel_model"}
    cases["bf_8x1_tm6_jakes_30kmh"] = (beamforming.simulate_beamforming_time_varying, bf_n, dict(
        draws={"phases": rng.uniform(0, 2 * np.pi, (16, lanes * 8)),
               "noise": normals(lanes, S, 1, bf_nd)}, **jk))
    for name, (fn, n, kw) in cases.items():
        sb = torch.as_tensor(rng.integers(0, 2, (lanes, n)).astype(np.int32))
        zero_counts()
        r_gpu = fn(sb, 20.0, small, **kw)
        r_cpu = fn(sb, 20.0, small, device="cpu", **kw)
        mism = int((r_gpu.bits_rx.cpu() != r_cpu.bits_rx).sum())
        if name.startswith("bf_"):
            pmi_gpu, pmi_cpu = (x.pmi_history if "jakes" in name else x.pmi
                                for x in (r_gpu, r_cpu))
            d_gain = (r_gpu.beamforming_gain_db.cpu() - r_cpu.beamforming_gain_db).abs().max()
            print(f"cuda vs cpu, same draws, {name}: PMIs equal "
                  f"{torch.equal(pmi_gpu.cpu(), pmi_cpu)}, gain differs by "
                  f"{d_gain.item():.2e} dB")
            if not torch.equal(pmi_gpu.cpu(), pmi_cpu) or d_gain.item() > 1e-4:
                raise AssertionError(f"{name}: the CUDA path's feedback disagrees with the CPU's")
        print(f"cuda vs cpu, same draws, {name}, 5 MHz 64-QAM 20 dB: {mism} of {sb.numel()} "
              f"bits differ, ber {r_gpu.ber.mean().item():.6g} vs "
              f"{r_cpu.ber.mean().item():.6g}, launches {cmatmul.launches}")
        if not r_gpu.bits_rx.is_cuda or mism > 1e-4 * sb.numel() or cmatmul.copies:
            raise AssertionError(f"{name}: the CUDA path disagrees with the CPU path")

    # the flat spatial channel at the bins against its time path, on the card,
    # under the same H and noise: an algebraic identity
    sb = torch.as_tensor(rng.integers(0, 2, (lanes, sp_n)).astype(np.int32), device=dev)
    for det in ("MMSE", "SIC"):
        zero_counts()
        by_impl = {impl: spatial.SpatialLink(small, 4, 2, 2, det, device=dev, channel_impl=impl)(
            sb, 20.0, draws=sp_flat) for impl in ("bins", "time")}
        mism = int((by_impl["bins"].bits_rx != by_impl["time"].bits_rx).sum())
        d_papr = (by_impl["bins"].papr_db - by_impl["time"].papr_db).abs().max().item()
        print(f"spatial 4x2 rank 2 {det} on the card, bins vs time, same draws, 5 MHz 64-QAM "
              f"20 dB: {mism} of {sb.numel()} bits differ, PAPR differs by {d_papr:.2e} dB, "
              f"launches {cmatmul.launches}")
        if mism > 1e-4 * sb.numel() or d_papr > 1e-3 or cmatmul.launches != 4 or cmatmul.copies:
            raise AssertionError(f"spatial {det}: the bins path disagrees with the time path")

    # the time-varying flat MIMO channel: one product, through the kernel
    phi = rng.uniform(0, 2 * np.pi, (16, 8 * 4 * 2))
    zero_counts()
    h_gpu = rayleigh.flat_mimo_time_varying(4, 2, 28, 70.0, batch_shape=(8,), device=dev,
                                            phases=phi)
    h_cpu = rayleigh.flat_mimo_time_varying(4, 2, 28, 70.0, batch_shape=(8,), device="cpu",
                                            phases=phi)
    err = max((h_gpu.re.cpu() - h_cpu.re).abs().max().item(),
              (h_gpu.im.cpu() - h_cpu.im).abs().max().item())
    print(f"flat_mimo_time_varying (28, 16) @ (16, 64) on the card vs the CPU, same phases: "
          f"max|d| {err:.2e}, launches {cmatmul.launches}")
    if err > 1e-5 or cmatmul.launches != 1:
        raise AssertionError("flat_mimo_time_varying: not one kernel launch, or wrong")

    # the coded chain's front end on the card: the CPU's results, exactly
    coding_front_on_card(rng, dev, cfg)
    coded_on_card(rng, dev)
    clear_link_cache()
    torch.cuda.empty_cache()

    # -- 6. timing --------------------------------------------------------
    pool = [random_bits(LANES, 1000 + i) for i in range(STEPS)]
    step_i = [0]

    def step():
        i = step_i[0] % STEPS
        step_i[0] += 1
        gen.manual_seed(5000 + step_i[0])
        return link(pool[i], 15.0, generator=gen).bit_errors

    torch.cuda.synchronize()
    # the step through each kernel in turns, there and back, after one untimed
    # pass that brings the card from the CPU comparisons back to its clocks;
    # each time is the mean of its two passes
    cuda_ms(step, STEPS)
    passes = {kernel: [] for kernel in HIGHEST}
    for kernel in HIGHEST + HIGHEST[::-1]:
        with main_path_through(kernel):
            passes[kernel].append(cuda_ms(step, STEPS))
    os.environ["OFDM_LTE_TPU_TORCH_CMATMUL"] = "fma4"
    ms_step = {kernel: sum(ts) / len(ts) for kernel, ts in passes.items()}
    for kernel, t in ms_step.items():
        print(f"[{card}] main path 20 MHz 64-QAM through {kernel}, {LANES} lanes: "
              f"{t:.4f} ms/step (passes {passes[kernel][0]:.4f}, {passes[kernel][1]:.4f}), "
              f"{LANES / (t / 1e3):.1f} frames/s, "
              f"{LANES * n_bits / (t / 1e3) / 1e9:.3f} Gbit/s")
    if "main" in to_profile:
        profile_steps(step)
    del pool

    for name, spec in PATHS.items():
        plink = path_link(name)
        ppool = [random_bits(LANES, 2000 + i, path_bits(name)) for i in range(PATH_STEPS)]

        def pstep():
            i = step_i[0] % PATH_STEPS
            step_i[0] += 1
            gen.manual_seed(6000 + step_i[0])
            return run_path(plink, name, ppool[i], spec["snr"]).bit_errors

        torch.cuda.reset_peak_memory_stats()
        t = cuda_ms(pstep, PATH_STEPS)
        rate = (f"{LANES / (t / 1e3):.1f} TBs/s, {LANES * path_bits(name) / (t / 1e3) / 1e6:.3f} "
                f"information Mbit/s" if spec["kind"] == "coded" else
                f"{LANES / (t / 1e3):.1f} frames/s, "
                f"{LANES * path_bits(name) / (t / 1e3) / 1e9:.3f} Gbit/s")
        print(f"[{card}] path {name} 20 MHz 64-QAM through tf32x3, {LANES} lanes: "
              f"{t:.4f} ms/step, {rate}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if name in to_profile:
            profile_steps(pstep, crc_gemm_kernels=crc_gemm_kernels(plink, LANES)
                          if spec["kind"] == "coded" else 0)
        if name == "lte_rayleigh_mp":
            # the channel stage alone: what one fused pass (taps made on the
            # fly, delayed multiply-adds, noise) would have to beat. Fused, it
            # reads x and writes y once: 4 planes of LANES·T floats.
            # the sinusoid table is kept: a step multiplies by it, as here
            sig, prof = plink.transmit(ppool[0]), plink.profile
            stages = {
                "jakes_taps": lambda: rayleigh.jakes_taps(
                    prof, T, (LANES,), generator=gen, device=dev),
                "apply_multipath (taps + FIR)": lambda: rayleigh.apply_multipath(
                    sig, prof, generator=gen),
                "rayleigh_multipath (taps + FIR + noise)": lambda: rayleigh.rayleigh_multipath(
                    sig, spec["snr"], prof, -1, gen),
            }
            fused = 1e3 * 4 * LANES * T * 4 / HBM_BYTES_PER_S
            for stage, fn in stages.items():
                print(f"[{card}] stage {stage}, {LANES} lanes x {prof.num_taps} taps x {T} "
                      f"samples: {cuda_ms(fn, PATH_STEPS):.4f} ms of the step's {t:.4f} ms; "
                      f"one fused pass moves {4 * LANES * T * 4 / 1e6:.1f} MB, at least "
                      f"{fused:.4f} ms")
            del sig
        if name in ("spatial_4x2_r2_mmse", "spatial_4x4_r4_sic_rayleigh_mp"):
            # the detector chain alone, elementwise PyTorch on planes: what a
            # fused pass would have to beat
            n_rx, L = spec["kw"]["num_rx"], spec["kw"]["rank_used"]
            gen.manual_seed(9)

            def plane():
                return C(torch.randn((LANES, SYMBOLS, plink.m), generator=gen, device=dev),
                         torch.randn((LANES, SYMBOLS, plink.m), generator=gen, device=dev))

            y_pl = [plane() for _ in range(n_rx)]
            h_pl = [[plane() for _ in range(L)] for _ in range(n_rx)]
            chains = {f"mmse{L}_planes": lambda: detector.mmse_planes(y_pl, h_pl, 1e-2),
                      "sic_planes": lambda: detector.sic_planes(y_pl, h_pl, 1e-2,
                                                                cfg.modulation)}
            moved = 1e3 * 4 * 2 * LANES * SYMBOLS * plink.m * (n_rx + n_rx * L + L) \
                / HBM_BYTES_PER_S
            for chain, fn in chains.items():
                print(f"[{card}] stage {chain}, {n_rx} rx x {L} layers x ({LANES}, {SYMBOLS}, "
                      f"{plink.m}) planes: {cuda_ms(fn, PATH_STEPS):.4f} ms in "
                      f"{count_kernels(fn)} kernels of the step's {t:.4f} ms; one fused pass "
                      f"reads y and H and writes the layers once, at least {moved:.4f} ms")
            del y_pl, h_pl
        del plink, ppool
        torch.cuda.empty_cache()

    # the BCJR kernel a pass at the coded paths' shapes: 256 blocks of K 6080
    # and 3,328 blocks of K 5824 (K' = K + 3), in the APP mode and in the
    # extrinsic mode the decoder runs (the a-priori through π, as decoder 2
    # reads it), against its bound and its plain version, which must give
    # the same floats there; no single PyTorch call computes a BCJR pass
    # (library: none). Log-MAP is timed beside each.
    print(f"turbo_bcjr registers and spill (ptxas): {bcjr_registers(_build.build_log)}")
    bcjr_rows = []
    for name, n_blk, kp in (("coded_6000_awgn", LANES, 6083),
                            ("harq_75376_awgn", 13 * LANES, 5827)):
        K = kp - 3
        ls, lp, la = bcjr_inputs(n_blk, kp, 7 * kp)
        ext = la[:, :K].t().contiguous()                      # step-major (K, n)
        perm = turbo.qpp_tables(K, dev)[0]
        modes = {"app": (lambda ml: bcjr.bcjr_app(ls, lp, la, ml),
                         lambda: bcjr.bcjr_plain(ls, lp, la, True)),
                 "extrinsic": (lambda ml: bcjr.bcjr_half(ls, lp, ext, perm, use_max_log=ml),
                               lambda: bcjr.bcjr_half_plain(ls, lp, ext, perm))}
        per_step = PATHS[name]["bcjr"]
        for mode, (kernel, plain) in modes.items():
            out = {}
            t_k = cuda_ms(lambda: out.__setitem__("kernel", kernel(True)), 10)
            t_p = cuda_ms(lambda: out.__setitem__("plain", plain()), 1)
            if not torch.equal(out["kernel"], out["plain"]):
                d = (out["kernel"] - out["plain"]).abs().max().item()
                raise AssertionError(f"turbo_bcjr {mode} at {n_blk} blocks x K' {kp}: max-log "
                                     f"differs from its plain version, max|d| {d:.3e}")
            t_lm = cuda_ms(lambda: kernel(False), 10)
            by_bytes = 1e3 * n_blk * kp * BCJR_BYTES_PER_STEP / HBM_BYTES_PER_S
            by_ops = 1e3 * n_blk * kp * BCJR_OPS_PER_STEP[mode] / PEAK_FLOPS["fp32"]
            bound, by = max((by_bytes, "bytes"), (by_ops, "operations"))
            scratch = 1e3 * n_blk * kp * BCJR_SCRATCH_BYTES_PER_STEP / HBM_BYTES_PER_S
            bcjr_rows.append({"path": name, "mode": mode, "n_blocks": n_blk, "K'": kp,
                              "ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                              "library_ms": None, "scratch_ms": scratch, "log_map_ms": t_lm,
                              "launches_a_step": per_step})
            print(f"[{card}] turbo_bcjr {mode} max-log, {n_blk} blocks x K' {kp}: {t_k:.4f} ms "
                  f"a pass, equal to plain ({t_p:.4f} ms) as floats; bound {bound:.4f} ms by "
                  f"{by} (bytes {by_bytes:.4f}, operations {by_ops:.4f}; share "
                  f"{bound / t_k:.3f}); the design's scratch {scratch:.4f} ms more of bytes; "
                  f"log-MAP {t_lm:.4f} ms; {per_step} passes a step of {name} "
                  f"({per_step * t_k:.3f} ms); no library call")
        del ls, lp, la, ext, out
        torch.cuda.empty_cache()

    # a whole decode, DECODE_ITERATIONS max-log iterations (17 launches),
    # through the kernel and through the plain half-iteration on the same
    # noisy codewords: equal bits, and a BER inside the JAX package's band
    decode_rows = []
    for name, n_blk, K in DECODE_SHAPES:
        gen.manual_seed(K)
        bits = torch.randint(0, 2, (n_blk, K), generator=gen, device=dev, dtype=torch.int32)
        sigma, its = DECODE_SIGMA, DECODE_ITERATIONS
        llr = (2.0 / sigma ** 2) * ((1.0 - 2.0 * turbo.turbo_encode(bits, K).float())
                                    + sigma * torch.randn((n_blk, 3 * K + 12), generator=gen,
                                                          device=dev))
        out = {}
        bcjr.bcjr_half.launches = 0
        out["kernel"] = turbo.turbo_decode(llr, K, its, True)
        if bcjr.bcjr_half.launches != 2 * its + 1:
            raise AssertionError(f"a decode launched {bcjr.bcjr_half.launches} BCJR passes")
        t_dec = cuda_ms(lambda: out.__setitem__("kernel", turbo.turbo_decode(llr, K, its, True)),
                        5)
        # the decode's one-time set-up beside its 2·its + 1 passes
        n_kern = count_kernels(lambda: turbo.turbo_decode(llr, K, its, True))
        if n_kern > 2 * its + 1 + 10:
            raise AssertionError(f"a decode launched {n_kern} kernels, {2 * its + 1} of them "
                                 f"BCJR passes: its set-up takes more than 10")
        kernel_half = turbo.bcjr_half
        try:
            turbo.bcjr_half = bcjr.bcjr_half_plain
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out["plain"] = turbo.turbo_decode(llr, K, its, True)
            e1.record()
            torch.cuda.synchronize()
            t_plain = e0.elapsed_time(e1)
        finally:
            turbo.bcjr_half = kernel_half
        ber = (out["kernel"] != bits).float().mean().item()
        if not torch.equal(out["kernel"], out["plain"]):
            raise AssertionError(f"a decode of {n_blk} x K {K} through turbo_bcjr differs from "
                                 f"the plain decode in {(out['kernel'] != out['plain']).sum()} bits")
        lo, hi = ber_band(JAX_DECODE_BER[K], n_blk)
        if not lo <= ber <= hi:
            raise AssertionError(f"a decode of {n_blk} x K {K} at sigma {sigma}: BER {ber:.6g} "
                                 f"outside the JAX package's band [{lo:.6g}, {hi:.6g}]")
        decode_rows.append({"path": name, "n_blocks": n_blk, "K": K, "ms": t_dec,
                            "plain_ms": t_plain, "launches": 2 * its + 1, "kernels": n_kern,
                            "ber": ber})
        print(f"[{card}] turbo_decode {n_blk} blocks x K {K}, {its} max-log iterations: "
              f"{t_dec:.4f} ms through turbo_bcjr ({2 * its + 1} launches, {n_kern} kernels in "
              f"all), plain {t_plain:.1f} ms, equal bits; BER {ber:.6g} at sigma {sigma} (JAX "
              f"{JAX_DECODE_BER[K]['mean']:.6g}, band [{lo:.6g}, {hi:.6g}])")
        del bits, llr, out
        torch.cuda.empty_cache()

    # -- 7. the command-line interface -------------------------------------
    clear_link_cache()
    cli_gemms, cli_passes = cli_on_card(card, zero_counts)
    launches["tf32x3"] += sum(cli_gemms.values())
    launches_by_path.update({f"cli/{name}": n for name, n in cli_gemms.items()})
    bcjr_launches_by_path.update({f"cli/{name}": n for name, n in cli_passes.items()})
    clear_link_cache()
    torch.cuda.empty_cache()

    # -- 8. N processes over torch.distributed, the bit library, the cost model
    native_on_host(card)
    mp_gemms, mp_passes = multiprocess_on_card(card, zero_counts, ms_step["tf32x3"])
    launches["tf32x3"] += sum(mp_gemms.values())
    launches_by_path.update(mp_gemms)
    bcjr_launches_by_path.update(mp_passes)
    clear_link_cache()
    torch.cuda.empty_cache()

    ms = dict.fromkeys(TOL, 0.0)
    plain_ms = dict.fromkeys(TOL, 0.0)
    bounds = dict.fromkeys(TOL, 0.0)
    bound_by = {kernel: {"bytes": 0.0, "operations": 0.0} for kernel in TOL}
    by_shape = {kernel: [] for kernel in TOL}
    library_ms = 0.0
    for name, (a, b, bsum) in {**gemms, **new_gemms, **coded_gemms}.items():
        M, K, N = mkn(a, b)
        # the library call: one cuBLAS cgemm on interleaved complex64; the
        # planar -> interleaved conversion happens here, outside the timing
        ac = torch.complex(a.re, a.im).reshape(M, K).contiguous()
        bc = torch.complex(b.re, b.im).contiguous()
        runs = {"plain": lambda: cmatmul_plain(a, b),
                "plain_gauss": lambda: cmatmul_plain(a, b, gauss=True),
                "library": lambda: torch.matmul(ac, bc)}
        for kernel in HIGHEST:
            runs[kernel] = (lambda kernel=kernel: run_kernel(kernel, a, b, bsum))
        # one interleaved sequence, there and back; each time is its mean
        t = dict.fromkeys(runs, 0.0)
        for which in list(runs) + list(reversed(runs)):
            t[which] += cuda_ms(runs[which], 10, run_ahead=True) / 2
        library_ms += t["library"]
        for kernel in HIGHEST:
            plain = t["plain_gauss" if GAUSS[kernel] else "plain"]
            bound, by = bound_ms(kernel, M, K, N)
            ms[kernel] += t[kernel]
            plain_ms[kernel] += plain
            bounds[kernel] += bound
            bound_by[kernel][by] += bound
            by_shape[kernel].append({"gemm": name, "M": M, "K": K, "N": N, "ms": t[kernel],
                                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                                     "library_ms": t["library"]})
            fl = (6 if GAUSS[kernel] else 8) * M * K * N
            print(f"[{card}] gemm {name} {kernel} ({M}x{K})@({K}x{N}): kernel "
                  f"{t[kernel]:.4f} ms ({fl / t[kernel] / 1e9:.1f} TFLOP/s fp32-equivalent), "
                  f"plain {plain:.4f} ms, library cgemm {t['library']:.4f} ms, bound "
                  f"{bound:.4f} ms by {by} (share reached {bound / t[kernel]:.3f})")
        del ac, bc
        torch.cuda.empty_cache()

    # -- 9. the `high` (TF32) and `default` (bf16) precisions ---------------
    t_phase = time.perf_counter()
    print(f"phase 9: the GEMMs at `high` ({', '.join(PRECISION_KERNELS[:2])}) and `default` "
          f"({', '.join(PRECISION_KERNELS[2:])})")
    launches.update(dict.fromkeys(PRECISION_KERNELS, 0))
    prec_launches = {kernel: {} for kernel in ("tf32x3",) + PRECISION_KERNELS}
    kernel_lib = _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for precision, (source, _) in WGMMA_SOURCES.items():
        smem = getattr(kernel_lib, f"cmatmul_{_kernel_for(False, 'tc', precision)}_smem_bytes")
        print(f"`{precision}` kernels (csrc/{source}) registers and spill (ptxas): "
              f"{wgmma_registers(_build.build_log, precision)}; dynamic shared memory a block: "
              f"4-dot {smem(0)} B, Gauss {smem(1)} B")

    # (a) each kernel against the plain version that rounds as it does, and
    # against the exact product of the unrounded operands within the bound
    # that its rounding allows (ops.cmatmul.rounding_bound, elementwise)
    bound_share = dict.fromkeys(PRECISION_KERNELS, 0.0)
    for name, (a, b, _) in {**gemms, **new_gemms, **coded_gemms, **ragged}.items():
        M, K, N = mkn(a, b)
        a2 = C(a.re.reshape(M, K), a.im.reshape(M, K))
        # the workspace that the wgmma kernels ask for, against its formula
        lda = _ld(a2.re)
        for kernel in PRECISION_KERNELS:
            splits = getattr(kernel_lib, f"cmatmul_{kernel}_splits")(M, N, K, sms)
            got = getattr(kernel_lib, f"cmatmul_{kernel}_workspace")(
                a2.re.data_ptr(), a2.im.data_ptr(), lda, M, N, K, splits)
            want = wgmma_workspace_floats(M, N, K, GAUSS[kernel],
                                          wgmma_a_needs_copy(a2.re, a2.im, lda), splits,
                                          PRECISION[kernel])
            if got != want:
                raise AssertionError(f"{kernel} at {name}: workspace {got} floats, the "
                                     f"formula {want}")
        zero_counts()
        outs = {kernel: run_kernel(kernel, a, b, None).reshape(M, N)
                for kernel in PRECISION_KERNELS}
        torch.cuda.synchronize()
        if [cmatmul.launches_by_kernel[k] for k in PRECISION_KERNELS] != [1] * 4 \
                or cmatmul.launches != 4 or cmatmul.copies:
            raise AssertionError(f"phase 9 at {name}: launches {cmatmul.launches_by_kernel}, "
                                 f"copies {cmatmul.copies}")
        rows = max(1, min(M, (1 << 26) // N))
        err, ref_max, err64, share = ({k: 0.0 for k in PRECISION_KERNELS} for _ in range(4))
        scale = 0.0
        for r0 in range(0, M, rows):
            ab = C(a2.re[r0:r0 + rows], a2.im[r0:r0 + rows])
            exact = c128(ab) @ c128(b)
            mag = (ab.re.abs() + ab.im.abs()).double() @ (b.re.abs() + b.im.abs()).double()
            scale = max(scale, exact.abs().max().item())
            for kernel in PRECISION_KERNELS:
                out = C(outs[kernel].re[r0:r0 + rows], outs[kernel].im[r0:r0 + rows])
                ref = PLAIN[kernel](ab, b)
                err[kernel] = max(err[kernel], max_diff(out, ref))
                ref_max[kernel] = max(ref_max[kernel], plane_max(ref))
                d = torch.maximum((out.re.double() - exact.real).abs(),
                                  (out.im.double() - exact.imag).abs())
                err64[kernel] = max(err64[kernel], d.max().item())
                bound = rounding_bound(PRECISION[kernel], GAUSS[kernel], K) * mag
                share[kernel] = max(share[kernel], (d / bound.clamp_min(1e-300)).max().item())
                del out, ref, d, bound
            del exact, mag
        print(f"check {name} (M={M}, K={K}, N={N}, a strides {tuple(a.re.stride())}): " +
              "; ".join(f"{k} vs plain max|d|/max|C| {err[k] / ref_max[k]:.3e} (tol "
                        f"{TOL[k]:.0e}), vs float64 {err64[k] / scale:.3e}, |d| over its "
                        f"rounding bound ({rounding_bound(PRECISION[k], GAUSS[k], K):.3e}·"
                        f"(|Ar|+|Ai|)(|Br|+|Bi|)) at most {share[k]:.3f}"
                        for k in PRECISION_KERNELS))
        for kernel in PRECISION_KERNELS:
            max_err[kernel] = max(max_err[kernel], err[kernel])
            bound_share[kernel] = max(bound_share[kernel], share[kernel])
            if not err[kernel] <= TOL[kernel] * ref_max[kernel] or not share[kernel] <= 1.0:
                raise AssertionError(f"kernel {kernel} at {name}: max|d|/max|C| "
                                     f"{err[kernel] / ref_max[kernel]:.3e} against its plain "
                                     f"version (tol {TOL[kernel]:.0e}), {share[kernel]:.3f} of "
                                     f"its rounding bound against float64")
        del outs
        torch.cuda.empty_cache()
    print("phase 9 (a): the largest |d| against float64 over its rounding bound, every shape: " +
          ", ".join(f"{k} {v:.4f}" for k, v in bound_share.items()))
    # the flagship's own TX and RX data operands over 8 draws of its bits
    for (name, kernel), e in draw_errors(PRECISION_KERNELS, 8, card, dev).items():
        if not e <= TOL[kernel]:
            raise AssertionError(f"{kernel} at the flagship's {name}: max|d|/max|C| {e:.3e} "
                                 f"over 8 draws, against its tolerance {TOL[kernel]:.0e}")
    a, b, _ = gemms["rx_pilot"]
    M, K, N = mkn(a, b)
    for kernel in PRECISION_KERNELS:
        splits = getattr(_build.library(), f"cmatmul_{kernel}_splits")(
            M, N, K, torch.cuda.get_device_properties(dev).multi_processor_count)
        first, second = run_kernel(kernel, a, b, None), run_kernel(kernel, a, b, None)
        torch.cuda.synchronize()
        same = torch.equal(first.re, second.re) and torch.equal(first.im, second.im)
        print(f"determinism rx_pilot {kernel}: K split {splits} ways, two runs identical: "
              f"{same}")
        if splits < 2 or not same:
            raise AssertionError(f"the split-K pilot GEMM through {kernel} is not split or "
                                 f"not reproducible")

    # (b) the paths: every path and the flagship under `default` in the 4-dot
    # form; the flagship, the multipath link and the coded link under `high`
    # in both forms and `default` in the Gauss form. Phase 5's bits and draws.
    main_spec = dict(kind="siso", kw={}, snr=15.0, ber60=0.0, launches=3)

    def prec_path(name: str, plink, precision: str, form: str) -> None:
        spec = main_spec if name == "main" else PATHS[name]
        kernel = _kernel_for(form == "gauss", "tc", precision)
        is_coded = spec["kind"] == "coded"
        clean = CODED_CLEAN_SNR if is_coded else 60.0
        nb = n_bits if name == "main" else path_bits(name)
        zero_counts()
        bers, blers = {}, {}
        with precision_knobs(precision, form):
            for step, snr in enumerate((clean, spec["snr"])):
                bits = random_bits(LANES, 300 + step, nb)
                gen.manual_seed(400 + step)
                r = (plink(bits, snr, generator=gen) if name == "main"
                     else run_path(plink, name, bits, snr))
                if r.bits_rx.shape != bits.shape or r.ber.shape != (LANES,) \
                        or not torch.isfinite(r.ber).all():
                    raise AssertionError(f"{name} at {precision}/{form}: bits_rx "
                                         f"{r.bits_rx.shape}, ber {r.ber.shape}")
                bers[snr] = r.ber.mean().item()
                if is_coded:
                    passed = (r.crc_pass_stage if hasattr(r, "crc_pass_stage")
                              else r.crc_pass[:, None])
                    blers[snr] = (1.0 - passed.float().mean(dim=0)).tolist()
        counts = dict(cmatmul.launches_by_kernel)
        n_bcjr, copies = bcjr.bcjr_half.launches, cmatmul.copies
        launches[kernel] += counts[kernel]
        prec_launches[kernel][f"prec/{precision}/{name}"] = counts[kernel]
        lo, hi = BER_15DB if name == "main" else ber_band(JAX_BER[name], LANES)
        sigma = (hi - lo) / 8 if name == "main" else \
            JAX_BER[name]["lane_std"] * np.sqrt(1 / JAX_BER[name]["lanes"] + 1 / LANES)
        excluded = precision == "default" and name in DEFAULT_EXCLUDED
        ber = bers[spec["snr"]]
        extra = ""
        if is_coded:
            bands = [bler_band(q, LANES, JAX_BER[name]["lanes"]) for q in JAX_BER[name]["bler"]]
            extra = (f", BLER@{clean:g}dB {blers[clean]}, BLER@{spec['snr']:g}dB by stage "
                     f"{[round(q, 6) for q in blers[spec['snr']]]} (bands "
                     f"{[(round(float(x), 4), round(float(y), 4)) for x, y in bands]}), BCJR "
                     f"launches {n_bcjr}")
            if any(blers[clean]) or bers[clean] != 0.0 or n_bcjr != 2 * spec["bcjr"] \
                    or len(bands) != len(blers[spec["snr"]]) or not all(
                        x <= q <= y for q, (x, y) in zip(blers[spec["snr"]], bands)):
                raise AssertionError(f"{name} at {precision}/{form}: BLER {blers}, "
                                     f"BER {bers}, {n_bcjr} BCJR launches")
        print(f"path {name} at {precision}/{form}: BER@{clean:g}dB {bers[clean]:.6g} (at most "
              f"{spec['ber60']}), BER@{spec['snr']:g}dB {ber:.6g} (band [{lo:.6g}, {hi:.6g}], "
              f"sigma {sigma:.4g}, {(ber - (lo + hi) / 2) / sigma:+.2f} sigma from its centre)"
              f"{' EXCLUDED from the band (DEFAULT_EXCLUDED)' if excluded else ''}{extra}, "
              f"launches {kernel} {counts[kernel]}, copies {copies}")
        if spec["ber60"] is not None and not bers[clean] <= spec["ber60"]:
            raise AssertionError(f"{name} at {precision}/{form}: BER {bers[clean]} at {clean} "
                                 f"dB, over {spec['ber60']}")
        if not excluded and not lo <= ber <= hi:
            raise AssertionError(f"{name} at {precision}/{form}: BER {ber} outside [{lo}, {hi}]")
        if counts[kernel] != 2 * spec["launches"] \
                or sum(counts.values()) != counts[kernel] or copies != 2 * spec.get("copies", 0):
            raise AssertionError(f"{name} at {precision}/{form}: launches {counts}, copies "
                                 f"{copies}; expected {2 * spec['launches']} of {kernel} alone")

    repeated = ("main", "lte_rayleigh_mp", "coded_6000_awgn")
    combos = (("default", "fma4"), ("high", "fma4"), ("high", "gauss"), ("default", "gauss"))
    for name in ("main", *PATHS):
        plink = link if name == "main" else path_link(name)
        for precision, form in (combos if name in repeated else combos[:1]):
            prec_path(name, plink, precision, form)
        del plink
        torch.cuda.empty_cache()

    # the flagship's decisions at `high` and `default` against `highest`'s,
    # under the same bits and draws
    for snr, seed in ((15.0, 900), (60.0, 901)):
        bits = random_bits(LANES, seed)
        decided = {}
        for precision in ("highest", "high", "default"):
            gen.manual_seed(seed + 50)
            zero_counts()
            with precision_knobs(precision, "fma4"):
                decided[precision] = link(bits, snr, generator=gen).bits_rx
            kernel = _kernel_for(False, "tc", precision)
            launches[kernel] += cmatmul.launches_by_kernel[kernel]
            prec_launches[kernel][f"prec/{precision}/main_{snr:g}dB"] = \
                cmatmul.launches_by_kernel[kernel]
            if cmatmul.launches_by_kernel[kernel] != 3 or cmatmul.launches != 3:
                raise AssertionError(f"the flagship at {precision}: launches "
                                     f"{cmatmul.launches_by_kernel}")
        shares = {p: (decided[p] != decided["highest"]).float().mean().item()
                  for p in ("high", "default")}
        print(f"flagship at {snr:g} dB, {LANES} lanes, same bits and draws: share of bit "
              f"decisions that differ from `highest`: " +
              ", ".join(f"{p} {v:.3e}" for p, v in shares.items()))
        if snr == 60.0 and any(shares.values()):
            raise AssertionError(f"the flagship at 60 dB decides otherwise than at `highest`: "
                                 f"{shares}")

    # (c) VALIDATION.md's anchors at each precision, same bits and draws
    for mod, bw, snr, n_sym in ANCHORS:
        cfg_a = LTEConfig(bw, modulation=mod)
        link_a = siso.SisoLink(cfg_a, device=dev)
        nb = siso.bits_per_frame(cfg_a, n_sym)
        bits = random_bits(LANES, 950, nb)
        total = LANES * nb
        ber = {}
        for precision in ("highest", "high", "default"):
            gen.manual_seed(951)
            with precision_knobs(precision, "fma4"):
                ber[precision] = link_a(bits, snr, generator=gen).bit_errors.sum().item() / total
        sigma = float(np.sqrt(ber["highest"] * (1 - ber["highest"]) / total))
        deltas = {p: (ber[p] - ber["highest"]) / sigma for p in ("high", "default")}
        print(f"anchor {mod} {bw:g} MHz {snr:g} dB, {n_sym} symbols x {LANES} lanes "
              f"({total} bits): BER highest {ber['highest']:.6g}, high {ber['high']:.6g} "
              f"({deltas['high']:+.3f} sigma), default {ber['default']:.6g} "
              f"({deltas['default']:+.3f} sigma); sigma {sigma:.3e}")
        if any(abs(v) > 4.0 for v in deltas.values()):
            raise AssertionError(f"anchor {mod} {bw:g} MHz {snr:g} dB: BER moves {deltas} "
                                 f"sigma from `highest` under the same bits and draws")
        del link_a
    clear_link_cache()
    torch.cuda.empty_cache()

    # (d) times: the flagship step at each precision and form, in turns there
    # and back; each GEMM shape through each kernel beside its bound, its
    # plain version and the library call of the same precision
    pool = [random_bits(LANES, 1000 + i) for i in range(STEPS)]
    settings = [(p, f) for p in ("highest", "high", "default") for f in ("fma4", "gauss")]
    cuda_ms(step, STEPS)
    passes = {c: [] for c in settings}
    for c in settings + settings[::-1]:
        with precision_knobs(*c):
            passes[c].append(cuda_ms(step, STEPS))
    step_ms = {c: sum(ts) / len(ts) for c, ts in passes.items()}
    for (p, f), t in step_ms.items():
        print(f"[{card}] main path 20 MHz 64-QAM at {p}/{f}, {LANES} lanes: {t:.4f} ms/step "
              f"(passes {passes[p, f][0]:.4f}, {passes[p, f][1]:.4f}), "
              f"{LANES / (t / 1e3):.1f} frames/s, {t / step_ms['highest', 'fma4']:.4f} of "
              f"highest/fma4's")
    del pool

    @contextlib.contextmanager
    def library_precision(precision: str):
        """torch.matmul's own knobs for one library call at `precision`."""
        saved = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
        if precision == "high":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("medium")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(saved[1])
            torch.backends.cuda.matmul.allow_tf32 = saved[0]

    # which cuBLAS kernels the library calls run at the TX shape, traced in a
    # fresh interpreter (in this one, after the earlier phases, the trace
    # recorded no kernel); a complex64 product that runs no bf16 kernel is no
    # `default` yardstick, and two bf16 stand-ins (bf16 out) take its place:
    # four real products of the rounded planes, and one product of the real
    # block form [Ar | Ai] (M, 2K') @ [[Br, Bi], [-Bi, Br]] (2K', 2N'), K and N
    # padded to multiples of 8 with zeros (built outside the timed window);
    # at each shape the faster is the yardstick
    M, K, N = mkn(*gemms["tx"][:2])
    lib_names = library_kernel_names(M, K, N)
    for setting, names in lib_names.items():
        print(f"library kernels at ({M}x{K})@({K}x{N}), {setting}: {names or 'none traced'}")
    complex_bf16 = any("bf16" in n.lower() for n in lib_names["complex64 at default"])
    print("library at default: " + (
        "the complex64 product under float32 matmul precision medium" if complex_bf16
        else "the faster of four real bf16 torch.matmuls and one of the real block form (bf16 "
             "out), since the complex64 product under float32 matmul precision medium ran no "
             "bf16 kernel"))
    library_ms_at = {"high": 0.0, "default": 0.0}
    library_default_by_shape = []
    for name, (a, b, _) in {**gemms, **new_gemms, **coded_gemms}.items():
        M, K, N = mkn(a, b)
        ac = torch.complex(a.re, a.im).reshape(M, K).contiguous()
        bc = torch.complex(b.re, b.im).contiguous()

        def library_high():
            with library_precision("high"):
                return torch.matmul(ac, bc)

        runs = {"library_high": library_high}
        if complex_bf16:
            def library_complex():
                with library_precision("default"):
                    return torch.matmul(ac, bc)
            runs["library_complex"] = library_complex
        else:
            runs.update(bf16_stand_ins(C(a.re.reshape(M, K), a.im.reshape(M, K)), b))
        stand_ins = [which for which in runs if which != "library_high"]
        for kernel in PRECISION_KERNELS:
            runs[kernel] = lambda kernel=kernel: run_kernel(kernel, a, b, None)
            runs["plain_" + kernel] = lambda kernel=kernel: PLAIN[kernel](a, b)
        t = dict.fromkeys(runs, 0.0)
        for which in list(runs) + list(reversed(runs)):
            t[which] += cuda_ms(runs[which], 5, run_ahead=True) / 2
        faster = min(stand_ins, key=t.get)
        t["library_default"] = t[faster]
        library_default_by_shape.append({"gemm": name, **{w: t[w] for w in stand_ins},
                                         "yardstick": faster})
        print(f"[{card}] gemm {name} library at default: " +
              ", ".join(f"{w} {t[w]:.4f} ms" for w in stand_ins) + f"; the yardstick: {faster}")
        for precision in library_ms_at:
            library_ms_at[precision] += t["library_" + precision]
        for kernel in PRECISION_KERNELS:
            lib = t["library_" + PRECISION[kernel]]
            bound, by = bound_ms(kernel, M, K, N)
            ms[kernel] += t[kernel]
            plain_ms[kernel] += t["plain_" + kernel]
            bounds[kernel] += bound
            bound_by[kernel][by] += bound
            by_shape[kernel].append({"gemm": name, "M": M, "K": K, "N": N, "ms": t[kernel],
                                     "plain_ms": t["plain_" + kernel], "bound_ms": bound,
                                     "bound_by": by, "library_ms": lib})
            print(f"[{card}] gemm {name} {kernel} ({M}x{K})@({K}x{N}): kernel "
                  f"{t[kernel]:.4f} ms, plain {t['plain_' + kernel]:.4f} ms, library "
                  f"{lib:.4f} ms, bound {bound:.4f} ms by {by} (share reached "
                  f"{bound / t[kernel]:.3f})")
        del ac, bc, runs
        torch.cuda.empty_cache()
    print(f"[{card}] phase 9: {time.perf_counter() - t_phase:.2f} s wall")

    sources = {"tf32x3": ("cmatmul_tf32x3", "cmatmul_tc.cu", "41"),
               "tf32x3_gauss": ("cmatmul_tf32x3_gauss", "cmatmul_tc_gauss.cu", "56"),
               "f32_fma4": ("cmatmul_f32 (fma4)", "cmatmul.cu", "41"),
               "f32_gauss": ("cmatmul_f32 (gauss)", "cmatmul.cu", "56"),
               "tf32": ("cmatmul_tf32", "cmatmul_wgmma_tf32.cu", "41"),
               "tf32_gauss": ("cmatmul_tf32_gauss", "cmatmul_wgmma_tf32.cu", "56"),
               "bf16": ("cmatmul_bf16", "cmatmul_bf16.cu", "41"),
               "bf16_gauss": ("cmatmul_bf16_gauss", "cmatmul_bf16.cu", "56")}
    kernels = [{
        "name": sources[kernel][0],
        "route": "cuda",
        "source": "ofdm_lte_tpu_torch/csrc/" + sources[kernel][1],
        "replaces": "ofdm_lte_tpu/ops/pallas_kernels.py:" + sources[kernel][2],
        "launches": launches[kernel],
        "max_abs_err": max_err[kernel],
        "ms": ms[kernel],
        "plain_ms": plain_ms[kernel],
        "bound_ms": bounds[kernel],
        # of the summed bound, the kind that makes up more of it
        "bound_by": max(bound_by[kernel], key=bound_by[kernel].get),
        "library_ms": library_ms if PRECISION[kernel] == "highest"
        else library_ms_at[PRECISION[kernel]],
        **({"library_default_by_shape": library_default_by_shape}
           if PRECISION[kernel] == "default" else {}),
        "launches_by_path": {**{p: n for p, n in launches_by_path.items()
                                if p == f"main/{kernel}"
                                or (kernel == "tf32x3" and not p.startswith("main/"))},
                             **prec_launches.get(kernel, {})},
        "precision": PRECISION[kernel],
        # phase 9's flagship step at the kernel's precision and form
        "main_step_ms": {f"{p}/{f}": t for (p, f), t in step_ms.items()
                         if TENSOR_CORE[kernel] and p == PRECISION[kernel]
                         and (f == "gauss") == GAUSS[kernel]},
        "by_shape": by_shape[kernel],
    } for kernel in TOL]
    ext_rows = [row for row in bcjr_rows if row["mode"] == "extrinsic"]
    kernels.append({
        "name": "turbo_bcjr",
        "route": "cuda",
        "source": "ofdm_lte_tpu_torch/csrc/turbo_bcjr.cu",
        "replaces": "ofdm_lte_tpu/coding/turbo.py:424",
        "launches": sum(bcjr_launches_by_path.values()),
        "max_abs_err": max(bcjr_err.values()),
        "max_abs_err_by_semiring": {"max_log": bcjr_err[True], "log_map": bcjr_err[False]},
        # the mode the decoder runs, summed over the two shapes
        "ms": sum(row["ms"] for row in ext_rows),
        "plain_ms": sum(row["plain_ms"] for row in ext_rows),
        "bound_ms": sum(row["bound_ms"] for row in ext_rows),
        # of the summed bound, the kind that makes up more of it
        "bound_by": max(("bytes", "operations"), key=lambda by: sum(
            row["bound_ms"] for row in ext_rows if row["bound_by"] == by)),
        "library_ms": None,
        "launches_by_path": bcjr_launches_by_path,
        "modes_checked": ["app", "extrinsic/pi", "extrinsic/pi_inv", "extrinsic/none",
                          "hard/pi_inv"],
        "by_shape": bcjr_rows,
        "decode_by_shape": decode_rows,
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
