"""detector_roofline: the least time of a call's MIMO detection over the
device time of the kernels launched inside the program's `detector.*`
spans (detector.device_ms), in %.

The work, one count whatever implements the detector: at each (lane,
symbol, layer bin) site the detector must read what the link hands it,
the num_rx received planes and the num_rx × rank effective-channel planes
of complex fp32 (8 B each: 160 B a site at 4 × 4, rank 4), and compute
the Gram matrix's rank(rank+1)/2 entries and the matched filter's rank,
each num_rx complex multiply-adds of 8 flops (448 flops a site at 4 × 4,
rank 4). The least time is the larger of the bytes at the HBM rate and
the flops at the fp32 rate (harness/peaks). Only those reads and that
arithmetic are credited: the solves, the SIC stages, the hard decisions
and every write are work the count leaves out, so the share cannot pass
100% whatever implements the detector. At 256 lanes × 14 symbols × 250
layer bins: 143.36 MB, 0.0428 ms.
"""
from pathlib import Path

from harness.core import load_module

_device_ms = load_module(Path(__file__).with_name("detector.device_ms.py"),
                         "portbench_metric_detector_device_ms_")

COMPLEX_BYTES = 8
CMAC_FLOPS = 8


def sites(shape) -> int:
    return shape.lanes * shape.symbols * shape.m


def detector_bytes(shape) -> float:
    return float(sites(shape) * COMPLEX_BYTES * shape.num_rx * (1 + shape.rank))


def detector_flops(shape) -> float:
    L = shape.rank
    return float(sites(shape) * CMAC_FLOPS * shape.num_rx * (L * (L + 1) // 2 + L))


def bound_s(shape, peaks) -> float:
    return max(detector_bytes(shape) / peaks["hbm_bytes_per_s"],
               detector_flops(shape) / peaks["fp32_flops"])


def read(ctx):
    ms = _device_ms.read(ctx)
    if ms is None or ms <= 0.0:
        return None
    return 100.0 * bound_s(ctx.shape, ctx.peaks) / (ms * 1e-3)
