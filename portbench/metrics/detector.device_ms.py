"""detector.device_ms: the device time, a call, of the kernels that the
program launches inside its `detector.*` spans (the spatial link's
effective channel and σ², and its MIMO detector: SIC, MMSE/ZF or the
stacked MRC and unbiased MMSE), in ms.

Read from the breakdown's window by harness/spans.py. A window with
kernels and no `detector.` span lost the trace: it raises, never reads 0.
A program that does not mark the `detector` layer (utils/profiling.LAYERS)
reads nothing.
"""
import importlib

from harness.spans import read_device_ms

PREFIX = "detector."


def program_marks_detector() -> bool:
    try:
        prof = importlib.import_module("ofdm_lte_tpu_torch.utils.profiling")
    except ImportError:
        return False
    return "detector" in getattr(prof, "LAYERS", ())


def read(ctx):
    if not program_marks_detector():
        return None
    return read_device_ms(ctx, PREFIX)
