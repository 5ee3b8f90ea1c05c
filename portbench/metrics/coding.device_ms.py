"""coding.device_ms: the device time, a call, of the kernels that the
program launches inside its `coding.*` spans (CRC attachment and check,
the turbo encoder, rate matching and de-matching, the turbo decoder with
its BCJR passes and the desegmenting gather, the HARQ combining), in ms.

Read from the breakdown's window by harness/spans.py. A window with
kernels and no `coding.` span lost the trace: it raises, never reads 0. A
program without `span` marks no stage, and reads nothing.
"""
from harness.spans import read_device_ms

PREFIX = "coding."


def read(ctx):
    return read_device_ms(ctx, PREFIX)
