"""channel.device_ms: the device time, a call, of the kernels that the
program launches inside its `channel.*` spans (the AWGN σ measure and noise,
the Jakes tap product and the multipath FIR), in ms.

Read from the breakdown's window by harness/spans.py. A window with kernels and no
`channel.` span lost the trace: it raises, never reads 0. A program
without `span` marks no stage, and reads nothing.
"""
from harness.spans import read_device_ms

PREFIX = "channel."


def read(ctx):
    return read_device_ms(ctx, PREFIX)
