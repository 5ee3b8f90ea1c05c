"""modem.device_ms: the device time, a call, of the kernels that the
program launches inside its `modem.*` spans (QAM map, the TX IDFT, PAPR,
the RX DFTs, estimation and ZF, the demap), the GEMM kernels among them, in ms.

Read from the breakdown's window by harness/spans.py. A window with kernels and no
`modem.` span lost the trace: it raises, never reads 0. A program
without `span` marks no stage, and reads nothing.
"""
from harness.spans import read_device_ms

PREFIX = "modem."


def read(ctx):
    return read_device_ms(ctx, PREFIX)
