"""modem.device_ms: the device time, a call, of the kernels that the
program launches inside its `modem.*` spans (QAM map, the TX IDFT, PAPR,
the RX DFTs, estimation and ZF, the demap), the GEMM kernels among them, in ms.

Read from the breakdown's window (host ops recorded), where each kernel is
tied to the host span that launched it by the launch's correlation id; the
kernels' durations are the card's own, so the host ops' profiling cost
does not bias them. The spans are the program's
(ofdm_lte_tpu_torch/utils/profiling.span). A window with kernels and no
`modem.` span lost the trace: it raises, never reads 0. A program
without `span` marks no stage, and reads nothing.
"""
import importlib

PREFIX = "modem."


def program_marks_stages() -> bool:
    try:
        prof = importlib.import_module("ofdm_lte_tpu_torch.utils.profiling")
    except ImportError:
        return False
    return hasattr(prof, "span")


def device_ms_per_call(h, prefix: str, lost) -> float:
    """Device ms a call of the kernels launched inside host spans whose name
    starts with `prefix`."""
    spans = sorted((s, s + d) for name, s, d in h.host if name.startswith(prefix))
    if not spans:
        raise lost(f"the breakdown window holds {len(h.kernels)} kernels and no "
                   f"`{prefix}*` span")
    inside = sum(d for (_, _, d), t in zip(h.kernels, h.launched)
                 if t is not None and any(a <= t <= b for a, b in spans))
    return inside * 1e-3 / h.calls


def read(ctx):
    h = ctx.host_trace
    if h is None or h.calls == 0 or not h.kernels or not program_marks_stages():
        return None
    return device_ms_per_call(h, PREFIX, ctx.LostTrace)
