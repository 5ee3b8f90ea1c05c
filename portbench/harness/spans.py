"""What the span readers share: whether the program marks its stages, and
the device time of the kernels launched inside a layer's spans.

The spans are the program's (ofdm_lte_tpu_torch/utils/profiling.span),
recorded in the breakdown's window (host ops recorded), where each kernel
is tied to the host span that launched it by the launch's correlation id;
the kernels' durations are the card's own, so the host ops' profiling cost
does not bias them."""
import importlib


def program_marks_stages() -> bool:
    try:
        prof = importlib.import_module("ofdm_lte_tpu_torch.utils.profiling")
    except ImportError:
        return False
    return hasattr(prof, "span")


def device_ms_per_call(h, prefix: str, lost) -> float:
    """Device ms a call of the kernels launched inside host spans whose name
    starts with `prefix`; a window with no such span lost the trace."""
    spans = sorted((s, s + d) for name, s, d in h.host if name.startswith(prefix))
    if not spans:
        raise lost(f"the breakdown window holds {len(h.kernels)} kernels and no "
                   f"`{prefix}*` span")
    inside = sum(d for (_, _, d), t in zip(h.kernels, h.launched)
                 if t is not None and any(a <= t <= b for a, b in spans))
    return inside * 1e-3 / h.calls


def read_device_ms(ctx, prefix: str):
    """A `<layer>.device_ms` reading: None where there is nothing to read."""
    h = ctx.host_trace
    if h is None or h.calls == 0 or not h.kernels or not program_marks_stages():
        return None
    return device_ms_per_call(h, prefix, ctx.LostTrace)
