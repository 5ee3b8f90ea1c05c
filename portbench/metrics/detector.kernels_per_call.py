"""detector.kernels_per_call: the device kernels that the program launches
inside its `detector.*` spans a call (kernels), in the breakdown's window
(host ops recorded), where each kernel is tied to the host span that
launched it by the launch's correlation id. The detector's chain of small
elementwise launches is what the host enqueues while the card waits; a
fused detector shows here first. A window with kernels and no `detector.`
span lost the trace: it raises, never reads 0. A program that does not
mark the `detector` layer (utils/profiling.LAYERS) reads nothing.
"""
from pathlib import Path

from harness.core import load_module

PREFIX = "detector."
_device_ms = load_module(Path(__file__).with_name("detector.device_ms.py"),
                         "portbench_metric_detector_device_ms_")


def read(ctx):
    h = ctx.host_trace
    if (h is None or h.calls == 0 or not h.kernels
            or not _device_ms.program_marks_detector()):
        return None
    spans = sorted((s, s + d) for name, s, d in h.host if name.startswith(PREFIX))
    if not spans:
        raise ctx.LostTrace(f"the breakdown window holds {len(h.kernels)} kernels and no "
                            f"`{PREFIX}*` span")
    inside = sum(1 for t in h.launched if t is not None and any(a <= t <= b for a, b in spans))
    return inside / h.calls
