"""The traced windows: torch.profiler around a few tens of steady calls,
reduced to what the per-layer readers and the `breakdown` read.

Two windows a traced run. The metrics' window records the card alone
(CUDA activity), since recording every host op costs the host some µs an
op and would pass for idle time on the card; its window runs from the
first device event to the last, so it holds every gap between calls
and leaves out only the host's lead into the first. The breakdown's
window records the host's ops too, to name each idle gap.

The Chrome trace that torch.profiler exports is read back and deleted:
device events (categories `kernel`, `gpu_memcpy`, `gpu_memset`) and host
ops (`cpu_op`, `user_annotation`) on one clock. With host ops the window
is the span of the harness's own `portbench.window` annotation. Busy time
is the union of the device intervals inside it; an idle gap is a stretch
between them, named by the innermost host op that covers its midpoint
(what the host was doing while the card waited). A kernel is tied to the
host op that launched it by the launch's correlation id, so that the
kernels of a host span (the harness's draw) can be counted.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"


class Reduced:
    """A traced window: kernels [(name, start_us, dur_us)], every device
    interval, the window (start_us, end_us), the calls made in it, the host
    ops, the program's counters over it, and the host time at which each
    kernel was launched (None where the trace holds no launch for it)."""

    def __init__(self, kernels, device, window, calls, host=(), counters=None, launched=None):
        self.kernels = list(kernels)
        self.device = list(device)
        self.window = tuple(window)
        self.calls = int(calls)
        self.host = list(host)
        self.counters = dict(counters or {})
        self.launched = list(launched) if launched is not None else [None] * len(self.kernels)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        """The union of device intervals inside the window, merged."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(s + d, w1)) for _, s, d in self.device
                    if s + d > w0 and s < w1)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_time_s(self, matches) -> float:
        """Device seconds of the kernels whose name `matches` accepts."""
        return sum(d for n, _, d in self.kernels if matches(n)) * 1e-6

    def _in_span(self, span: str) -> list:
        """The kernels launched inside a host op named `span`."""
        spans = [(s, s + d) for name, s, d in self.host if name == span]
        return [k for k, t in zip(self.kernels, self.launched)
                if t is not None and any(a <= t <= b for a, b in spans)]

    def kernels_each_span(self, span: str) -> list:
        """The number of kernels launched inside each host op named `span`."""
        spans = sorted((s, s + d) for name, s, d in self.host if name == span)
        return [sum(1 for t in self.launched if t is not None and a <= t <= b)
                for a, b in spans]

    def kernel_time_in_span_s(self, span: str) -> float:
        return sum(d for _, _, d in self._in_span(span)) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for name, _, d in self.kernels:
            total[_short(name)] += d * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle stretches inside the window summed by what the host was
        doing, the longest first."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy_intervals() for x in iv] + [w1]
        total = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            inner = [h for h in host if h[1] <= mid <= h[1] + h[2]]
            label = min(inner, key=lambda h: h[2])[0] if inner else "host: between calls"
            total[_short(label)] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def reduce_chrome(events: list, calls: int, counters=None, device_window=False) -> Reduced:
    """A Reduced of the `traceEvents` of a Chrome trace; the window from the
    device events where `device_window` and the trace holds no host ops."""
    kernels, device, host, window = [], [], [], None
    kernel_ids, launches = [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((name, ts, dur))
            if cat == "kernel":
                kernels.append((name, ts, dur))
                kernel_ids.append(corr)
        elif cat in LAUNCH_CATS:
            if corr is not None:
                launches[corr] = ts
        elif cat in HOST_CATS:
            if name == WINDOW and cat == "user_annotation":
                window = (ts, ts + dur)
            else:
                host.append((name, ts, dur))
    if window is None and device_window and device:
        window = (min(s for _, s, _ in device), max(s + d for _, s, d in device))
    if window is None:
        raise RuntimeError(f"the trace holds no `{WINDOW}` annotation and no device event: "
                           "the profiler recorded nothing of the window")
    return Reduced(kernels, device, window, calls, host, counters,
                   [launches.get(c) for c in kernel_ids])


def trace_calls(run_call, calls: int, counters=None, host: bool = True, settle: int = 5):
    """Profile `calls` calls of run_call(i) on the card, and with `host` over
    the host's ops too, and reduce the trace. The first `settle` calls run
    under the profiler unrecorded (its schedule's warm-up), so that the
    profiler's start lies outside the window. `counters()` reads the program's counters, taken around
    the recorded calls alone; their difference is kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule
    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=settle, active=1, repeat=1)) as prof:
        for i in range(settle):
            run_call(i)
            prof.step()
        before = counters() if counters else {}
        with record_function(WINDOW):
            for i in range(settle, settle + calls):
                run_call(i)
        after = counters() if counters else {}
        prof.step()
    d = tempfile.mkdtemp(prefix="portbench_trace_")
    path = Path(d) / "trace.json"
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
        os.rmdir(d)
    return reduce_chrome(events, calls, {k: after[k] - before.get(k, 0) for k in after},
                         device_window=not host)
