"""link.kernels_per_call: the device kernels that the sweep launches a call
(kernels). The metrics' window (the card alone) holds every kernel of its
calls, the harness's input draw among them; the breakdown's window (host
ops too) ties each kernel to the host op that launched it, and the draw's
kernels, the count most of its spans launch (the profiler may miss a
launch at a window's edge), are taken out of each call. An exact count of
what the host enqueues a call; it sets the pace where the host does. A
breakdown window whose draw launched no kernel lost the launches: a lost
trace, never a guess."""
from collections import Counter


def read(ctx):
    t, h = ctx.trace, ctx.host_trace
    if t.calls == 0 or h is None:
        return None
    counts = Counter(h.kernels_each_span(ctx.draw_span))
    draw = max(counts.items(), key=lambda kv: (kv[1], kv[0]))[0] if counts else 0
    if draw == 0:
        raise ctx.LostTrace("the breakdown window ties no kernel to the input draw")
    return len(t.kernels) / t.calls - draw
