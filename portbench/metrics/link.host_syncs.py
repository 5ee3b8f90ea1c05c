"""link.host_syncs: the times a sweep call makes the host wait for the
card, counted as the program's `link.host_sync` spans a call
(ofdm_lte_tpu_torch/utils/profiling.span) in the breakdown's window: the
copies of the counts to the host and the pageable copy of the SNR points
to the card. Each one drains the card's queue, so the host cannot run
ahead into the next call. A window with kernels and no `link.` span lost
the trace: it raises, never reads 0. A program without `span` marks no
stage, and reads nothing.
"""
from harness.spans import program_marks_stages

SYNC, LAYER = "link.host_sync", "link."


def read(ctx):
    h = ctx.host_trace
    if h is None or h.calls == 0 or not h.kernels or not program_marks_stages():
        return None
    names = [name for name, _, _ in h.host]
    if not any(n.startswith(LAYER) for n in names):
        raise ctx.LostTrace(f"the breakdown window holds {len(h.kernels)} kernels and no "
                            f"`{LAYER}*` span")
    return names.count(SYNC) / h.calls
