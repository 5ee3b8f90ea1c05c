"""turbo_bcjr_roofline: the least time of the BCJR work that the traced
calls' results show was needed, over the device time of every kernel of
ofdm_lte_tpu_torch/csrc/turbo_bcjr.cu in the traced window, in %.

The work: each transmission that a transport block needed (the sweep's
`ntx`, summed over the points of every traced call) is one decode of
2·num_iterations extrinsic passes over each code block's K + 3 trellis
steps (harness/costs.harq_bcjr_steps); a step's least time is the larger
of 109 operations at the fp32 rate and 16 B at the HBM rate
(costs.bcjr_bound_s). One count whatever implements the decode, and it
cannot pass 100%: a lane decoded again after its CRC passed, and the hard-
decision pass, are work that it does not credit. A window with no BCJR
kernel while the port's counters `bcjr_half.launches` or
`bcjr_app.launches` counted launches is a lost trace, never a 0.
"""
import re

import numpy as np

PATTERNS = (r"\bbcjr_kernel\b",)
COUNTERS = ("bcjr_half.launches", "bcjr_app.launches")


def matches(name: str) -> bool:
    return any(re.search(p, name) for p in PATTERNS)


def bound_s(ctx) -> float:
    """The least time of the traced calls' needed BCJR work."""
    ntx = sum(int(np.sum(r["ntx"])) for r in ctx.results)
    steps = ctx.costs.harq_bcjr_steps(ntx, ctx.shape.block_sizes,
                                      ctx.cell.traffic["num_iterations"])
    return ctx.costs.bcjr_bound_s(steps, ctx.peaks)


def read(ctx):
    t = ctx.trace
    dev = t.kernel_time_s(matches)
    if dev == 0.0:
        launched = sum(t.counters.get(c, 0) for c in COUNTERS)
        if launched:
            raise ctx.LostTrace(f"the decoder counted {launched} BCJR launches and the trace "
                                "holds none of its kernels")
        return None
    if len(ctx.results) != t.calls:
        raise ctx.LostTrace(f"{t.calls} traced calls and {len(ctx.results)} results")
    return 100.0 * bound_s(ctx) / dev
