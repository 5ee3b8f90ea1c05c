"""cmatmul_roofline: the least time of a call's complex products
(harness/costs.cgemm_bound_s: 6·m·k·n flops at the bf16 dense rate or
8 B a complex element of A, B and C at the HBM rate, whichever is longer),
times the calls, over the device time of the port's complex-GEMM kernels
in the traced window, in %.

The kernels are matched by name: every `__global__` of
ofdm_lte_tpu_torch/csrc/cmatmul*.cu, cmatmul_tc.cuh and wgmma_cmatmul.cuh,
the per-call operand preparation and copies among them, which are part of
a product. The products are those the cell's entry adapter counts a call
(`products`: one SISO link step over the call's lanes, with the Jakes tap
product over multipath; in the HARQ entry, one a transmission).
A window with no matching kernel while the port's counter
`cmatmul.launches` counted launches is a lost trace, never a 0.
"""
import re

PATTERNS = (r"\bcmatmul\w*_kernel\b", r"\bprep_[ab]_kernel\b", r"\bcopy_a_kernel\b",
            r"\bsplitk_sum_kernel\b")


def matches(name: str) -> bool:
    return any(re.search(p, name) for p in PATTERNS)


def bound_s_per_call(ctx) -> float:
    products = ctx.cell.entry.products(ctx.shape, ctx.costs)
    return sum(ctx.costs.cgemm_bound_s(m, k, n, ctx.peaks) for _, m, k, n in products)


def read(ctx):
    t = ctx.trace
    dev = t.kernel_time_s(matches)
    if dev == 0.0:
        if t.counters.get("cmatmul.launches", 0):
            raise ctx.LostTrace(f"cmatmul counted {t.counters['cmatmul.launches']} launches "
                                "and the trace holds none of its kernels")
        return None
    return 100.0 * bound_s_per_call(ctx) * t.calls / dev
