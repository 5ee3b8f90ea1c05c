"""call_mfu: a call's useful work, the 6·m·k·n flops of its complex products
(the entry adapter's `products`, harness/costs), times the calls of the
traced window, over the window's wall time at the card's bf16 dense peak,
in %. Where cmatmul_roofline divides the products' least time by the GEMM
kernels' own device time, this divides their work by the whole window,
host gaps and every other kernel in it: a gain that lifts the kernels'
share and not this one has not reached the user, and a product taken off
the path leaves cmatmul_roofline silent but not this."""


def read(ctx):
    t = ctx.trace
    if t.calls == 0 or t.window_s <= 0:
        return None
    products = ctx.cell.entry.products(ctx.shape, ctx.costs)
    flops = sum(ctx.costs.cgemm_flops(m, k, n) for _, m, k, n in products)
    return 100.0 * flops * t.calls / (t.window_s * ctx.peaks["bf16_dense_flops"])
