"""Each per-layer reader, and the trace reduction, against small synthetic
traces; the lost-trace rule; and that every `__global__` of the port's
GEMM and BCJR sources matches its metric's name patterns."""
import json
import re
from pathlib import Path

import numpy as np
import pytest

from harness import core, devtrace, inputs
from pb_helpers import BENCH, REPO

CSRC = REPO / "ofdm_lte_tpu_torch" / "csrc"


def metric(name):
    return core.load_module(BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


class FakeCell:
    traffic = {}
    entry = core.load_module(BENCH / "entries" / "ber_sweep.py", "t_metrics_ber_entry")


def ctx_of(trace, frames=32, symbols=14, taps=0, host=None):
    shape = inputs.Shape(points=8, frames=frames, n_bits=83916 * symbols // 14, symbols=symbols,
                         n_fft=2048, cp=144, n_data=999, n_pilot=200,
                         channel="awgn" if not taps else "rayleigh_mp", taps=taps)
    return core.Context(FakeCell(), shape, trace, host)


def reduced(kernels, window=(0.0, 1000.0), calls=2, counters=None, host=(), launched=None):
    return devtrace.Reduced(kernels, kernels, window, calls, host, counters or {}, launched)


def test_kernels_per_call_leaves_the_draw_out():
    t = reduced([("randint", 0, 1), ("a", 2, 1), ("b", 4, 1), ("randint", 6, 1),
                 ("a", 8, 1), ("b", 10, 1)], window=(0.0, 12.0), calls=2)
    # the breakdown window: three calls, each draw's span launching one
    # kernel, the first draw's launch lost at the window's edge
    spans = [(core.DRAW, 0.0, 5.0), (core.DRAW, 20.0, 5.0), (core.DRAW, 40.0, 5.0)]
    host = reduced([("randint", 1, 1), ("a", 10, 1), ("randint", 21, 1), ("a", 30, 1),
                    ("randint", 41, 1), ("a", 50, 1)], calls=3, host=spans,
                   launched=[None, 7.0, 21.0, 27.0, 41.0, 47.0])
    assert host.kernels_each_span(core.DRAW) == [0, 1, 1]
    assert metric("link.kernels_per_call").read(ctx_of(t, host=host)) == 2.0
    lost = reduced(host.kernels, calls=3, host=spans)          # no launch times
    with pytest.raises(core.LostTrace):
        metric("link.kernels_per_call").read(ctx_of(t, host=lost))


def test_idle_share():
    t = reduced([("a", 0, 250), ("b", 100, 250)])           # busy 350 of 1000 µs
    assert metric("device.idle_share").read(ctx_of(t)) == pytest.approx(65.0)


def test_cmatmul_roofline_reads_bound_over_kernel_time():
    m = metric("cmatmul_roofline")
    ctx0 = ctx_of(reduced([]))
    bound = m.bound_s_per_call(ctx0)
    assert bound == pytest.approx(0.0945e-3, rel=2e-3)
    dur_us = 4 * bound * 1e6            # two calls at half the speed of light
    t = reduced([("void cmatmul_tc_kernel<false>(float const*)", 0, dur_us / 2),
                 ("prep_b_kernel(float const*)", 10, dur_us / 4),
                 ("wgc::copy_a_kernel(float const*)", 20, dur_us / 4),
                 ("elementwise_kernel", 30, 500.0)], calls=2,
                counters={"cmatmul.launches": 6})
    assert m.read(ctx_of(t)) == pytest.approx(50.0)


def test_cmatmul_roofline_adds_the_jakes_product():
    m = metric("cmatmul_roofline")
    assert m.bound_s_per_call(ctx_of(reduced([]), taps=4)) == pytest.approx(
        0.0945e-3 + 0.0762e-3, rel=1e-2)


def test_lost_trace_fails_and_silence_reads_none():
    m = metric("cmatmul_roofline")
    lost = reduced([("elementwise_kernel", 0, 5)], counters={"cmatmul.launches": 3})
    with pytest.raises(core.LostTrace):
        m.read(ctx_of(lost))
    assert m.read(ctx_of(reduced([("elementwise_kernel", 0, 5)]))) is None


def test_call_mfu():
    m = metric("call_mfu")
    t = reduced([("x", 0, 1)], window=(0.0, 1e6), calls=1)        # one call a second
    flops = sum(6.0 * a * b * c for a, b, c in [(3584, 999, 2192), (3584, 2048, 999),
                                                (256, 2048, 200)])
    assert m.read(ctx_of(t)) == pytest.approx(100 * flops / 989e12)


def test_reduce_chrome_window_busy_gaps_and_launches():
    ev = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 100, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90, "dur": 20,       # clipped to 10
           "args": {"correlation": 7}},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 130, "dur": 10,
           "args": {"correlation": 8}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 135, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 190, "dur": 5},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 106, "dur": 2,
           "args": {"correlation": 8}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::randn", "ts": 105, "dur": 30},
          {"ph": "X", "cat": "user_annotation", "name": core.DRAW, "ts": 104, "dur": 40},
          {"ph": "X", "cat": "cpu_op", "name": "portbench.call", "ts": 100, "dur": 100},
          {"ph": "i", "cat": "kernel", "name": "instant", "ts": 150}]
    r = devtrace.reduce_chrome(ev, calls=1, counters={"cmatmul.launches": 0})
    assert r.window == (100.0, 200.0) and len(r.kernels) == 3
    assert r.busy_s == pytest.approx((10 + 15 + 5) * 1e-6)
    gaps = dict(r.idle_gaps())
    assert gaps["aten::randn"] == pytest.approx(20e-6)          # 110..130
    assert gaps["portbench.call"] == pytest.approx(50e-6)       # 145..190 and 195..200
    assert dict(r.top_ops())["k1"] == pytest.approx(25e-6)
    assert r.launched == [None, 106.0, None]
    assert r.kernels_each_span(core.DRAW) == [1]
    assert r.kernel_time_in_span_s(core.DRAW) == pytest.approx(10e-6)


def test_trace_without_window_fails():
    with pytest.raises(RuntimeError):
        devtrace.reduce_chrome([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1}], 1)


GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def kernels_in(paths):
    names = []
    for p in paths:
        names += [(p.name, n) for n in GLOBAL.findall(p.read_text())]
    return names


def test_every_gemm_kernel_matches_the_patterns():
    m = metric("cmatmul_roofline")
    files = sorted(CSRC.glob("cmatmul*.cu")) + [CSRC / "cmatmul_tc.cuh",
                                                CSRC / "wgmma_cmatmul.cuh"]
    found = kernels_in(files)
    assert len(found) >= 9
    for f, name in found:
        assert m.matches(f"void {name}<true, 4>(float const*, float*)"), (f, name)
    assert not m.matches("void at::native::vectorized_elementwise_kernel<4>()")
    assert not m.matches("bcjr_kernel(float const*)")
    assert not m.matches("void at::native::distribution_elementwise_grid_stride_kernel<float>")


def test_a_card_only_trace_takes_its_window_from_the_device():
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 5},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30, "dur": 10}]
    r = devtrace.reduce_chrome(ev, calls=1, device_window=True)
    assert r.window == (10.0, 40.0)
    assert 1 - r.busy_s / r.window_s == pytest.approx(0.5)


def harq_ctx(trace, ntx_per_call):
    cell = core.Cell("harq75376_awgn", REPO)
    results = [{"ntx": np.array(n)} for n in ntx_per_call]
    return core.Context(cell, cell.shape(), trace, None, results)


def test_harq_products_are_each_transmissions():
    ctx = harq_ctx(reduced([]), [])
    prods = ctx.cell.entry.products(ctx.shape, ctx.costs)
    assert len(prods) == 12          # TX, RX data, RX pilot, at each of 4 transmissions
    assert [p[1:] for p in prods[:3]] == [(256 * 38, 999, 2192), (256 * 38, 2048, 999),
                                           (256 * 3, 2048, 200)]
    assert prods[3:6] == [(n.replace(".0", ".1"), *d) for n, *d in prods[:3]]
    m = metric("cmatmul_roofline")
    assert m.bound_s_per_call(ctx) == pytest.approx(4 * sum(
        ctx.costs.cgemm_bound_s(*p[1:]) for p in prods[:3]))
    t = reduced([("x", 0, 1)], window=(0.0, 1e6), calls=1)
    assert metric("call_mfu").read(harq_ctx(t, [])) == pytest.approx(
        100 * sum(6.0 * a * b * c for _, a, b, c in prods) / 989e12)


def test_turbo_bcjr_roofline_reads_needed_work_over_kernel_time():
    m = metric("turbo_bcjr_roofline")
    # two calls, each of the 256 lanes needing 2 transmissions: 512 decodes a call
    ntx = [[2] * 256] * 2
    bound = 2 * 512 * 16 * 13 * 5827 * 16 / 3.35e12
    t = reduced([("void (anonymous namespace)::bcjr_kernel<true, 1>(float const*)", 0,
                  bound * 4e6 / 2),
                 ("void (anonymous namespace)::bcjr_kernel<true, 2>(float const*)", 5,
                  bound * 4e6 / 2),
                 ("cmatmul_wgmma_tf32x3_kernel", 10, 1e6)], calls=2,
                counters={"bcjr_half.launches": 136})
    assert m.read(harq_ctx(t, ntx)) == pytest.approx(25.0)


def test_turbo_bcjr_roofline_lost_trace_and_silence():
    m = metric("turbo_bcjr_roofline")
    lost = reduced([("elementwise_kernel", 0, 5)], counters={"bcjr_half.launches": 68})
    with pytest.raises(core.LostTrace):
        m.read(harq_ctx(lost, [[4, 4, 4, 4]] * 2))
    with pytest.raises(core.LostTrace):
        m.read(harq_ctx(reduced([("x", 0, 5)], counters={"bcjr_app.launches": 1}),
                        [[4, 4, 4, 4]] * 2))
    assert m.read(harq_ctx(reduced([("elementwise_kernel", 0, 5)]), [[4] * 4] * 2)) is None
    # results that do not match the traced calls
    t = reduced([("bcjr_kernel<true, 1>", 0, 5)], calls=2)
    with pytest.raises(core.LostTrace):
        m.read(harq_ctx(t, [[4] * 4]))


def test_every_bcjr_kernel_matches_the_patterns():
    m = metric("turbo_bcjr_roofline")
    found = kernels_in([CSRC / "turbo_bcjr.cu"])
    assert found
    for f, name in found:
        assert m.matches(f"void (anonymous namespace)::{name}<true, 1>(float const*, int)"), name
    gemm = metric("cmatmul_roofline")
    for f, name in kernels_in(sorted(CSRC.glob("cmatmul*.cu"))):
        assert not m.matches(f"void {name}<true, 4>(float const*)"), name
        assert not gemm.matches(f"void {found[0][1]}<true, 1>(float const*)")
