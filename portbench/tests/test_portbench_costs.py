"""The work arithmetic: the products of a sweep call, the one count of a
complex product and of a BCJR step, and that no share can pass 100%."""
import itertools

import pytest

from harness import costs
from harness.peaks import H100_SXM as P


def test_flagship_products_and_bound():
    prods = costs.siso_products(256, 14, 2048, 144, 999, 200)
    assert [p[1:] for p in prods] == [(3584, 999, 2192), (3584, 2048, 999), (256, 2048, 200)]
    bound = sum(costs.cgemm_bound_s(m, k, n) for _, m, k, n in prods)
    assert bound == pytest.approx(0.0945e-3, rel=2e-3)


def test_products_of_the_cells():
    # 64 lanes of 28 symbols, two 14-symbol slots, and 512 lanes
    assert [p[1:] for p in costs.siso_products(64, 28, 2048, 144, 999, 200)] == [
        (1792, 999, 2192), (1792, 2048, 999), (128, 2048, 200)]
    assert [p[1:] for p in costs.siso_products(512, 28, 2048, 144, 999, 200, jakes_taps=4)] == [
        (14336, 999, 2192), (14336, 2048, 999), (1024, 2048, 200), (2048, 16, 61376)]


def test_jakes_product_is_store_bound():
    (_, m, k, n), = [p for p in costs.siso_products(256, 14, 2048, 144, 999, 200, jakes_taps=4)
                     if p[0] == "jakes"]
    assert (m, k, n) == (1024, 16, 30688)
    assert costs.cgemm_bound_s(m, k, n) == pytest.approx(costs.cgemm_bytes(m, k, n) / 3.35e12)
    assert costs.cgemm_bound_s(m, k, n) == pytest.approx(0.0762e-3, rel=1e-2)


def test_counts():
    assert costs.cgemm_flops(2, 3, 5) == 6 * 2 * 3 * 5
    assert costs.cgemm_bytes(2, 3, 5) == 8 * (6 + 15 + 10)


# (flops a complex product as each form computes it, the rate it runs at):
# 4-dot and Gauss at highest (3 TF32 products a real one), high (TF32),
# default (bf16), and the fp32 CUDA cores
FORMS = {"fma4": 8, "gauss": 6}
RATES = {"tf32x3": P["tf32_dense_flops"] / 3, "tf32": P["tf32_dense_flops"],
         "bf16": P["bf16_dense_flops"], "ffma": P["fp32_flops"]}


@pytest.mark.parametrize("m,k,n", [(3584, 999, 2192), (3584, 2048, 999), (256, 2048, 200),
                                   (1024, 16, 30688), (14, 16, 2048), (14336, 25, 500),
                                   (1, 1, 1)])
def test_no_kernel_beats_the_bound(m, k, n):
    """The fastest any form at any precision could run, at its peak and at
    the HBM rate, is never under the bound: a share stays at or below 100%."""
    bound = costs.cgemm_bound_s(m, k, n)
    for (form, per), (_, rate) in itertools.product(FORMS.items(), RATES.items()):
        fastest = max(per * m * k * n / rate, costs.cgemm_bytes(m, k, n) / P["hbm_bytes_per_s"])
        assert fastest >= bound * (1 - 1e-12), (form, rate)


def test_bcjr_step_is_bound_by_its_bytes():
    assert costs.BCJR_OPS_PER_STEP == 109 and costs.BCJR_BYTES_PER_STEP == 16
    assert costs.bcjr_bound_s(1.0) == pytest.approx(16 / 3.35e12)
    assert 109 / P["fp32_flops"] < 16 / P["hbm_bytes_per_s"]
    # one extrinsic pass at 3,328 blocks of K' 5,827: 0.0926 ms (PERF.md's kernel table)
    assert costs.bcjr_bound_s(3328 * 5827) == pytest.approx(0.0926e-3, rel=1e-3)


def test_harq_steps_count_the_needed_decodes():
    # 13 blocks of 5,824 and 8 iterations: 16 passes over 13 · 5,827 steps a decode
    assert costs.harq_bcjr_steps(1, [5824] * 13, 8) == 16 * 13 * 5827
    assert costs.harq_bcjr_steps(7, [1024], 8) == 7 * 16 * 1027
    assert costs.harq_bcjr_steps(0, [5824] * 13, 8) == 0


@pytest.mark.parametrize("lanes,T,ntx_each", [(256, 4, 1), (256, 4, 4), (4, 4, 2), (1, 1, 1)])
def test_no_decoder_beats_the_bcjr_bound(lanes, T, ntx_each):
    """The credited work is at most what the batched decoder launches (every
    lane decodes every stage, 2·iterations + 1 passes each), and no pass
    over those steps can move its 16 B a step faster than HBM: the share
    stays at or below 100%."""
    blocks = [5824] * 13
    credited = costs.bcjr_bound_s(costs.harq_bcjr_steps(lanes * ntx_each, blocks, 8))
    launched_steps = lanes * T * (2 * 8 + 1) * sum(K + 3 for K in blocks)
    fastest = launched_steps * 16 / P["hbm_bytes_per_s"]
    assert ntx_each <= T and credited <= fastest
