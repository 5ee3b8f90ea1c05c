"""The complex-GEMM wrapper and its plain versions against the JAX package.

On the CPU the wrapper runs its plain version; the hand-written CUDA
kernels are held against their plain versions in tests/test_torch_cuda.py
and by chip_smoke.py. The tensor-core kernel's arithmetic (the TF32 split,
three products per real product) is tested here through
`cmatmul_plain_tf32x3`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.ops import pallas_kernels as pk

from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.ops import cmatmul as cm
from ofdm_lte_tpu_torch.ops import ofdm as tofdm

torch.set_num_threads(2)

# tests/test_pallas.py's tolerances: rtol 1e-5, atol 1e-4 (4-dot) / 1e-3 (Gauss)
ATOL = {False: 1e-4, True: 1e-3}


def _operands(rng, M, K, N):
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((M, K), (M, K), (K, N), (K, N))]
    jx = (jcplx.C(jnp.asarray(planes[0]), jnp.asarray(planes[1])),
          jcplx.C(jnp.asarray(planes[2]), jnp.asarray(planes[3])))
    tc = (C(torch.from_numpy(planes[0]), torch.from_numpy(planes[1])),
          C(torch.from_numpy(planes[2]), torch.from_numpy(planes[3])))
    return jx, tc


def _close(out, ref, gauss):
    np.testing.assert_allclose(out.re.numpy(), np.asarray(ref.re), rtol=1e-5, atol=ATOL[gauss])
    np.testing.assert_allclose(out.im.numpy(), np.asarray(ref.im), rtol=1e-5, atol=ATOL[gauss])


@pytest.mark.skipif(not pk.HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("gauss", [False, True])
@pytest.mark.parametrize("M,K,N", [(64, 128, 96), (300, 512, 260), (128, 512, 260)])
def test_plain_matches_pallas_interpret(M, K, N, gauss, rng):
    (ja, jb), (ta, tb) = _operands(rng, M, K, N)
    ref = pk.cmatmul_pallas_2d(ja, jb, interpret=True, gauss=gauss)
    _close(cm.cmatmul_plain(ta, tb, gauss), ref, gauss)
    _close(cm.cmatmul(ta, tb, gauss=gauss), ref, gauss)


@pytest.mark.parametrize("gauss", [False, True])
def test_plain_matches_xla_at_ragged_k(gauss, rng):
    """K = 999 is the TX GEMM's depth. The Pallas kernel leaves a ragged K
    edge unmasked (NaN in interpret mode), so the reference here is the
    JAX package's XLA form."""
    (ja, jb), (ta, tb) = _operands(rng, 28, 999, 300)
    ref = jcplx.matmul(ja, jb, precision=jax.lax.Precision.HIGHEST)
    _close(cm.cmatmul(ta, tb, gauss=gauss), ref, gauss)


def _tf32_inputs(rng):
    """Seeded fp32 values: normals over 12 decades, zeros, small normal
    (not denormal) values, and values on and next to a rounding tie."""
    normals = (rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000)).astype(np.float32)
    small = (rng.standard_normal(200) * 1e-30).astype(np.float32)
    # 1 + m·2⁻¹⁰ + 2⁻¹¹ is a tie of the 10-bit grid; ±1 ulp of fp32 is next to it
    m = rng.integers(0, 1024, 300).astype(np.float64)
    tie = 1.0 + m * 2.0 ** -10 + 2.0 ** -11
    ties = np.concatenate([tie, tie + 2.0 ** -23, tie - 2.0 ** -23, -tie]).astype(np.float32)
    ties = ties * np.float32(2.0) ** rng.integers(-20, 20, ties.size).astype(np.float32)
    return np.concatenate([normals, np.zeros(8, np.float32), -np.zeros(8, np.float32),
                           small, ties])


def test_tf32_split_halves_fit_tf32_and_sum_to_x(rng):
    x = _tf32_inputs(rng)
    hi, lo = (t.numpy() for t in cm.tf32_split(torch.from_numpy(x)))
    # at most 10 explicit mantissa bits: the low 13 of fp32's 23 are clear
    assert not (hi.view(np.int32) & 0x1FFF).any()
    assert not (lo.view(np.int32) & 0x1FFF).any()
    x64 = x.astype(np.float64)
    # hi is the nearest 10-bit value, so the tail is at most half a step
    assert (np.abs(x64 - hi) <= 2.0 ** -11 * np.abs(x64)).all()
    assert (np.abs(x64 - hi - lo) <= 2.0 ** -21 * np.abs(x64)).all()
    assert hi[x == 0].tolist() == [0.0] * 16 and not lo[x == 0].any()


def test_tf32_split_rounds_ties_away_from_zero():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23],
                     dtype=torch.float32)
    hi, lo = cm.tf32_split(x)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert torch.equal((hi + lo)[:2], x[:2])
    # the third tail, 2⁻¹¹ − 2⁻²³, has 12 significant bits and is cut to 11
    assert lo[2].item() == 2.0 ** -11 - 2.0 ** -22


@pytest.mark.parametrize("M,K,N", [(28, 999, 300), (28, 2048, 200), (5, 7, 3)])
def test_plain_tf32x3_keeps_fp32_accuracy(M, K, N, rng):
    """The split keeps fp32 accuracy at the path's depths: against a float64
    product the 3xTF32 form is within 2x of the fp32 form's error, and it
    agrees with the JAX package's `highest` product to 1e-5 of max|C|."""
    (ja, jb), (ta, tb) = _operands(rng, M, K, N)
    exact = (ta.re.numpy().astype(np.float64) + 1j * ta.im.numpy()) @ \
            (tb.re.numpy().astype(np.float64) + 1j * tb.im.numpy())
    scale = np.abs(exact).max()

    def err(out):
        return np.abs(out.re.numpy() + 1j * out.im.numpy().astype(np.float64) - exact).max()

    split = cm.cmatmul_plain_tf32x3(ta, tb)
    assert err(split) <= 2 * err(cm.cmatmul_plain(ta, tb))
    ref = jcplx.matmul(ja, jb, precision=jax.lax.Precision.HIGHEST)
    assert np.abs(split.re.numpy() - np.asarray(ref.re)).max() <= 1e-5 * scale
    assert np.abs(split.im.numpy() - np.asarray(ref.im)).max() <= 1e-5 * scale


def test_kernel_rule():
    assert cm._kernel_for(False) == "tf32x3"
    assert cm._kernel_for(True) == "tf32x3_gauss"
    assert set(cm.cmatmul.launches_by_kernel) == {"tf32x3", "tf32x3_gauss", "tf32",
                                                  "tf32_gauss", "bf16", "bf16_gauss"}


def test_cpu_dispatch_flattens_batch_and_launches_nothing(rng):
    (_, _), (ta, tb) = _operands(rng, 24, 40, 16)
    a3 = ta.reshape(2, 3, 4, 40)
    before = cm.cmatmul.launches
    out = cm.cmatmul(a3, tb)
    assert cm.cmatmul.launches == before == 0
    assert out.shape == (2, 3, 4, 16)
    ref = cm.cmatmul_plain(ta, tb)
    torch.testing.assert_close(out.re.reshape(24, 16), ref.re)
    torch.testing.assert_close(out.im.reshape(24, 16), ref.im)


def test_cpu_strided_view_operand(rng):
    """The CP-stripped view (row stride N+cp) gives what a contiguous copy gives."""
    y = C(torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32)),
          torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32)))
    b = C(torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32)),
          torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32)))
    view = y[:, 10:]
    assert view.re.stride() == (50, 1)
    out = cm.cmatmul(view, b)
    ref = cm.cmatmul(C(view.re.contiguous(), view.im.contiguous()), b)
    torch.testing.assert_close(out.re, ref.re)
    torch.testing.assert_close(out.im, ref.im)


@pytest.mark.parametrize("form,gauss", [("fma4", False), ("gauss", True)])
def test_modem_form_switch(form, gauss, monkeypatch, rng):
    (_, _), (ta, tb) = _operands(rng, 12, 30, 20)
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_CMATMUL", form)
    out = tofdm._cmm(ta, tb)
    ref = cm.cmatmul_plain(ta, tb, gauss)
    assert torch.equal(out.re, ref.re) and torch.equal(out.im, ref.im)


def test_modem_form_switch_rejects_unknown(monkeypatch, rng):
    (_, _), (ta, tb) = _operands(rng, 4, 6, 5)
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_CMATMUL", "xla4")
    with pytest.raises(ValueError):
        tofdm._cmm(ta, tb)


def test_precision_policy(monkeypatch):
    from ofdm_lte_tpu_torch import precision
    monkeypatch.delenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", raising=False)
    assert precision.matmul_precision_name() == "highest"
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", "default")
    assert precision.matmul_precision_name() == "default"
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", "bf17")
    with pytest.raises(ValueError):
        precision.matmul_precision_name()


def test_non_cuda_device_raises():
    a = C(torch.zeros(2, 3, device="meta"), torch.zeros(2, 3, device="meta"))
    b = C(torch.zeros(3, 4, device="meta"), torch.zeros(3, 4, device="meta"))
    with pytest.raises(ValueError):
        cm.cmatmul(a, b)


@pytest.mark.parametrize("S,folds", [(14, True), (28, True), (20, False)])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["lanes", "antennas_lanes"])
def test_slot_start_view_folds_only_at_whole_slots(S, folds, lead):
    """The kernel reads A through one row stride. The slot-start view
    y[..., ::14, cp:] of (lead..., lanes, S, N+cp) folds into rows when S is
    a multiple of 14 (the slot step then equals the lane step); at S = 20 it
    does not, `reshape` copies, and the wrapper counts it."""
    sps, cp, lanes = 40, 8, 3
    y = torch.arange(int(np.prod(lead + (lanes, S, sps))), dtype=torch.float32
                     ).reshape(lead + (lanes, S, sps))
    view = y[..., ::14, cp:]
    rows, copied = cm.fold_rows(view, sps - cp)
    assert copied == (not folds)
    assert rows.shape == (int(np.prod(lead + (lanes,))) * -(-S // 14), sps - cp)
    assert torch.equal(rows, view.contiguous().reshape(-1, sps - cp))
    if folds:
        assert rows.stride() == (14 * sps, 1)
    # the CP-stripped view of every symbol always folds, antennas or not
    assert cm.fold_rows(y[..., cp:], sps - cp)[1] is False
    before = cm.cmatmul.copies
    cm._plane_2d(view, sps - cp, "a.re")
    assert cm.cmatmul.copies == before + (0 if folds else 1)
