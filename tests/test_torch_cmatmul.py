"""The complex-GEMM wrapper and its plain version against the JAX package.

On the CPU the wrapper runs its plain version; the hand-written CUDA
kernel is held against that plain version in tests/test_torch_cuda.py and
by chip_smoke.py."""
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
    assert precision.matmul_precision() == "highest"
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", "default")
    assert precision.matmul_precision() == "medium"
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", "bf17")
    with pytest.raises(ValueError):
        precision.matmul_precision_name()


def test_non_cuda_device_raises():
    a = C(torch.zeros(2, 3, device="meta"), torch.zeros(2, 3, device="meta"))
    b = C(torch.zeros(3, 4, device="meta"), torch.zeros(3, 4, device="meta"))
    with pytest.raises(ValueError):
        cm.cmatmul(a, b)
