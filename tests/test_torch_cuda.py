"""The hand-written CUDA kernel against its plain version, on the card.

Marked `cuda`: each test skips where no card is present. This file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.ops import cmatmul as cm
from ofdm_lte_tpu_torch.sim import siso


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gauss", [False, True])
@pytest.mark.parametrize("M,K,N", [(28, 999, 300), (5, 7, 3), (300, 512, 260)])
def test_kernel_matches_plain(M, K, N, gauss, cuda_device):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(M * K * N)
    planes = [torch.randn(s, generator=g, device=cuda_device)
              for s in ((M, K), (M, K), (K, N), (K, N))]
    a, b = C(planes[0], planes[1]), C(planes[2], planes[3])
    before = cm.cmatmul.launches
    out = cm.cmatmul(a, b, gauss=gauss)
    assert cm.cmatmul.launches == before + 1
    ref = cm.cmatmul_plain(a, b, gauss)
    torch.cuda.synchronize()
    scale = max(ref.re.abs().max().item(), ref.im.abs().max().item())
    err = max((out.re - ref.re).abs().max().item(), (out.im - ref.im).abs().max().item())
    assert err / scale <= (1e-4 if gauss else 1e-5)


@pytest.mark.cuda
def test_kernel_reads_strided_view(cuda_device):
    y = C(torch.randn(64, 2192, device=cuda_device), torch.randn(64, 2192, device=cuda_device))
    b = C(torch.randn(2048, 200, device=cuda_device), torch.randn(2048, 200, device=cuda_device))
    view = y[::14, 144:]
    out = cm.cmatmul(view, b)
    ref = cm.cmatmul_plain(C(view.re.contiguous(), view.im.contiguous()), b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.re, ref.re, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(out.im, ref.im, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_kernel_rejects_other_precisions(cuda_device, monkeypatch):
    a = C(torch.zeros(2, 3, device=cuda_device), torch.zeros(2, 3, device=cuda_device))
    b = C(torch.zeros(3, 4, device=cuda_device), torch.zeros(3, 4, device=cuda_device))
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", "high")
    with pytest.raises(NotImplementedError):
        cm.cmatmul(a, b)


@pytest.mark.cuda
def test_link_on_card_matches_cpu_with_same_noise(cuda_device):
    """The CUDA path (three kernel launches) against the CPU path, same noise."""
    cfg = LTEConfig(5.0, modulation="64-QAM")
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (4, siso.bits_per_frame(cfg, 28))).astype(np.int32)
    g = siso.grid_for(cfg)
    noise = ((rng.standard_normal((4, 28, g.num_data)), rng.standard_normal((4, 28, g.num_data))),
             (rng.standard_normal((4, 2, g.num_pilot)), rng.standard_normal((4, 2, g.num_pilot))))
    before = cm.cmatmul.launches
    on_card = siso.simulate_siso(torch.from_numpy(bits).to(cuda_device), 20.0, cfg, noise=noise)
    assert cm.cmatmul.launches == before + 3
    on_cpu = siso.simulate_siso(torch.from_numpy(bits), 20.0, cfg, noise=noise)
    assert int((on_card.bits_rx.cpu() != on_cpu.bits_rx).sum()) <= 1e-4 * bits.size
