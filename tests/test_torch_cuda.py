"""The hand-written CUDA kernels against their plain versions, on the card.

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


SHAPES = [(28, 999, 300), (5, 7, 3), (300, 512, 260), (130, 999, 70), (64, 7, 64)]
# (gauss, variant) -> the kernel that must serve the call, and max|Δ|/max|C|
KERNELS = {(False, "tc"): ("tf32x3", 1e-5), (False, "ffma"): ("f32_fma4", 1e-5),
           (True, "tc"): ("f32_gauss", 1e-4)}


def _operands(M, K, N, device):
    g = torch.Generator(device=device)
    g.manual_seed(M * K * N)
    planes = [torch.randn(s, generator=g, device=device)
              for s in ((M, K), (M, K), (K, N), (K, N))]
    return C(planes[0], planes[1]), C(planes[2], planes[3])


def _rel_diff(out, ref):
    scale = max(ref.re.abs().max().item(), ref.im.abs().max().item())
    return max((out.re - ref.re).abs().max().item(), (out.im - ref.im).abs().max().item()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("gauss,variant", list(KERNELS), ids=["tc", "ffma", "gauss"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernel_matches_plain(M, K, N, gauss, variant, cuda_device):
    a, b = _operands(M, K, N, cuda_device)
    kernel, tol = KERNELS[gauss, variant]
    before = cm.cmatmul.launches
    before_kernel = cm.cmatmul.launches_by_kernel[kernel]
    out = cm.cmatmul(a, b, gauss=gauss, variant=variant)
    assert cm.cmatmul.launches == before + 1
    assert cm.cmatmul.launches_by_kernel[kernel] == before_kernel + 1
    ref = cm.cmatmul_plain(a, b, gauss)
    torch.cuda.synchronize()
    assert _rel_diff(out, ref) <= tol
    if kernel == "tf32x3":
        assert _rel_diff(out, cm.cmatmul_plain_tf32x3(a, b)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("variant", cm.VARIANTS)
def test_kernel_reads_strided_view(variant, cuda_device):
    y = C(torch.randn(64, 2192, device=cuda_device), torch.randn(64, 2192, device=cuda_device))
    b = C(torch.randn(2048, 200, device=cuda_device), torch.randn(2048, 200, device=cuda_device))
    view = y[::14, 144:]
    out = cm.cmatmul(view, b, variant=variant)
    ref = cm.cmatmul_plain(C(view.re.contiguous(), view.im.contiguous()), b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.re, ref.re, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(out.im, ref.im, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_split_k_pilot_gemm_is_bit_identical_from_run_to_run(cuda_device):
    """(256, 2048) @ (2048, 200) is 4x4 tiles: the kernel splits K across the
    card and adds the partial sums in a fixed order."""
    from ofdm_lte_tpu_torch._build import library
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert library().cmatmul_tf32x3_splits(256, 200, 2048, sms) > 1
    assert library().cmatmul_tf32x3_splits(3584, 2192, 999, sms) == 1
    a, b = _operands(256, 2048, 200, cuda_device)
    before = cm.cmatmul.launches
    runs = [cm.cmatmul(a, b) for _ in range(3)]
    assert cm.cmatmul.launches == before + 3          # a split-K call counts once
    torch.cuda.synchronize()
    for out in runs[1:]:
        assert torch.equal(out.re, runs[0].re) and torch.equal(out.im, runs[0].im)
    assert _rel_diff(runs[0], cm.cmatmul_plain(a, b)) <= 1e-5


@pytest.mark.cuda
def test_default_variant_context_reaches_ffma(cuda_device):
    a, b = _operands(40, 50, 60, cuda_device)
    before = dict(cm.cmatmul.launches_by_kernel)
    with cm.default_variant("ffma"):
        cm.cmatmul(a, b)
    cm.cmatmul(a, b)
    after = cm.cmatmul.launches_by_kernel
    assert after["f32_fma4"] == before["f32_fma4"] + 1
    assert after["tf32x3"] == before["tf32x3"] + 1


@pytest.mark.cuda
def test_kernel_rejects_other_precisions(cuda_device, monkeypatch):
    a = C(torch.zeros(2, 3, device=cuda_device), torch.zeros(2, 3, device=cuda_device))
    b = C(torch.zeros(3, 4, device=cuda_device), torch.zeros(3, 4, device=cuda_device))
    for precision in ("high", "default"):
        monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", precision)
        for variant in cm.VARIANTS:
            with pytest.raises(NotImplementedError):
                cm.cmatmul(a, b, variant=variant)


@pytest.mark.cuda
def test_link_on_card_matches_cpu_with_same_noise(cuda_device):
    """The CUDA path (three launches of the tensor-core kernel) against the CPU
    path, same noise."""
    cfg = LTEConfig(5.0, modulation="64-QAM")
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (4, siso.bits_per_frame(cfg, 28))).astype(np.int32)
    g = siso.grid_for(cfg)
    noise = ((rng.standard_normal((4, 28, g.num_data)), rng.standard_normal((4, 28, g.num_data))),
             (rng.standard_normal((4, 2, g.num_pilot)), rng.standard_normal((4, 2, g.num_pilot))))
    before = cm.cmatmul.launches_by_kernel["tf32x3"]
    on_card = siso.simulate_siso(torch.from_numpy(bits).to(cuda_device), 20.0, cfg, noise=noise)
    assert cm.cmatmul.launches_by_kernel["tf32x3"] == before + 3
    on_cpu = siso.simulate_siso(torch.from_numpy(bits), 20.0, cfg, noise=noise)
    assert int((on_card.bits_rx.cpu() != on_cpu.bits_rx).sum()) <= 1e-4 * bits.size


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda_device):
    from ofdm_lte_tpu_torch import OFDMModule
    cfg = LTEConfig(1.25, modulation="QPSK")
    assert all(b.is_cuda for b in siso.SisoLink(cfg).buffers())
    module = OFDMModule(cfg, seed=0)
    assert module.simulator.device.type == "cuda"
    assert module.transmit(np.random.default_rng(0).integers(0, 2, 300), 60.0)["ber"] == 0.0
