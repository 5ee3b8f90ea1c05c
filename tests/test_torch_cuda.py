"""The hand-written CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where no card is present. This file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from chip_smoke import WGMMA_SOURCES
from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.ops import cmatmul as cm
from ofdm_lte_tpu_torch.ops.multipath_fir import multipath_fir
from ofdm_lte_tpu_torch.ops.sic_detect import sic_detect
from ofdm_lte_tpu_torch.sim import siso


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


SHAPES = [(28, 999, 300), (5, 7, 3), (300, 512, 260), (130, 999, 70), (64, 7, 64)]
# gauss -> the kernel of `highest` that must serve the call, and max|Δ|/max|C|
KERNELS = {False: ("tf32x3", 1e-5), True: ("tf32x3_gauss", 1e-4)}
KERNEL_IDS = ["tc", "gauss"]
# the plain version that repeats a tensor-core kernel's own arithmetic
PLAIN_TF32X3 = {"tf32x3": cm.cmatmul_plain_tf32x3, "tf32x3_gauss": cm.cmatmul_plain_gauss_tf32x3}


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
@pytest.mark.parametrize("gauss", list(KERNELS), ids=KERNEL_IDS)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernel_matches_plain(M, K, N, gauss, cuda_device):
    a, b = _operands(M, K, N, cuda_device)
    kernel, tol = KERNELS[gauss]
    before = cm.cmatmul.launches
    before_kernel = cm.cmatmul.launches_by_kernel[kernel]
    out = cm.cmatmul(a, b, gauss=gauss)
    assert cm.cmatmul.launches == before + 1
    assert cm.cmatmul.launches_by_kernel[kernel] == before_kernel + 1
    ref = cm.cmatmul_plain(a, b, gauss)
    torch.cuda.synchronize()
    assert _rel_diff(out, ref) <= tol
    if kernel in PLAIN_TF32X3:
        assert _rel_diff(out, PLAIN_TF32X3[kernel](a, b)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("gauss", [False, True], ids=["fma4", "gauss"])
def test_kernel_reads_strided_view(gauss, cuda_device):
    y = C(torch.randn(64, 2192, device=cuda_device), torch.randn(64, 2192, device=cuda_device))
    b = C(torch.randn(2048, 200, device=cuda_device), torch.randn(2048, 200, device=cuda_device))
    view = y[::14, 144:]
    before = cm.cmatmul.copies
    out = cm.cmatmul(view, b, gauss=gauss)
    assert cm.cmatmul.copies == before
    ref = cm.cmatmul_plain(C(view.re.contiguous(), view.im.contiguous()), b, gauss)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.re, ref.re, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(out.im, ref.im, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("gauss", [False, True], ids=["tc", "gauss"])
def test_split_k_pilot_gemm_is_bit_identical_from_run_to_run(gauss, cuda_device):
    """(256, 2048) @ (2048, 200) is 4x4 tiles: each tensor-core kernel splits
    K across the card and adds the partial sums in a fixed order."""
    from ofdm_lte_tpu_torch._build import library
    kernel, tol = KERNELS[gauss]
    splits = getattr(library(), f"cmatmul_{kernel}_splits")
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert splits(256, 200, 2048, sms) > 1
    assert splits(3584, 2192, 999, sms) == 1
    a, b = _operands(256, 2048, 200, cuda_device)
    before = cm.cmatmul.launches
    runs = [cm.cmatmul(a, b, gauss=gauss) for _ in range(3)]
    assert cm.cmatmul.launches == before + 3          # a split-K call counts once
    torch.cuda.synchronize()
    for out in runs[1:]:
        assert torch.equal(out.re, runs[0].re) and torch.equal(out.im, runs[0].im)
    assert _rel_diff(runs[0], cm.cmatmul_plain(a, b, gauss)) <= tol


# the wgmma kernels, at `highest` (3xTF32, 4-dot), `high` (TF32) and `default`
# (bf16): (precision, gauss) -> kernel
PRECISION_KERNELS = {("highest", False): "tf32x3",
                     ("high", False): "tf32", ("high", True): "tf32_gauss",
                     ("default", False): "bf16", ("default", True): "bf16_gauss"}
PRECISION_IDS = ["tf32x3", "tf32", "tf32_gauss", "bf16", "bf16_gauss"]


def _within_rounding_bound(out, a, b, precision, gauss):
    """|out − A·B| against rounding_bound, elementwise, A·B exact (float64)."""
    def c128(x):
        return torch.complex(x.re.double(), x.im.double())

    exact = c128(a) @ c128(b)
    mag = (a.re.abs() + a.im.abs()).double() @ (b.re.abs() + b.im.abs()).double()
    bound = cm.rounding_bound(precision, gauss, a.shape[-1]) * mag
    out = c128(out)
    return bool(((out.real - exact.real).abs() <= bound).all()
                and ((out.imag - exact.imag).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("precision,gauss", list(PRECISION_KERNELS), ids=PRECISION_IDS)
@pytest.mark.parametrize("M,K,N", SHAPES + [(96, 16, 30688), (40, 16, 300), (40, 25, 130),
                                   (70, 999, 999), (1, 999, 999), (300, 2048, 999)])
def test_precision_kernel_matches_plain(M, K, N, precision, gauss, cuda_device, monkeypatch):
    """The wgmma kernels against the plain versions that repeat their
    arithmetic (the same exact products, summed in another order: 1e-5 of
    max|C|, 1e-4 for Gauss), and against the exact product within the
    rounding's (at `highest` the split's) bound; ragged shapes and the Jakes
    product."""
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", precision)
    kernel = PRECISION_KERNELS[precision, gauss]
    a, b = _operands(M, K, N, cuda_device)
    before = dict(cm.cmatmul.launches_by_kernel)
    out = cm.cmatmul(a, b, gauss=gauss)
    after = cm.cmatmul.launches_by_kernel
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {kernel: 1}
    torch.cuda.synchronize()
    assert _rel_diff(out, cm.PLAIN[kernel](a, b)) <= (1e-4 if gauss else 1e-5)
    assert _within_rounding_bound(out, a, b, precision, gauss)


# A read in place: the slot-start view (a pitch of 14 rows), a base 4 bytes
# off 16-byte alignment, an odd row pitch (the `high` kernels copy the last two
# into their workspace, since TMA cannot read them)
VIEWS = {"slot_start": lambda y: y[::14, 144:], "unaligned_base": lambda y: y[:, 1:2049],
         "odd_pitch": lambda y: y[:, :2191].reshape(-1)[:61 * 2191].reshape(61, 2191)[:, :2048]}


@pytest.mark.cuda
@pytest.mark.parametrize("view", list(VIEWS))
@pytest.mark.parametrize("precision,gauss", list(PRECISION_KERNELS), ids=PRECISION_IDS)
def test_precision_kernel_reads_strided_view(precision, gauss, view, cuda_device, monkeypatch):
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", precision)
    y = C(torch.randn(64, 2192, device=cuda_device), torch.randn(64, 2192, device=cuda_device))
    b = C(torch.randn(2048, 200, device=cuda_device), torch.randn(2048, 200, device=cuda_device))
    view = VIEWS[view](y)
    before = cm.cmatmul.copies
    out = cm.cmatmul(view, b, gauss=gauss)
    assert cm.cmatmul.copies == before
    dense = C(view.re.contiguous(), view.im.contiguous())
    torch.cuda.synchronize()
    kernel = PRECISION_KERNELS[precision, gauss]
    assert _rel_diff(out, cm.PLAIN[kernel](dense, b)) <= (1e-4 if gauss else 1e-5)
    assert _within_rounding_bound(out, dense, b, precision, gauss)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,offset", [(256, 2048, 200, 0), (256, 999, 999, 0),
                                          (256, 2048, 200, 1)])
@pytest.mark.parametrize("precision,gauss", list(PRECISION_KERNELS), ids=PRECISION_IDS)
def test_precision_split_k_is_bit_identical(precision, gauss, M, K, N, offset, cuda_device,
                                            monkeypatch):
    """The pilot GEMM's shape, K = 999 with N = 999, and A at a base 4 bytes off
    16-byte alignment: split along K, the same bits every run."""
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", precision)
    from ofdm_lte_tpu_torch._build import library
    kernel = PRECISION_KERNELS[precision, gauss]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert getattr(library(), f"cmatmul_{kernel}_splits")(M, N, K, sms) > 1
    a, b = _operands(M, K + offset, N, cuda_device)
    a, b = C(a.re[:, offset:], a.im[:, offset:]), C(b.re[offset:], b.im[offset:])
    runs = [cm.cmatmul(a, b, gauss=gauss) for _ in range(3)]
    torch.cuda.synchronize()
    for out in runs[1:]:
        assert torch.equal(out.re, runs[0].re) and torch.equal(out.im, runs[0].im)
    assert _rel_diff(runs[0], cm.PLAIN[kernel](a, b)) <= (1e-4 if gauss else 1e-5)


def _runs_the_wgmma_source(precision, gauss, device, monkeypatch):
    """A call at `precision` launches its wgmma source's kernel (its launch
    count, its entry in the build log, its workspace query, which agrees with
    the plain formula for an A that TMA reads in place and one it copies)."""
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", precision)
    from ofdm_lte_tpu_torch import _build
    lib = _build.library()
    assert WGMMA_SOURCES[precision][1] in _build.build_log
    kernel = PRECISION_KERNELS[precision, gauss]
    query = getattr(lib, f"cmatmul_{kernel}_workspace")
    y = torch.empty(64, 2192, device=device)
    for view, lda in ((y[:, 144:], 2192), (y[:, 1:], 2192), (y[:, :999], 999)):
        for M, N, K, splits in ((64, 999, 2048, 1), (64, 200, 999, 4), (64, 300, 16, 1),
                                (64, 300, 32, 1), (64, 300, 33, 1)):
            want = cm.wgmma_workspace_floats(M, N, K, gauss,
                                             cm.wgmma_a_needs_copy(view, view, lda), splits,
                                             precision)
            assert query(view.data_ptr(), view.data_ptr(), lda, M, N, K, splits) == want
    a, b = _operands(64, 999, 130, device)
    before = dict(cm.cmatmul.launches_by_kernel)
    out = cm.cmatmul(a, b, gauss=gauss)
    after = cm.cmatmul.launches_by_kernel
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {kernel: 1}
    torch.cuda.synchronize()
    assert _rel_diff(out, cm.PLAIN[kernel](a, b)) <= (1e-4 if gauss else 1e-5)


@pytest.mark.cuda
def test_highest_runs_the_wgmma_source(cuda_device, monkeypatch):
    """At `highest`, the 4-dot form: cmatmul_wgmma_tf32x3.cu, and no mma.sync
    4-dot kernel left in the library."""
    _runs_the_wgmma_source("highest", False, cuda_device, monkeypatch)
    from ofdm_lte_tpu_torch import _build
    assert "cmatmul_tc_kernel" not in _build.build_log


@pytest.mark.cuda
@pytest.mark.parametrize("gauss", [False, True], ids=["tf32", "tf32_gauss"])
def test_high_runs_the_wgmma_source(gauss, cuda_device, monkeypatch):
    """At `high`: cmatmul_wgmma_tf32.cu."""
    _runs_the_wgmma_source("high", gauss, cuda_device, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("gauss", [False, True], ids=["bf16", "bf16_gauss"])
def test_default_runs_the_wgmma_source(gauss, cuda_device, monkeypatch):
    """At `default`: cmatmul_bf16.cu, whose kernels are wgmma's too."""
    _runs_the_wgmma_source("default", gauss, cuda_device, monkeypatch)


def _workspace_holds_the_twins_layout(precision, M, K, N, gauss, device):
    """What a wgmma kernel writes into its workspace, read back after a call:
    B prepared (prep_b_kernel), and A prepared at `default` (prep_a_kernel)
    or copied at `high` (copy_a_kernel, where TMA cannot read it: K = 999 and
    25 here), equal their plain twins wgmma_prep_b, wgmma_prep_a and
    wgmma_copy_a byte for byte."""
    from ofdm_lte_tpu_torch._build import library
    lib = library()
    kernel = PRECISION_KERNELS[precision, gauss]
    a, b = _operands(M, K, N, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = getattr(lib, f"cmatmul_{kernel}_splits")(M, N, K, sms)
    a_copy = cm.wgmma_a_needs_copy(a.re, a.im, K)
    floats = cm.wgmma_workspace_floats(M, N, K, gauss, a_copy, splits, precision)
    ws = torch.full((floats + 1,), float("nan"), device=device)
    cr, ci = (torch.empty(M, N, device=device) for _ in range(2))
    rc = getattr(lib, "cmatmul_" + kernel)(
        a.re.data_ptr(), a.im.data_ptr(), K, b.re.data_ptr(), b.im.data_ptr(), N,
        cr.data_ptr(), ci.data_ptr(), N, M, N, K, ws.data_ptr(), splits,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    want = [cm.wgmma_prep_b(b, gauss, precision).reshape(-1).view(torch.uint8)]
    if precision == "default":
        want.append(cm.wgmma_prep_a(a, gauss).reshape(-1).view(torch.uint8))
    elif a_copy:
        want.append(cm.wgmma_copy_a(a).reshape(-1).view(torch.uint8))
    want = torch.cat(want)
    assert torch.equal(ws.view(torch.uint8)[:want.numel()], want)
    assert torch.isnan(ws[-1])                    # nothing written past the workspace
    assert _rel_diff(C(cr, ci), cm.PLAIN[kernel](a, b)) <= (1e-4 if gauss else 1e-5)


WORKSPACE_SHAPES = [(64, 999, 130), (40, 2048, 70), (40, 25, 130), (40, 16, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", WORKSPACE_SHAPES)
def test_highest_workspace_holds_the_twins_layout(M, K, N, cuda_device):
    """At `highest`: B split into the heads and tails of −Bi, Br and Bi."""
    _workspace_holds_the_twins_layout("highest", M, K, N, False, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", WORKSPACE_SHAPES)
@pytest.mark.parametrize("gauss", [False, True], ids=["tf32", "tf32_gauss"])
def test_high_workspace_holds_the_twins_layout(M, K, N, gauss, cuda_device):
    """At `high`: B rounded to TF32 in fp32 words."""
    _workspace_holds_the_twins_layout("high", M, K, N, gauss, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", WORKSPACE_SHAPES)
@pytest.mark.parametrize("gauss", [False, True], ids=["bf16", "bf16_gauss"])
def test_default_workspace_holds_the_twins_layout(M, K, N, gauss, cuda_device):
    """At `default`: B and A rounded to bf16 (to nearest even)."""
    _workspace_holds_the_twins_layout("default", M, K, N, gauss, cuda_device)


# the `highest` 4-dot kernel's products on each path: (A's rows, its row
# pitch and offset in a frame stream of 2192-sample symbols, or None for a
# dense A; K; N): TX (K = 999, A copied), RX data (the CP-stripped view), RX
# pilot (the slot-start view, split along K), the Jakes product (K = 16) and
# ragged edges
SLAB_SHAPES = {"tx": (3584, None, 999, 2192), "rx_data": (3584, 1, 2048, 999),
               "rx_pilot": (256, 14, 2048, 200), "jakes": (1536, None, 16, 30688),
               "ragged": (130, None, 999, 70), "tiny": (5, None, 7, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(SLAB_SHAPES))
def test_highest_kernel_matches_the_slab_model(path, cuda_device):
    """The `highest` 4-dot kernel against its slab model
    (cmatmul_plain_wgmma_slabs: the same split, the same chains of one
    slab), within the sum-order tolerance, at each path's shape and
    strides."""
    M, pitch, K, N = SLAB_SHAPES[path]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(K * N)
    if pitch is None:
        a = C(*(torch.randn(M, K, generator=g, device=cuda_device) for _ in range(2)))
    else:
        y = C(*(torch.randn(M * pitch, 2192, generator=g, device=cuda_device) for _ in range(2)))
        a = y[::pitch, 144:]
    b = C(*(torch.randn(K, N, generator=g, device=cuda_device) for _ in range(2)))
    before = cm.cmatmul.launches_by_kernel["tf32x3"]
    out = cm.cmatmul(a, b)
    assert cm.cmatmul.launches_by_kernel["tf32x3"] == before + 1
    torch.cuda.synchronize()
    assert _rel_diff(out, cm.cmatmul_plain_wgmma_slabs(a, b, False, "highest")) <= 1e-5


@pytest.mark.cuda
def test_high_raises_when_the_library_fails_to_build(cuda_device, monkeypatch, tmp_path):
    """A build that fails raises from the call at `high`: nothing falls back to
    another kernel, a plain version or the library."""
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", "high")
    from ofdm_lte_tpu_torch import _build
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("--no-such-nvcc-flag",))
    a, b = _operands(8, 16, 8, cuda_device)
    before = cm.cmatmul.launches
    for gauss in (False, True):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            cm.cmatmul(a, b, gauss=gauss)
    assert cm.cmatmul.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("form,kernel", [("fma4", "tf32x3"), ("gauss", "tf32x3_gauss")])
def test_link_on_card_matches_cpu_with_same_noise(form, kernel, cuda_device, monkeypatch):
    """The CUDA path (three launches of the form's tensor-core kernel) against
    the CPU path, same noise."""
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_CMATMUL", form)
    cfg = LTEConfig(5.0, modulation="64-QAM")
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (4, siso.bits_per_frame(cfg, 28))).astype(np.int32)
    g = siso.grid_for(cfg)
    noise = ((rng.standard_normal((4, 28, g.num_data)), rng.standard_normal((4, 28, g.num_data))),
             (rng.standard_normal((4, 2, g.num_pilot)), rng.standard_normal((4, 2, g.num_pilot))))
    before = cm.cmatmul.launches_by_kernel[kernel]
    on_card = siso.simulate_siso(torch.from_numpy(bits), 20.0, cfg, noise=noise)
    assert cm.cmatmul.launches_by_kernel[kernel] == before + 3
    on_cpu = siso.simulate_siso(torch.from_numpy(bits), 20.0, cfg, noise=noise, device="cpu")
    assert int((on_card.bits_rx.cpu() != on_cpu.bits_rx).sum()) <= 1e-4 * bits.size


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda_device):
    from ofdm_lte_tpu_torch import OFDMModule
    cfg = LTEConfig(1.25, modulation="QPSK")
    assert all(b.is_cuda for b in siso.SisoLink(cfg).buffers())
    module = OFDMModule(cfg, seed=0)
    assert module.simulator.device.type == "cuda"
    assert module.transmit(np.random.default_rng(0).integers(0, 2, 300), 60.0)["ber"] == 0.0


# the new call sites' depths and widths at a narrow M: SFBC (K, N = 998), SC-FDM
# (999×999), the 'simple' mode's Nc rows, and the Jakes product (K = 16, wide N)
NEW_SHAPES = [(56, 998, 2192), (56, 2048, 998), (42, 999, 999), (28, 1200, 2192), (96, 16, 30688)]


@pytest.mark.cuda
@pytest.mark.parametrize("gauss", list(KERNELS), ids=KERNEL_IDS)
@pytest.mark.parametrize("M,K,N", NEW_SHAPES)
def test_kernel_matches_plain_at_new_call_sites(M, K, N, gauss, cuda_device):
    a, b = _operands(M, K, N, cuda_device)
    kernel, tol = KERNELS[gauss]
    out = cm.cmatmul(a, b, gauss=gauss)
    ref = cm.cmatmul_plain(a, b, gauss)
    torch.cuda.synchronize()
    assert _rel_diff(out, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("S,copies", [(14, 0), (28, 0), (20, 2)])
def test_antenna_axis_folds_and_odd_slots_are_counted(S, copies, cuda_device):
    """A (rx, lanes, S, N+cp) stream: the CP-stripped view folds into rows
    under the antenna axis; the slot-start view folds only at whole slots,
    and at S = 20 both planes are copied and counted."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(S)
    y = C(torch.randn(2, 3, S, 160, generator=g, device=cuda_device),
          torch.randn(2, 3, S, 160, generator=g, device=cuda_device))
    b = C(torch.randn(128, 24, generator=g, device=cuda_device),
          torch.randn(128, 24, generator=g, device=cuda_device))
    before = cm.cmatmul.copies
    out = cm.cmatmul(y[..., 32:], b)
    assert cm.cmatmul.copies == before and out.shape == (2, 3, S, 24)
    assert _rel_diff(out, cm.cmatmul_plain(y[..., 32:], b)) <= 1e-5
    view = y[..., ::14, 32:]
    out = cm.cmatmul(view, b)
    assert cm.cmatmul.copies == before + copies
    assert _rel_diff(out, cm.cmatmul_plain(view, b)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["sc-fdm", "rayleigh_mp", "fading", "sfbc"])
def test_new_paths_on_card_match_cpu_with_same_draws(path, cuda_device):
    from ofdm_lte_tpu_torch.sim import diversity
    cfg = LTEConfig(5.0, modulation="16-QAM")
    rng = np.random.default_rng(5)
    g = siso.grid_for(cfg)
    lanes, S = 3, 28
    T = S * cfg.samples_per_ofdm_symbol

    def normals(*shape):
        return rng.standard_normal(shape), rng.standard_normal(shape)

    if path == "sfbc":
        n_even = len(diversity.sfbc_data_bins(cfg))
        bits = rng.integers(0, 2, (lanes, diversity.sfbc_bits_per_frame(cfg, S))).astype(np.int32)
        kw = {"num_rx": 2, "draws": {"noise": (normals(2, lanes, S, n_even),
                                               normals(2, lanes, 2, g.num_pilot))}}
        run = diversity.simulate_sfbc
    else:
        bits = rng.integers(0, 2, (lanes, siso.bits_per_frame(cfg, S))).astype(np.int32)
        run = siso.simulate_siso
        if path == "sc-fdm":
            kw = {"mode": "sc-fdm", "noise": (normals(lanes, S, g.num_data),
                                              normals(lanes, 2, g.num_pilot))}
        elif path == "fading":
            kw = {"channel_type": "fading",
                  "draws": {"fading": normals(lanes, T), "noise": normals(lanes, T)}}
        else:
            kw = {"channel_type": "rayleigh_mp",
                  "draws": {"phases": rng.uniform(0, 2 * np.pi, (lanes * 4, 16)),
                            "noise": normals(lanes, T)}}
    before, fir_before = cm.cmatmul.copies, multipath_fir.launches
    on_card = run(torch.from_numpy(bits), 18.0, cfg, **kw)
    assert multipath_fir.launches == fir_before + (path == "rayleigh_mp")
    on_cpu = run(torch.from_numpy(bits), 18.0, cfg, device="cpu", **kw)
    assert on_card.bits_rx.is_cuda and cm.cmatmul.copies == before
    assert int((on_card.bits_rx.cpu() != on_cpu.bits_rx).sum()) <= 1e-4 * bits.size


# the spatial link's call sites at a narrow M: TX over layer bins (K = 500 and
# 250), the time path's RX GEMMs (N = 500, 250), the tap-basis product (K = 25)
SPATIAL_SHAPES = [(56, 500, 2192), (56, 250, 2192), (56, 2048, 500), (56, 2048, 250),
                  (448, 25, 500)]


@pytest.mark.cuda
@pytest.mark.parametrize("gauss", list(KERNELS), ids=KERNEL_IDS)
@pytest.mark.parametrize("M,K,N", SPATIAL_SHAPES)
def test_kernel_matches_plain_at_spatial_call_sites(M, K, N, gauss, cuda_device):
    a, b = _operands(M, K, N, cuda_device)
    kernel, tol = KERNELS[gauss]
    out = cm.cmatmul(a, b, gauss=gauss)
    ref = cm.cmatmul_plain(a, b, gauss)
    torch.cuda.synchronize()
    assert _rel_diff(out, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [True, False])
def test_plain_versions_restore_allow_tf32_on_the_card(flag, cuda_device):
    a, b = _operands(40, 50, 60, cuda_device)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        for plain in (cm.cmatmul_plain, cm.cmatmul_plain_tf32x3, cm.cmatmul_plain_gauss_tf32x3):
            plain(a, b)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_flat_mimo_time_varying_launches_the_kernel_once(cuda_device):
    from ofdm_lte_tpu_torch.channel import rayleigh
    phi = np.random.default_rng(2).uniform(0, 2 * np.pi, (16, 5 * 2 * 3))
    before = cm.cmatmul.launches
    on_card = rayleigh.flat_mimo_time_varying(2, 3, 28, 70.0, batch_shape=(5,), phases=phi,
                                              device=cuda_device)
    assert cm.cmatmul.launches == before + 1
    on_cpu = rayleigh.flat_mimo_time_varying(2, 3, 28, 70.0, batch_shape=(5,), phases=phi,
                                             device="cpu")
    assert on_card.shape == (5, 28, 2, 3)
    torch.testing.assert_close(on_card.re.cpu(), on_cpu.re, rtol=0, atol=1e-5)
    torch.testing.assert_close(on_card.im.cpu(), on_cpu.im, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kept", ["table", "fold"])
def test_jakes_table_is_kept_on_the_card(kept, cuda_device):
    """The sinusoid table is made once on the CPU and kept on the card, equal
    to the CPU's bit for bit: the plain table, which `jakes_taps` multiplies
    by, and its distinct rows (the fold), which a multipath step reads."""
    from ofdm_lte_tpu_torch.channel import rayleigh
    cfg = LTEConfig(1.25, modulation="QPSK")
    link = siso.SisoLink(cfg, channel_type="rayleigh_mp")
    T = 14 * cfg.samples_per_ofdm_symbol
    prof = link.profile
    rayleigh._tables.clear()
    if kept == "table":
        for _ in range(2):
            rayleigh.jakes_taps(prof, T, (2,), device=cuda_device)
    else:
        bits = torch.zeros((2, siso.bits_per_frame(cfg, 14)), dtype=torch.int32,
                           device=cuda_device)
        link(bits, 20.0)
        link(bits, 20.0)
    (key, entry), = rayleigh._tables.items()
    on_cpu = rayleigh.jakes_table(prof.doppler_hz, prof.fs, T, device="cpu")
    if kept == "table":
        assert key[2:] == (T, 1, entry.re.device) and entry.re.is_cuda and entry.im.is_cuda
        assert rayleigh.jakes_table(prof.doppler_hz, prof.fs, T, device="cuda") is entry
        assert torch.equal(entry.re.cpu(), on_cpu.re) and torch.equal(entry.im.cpu(), on_cpu.im)
        return
    assert key[0] == "fold" and key[3:] == (T, 1, entry.cos.device)
    assert entry.cos.is_cuda and entry.sin.is_cuda
    assert rayleigh.jakes_fold(prof.doppler_hz, prof.fs, T, device="cuda") is entry
    for n, (k, sign) in enumerate(zip(entry.group, entry.sign)):
        assert torch.equal(entry.cos[k].cpu(), on_cpu.re[n])
        assert torch.equal(sign * entry.sin[k].cpu(), on_cpu.im[n])


# the fused multipath pass at the cells' shapes (RX legs, TX antennas, lanes,
# T, profile, km/h, hold), a held tap under a TX sum, and eight RX legs (two
# chunks of four) over a table whose rows fold into none (D = 16)
FIR_SHAPES = {
    "siso_peda_256": (1, 1, 256, 14 * 2192, "Pedestrian_A", None, 1),
    "4x4_peda_256": (4, 4, 256, 14 * 2192, "Pedestrian_A", 3.0, 1),
    "2x3_veha_hold4": (2, 3, 5, 2 * 2192, "Vehicular_A", 30.0, 4),
    "8x1_bad_urban_unfolded": (8, 1, 3, 2000, "Bad_Urban", 10.0, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FIR_SHAPES))
def test_multipath_fir_kernel_matches_plain(name, cuda_device):
    """The kernel against multipath_fir_plain on the card, one launch. Both
    sum the same fp32 terms in the same order; the kernel's fmaf rounds a
    multiply-add once where the plain version rounds the product and the sum,
    so they part by some 30 roundings of terms below max|y|: 4e-6 of it (the
    CPU tests hold the plain version within 3e-7 of a float64 sum)."""
    from ofdm_lte_tpu_torch.channel import rayleigh
    from ofdm_lte_tpu_torch.ops import multipath_fir as fir
    n_rx, n_tx, lanes, T, prof_name, kmh, hold = FIR_SHAPES[name]
    prof = rayleigh.make_profile(prof_name, 30.72e6, velocity_kmh=kmh)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(T + lanes)
    x = C(torch.randn((n_tx, lanes, T), generator=g, device=cuda_device),
          torch.randn((n_tx, lanes, T), generator=g, device=cuda_device))
    rows = rayleigh.jakes_rows(prof, (n_rx, n_tx, lanes), g, cuda_device).reshape(
        n_rx, n_tx, lanes, prof.num_taps, 16)
    if name.endswith("unfolded"):
        phase = torch.rand((16, T // hold), generator=g, device=cuda_device) * (2 * np.pi)
        fold = fir.sinusoid_fold(C(torch.cos(phase), torch.sin(phase)))
        assert fold.groups == 16
    else:
        fold = rayleigh.jakes_fold(prof.doppler_hz, prof.fs, T // hold, hold, cuda_device)
        assert fold.groups == 6
    args = (prof.delays_samples, prof.gains_linear, hold)
    before = fir.multipath_fir.launches
    got = fir.multipath_fir(x, rows, fold, *args)
    assert fir.multipath_fir.launches == before + 1
    want = fir.multipath_fir_plain(x, rows, fold, *args)
    torch.cuda.synchronize()
    assert got.shape == (n_rx, lanes, T) and _rel_diff(got, want) <= 4e-6


@pytest.mark.cuda
@pytest.mark.parametrize("precision,form", [("highest", "fma4"), ("high", "fma4"),
                                            ("highest", "gauss"), ("default", "fma4")])
def test_multipath_step_takes_the_fused_pass_under_every_setting(precision, form, cuda_device,
                                                                 monkeypatch):
    """A SISO multipath step on the card: the fused pass once and no Jakes
    product (TX, RX data and RX pilot GEMMs alone) whatever the GEMM policy
    and form, since the pass computes in fp32 under all of them."""
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", precision)
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_CMATMUL", form)
    cfg = LTEConfig(5.0, modulation="16-QAM")
    link = siso.SisoLink(cfg, channel_type="rayleigh_mp")
    bits = torch.zeros((3, siso.bits_per_frame(cfg, 14)), dtype=torch.int32, device=cuda_device)
    before, fir_before = cm.cmatmul.launches, multipath_fir.launches
    link(bits, 20.0)
    assert cm.cmatmul.launches == before + 3
    assert multipath_fir.launches == fir_before + 1


# (num_rx, L) with L <= num_rx; num_tx 4 throughout but for one 8-TX case
SIC_SHAPES = [(r, L) for r in (1, 2, 3, 4) for L in range(1, r + 1)]
SIC_MODULATIONS = ["QPSK", "16-QAM", "64-QAM"]


def _sic_system(num_rx, num_tx, L, sigma, g, device, lanes=8, S=14, m=250):
    """The kernel's operands: y and the per-TX planes (num_rx, lanes, S, m),
    a TM4 precoder W (num_tx, L) other than the identity, and σ² a scalar or
    one value per lane."""
    from ofdm_lte_tpu_torch import cplx
    from ofdm_lte_tpu_torch.mimo import codebook

    def plane():
        return C(*(torch.randn((num_rx, lanes, S, m), generator=g, device=device)
                   for _ in range(2)))

    y, h_tx = plane(), [plane() for _ in range(num_tx)]
    W = cplx.const(codebook.get_precoder(1, num_tx, "TM4", L), device)
    s2 = (torch.rand((lanes,), generator=g, device=device) * 0.3 + 1e-3 if sigma == "per_lane"
          else 0.05)
    return y, h_tx, W, s2


def _sic_equal(y, h_tx, W, s2, modulation):
    from ofdm_lte_tpu_torch.ops import sic_detect as sd
    before = sd.sic_detect.launches
    got = sd.sic_detect(y, h_tx, W, s2, modulation)
    assert sd.sic_detect.launches == before + 1
    want = sd.sic_detect_plain(y, h_tx, W, s2, modulation)
    torch.cuda.synchronize()
    assert got.shape == want.shape == tuple(y.shape[1:]) + (W.shape[1],)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", ["scalar", "per_lane"])
@pytest.mark.parametrize("modulation", SIC_MODULATIONS)
@pytest.mark.parametrize("num_rx,L", SIC_SHAPES)
def test_sic_detect_kernel_matches_plain(num_rx, L, modulation, sigma, cuda_device):
    """csrc/sic_detect.cu against its plain version (the effective channel,
    then sic_stacked) on the card: the decisions equal bit for bit on every
    site, one launch."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(101 * num_rx + 7 * L + SIC_MODULATIONS.index(modulation))
    _sic_equal(*_sic_system(num_rx, 4, L, sigma, g, cuda_device), modulation)


@pytest.mark.cuda
@pytest.mark.parametrize("num_rx,num_tx,L", [(4, 8, 2), (2, 8, 1), (3, 2, 2)])
def test_sic_detect_kernel_matches_plain_at_other_tx_counts(num_rx, num_tx, L, cuda_device):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(num_rx * num_tx * L)
    _sic_equal(*_sic_system(num_rx, num_tx, L, "per_lane", g, cuda_device), "64-QAM")


@pytest.mark.cuda
@pytest.mark.parametrize("modulation", SIC_MODULATIONS)
def test_sic_detect_kernel_breaks_ties_as_plain(modulation, cuda_device):
    """Unit columns of the effective channel (exact SINR ties) and two
    collinear columns, as in test_sic_order_breaks_ties_as_jax: W the identity
    here, so that h_tx is the effective channel; the kernel multiplies it out
    all the same."""
    from ofdm_lte_tpu_torch import cplx
    g = torch.Generator(device=cuda_device)
    g.manual_seed(5)
    y, h_tx, _, _ = _sic_system(4, 4, 4, "scalar", g, cuda_device)
    norms = [torch.sqrt(h.abs2().sum(dim=0, keepdim=True)) for h in h_tx]   # over rx
    h_tx = [C(h.re / n, h.im / n) for h, n in zip(h_tx, norms)]
    h_tx[2] = C(-h_tx[0].im, h_tx[0].re)                         # column 0 times j
    _sic_equal(y, h_tx, cplx.const(np.eye(4), cuda_device), 0.1, modulation)


@pytest.mark.cuda
def test_sic_detect_wrapper_checks_its_inputs(cuda_device):
    from ofdm_lte_tpu_torch.ops import sic_detect as sd
    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    y, h_tx, W, s2 = _sic_system(2, 4, 2, "scalar", g, cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        sd.sic_detect(C(y.re[:, :, :, ::2], y.im[:, :, :, ::2]),
                      [C(h.re[:, :, :, ::2], h.im[:, :, :, ::2]) for h in h_tx], W, s2, "QPSK")
    with pytest.raises(ValueError, match="contiguous float32"):
        sd.sic_detect(y, h_tx, C(W.re.cpu(), W.im.cpu()), s2, "QPSK")
    empty = C(y.re[:, :0], y.im[:, :0])
    assert sd.sic_detect(empty, [empty] * 4, W, s2, "QPSK").shape == (0, 14, 250, 2)


SPATIAL_CASES = {
    "4x2_r2_mmse_bins": dict(num_tx=4, num_rx=2, rank=2, detector_type="MMSE"),
    "4x2_r2_sic_time": dict(num_tx=4, num_rx=2, rank=2, detector_type="SIC", impl="time"),
    "4x4_r4_sic_mp": dict(num_tx=4, num_rx=4, rank=4, detector_type="SIC",
                          channel_type="rayleigh_mp"),
    "4x4_r3_zf_bins": dict(num_tx=4, num_rx=4, rank=3, detector_type="ZF"),
    "4x2_r1_mrc_bins": dict(num_tx=4, num_rx=2, rank=1, detector_type="MRC"),
    "8x4_r2_mmse_ext_mp": dict(num_tx=8, num_rx=4, rank=2, detector_type="MMSE",
                               channel_type="rayleigh_mp", pilot_layout="extended"),
}
# complex-GEMM launches a step: TX; + RX data and RX pilot on the time path;
# + one tap-basis product a TX antenna. Over multipath the Jakes taps are made
# inside the one fused pass (FIR_LAUNCHES), not by a product.
SPATIAL_LAUNCHES = {"4x2_r2_mmse_bins": 1, "4x2_r2_sic_time": 3, "4x4_r4_sic_mp": 3,
                    "4x4_r3_zf_bins": 1, "4x2_r1_mrc_bins": 1, "8x4_r2_mmse_ext_mp": 11}
FIR_LAUNCHES = {"4x4_r4_sic_mp": 1, "8x4_r2_mmse_ext_mp": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_link_on_card_matches_cpu_with_same_draws(name, cuda_device, monkeypatch):
    from ofdm_lte_tpu_torch.sim import spatial
    kw = dict(SPATIAL_CASES[name])
    impl = kw.pop("impl", None)
    if impl:
        monkeypatch.setenv("OFDM_LTE_TPU_TORCH_SPATIAL_CHANNEL", impl)
    cfg = LTEConfig(5.0, modulation="16-QAM")
    rng = np.random.default_rng(6)
    g = siso.grid_for(cfg)
    lanes, S = 3, 14
    num_tx, num_rx, rank = kw["num_tx"], kw["num_rx"], kw["rank"]
    m = -(-g.num_data // rank)

    def normals(*shape):
        return rng.standard_normal(shape), rng.standard_normal(shape)

    draws = {"noise": (normals(num_rx, lanes, S, m), normals(num_rx, lanes, S, g.num_pilot))}
    if kw.get("channel_type") == "rayleigh_mp":
        draws["phases"] = rng.uniform(0, 2 * np.pi, (num_rx * num_tx * lanes * 4, 16))
    else:
        draws["fading"] = normals(lanes, num_rx, num_tx)
    bits = rng.integers(0, 2, (lanes, spatial.bits_per_frame(cfg, S))).astype(np.int32)
    snr = np.array([12.0, 20.0, 30.0], np.float32)
    before, copies = cm.cmatmul.launches, cm.cmatmul.copies
    fir_before, sic_before = multipath_fir.launches, sic_detect.launches
    on_card = spatial.simulate_spatial_multiplexing(torch.from_numpy(bits), snr, cfg,
                                                    draws=draws, **kw)
    assert cm.cmatmul.launches == before + SPATIAL_LAUNCHES[name]
    assert multipath_fir.launches == fir_before + FIR_LAUNCHES.get(name, 0)
    # the SIC route is one pass of the detector kernel a forward
    assert sic_detect.launches == sic_before + (kw["detector_type"] == "SIC")
    assert cm.cmatmul.copies == copies and on_card.bits_rx.is_cuda
    on_cpu = spatial.simulate_spatial_multiplexing(torch.from_numpy(bits), snr, cfg,
                                                   device="cpu", draws=draws, **kw)
    assert int((on_card.bits_rx.cpu() != on_cpu.bits_rx).sum()) <= 1e-4 * bits.size
    torch.testing.assert_close(on_card.papr_db.cpu(), on_cpu.papr_db, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["siso", "simo", "sfbc", "spatial"])
def test_ber_sweep_on_the_card(pipeline, cuda_device):
    from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep
    cfg = LTEConfig(1.25, modulation="QPSK")
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    r = ber_sweep(cfg, [0.0, 60.0], frames=4, num_ofdm_symbols=14, pipeline=pipeline,
                  generator=gen)
    assert r.bit_errors[0] > r.bit_errors[1] == 0 and r.bit_errors.dtype == np.int64
    assert np.isfinite(r.papr_db).all()


@pytest.mark.cuda
def test_spatial_entry_points_default_to_the_card(cuda_device):
    from ofdm_lte_tpu_torch import OFDMSimulator
    from ofdm_lte_tpu_torch.sim import spatial
    cfg = LTEConfig(1.25, modulation="QPSK")
    link = spatial.SpatialLink(cfg, 2, 2, 2)
    assert all(b.is_cuda for b in link.buffers())
    res = OFDMSimulator(cfg, seed=0).simulate_spatial_multiplexing(
        np.random.default_rng(0).integers(0, 2, 300), 60.0, num_tx=2, num_rx=2, rank=2)
    assert res["ber"] == 0.0


BF_CASES = {"static_4x2_codebook": dict(num_tx=4, num_rx=2, update_mode="static"),
            "jakes_8x1_codebook_p4": dict(num_tx=8, num_rx=1, update_mode="static",
                                          update_period=4, doppler_hz=55.5556),
            "jakes_4x2_mrt_p3": dict(num_tx=4, num_rx=2, update_mode="adaptive",
                                     update_period=3, doppler_hz=111.1)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BF_CASES))
def test_beamforming_link_on_card_matches_cpu_with_same_draws(name, cuda_device):
    """The static link launches no GEMM; the Jakes one the channel's
    E @ P product once, through the kernel."""
    from ofdm_lte_tpu_torch.sim import beamforming
    kw = dict(BF_CASES[name])
    cfg = LTEConfig(5.0, modulation="64-QAM")
    rng = np.random.default_rng(8)
    lanes, S = 4, 14
    nd = siso.grid_for(cfg).num_data
    bits = rng.integers(0, 2, (lanes, beamforming.bits_per_frame(cfg, S))).astype(np.int32)
    num_tx, num_rx = kw["num_tx"], kw["num_rx"]

    def normals(*shape):
        return rng.standard_normal(shape), rng.standard_normal(shape)

    if "update_period" in kw:
        fn, launches = beamforming.simulate_beamforming_time_varying, 1
        draws = {"phases": rng.uniform(0, 2 * np.pi, (16, lanes * num_rx * num_tx)),
                 "noise": normals(lanes, S, num_rx, nd)}
    else:
        fn, launches = beamforming.simulate_beamforming, 0
        draws = {"H": normals(lanes, num_rx, num_tx), "noise": normals(lanes, num_rx, S * nd)}
    before, copies = cm.cmatmul.launches, cm.cmatmul.copies
    on_card = fn(torch.from_numpy(bits), 18.0, cfg, draws=draws, **kw)
    assert cm.cmatmul.launches == before + launches and cm.cmatmul.copies == copies
    assert on_card.bits_rx.is_cuda
    on_cpu = fn(torch.from_numpy(bits), 18.0, cfg, device="cpu", draws=draws, **kw)
    assert int((on_card.bits_rx.cpu() != on_cpu.bits_rx).sum()) <= 1e-4 * bits.size
    torch.testing.assert_close(on_card.beamforming_gain_db.cpu(), on_cpu.beamforming_gain_db,
                               rtol=0, atol=1e-4)
    if launches:
        assert torch.equal(on_card.pmi_history.cpu(), on_cpu.pmi_history)
    else:
        assert torch.equal(on_card.pmi.cpu(), on_cpu.pmi)


@pytest.mark.cuda
def test_coding_front_on_card_equals_cpu(cuda_device):
    from ofdm_lte_tpu_torch.coding import crc, rate_matching as rm
    from ofdm_lte_tpu_torch.ops import qam
    rng = np.random.default_rng(9)
    bits = torch.from_numpy(rng.integers(0, 2, (5, 6144)).astype(np.int32))
    assert torch.equal(crc.crc_torch(bits.to(cuda_device)).cpu(), crc.crc_torch(bits))
    for K in (40, 6144):
        N_cb = 3 * (K + 6)
        for E in (N_cb // 3, N_cb + 7, 2 * N_cb + 101):
            for rv in range(4):
                enc = torch.from_numpy(rng.integers(0, 2, (3, 3 * K + 12)).astype(np.int32))
                assert torch.equal(rm.rate_match(enc.to(cuda_device), E, K, rv).cpu(),
                                   rm.rate_match(enc, E, K, rv))
                llr = torch.from_numpy((rng.standard_normal((3, E)) * 4).astype(np.float32))
                assert torch.equal(rm.rate_dematch(llr.to(cuda_device), K, rv).cpu(),
                                   rm.rate_dematch(llr, K, rv))
    y = C(torch.randn(2, 999), torch.randn(2, 999))
    for mod in ("QPSK", "16-QAM", "64-QAM"):
        for nv in (0.05, torch.rand(2, 999) * 0.4 + 0.01):
            on_cpu = qam.llrs(y, nv, mod)
            on_card = qam.llrs(C(y.re.to(cuda_device), y.im.to(cuda_device)),
                               nv.to(cuda_device) if isinstance(nv, torch.Tensor) else nv, mod)
            scale = on_cpu.abs().max().item()
            assert (on_card.cpu() - on_cpu).abs().max().item() <= 1e-6 * scale


@pytest.mark.cuda
def test_beamforming_entry_points_default_to_the_card(cuda_device):
    from ofdm_lte_tpu_torch import OFDMSimulator
    from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep
    from ofdm_lte_tpu_torch.sim import beamforming
    cfg = LTEConfig(1.25, modulation="QPSK")
    assert all(b.is_cuda for b in beamforming.BeamformingLink(cfg, 4, 2).buffers())
    sim = OFDMSimulator(cfg, seed=0)
    bits = np.random.default_rng(0).integers(0, 2, 300)
    for model in ("static", "jakes"):
        res = sim.simulate_beamforming(bits, 60.0, num_tx=4, num_rx=2, velocity_kmh=30.0,
                                       channel_model=model)
        assert res["ber"] == 0.0
    r = ber_sweep(cfg, [0.0, 60.0], frames=4, num_ofdm_symbols=14, pipeline="beamforming",
                  generator=torch.Generator(device=cuda_device).manual_seed(1))
    assert r.bit_errors[0] > r.bit_errors[1] == 0 and r.papr_db.tolist() == [0.0, 0.0]


def _bcjr_inputs(n, kp, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randn((n, kp), generator=g, device=device) * 3.0 for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("use_max_log", [True, False], ids=["max_log", "log_map"])
@pytest.mark.parametrize("n,kp", [(1, 43), (7, 1027), (64, 6147), (17, 5827), (3, 64), (2, 1)])
def test_bcjr_kernel_matches_plain(n, kp, use_max_log, cuda_device, monkeypatch):
    """Max-log equal as floats; log-MAP within 1e-6 of the largest path
    metric (expf/logf and the 8-state sum order differ by ulps). The wrapper
    never hands a CUDA tensor to the plain version."""
    from ofdm_lte_tpu_torch.ops import bcjr
    ls, lp, la = _bcjr_inputs(n, kp, n * kp, cuda_device)
    want = bcjr.bcjr_plain(ls, lp, la, use_max_log)
    monkeypatch.setattr(bcjr, "bcjr_plain", None)
    before = bcjr.bcjr_app.launches
    got = bcjr.bcjr_app(ls, lp, la, use_max_log)
    again = bcjr.bcjr_app(ls, lp, la, use_max_log)
    torch.cuda.synchronize()
    assert bcjr.bcjr_app.launches == before + 2 and got.shape == (n, kp)
    assert torch.equal(got, again)
    if use_max_log:
        assert torch.equal(got, want)
    else:
        metric = 0.5 * (ls.abs() + lp.abs() + la.abs()).sum(dim=-1).max().item()
        assert (got - want).abs().max().item() <= 1e-6 * metric


@pytest.mark.cuda
def test_bcjr_wrapper_checks_its_inputs(cuda_device):
    from ofdm_lte_tpu_torch.ops import bcjr
    ls, lp, la = _bcjr_inputs(4, 50, 1, cuda_device)
    with pytest.raises(TypeError):
        bcjr.bcjr_app(ls.double(), lp, la)
    with pytest.raises(ValueError):
        bcjr.bcjr_app(ls[:, ::2], lp[:, ::2], la[:, ::2])
    with pytest.raises(ValueError):
        bcjr.bcjr_app(ls, lp[:3], la)


# a-priori sources of a half-iteration: the other decoder's extrinsic through
# a permutation (the role of π or π⁻¹) or in order, or none (the first one)
HALF_APRIORI = ["permuted", "in_order", "none"]


@pytest.mark.cuda
@pytest.mark.parametrize("use_max_log", [True, False], ids=["max_log", "log_map"])
@pytest.mark.parametrize("apriori", HALF_APRIORI)
@pytest.mark.parametrize("n,kp", [(1, 43), (7, 1027), (64, 6147), (17, 5827), (3, 64), (2, 4)])
def test_bcjr_half_kernel_matches_plain(n, kp, apriori, use_max_log, cuda_device, monkeypatch):
    """The extrinsic and hard modes against bcjr_half_plain: max-log equal as
    floats, log-MAP within 1e-6 of the largest path metric (hard bits equal
    wherever the plain APP is farther than that from 0); two launches
    identical; odd block counts leave a half-warp alone."""
    from ofdm_lte_tpu_torch.ops import bcjr
    K = kp - 3
    ls, lp, la = _bcjr_inputs(n, kp, n * kp + 1, cuda_device)
    ext = None if apriori == "none" else la[:, :K].t().contiguous()      # step-major
    index = None
    if apriori == "permuted":
        index = torch.as_tensor(np.random.default_rng(kp).permutation(K).astype(np.int32),
                                device=cuda_device)
    want = bcjr.bcjr_half_plain(ls, lp, ext, index, False, use_max_log)
    want_bits = bcjr.bcjr_half_plain(ls, lp, ext, index, True, use_max_log)
    body = torch.zeros_like(ls[:, :K]) if ext is None else \
        (ext if index is None else ext.index_select(0, index.long())).t()
    app = bcjr.bcjr_plain(ls, lp, torch.cat([body, torch.zeros_like(ls[:, :3])], -1),
                          use_max_log)[:, :K]
    monkeypatch.setattr(bcjr, "bcjr_half_plain", None)
    before = bcjr.bcjr_half.launches
    got = bcjr.bcjr_half(ls, lp, ext, index, use_max_log=use_max_log)
    again = bcjr.bcjr_half(ls, lp, ext, index, use_max_log=use_max_log)
    bits = bcjr.bcjr_half(ls, lp, ext, index, hard=True, use_max_log=use_max_log)
    torch.cuda.synchronize()
    assert bcjr.bcjr_half.launches == before + 3
    assert got.shape == (K, n) and got.dtype == torch.float32 and got.is_contiguous()
    assert bits.shape == (n, K) and bits.dtype == torch.int32
    assert torch.equal(got, again)
    metric = 0.5 * (ls.abs() + lp.abs() + la.abs()).sum(dim=-1).max().item()
    if use_max_log:
        assert torch.equal(got, want) and torch.equal(bits, want_bits)
    else:
        assert (got - want).abs().max().item() <= 1e-6 * metric
        clear = app.abs() > 1e-6 * metric
        assert torch.equal(bits[clear], want_bits[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,iterations", [(3, 1024, 8), (2, 6144, 2)])
def test_turbo_decode_through_kernel_matches_plain_on_card(n, K, iterations, cuda_device):
    """A whole decode through the kernel against the same decode through the
    plain half-iteration on the card, max-log: the last extrinsic plane and
    the bits equal as floats; 2·iterations + 1 launches."""
    from ofdm_lte_tpu_torch.coding import turbo
    from ofdm_lte_tpu_torch.ops import bcjr
    rng = np.random.default_rng(K)
    bits = torch.as_tensor(rng.integers(0, 2, (n, K)).astype(np.int32), device=cuda_device)
    enc = turbo.turbo_encode(bits, K).float()
    sigma = 0.55                                  # past the waterfall
    llr = (2.0 / sigma ** 2) * ((1.0 - 2.0 * enc) + sigma * torch.as_tensor(
        rng.standard_normal(tuple(enc.shape)).astype(np.float32), device=cuda_device))
    perm, inv = turbo.qpp_tables(K, cuda_device)
    ls1, lp1, ls2, lp2 = turbo.constituent_llrs(llr, K, perm)

    def decode(half):
        e2 = None
        for _ in range(iterations):
            e1 = half(ls1, lp1, e2, inv)
            e2 = half(ls2, lp2, e1, perm)
        return e2, half(ls1, lp1, e2, inv, True)

    before = bcjr.bcjr_half.launches
    e2, hard = decode(bcjr.bcjr_half)
    assert bcjr.bcjr_half.launches == before + 2 * iterations + 1
    e2_plain, hard_plain = decode(bcjr.bcjr_half_plain)
    assert torch.equal(e2, e2_plain) and torch.equal(hard, hard_plain)
    assert torch.equal(turbo.turbo_decode(llr, K, iterations, True), hard)
    assert (hard != bits).float().mean().item() < 0.01


@pytest.mark.cuda
def test_bcjr_half_raises_when_the_library_fails_to_build(cuda_device, monkeypatch):
    """No fallback: a CUDA tensor never reaches the plain version."""
    from ofdm_lte_tpu_torch import _build
    from ofdm_lte_tpu_torch.ops import bcjr

    def broken():
        raise RuntimeError("nvcc failed")

    ls, lp, la = _bcjr_inputs(2, 43, 3, cuda_device)
    monkeypatch.setattr(_build, "library", broken)
    monkeypatch.setattr(bcjr, "bcjr_half_plain", None)
    monkeypatch.setattr(bcjr, "bcjr_plain", None)
    before = bcjr.bcjr_half.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bcjr.bcjr_half(ls, lp, la[:, :40].t().contiguous(), None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bcjr.bcjr_app(ls, lp, la)
    assert bcjr.bcjr_half.launches == before


@pytest.mark.cuda
def test_bcjr_half_wrapper_checks_its_inputs(cuda_device):
    from ofdm_lte_tpu_torch.ops import bcjr
    ls, lp, la = _bcjr_inputs(4, 50, 1, cuda_device)
    ext = la[:, :47].t().contiguous()                     # step-major (K, n)
    index = torch.arange(47, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        bcjr.bcjr_half(ls, lp, ext, index.long())
    with pytest.raises(TypeError):
        bcjr.bcjr_half(ls, lp, ext.double(), index)
    with pytest.raises(ValueError):
        bcjr.bcjr_half(ls, lp, ext.t().contiguous(), index)   # block-major
    with pytest.raises(ValueError):
        bcjr.bcjr_half(ls, lp, la[:, :47].t(), index)        # not contiguous
    with pytest.raises(ValueError):
        bcjr.bcjr_half(ls, lp, ext, index[:40])
    with pytest.raises(ValueError):
        bcjr.bcjr_half(ls[:, :3].contiguous(), lp[:, :3].contiguous(), None, None)
    with pytest.raises(ValueError):
        bcjr.bcjr_half(ls, lp, ext, index.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n,iterations", [(1000, 8), (12000, 2)])
def test_coded_chain_on_card_matches_cpu_with_same_draws(n, iterations, cuda_device):
    """The batched chain and its HARQ on the card against the CPU under the
    same noise: equal bits, CRC outcomes and transmissions."""
    from ofdm_lte_tpu_torch.ops import bcjr
    from ofdm_lte_tpu_torch.sim import coded
    cfg = LTEConfig(5.0, modulation="QPSK")
    rng = np.random.default_rng(10)
    bits = torch.from_numpy(rng.integers(0, 2, (4, n)).astype(np.int32))
    link = coded.link_for(cfg, n, cuda_device)
    assert all(b.is_cuda for b in link.buffers())
    n_sym = -(-link.coded_len // cfg.bits_per_symbol)
    samples = -(-n_sym // siso.grid_for(cfg).num_data) * cfg.samples_per_ofdm_symbol
    noise = (rng.standard_normal((4, 4, samples)), rng.standard_normal((4, 4, samples)))
    snr = torch.tensor([-1.0, 1.0, 3.0, 30.0])
    before = bcjr.bcjr_half.launches
    card = link.harq(bits, snr, num_iterations=iterations, draws={"noise": noise})
    assert bcjr.bcjr_half.launches == before + 4 * (2 * iterations + 1) * len(link.groups)
    cpu = coded.link_for(cfg, n, "cpu").harq(bits, snr, num_iterations=iterations,
                                             draws={"noise": noise})
    assert torch.equal(card.crc_pass_stage.cpu(), cpu.crc_pass_stage)
    assert torch.equal(card.num_transmissions.cpu(), cpu.num_transmissions)
    assert torch.equal(card.bits_rx.cpu(), cpu.bits_rx)
    # one transmission: the lanes below the waterfall fail on both, with
    # decodes that rounding may move; the passing ones agree bit for bit
    one = {"noise": (noise[0][0], noise[1][0])}
    card1 = link(bits, snr, num_iterations=iterations, draws=one)
    cpu1 = coded.link_for(cfg, n, "cpu")(bits, snr, num_iterations=iterations, draws=one)
    assert torch.equal(card1.crc_pass.cpu(), cpu1.crc_pass) and bool(cpu1.crc_pass[-1])
    assert torch.equal(card1.bits_rx.cpu()[cpu1.crc_pass], cpu1.bits_rx[cpu1.crc_pass])


@pytest.mark.cuda
def test_coded_entry_points_default_to_the_card(cuda_device):
    from ofdm_lte_tpu_torch import OFDMSimulator
    from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep, harq_sweep
    cfg = LTEConfig(1.25, modulation="QPSK")
    sim = OFDMSimulator(cfg, seed=0)
    bits = np.random.default_rng(0).integers(0, 2, 1000)
    assert sim.simulate_siso_coded(bits, 30.0)["crc_pass"]
    assert sim.simulate_siso_coded_harq(bits, 30.0)["num_transmissions"] == 1
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    r = ber_sweep(cfg, [-5.0, 30.0], frames=2, pipeline="coded", coded_tb_bits=1000,
                  generator=gen)
    assert r.bit_errors[0] > r.bit_errors[1] == 0
    h = harq_sweep(cfg, [-10.0, 30.0], frames=2, tb_bits=1000, generator=gen)
    assert h.tb_failures.tolist() == [2, 0] and h.tx_sum.tolist() == [8, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["siso", "harq"])
def test_cli_run_on_the_card(cuda_device, capsys, pipeline):
    """`run` with no --device runs on the card at 20 MHz 64-QAM: BER 0 at
    60 dB, through the tensor-core GEMM and, coded, through turbo_bcjr."""
    import json
    from ofdm_lte_tpu_torch import cli
    from ofdm_lte_tpu_torch.ops import bcjr
    gemms, passes = cm.cmatmul.launches_by_kernel["tf32x3"], bcjr.bcjr_half.launches
    cli.main(["run", "--bandwidth", "20", "--modulation", "64-QAM", "--snr", "60",
              "--num-bits", "12000", "--pipeline", pipeline])
    out = json.loads(capsys.readouterr().out)
    assert out["ber"] == 0.0 and out["transmitted_bits"] == 12000
    assert cm.cmatmul.launches_by_kernel["tf32x3"] >= gemms + 3
    if pipeline == "harq":
        assert out["num_transmissions"] == 1 and out["crc_pass"]
        assert bcjr.bcjr_half.launches > passes


@pytest.mark.cuda
def test_cli_papr_on_the_card_equals_the_cpu(cuda_device, capsys):
    import json
    from ofdm_lte_tpu_torch import cli
    argv = ["papr", "--bandwidth", "20", "--num-symbols", "50"]
    cli.main(argv)
    card = json.loads(capsys.readouterr().out)
    cli.main(argv + ["--device", "cpu"])
    cpu = json.loads(capsys.readouterr().out)
    assert list(card) == list(cpu)
    for label, row in cpu.items():
        for k, v in row.items():
            assert abs(card[label][k] - v) < 1e-3, (label, k)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline,shards", [("siso", 1), ("spatial", 2), ("harq", 1)])
def test_two_gloo_ranks_on_the_card_equal_the_one_device_sweep(cuda_device, pipeline, shards):
    """Two fresh interpreters in one gloo group, both on cuda:0, at 1.25 MHz
    QPSK under global bits and seams: the reduced counts equal the
    one-device sweep's, and the ranks agree."""
    from ofdm_lte_tpu_torch.parallel import mp_bench
    case = {"bandwidth": 1.25, "modulation": "QPSK", "symbols": 14, "pipeline": pipeline,
            "snr": [0.0, 6.0, 60.0], "frames": 2, "seed": 5, "shards": shards}
    if pipeline == "harq":
        case.update(snr=[-2.0, 30.0], tb_bits=104, rv=[0, 1], iterations=2)
    ranks = mp_bench.spawn(2, [{"job": "case", "case": case}], "cuda:0", timeout_s=300)
    r0, r1 = ({k: v for k, v in r[0].items() if k not in ("launches", "share")} for r in ranks)
    one = mp_bench.run_case({**case, "frames": case["frames"] * 2 // shards}, None, cuda_device)
    assert r0 == r1
    for key in one:
        if key == "papr_db":
            np.testing.assert_allclose(r0[key], one[key], rtol=1e-5)
        else:
            assert r0[key] == one[key], key
        if key in ("bit_errors", "stage_failures"):
            assert mp_bench.sum_of_shares([r[0] for r in ranks], key, len(case["snr"])) == r0[key]
    assert ranks[0][0]["launches"]["tf32x3"] > 0


@pytest.mark.cuda
def test_four_ranks_with_a_card_each_reduce_over_nccl(cuda_device):
    """Four fresh interpreters, a card each (NCCL), at 1.25 MHz QPSK under
    global bits and seams, 1-D, on 2 SNR shards and HARQ: the ranks agree,
    the reduced counts equal the sum of the ranks' lanes run one-device
    (the one-device sweep of all lanes may round a few GEMM sums
    otherwise: a rank's fewer rows split K otherwise)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    from ofdm_lte_tpu_torch.parallel import mp_bench
    base = {"bandwidth": 1.25, "modulation": "QPSK", "symbols": 14, "pipeline": "siso",
            "frames": 2, "seed": 9}
    cases = [{**base, "snr": [0.0, 6.0, 60.0]},
             {**base, "snr": [0.0, 6.0, 60.0], "shards": 2},
             {**base, "pipeline": "harq", "snr": [-2.0, 30.0], "tb_bits": 104, "rv": [0, 1],
              "iterations": 2}]
    ranks = mp_bench.spawn(4, [{"job": "case", "case": c} for c in cases], None, timeout_s=300)
    for i, case in enumerate(cases):
        results = [r[i] for r in ranks]
        counts = [{k: v for k, v in r.items() if k not in ("launches", "share")}
                  for r in results]
        assert all(c == counts[0] for c in counts)
        key = "stage_failures" if case["pipeline"] == "harq" else "bit_errors"
        assert mp_bench.sum_of_shares(results, key, len(case["snr"])) == counts[0][key]
        assert counts[0]["frames"] == case["frames"] * 4 // case.get("shards", 1)
