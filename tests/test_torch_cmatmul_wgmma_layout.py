"""The operand layout and the sums of the `high` (TF32) GEMM kernels.

csrc/cmatmul_wgmma_tf32.cu runs only on a card. What surrounds its main loop
is tested here through the plain twins in ops/cmatmul.py: B prepared as the
kernel prepares it (`wgmma_prep_b`: K-major, rounded to TF32, K padded to a
whole slab with zeros, Br + Bi for the Gauss form), A copied where TMA cannot
read it (`wgmma_copy_a`: raw, padded), the workspace's size, the slab depth
and chain length that the twins share with the kernel's source, and the
product of those operands summed chain by chain as the kernel sums it
(`cmatmul_plain_tf32_slabs`: chains of four 32-deep slabs), against the plain
versions that specify the kernels (`cmatmul_plain_tf32`,
`cmatmul_plain_gauss_tf32`) and against the JAX package's Pallas kernel in
interpret mode fed the rounded operands.
tests/test_torch_cuda.py and chip_smoke.py (phase 9) hold the kernels
themselves to the plain versions on the card."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.ops import pallas_kernels as pk

from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.ops import cmatmul as cm

torch.set_num_threads(2)

# (M, K, N): a ragged K, the TX and RX data GEMMs' K = 999 and N = 999 at a
# narrow M, the Jakes product's K = 16 and the extended CRS layout's K = 25
SHAPES = [(20, 300, 40), (12, 999, 999), (8, 2048, 999), (40, 16, 300), (30, 25, 70),
          (5, 7, 3)]
KERNEL = {False: "tf32", True: "tf32_gauss"}
FORMS = [False, True]
FORM_IDS = ["tf32", "tf32_gauss"]


def _operands(rng, M, K, N):
    planes = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((M, K), (M, K), (K, N), (K, N))]
    return C(planes[0], planes[1]), C(planes[2], planes[3])


def _rel(out: C, ref: C) -> float:
    scale = max(ref.re.abs().max().item(), ref.im.abs().max().item())
    return max((out.re - ref.re).abs().max().item(),
               (out.im - ref.im).abs().max().item()) / scale


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("gauss", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_prepared_b_is_the_rounded_planes_k_major(M, K, N, gauss, rng):
    """B (K, N) becomes (planes, N, Kp): each plane tf32_round of Br, Bi (and
    of Br + Bi added in fp32), transposed, bit for bit, zeros past K."""
    _, b = _operands(rng, M, K, N)
    bt = cm.wgmma_prep_b(b, gauss)
    kp = cm.wgmma_padded_k(K)
    assert kp % cm.WGMMA_BK == 0 and K <= kp < K + cm.WGMMA_BK
    planes = [b.re, b.im] + ([b.re + b.im] if gauss else [])
    assert bt.shape == (len(planes), N, kp) and bt.dtype == torch.float32
    for p, x in enumerate(planes):
        assert torch.equal(_bits(bt[p, :, :K]), _bits(cm.tf32_round(x).t()))
    assert torch.equal(bt[:, :, K:], torch.zeros_like(bt[:, :, K:]))
    # rounded once: rounding again changes no bit
    assert torch.equal(_bits(cm.tf32_round(bt)), _bits(bt))


@pytest.mark.parametrize("view", ["dense", "cp_stripped", "slot_start", "odd_base"])
def test_copied_a_is_the_raw_planes_padded(view, rng):
    """A copied for TMA keeps the raw fp32 values (the kernel rounds them
    after forming Ar + Ai), at pitch Kp with zeros past K, whatever view the
    caller passed."""
    y = C(*(torch.from_numpy(rng.standard_normal((28, 160)).astype(np.float32))
            for _ in range(2)))
    a = {"dense": C(y.re[:, :100].contiguous(), y.im[:, :100].contiguous()),
         "cp_stripped": y[:, 32:], "slot_start": y[::14, 32:], "odd_base": y[:, 1:100]}[view]
    M, K = a.re.shape
    at = cm.wgmma_copy_a(a)
    assert at.shape == (2, M, cm.wgmma_padded_k(K))
    assert torch.equal(_bits(at[0, :, :K]), _bits(a.re))
    assert torch.equal(_bits(at[1, :, :K]), _bits(a.im))
    assert torch.equal(at[:, :, K:], torch.zeros_like(at[:, :, K:]))


@pytest.mark.parametrize("name,value", [("BK", cm.WGMMA_BK), ("CHAIN", cm.WGMMA_CHAIN)])
def test_twin_constants_are_the_kernel_source(name, value):
    """The slab depth and the chain length that the plain twins repeat are the
    ones csrc/cmatmul_wgmma_tf32.cu compiles with."""
    src = (Path(cm.__file__).parents[1] / "csrc" / "cmatmul_wgmma_tf32.cu").read_text()
    found = re.findall(rf"^constexpr int {name} = (\d+);", src, flags=re.M)
    assert found == [str(value)]


def test_a_is_copied_only_where_tma_cannot_read_it():
    """TMA needs a 16-byte-aligned base and a row pitch of whole 16 bytes."""
    y = torch.zeros(64, 2192)
    assert y.data_ptr() % 16 == 0
    assert not cm.wgmma_a_needs_copy(y[:, 144:], y[:, 144:], 2192)      # the CP-stripped view
    assert not cm.wgmma_a_needs_copy(y[::14, 144:], y[::14, 144:], 14 * 2192)
    assert cm.wgmma_a_needs_copy(y[:, 1:], y[:, 144:], 2192)             # a base off 16 bytes
    assert cm.wgmma_a_needs_copy(y, y, 999)                               # K = 999 at TX
    assert not cm.wgmma_a_needs_copy(y, y, 1000)


@pytest.mark.parametrize("gauss", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("M,K,N,a_copy,splits", [
    (3584, 999, 2192, True, 1), (3584, 2048, 999, False, 1), (256, 2048, 200, False, 16),
    (1024, 16, 30688, False, 1), (5, 7, 3, True, 1), (0, 7, 3, True, 1), (5, 0, 3, False, 1),
    (14336, 25, 500, True, 1), (64, 32, 300, False, 1), (64, 33, 300, True, 1)])
def test_workspace_is_what_the_prepared_operands_take(M, K, N, a_copy, splits, gauss):
    """The workspace: B prepared, A copied where it must be, the partial
    planes of a K split; nothing for an empty product."""
    floats = cm.wgmma_workspace_floats(M, N, K, gauss, a_copy, splits)
    if min(M, N, K) == 0:
        assert floats == 0
        return
    b = C(torch.zeros(K, N), torch.zeros(K, N))
    a = C(torch.zeros(M, K), torch.zeros(M, K))
    want = cm.wgmma_prep_b(b, gauss).numel()
    want += cm.wgmma_copy_a(a).numel() if a_copy else 0
    want += 2 * splits * M * N if splits > 1 else 0
    assert floats == want


@pytest.mark.parametrize("gauss", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_slab_sums_match_the_plain_version(M, K, N, gauss, rng):
    """The prepared operands summed chain by chain as the kernel sums them are
    the plain version's exact products in another order: within chip_smoke's
    tolerance of it, and within the rounding's bound of the exact product."""
    a, b = _operands(rng, M, K, N)
    kernel = KERNEL[gauss]
    out = cm.cmatmul_plain_tf32_slabs(a, b, gauss)
    assert _rel(out, cm.PLAIN[kernel](a, b)) <= chip_smoke.TOL[kernel]
    exact_a = a.re.double().numpy() + 1j * a.im.double().numpy()
    exact = exact_a @ (b.re.double().numpy() + 1j * b.im.double().numpy())
    mag = (a.re.abs() + a.im.abs()).double().numpy() @ (b.re.abs() + b.im.abs()).double().numpy()
    bound = cm.rounding_bound("high", gauss, K) * mag
    assert (np.abs(out.re.double().numpy() - exact.real) <= bound).all()
    assert (np.abs(out.im.double().numpy() - exact.imag) <= bound).all()


def test_slab_sums_read_a_strided_view(rng):
    """The CP-stripped view that the RX GEMMs read in place."""
    y = C(*(torch.from_numpy(rng.standard_normal((14, 2192)).astype(np.float32))
            for _ in range(2)))
    _, b = _operands(rng, 1, 2048, 50)
    view = y[:, 144:]
    dense = C(view.re.contiguous(), view.im.contiguous())
    for gauss in FORMS:
        out = cm.cmatmul_plain_tf32_slabs(view, b, gauss)
        ref = cm.cmatmul_plain_tf32_slabs(dense, b, gauss)
        assert torch.equal(out.re, ref.re) and torch.equal(out.im, ref.im)


@pytest.mark.skipif(not pk.HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("M,K,N", [(12, 999, 40), (16, 16, 64), (9, 25, 30)])
def test_slab_sums_match_pallas_fed_rounded_operands(M, K, N, rng):
    """The 4-dot form against the JAX package's Pallas kernel at `high` in
    interpret mode, fed the operands rounded to TF32 (its precision is inert
    on the CPU, so it multiplies them in fp32): the same exact products."""
    a, b = _operands(rng, M, K, N)
    out = cm.cmatmul_plain_tf32_slabs(a, b, False)
    rnd = [jnp.asarray(cm.tf32_round(x).numpy()) for x in (a.re, a.im, b.re, b.im)]
    ref = pk.cmatmul_pallas_2d(jcplx.C(rnd[0], rnd[1]), jcplx.C(rnd[2], rnd[3]), bk=K,
                               interpret=True, gauss=False, precision="high")
    assert _rel(out, C(torch.from_numpy(np.array(ref.re)),
                       torch.from_numpy(np.array(ref.im)))) <= chip_smoke.TOL["tf32"]
