"""The operand layout and the sums of the wgmma GEMM kernels, at `highest`
(3xTF32, the 4-dot form), `high` (TF32) and `default` (bf16).

csrc/cmatmul_wgmma_tf32x3.cu, csrc/cmatmul_wgmma_tf32.cu and
csrc/cmatmul_bf16.cu run only on a card. What surrounds their shared main
loop is tested here through the plain twins in ops/cmatmul.py, at each
precision: B prepared as the kernels prepare it (`wgmma_prep_b`: K-major, K
padded to a whole slab with zeros; rounded to TF32 or bf16, Br + Bi formed
in fp32 for the Gauss form; at `highest` split by `tf32_split` into the
heads and tails of −Bi, Br and Bi), A copied where TMA cannot read it at
`highest` and `high` (`wgmma_copy_a`: raw fp32, padded) and prepared at
every call at `default` (`wgmma_prep_a`: rounded to bf16, Ar + Ai formed in
fp32), the workspace's size, the slab depth and chain length that the twins
share with each source, and the product of those operands summed chain by
chain as the kernels sum it (`cmatmul_plain_wgmma_slabs`: chains of one
32-deep slab at `highest`, four at `high`, two 64-deep ones at `default`),
against the plain versions that specify the kernels (`cmatmul_plain_tf32x3`,
`cmatmul_plain_tf32`, `cmatmul_plain_gauss_tf32`, `cmatmul_plain_bf16`,
`cmatmul_plain_gauss_bf16`) and against the JAX package's Pallas kernel in
interpret mode fed the rounded operands. tests/test_torch_cuda.py and
chip_smoke.py (phases 3 and 9) hold the kernels themselves to the plain
versions on the card."""
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
# every wgmma kernel: (precision, gauss); the test ids are the kernels' names
KERNELS = {"tf32x3": ("highest", False), "tf32": ("high", False), "tf32_gauss": ("high", True),
           "bf16": ("default", False), "bf16_gauss": ("default", True)}


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


def _b_planes(b: C, precision: str, gauss: bool) -> list:
    """The (K, N) planes that the kernel's prep of B holds, transposed:
    each rounded at `high` and `default`; at `highest` tf32_split's heads
    of −Bi, Br and Bi, then their tails."""
    if precision == "highest":
        (rh, rl), (ih, il) = cm.tf32_split(b.re), cm.tf32_split(b.im)
        return [-ih, rh, ih, -il, rl, il]
    planes = [b.re, b.im] + ([b.re + b.im] if gauss else [])
    if precision == "high":
        return [cm.tf32_round(x) for x in planes]
    return [x.to(torch.bfloat16) for x in planes]


@pytest.mark.parametrize("kernel", list(KERNELS), ids=list(KERNELS))
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_prepared_b_is_the_rounded_planes_k_major(M, K, N, kernel, rng):
    """B (K, N) becomes (planes, N, Kp): each plane Br, Bi (and Br + Bi added
    in fp32) rounded to TF32 (float32 words) or to bf16 (to nearest even,
    bfloat16), or at `highest` the heads and tails of −Bi, Br and Bi as
    tf32_split splits them, transposed, bit for bit, zeros past K."""
    precision, gauss = KERNELS[kernel]
    _, b = _operands(rng, M, K, N)
    bt = cm.wgmma_prep_b(b, gauss, precision)
    kp, bk = cm.wgmma_padded_k(K, precision), cm.WGMMA_BK[precision]
    assert kp % bk == 0 and K <= kp < K + bk
    planes = _b_planes(b, precision, gauss)
    dtype = cm.WGMMA_DTYPE[precision]
    assert bt.shape == (len(planes), N, kp) and bt.dtype == dtype
    for p, want in enumerate(planes):
        assert torch.equal(bt[p, :, :K].contiguous().view(torch.uint8),
                           want.t().to(dtype).contiguous().view(torch.uint8))
    assert torch.equal(bt[:, :, K:], torch.zeros_like(bt[:, :, K:]))
    # rounded once: rounding again changes no bit (a tail is a TF32 value too)
    again = cm.WGMMA_ROUND.get(precision, cm.tf32_round)(bt.float()).to(dtype)
    assert torch.equal(again.view(torch.uint8), bt.view(torch.uint8))
    if precision == "highest":
        # the heads and tails stand for B to within 2^-21 of each value
        heads, tails = bt[1:3, :, :K].double(), bt[4:6, :, :K].double()
        exact = torch.stack([b.re.t(), b.im.t()]).double()
        assert ((heads + tails - exact).abs() <= 2.0 ** -21 * exact.abs()).all()
        assert torch.equal(bt[0], -bt[2]) and torch.equal(bt[3], -bt[5])


def test_highest_has_no_wgmma_gauss_form(rng):
    """At `highest` the Gauss form is the mma.sync kernel tf32x3_gauss, which
    prepares nothing: the twins refuse it."""
    a, b = _operands(rng, 4, 40, 8)
    for call in (lambda: cm.wgmma_prep_b(b, True, "highest"),
                 lambda: cm.wgmma_workspace_floats(4, 8, 40, True, False, 1, "highest"),
                 lambda: cm.cmatmul_plain_wgmma_slabs(a, b, True, "highest")):
        with pytest.raises(ValueError, match="tf32x3_gauss"):
            call()


@pytest.mark.parametrize("operand", ["a", "b"])
def test_prepared_gauss_plane_is_formed_in_fp32_then_rounded(operand):
    """The Gauss plane is rnd(Xr + Xi) with the sum in fp32, not rnd(Xr) +
    rnd(Xi): for Xr = 1 and Xi = 2^-8 + 2^-16 the fp32 sum rounds up to bf16's
    1 + 2^-7, where bf16's Xr + Xi would be 1 + 2^-8, between two bf16 values
    (ties to even: 1)."""
    xr = torch.full((3, 2), 1.0)
    xi = torch.full((3, 2), 2.0 ** -8 + 2.0 ** -16)
    if operand == "a":
        planes = cm.wgmma_prep_a(C(xr, xi), True)[:, :, :2]
    else:
        planes = cm.wgmma_prep_b(C(xr, xi), True, "default")[:, :, :3].transpose(1, 2)
    assert torch.equal(planes[2].float(), torch.full((3, 2), 1.0 + 2.0 ** -7))
    assert torch.equal((xr.to(torch.bfloat16) + xi.to(torch.bfloat16)).float(), xr)


@pytest.mark.parametrize("gauss", [False, True], ids=["bf16", "bf16_gauss"])
@pytest.mark.parametrize("view", ["dense", "cp_stripped", "slot_start", "odd_base"])
def test_prepared_a_is_the_rounded_planes(view, gauss, rng):
    """At `default` A is prepared at every call, whatever view the caller
    passed: (planes, M, Kp) bf16, Ar, Ai (and Ar + Ai added in fp32) rounded
    to nearest even, bit for bit, zeros past K."""
    y = C(*(torch.from_numpy(rng.standard_normal((28, 160)).astype(np.float32))
            for _ in range(2)))
    a = {"dense": C(y.re[:, :100].contiguous(), y.im[:, :100].contiguous()),
         "cp_stripped": y[:, 32:], "slot_start": y[::14, 32:], "odd_base": y[:, 1:100]}[view]
    M, K = a.re.shape
    at = cm.wgmma_prep_a(a, gauss)
    planes = [a.re, a.im] + ([a.re + a.im] if gauss else [])
    assert at.shape == (len(planes), M, cm.wgmma_padded_k(K, "default"))
    assert at.dtype == torch.bfloat16
    for p, x in enumerate(planes):
        assert torch.equal(at[p, :, :K].contiguous().view(torch.int16),
                           x.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(at[:, :, K:], torch.zeros_like(at[:, :, K:]))


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


@pytest.mark.parametrize("name,value,source", [
    pytest.param(name, value, source,
                 id=f"{name}-{value}" if precision == "high" else f"{precision}-{name}-{value}")
    for precision, (source, _) in chip_smoke.WGMMA_SOURCES.items()
    for name, value in (("BK", cm.WGMMA_BK[precision]), ("CHAIN", cm.WGMMA_CHAIN[precision]))])
def test_twin_constants_are_the_kernel_source(name, value, source):
    """The slab depth and the chain length that the plain twins repeat are the
    ones csrc/cmatmul_wgmma_tf32.cu and csrc/cmatmul_bf16.cu compile with."""
    src = (Path(cm.__file__).parents[1] / "csrc" / source).read_text()
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


@pytest.mark.parametrize("kernel", list(KERNELS), ids=list(KERNELS))
@pytest.mark.parametrize("M,K,N,a_copy,splits", [
    (3584, 999, 2192, True, 1), (3584, 2048, 999, False, 1), (256, 2048, 200, False, 16),
    (1024, 16, 30688, False, 1), (5, 7, 3, True, 1), (0, 7, 3, True, 1), (5, 0, 3, False, 1),
    (14336, 25, 500, True, 1), (64, 32, 300, False, 1), (64, 33, 300, True, 1)])
def test_workspace_is_what_the_prepared_operands_take(M, K, N, a_copy, splits, kernel):
    """The workspace, in floats: B prepared (a bf16 value takes half the
    float of a TF32 one), A prepared at `default` or copied where it must be
    at `high`, the partial planes of a K split; nothing for an empty
    product."""
    precision, gauss = KERNELS[kernel]
    floats = cm.wgmma_workspace_floats(M, N, K, gauss, a_copy, splits, precision)
    if precision == "highest" and min(M, N, K) > 0:     # B's six planes of TF32 values
        assert floats >= 6 * N * cm.wgmma_padded_k(K, precision)
    if min(M, N, K) == 0:
        assert floats == 0
        return
    b = C(torch.zeros(K, N), torch.zeros(K, N))
    a = C(torch.zeros(M, K), torch.zeros(M, K))
    bt = cm.wgmma_prep_b(b, gauss, precision)
    assert bt.numel() * bt.element_size() % 16 == 0     # A's planes start 16-byte aligned
    want = bt.numel() * bt.element_size() // 4
    if precision == "default":
        at = cm.wgmma_prep_a(a, gauss)
        want += at.numel() * at.element_size() // 4
    elif a_copy:
        want += cm.wgmma_copy_a(a).numel()
    want += 2 * splits * M * N if splits > 1 else 0
    assert floats == want


@pytest.mark.parametrize("kernel", list(KERNELS), ids=list(KERNELS))
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_slab_sums_match_the_plain_version(M, K, N, kernel, rng):
    """The prepared operands summed chain by chain as the kernel sums them are
    the plain version's exact products in another order: within chip_smoke's
    tolerance of it, and within the rounding's bound of the exact product (at
    `highest` the bound of the 3xTF32 split, rounding_bound("highest"))."""
    precision, gauss = KERNELS[kernel]
    a, b = _operands(rng, M, K, N)
    out = cm.cmatmul_plain_wgmma_slabs(a, b, gauss, precision)
    assert _rel(out, cm.PLAIN[kernel](a, b)) <= chip_smoke.TOL[kernel]
    exact_a = a.re.double().numpy() + 1j * a.im.double().numpy()
    exact = exact_a @ (b.re.double().numpy() + 1j * b.im.double().numpy())
    mag = (a.re.abs() + a.im.abs()).double().numpy() @ (b.re.abs() + b.im.abs()).double().numpy()
    bound = cm.rounding_bound(precision, gauss, K) * mag
    assert (np.abs(out.re.double().numpy() - exact.real) <= bound).all()
    assert (np.abs(out.im.double().numpy() - exact.imag) <= bound).all()


def test_slab_sums_read_a_strided_view(rng):
    """The CP-stripped view that the RX GEMMs read in place."""
    y = C(*(torch.from_numpy(rng.standard_normal((14, 2192)).astype(np.float32))
            for _ in range(2)))
    _, b = _operands(rng, 1, 2048, 50)
    view = y[:, 144:]
    dense = C(view.re.contiguous(), view.im.contiguous())
    for precision, gauss in KERNELS.values():
        out = cm.cmatmul_plain_wgmma_slabs(view, b, gauss, precision)
        ref = cm.cmatmul_plain_wgmma_slabs(dense, b, gauss, precision)
        assert torch.equal(out.re, ref.re) and torch.equal(out.im, ref.im)
        plain = cm.PLAIN[next(k for k, v in KERNELS.items() if v == (precision, gauss))]
        assert _rel(out, plain(dense, b)) <= chip_smoke.TOL["tf32_gauss" if gauss else "tf32"]


def _against_pallas(precision, M, K, N, rng) -> float:
    """The 4-dot twin at `precision` against the JAX package's Pallas kernel
    at that precision in interpret mode, fed the operands rounded as the
    kernel rounds them (its precision is inert on the CPU, so it multiplies
    them in fp32): the same exact products, summed in another order."""
    a, b = _operands(rng, M, K, N)
    out = cm.cmatmul_plain_wgmma_slabs(a, b, False, precision)
    rounded = cm.WGMMA_ROUND.get(precision, lambda x: x)     # `highest` feeds it raw
    rnd = [jnp.asarray(rounded(x).numpy()) for x in (a.re, a.im, b.re, b.im)]
    ref = pk.cmatmul_pallas_2d(jcplx.C(rnd[0], rnd[1]), jcplx.C(rnd[2], rnd[3]), bk=K,
                               interpret=True, gauss=False, precision=precision)
    return _rel(out, C(torch.from_numpy(np.array(ref.re)), torch.from_numpy(np.array(ref.im))))


@pytest.mark.skipif(not pk.HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("M,K,N", [(12, 999, 40), (16, 16, 64), (9, 25, 30)])
def test_slab_sums_match_pallas_fed_rounded_operands(M, K, N, rng):
    """At `high`: operands rounded to TF32."""
    assert _against_pallas("high", M, K, N, rng) <= chip_smoke.TOL["tf32"]


@pytest.mark.skipif(not pk.HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("M,K,N", [(12, 999, 40), (8, 2048, 24), (16, 16, 64)])
def test_highest_slab_sums_match_pallas(M, K, N, rng):
    """At `highest`: the Pallas kernel fed the raw operands, which it
    multiplies in fp32 on the CPU; the split's error lies inside the sum-order
    tolerance."""
    assert _against_pallas("highest", M, K, N, rng) <= chip_smoke.TOL["tf32x3"]


@pytest.mark.skipif(not pk.HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("M,K,N", [(12, 999, 40), (8, 2048, 24), (16, 16, 64), (9, 25, 30)])
def test_bf16_slab_sums_match_pallas_fed_rounded_operands(M, K, N, rng):
    """At `default`: operands rounded to bf16, to nearest even; K = 2048 is
    the largest K of any path."""
    assert _against_pallas("default", M, K, N, rng) <= chip_smoke.TOL["bf16"]
