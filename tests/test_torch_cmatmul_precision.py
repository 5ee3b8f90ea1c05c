"""The complex GEMM at the `high` (TF32) and `default` (bf16) precisions, and
the error bound of `highest` (3xTF32).

The four kernels (csrc/cmatmul_wgmma_tf32.cu with one TF32 product a real
product; csrc/cmatmul_bf16.cu) run only on a card. Their
arithmetic is tested here through the plain versions that repeat it
(`ops.cmatmul.PLAIN`): operands rounded as the kernel rounds them, then
multiplied in true fp32. Each is held against the JAX package's Pallas
kernel in interpret mode fed the same rounded operands (on the CPU the JAX
kernel's precision is inert, so it multiplies them in fp32 too), and
against the exact product of the unrounded operands within
`rounding_bound`. The kernels are held against these plain versions in
tests/test_torch_cuda.py and by chip_smoke.py (phase 9). At `highest` the
plain 3xTF32 versions (`cmatmul_plain_tf32x3`, `cmatmul_plain_gauss_tf32x3`)
are held to the exact product within `rounding_bound("highest")`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.ops import pallas_kernels as pk

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.ops import cmatmul as cm
from ofdm_lte_tpu_torch.ops import ofdm as tofdm
from ofdm_lte_tpu_torch.sim import siso

torch.set_num_threads(2)

# (precision, gauss) -> the kernel whose arithmetic the plain version repeats
KERNELS = {("high", False): "tf32", ("high", True): "tf32_gauss",
           ("default", False): "bf16", ("default", True): "bf16_gauss"}
IDS = ["tf32", "tf32_gauss", "bf16", "bf16_gauss"]
# max|Δ| / max|C| between two sums of the same exact products in another
# order: chip_smoke.TOL's 4-dot and Gauss tolerances
TOL = {False: 1e-5, True: 1e-4}
# (M, K, N): ragged edges everywhere, and the TX GEMM's depth of 999
SHAPES = [(28, 300, 40), (8, 999, 64)]
ROUND = {"high": cm.tf32_round, "default": cm.bf16_round}


def _planes(rng, M, K, N):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((M, K), (M, K), (K, N), (K, N))]


def _jax_dot(x: torch.Tensor, y: torch.Tensor, K: int, gauss: bool, precision: str):
    """x @ y through the JAX package's Pallas kernel (interpret mode), as the
    real part of (x + 0j) @ (y + 0j); one block spans K, since the kernel
    leaves a ragged K block unmasked."""
    zx, zy = jnp.zeros(tuple(x.shape), jnp.float32), jnp.zeros(tuple(y.shape), jnp.float32)
    out = pk.cmatmul_pallas_2d(jcplx.C(jnp.asarray(x.numpy()), zx),
                               jcplx.C(jnp.asarray(y.numpy()), zy), bk=K, interpret=True,
                               gauss=gauss, precision=precision)
    return np.asarray(out.re)


def _rel(out: C, ref_re, ref_im) -> float:
    scale = max(np.abs(ref_re).max(), np.abs(ref_im).max())
    return max(np.abs(out.re.numpy() - ref_re).max(),
               np.abs(out.im.numpy() - ref_im).max()) / scale


@pytest.mark.skipif(not pk.HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("precision,gauss", list(KERNELS), ids=IDS)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_pallas_fed_rounded_operands(M, K, N, precision, gauss, rng):
    """The 4-dot form: the Pallas kernel on the rounded planes. The Gauss
    form rounds Ar+Ai and Br+Bi after an fp32 add, which no input of the
    Pallas kernel can carry (it adds the planes inside), so there its three
    real products come from the Pallas Gauss kernel one by one, each on
    rounded factors, and are folded as the kernel folds them; its real
    part also from one call on the rounded planes."""
    ar, ai, br, bi = _planes(rng, M, K, N)
    rnd = ROUND[precision]
    out = cm.PLAIN[KERNELS[precision, gauss]](C(ar, ai), C(br, bi))
    if gauss:
        t1 = _jax_dot(rnd(ar), rnd(br), K, True, precision)
        t2 = _jax_dot(rnd(ai), rnd(bi), K, True, precision)
        t3 = _jax_dot(rnd(ar + ai), rnd(br + bi), K, True, precision)
        ref_re, ref_im = t1 - t2, t3 - t1 - t2
        whole = pk.cmatmul_pallas_2d(
            jcplx.C(jnp.asarray(rnd(ar).numpy()), jnp.asarray(rnd(ai).numpy())),
            jcplx.C(jnp.asarray(rnd(br).numpy()), jnp.asarray(rnd(bi).numpy())),
            bk=K, interpret=True, gauss=True, precision=precision)
        scale = np.abs(ref_re).max()
        assert np.abs(out.re.numpy() - np.asarray(whole.re)).max() <= TOL[gauss] * scale
    else:
        ref = pk.cmatmul_pallas_2d(
            jcplx.C(jnp.asarray(rnd(ar).numpy()), jnp.asarray(rnd(ai).numpy())),
            jcplx.C(jnp.asarray(rnd(br).numpy()), jnp.asarray(rnd(bi).numpy())),
            bk=K, interpret=True, gauss=False, precision=precision)
        ref_re, ref_im = np.asarray(ref.re), np.asarray(ref.im)
    assert np.isfinite(ref_re).all() and np.isfinite(ref_im).all()
    assert _rel(out, ref_re, ref_im) <= TOL[gauss]


@pytest.mark.parametrize("precision,gauss", list(KERNELS), ids=IDS)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_within_rounding_bound_of_exact_product(M, K, N, precision, gauss, rng):
    ar, ai, br, bi = _planes(rng, M, K, N)
    out = cm.PLAIN[KERNELS[precision, gauss]](C(ar, ai), C(br, bi))
    a = ar.double().numpy() + 1j * ai.double().numpy()
    b = br.double().numpy() + 1j * bi.double().numpy()
    exact = a @ b
    mag = (np.abs(ar.double().numpy()) + np.abs(ai.double().numpy())) @ \
        (np.abs(br.double().numpy()) + np.abs(bi.double().numpy()))
    bound = cm.rounding_bound(precision, gauss, K) * mag
    d_re = np.abs(out.re.double().numpy() - exact.real)
    d_im = np.abs(out.im.double().numpy() - exact.imag)
    assert (d_re <= bound).all() and (d_im <= bound).all()
    # and the rounding shows: the product is not the fp32 one
    assert max(d_re.max(), d_im.max()) > 10 * np.abs(
        cm.cmatmul_plain(C(ar, ai), C(br, bi), gauss).re.double().numpy() - exact.real).max()


@pytest.mark.parametrize("gauss", [False, True], ids=["tf32x3", "tf32x3_gauss"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_highest_plain_within_rounding_bound_of_exact_product(M, K, N, gauss, rng):
    """The 3xTF32 products against the exact one: inside the split's bound,
    and as accurate as fp32 give or take a few units (the split leaves some
    2^-20 of each product, the fp32 sums 2^-24 an add)."""
    ar, ai, br, bi = _planes(rng, M, K, N)
    out = cm.PLAIN["tf32x3_gauss" if gauss else "tf32x3"](C(ar, ai), C(br, bi))
    a = ar.double().numpy() + 1j * ai.double().numpy()
    exact = a @ (br.double().numpy() + 1j * bi.double().numpy())
    mag = (np.abs(ar.double().numpy()) + np.abs(ai.double().numpy())) @ \
        (np.abs(br.double().numpy()) + np.abs(bi.double().numpy()))
    bound = cm.rounding_bound("highest", gauss, K) * mag
    d_re = np.abs(out.re.double().numpy() - exact.real)
    d_im = np.abs(out.im.double().numpy() - exact.imag)
    assert (d_re <= bound).all() and (d_im <= bound).all()
    fp32 = cm.cmatmul_plain(C(ar, ai), C(br, bi), gauss)
    err32 = max(np.abs(fp32.re.double().numpy() - exact.real).max(),
                np.abs(fp32.im.double().numpy() - exact.imag).max())
    assert max(d_re.max(), d_im.max()) <= 8 * err32


def test_rounding_bound_and_roundings():
    assert cm.UNIT_ROUNDOFF == {"high": 2.0 ** -11, "default": 2.0 ** -9}
    assert cm.rounding_bound("default", False, 16) == pytest.approx(2 ** -8 + 2 ** -18 + 2 ** -19)
    # 3xTF32: the split's 2^-20 (1 + 2^-11) + 2^-22 a product, far below TF32's 2^-10
    assert cm.rounding_bound("highest", False, 0) == pytest.approx(2 ** -20 + 2 ** -31 + 2 ** -22)
    assert cm.rounding_bound("highest", False, 999) < cm.rounding_bound("high", False, 999) / 8
    assert cm.rounding_bound("highest", True, 999) > 2 * cm.rounding_bound("highest", False, 999)
    assert cm.rounding_bound("high", True, 999) > 2 * cm.rounding_bound("high", False, 999)
    x = torch.tensor([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 3 * 2 ** -9, -(1.0 + 2 ** -12)])
    # bf16: to nearest, ties to even; TF32 head: to nearest, ties away from zero
    assert cm.bf16_round(x).tolist() == [1.0, 1.0 + 2 ** -6, 1.0 + 2 ** -7, -1.0]
    assert cm.tf32_round(torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12])
                         ).tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0]


@pytest.mark.skipif(not pk.HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("gauss", [False, True], ids=["fma4", "gauss"])
def test_cpu_product_is_fp32_at_every_precision(gauss, monkeypatch, rng):
    """On the CPU the knob is inert in both packages: the port's cmatmul and
    the JAX package's kernel give the same planes at all three precisions."""
    ar, ai, br, bi = _planes(rng, 28, 300, 40)
    ours, theirs = {}, {}
    for precision in ("highest", "high", "default"):
        monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", precision)
        ours[precision] = cm.cmatmul(C(ar, ai), C(br, bi), gauss=gauss)
        out = pk.cmatmul_pallas_2d(jcplx.C(jnp.asarray(ar.numpy()), jnp.asarray(ai.numpy())),
                                   jcplx.C(jnp.asarray(br.numpy()), jnp.asarray(bi.numpy())),
                                   interpret=True, gauss=gauss, precision=precision)
        theirs[precision] = (np.asarray(out.re), np.asarray(out.im))
    ref = cm.cmatmul_plain(C(ar, ai), C(br, bi), gauss)
    for precision in ("high", "default"):
        assert torch.equal(ours[precision].re, ref.re) and torch.equal(ours[precision].im, ref.im)
        assert np.array_equal(theirs[precision][0], theirs["highest"][0])
        assert np.array_equal(theirs[precision][1], theirs["highest"][1])
    assert cm.cmatmul.launches == 0


def test_kernel_rule_by_precision():
    """One kernel for each of the JAX package's six modes, by (form, precision)."""
    table = {(gauss, precision): cm._kernel_for(gauss, precision)
             for gauss in (False, True) for precision in ("highest", "high", "default")}
    assert table == {(False, "highest"): "tf32x3", (True, "highest"): "tf32x3_gauss",
                     (False, "high"): "tf32", (True, "high"): "tf32_gauss",
                     (False, "default"): "bf16", (True, "default"): "bf16_gauss"}
    assert set(cm.KERNELS) == set(cm.cmatmul.launches_by_kernel) == set(cm.PLAIN)
    assert len(cm.KERNELS) == 6
    for kernel, (precision, gauss) in cm.KERNELS.items():
        assert cm._kernel_for(gauss, precision) == kernel


@pytest.mark.parametrize("precision,gauss", list(KERNELS), ids=IDS)
def test_small_flagship_frame_decides_as_highest(precision, gauss, monkeypatch):
    """A 1.25 MHz 64-QAM frame of 4 lanes at 60 dB on the CPU: under the
    knob (inert here) and with the modem's GEMMs through the plain version of
    the precision's kernel, the decisions are `highest`'s, which are the
    transmitted bits."""
    cfg = LTEConfig(1.25, modulation="64-QAM")
    rng = np.random.default_rng(9)
    g = siso.grid_for(cfg)
    bits = rng.integers(0, 2, (4, siso.bits_per_frame(cfg, 14))).astype(np.int32)
    noise = ((rng.standard_normal((4, 14, g.num_data)), rng.standard_normal((4, 14, g.num_data))),
             (rng.standard_normal((4, 1, g.num_pilot)), rng.standard_normal((4, 1, g.num_pilot))))
    form = "gauss" if gauss else "fma4"
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_CMATMUL", form)
    highest = siso.simulate_siso(torch.from_numpy(bits), 60.0, cfg, noise=noise, device="cpu")
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", precision)
    knob = siso.simulate_siso(torch.from_numpy(bits), 60.0, cfg, noise=noise, device="cpu")
    plain = cm.PLAIN[KERNELS[precision, gauss]]
    monkeypatch.setattr(tofdm, "cmatmul", lambda a, b, gauss=False: plain(a, b))
    rounded = siso.simulate_siso(torch.from_numpy(bits), 60.0, cfg, noise=noise, device="cpu")
    assert torch.equal(knob.bits_rx, highest.bits_rx)
    assert torch.equal(rounded.bits_rx, highest.bits_rx)
    assert torch.equal(highest.bits_rx.to(torch.int32), torch.from_numpy(bits))
    assert float(rounded.ber.max()) == 0.0
