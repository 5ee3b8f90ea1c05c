"""The Gauss (3-product) form of the complex GEMM against the JAX package.

The tensor-core Gauss kernel (csrc/cmatmul_tc_gauss.cu) runs only on a
card; its arithmetic (Ar+Ai and Br+Bi formed in fp32, the TF32 head/tail
split of three planes a side, nine products, the fold) is tested here
through `cmatmul_plain_gauss_tf32x3`, and the kernel is held against that
function in tests/test_torch_cuda.py and by chip_smoke.py."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.cplx import C as JC
from ofdm_lte_tpu.grid import grid_for
from ofdm_lte_tpu.ops import ofdm as jofdm
from ofdm_lte_tpu.ops import pallas_kernels as pk
from ofdm_lte_tpu.rx import estimation as jest
from ofdm_lte_tpu.sim import siso as jsiso

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.ops import cmatmul as cm
from ofdm_lte_tpu_torch.ops import ofdm as tofdm
from ofdm_lte_tpu_torch.sim import diversity as tdiv
from ofdm_lte_tpu_torch.sim import siso as tsiso

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)

# max|Δ| / max|C| between two fp32-accurate Gauss products: the form's bound
# in this repo (the imaginary part is t3 − t1 − t2, which cancels: one more
# rounding of the size of |t1| + |t2| than the 4-dot form's 1e-5)
TOL = 1e-4
PALLAS_SHAPES = [(64, 128, 96), (300, 512, 260), (128, 512, 260)]
RAGGED_SHAPES = [(28, 999, 300), (28, 2048, 200), (5, 7, 3)]


def _operands(rng, M, K, N):
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((M, K), (M, K), (K, N), (K, N))]
    jx = (JC(jnp.asarray(planes[0]), jnp.asarray(planes[1])),
          JC(jnp.asarray(planes[2]), jnp.asarray(planes[3])))
    tc = (C(torch.from_numpy(planes[0]), torch.from_numpy(planes[1])),
          C(torch.from_numpy(planes[2]), torch.from_numpy(planes[3])))
    return jx, tc


def _rel_diff(out: C, ref) -> float:
    ref_re, ref_im = np.asarray(ref.re), np.asarray(ref.im)
    scale = max(np.abs(ref_re).max(), np.abs(ref_im).max())
    return max(np.abs(out.re.numpy() - ref_re).max(),
               np.abs(out.im.numpy() - ref_im).max()) / scale


@pytest.mark.skipif(not pk.HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("M,K,N", PALLAS_SHAPES)
def test_plain_gauss_tf32x3_matches_pallas_gauss_interpret(M, K, N, rng):
    (ja, jb), (ta, tb) = _operands(rng, M, K, N)
    ref = pk.cmatmul_pallas_2d(ja, jb, interpret=True, gauss=True)
    assert _rel_diff(cm.cmatmul_plain_gauss_tf32x3(ta, tb), ref) <= TOL


@pytest.mark.parametrize("M,K,N", RAGGED_SHAPES)
def test_plain_gauss_tf32x3_matches_jax_gauss_at_ragged_shapes(M, K, N, rng):
    """K = 999 and 2048 are the TX and RX depths. The Pallas kernel leaves a
    ragged K edge unmasked (NaN in interpret mode), so the reference is the
    JAX package's own Gauss product."""
    (ja, jb), (ta, tb) = _operands(rng, M, K, N)
    ref = jcplx.matmul_gauss(ja, jb, precision=jax.lax.Precision.HIGHEST)
    assert _rel_diff(cm.cmatmul_plain_gauss_tf32x3(ta, tb), ref) <= TOL
    assert _rel_diff(cm.cmatmul(ta, tb, gauss=True), ref) <= TOL


@pytest.mark.parametrize("M,K,N", PALLAS_SHAPES + RAGGED_SHAPES)
def test_plain_gauss_tf32x3_keeps_the_forms_fp32_accuracy(M, K, N, rng):
    """Against a float64 product the 3xTF32 Gauss form is no worse than the
    fp32 Gauss form by more than a factor of 2 (the margin `tf32x3` is held
    to for the 4-dot form: the split pair stands for x to 2^-21, the three
    kept terms are exact in fp32, and only the order of the sums differs),
    plus 1e-7 of max|C|, which is fp32's own last bit at the tiny shape."""
    (_, _), (ta, tb) = _operands(rng, M, K, N)
    exact = (ta.re.numpy().astype(np.float64) + 1j * ta.im.numpy()) @ \
            (tb.re.numpy().astype(np.float64) + 1j * tb.im.numpy())
    scale = np.abs(exact).max()

    def err(out):
        return np.abs(out.re.numpy() + 1j * out.im.numpy().astype(np.float64) - exact).max()

    split = err(cm.cmatmul_plain_gauss_tf32x3(ta, tb))
    assert split <= 2 * err(cm.cmatmul_plain(ta, tb, gauss=True)) + 1e-7 * scale
    assert split <= 1e-5 * scale


def test_operand_sums_are_the_ieee_fp32_sum_bit_for_bit(rng):
    """The kernel forms Br+Bi (and Ar+Ai) with one rounded fp32 add a value
    (`__fadd_rn`, IEEE round to nearest), the plain version with `+`: the
    same bits as NumPy's fp32 add, so the kernel and its plain version
    multiply the same third operand."""
    re, im = (rng.standard_normal((64, 48)).astype(np.float32) for _ in range(2))
    ieee_sum = torch.from_numpy(re + im)
    assert torch.equal(torch.from_numpy(re) + torch.from_numpy(im), ieee_sum)
    # the sum is split like any other plane: the pair stands for it to 2^-21
    hi, lo = cm.tf32_split(ieee_sum)
    assert (ieee_sum.double() - hi.double() - lo.double()).abs().max() \
        <= 2.0 ** -21 * ieee_sum.abs().max()


def test_fold_is_linear_over_k_splits(rng):
    """A K split stores partial (Cr, Ci) planes and the second pass adds
    them: t1 − t2 and t3 − t1 − t2 are linear in the three sums, so the
    partial planes of two halves of K add up to the whole product."""
    (_, _), (ta, tb) = _operands(rng, 24, 96, 40)
    whole = cm.cmatmul_plain_gauss_tf32x3(ta, tb)
    halves = [cm.cmatmul_plain_gauss_tf32x3(C(ta.re[:, s], ta.im[:, s]), C(tb.re[s], tb.im[s]))
              for s in (slice(0, 48), slice(48, 96))]
    total = C(halves[0].re + halves[1].re, halves[0].im + halves[1].im)
    assert _rel_diff(total, whole) <= 1e-6


def test_cpu_tensor_runs_the_fp32_gauss_form(rng):
    (_, _), (ta, tb) = _operands(rng, 6, 10, 4)
    ref = cm.cmatmul_plain(ta, tb, gauss=True)
    before = dict(cm.cmatmul.launches_by_kernel)
    out = cm.cmatmul(ta, tb, gauss=True)
    assert torch.equal(out.re, ref.re) and torch.equal(out.im, ref.im)
    assert cm.cmatmul.launches_by_kernel == before


def _jax_same_noise(bits, snr_db, cfg, noise, mode="lte"):
    """The JAX package's own stages with the given standard normals added at
    the bins, scaled as in sim/siso.py:_receive_awgn_freq."""
    sig = jsiso.transmit(jnp.asarray(bits), cfg, mode)
    snr_lin = 10.0 ** (jnp.asarray(snr_db, jnp.float32) / 10.0)
    std = jnp.sqrt((jnp.mean(sig.abs2(), axis=-1) / snr_lin)[..., None, None] / 2.0)
    g = grid_for(cfg)
    y = jofdm.frame_stream(sig, cfg)
    y_data = jofdm.demodulate_bins(y, cfg, g.data_idx)
    y_pil = jofdm.demodulate_bins(y[..., jest.slot_start_indices(y.shape[-2]), :], cfg,
                                  g.pilot_idx)
    (dr, di), (pr, pi) = noise
    y_data = JC(y_data.re + jnp.asarray(dr, jnp.float32) * std,
                y_data.im + jnp.asarray(di, jnp.float32) * std)
    y_pil = JC(y_pil.re + jnp.asarray(pr, jnp.float32) * std,
               y_pil.im + jnp.asarray(pi, jnp.float32) * std)
    return jsiso._detect_from_bins(y_data, y_pil, cfg, mode)[0]


def _siso_link(mode):
    """The SISO link over AWGN under the bin-noise seam, against the JAX
    package's stages with the same noise."""
    def run(rng, monkeypatch):
        jc, tc = jcfg.LTEConfig(5.0, modulation="64-QAM"), LTEConfig(5.0, modulation="64-QAM")
        lanes, symbols = 4, 28
        bits = rng.integers(0, 2, (lanes, jsiso.bits_per_frame(jc, symbols))).astype(np.int32)
        g = grid_for(jc)
        noise = tuple((rng.standard_normal(shape), rng.standard_normal(shape))
                      for shape in ((lanes, symbols, g.num_data), (lanes, 2, g.num_pilot)))
        r = tsiso.simulate_siso(torch.from_numpy(bits), 20.0, tc, noise=noise, device="cpu",
                                mode=mode)
        return bits, r, np.asarray(_jax_same_noise(bits, 20.0, jc, noise, mode))
    return run


def _sfbc_link(rng, monkeypatch):
    """2x2 SFBC (sim/diversity.py) under its noise seam, against the JAX
    package's stages with the same noise."""
    from test_torch_diversity import _jax_sfbc_same_noise
    jc, tc = jcfg.LTEConfig(5.0, modulation="16-QAM"), LTEConfig(5.0, modulation="16-QAM")
    lanes, symbols, num_rx = 3, 28, 2
    g = grid_for(jc)
    n_even = len(tdiv.sfbc_data_bins(tc))
    bits = rng.integers(0, 2, (lanes, tdiv.sfbc_bits_per_frame(tc, symbols))).astype(np.int32)
    noise = tuple((rng.standard_normal(s), rng.standard_normal(s))
                  for s in ((num_rx, lanes, symbols, n_even), (num_rx, lanes, 2, g.num_pilot)))
    r = tdiv.simulate_sfbc(torch.from_numpy(bits), 12.0, tc, num_rx=num_rx, device="cpu",
                           draws={"noise": noise})
    return bits, r, np.asarray(_jax_sfbc_same_noise(bits, 12.0, jc, num_rx, noise)[0])


def _spatial_link(rng, monkeypatch):
    """The 4x2 rank-2 MMSE spatial link (sim/spatial.py) on its time path,
    under the draws the JAX package makes from the same key."""
    from test_torch_spatial import run_both
    j, t, bits = run_both(5.0, "64-QAM", 25.0, impl="time", monkeypatch=monkeypatch,
                          num_tx=4, num_rx=2, rank=2, detector_type="MMSE")
    return bits, t, np.asarray(j.bits_rx)


# link -> (run, GEMM calls a run: TX, RX data, RX pilot, and SC-FDM's
# precode and decode, BER range)
LINKS = {"siso": (_siso_link("lte"), 3, (0.005, 0.02)),
         "scfdm": (_siso_link("sc-fdm"), 5, (0.005, 0.05)),
         "sfbc": (_sfbc_link, 3, (0.0, 0.1)),
         "spatial": (_spatial_link, 3, (0.0, 0.3))}


@pytest.mark.parametrize("link,arithmetic", [
    pytest.param("siso", "fp32", id="fp32"), pytest.param("siso", "tf32x3", id="tf32x3"),
    pytest.param("scfdm", "tf32x3", id="scfdm"), pytest.param("sfbc", "tf32x3", id="sfbc"),
    pytest.param("spatial", "tf32x3", id="spatial")])
def test_link_under_gauss_form_matches_jax_with_same_noise(link, arithmetic, monkeypatch, rng):
    """A whole link with every GEMM in the Gauss form, in fp32 (what a CPU
    tensor gets) and in the tensor-core kernel's own arithmetic (the wrapper
    replaced by `cmatmul_plain_gauss_tf32x3`): only rounding differs from the
    JAX package's link under the same noise, so at most 1e-4 of the
    decisions may. The SISO link in its OFDM and SC-FDM modes, 2x2 SFBC and
    the spatial link's time path: every link whose B operands are constant
    tables."""
    monkeypatch.setenv("OFDM_LTE_TPU_TORCH_CMATMUL", "gauss")
    calls = []

    def through_kernel_arithmetic(a, b, gauss=False):
        calls.append(gauss)
        lead = tuple(a.shape[:-1])
        out = cm.cmatmul_plain_gauss_tf32x3(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(lead + (b.shape[1],))

    if arithmetic == "tf32x3":
        monkeypatch.setattr(tofdm, "cmatmul", through_kernel_arithmetic)
    run, n_calls, (lo, hi) = LINKS[link]
    bits, r, j_bits = run(rng, monkeypatch)
    if arithmetic == "tf32x3":
        assert calls == [True] * n_calls
    mismatch = int(np.sum(r.bits_rx.numpy() != j_bits))
    assert mismatch <= 1e-4 * bits.size, mismatch
    assert lo < r.ber.mean().item() < hi
