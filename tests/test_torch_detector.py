"""Every MIMO detector of the port against ofdm_lte_tpu.mimo.detector on the
same NumPy inputs: the plane solvers and the stacked detectors, ranks 1 to
4, scalar and per-lane σ². Soft outputs agree to 1e-4 of max|ŝ|; SIC's hard
outputs are identical, ties in its order included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.mimo import detector as jdet

from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.mimo import detector as tdet
from ofdm_lte_tpu_torch.ops import qam as tqam

torch.set_num_threads(2)

LANES, S, M = 3, 2, 40
SIGMAS = {"scalar": 0.05, "per_lane": np.array([0.3, 0.05, 0.002], np.float32)}


def _cn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _system(rng, num_rx, L, modulation="16-QAM", noise=0.05):
    """y = H s + n with s on the constellation: (y (..., rx), H (..., rx, L), s)."""
    bits = rng.integers(0, 2, (LANES, S, M, L * tqam.spec(modulation).bits_per_symbol))
    s = tqam.modulate(torch.from_numpy(bits), modulation).to_numpy()         # (..., L)
    H = _cn(rng, (LANES, S, M, num_rx, L))
    y = (H @ s[..., None])[..., 0] + noise * _cn(rng, (LANES, S, M, num_rx))
    return y, H, s


def _planes(y, H, conv):
    """The stacked system as lists of (..., S, m) planes."""
    return ([conv(y[..., r]) for r in range(H.shape[-2])],
            [[conv(H[..., r, l]) for l in range(H.shape[-1])] for r in range(H.shape[-2])])


def _close(t, j, rel=1e-4):
    jn = np.asarray(j.re) + 1j * np.asarray(j.im)
    assert tuple(t.shape) == jn.shape
    np.testing.assert_allclose(t.to_numpy(), jn, rtol=0, atol=rel * np.abs(jn).max())


def _jsig(sigma):
    return jnp.asarray(sigma) if isinstance(sigma, np.ndarray) else sigma


@pytest.mark.parametrize("sigma", list(SIGMAS))
@pytest.mark.parametrize("num_rx,L", [(2, 1), (2, 2), (4, 3), (4, 4)])
def test_mmse_planes_match_jax(num_rx, L, sigma, rng):
    y, H, s = _system(rng, num_rx, L)
    s2 = SIGMAS[sigma]
    jy, jh = _planes(y, H, jcplx.from_numpy)
    ty, th = _planes(y, H, tcplx.from_numpy)
    j, t = jdet.mmse_planes(jy, jh, _jsig(s2)), tdet.mmse_planes(ty, th, s2)
    assert len(t) == L
    for tp, jp in zip(t, j):
        _close(tp, jp)
    # and the planes are the stacked detector's layers
    stacked = tdet.mmse(tcplx.from_numpy(y), tcplx.from_numpy(H), s2)
    for l in range(L):
        np.testing.assert_allclose(t[l].to_numpy(), stacked.to_numpy()[..., l], atol=2e-4)


@pytest.mark.parametrize("num_rx,L", [(2, 2), (4, 3), (4, 4)])
def test_zf_planes_match_jax(num_rx, L, rng):
    """ZF is the plane MMSE with σ² = 1e-9: the 4×4 Schur path is
    ill-conditioned there in fp32, so it is held to the JAX result on the
    same inputs and, loosely, to the transmitted symbols."""
    y, H, s = _system(rng, num_rx, L, noise=0.0)
    jy, jh = _planes(y, H, jcplx.from_numpy)
    ty, th = _planes(y, H, tcplx.from_numpy)
    j, t = jdet.mmse_planes(jy, jh, jnp.float32(1e-9)), tdet.mmse_planes(ty, th, 1e-9)
    for l, (tp, jp) in enumerate(zip(t, j)):
        _close(tp, jp, 2e-3)
        assert np.median(np.abs(tp.to_numpy() - s[..., l])) < 1e-3


@pytest.mark.parametrize("sigma", list(SIGMAS))
@pytest.mark.parametrize("num_rx,L", [(2, 1), (2, 2), (4, 3), (4, 4)])
def test_sic_planes_hard_outputs_identical(num_rx, L, sigma, rng):
    y, H, s = _system(rng, num_rx, L)
    s2 = SIGMAS[sigma]
    jy, jh = _planes(y, H, jcplx.from_numpy)
    ty, th = _planes(y, H, tcplx.from_numpy)
    j = jdet.sic_planes(jy, jh, _jsig(s2), "16-QAM")
    t = tdet.sic_planes(ty, th, s2, "16-QAM")
    wrong = 0
    for l, (tp, jp) in enumerate(zip(t, j)):
        jn = np.asarray(jp.re) + 1j * np.asarray(jp.im)
        assert np.array_equal(tp.to_numpy(), jn.astype(np.complex64))
        wrong += int(np.sum(np.abs(tp.to_numpy() - s[..., l]) > 1e-3))
    assert wrong <= 0.1 * s.size


@pytest.mark.parametrize("layout", ["planes", "stacked"])
def test_sic_order_breaks_ties_as_jax(layout, rng):
    """Equal-power columns (as W of PMI 0 at 2 TX gives): the stage order is
    the lowest index first in both packages, so the decisions are equal."""
    L, num_rx = 4, 4
    y, H, s = _system(rng, num_rx, L)
    H = H / np.linalg.norm(H, axis=-2, keepdims=True)       # unit columns: exact SINR ties
    H[..., 2] = H[..., 0] * 1j                                # and two collinear columns
    y = (H @ s[..., None])[..., 0]
    if layout == "planes":
        jy, jh = _planes(y, H, jcplx.from_numpy)
        ty, th = _planes(y, H, tcplx.from_numpy)
        j = jcplx.stack(jdet.sic_planes(jy, jh, 0.1, "16-QAM"), axis=-1)
        t = tcplx.stack(tdet.sic_planes(ty, th, 0.1, "16-QAM"), axis=-1)
    else:
        j = jdet.sic(jcplx.from_numpy(y), jcplx.from_numpy(H), 0.1, "16-QAM")
        t = tdet.sic(tcplx.from_numpy(y), tcplx.from_numpy(H), 0.1, "16-QAM")
    jn = (np.asarray(j.re) + 1j * np.asarray(j.im)).astype(np.complex64)
    assert np.mean(t.to_numpy() != jn) <= 1e-3


@pytest.mark.parametrize("sigma", list(SIGMAS))
@pytest.mark.parametrize("name,num_rx,L", [("mmse", 2, 1), ("mmse", 2, 2), ("mmse", 4, 3),
                                           ("mmse", 4, 4), ("mmse_unbiased", 2, 2),
                                           ("mmse_unbiased", 4, 3), ("mmse_unbiased", 4, 4)])
def test_stacked_soft_detectors_match_jax(name, num_rx, L, sigma, rng):
    y, H, _ = _system(rng, num_rx, L)
    s2 = SIGMAS[sigma]
    j = getattr(jdet, name)(jcplx.from_numpy(y), jcplx.from_numpy(H), _jsig(s2))
    t = getattr(tdet, name)(tcplx.from_numpy(y), tcplx.from_numpy(H), s2)
    _close(t, j)


@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_stacked_zf_mrc_and_sic_match_jax(L, rng):
    y, H, s = _system(rng, 4, L)
    jy, jH, ty, tH = (jcplx.from_numpy(y), jcplx.from_numpy(H), tcplx.from_numpy(y),
                      tcplx.from_numpy(H))
    _close(tdet.zf(ty, tH), jdet.zf(jy, jH), 1e-3)
    for s2 in SIGMAS.values():
        j, t = jdet.sic(jy, jH, _jsig(s2), "16-QAM"), tdet.sic(ty, tH, s2, "16-QAM")
        jn = (np.asarray(j.re) + 1j * np.asarray(j.im)).astype(np.complex64)
        assert np.array_equal(t.to_numpy(), jn)
    if L == 1:
        _close(tdet.mrc(ty, tH), jdet.mrc(jy, jH))


@pytest.mark.parametrize("detector_type", ["MMSE", "IRC", "MMSE-U", "ZF", "SIC", "MRC"])
def test_detect_dispatch_with_precoder_matches_jax(detector_type, rng):
    from ofdm_lte_tpu_torch.mimo import codebook
    L = 1 if detector_type == "MRC" else 2
    W = codebook.get_precoder(3, 4, "TM4", L)
    y, _, _ = _system(rng, 2, L)
    H = _cn(rng, (LANES, S, M, 2, 4))
    s2 = SIGMAS["per_lane"]
    j = jdet.detect(jcplx.from_numpy(y), jcplx.from_numpy(H), jnp.asarray(s2), detector_type,
                    jcplx.from_numpy(W), "16-QAM")
    t = tdet.detect(tcplx.from_numpy(y), tcplx.from_numpy(H), s2, detector_type,
                    tcplx.from_numpy(W), "16-QAM")
    _close(t, j, 1e-3 if detector_type == "ZF" else 1e-4)
    _close(tdet.effective_channel(tcplx.from_numpy(H), tcplx.from_numpy(W)),
           jdet.effective_channel(jcplx.from_numpy(H), jcplx.from_numpy(W)))


def test_detect_rejects_what_jax_rejects(rng):
    y, H, _ = _system(rng, 2, 2)
    ty, tH = tcplx.from_numpy(y), tcplx.from_numpy(H)
    with pytest.raises(ValueError, match="MRC"):
        tdet.detect(ty, tH, 0.1, "MRC")
    with pytest.raises(ValueError, match="not supported"):
        tdet.detect(ty, tH, 0.1, "ML")
    # SIC without a constellation falls back to MMSE, as in the JAX package
    _close(tdet.detect(ty, tH, 0.1, "SIC"), jdet.mmse(jcplx.from_numpy(y),
                                                      jcplx.from_numpy(H), 0.1))
    with pytest.raises(ValueError, match="L<=4"):
        tdet._solve_planes([[None] * 5] * 5, [None] * 5)


def _sic_inputs(rng, num_rx, num_tx, L, sigma):
    """The link's SIC operands on the CPU: y (rx, ...), the per-TX planes
    h_tx[t] (rx, ...), a TM4 precoder W (tx, L) and σ²."""
    from ofdm_lte_tpu_torch.mimo import codebook
    y = tcplx.from_numpy(_cn(rng, (num_rx, LANES, S, M)))
    h_tx = [tcplx.from_numpy(_cn(rng, (num_rx, LANES, S, M))) for _ in range(num_tx)]
    W = tcplx.from_numpy(codebook.get_precoder(1, num_tx, "TM4", L))
    s2 = SIGMAS[sigma]
    return y, h_tx, W, torch.from_numpy(s2) if isinstance(s2, np.ndarray) else s2


@pytest.mark.parametrize("sigma", list(SIGMAS))
@pytest.mark.parametrize("num_rx,num_tx,L", [(4, 4, 4), (2, 4, 2), (4, 4, 3), (2, 2, 1)])
def test_sic_detect_off_the_card_is_heff_and_sic_stacked(num_rx, num_tx, L, sigma, rng):
    """On a CPU tensor ops/sic_detect is its plain version: the effective
    channel Σ_t h_tx[t]·W[t, l] summed in t order, then sic_stacked, bit for
    bit, in the (..., S, m, L) layout; no launch is counted."""
    from ofdm_lte_tpu_torch.ops import sic_detect as sd
    y, h_tx, W, s2 = _sic_inputs(rng, num_rx, num_tx, L, sigma)
    h = tcplx.stack(h_tx, axis=0)                                     # (tx, rx, ...)
    w = W.reshape((num_tx, 1, L, 1, 1, 1))
    heff = None
    for t in range(num_tx):
        term = tcplx.C(h.re[t][:, None], h.im[t][:, None]) * w[t]
        heff = term if heff is None else heff + term
    want = tdet.sic_stacked(y, heff, s2, "16-QAM")
    launches = sd.sic_detect.launches
    got = sd.sic_detect(y, h_tx, W, s2, "16-QAM")
    assert tuple(got.shape) == (LANES, S, M, L)
    assert torch.equal(got.re, want.re.movedim(0, -1))
    assert torch.equal(got.im, want.im.movedim(0, -1))
    assert sd.sic_detect.launches == launches
    # each decision is a constellation point: the quantizer leaves it as it is
    again = tqam.detect(got, "16-QAM")
    assert torch.equal(again.re, got.re) and torch.equal(again.im, got.im)


def test_sic_detect_rejects_what_the_kernel_cannot_take(rng):
    from ofdm_lte_tpu_torch.ops import sic_detect as sd
    y, h_tx, W, s2 = _sic_inputs(rng, 2, 4, 2, "scalar")
    with pytest.raises(ValueError, match="share one"):
        sd.sic_detect(y, h_tx[:3] + [h_tx[3][:, :1]], W, s2, "QPSK")
    with pytest.raises(ValueError, match="expected"):
        sd.sic_detect(y, h_tx[:3], W, s2, "QPSK")
    with pytest.raises(ValueError, match="L in 1..4"):
        sd.sic_detect(y, h_tx, tcplx.czeros((4, 5)), s2, "QPSK")
    with pytest.raises(ValueError, match="1..8"):
        sd.sic_detect(y, h_tx * 3, tcplx.czeros((12, 2)), s2, "QPSK")
