"""The port's utils/image.py and ops/qam.constellation / ser against the JAX
package's, and the image round trips of tests/test_image_roundtrip.py
through the port's facade on the CPU, with the JAX package's on the same
image beside them where the result is random."""
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import LTEConfig as JLTEConfig
from ofdm_lte_tpu import cplx as jcplx
from ofdm_lte_tpu.api import OFDMSimulator as JOFDMSimulator
from ofdm_lte_tpu.ops import qam as jqam
from ofdm_lte_tpu.utils import image as jimg

from ofdm_lte_tpu_torch import LTEConfig, OFDMSimulator
from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.ops import qam as tqam
from ofdm_lte_tpu_torch.utils import image as timg

torch.set_num_threads(2)

MODULATIONS = ["QPSK", "16-QAM", "64-QAM"]


@pytest.fixture(scope="module")
def test_image():
    """The structured synthetic image of tests/test_image_roundtrip.py."""
    rng = np.random.default_rng(42)
    x = np.linspace(0, 255, 48)
    img = np.zeros((48, 48, 3), np.uint8)
    img[..., 0] = x[None, :].astype(np.uint8)
    img[..., 1] = x[:, None].astype(np.uint8)
    img[..., 2] = rng.integers(0, 256, (48, 48))
    return img


@pytest.mark.parametrize("modulation", MODULATIONS)
def test_constellation_is_the_jax_one(modulation):
    ours, ref = tqam.constellation(modulation), jqam.constellation(modulation)
    assert ours.dtype == ref.dtype == np.complex128
    np.testing.assert_array_equal(ours, ref)
    # index order: modulating an index's bits gives its point
    bits = tqam.indices_to_bits(torch.arange(len(ours), dtype=torch.int32), modulation)
    sym = tqam.modulate(bits.reshape(-1), modulation)
    np.testing.assert_allclose(sym.to_numpy(), ours, atol=1e-6)


@pytest.mark.parametrize("modulation", MODULATIONS)
def test_ser_equals_jax_under_the_same_symbols(modulation, rng):
    pts = jqam.constellation(modulation)
    tx = pts[rng.integers(0, len(pts), 4000)]
    rx = tx + 0.3 * (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
    ours = tqam.ser(tcplx.from_numpy(tx), tcplx.from_numpy(rx), modulation)
    ref = jqam.ser(jcplx.C(np.float32(tx.real), np.float32(tx.imag)),
                   jcplx.C(np.float32(rx.real), np.float32(rx.imag)), modulation)
    assert ours.dtype == torch.float32 and ours.ndim == 0
    assert ours.item() == float(ref) and 0.0 < ours.item() < 1.0


def test_image_functions_equal_jax(test_image, rng):
    noisy = np.clip(test_image.astype(int) + rng.integers(-20, 21, test_image.shape),
                    0, 255).astype(np.uint8)
    bits, meta = timg.image_to_bits(test_image)
    jbits, jmeta = jimg.image_to_bits(test_image)
    np.testing.assert_array_equal(bits, jbits)
    assert meta == jmeta
    flipped = bits.copy()
    flipped[::97] ^= 1
    for b in (bits, flipped, bits[:-100]):
        np.testing.assert_array_equal(timg.bits_to_image(b, meta), jimg.bits_to_image(b, meta))
    np.testing.assert_array_equal(timg.bits_to_image(bits, meta), test_image)
    assert timg.psnr(test_image, noisy) == jimg.psnr(test_image, noisy)
    assert timg.psnr(test_image, test_image) == float("inf")
    assert timg.ssim(test_image, noisy) == jimg.ssim(test_image, noisy)
    assert timg.ssim(test_image[..., 0], noisy[..., 0]) == jimg.ssim(test_image[..., 0],
                                                                     noisy[..., 0])
    assert timg.bit_psnr(bits, flipped) == jimg.bit_psnr(bits, flipped)
    assert timg.bit_psnr(bits, bits) == float("inf")


def test_save_and_load_image(test_image, tmp_path):
    path = str(tmp_path / "img.png")
    timg.save_image(test_image, path)
    np.testing.assert_array_equal(timg.load_image(path), jimg.load_image(path))
    np.testing.assert_array_equal(timg.load_image(path), test_image)


def _roundtrip(sim_method, img, snr, **kw):
    bits, meta = timg.image_to_bits(img)
    r = sim_method(bits.astype(np.int32), snr, **kw)
    return r, timg.bits_to_image(r["bits_received_array"], meta)


def test_siso_image_high_snr(test_image):
    sim = OFDMSimulator(LTEConfig(bandwidth=5.0, modulation="16-QAM"), device="cpu")
    r, rec = _roundtrip(sim.simulate_siso, test_image, 40.0)
    assert r["ber"] == 0.0
    np.testing.assert_array_equal(rec, test_image)


def test_siso_image_noisy_psnr_beside_jax(test_image):
    """Moderate SNR: errors occur but the image stays recognizable, as in
    the JAX package on the same image: the two BERs within 5σ of each other
    (binomial over the image's bits)."""
    sim = OFDMSimulator(LTEConfig(bandwidth=5.0, modulation="64-QAM"), device="cpu")
    r, rec = _roundtrip(sim.simulate_siso, test_image, 17.0)
    jsim = JOFDMSimulator(JLTEConfig(bandwidth=5.0, modulation="64-QAM"))
    bits, meta = jimg.image_to_bits(test_image)
    jr = jsim.simulate_siso(bits.astype(np.int32), 17.0)
    assert 0.0 < r["ber"] < 0.1 and 0.0 < jr["ber"] < 0.1
    p = (r["ber"] + jr["ber"]) / 2
    assert abs(r["ber"] - jr["ber"]) < 5 * np.sqrt(2 * p * (1 - p) / len(bits))
    assert 10.0 < timg.psnr(test_image, rec) < 60.0
    assert timg.ssim(test_image, rec) > 0.3


def test_simo_image_rayleigh(test_image):
    sim = OFDMSimulator(LTEConfig(bandwidth=5.0, modulation="QPSK"),
                        channel_type="rayleigh_mp", itu_profile="Pedestrian_A",
                        velocity_kmh=3.0, device="cpu")
    r, rec = _roundtrip(sim.simulate_simo, test_image, 15.0, num_rx=4)
    assert r["ber"] < 0.01
    assert timg.psnr(test_image, rec) > 25.0


def test_mimo_sfbc_image(test_image):
    sim = OFDMSimulator(LTEConfig(bandwidth=5.0, modulation="QPSK"), device="cpu")
    r, _ = _roundtrip(sim.simulate_mimo, test_image, 14.0, num_rx=2)
    assert r["ber"] < 0.05


def test_coded_image_clean_at_waterfall(test_image):
    """A turbo-coded image at moderate SNR reconstructs exactly."""
    sim = OFDMSimulator(LTEConfig(bandwidth=5.0, modulation="QPSK"), device="cpu")
    bits, meta = timg.image_to_bits(test_image)
    r = sim.simulate_siso_coded(bits, 6.0)
    assert r["crc_pass"]
    np.testing.assert_array_equal(timg.bits_to_image(r["bits_received_array"], meta),
                                  test_image)


def test_comparison_png_saved(test_image, tmp_path):
    out = tmp_path / "cmp.png"
    timg.save_comparison(test_image, test_image, str(out), "test")
    assert out.exists() and out.stat().st_size > 1000


def test_no_module_level_pil_or_matplotlib():
    """PIL and matplotlib stay inside the functions that write or read a
    file: the card's machine has neither."""
    import ast
    import pathlib
    import ofdm_lte_tpu_torch
    root = pathlib.Path(ofdm_lte_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("PIL", "matplotlib") for n in names), path
