"""Image <-> bit-stream conversion and quality metrics.

Port of ofdm_lte_tpu/utils/image.py, a copy: NumPy only, so the port keeps
its own and imports nothing of the JAX package. It replaces the
reference's utils/image_processing.py (ImageProcessor):
- image_to_bits / bits_to_image via np.unpackbits/packbits with (h, w, c)
  metadata
- PSNR in the pixel domain
- SSIM (the reference uses scikit-image; this is a windowed SSIM with a
  uniform 8x8 window, written out)
- a side-by-side comparison saver (PNG via matplotlib Agg)

PIL and matplotlib are imported inside the functions that read or write a
file, so the module and the CLI import without them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def image_to_bits(img: np.ndarray) -> Tuple[np.ndarray, Dict]:
    """uint8 image (h, w[, c]) -> (bits, metadata)."""
    img = np.asarray(img, np.uint8)
    meta = {"shape": img.shape, "dtype": "uint8"}
    return np.unpackbits(img.flatten()), meta


def bits_to_image(bits: np.ndarray, meta: Dict) -> np.ndarray:
    shape = tuple(meta["shape"])
    n = int(np.prod(shape))
    b = np.asarray(bits, np.uint8)[:n * 8]
    if len(b) < n * 8:
        b = np.pad(b, (0, n * 8 - len(b)))
    return np.packbits(b)[:n].reshape(shape)


def load_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def save_image(img: np.ndarray, path: str) -> None:
    from PIL import Image
    Image.fromarray(np.asarray(img, np.uint8)).save(path)


def psnr(original: np.ndarray, received: np.ndarray,
         max_value: float = 255.0) -> float:
    """Peak SNR in dB."""
    o = np.asarray(original, np.float64)
    r = np.asarray(received, np.float64)
    mse = np.mean((o - r) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_value ** 2 / mse))


def bit_psnr(tx_bits: np.ndarray, rx_bits: np.ndarray) -> float:
    """Bit-domain PSNR: -10·log10(BER) style metric used by the reference's
    summary tables."""
    n = min(len(tx_bits), len(rx_bits))
    ber = np.mean(np.asarray(tx_bits[:n]) != np.asarray(rx_bits[:n]))
    if ber == 0:
        return float("inf")
    return float(-10.0 * np.log10(ber))


def ssim(a: np.ndarray, b: np.ndarray, window: int = 8,
         max_value: float = 255.0) -> float:
    """Mean structural similarity with a uniform window (grayscale; RGB
    inputs are averaged over channels)."""
    x = np.asarray(a, np.float64)
    y = np.asarray(b, np.float64)
    if x.ndim == 3:
        x = x.mean(axis=2)
        y = y.mean(axis=2)
    k1, k2 = 0.01, 0.03
    c1 = (k1 * max_value) ** 2
    c2 = (k2 * max_value) ** 2

    def win_mean(z):
        h, w = z.shape
        hh, ww = h - h % window, w - w % window
        return z[:hh, :ww].reshape(hh // window, window,
                                   ww // window, window).mean(axis=(1, 3))

    mx, my = win_mean(x), win_mean(y)
    mxx, myy, mxy = win_mean(x * x), win_mean(y * y), win_mean(x * y)
    vx = mxx - mx * mx
    vy = myy - my * my
    cxy = mxy - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / \
        ((mx ** 2 + my ** 2 + c1) * (vx + vy + c2))
    return float(np.mean(s))


def save_comparison(original: np.ndarray, received: np.ndarray, path: str,
                    title: str = "") -> None:
    """Side-by-side original/received PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(original)
    axes[0].set_title("Original")
    axes[0].axis("off")
    axes[1].imshow(np.asarray(received, np.uint8))
    axes[1].set_title(f"Received {title}".strip())
    axes[1].axis("off")
    p = psnr(original, received)
    fig.suptitle(f"PSNR {p:.2f} dB | SSIM {ssim(original, received):.4f}")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
