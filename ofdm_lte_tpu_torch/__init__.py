"""ofdm_lte_tpu_torch — the LTE PHY simulator ported to PyTorch and CUDA.

A second package beside the JAX package `ofdm_lte_tpu`, which stays the
reference it is tested against. It imports torch and NumPy and never JAX.
Complex values are planar (`C`, a pair of float32 tensors); the modem's
complex GEMMs run in a hand-written Hopper kernel (ops/cmatmul.py,
csrc/cmatmul.cu) on CUDA tensors and in plain PyTorch on CPU tensors.

Ported so far: the SISO link over AWGN with CRS estimation and ZF
(sim/siso.py) and its facade (api.py).
"""

from .config import LTEConfig, LTE_PROFILES, CP_VALUES_US, MODULATION_SCHEMES
from .cplx import C
from .api import OFDMModule, OFDMSimulator

__all__ = ["LTEConfig", "LTE_PROFILES", "CP_VALUES_US", "MODULATION_SCHEMES",
           "C", "OFDMModule", "OFDMSimulator"]
