"""ofdm_lte_tpu_torch — the LTE PHY simulator ported to PyTorch and CUDA.

A second package beside the JAX package `ofdm_lte_tpu`, which stays the
reference it is tested against. It imports torch and NumPy and never JAX.
Complex values are planar (`C`, a pair of float32 tensors); the modem's
complex GEMMs run in hand-written Hopper tensor-core kernels
(ops/cmatmul.py, csrc/cmatmul_wgmma_tf32x3.cu and its siblings) and each
BCJR pass of the turbo decoder in another (ops/bcjr.py,
csrc/turbo_bcjr.cu) on CUDA tensors, and in plain PyTorch on CPU tensors.
Its objects run on the CUDA card unless the caller passes `device="cpu"`
(device.py).

Ported so far: the SISO link in its OFDM, SC-FDM and simple modes over
AWGN, flat fading and Jakes/ITU multipath, with and without CRS
equalization (sim/siso.py, channel/rayleigh.py); the SIMO-MRC and 2×N
Alamouti SFBC diversity links (sim/diversity.py, channel/mimo.py); the
metrics (utils/metrics.py); TM4 spatial multiplexing (sim/spatial.py,
mimo/); TM6/TM4 beamforming with CSI feedback (sim/beamforming.py,
mimo/beamforming.py, mimo/csi.py); the TS 36.212 coded chain (coding/:
CRC, segmentation, rate matching, the turbo code; ops/qam.llrs) and the
coded SISO sims with HARQ (sim/coded.py); the one-device sweeps
(parallel/sweep.py: ber_sweep, harq_sweep); the facade over them (api.py);
and the command-line interface over the facade and the sweeps
(`python -m ofdm_lte_tpu_torch.cli <command>`: info, run, sweep, fullsweep,
image, bfcompare, papr), with utils/image.py. The N-process sweeps are not
ported yet (ROADMAP.md).
"""

from .config import LTEConfig, LTE_PROFILES, CP_VALUES_US, MODULATION_SCHEMES
from .cplx import C
from .api import OFDMModule, OFDMSimulator, create_simulator

__all__ = ["LTEConfig", "LTE_PROFILES", "CP_VALUES_US", "MODULATION_SCHEMES",
           "C", "OFDMModule", "OFDMSimulator", "create_simulator"]
