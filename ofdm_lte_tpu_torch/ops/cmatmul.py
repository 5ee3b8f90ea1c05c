"""The modem's planar complex GEMM: the CUDA kernel's wrapper and its plain
version.

Counterpart of ofdm_lte_tpu/ops/pallas_kernels.py. `cmatmul` computes
(..., M0, K) @ (K, N) on (re, im) float32 planes, with the leading batch
dimensions flattened into M, in the 4-dot form or the 3-dot Gauss form:

- on a CPU tensor it runs `cmatmul_plain`, the same products through
  torch.matmul (the form the CPU tests compare with the JAX package);
- on a CUDA tensor it launches the hand-written kernel in
  csrc/cmatmul.cu, built on first use (see _build.py), or raises. It never
  falls back to the plain version. Each launch adds one to
  `cmatmul.launches`.
"""
from __future__ import annotations

import torch

from .. import cplx
from ..cplx import C
from ..precision import matmul_precision_name


def cmatmul_plain(a: C, b: C, gauss: bool = False) -> C:
    """Plain PyTorch complex matmul, 4-multiply or Gauss form, in fp32.

    On a CUDA tensor it turns TF32 off, so that it is the fp32 reference
    the kernel is held against."""
    if a.re.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return cplx.matmul_gauss(a, b) if gauss else cplx.matmul(a, b)


def _plane_2d(x: torch.Tensor, k: int, what: str) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"cmatmul: {what} must be float32, got {x.dtype}")
    x2 = x.reshape(-1, k)            # a view whenever the strides allow it
    if k > 1 and x2.stride(1) != 1:
        raise ValueError(f"cmatmul: {what} needs unit inner stride, got {x2.stride()}")
    return x2


def _ld(x2: torch.Tensor) -> int:
    return x2.stride(0) if x2.shape[0] > 1 else x2.shape[1]


def cmatmul(a: C, b: C, gauss: bool = False, bsum: torch.Tensor = None) -> C:
    """Complex matmul a (..., M0, K) @ b (K, N) -> (..., M0, N).

    gauss=True selects the 3-dot Gauss form; `bsum` is b.re + b.im,
    precomputed by a caller whose B is a constant (formed here if None)."""
    dev = a.re.device
    if dev.type == "cpu":
        return cmatmul_plain(a, b, gauss)
    if dev.type != "cuda":
        raise ValueError(f"cmatmul: no kernel for device {dev}")
    name = matmul_precision_name()
    if name != "highest":
        raise NotImplementedError(
            f"cmatmul: the CUDA kernel implements precision 'highest' only, got "
            f"{name!r}; TF32 'high' and bf16 'default' are ROADMAP item B5")

    K = a.shape[-1]
    if a.re.shape != a.im.shape or b.re.shape != b.im.shape or b.re.ndim != 2 \
            or b.re.shape[0] != K:
        raise ValueError(f"cmatmul: shapes {tuple(a.re.shape)}/{tuple(a.im.shape)} @ "
                         f"{tuple(b.re.shape)}/{tuple(b.im.shape)}")
    for t in (a.im, b.re, b.im):
        if t.device != dev:
            raise ValueError(f"cmatmul: operands on {dev} and {t.device}")
    N = b.re.shape[1]
    ar, ai = _plane_2d(a.re, K, "a.re"), _plane_2d(a.im, K, "a.im")
    br, bi = _plane_2d(b.re, N, "b.re"), _plane_2d(b.im, N, "b.im")
    if _ld(ar) != _ld(ai) or _ld(br) != _ld(bi):
        raise ValueError("cmatmul: the re and im planes need the same strides")
    if gauss:
        bsum = (b.re + b.im) if bsum is None else bsum
        if bsum.shape != b.re.shape or bsum.device != dev:
            raise ValueError(f"cmatmul: bsum {tuple(bsum.shape)} on {bsum.device}")
        bsum = _plane_2d(bsum, N, "bsum")
        if _ld(bsum) != _ld(br):
            raise ValueError("cmatmul: bsum needs the strides of b")
    M = ar.shape[0]
    lda, ldb = _ld(ar), _ld(br)
    if max(M, N, K, lda, ldb) >= 2 ** 31:
        raise ValueError("cmatmul: a dimension or stride exceeds int32")

    lead = tuple(a.shape[:-1])
    cr = torch.empty((M, N), dtype=torch.float32, device=dev)
    ci = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return C(cr.reshape(lead + (N,)), ci.reshape(lead + (N,)))
    from .._build import library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cmatmul_f32(ar.data_ptr(), ai.data_ptr(), lda,
                             br.data_ptr(), bi.data_ptr(),
                             bsum.data_ptr() if gauss else None, ldb,
                             cr.data_ptr(), ci.data_ptr(), N,
                             M, N, K, int(gauss), stream)
    if rc != 0:
        raise RuntimeError(f"cmatmul_f32 launch failed: CUDA error {rc} "
                           f"(M={M}, N={N}, K={K}, gauss={gauss})")
    cmatmul.launches += 1
    return C(cr.reshape(lead + (N,)), ci.reshape(lead + (N,)))


cmatmul.launches = 0
