"""The modem's planar complex GEMM: the CUDA kernels' wrapper and their
plain versions.

Counterpart of ofdm_lte_tpu/ops/pallas_kernels.py. `cmatmul` computes
(..., M0, K) @ (K, N) on (re, im) float32 planes, with the leading batch
dimensions flattened into M, in the 4-dot form or the 3-dot Gauss form:

- on a CPU tensor it runs `cmatmul_plain`, the same products through
  torch.matmul in true fp32 (the form the CPU tests compare with the JAX
  package);
- on a CUDA tensor it launches a hand-written kernel, built on first use
  (see _build.py), or raises. It never falls back to a plain version or to
  another kernel. Which kernel serves a call is the rule in `_kernel_for`:
  the 4-dot form goes to the tensor-core kernel csrc/cmatmul_tc.cu
  (`cmatmul_tf32x3`: mma.sync, three TF32 products per real product, as
  accurate as fp32) unless the caller asks for `variant="ffma"`; the
  Gauss form and `variant="ffma"` go to the fp32 CUDA-core kernel
  csrc/cmatmul.cu (`cmatmul_f32`). Each call that launches adds one to
  `cmatmul.launches` and to its kernel's entry in
  `cmatmul.launches_by_kernel` (a split-K call counts once).

`cmatmul_plain_tf32x3` repeats the tensor-core kernel's arithmetic (the
TF32 head/tail split and the twelve products) in plain PyTorch; the tests
and chip_smoke.py hold the kernel against it.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from .. import cplx
from ..cplx import C
from ..precision import matmul_precision_name

VARIANTS = ("tc", "ffma")
_default_variant = "tc"


@contextlib.contextmanager
def default_variant(variant: str):
    """Within the block, calls of `cmatmul` that name no variant use this one
    (how a whole link is driven through the CUDA-core kernel)."""
    global _default_variant
    if variant not in VARIANTS:
        raise ValueError(f"cmatmul: variant {variant!r}; pick from {VARIANTS}")
    saved, _default_variant = _default_variant, variant
    try:
        yield
    finally:
        _default_variant = saved


def _kernel_for(gauss: bool, variant: str) -> str:
    """The one rule that says which kernel serves a CUDA call."""
    if gauss:
        return "f32_gauss"
    return "tf32x3" if variant == "tc" else "f32_fma4"


def cmatmul_plain(a: C, b: C, gauss: bool = False) -> C:
    """Plain PyTorch complex matmul, 4-multiply or Gauss form, in fp32.

    On a CUDA tensor it turns TF32 off, so that it is the fp32 reference
    the kernel is held against."""
    if a.re.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return cplx.matmul_gauss(a, b) if gauss else cplx.matmul(a, b)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ≈ hi + lo with hi and lo float32 values that TF32 holds exactly,
    split as the tensor-core kernel splits (csrc/cmatmul_tc.cu:split_tf32).

    hi is x rounded to nearest (ties away from zero) to TF32's 10 explicit
    mantissa bits, by integer arithmetic on the fp32 bit pattern; lo is
    x − hi (exact in fp32) cut to its top 10 mantissa bits, which is all a
    tensor core reads of an operand. |x − hi − lo| < 2⁻²¹ |x|."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def cmatmul_plain_tf32x3(a: C, b: C) -> C:
    """The tensor-core kernel's arithmetic in plain PyTorch: each real product
    as hi·lo + lo·hi + hi·hi of the TF32 split, twelve fp32 matmuls in all.

    A product of two TF32 values is exact in fp32, so this differs from the
    kernel only in the order of the sums."""
    if a.re.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False

    def dot(x, y):
        (xh, xl), (yh, yl) = x, y
        return (xh @ yl + xl @ yh) + xh @ yh

    ar, ai, br, bi = (tf32_split(p) for p in (a.re, a.im, b.re, b.im))
    return C(dot(ar, br) - dot(ai, bi), dot(ar, bi) + dot(ai, br))


def _plane_2d(x: torch.Tensor, k: int, what: str) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"cmatmul: {what} must be float32, got {x.dtype}")
    x2 = x.reshape(-1, k)            # a view whenever the strides allow it
    if k > 1 and x2.stride(1) != 1:
        raise ValueError(f"cmatmul: {what} needs unit inner stride, got {x2.stride()}")
    return x2


def _ld(x2: torch.Tensor) -> int:
    return x2.stride(0) if x2.shape[0] > 1 else x2.shape[1]


def cmatmul(a: C, b: C, gauss: bool = False, bsum: torch.Tensor = None,
            variant: Optional[str] = None) -> C:
    """Complex matmul a (..., M0, K) @ b (K, N) -> (..., M0, N).

    gauss=True selects the 3-dot Gauss form; `bsum` is b.re + b.im,
    precomputed by a caller whose B is a constant (formed here if None).
    `variant` picks the 4-dot form's CUDA kernel: "tc" (tensor cores,
    3xTF32; the default) or "ffma" (CUDA cores). A CPU tensor ignores it."""
    variant = _default_variant if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"cmatmul: variant {variant!r}; pick from {VARIANTS}")
    dev = a.re.device
    if dev.type == "cpu":
        return cmatmul_plain(a, b, gauss)
    if dev.type != "cuda":
        raise ValueError(f"cmatmul: no kernel for device {dev}")
    name = matmul_precision_name()
    if name != "highest":
        raise NotImplementedError(
            f"cmatmul: the CUDA kernels implement precision 'highest' only, got "
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
    kernel = _kernel_for(gauss, variant)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "tf32x3":
            # a tile grid smaller than the card is split along K into partial
            # sums, which the kernel's second pass adds in a fixed order
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            splits = lib.cmatmul_tf32x3_splits(M, N, K, sms)
            scratch = (torch.empty((2 * splits, M, N), dtype=torch.float32, device=dev)
                       if splits > 1 else None)
            rc = lib.cmatmul_tf32x3(ar.data_ptr(), ai.data_ptr(), lda,
                                    br.data_ptr(), bi.data_ptr(), ldb,
                                    cr.data_ptr(), ci.data_ptr(), N, M, N, K,
                                    scratch.data_ptr() if splits > 1 else None,
                                    splits, stream)
        else:
            rc = lib.cmatmul_f32(ar.data_ptr(), ai.data_ptr(), lda,
                                 br.data_ptr(), bi.data_ptr(),
                                 bsum.data_ptr() if gauss else None, ldb,
                                 cr.data_ptr(), ci.data_ptr(), N,
                                 M, N, K, int(gauss), stream)
    if rc != 0:
        raise RuntimeError(f"cmatmul kernel {kernel} launch failed: CUDA error {rc} "
                           f"(M={M}, N={N}, K={K})")
    cmatmul.launches += 1
    cmatmul.launches_by_kernel[kernel] += 1
    return C(cr.reshape(lead + (N,)), ci.reshape(lead + (N,)))


cmatmul.launches = 0
cmatmul.launches_by_kernel = {"tf32x3": 0, "f32_fma4": 0, "f32_gauss": 0}
