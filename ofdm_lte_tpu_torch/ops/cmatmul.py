"""The modem's planar complex GEMM: the CUDA kernels' wrapper and their
plain versions.

Counterpart of ofdm_lte_tpu/ops/pallas_kernels.py. `cmatmul` computes
(..., M0, K) @ (K, N) on (re, im) float32 planes, with the leading batch
dimensions flattened into M, in the 4-dot form or the 3-dot Gauss form, at
the precision that OFDM_LTE_TPU_TORCH_MATMUL_PRECISION names
(ofdm_lte_tpu_torch/precision.py):

- on a CPU tensor it runs `cmatmul_plain`, the same products through
  torch.matmul in true fp32 under every precision (the form the CPU tests
  compare with the JAX package, whose knob is inert on the CPU too);
- on a CUDA tensor it launches a hand-written kernel, built on first use
  (see _build.py), or raises. It never falls back to a plain version, to a
  library GEMM or to another precision's kernel. Which kernel serves a call
  is the rule in `_kernel_for`. `variant="tc"`, the default, goes to the
  tensor cores: at `highest` three TF32 products per real product, as
  accurate as fp32 (mma.sync; `tf32x3`: csrc/cmatmul_tc.cu, and
  `tf32x3_gauss`: csrc/cmatmul_tc_gauss.cu); at `high` one TF32 product of
  the operands rounded to TF32 (wgmma with TMA; `tf32`, `tf32_gauss`:
  csrc/cmatmul_wgmma_tf32.cu); at `default` bf16 operands with fp32 sums
  (wgmma with TMA; `bf16`, `bf16_gauss`: csrc/cmatmul_bf16.cu). Both pairs
  share their main loop (csrc/wgmma_cmatmul.cuh) and prepare B (and, at
  `default`, A) per call in a workspace that this wrapper allocates (see
  `wgmma_prep_b`, `wgmma_prep_a`).
  `variant="ffma"` goes to the fp32 CUDA-core kernel
  csrc/cmatmul.cu (`cmatmul_f32`, either form), at `highest` only: the
  CUDA cores have no TF32 or bf16 product. Each call that launches adds one
  to `cmatmul.launches` and to its kernel's entry in
  `cmatmul.launches_by_kernel` (a split-K call counts once), and each
  operand plane whose leading axes do not fold into one row stride, which
  `reshape` then copies, adds one to `cmatmul.copies` (see `fold_rows`).

`PLAIN[kernel]` is the plain PyTorch version that repeats a kernel's own
arithmetic: `cmatmul_plain_tf32x3` and `cmatmul_plain_gauss_tf32x3` (the
TF32 head/tail split and the twelve or nine products),
`cmatmul_plain_tf32`, `cmatmul_plain_gauss_tf32` (the TF32 heads),
`cmatmul_plain_bf16` and `cmatmul_plain_gauss_bf16` (planes rounded to
bf16), each multiplied in true fp32; the tests and chip_smoke.py hold the
kernels against them, and a product at `high` or `default` against the
exact one within `rounding_bound`.
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


# every kernel: (variant, precision, gauss) of the calls it serves
KERNELS = {"tf32x3": ("tc", "highest", False), "tf32x3_gauss": ("tc", "highest", True),
           "tf32": ("tc", "high", False), "tf32_gauss": ("tc", "high", True),
           "bf16": ("tc", "default", False), "bf16_gauss": ("tc", "default", True),
           "f32_fma4": ("ffma", "highest", False), "f32_gauss": ("ffma", "highest", True)}
_KERNEL_OF = {call: kernel for kernel, call in KERNELS.items()}


def _kernel_for(gauss: bool, variant: str, precision: str = "highest") -> str:
    """The one rule that says which kernel serves a CUDA call."""
    if (variant, precision, gauss) not in _KERNEL_OF:
        raise ValueError(f"cmatmul: variant {variant!r} has no kernel at precision "
                         f"{precision!r}: the CUDA cores (ffma) multiply in fp32 alone; "
                         f"`high` and `default` run on the tensor cores (tc)")
    return _KERNEL_OF[variant, precision, bool(gauss)]


@contextlib.contextmanager
def true_fp32_products(on_cuda: bool = True):
    """Within the block torch.matmul on a CUDA tensor multiplies in true fp32
    (`allow_tf32` off); the flag is what it was when the block ends. A CPU
    product reads no flag, so `on_cuda=False` touches nothing."""
    if not on_cuda:
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def cmatmul_plain(a: C, b: C, gauss: bool = False) -> C:
    """Plain PyTorch complex matmul, 4-multiply or Gauss form, in fp32.

    On a CUDA tensor it multiplies with TF32 off, so that it is the fp32
    reference the kernel is held against, and leaves the flag as it was."""
    with true_fp32_products(a.re.is_cuda):
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
    def dot(x, y):
        (xh, xl), (yh, yl) = x, y
        return (xh @ yl + xl @ yh) + xh @ yh

    ar, ai, br, bi = (tf32_split(p) for p in (a.re, a.im, b.re, b.im))
    with true_fp32_products(a.re.is_cuda):
        return C(dot(ar, br) - dot(ai, bi), dot(ar, bi) + dot(ai, br))


def cmatmul_plain_gauss_tf32x3(a: C, b: C) -> C:
    """The Gauss tensor-core kernel's arithmetic in plain PyTorch: Ar+Ai and
    Br+Bi formed in fp32 and split like the other planes, each of the three
    real products as hi·lo + lo·hi + hi·hi (nine fp32 matmuls), then the
    fold Cr = t1 − t2, Ci = t3 − t1 − t2.

    Differs from the kernel only in the order of the sums."""
    def dot(x, y):
        (xh, xl), (yh, yl) = tf32_split(x), tf32_split(y)
        return (xh @ yl + xl @ yh) + xh @ yh

    with true_fp32_products(a.re.is_cuda):
        t1, t2, t3 = dot(a.re, b.re), dot(a.im, b.im), dot(a.re + a.im, b.re + b.im)
    return C(t1 - t2, t3 - t1 - t2)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernels at `high` round it: tf32_split's head."""
    return tf32_split(x)[0]


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even, as cvt.rn.bf16x2.f32), in float32."""
    return x.to(torch.bfloat16).float()


def _plain_rounded(a: C, b: C, gauss: bool, rnd) -> C:
    """The planes (and, in the Gauss form, Ar+Ai and Br+Bi formed in fp32)
    rounded by `rnd`, then multiplied in true fp32. A product of two TF32 or
    two bf16 values is exact in fp32, so this differs from the kernel only in
    the order of the sums."""
    with true_fp32_products(a.re.is_cuda):
        if gauss:
            t1 = rnd(a.re) @ rnd(b.re)
            t2 = rnd(a.im) @ rnd(b.im)
            t3 = rnd(a.re + a.im) @ rnd(b.re + b.im)
            return C(t1 - t2, t3 - t1 - t2)
        ar, ai, br, bi = (rnd(x) for x in (a.re, a.im, b.re, b.im))
        return C(ar @ br - ai @ bi, ar @ bi + ai @ br)


def cmatmul_plain_tf32(a: C, b: C) -> C:
    """The 4-dot kernel at `high` in plain PyTorch: the TF32 heads multiplied."""
    return _plain_rounded(a, b, False, tf32_round)


def cmatmul_plain_gauss_tf32(a: C, b: C) -> C:
    """The Gauss kernel at `high` in plain PyTorch: Ar+Ai and Br+Bi formed in
    fp32, the heads of the six planes multiplied, then the fold."""
    return _plain_rounded(a, b, True, tf32_round)


def cmatmul_plain_bf16(a: C, b: C) -> C:
    """The 4-dot kernel at `default` in plain PyTorch: the planes rounded to
    bf16, multiplied in fp32."""
    return _plain_rounded(a, b, False, bf16_round)


def cmatmul_plain_gauss_bf16(a: C, b: C) -> C:
    """The Gauss kernel at `default` in plain PyTorch: Ar+Ai and Br+Bi formed
    in fp32, the six planes rounded to bf16, multiplied in fp32, the fold."""
    return _plain_rounded(a, b, True, bf16_round)


# the plain version that repeats each kernel's arithmetic
PLAIN = {"tf32x3": cmatmul_plain_tf32x3, "tf32x3_gauss": cmatmul_plain_gauss_tf32x3,
         "tf32": cmatmul_plain_tf32, "tf32_gauss": cmatmul_plain_gauss_tf32,
         "bf16": cmatmul_plain_bf16, "bf16_gauss": cmatmul_plain_gauss_bf16,
         "f32_fma4": lambda a, b: cmatmul_plain(a, b),
         "f32_gauss": lambda a, b: cmatmul_plain(a, b, gauss=True)}

# The wgmma kernels of `high` (csrc/cmatmul_wgmma_tf32.cu) and `default`
# (csrc/cmatmul_bf16.cu) read operands in the layout that TMA and wgmma
# accept. Their plain twins below, each taking the precision, are what the CPU
# tests hold that layout and the kernels' chain-by-chain sums to. The
# constants are each source's BK and CHAIN, which a test reads there.
WGMMA_BK = {"high": 32, "default": 64}     # depth of a slab: one 128-byte row of A
WGMMA_CHAIN = {"high": 4, "default": 2}    # slabs a chain sums from zero (128 of K)
# how each precision's kernels round an operand, and the type of a prepared
# value (TF32 in fp32 words, bf16)
WGMMA_ROUND = {"high": tf32_round, "default": bf16_round}
WGMMA_DTYPE = {"high": torch.float32, "default": torch.bfloat16}


def wgmma_padded_k(K: int, precision: str = "high") -> int:
    """K rounded up to a whole slab: the pitch of the prepared planes."""
    return -(-K // WGMMA_BK[precision]) * WGMMA_BK[precision]


def wgmma_a_needs_copy(ar: torch.Tensor, ai: torch.Tensor, lda: int) -> bool:
    """Whether TMA cannot read A's planes in place (a base that is not 16-byte
    aligned, or a row pitch that is not a multiple of 16 bytes), so that a
    `high` kernel copies them first (`wgmma_copy_a`). The `default` kernels
    prepare A at every call (`wgmma_prep_a`)."""
    return bool(ar.data_ptr() % 16 or ai.data_ptr() % 16 or lda % 4)


def wgmma_workspace_floats(M: int, N: int, K: int, gauss: bool, a_copy: bool,
                           splits: int, precision: str = "high") -> int:
    """The floats of workspace one call of a wgmma kernel takes (what its C
    query cmatmul_<kernel>_workspace returns): B prepared, (N, Kp) a plane,
    two planes or three (Gauss); A prepared at `default`, (M, Kp) a plane, two
    or three, else A copied, two fp32 (M, Kp) planes, where TMA cannot read it
    (`a_copy`, read at `high` alone); the two partial planes of each K split.
    A value of a prepared plane takes 4 bytes at `high`, 2 at `default`."""
    if M <= 0 or N <= 0 or K <= 0:
        return 0
    kp, nb = wgmma_padded_k(K, precision), WGMMA_DTYPE[precision].itemsize
    planes = 3 if gauss else 2
    if precision == "default":
        a_floats = planes * M * kp * nb // 4
    else:
        a_floats = 2 * M * kp if a_copy else 0
    return planes * N * kp * nb // 4 + a_floats + (2 * splits * M * N if splits > 1 else 0)


def _prepared(planes, precision: str) -> torch.Tensor:
    """The planes (rows, K) rounded as the precision rounds, (planes, rows, Kp),
    zero past K, in the precision's prepared dtype."""
    rows, K = planes[0].shape
    out = torch.zeros((len(planes), rows, wgmma_padded_k(K, precision)),
                      dtype=WGMMA_DTYPE[precision], device=planes[0].device)
    for p, x in enumerate(planes):
        out[p, :, :K] = WGMMA_ROUND[precision](x)
    return out


def wgmma_prep_b(b: C, gauss: bool, precision: str = "high") -> torch.Tensor:
    """B as the wgmma kernels prepare it (prep_b_kernel): (planes, N, Kp),
    K-major, each plane rounded as the precision rounds (`WGMMA_ROUND`),
    zero past K; the planes Br, Bi and, for the Gauss form, Br + Bi formed in
    fp32. float32 at `high`, bfloat16 at `default`."""
    planes = [b.re, b.im] + ([b.re + b.im] if gauss else [])
    return _prepared([x.t() for x in planes], precision)


def wgmma_prep_a(a: C, gauss: bool) -> torch.Tensor:
    """A as the `default` kernels prepare it at every call (prep_a_kernel):
    (planes, M, Kp) bfloat16, each plane rounded to nearest even, zero past
    K; the planes Ar, Ai and, for the Gauss form, Ar + Ai formed in fp32."""
    planes = [a.re, a.im] + ([a.re + a.im] if gauss else [])
    return _prepared(planes, "default")


def wgmma_copy_a(a: C) -> torch.Tensor:
    """A (M, K) as the `high` kernels copy it where TMA cannot read it in place
    (copy_a_kernel): (2, M, Kp), the raw fp32 planes, zero past K. Those
    kernels round A in registers, after forming Ar + Ai for the Gauss form."""
    M, K = a.re.shape
    out = torch.zeros((2, M, wgmma_padded_k(K)), dtype=torch.float32, device=a.re.device)
    out[0, :, :K] = a.re
    out[1, :, :K] = a.im
    return out


def cmatmul_plain_wgmma_slabs(a: C, b: C, gauss: bool, precision: str = "high") -> C:
    """The wgmma kernels' sums in plain PyTorch, from the prepared operands:
    A rounded as the kernel rounds it (at `high` in registers, from the raw
    planes; at `default` by its prep), Ar + Ai formed in fp32 first for
    Gauss; the products of each chain of WGMMA_CHAIN slabs (128 of K) summed
    from zero in true fp32 (the kernel sums them in the tensor cores) and
    added to fp32 running sums, the Gauss form folded after each chain
    (Cr += t1 − t2, Ci += t3 − t1 − t2)."""
    M, N = a.re.shape[0], b.re.shape[1]
    bt = wgmma_prep_b(b, gauss, precision).float()
    if precision == "default":
        a_planes = list(wgmma_prep_a(a, gauss).float())
    else:
        at = wgmma_copy_a(a)
        a_planes = [tf32_round(at[0]), tf32_round(at[1])]
        a_planes += [tf32_round(at[0] + at[1])] if gauss else []
    cr = torch.zeros((M, N), dtype=torch.float32, device=a.re.device)
    ci = torch.zeros_like(cr)
    depth = WGMMA_BK[precision] * WGMMA_CHAIN[precision]
    with true_fp32_products(a.re.is_cuda):
        for k0 in range(0, bt.shape[2], depth):
            sl = slice(k0, k0 + depth)
            xs = [x[:, sl] for x in a_planes]
            ys = [y[:, sl].t() for y in bt]
            if gauss:
                t1, t2, t3 = (x @ y for x, y in zip(xs, ys))
                cr += t1 - t2
                ci += t3 - t1 - t2
            else:
                (xr, xi), (yr, yi) = xs, ys
                cr += xr @ yr - xi @ yi
                ci += xr @ yi + xi @ yr
    return C(cr, ci)


# unit roundoff of an operand rounded to TF32 (10 stored mantissa bits) or bf16 (7)
UNIT_ROUNDOFF = {"high": 2.0 ** -11, "default": 2.0 ** -9}


def rounding_bound(precision: str, gauss: bool, K: int) -> float:
    """c such that, elementwise, a product at `precision` (`high` or
    `default`) of fp32 operands lies within c·(|Ar|+|Ai|)·(|Br|+|Bi|) of the
    exact product of those operands.

    Each operand is rounded with unit roundoff u (TF32 2⁻¹¹, bf16 2⁻⁹), so a
    product of two is within 2u + u² of the exact one, and the fp32 sums of
    K terms add at most one ulp, 2⁻²³, of the terms' magnitude an add (the
    tensor cores' adder truncates). The Gauss form rounds Ar+Ai and Br+Bi
    after an fp32 add (u + 2⁻²⁴ an operand), and its imaginary part,
    t3 − t1 − t2, carries the errors of three products whose magnitudes sum
    to at most twice (|Ar|+|Ai|)(|Br|+|Bi|), and two more adds: twice the
    bound."""
    u = UNIT_ROUNDOFF[precision]
    if not gauss:
        return 2 * u + u * u + K * 2.0 ** -23
    u += 2.0 ** -24 * (1 + u)
    return 2 * (2 * u + u * u + (K + 2) * 2.0 ** -23)


def fold_rows(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, bool]:
    """x (..., k) as (M, k) rows for the kernel, and whether that took a copy.

    The kernel reads its operand through one row stride, so the leading
    axes must fold into one: a view when each axis's stride is the next
    one's stride times its length (a contiguous batch, a CP-stripped view,
    a slot-start view y[..., ::14, :] when S is a multiple of 14), else
    `reshape` copies the plane."""
    x2 = x.reshape(-1, k)
    copied = x2.numel() > 0 and (x2.untyped_storage().data_ptr()
                                 != x.untyped_storage().data_ptr())
    return x2, copied


def _plane_2d(x: torch.Tensor, k: int, what: str) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"cmatmul: {what} must be float32, got {x.dtype}")
    x2, copied = fold_rows(x, k)
    cmatmul.copies += int(copied)
    if k > 1 and x2.stride(1) != 1:
        raise ValueError(f"cmatmul: {what} needs unit inner stride, got {x2.stride()}")
    return x2


def _ld(x2: torch.Tensor) -> int:
    return x2.stride(0) if x2.shape[0] > 1 else x2.shape[1]


def cmatmul(a: C, b: C, gauss: bool = False, bsum: torch.Tensor = None,
            variant: Optional[str] = None) -> C:
    """Complex matmul a (..., M0, K) @ b (K, N) -> (..., M0, N).

    gauss=True selects the 3-dot Gauss form. `variant` picks the CUDA
    kernel: "tc" (tensor cores; the default) or "ffma" (CUDA cores, at
    `highest` only: ValueError under `high` or `default`, on any device).
    The precision is OFDM_LTE_TPU_TORCH_MATMUL_PRECISION's, read at each
    call. `bsum` is b.re + b.im, precomputed by a caller whose B is a
    constant: only the CUDA-core Gauss kernel reads it (formed here if
    None); the tensor-core ones add the planes in registers. A CPU tensor
    ignores both, and the precision: it multiplies in true fp32."""
    variant = _default_variant if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"cmatmul: variant {variant!r}; pick from {VARIANTS}")
    kernel = _kernel_for(gauss, variant, matmul_precision_name())
    dev = a.re.device
    if dev.type == "cpu":
        return cmatmul_plain(a, b, gauss)
    if dev.type != "cuda":
        raise ValueError(f"cmatmul: no kernel for device {dev}")

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
    if kernel == "f32_gauss":
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
    from .._build import WORKSPACE_KERNELS, library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if variant == "tc":
            # a tile grid smaller than the card is split along K into partial
            # sums, which the kernel's second pass adds in a fixed order; the
            # `high` kernels' scratch is a workspace that also holds B prepared
            # and, where TMA cannot read it in place, A copied
            run = getattr(lib, "cmatmul_" + kernel)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            splits = getattr(lib, f"cmatmul_{kernel}_splits")(M, N, K, sms)
            if kernel in WORKSPACE_KERNELS:
                floats = getattr(lib, f"cmatmul_{kernel}_workspace")(
                    ar.data_ptr(), ai.data_ptr(), lda, M, N, K, splits)
            else:
                floats = 2 * splits * M * N if splits > 1 else 0
            scratch = torch.empty(floats, dtype=torch.float32, device=dev) if floats else None
            rc = run(ar.data_ptr(), ai.data_ptr(), lda, br.data_ptr(), bi.data_ptr(), ldb,
                     cr.data_ptr(), ci.data_ptr(), N, M, N, K,
                     scratch.data_ptr() if floats else None, splits, stream)
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
cmatmul.copies = 0      # operand planes that did not fold into rows and were copied
cmatmul.launches_by_kernel = dict.fromkeys(KERNELS, 0)
