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
  is the rule in `_kernel_for`, by form and precision alone: at `highest`
  three TF32 tensor-core products per real product, as accurate as fp32
  (`tf32x3`: wgmma with TMA, csrc/cmatmul_wgmma_tf32x3.cu; `tf32x3_gauss`:
  mma.sync, csrc/cmatmul_tc_gauss.cu); at `high` one TF32 product of the
  operands rounded to TF32 (wgmma with TMA; `tf32`, `tf32_gauss`:
  csrc/cmatmul_wgmma_tf32.cu); at `default` bf16 operands with fp32 sums
  (wgmma with TMA; `bf16`, `bf16_gauss`: csrc/cmatmul_bf16.cu).
  The wgmma kernels share their main loop (csrc/wgmma_cmatmul.cuh) and
  prepare B (and, at `default`, A) per call in a workspace that this
  wrapper allocates (see `wgmma_prep_b`, `wgmma_prep_a`). Each call that
  launches adds one to `cmatmul.launches` and to its kernel's entry in
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
from typing import Tuple

import torch

from .. import cplx
from ..cplx import C
from ..precision import matmul_precision_name

# every kernel: (precision, gauss) of the calls it serves, one for each mode
# of the JAX package's Pallas kernel
KERNELS = {"tf32x3": ("highest", False), "tf32x3_gauss": ("highest", True),
           "tf32": ("high", False), "tf32_gauss": ("high", True),
           "bf16": ("default", False), "bf16_gauss": ("default", True)}
_KERNEL_OF = {call: kernel for kernel, call in KERNELS.items()}


def _kernel_for(gauss: bool, precision: str = "highest") -> str:
    """The one rule that says which kernel serves a CUDA call."""
    return _KERNEL_OF[precision, bool(gauss)]


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
    split as the `highest` kernels split (csrc/cmatmul_wgmma_tf32x3.cu:split,
    csrc/cmatmul_tc.cuh:split_tf32).

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
         "bf16": cmatmul_plain_bf16, "bf16_gauss": cmatmul_plain_gauss_bf16}

# The wgmma kernels of `highest` (4-dot: csrc/cmatmul_wgmma_tf32x3.cu), `high`
# (csrc/cmatmul_wgmma_tf32.cu) and `default` (csrc/cmatmul_bf16.cu) read
# operands in the layout that TMA and wgmma accept. Their plain twins below,
# each taking the precision, are what the CPU tests hold that layout and the
# kernels' chain-by-chain sums to. The constants are each source's BK and
# CHAIN, which a test reads there.
WGMMA_BK = {"highest": 32, "high": 32, "default": 64}  # depth of a slab: a 128-byte row of A
WGMMA_CHAIN = {"highest": 1, "high": 4, "default": 2}  # slabs a chain sums from zero
# how the `high` and `default` kernels round an operand (`highest` splits it:
# tf32_split), and the type of a prepared value (TF32 in fp32 words, bf16)
WGMMA_ROUND = {"high": tf32_round, "default": bf16_round}
WGMMA_DTYPE = {"highest": torch.float32, "high": torch.float32, "default": torch.bfloat16}


def wgmma_padded_k(K: int, precision: str = "high") -> int:
    """K rounded up to a whole slab: the pitch of the prepared planes."""
    return -(-K // WGMMA_BK[precision]) * WGMMA_BK[precision]


def wgmma_a_needs_copy(ar: torch.Tensor, ai: torch.Tensor, lda: int) -> bool:
    """Whether TMA cannot read A's planes in place (a base that is not 16-byte
    aligned, or a row pitch that is not a multiple of 16 bytes), so that a
    `highest` or `high` kernel copies them first (`wgmma_copy_a`). The
    `default` kernels prepare A at every call (`wgmma_prep_a`)."""
    return bool(ar.data_ptr() % 16 or ai.data_ptr() % 16 or lda % 4)


def wgmma_workspace_floats(M: int, N: int, K: int, gauss: bool, a_copy: bool,
                           splits: int, precision: str = "high") -> int:
    """The floats of workspace one call of a wgmma kernel takes (what its C
    query cmatmul_<kernel>_workspace returns): B prepared, (N, Kp) a plane,
    two planes or three (Gauss), six at `highest` (`wgmma_prep_b`); A
    prepared at `default`, (M, Kp) a plane, two or three, else A copied, two
    fp32 (M, Kp) planes, where TMA cannot read it (`a_copy`, read at
    `highest` and `high` alone); the two partial planes of each K split. A
    value of a prepared plane takes 4 bytes at `highest` and `high`, 2 at
    `default`."""
    _check_wgmma(gauss, precision)
    if M <= 0 or N <= 0 or K <= 0:
        return 0
    kp, nb = wgmma_padded_k(K, precision), WGMMA_DTYPE[precision].itemsize
    planes = 3 if gauss else 2
    b_planes = 6 if precision == "highest" else planes
    if precision == "default":
        a_floats = planes * M * kp * nb // 4
    else:
        a_floats = 2 * M * kp if a_copy else 0
    return b_planes * N * kp * nb // 4 + a_floats + (2 * splits * M * N if splits > 1 else 0)


def _check_wgmma(gauss: bool, precision: str) -> None:
    if gauss and precision == "highest":
        raise ValueError("cmatmul: the Gauss form at `highest` is the mma.sync kernel "
                         "tf32x3_gauss, which prepares nothing")


def _prepared(planes, precision: str) -> torch.Tensor:
    """The planes (rows, K), already rounded or split as the precision's
    kernels make them, as (planes, rows, Kp), zero past K, in the precision's
    prepared dtype."""
    rows, K = planes[0].shape
    out = torch.zeros((len(planes), rows, wgmma_padded_k(K, precision)),
                      dtype=WGMMA_DTYPE[precision], device=planes[0].device)
    for p, x in enumerate(planes):
        out[p, :, :K] = x
    return out


def wgmma_prep_b(b: C, gauss: bool, precision: str = "high") -> torch.Tensor:
    """B as the wgmma kernels prepare it (prep_b_kernel): (planes, N, Kp),
    K-major, zero past K. At `high` and `default` each plane rounded as the
    precision rounds (`WGMMA_ROUND`): Br, Bi and, for the Gauss form, Br + Bi
    formed in fp32; float32 at `high`, bfloat16 at `default`. At `highest`
    (4-dot form) six float32 planes, split by `tf32_split`: the heads of −Bi,
    Br and Bi, then their tails (−Bi's the negated heads and tails of Bi), so
    that the kernel reads [Br | Bi] and [−Bi | Br] as one operand each."""
    _check_wgmma(gauss, precision)
    if precision == "highest":
        (rh, rl), (ih, il) = tf32_split(b.re.t()), tf32_split(b.im.t())
        return _prepared([-ih, rh, ih, -il, rl, il], precision)
    planes = [b.re, b.im] + ([b.re + b.im] if gauss else [])
    return _prepared([WGMMA_ROUND[precision](x.t()) for x in planes], precision)


def wgmma_prep_a(a: C, gauss: bool) -> torch.Tensor:
    """A as the `default` kernels prepare it at every call (prep_a_kernel):
    (planes, M, Kp) bfloat16, each plane rounded to nearest even, zero past
    K; the planes Ar, Ai and, for the Gauss form, Ar + Ai formed in fp32."""
    planes = [a.re, a.im] + ([a.re + a.im] if gauss else [])
    return _prepared([bf16_round(x) for x in planes], "default")


def wgmma_copy_a(a: C) -> torch.Tensor:
    """A (M, K) as the `highest` and `high` kernels copy it where TMA cannot
    read it in place (copy_a_kernel): (2, M, Kp), the raw fp32 planes, zero
    past K. Those kernels split (`highest`) or round (`high`, after forming
    Ar + Ai for the Gauss form) A in registers."""
    M, K = a.re.shape
    out = torch.zeros((2, M, wgmma_padded_k(K)), dtype=torch.float32, device=a.re.device)
    out[0, :, :K] = a.re
    out[1, :, :K] = a.im
    return out


def cmatmul_plain_wgmma_slabs(a: C, b: C, gauss: bool, precision: str = "high") -> C:
    """The wgmma kernels' sums in plain PyTorch, from the prepared operands:
    A split or rounded as the kernel does it (at `highest` and `high` in
    registers, from the raw planes; at `default` by its prep), Ar + Ai formed
    in fp32 first for Gauss; the products of each chain of WGMMA_CHAIN slabs
    (128 of K; 32 at `highest`) summed from zero in true fp32 (the kernel sums
    them in the tensor cores) and added to fp32 running sums, the Gauss form
    folded after each chain (Cr += t1 − t2, Ci += t3 − t1 − t2). At
    `highest` a chain is the six products of the kernel's wgmmas, in its
    order: Ar.hi and Ar.lo times [Br | Bi], Ai.hi and Ai.lo times [−Bi | Br],
    each A plane against the other's tails or heads, the heads' products
    last."""
    M, N = a.re.shape[0], b.re.shape[1]
    bt = wgmma_prep_b(b, gauss, precision).float()
    if precision == "default":
        a_planes = list(wgmma_prep_a(a, gauss).float())
    else:
        at = wgmma_copy_a(a)
        if precision == "highest":
            a_planes = [*tf32_split(at[0]), *tf32_split(at[1])]
        else:
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
            if precision == "highest":
                (arh, arl, aih, ail), (nh, rh, ih, nl, rl, il) = xs, ys
                terms = [(arh, rl, il), (arl, rh, ih), (aih, nl, rl), (ail, nh, rh),
                         (arh, rh, ih), (aih, nh, rh)]
                chain_r, chain_i = (sum(x @ y[j] for x, *y in terms) for j in (0, 1))
                cr += chain_r
                ci += chain_i
            elif gauss:
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
    """c such that, elementwise, a product at `precision` of fp32 operands
    lies within c·(|Ar|+|Ai|)·(|Br|+|Bi|) of the exact product of those
    operands.

    At `high` and `default` each operand is rounded with unit roundoff u
    (TF32 2⁻¹¹, bf16 2⁻⁹), so a product of two is within 2u + u² of the
    exact one. At `highest` (3xTF32) x = hi + lo within 2⁻²¹|x| (`tf32_split`:
    the head within 2⁻¹¹|x|, the tail cut within 2⁻¹⁰ of the rest), so
    hi·hi + hi·lo + lo·hi is within (2·2⁻²¹(1 + 2⁻¹¹) + 2⁻²²)|x||y| of xy
    (the tails' two cuts and the product lo·lo that it leaves out). The fp32
    sums of K terms add at most one ulp, 2⁻²³, of the terms' magnitude an add
    (the tensor cores' adder truncates). The Gauss form forms Ar+Ai and Br+Bi
    by an fp32 add (2⁻²⁴ an operand) before it rounds or splits them, and its
    imaginary part, t3 − t1 − t2, carries the errors of three products whose
    magnitudes sum to at most twice (|Ar|+|Ai|)(|Br|+|Bi|), and two more
    adds: twice the bound."""
    if precision == "highest":
        e = 2 * 2.0 ** -21 * (1 + 2.0 ** -11) + 2.0 ** -22
        if not gauss:
            return e + K * 2.0 ** -23
        return 2 * (e + 2.0 ** -23 * (1 + e) + (K + 2) * 2.0 ** -23)
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


def cmatmul(a: C, b: C, gauss: bool = False) -> C:
    """Complex matmul a (..., M0, K) @ b (K, N) -> (..., M0, N).

    gauss=True selects the 3-dot Gauss form. The precision is
    OFDM_LTE_TPU_TORCH_MATMUL_PRECISION's, read at each call. A CPU tensor
    ignores the precision: it multiplies in true fp32."""
    kernel = _kernel_for(gauss, matmul_precision_name())
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
        # a tile grid smaller than the card is split along K into partial
        # sums, which the kernel's second pass adds in a fixed order; the
        # scratch of a kernel of WORKSPACE_KERNELS (the wgmma kernels) is a
        # workspace that also holds B prepared and A prepared (`default`) or,
        # where TMA cannot read it in place, copied
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
    if rc != 0:
        raise RuntimeError(f"cmatmul kernel {kernel} launch failed: CUDA error {rc} "
                           f"(M={M}, N={N}, K={K})")
    cmatmul.launches += 1
    cmatmul.launches_by_kernel[kernel] += 1
    return C(cr.reshape(lead + (N,)), ci.reshape(lead + (N,)))


cmatmul.launches = 0
cmatmul.copies = 0      # operand planes that did not fold into rows and were copied
cmatmul.launches_by_kernel = dict.fromkeys(KERNELS, 0)
