"""Complex arithmetic as planar float32 pairs, in PyTorch.

Mirrors ofdm_lte_tpu.cplx: a complex tensor is a `C` NamedTuple of two
same-shape float32 tensors (re, im). The port keeps the planar layout
instead of torch.complex64 because the complex-GEMM kernel reads planes
(ops/cmatmul.py), and the tests compare planes with the JAX package's
planes.

Complex matmul expands into real matmuls: the 4-multiply form (`matmul`)
and the 3-multiply Gauss/Karatsuba form (`matmul_gauss`). These are the
plain versions; the modem's GEMMs go through ops.cmatmul.

The MIMO stack's per-subcarrier matrices are 1×1 to 4×4, batched over
millions of subcarriers: `matmul_small`, `einsum` and `solve` expand them
into broadcast multiply-sums and closed forms, and never reach a library
GEMM or a factorization for n ≤ 4.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class C(NamedTuple):
    """A complex tensor as a (re, im) pair of same-shape real tensors."""

    re: torch.Tensor
    im: torch.Tensor

    # ---- structural ----
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    def __getitem__(self, idx) -> "C":
        return C(self.re[idx], self.im[idx])

    def reshape(self, *shape) -> "C":
        return C(self.re.reshape(*shape), self.im.reshape(*shape))

    def transpose(self, *axes) -> "C":
        """Permute the axes (NumPy's transpose, torch's permute)."""
        if len(axes) == 1 and not isinstance(axes[0], int):
            axes = tuple(axes[0])
        if not axes:
            axes = tuple(reversed(range(self.ndim)))
        return C(self.re.permute(*axes), self.im.permute(*axes))

    # ---- arithmetic ----
    def __add__(self, o) -> "C":
        if isinstance(o, C):
            return C(self.re + o.re, self.im + o.im)
        return C(self.re + o, self.im)

    def __radd__(self, o) -> "C":
        return self.__add__(o)

    def __sub__(self, o) -> "C":
        if isinstance(o, C):
            return C(self.re - o.re, self.im - o.im)
        return C(self.re - o, self.im)

    def __rsub__(self, o) -> "C":
        return C(o - self.re, -self.im)

    def __neg__(self) -> "C":
        return C(-self.re, -self.im)

    def __mul__(self, o) -> "C":
        if isinstance(o, C):
            return C(self.re * o.re - self.im * o.im,
                     self.re * o.im + self.im * o.re)
        return C(self.re * o, self.im * o)

    def __rmul__(self, o) -> "C":
        return self.__mul__(o)

    def __truediv__(self, o) -> "C":
        if isinstance(o, C):
            d = o.re * o.re + o.im * o.im
            return C((self.re * o.re + self.im * o.im) / d,
                     (self.im * o.re - self.re * o.im) / d)
        return C(self.re / o, self.im / o)

    def conj(self) -> "C":
        return C(self.re, -self.im)

    def abs2(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im

    def abs(self) -> torch.Tensor:
        return torch.sqrt(self.abs2())

    def sum(self, axis=None, keepdims: bool = False) -> "C":
        if axis is None:
            return C(self.re.sum(), self.im.sum())
        return C(self.re.sum(dim=axis, keepdim=keepdims),
                 self.im.sum(dim=axis, keepdim=keepdims))

    def mean(self, axis=None, keepdims: bool = False) -> "C":
        if axis is None:
            return C(self.re.mean(), self.im.mean())
        return C(self.re.mean(dim=axis, keepdim=keepdims),
                 self.im.mean(dim=axis, keepdim=keepdims))

    # ---- interop ----
    def to_numpy(self) -> np.ndarray:
        return self.re.detach().cpu().numpy() + 1j * self.im.detach().cpu().numpy()


def from_numpy(x, device=None) -> C:
    """A NumPy complex (or real) array as a float32 C pair on `device`. Any
    object with `re` and `im` planes that NumPy can read (a C pair of either
    package) is taken plane by plane."""
    if hasattr(x, "re") and hasattr(x, "im"):
        return C(torch.as_tensor(np.array(x.re, np.float32), device=device),
                 torch.as_tensor(np.array(x.im, np.float32), device=device))
    x = np.asarray(x)
    # copies: the imaginary part of a real array is a read-only view
    return C(torch.as_tensor(np.array(x.real, np.float32), device=device),
             torch.as_tensor(np.array(x.imag, np.float32), device=device))


def const(x, device=None) -> C:
    """Embed a NumPy complex constant as a C pair on `device`."""
    return from_numpy(x, device)


def czeros(shape, device=None) -> C:
    return C(torch.zeros(shape, dtype=torch.float32, device=device),
             torch.zeros(shape, dtype=torch.float32, device=device))


def cones(shape, device=None) -> C:
    return C(torch.ones(shape, dtype=torch.float32, device=device),
             torch.zeros(shape, dtype=torch.float32, device=device))


def expi(theta: torch.Tensor) -> C:
    """exp(i·theta) elementwise."""
    return C(torch.cos(theta), torch.sin(theta))


def stack(xs, axis: int = 0) -> C:
    return C(torch.stack([x.re for x in xs], dim=axis),
             torch.stack([x.im for x in xs], dim=axis))


def concatenate(xs, axis: int = 0) -> C:
    return C(torch.cat([x.re for x in xs], dim=axis),
             torch.cat([x.im for x in xs], dim=axis))


def pad(x: C, pad_width) -> C:
    """Zero-pad with NumPy's per-axis ((before, after), ...) widths."""
    flat = [w for pair in reversed(list(pad_width)) for w in pair]
    return C(torch.nn.functional.pad(x.re, flat), torch.nn.functional.pad(x.im, flat))


def scatter_set(base: C, idx, values: C) -> C:
    """A copy of `base` with base[idx] = values (jnp's .at[idx].set)."""
    re, im = base.re.clone(), base.im.clone()
    re[idx] = values.re
    im[idx] = values.im
    return C(re, im)


def take(x: C, idx: torch.Tensor, axis: int = 0) -> C:
    """Gather along `axis` with an integer index tensor (jnp.take)."""
    return C(torch.index_select(x.re, axis, idx), torch.index_select(x.im, axis, idx))


def matmul(a: C, b: C) -> C:
    """Complex matmul as 4 real fp32 matmuls."""
    rr = torch.matmul(a.re, b.re)
    ii = torch.matmul(a.im, b.im)
    ri = torch.matmul(a.re, b.im)
    ir = torch.matmul(a.im, b.re)
    return C(rr - ii, ri + ir)


def matmul_gauss(a: C, b: C) -> C:
    """Complex matmul in the 3-multiply Gauss/Karatsuba form:

        t1 = ar·br, t2 = ai·bi, t3 = (ar+ai)·(br+bi)
        C  = (t1 − t2) + j·(t3 − t1 − t2)

    The imaginary part carries one extra rounding of size ~|t1|+|t2|."""
    t1 = torch.matmul(a.re, b.re)
    t2 = torch.matmul(a.im, b.im)
    t3 = torch.matmul(a.re + a.im, b.re + b.im)
    return C(t1 - t2, t3 - t1 - t2)


def matmul_small(a: C, b: C) -> C:
    """Batched complex matmul for tiny matrices (contraction ≤ ~8) as a
    broadcast multiply-sum, never a library GEMM.

    a (..., M, K) @ b (..., K, N) -> (..., M, N); leading dims broadcast."""
    ar, ai = a.re[..., :, :, None], a.im[..., :, :, None]      # (..., M, K, 1)
    br, bi = b.re[..., None, :, :], b.im[..., None, :, :]      # (..., 1, K, N)
    return C((ar * br - ai * bi).sum(dim=-2), (ar * bi + ai * br).sum(dim=-2))


def einsum(spec: str, a: C, b: C) -> C:
    """The tiny complex contractions the package uses, as broadcast
    multiply-sums (torch.einsum would send them to a batched library GEMM):

    "...rt,ptl->...prl": a (..., r, t) against a stack b (p, t, l)."""
    if spec != "...rt,ptl->...prl":
        raise NotImplementedError(f"cplx.einsum: no broadcast form for {spec!r}")
    ar, ai = a.re[..., None, :, :, None], a.im[..., None, :, :, None]   # (..., 1, r, t, 1)
    br, bi = b.re[..., None, :, :], b.im[..., None, :, :]               # (p, 1, t, l)
    # four real contractions, combined after the sums
    return C((ar * br).sum(dim=-2) - (ai * bi).sum(dim=-2),
             (ar * bi).sum(dim=-2) + (ai * br).sum(dim=-2))


def vdot(a: C, b: C, axis: int = -1, keepdims: bool = False) -> C:
    """Hermitian inner product sum(conj(a)·b) along axis."""
    return (a.conj() * b).sum(axis=axis, keepdims=keepdims)


def where(mask: torch.Tensor, a: C, b: C) -> C:
    return C(torch.where(mask, a.re, b.re), torch.where(mask, a.im, b.im))


def scatter_add(base: C, idx, values: C) -> C:
    """A copy of `base` with base[idx] += values along axis 0 for an integer
    index array, duplicates accumulated (jnp's .at[idx].add)."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=base.re.device)
    return C(base.re.index_add(0, idx, values.re), base.im.index_add(0, idx, values.im))


def take_along(x: C, idx: torch.Tensor, axis: int = -1) -> C:
    """Gather one element along `axis` per batch lane; squeezes that axis."""
    ex = idx.to(torch.int64).unsqueeze(axis)
    return C(torch.take_along_dim(x.re, ex, dim=axis).squeeze(axis),
             torch.take_along_dim(x.im, ex, dim=axis).squeeze(axis))


def _matvec(a: C, v: C) -> C:
    """(..., m, n) @ (..., n) -> (..., m) as a multiply-sum (tiny dims)."""
    return (a * C(v.re[..., None, :], v.im[..., None, :])).sum(axis=-1)


def _solve2_mat(a: C, b: C) -> C:
    """Closed-form A⁻¹B for 2×2 A and (..., 2, k) B."""
    a11, a12 = a[..., 0:1, 0:1], a[..., 0:1, 1:2]
    a21, a22 = a[..., 1:2, 0:1], a[..., 1:2, 1:2]
    det = a11 * a22 - a12 * a21
    top = (a22 * b[..., 0:1, :] - a12 * b[..., 1:2, :]) / det
    bot = (a11 * b[..., 1:2, :] - a21 * b[..., 0:1, :]) / det
    return concatenate([top, bot], axis=-2)


def solve(a: C, b: C) -> C:
    """Solve A x = b for complex A (..., n, n), batched over leading dims;
    b is a vector (..., n) or a matrix (..., n, k).

    The systems of the MIMO detectors (n ≤ 4, vector b) are solved in closed
    form: n = 1 and 2 directly, n = 4 through the 2×2-block Schur
    complement, n = 3 padded to 4 with a decoupled unit equation. Anything
    else goes through the real 2n×2n embedding
    [[Ar, -Ai], [Ai, Ar]] @ [xr; xi] = [br; bi] and torch.linalg.solve."""
    n = a.shape[-1]
    vector = b.ndim == a.ndim - 1
    if n == 1:
        if vector:
            return b / C(a.re[..., 0, :], a.im[..., 0, :])
        return b / C(a.re[..., 0:1, 0:1], a.im[..., 0:1, 0:1])
    if n == 2 and vector:
        a11, a12, a21, a22 = a[..., 0, 0], a[..., 0, 1], a[..., 1, 0], a[..., 1, 1]
        det = a11 * a22 - a12 * a21
        x0 = (a22 * b[..., 0] - a12 * b[..., 1]) / det
        x1 = (a11 * b[..., 1] - a21 * b[..., 0]) / det
        return stack([x0, x1], axis=-1)
    if n == 3 and vector:
        # pad to the block-diagonal [[A, 0], [0, 1]]: the solution is unchanged
        pad_a = pad(a, [(0, 0)] * (a.ndim - 2) + [(0, 1), (0, 1)])
        pad_a.re[..., 3, 3] = 1.0
        pad_b = pad(b, [(0, 0)] * (b.ndim - 1) + [(0, 1)])
        return solve(pad_a, pad_b)[..., :3]
    if n == 4 and vector:
        A, B = a[..., 0:2, 0:2], a[..., 0:2, 2:4]
        Cm, D = a[..., 2:4, 0:2], a[..., 2:4, 2:4]
        b1, b2 = b[..., 0:2], b[..., 2:4]
        Ainv_b1 = solve(A, b1)
        Ainv_B = _solve2_mat(A, B)
        S = D - matmul_small(Cm, Ainv_B)
        x2 = solve(S, b2 - _matvec(Cm, Ainv_b1))
        x1 = Ainv_b1 - _matvec(Ainv_B, x2)
        return concatenate([x1, x2], axis=-1)
    areal = torch.cat([torch.cat([a.re, -a.im], dim=-1),
                       torch.cat([a.im, a.re], dim=-1)], dim=-2)   # (..., 2n, 2n)
    if vector:
        x = torch.linalg.solve(areal, torch.cat([b.re, b.im], dim=-1)[..., None])[..., 0]
        return C(x[..., :n], x[..., n:])
    x = torch.linalg.solve(areal, torch.cat([b.re, b.im], dim=-2))
    return C(x[..., :n, :], x[..., n:, :])
