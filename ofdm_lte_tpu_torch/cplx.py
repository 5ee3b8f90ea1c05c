"""Complex arithmetic as planar float32 pairs, in PyTorch.

Mirrors ofdm_lte_tpu.cplx: a complex tensor is a `C` NamedTuple of two
same-shape float32 tensors (re, im). The port keeps the planar layout
instead of torch.complex64 because the complex-GEMM kernel reads planes
(ops/cmatmul.py), and the tests compare planes with the JAX package's
planes.

Complex matmul expands into real matmuls: the 4-multiply form (`matmul`)
and the 3-multiply Gauss/Karatsuba form (`matmul_gauss`). These are the
plain versions; the modem's GEMMs go through ops.cmatmul.
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
    """A NumPy complex (or real) array as a float32 C pair on `device`."""
    x = np.asarray(x)
    return C(torch.as_tensor(np.ascontiguousarray(x.real), dtype=torch.float32, device=device),
             torch.as_tensor(np.ascontiguousarray(x.imag), dtype=torch.float32, device=device))


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
