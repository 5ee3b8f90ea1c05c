"""The time-varying multipath channel of a batch of links in one pass: the
CUDA kernel's wrapper and its plain version.

For RX leg r, lane b and output sample t (channel/rayleigh.apply_multipath,
summed over TX as channel/mimo._multipath_links does):

    y[r, b, t] = Σ_tx Σ_i h_{r,tx,b,i}(t) · x[tx, b, t − d_i]
    h(t)       = g_i · Σ_n P_n · E_n(t // hold)

with P a link's scaled Jakes phase row (expi(φ)·√(2/16)), E the kept
sinusoid table and (d_i, g_i) the profile's integer delays and linear gains.
The unfused form writes the taps P @ E as planes, adds each tap into a zeroed
(rx, tx, lanes, T) buffer and sums it over TX; csrc/multipath_fir.cu makes
each tap value in registers at its output sample and writes y once.

Sinusoid folding (`sinusoid_fold`): with α_n = 2πn/16 the table's rows come
in groups whose values are equal or exact conjugates, bit for bit. Found in
the table itself, a group k of distinct row (c_k, s_k) and signs σ_n gives

    Σ_{n∈k} P_n·(c_k + j·σ_n·s_k) = c_k·A_k + j·s_k·B_k,
    A_k = Σ_{n∈k} P_n,  B_k = Σ_{n∈k} σ_n·P_n,

the same sum in another order: 4 FMAs a group and sample instead of 4 a
sinusoid. A row that matches no other is a group of its own.

On a CPU tensor `multipath_fir` runs `multipath_fir_plain`, which repeats
the kernel's arithmetic: the folded coefficients (gain times the group sums,
the sums in n's order), each tap as the groups' terms in order, the taps and
TX summed in the kernel's order (TX, then taps). On a CUDA tensor it launches
the kernel (built on first use, _build.py) or raises; it never falls back.
Each launch adds one to `multipath_fir.launches`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..cplx import C

N_SINUSOIDS = 16
# the kernel's row counts of the distinct-row table: found groups are padded
# with zero rows to the first that holds them
KERNEL_GROUPS = (6, 16)


class SinusoidFold(NamedTuple):
    """A sinusoid table's distinct rows and how its rows map onto them."""

    cos: torch.Tensor       # (D, Tg): the distinct rows' real parts, zero past `groups`
    sin: torch.Tensor       # (D, Tg): their imaginary parts
    group: tuple            # sinusoid n -> its distinct row
    sign: tuple             # +1: the row itself; -1: its conjugate
    groups: int             # distinct rows found


def sinusoid_fold(table: C) -> SinusoidFold:
    """Group the rows of a sinusoid table E (Ns, Tg) that are equal, or
    conjugate (equal cos, negated sin), value for value; D is the smallest of
    KERNEL_GROUPS that holds the groups, on the table's device."""
    re, im = table.re, table.im
    first, group, sign = [], [], []
    for n in range(re.shape[0]):
        for k, m in enumerate(first):
            if torch.equal(re[n], re[m]):
                if torch.equal(im[n], im[m]):
                    group.append(k), sign.append(1)
                    break
                if torch.equal(im[n], -im[m]):
                    group.append(k), sign.append(-1)
                    break
        else:
            group.append(len(first)), sign.append(1)
            first.append(n)
    D = next(d for d in KERNEL_GROUPS if d >= len(first))
    cos = re.new_zeros((D, re.shape[1]))
    sin = im.new_zeros((D, im.shape[1]))
    cos[:len(first)], sin[:len(first)] = re[first], im[first]
    return SinusoidFold(cos, sin, tuple(group), tuple(sign), len(first))


def fold_coefficients(rows: C, fold: SinusoidFold, gains) -> Tuple[C, C]:
    """A, B (..., taps, D) of phase rows (..., taps, 16): A_k = g_i·Σ_{n∈k}
    P_n and B_k = g_i·Σ σ_n·P_n, each sum in n's order from 0."""
    D = fold.cos.shape[0]
    zero = rows.re.new_zeros(rows.shape[:-1])
    ar, ai, br, bi = ([zero] * D for _ in range(4))
    for n, (k, s) in enumerate(zip(fold.group, fold.sign)):
        p_r, p_i = rows.re[..., n], rows.im[..., n]
        ar[k], ai[k] = ar[k] + p_r, ai[k] + p_i
        br[k], bi[k] = (br[k] + p_r, bi[k] + p_i) if s > 0 else (br[k] - p_r, bi[k] - p_i)
    g = torch.as_tensor(gains, dtype=torch.float32, device=rows.re.device)[:, None]
    return (C(torch.stack(ar, -1) * g, torch.stack(ai, -1) * g),
            C(torch.stack(br, -1) * g, torch.stack(bi, -1) * g))


def multipath_fir_plain(x: C, rows: C, fold: SinusoidFold, delays, gains, hold: int = 1) -> C:
    """y (n_rx, lanes, T) from x (n_tx, lanes, T) and the phase rows
    (n_rx, n_tx, lanes, taps, 16), in plain PyTorch, in the kernel's order."""
    n_rx, n_tx, lanes = rows.shape[:3]
    T = x.shape[-1]
    a, b = fold_coefficients(rows, fold, gains)               # (rx, tx, lanes, taps, D)
    y_r = x.re.new_zeros((n_rx, lanes, T))
    y_i = x.re.new_zeros((n_rx, lanes, T))
    for tx in range(n_tx):
        for i, d in enumerate(delays):
            if d >= T:
                continue
            h_r = h_i = 0.0
            for k in range(fold.cos.shape[0]):
                c, s = fold.cos[k], fold.sin[k]                  # (Tg,)
                h_r = h_r + c * a.re[:, tx, :, i, k, None]
                h_r = h_r - s * b.im[:, tx, :, i, k, None]
                h_i = h_i + c * a.im[:, tx, :, i, k, None]
                h_i = h_i + s * b.re[:, tx, :, i, k, None]
            if hold > 1:
                h_r, h_i = (h.repeat_interleave(hold, dim=-1) for h in (h_r, h_i))
            h_r, h_i = h_r[..., d:], h_i[..., d:]
            x_r, x_i = x.re[tx, :, :T - d], x.im[tx, :, :T - d]
            y_r[..., d:] = y_r[..., d:] + h_r * x_r - h_i * x_i
            y_i[..., d:] = y_i[..., d:] + h_r * x_i + h_i * x_r
    return C(y_r, y_i)


def _check(x: C, rows: C, fold: SinusoidFold, delays, gains, hold: int) -> None:
    if rows.ndim != 5 or rows.shape[-1] != N_SINUSOIDS:
        raise ValueError(f"multipath_fir: phase rows {tuple(rows.shape)}, expected "
                         f"(n_rx, n_tx, lanes, taps, {N_SINUSOIDS})")
    n_rx, n_tx, lanes, taps = rows.shape[:4]
    T = x.shape[-1]
    if tuple(x.shape) != (n_tx, lanes, T):
        raise ValueError(f"multipath_fir: x {tuple(x.shape)}, expected ({n_tx}, {lanes}, T)")
    if len(delays) != taps or len(gains) != taps:
        raise ValueError(f"multipath_fir: {taps} taps, {len(delays)} delays, {len(gains)} gains")
    if hold < 1 or T % hold or fold.cos.shape[-1] != T // hold:
        raise ValueError(f"multipath_fir: table of {fold.cos.shape[-1]} columns for T = {T} "
                         f"held {hold}")
    if len(fold.group) != N_SINUSOIDS or len(fold.sign) != N_SINUSOIDS:
        raise ValueError("multipath_fir: the fold maps 16 sinusoids")


def multipath_fir(x: C, rows: C, fold: SinusoidFold, delays, gains, hold: int = 1) -> C:
    """y (n_rx, lanes, T) = Σ_tx Σ_i g_i·h_i(t)·x[tx, :, t − d_i] with the taps
    made from the phase rows (n_rx, n_tx, lanes, taps, 16) and the folded
    table: `multipath_fir_plain` on a CPU tensor, one launch of
    csrc/multipath_fir.cu on a CUDA tensor."""
    _check(x, rows, fold, delays, gains, hold)
    dev = x.re.device
    if dev.type == "cpu":
        return multipath_fir_plain(x, rows, fold, delays, gains, hold)
    if dev.type != "cuda":
        raise ValueError(f"multipath_fir: no kernel for device {dev}")
    n_rx, n_tx, lanes, taps = rows.shape[:4]
    T = x.shape[-1]
    D = fold.cos.shape[0]
    planes = (x.re, x.im, rows.re, rows.im, fold.cos, fold.sin)
    for p in planes:
        if p.dtype != torch.float32 or p.device != dev or not p.is_contiguous():
            raise ValueError(f"multipath_fir: the kernel reads contiguous float32 planes on "
                             f"{dev}, got {p.dtype} {tuple(p.stride())} on {p.device}")
    if max(n_rx, n_tx, lanes, T) >= 2 ** 31:
        raise ValueError("multipath_fir: a dimension exceeds int32")
    y = C(torch.empty((n_rx, lanes, T), dtype=torch.float32, device=dev),
          torch.empty((n_rx, lanes, T), dtype=torch.float32, device=dev))
    if y.re.numel() == 0:
        return y
    from .._build import library
    lib = library()
    ints = ctypes.c_int * N_SINUSOIDS
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.multipath_fir(*(p.data_ptr() for p in planes), y.re.data_ptr(),
                               y.im.data_ptr(), n_rx, n_tx, lanes, taps, T, hold, T // hold, D,
                               ints(*fold.group), ints(*fold.sign),
                               (ctypes.c_int * taps)(*(int(d) for d in delays)),
                               (ctypes.c_float * taps)(*(float(g) for g in gains)), stream)
    # the kernel itself refuses (cudaErrorInvalidValue, 1) more than 16 taps, a
    # table of other than 6 or 16 rows, and coefficients past a block's shared memory
    if rc != 0:
        raise RuntimeError(f"multipath_fir launch failed: CUDA error {rc} (n_rx={n_rx}, "
                           f"n_tx={n_tx}, lanes={lanes}, taps={taps}, table rows={D}, T={T}, "
                           f"hold={hold})")
    multipath_fir.launches += 1
    return y


multipath_fir.launches = 0
