"""MIMO detectors (MMSE/IRC, ZF, SIC, MRC), batched over subcarriers.

Port of ofdm_lte_tpu/mimo/detector.py:

- MMSE/IRC: ŝ = (HᴴH + σ²I)⁻¹ Hᴴ y
- ZF:       ŝ = (HᴴH + εI)⁻¹ Hᴴ y, ε = 1e-9
- SIC:      SINR-ordered MMSE + hard decision + cancellation against the
            original H
- MRC:      rank-1 ŝ = hᴴy/‖h‖²

Two layouts. The *plane* solvers (`mmse_planes`, `sic_planes`) take the rx
and layer axes unrolled as Python lists of (..., S, m) planes, so every
operand keeps the large subcarrier axis minor: the spatial link's route
for MMSE, ZF and SIC at ranks 1 to 4. `sic_stacked`, which `sic_planes`
wraps and the link's SIC (ops/sic_detect) calls off the card, takes the
same planes stacked on leading axes, (rx, ...) and (rx, L, ...), and runs
the plane arithmetic one launch per operation over every (layer, layer)
entry, as does the plane solve of ranks 1 and 3 (`_solve_s`). The
*stacked* detectors take y (..., rx) and H (..., rx, L) with the tiny axes
trailing and solve through cplx.solve: the route of MRC and the unbiased
MMSE. σ² is a scalar or one value per lane: right-padded against planes,
left-aligned against stacked matrices. All of it is elementwise PyTorch,
closed forms for L ≤ 4; a tie in the SIC order goes to the lowest layer
index in both layouts.

On a card the spatial link's SIC runs as one kernel, ops/sic_detect, whose
plain version is `effective_planes` and `sic_stacked`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import cplx
from ..cplx import C
from ..ops import qam


def _as_sigma(sigma2, device):
    """σ² as a Python float (a scalar: no copy to the device on the hot path)
    or a float32 tensor on `device` (one value per lane)."""
    if isinstance(sigma2, torch.Tensor):
        return sigma2.to(device=device, dtype=torch.float32)
    s = np.asarray(sigma2, np.float32)
    return float(s) if s.ndim == 0 else torch.as_tensor(s, device=device)


def _ndim(sigma2) -> int:
    return getattr(sigma2, "ndim", 0)


def _gram(H: C) -> C:
    """HᴴH for H (..., rx, L) -> (..., L, L), as a multiply-sum."""
    Hh = C(H.re.transpose(-1, -2), -H.im.transpose(-1, -2))
    return cplx.matmul_small(Hh, H)


def _Hh_y(H: C, y: C) -> C:
    """Hᴴy for H (..., rx, L), y (..., rx) -> (..., L)."""
    return (H.conj() * C(y.re[..., None], y.im[..., None])).sum(axis=-2)


def _add_diag(A: C, d) -> C:
    """A + d·I with a real scalar (or per-lane) d broadcast over the batch."""
    eye = torch.eye(A.shape[-1], dtype=A.re.dtype, device=A.re.device)
    d = _as_sigma(d, A.re.device)
    if _ndim(d):
        d = d[..., None, None]
    return C(A.re + eye * d, A.im)


def effective_channel(H: C, W: C) -> C:
    """H_eff = H @ W. H (..., rx, tx), W (tx, L) or (..., tx, L)."""
    return cplx.matmul_small(H, W)


def effective_planes(h_tx: Sequence[C], W: C) -> C:
    """heff (rx, L, ...) of the per-TX planes h_tx[t] (rx, ...) and W (tx, L):
    heff[rx, l] = Σ_t h_tx[t][rx]·W[t, l], summed in t order, every layer at
    once."""
    L = W.shape[1]
    heff = None
    for t, h in enumerate(h_tx):
        w = W[t].reshape((1, L) + (1,) * (h.ndim - 1))
        term = C(h.re[:, None], h.im[:, None]) * w
        heff = term if heff is None else heff + term
    return heff


def _mmse2_fused(y: C, H_eff: C, s2) -> C:
    """Closed-form 2-layer MMSE with no matrix temporaries: G = HᴴH + σ²I
    is [[a, b], [b̄, d]] (a, d real), ŝ = G⁻¹Hᴴy via the 2×2 adjugate."""
    h0, h1 = H_eff[..., 0], H_eff[..., 1]               # (..., rx)
    s2 = _as_sigma(s2, y.re.device)
    if _ndim(s2):
        s2 = s2.reshape(tuple(s2.shape) + (1,) * (h0.ndim - 1 - s2.ndim))
    a = h0.abs2().sum(-1) + s2
    d = h1.abs2().sum(-1) + s2
    b = (h0.conj() * h1).sum(-1)
    z0 = (h0.conj() * y).sum(-1)
    z1 = (h1.conj() * y).sum(-1)
    s0, s1 = _adjugate2(a, b, d, z0, z1)
    return cplx.stack([s0, s1], axis=-1)


def _adjugate2(a, b: C, d, z0: C, z1: C):
    """[[a, b], [b̄, d]]⁻¹ [z0, z1] for real a, d and complex b."""
    inv = 1.0 / (a * d - b.abs2())
    s0 = C((d * z0.re - (b.re * z1.re - b.im * z1.im)) * inv,
           (d * z0.im - (b.re * z1.im + b.im * z1.re)) * inv)
    s1 = C((a * z1.re - (b.re * z0.re + b.im * z0.im)) * inv,
           (a * z1.im - (b.re * z0.im - b.im * z0.re)) * inv)
    return s0, s1


def _csum(terms):
    acc = None
    for t in terms:
        acc = t if acc is None else acc + t
    return acc


def _align_sigma_planes(sigma2, ref_plane: C):
    """Right-pad a scalar or per-lane σ² with singleton axes so that it
    broadcasts against a (..., S, m) plane."""
    s2 = _as_sigma(sigma2, ref_plane.re.device)
    nd = ref_plane.ndim
    if _ndim(s2) and s2.ndim < nd:
        s2 = s2.reshape(tuple(s2.shape) + (1,) * (nd - s2.ndim))
    return s2


def _matched(y_planes, heff_planes, i: int) -> C:
    """z_i = Σ_rx conj(h[rx][i])·y[rx]."""
    return _csum(hp[i].conj() * yr for hp, yr in zip(heff_planes, y_planes))


def _gram_plane(heff_planes, i: int, j: int) -> C:
    return _csum(hp[i].conj() * hp[j] for hp in heff_planes)


def mmse2_planes(y_planes, heff_planes, sigma2) -> List[C]:
    """Fused closed-form 2-layer MMSE on per-(rx, layer) channel planes.

    y_planes: list over rx of C planes (..., S, m); heff_planes: nested
    [rx][layer] effective-channel planes of the same shape. Returns
    [s0, s1] layer planes: _mmse2_fused with the rx and layer axes unrolled."""
    s2 = _align_sigma_planes(sigma2, y_planes[0])
    a = sum(hp[0].abs2() for hp in heff_planes) + s2
    d = sum(hp[1].abs2() for hp in heff_planes) + s2
    b = _gram_plane(heff_planes, 0, 1)
    return list(_adjugate2(a, b, d, _matched(y_planes, heff_planes, 0),
                           _matched(y_planes, heff_planes, 1)))


def _m2_mul(a, b):
    """2×2 plane-matrix product: a, b are [[C, C], [C, C]] nests of planes."""
    return [[a[0][0] * b[0][0] + a[0][1] * b[1][0],
             a[0][0] * b[0][1] + a[0][1] * b[1][1]],
            [a[1][0] * b[0][0] + a[1][1] * b[1][0],
             a[1][0] * b[0][1] + a[1][1] * b[1][1]]]


def _m2_vec(a, v):
    """2×2 plane matrix @ 2-vector of planes."""
    return [a[0][0] * v[0] + a[0][1] * v[1],
            a[1][0] * v[0] + a[1][1] * v[1]]


def _reciprocal(d: C) -> C:
    n = d.abs2()
    return C(d.re / n, -d.im / n)


def _m2_inv(a):
    """Closed-form 2×2 plane-matrix inverse (adjugate / det)."""
    inv = _reciprocal(a[0][0] * a[1][1] - a[0][1] * a[1][0])
    return [[a[1][1] * inv, -1.0 * (a[0][1] * inv)],
            [-1.0 * (a[1][0] * inv), a[0][0] * inv]]


def _m2_herm(a):
    """Conjugate transpose of a 2×2 plane matrix."""
    return [[a[0][0].conj(), a[1][0].conj()],
            [a[0][1].conj(), a[1][1].conj()]]


def mmse4_planes(y_planes, heff_planes, sigma2) -> List[C]:
    """Closed-form 4-layer MMSE on per-(rx, layer) channel planes via the
    2×2-block Schur complement: G = HᴴH + σ²I = [[A, B], [Bᴴ, D]],
    ŝ = G⁻¹Hᴴy with S = D − BᴴA⁻¹B. Returns [s0..s3] layer planes."""
    s2 = _align_sigma_planes(sigma2, y_planes[0])

    def gram(i, j):
        g = _gram_plane(heff_planes, i, j)
        return C(g.re + s2, g.im) if i == j else g

    z = [_matched(y_planes, heff_planes, i) for i in range(4)]
    A = [[gram(0, 0), gram(0, 1)], [gram(1, 0), gram(1, 1)]]
    B = [[gram(0, 2), gram(0, 3)], [gram(1, 2), gram(1, 3)]]
    D = [[gram(2, 2), gram(2, 3)], [gram(3, 2), gram(3, 3)]]

    Ainv = _m2_inv(A)
    BhAinv = _m2_mul(_m2_herm(B), Ainv)
    BhAinvB = _m2_mul(BhAinv, B)
    S = [[D[i][j] - BhAinvB[i][j] for j in range(2)] for i in range(2)]
    lo = _m2_vec(BhAinv, z[:2])
    s_lo = _m2_vec(_m2_inv(S), [z[2] - lo[0], z[3] - lo[1]])
    hi = _m2_vec(B, s_lo)
    s_hi = _m2_vec(Ainv, [z[0] - hi[0], z[1] - hi[1]])
    return [s_hi[0], s_hi[1], s_lo[0], s_lo[1]]


def _m2_mul_s(a: C, b: C) -> C:
    """_m2_mul of 2×2 blocks stacked on the two leading axes, (2, 2, ...):
    p[i, k, j] = a[i, k]·b[k, j], summed over k in _m2_mul's order."""
    p = C(a.re[:, :, None], a.im[:, :, None]) * C(b.re[None], b.im[None])
    return p[:, 0] + p[:, 1]


def _m2_vec_s(a: C, v: C) -> C:
    """_m2_vec of a stacked block a (2, 2, ...) and vector v (2, ...)."""
    p = a * C(v.re[None], v.im[None])
    return p[:, 0] + p[:, 1]


def _pair(a: C, b: C) -> C:
    return C(torch.stack([a.re, b.re]), torch.stack([a.im, b.im]))


def _m2_inv_s(a: C, sign: torch.Tensor) -> C:
    """_m2_inv of a stacked block: the adjugate's entries times 1/det, the
    off-diagonal ones negated (`sign` is [[1, −1], [−1, 1]])."""
    inv = _reciprocal(a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0])
    adj = _pair(_pair(a[1, 1], a[0, 1]), _pair(a[1, 0], a[0, 0])) * inv
    return C(adj.re * sign, adj.im * sign)


def _solve2_s(G: C, z: C) -> C:
    """The closed-form 2×2 solve of a stacked system G (2, 2, ...) (general,
    not necessarily Hermitian), z (2, ...)."""
    inv = _reciprocal(G[0, 0] * G[1, 1] - G[0, 1] * G[1, 0])
    return (_pair(G[1, 1], G[0, 0]) * z - _pair(G[0, 1], G[1, 0]) * _pair(z[1], z[0])) * inv


def _solve4_s(G: C, z: C, sign: torch.Tensor) -> C:
    """A 4×4 solve of a stacked system G (4, 4, ...), z (4, ...) via the
    2×2-block Schur complement, the plane counterpart of cplx.solve's n = 4
    path: each block operation one launch over its stacked entries, every
    sum in the order of the 2×2 plane-matrix helpers above."""
    A, B, Cm, D = G[:2, :2], G[:2, 2:], G[2:, :2], G[2:, 2:]
    Ainv = _m2_inv_s(A, sign)
    Ainv_b1 = _m2_vec_s(Ainv, z[:2])
    AinvB = _m2_mul_s(Ainv, B)
    S = D - _m2_mul_s(Cm, AinvB)
    x2 = _solve2_s(S, z[2:] - _m2_vec_s(Cm, Ainv_b1))
    return cplx.concatenate([Ainv_b1 - _m2_vec_s(AinvB, x2), x2], axis=0)


def _solve_s(G: C, z: C, sign: torch.Tensor) -> C:
    """A plane-system solve on a stacked system G (L, L, ...), z (L, ...),
    for L in {1, 2, 3, 4}: L = 3 pads to the 4×4 Schur path with a
    decoupled unit fourth equation."""
    L = z.shape[0]
    if L == 1:
        return z * _reciprocal(G[0, 0])
    if L == 2:
        return _solve2_s(G, z)
    if L == 3:
        G4 = cplx.czeros((4, 4) + tuple(z.shape[1:]), z.re.device)
        G4.re[:3, :3], G4.im[:3, :3] = G.re, G.im
        G4.re[3, 3] = 1.0
        z4 = cplx.concatenate([z, cplx.czeros((1,) + tuple(z.shape[1:]), z.re.device)], axis=0)
        return _solve4_s(G4, z4, sign)[:3]
    if L == 4:
        return _solve4_s(G, z, sign)
    raise ValueError(f"plane solve supports L<=4, got {L}")


def _sign(ndim: int, device) -> torch.Tensor:
    """[[1, −1], [−1, 1]] shaped (2, 2, 1, ...) against ndim site axes."""
    return (torch.eye(2, device=device) * 2.0 - 1.0).reshape((2, 2) + (1,) * ndim)


def _solve_planes(G, z) -> List[C]:
    """A plane-system solve for L in {1, 2, 3, 4}: G a [L][L] nest of C
    planes, z [L] planes, stacked and solved by _solve_s."""
    L = len(z)
    if L > 4:
        raise ValueError(f"plane solve supports L<=4, got {L}")
    plane = tuple(z[0].shape)
    Gs = C(torch.stack([g.re for row in G for g in row]).reshape((L, L) + plane),
           torch.stack([g.im for row in G for g in row]).reshape((L, L) + plane))
    s = _solve_s(Gs, cplx.stack(z, axis=0), _sign(len(plane), z[0].re.device))
    return [s[l] for l in range(L)]


def mmse_planes(y_planes, heff_planes, sigma2) -> List[C]:
    """Plane MMSE for L in {1, 2, 3, 4} layers: the fused 2-layer and the
    block-Schur 4-layer forms, and the same plane layout for ranks 1 and 3."""
    L = len(heff_planes[0])
    if L == 2:
        return mmse2_planes(y_planes, heff_planes, sigma2)
    if L == 4:
        return mmse4_planes(y_planes, heff_planes, sigma2)
    s2 = _align_sigma_planes(sigma2, y_planes[0])

    def gram(i, j):
        g = _gram_plane(heff_planes, i, j)
        return C(g.re + s2, g.im) if i == j else g

    G = [[gram(i, j) for j in range(L)] for i in range(L)]
    z = [_matched(y_planes, heff_planes, i) for i in range(L)]
    return _solve_planes(G, z)


def sic_planes(y_planes, heff_planes, sigma2, modulation: str) -> List[C]:
    """SIC on per-(rx, layer) channel planes: y_planes a list over rx of C
    planes (..., S, m), heff_planes the nested [rx][layer] planes of the
    same shape; returns the L layers' hard decisions as planes. The planes
    are stacked into the layout of `sic_stacked`, which computes them."""
    rx, L = len(heff_planes), len(heff_planes[0])
    plane = tuple(y_planes[0].shape)
    flat = [p for row in heff_planes for p in row]
    H = C(torch.stack([p.re for p in flat]).reshape((rx, L) + plane),
          torch.stack([p.im for p in flat]).reshape((rx, L) + plane))
    s = sic_stacked(cplx.stack(y_planes, axis=0), H, sigma2, modulation)
    return [s[l] for l in range(L)]


def sic_stacked(y: C, H: C, sigma2, modulation: str) -> C:
    """SIC with the rx and layer axes leading: y (rx, ...) and the effective
    channel H (rx, L, ...), the sites (..., S, m) trailing -> the hard
    decisions (L, ...). SINR order from the original columns, per-stage
    MMSE over the remaining set, hard decision, cancellation against the
    original H. The per-stage masked MMSE solves the plane system with the
    inactive columns' Gram rows and columns zeroed and their diagonal
    padded to σ²+1, as the stacked `sic` masks H.

    The arithmetic of the plane solvers, element for element and sum for
    sum, on stacked tensors: each operation is one launch over every
    (layer, layer) or (rx, layer) entry at once, not one a plane. Two
    shortcuts (identical math, fewer passes): the masked Gram is the
    original Gram scaled by a_i·a_j, so the base Gram is computed once; and
    the residual's matched filter updates in the Gram domain,
    z_i ← z_i − ŝ_hard·g_base[i][sel] (= Hᴴ(y − h_sel·ŝ_hard)), so y is
    never re-read after the initial z.
    """
    rx, L = H.shape[0], H.shape[1]
    dev = y.re.device
    s2 = _align_sigma_planes(sigma2, y[0])

    # base Gram (no σ², no masks) and matched filter, both stage-invariant,
    # summed over rx in rx order
    Hc = H.conj()
    gram = C(Hc.re[:, :, None], Hc.im[:, :, None]) * C(H.re[:, None], H.im[:, None])
    g_base = _csum(gram[r] for r in range(rx))                   # (L, L, ...)
    mf = Hc * C(y.re[:, None], y.im[:, None])
    z = _csum(mf[r] for r in range(rx))                          # (L, ...)
    del gram, mf

    colp = torch.diagonal(g_base.re, 0, 0, 1).movedim(-1, 0)     # (L, ...)
    total = _csum(colp[l] for l in range(L))
    sinr = colp / (total - colp + s2 + 1e-10)

    active = torch.ones_like(colp)
    s_hat = C(torch.zeros_like(colp), torch.zeros_like(colp))
    layer = torch.arange(L, device=dev).reshape((L,) + (1,) * (colp.ndim - 1))
    sign = _sign(colp.ndim - 1, dev)
    s2_diag = s2[..., None] if _ndim(s2) else s2

    for _ in range(L):
        # the stage's layer: argmax of the original SINR among the active
        # columns, the first index on a tie
        sel_idx = torch.argmax(torch.where(active > 0, sinr, float("-inf")), dim=0)
        sel = (sel_idx[None] == layer).to(torch.float32)          # (L, ...)

        aa = active[:, None] * active[None, :]
        G = C(g_base.re * aa, g_base.im * aa)
        diag = torch.diagonal(G.re, 0, 0, 1)
        diag.add_(s2_diag)
        diag.add_((1.0 - active).movedim(0, -1))
        s_all = _solve_s(G, C(z.re * active, z.im * active), sign)

        s_hard = qam.detect(C(s_all.re * sel, s_all.im * sel).sum(axis=0), modulation)
        s_hat = cplx.where(sel > 0, C(s_hard.re[None], s_hard.im[None]), s_hat)
        # cancel in the Gram domain against the original columns
        gsel = C((g_base.re * sel[None]).sum(dim=1), (g_base.im * sel[None]).sum(dim=1))
        z = z - gsel * s_hard
        active = active * (1.0 - sel)

    return s_hat


def _align_sigma(sigma2, H_eff: C):
    """Left-align a scalar or per-lane σ² against H_eff's batch dims so that
    it broadcasts under appended matrix axes."""
    s = _as_sigma(sigma2, H_eff.re.device)
    batch_rank = H_eff.ndim - 2
    if _ndim(s) and s.ndim < batch_rank:
        s = s.reshape(tuple(s.shape) + (1,) * (batch_rank - s.ndim))
    return s


def mmse(y: C, H_eff: C, sigma2) -> C:
    """y (..., rx), H_eff (..., rx, L) -> ŝ (..., L)."""
    s2 = _align_sigma(sigma2, H_eff)
    if H_eff.shape[-1] == 2:
        return _mmse2_fused(y, H_eff, s2)
    return cplx.solve(_add_diag(_gram(H_eff), s2), _Hh_y(H_eff, y))


def zf(y: C, H_eff: C, regularization: float = 1e-9) -> C:
    return cplx.solve(_add_diag(_gram(H_eff), regularization), _Hh_y(H_eff, y))


def mmse_unbiased(y: C, H_eff: C, sigma2) -> C:
    """Unbiased MMSE: ŝ = (HᴴH+σ²I)⁻¹Hᴴy is biased, E[ŝ|s] = (G+σ²I)⁻¹G·s
    shrinks and mixes the layers. Dividing each layer by its bias
    b_i = 1 − σ²·[(G+σ²I)⁻¹]_ii restores E[ŝ_i|s] ≈ s_i and keeps the MMSE
    interference suppression. The biased form stays detector_type="MMSE"."""
    L = H_eff.shape[-1]
    s2 = _align_sigma(sigma2, H_eff)
    G = _add_diag(_gram(H_eff), s2)
    s_hat = cplx.solve(G, _Hh_y(H_eff, y))
    # the diagonal of (G+σ²I)⁻¹ from L unit-vector solves (L ≤ 4, closed
    # form); Hermitian positive definite, so it is real and positive
    batch = tuple(H_eff.shape[:-2])
    d = []
    for i in range(L):
        e = torch.zeros(batch + (L,), dtype=torch.float32, device=y.re.device)
        e[..., i] = 1.0
        d.append(cplx.solve(G, C(e, torch.zeros_like(e))).re[..., i])
    dinv = torch.stack(d, dim=-1)                          # (..., L)
    s2b = s2[..., None] if _ndim(s2) else s2
    b = torch.clamp(1.0 - s2b * dinv, min=1e-6)            # bias per layer
    return C(s_hat.re / b, s_hat.im / b)


def mrc(y: C, H_eff: C) -> C:
    """Rank-1 only: H_eff (..., rx, 1)."""
    h = H_eff[..., 0]
    num = (h.conj() * y).sum(axis=-1)
    den = h.abs2().sum(dim=-1)
    return C((num.re / den)[..., None], (num.im / den)[..., None])


def sic(y: C, H_eff: C, sigma2, modulation: str) -> C:
    """Successive interference cancellation with hard decisions.

    Ordering: per-subcarrier SINR_i = ‖h_i‖²/(Σ_{j≠i}‖h_j‖² + σ²), strongest
    first, ties to the lowest index; each stage MMSE-detects the chosen layer
    over the remaining set, hard-decides against the constellation, and
    subtracts h_layer·ŝ_hard from the residual using the original H.
    """
    L = H_eff.shape[-1]
    batch = tuple(H_eff.shape[:-2])
    dev = y.re.device
    sigma2 = _align_sigma(sigma2, H_eff)
    sigma2_l = sigma2[..., None] if _ndim(sigma2) else sigma2
    col_power = H_eff.abs2().sum(dim=-2)                      # (..., L)
    total = col_power.sum(dim=-1, keepdim=True)
    sinr = col_power / (total - col_power + sigma2_l + 1e-10)
    order = torch.argsort(-sinr, dim=-1, stable=True)         # (..., L)

    y_res = y
    active = torch.ones(batch + (L,), dtype=torch.float32, device=dev)
    s_hat = cplx.czeros(batch + (L,), dev)
    eye = torch.eye(L, dtype=torch.float32, device=dev)
    s_mat = sigma2[..., None, None] if _ndim(sigma2) else sigma2

    for it in range(L):
        layer = order[..., it]                                # (...,)
        one_hot = torch.nn.functional.one_hot(layer, L).to(torch.bool)
        # mask the inactive columns of H, pad their Gram diagonal with 1
        Hm = C(H_eff.re * active[..., None, :], H_eff.im * active[..., None, :])
        G = _gram(Hm)
        G = C(G.re + eye * s_mat + eye * (1.0 - active[..., None, :]), G.im)
        s_all = cplx.solve(G, _Hh_y(Hm, y_res))               # (..., L)
        s_hard = qam.detect(cplx.take_along(s_all, layer), modulation)
        s_hat = cplx.where(one_hot, C(s_hard.re[..., None], s_hard.im[..., None]), s_hat)

        # cancel against the original H
        h_layer = cplx.take_along(H_eff, layer[..., None].expand(tuple(H_eff.shape[:-1])))
        y_res = y_res - h_layer * C(s_hard.re[..., None], s_hard.im[..., None])
        active = active * (1.0 - one_hot.to(torch.float32))

    return s_hat


def detect(y: C, H: C, sigma2, detector_type: str = "MMSE", W: Optional[C] = None,
           modulation: Optional[str] = None) -> C:
    """Dispatch by detector name. y (..., rx), H (..., rx, tx); W optional
    (tx, L). Returns (..., L)."""
    H_eff = cplx.matmul_small(H, W) if W is not None else H
    dt = detector_type.upper()
    if dt in ("MMSE", "IRC"):
        return mmse(y, H_eff, sigma2)
    if dt in ("MMSE-U", "MMSE_UNBIASED"):
        return mmse_unbiased(y, H_eff, sigma2)
    if dt == "ZF":
        return zf(y, H_eff)
    if dt == "SIC":
        if modulation is None:
            return mmse(y, H_eff, sigma2)      # no constellation: plain MMSE
        return sic(y, H_eff, sigma2, modulation)
    if dt == "MRC":
        if H_eff.shape[-1] != 1:
            raise ValueError("MRC only supports num_layers=1")
        return mrc(y, H_eff)
    raise ValueError(f"Detector '{detector_type}' not supported")
