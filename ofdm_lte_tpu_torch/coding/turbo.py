"""LTE rate-1/3 turbo codec (TS 36.212 §5.1.3): QPP interleaver, RSC
encoders without a loop over K, iterative BCJR decoding.

Port of ofdm_lte_tpu/coding/turbo.py, with its own copy of the QPP table:

- QPP permutation π(i) = (f1·i + f2·i²) mod K with the full 188-entry
  (f1, f2) table; interleaving is a gather on an index tensor kept on the
  device (coding.tables), or on the caller's (a link's buffer).
- RSC constituent encoders g0 = 013 (feedback), g1 = 015, 8 states, with the
  JAX package's convention that the systematic output is the feedback bit.
  The feedback obeys fb_k = b_k ⊕ fb_{k-2} ⊕ fb_{k-3}, the filter
  1/(1 + D² + D³), whose impulse response repeats every 7 steps
  (1,0,1,1,1,0,0). So fb_k = P(k) ⊕ P(k-2) ⊕ P(k-3) ⊕ P(k-4) with P(m) the
  XOR of the b_j with j ≤ m and j ≡ m (mod 7): one cumulative sum over b
  laid out as (⌈K/7⌉, 7) rows, and four shifted reads. The parity is
  fb ⊕ fb_{-1} ⊕ fb_{-3}; the three tail steps follow from the final state.
- Decoder: the JAX package's "scan" BCJR (max-log by default, exact
  log-MAP on request) in ops/bcjr.py, one launch a half-iteration on a
  card, the QPP gather of the a-priori and the extrinsic inside it; the
  extrinsic, tail and final-pass semantics of turbo.py:465-517.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

# the trellis lives beside the BCJR pass that walks it; named here too
from ..ops.bcjr import bcjr_app, bcjr_half, reverse_trellis, trellis_tables  # noqa: F401
from .tables import on_device

# QPP interleaver parameters (TS 36.212 Table 5.1.3-3): K -> (f1, f2).
QPP_PARAMS = {
    40: (3, 10), 48: (7, 12), 56: (19, 42), 64: (7, 16), 72: (7, 18),
    80: (11, 20), 88: (5, 22), 96: (11, 24), 104: (7, 26), 112: (41, 84),
    120: (103, 90), 128: (15, 32), 136: (9, 34), 144: (17, 108), 152: (9, 38),
    160: (21, 120), 168: (101, 84), 176: (21, 44), 184: (57, 46), 192: (23, 48),
    200: (13, 50), 208: (27, 52), 216: (11, 36), 224: (27, 56), 232: (85, 58),
    240: (29, 60), 248: (33, 62), 256: (15, 32), 264: (17, 198), 272: (33, 68),
    280: (103, 210), 288: (19, 36), 296: (19, 74), 304: (37, 76), 312: (19, 78),
    320: (21, 120), 328: (21, 82), 336: (115, 84), 344: (193, 86), 352: (21, 44),
    360: (133, 90), 368: (81, 46), 376: (45, 94), 384: (23, 48), 392: (243, 98),
    400: (151, 40), 408: (155, 102), 416: (25, 52), 424: (51, 106), 432: (47, 72),
    440: (91, 110), 448: (29, 168), 456: (29, 114), 464: (247, 58), 472: (29, 118),
    480: (89, 180), 488: (91, 122), 496: (157, 62), 504: (55, 84), 512: (31, 64),
    528: (17, 66), 544: (35, 68), 560: (227, 420), 576: (65, 96), 592: (19, 74),
    608: (37, 76), 624: (41, 234), 640: (39, 80), 656: (185, 82), 672: (43, 252),
    688: (21, 86), 704: (155, 44), 720: (79, 120), 736: (139, 92), 752: (23, 94),
    768: (217, 48), 784: (25, 98), 800: (17, 80), 816: (127, 102), 832: (25, 52),
    848: (239, 106), 864: (17, 48), 880: (137, 110), 896: (215, 112), 912: (29, 114),
    928: (15, 58), 944: (147, 118), 960: (29, 60), 976: (59, 122), 992: (65, 124),
    1008: (55, 84), 1024: (31, 64), 1056: (17, 66), 1088: (171, 204),
    1120: (67, 140), 1152: (35, 72), 1184: (19, 74), 1216: (39, 76),
    1248: (19, 78), 1280: (199, 240), 1312: (21, 82), 1344: (211, 252),
    1376: (21, 86), 1408: (43, 88), 1440: (149, 60), 1472: (45, 92),
    1504: (49, 846), 1536: (71, 48), 1568: (13, 28), 1600: (17, 80),
    1632: (25, 102), 1664: (183, 104), 1696: (55, 954), 1728: (127, 96),
    1760: (27, 110), 1792: (29, 112), 1824: (29, 114), 1856: (57, 116),
    1888: (45, 354), 1920: (31, 120), 1952: (59, 610), 1984: (185, 124),
    2016: (113, 420), 2048: (31, 64), 2112: (17, 66), 2176: (171, 136),
    2240: (209, 420), 2304: (253, 216), 2368: (367, 444), 2432: (265, 456),
    2496: (181, 468), 2560: (39, 80), 2624: (27, 164), 2688: (127, 504),
    2752: (143, 172), 2816: (43, 88), 2880: (29, 300), 2944: (45, 92),
    3008: (157, 188), 3072: (47, 96), 3136: (13, 28), 3200: (111, 240),
    3264: (443, 204), 3328: (51, 104), 3392: (51, 212), 3456: (451, 192),
    3520: (257, 220), 3584: (57, 336), 3648: (313, 228), 3712: (271, 232),
    3776: (179, 236), 3840: (331, 120), 3904: (363, 244), 3968: (375, 248),
    4032: (127, 168), 4096: (31, 64), 4160: (33, 130), 4224: (43, 264),
    4288: (33, 134), 4352: (477, 408), 4416: (35, 138), 4480: (233, 280),
    4544: (357, 142), 4608: (337, 480), 4672: (37, 146), 4736: (71, 444),
    4800: (71, 120), 4864: (37, 152), 4928: (39, 462), 4992: (127, 234),
    5056: (39, 158), 5120: (39, 80), 5184: (31, 96), 5248: (113, 902),
    5312: (41, 166), 5376: (251, 336), 5440: (43, 170), 5504: (21, 86),
    5568: (43, 174), 5632: (45, 176), 5696: (45, 178), 5760: (161, 120),
    5824: (89, 182), 5888: (323, 184), 5952: (47, 186), 6016: (23, 94),
    6080: (47, 190), 6144: (263, 480),
}


@functools.lru_cache(maxsize=None)
def qpp_indices(K: int) -> np.ndarray:
    """π such that interleaved[i] = x[π(i)], π(i) = (f1·i + f2·i²) mod K."""
    if K not in QPP_PARAMS:
        raise ValueError(f"Invalid interleaver size K={K}")
    f1, f2 = QPP_PARAMS[K]
    i = np.arange(K, dtype=np.int64)
    return ((f1 * i + f2 * i * i) % K).astype(np.int32)


@functools.lru_cache(maxsize=None)
def qpp_inverse_indices(K: int) -> np.ndarray:
    perm = qpp_indices(K)
    inv = np.zeros(K, np.int32)
    inv[perm] = np.arange(K, dtype=np.int32)
    return inv


def qpp_tables(K: int, device) -> tuple:
    """(π, π⁻¹) as int32 index tensors on `device`, kept by coding.tables:
    the gathers take them, and so does the decoder's kernel."""
    return (on_device(("qpp", K), lambda: qpp_indices(K).copy(), device),
            on_device(("qpp_inv", K), lambda: qpp_inverse_indices(K).copy(), device))


def qpp_interleave(x: torch.Tensor, K: int, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) in QPP order; `perm` is the kept π (qpp_tables) or a link's."""
    if perm is None:
        perm = qpp_tables(K, x.device)[0]
    return torch.index_select(x, -1, perm)


def qpp_deinterleave(x: torch.Tensor, K: int, inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    if inv is None:
        inv = qpp_tables(K, x.device)[1]
    return torch.index_select(x, -1, inv)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """x delayed by d steps along the last axis, zeros shifted in."""
    return torch.nn.functional.pad(x[..., :x.shape[-1] - d], (d, 0))


def rsc_encode(bits: torch.Tensor):
    """RSC encode with trellis termination.

    bits: (..., K) integers -> (systematic (..., K+3), parity (..., K+3))
    int32, 'systematic' being the feedback-bit stream (the JAX package's
    convention) and the 3 tail steps driving the state to zero."""
    b = bits.to(torch.int32)
    lead, K = tuple(b.shape[:-1]), b.shape[-1]
    rows = -(-K // 7)
    laid = torch.nn.functional.pad(b, (0, 7 * rows - K)).reshape(lead + (rows, 7))
    # P(m): XOR of b_j over j <= m, j = m (mod 7)
    P = (torch.cumsum(laid, dim=-2, dtype=torch.int32) & 1).reshape(lead + (7 * rows,))[..., :K]
    fb = P ^ _shift(P, 2) ^ _shift(P, 3) ^ _shift(P, 4)
    par = fb ^ _shift(fb, 1) ^ _shift(fb, 3)
    # tail: state (fb_{K-1}, fb_{K-2}, fb_{K-3}); the feedback is 0 in each of
    # the three steps and the parities are s0 ^ s2, then fb_{K-2}, fb_{K-1}
    f1, f2, f3 = fb[..., K - 1:K], fb[..., K - 2:K - 1], fb[..., K - 3:K - 2]
    sys_full = torch.cat([fb, torch.zeros_like(fb[..., :3])], dim=-1)
    par_full = torch.cat([par, f1 ^ f3, f2, f1], dim=-1)
    return sys_full, par_full


def turbo_encode(bits: torch.Tensor, K: int, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bits (..., K) -> encoded (..., 3K+12) int32, interlaced
    [sys_k, par1_k, par2_k]·K then 12 tail bits
    [sys_tail1, par1_tail, sys_tail2, par2_tail]."""
    sys1, par1 = rsc_encode(bits)
    sys2, par2 = rsc_encode(qpp_interleave(bits, K, perm))
    lead = tuple(bits.shape[:-1])
    data = torch.stack([sys1[..., :K], par1[..., :K], par2[..., :K]], dim=-1)
    tails = torch.cat([sys1[..., K:], par1[..., K:], sys2[..., K:], par2[..., K:]], dim=-1)
    return torch.cat([data.reshape(lead + (3 * K,)), tails], dim=-1)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

# True = max-log (the reference's default), False = exact log-MAP; a call's
# `use_max_log` overrides it.
USE_MAX_LOG_MAP = True


def set_decoder_mode(use_max_log_map: bool = True) -> None:
    """The decoders' default semiring: max-log (True) or exact log-MAP."""
    global USE_MAX_LOG_MAP
    USE_MAX_LOG_MAP = bool(use_max_log_map)


def _bcjr(llr_sys: torch.Tensor, llr_par: torch.Tensor, llr_apriori: torch.Tensor,
          impl: str = "scan", use_max_log: bool = True) -> torch.Tensor:
    """A-posteriori LLRs (..., K') of one BCJR pass, the trellis started and
    ended in state 0. Only the JAX package's "scan" form is ported: its
    "block" form is a TPU latency workaround, which the kernel replaces on
    a card, and "assoc" a reference algebra 8× slower than "scan"."""
    if impl != "scan":
        raise ValueError(f"BCJR impl {impl!r}: the port runs 'scan' alone")
    return bcjr_app(llr_sys, llr_par, llr_apriori, use_max_log)


def constituent_llrs(llr_encoded: torch.Tensor, K: int, perm: torch.Tensor) -> tuple:
    """The two constituent decoders' systematic and parity LLRs (..., K+3),
    each with its tail, from llr_encoded (..., 3K+12): decoder 2's
    systematic is decoder 1's through π."""
    llr = llr_encoded.to(torch.float32)
    lead = tuple(llr.shape[:-1])
    data = llr[..., :3 * K].reshape(lead + (K, 3))
    l_sys, l_par1, l_par2 = data[..., 0], data[..., 1], data[..., 2]
    t = llr[..., 3 * K:]
    return (torch.cat([l_sys, t[..., 0:3]], dim=-1),
            torch.cat([l_par1, t[..., 3:6]], dim=-1),
            torch.cat([torch.index_select(l_sys, -1, perm), t[..., 6:9]], dim=-1),
            torch.cat([l_par2, t[..., 9:12]], dim=-1))


def turbo_decode(llr_encoded: torch.Tensor, K: int, num_iterations: int = 5,
                 use_max_log: Optional[bool] = None, perm: Optional[torch.Tensor] = None,
                 inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Iterative turbo decode of llr_encoded (..., 3K+12) float32 in the
    encoder's interlaced order (LLR > 0 means bit 0) -> hard bits (..., K)
    int32. extrinsic = APP − a-priori − systematic, the tails appended per
    constituent decoder, the final pass on decoder 1's APP: 2·num_iterations
    + 1 BCJR passes, each one `bcjr_half` (one kernel launch on a card)
    that reads the other decoder's extrinsic through π or π⁻¹. `perm`/`inv`
    are the QPP index tensors, int32 (qpp_tables).

    The JAX package's loop (ofdm_lte_tpu/coding/turbo.py:495-517) keeps
    ext21 = deinterleave(ext_2) in decoder 1's order; here decoder 2's
    extrinsic e2 stays in its own order and decoder 1 reads e2[π⁻¹[j]],
    which is ext21[j], while decoder 2 reads e1[π[k]], ext12's interleave:
    the same numbers in the same operations. e1 and e2 are step-major
    (K, ...) planes, as bcjr_half keeps them."""
    if use_max_log is None:
        use_max_log = USE_MAX_LOG_MAP
    if perm is None or inv is None:
        perm, inv = qpp_tables(K, llr_encoded.device)
    l_sys1, l_par1e, l_sys2, l_par2e = constituent_llrs(llr_encoded, K, perm)
    e2 = None                                   # the first iteration's zeros
    for _ in range(num_iterations):
        e1 = bcjr_half(l_sys1, l_par1e, e2, inv, use_max_log=use_max_log)
        e2 = bcjr_half(l_sys2, l_par2e, e1, perm, use_max_log=use_max_log)
    return bcjr_half(l_sys1, l_par1e, e2, inv, hard=True, use_max_log=use_max_log)
