"""The plain reference of the turbo-coded SISO LTE link's HARQ sweep, in
float64 and complex128.

Written from TS 36.212 and the simulator's stated conventions (the
configuration's `assumed`), with its own tables; it imports neither JAX,
the JAX package nor the port, and takes nothing the port made. The OFDM
numerology, grid, CRS and QAM levels are the SISO reference's
(lte_siso.py, loaded beside this file).

A transport block of A bits, one a frame:

- CRC-24A (g = 0x1864CFB) appended, B = A + 24 bits; code-block
  segmentation by TS 36.212 §5.1.2 (C = ⌈B / 6120⌉ blocks when B > 6144,
  K± from the QPP table, fillers at the start of the first block), each
  block of a segmented block given CRC-24B (g = 0x1800063). A CRC is the
  remainder of m(x)·x^24 mod g(x): the sum over the message's 1 bits of
  the remainders of their powers, one 0/1 matrix a length, applied as an
  exact float64 product mod 2.
- The rate-1/3 turbo code: two 8-state RSC encoders (feedback 1 + D² + D³,
  parity 1 + D + D³), the second on the block through the QPP
  interleaver π(i) = (f1·i + f2·i²) mod K, each terminated by three tail
  steps of zero feedback. The simulator sends the feedback bit a_k as the
  systematic bit (not the input c_k), and as the tail's systematic bits.
  Output (3K + 12): [x_k, z_k, z'_k] for k < K, then the tails [x_K..,
  z_K.., x'_K.., z'_K..], three bits each.
- Rate matching at E = 3K + 12 (no puncturing to the grid): streams d0 =
  the systematic bits and both systematic tails (K + 6), d1 / d2 = each
  parity with its tail (K + 3); each through a 32-column sub-block
  interleaver (the stream written column by column into ⌈n/32⌉ rows, the
  columns permuted by TS 36.212's P, read row by row, the positions past
  n dropped); a circular buffer of 3(K + 6) positions holding
  [v0_i, v1_i, v2_i] for each i, empty positions sending a 0 bit; E bits
  read from the start ⌊j·N_cb/4⌋ of rv j.
- The blocks' E-bit streams laid end to end, MSB-first QAM symbols (64-QAM
  as in lte_siso) padded with zero symbols to R·n_data (R = OFDM symbols a
  transmission), written row by row into an (R, n_data) matrix and read
  column by column, the stream so read laid onto the grid symbol by
  symbol; CRS in every symbol; IDFT and CP.
- AWGN in the time domain: σ² = P / SNR, P the transmission's mean sample
  power, standard normals of the harness's draws scaled by σ/√2 a leg.
- The receiver: DFT of each symbol after its CP at the data bins, LS
  estimates at the pilots of symbols 0, 14, 28, ..., linear interpolation,
  held for the 14-symbol slot, ZF Y/(Ĥ + 1e-6); the de-interleave; a noise
  variance of max(s²/|Ĥ|², s²/4) a symbol, |Ĥ|² clipped to [1e-6, 1e6], s²
  = 10^(−SNR/10); per axis max-log LLRs (min distance over the levels
  whose bit is 1, less that over the levels whose bit is 0, over 2·var),
  clipped to ±10, LLR > 0 meaning bit 0.
- De-rate-matching (each LLR to its circular-buffer position, then to its
  encoder bit; a bit not sent reads 0) and IR combining: the sum of every
  transmission's LLRs so far.
- The turbo decoder, 8 iterations of max-log BCJR: decoder 1 on (x, z),
  decoder 2 on (x through π, z'), each trellis started and ended in state
  0; a-priori the other decoder's extrinsic (APP − a-priori − L_sys)
  through π or π⁻¹, 0 on the tails; the hard bits APP < 0 of a last pass
  of decoder 1. The α and β recursions are the textbook max-plus ones; to
  run K' = K + 3 steps without K' launches each, the steps are composed in
  chunks of L into 8×8 max-plus transfer matrices, the chunks' boundary
  metrics carried across them, and each chunk walked again from its
  boundary (all chunks at once): the same sums as the step-by-step
  recursion, in float64.
- HARQ: transmissions at rv_sequence until CRC-24A of the decoded
  transport block passes; a block that never passes keeps the last
  decode. A lane's outcome: whether it has passed by each stage, its
  transmissions, its residual information-bit errors, and the PAPR of its
  first transmission (the peak over the mean of |x|² over every sample).
"""
from __future__ import annotations

import functools
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import torch


def _siso():
    name = "portbench_reference_lte_siso"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, Path(__file__).with_name("lte_siso.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


CRC24A, CRC24B = 0x1864CFB, 0x1800063
Z, L_CRC = 6144, 24
SLOT = 14
EPS_ZF = 1e-6
LLR_CLIP = 10.0
CHUNK = 64                  # trellis steps composed into one transfer matrix
LANE_BLOCK = 256            # lanes decoded together (memory: some 15 GB at K 5,824)
SUBBLOCK_P = (0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
              1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31)

# TS 36.212 Table 5.1.3-3: K -> (f1, f2) of the QPP interleaver
QPP = {
    40: (3, 10), 48: (7, 12), 56: (19, 42), 64: (7, 16), 72: (7, 18), 80: (11, 20),
    88: (5, 22), 96: (11, 24), 104: (7, 26), 112: (41, 84), 120: (103, 90), 128: (15, 32),
    136: (9, 34), 144: (17, 108), 152: (9, 38), 160: (21, 120), 168: (101, 84),
    176: (21, 44), 184: (57, 46), 192: (23, 48), 200: (13, 50), 208: (27, 52),
    216: (11, 36), 224: (27, 56), 232: (85, 58), 240: (29, 60), 248: (33, 62),
    256: (15, 32), 264: (17, 198), 272: (33, 68), 280: (103, 210), 288: (19, 36),
    296: (19, 74), 304: (37, 76), 312: (19, 78), 320: (21, 120), 328: (21, 82),
    336: (115, 84), 344: (193, 86), 352: (21, 44), 360: (133, 90), 368: (81, 46),
    376: (45, 94), 384: (23, 48), 392: (243, 98), 400: (151, 40), 408: (155, 102),
    416: (25, 52), 424: (51, 106), 432: (47, 72), 440: (91, 110), 448: (29, 168),
    456: (29, 114), 464: (247, 58), 472: (29, 118), 480: (89, 180), 488: (91, 122),
    496: (157, 62), 504: (55, 84), 512: (31, 64), 528: (17, 66), 544: (35, 68),
    560: (227, 420), 576: (65, 96), 592: (19, 74), 608: (37, 76), 624: (41, 234),
    640: (39, 80), 656: (185, 82), 672: (43, 252), 688: (21, 86), 704: (155, 44),
    720: (79, 120), 736: (139, 92), 752: (23, 94), 768: (217, 48), 784: (25, 98),
    800: (17, 80), 816: (127, 102), 832: (25, 52), 848: (239, 106), 864: (17, 48),
    880: (137, 110), 896: (215, 112), 912: (29, 114), 928: (15, 58), 944: (147, 118),
    960: (29, 60), 976: (59, 122), 992: (65, 124), 1008: (55, 84), 1024: (31, 64),
    1056: (17, 66), 1088: (171, 204), 1120: (67, 140), 1152: (35, 72), 1184: (19, 74),
    1216: (39, 76), 1248: (19, 78), 1280: (199, 240), 1312: (21, 82), 1344: (211, 252),
    1376: (21, 86), 1408: (43, 88), 1440: (149, 60), 1472: (45, 92), 1504: (49, 846),
    1536: (71, 48), 1568: (13, 28), 1600: (17, 80), 1632: (25, 102), 1664: (183, 104),
    1696: (55, 954), 1728: (127, 96), 1760: (27, 110), 1792: (29, 112), 1824: (29, 114),
    1856: (57, 116), 1888: (45, 354), 1920: (31, 120), 1952: (59, 610), 1984: (185, 124),
    2016: (113, 420), 2048: (31, 64), 2112: (17, 66), 2176: (171, 136), 2240: (209, 420),
    2304: (253, 216), 2368: (367, 444), 2432: (265, 456), 2496: (181, 468),
    2560: (39, 80), 2624: (27, 164), 2688: (127, 504), 2752: (143, 172), 2816: (43, 88),
    2880: (29, 300), 2944: (45, 92), 3008: (157, 188), 3072: (47, 96), 3136: (13, 28),
    3200: (111, 240), 3264: (443, 204), 3328: (51, 104), 3392: (51, 212),
    3456: (451, 192), 3520: (257, 220), 3584: (57, 336), 3648: (313, 228),
    3712: (271, 232), 3776: (179, 236), 3840: (331, 120), 3904: (363, 244),
    3968: (375, 248), 4032: (127, 168), 4096: (31, 64), 4160: (33, 130), 4224: (43, 264),
    4288: (33, 134), 4352: (477, 408), 4416: (35, 138), 4480: (233, 280),
    4544: (357, 142), 4608: (337, 480), 4672: (37, 146), 4736: (71, 444),
    4800: (71, 120), 4864: (37, 152), 4928: (39, 462), 4992: (127, 234),
    5056: (39, 158), 5120: (39, 80), 5184: (31, 96), 5248: (113, 902), 5312: (41, 166),
    5376: (251, 336), 5440: (43, 170), 5504: (21, 86), 5568: (43, 174), 5632: (45, 176),
    5696: (45, 178), 5760: (161, 120), 5824: (89, 182), 5888: (323, 184),
    5952: (47, 186), 6016: (23, 94), 6080: (47, 190), 6144: (263, 480),
}


# -- CRC and segmentation -------------------------------------------------------

@functools.lru_cache(maxsize=8)
def crc_matrix(n: int, poly: int, L: int = L_CRC) -> np.ndarray:
    """(n, L) 0/1: row i the remainder of x^(n−1−i) · x^L mod g, MSB first."""
    rem, r, top = np.empty(n, np.int64), poly & ((1 << L) - 1), 1 << L
    for j in range(n):              # rem[j] = x^(L+j) mod g
        rem[j] = r
        r <<= 1
        if r & top:
            r ^= poly
    rows = rem[::-1]
    return ((rows[:, None] >> np.arange(L - 1, -1, -1)) & 1).astype(np.float64)


def crc(bits: torch.Tensor, poly: int, L: int = L_CRC) -> torch.Tensor:
    """CRC of each row of 0/1 bits (..., n) -> (..., L) int64."""
    M = torch.as_tensor(crc_matrix(bits.shape[-1], poly, L), device=bits.device)
    return (bits.to(torch.float64) @ M).remainder(2).to(torch.int64)


def segmentation(B: int) -> dict:
    """TS 36.212 §5.1.2 for B bits (CRC-24A included): C, each block's K,
    the fillers F, and whether each block carries CRC-24B."""
    if B <= Z:
        C, Bp = 1, B
    else:
        C = -(-B // (Z - L_CRC))
        Bp = B + C * L_CRC
    ks = sorted(QPP)
    k_plus = min(k for k in ks if C * k >= Bp)
    if C == 1:
        c_minus, k_minus = 0, 0
    else:
        k_minus = max(k for k in ks if k < k_plus)
        c_minus = (C * k_plus - Bp) // (k_plus - k_minus)
    sizes = [k_minus] * c_minus + [k_plus] * (C - c_minus)
    return {"C": C, "sizes": sizes, "F": sum(sizes) - Bp, "segmented": C > 1}


def code_blocks(tb: torch.Tensor, seg: dict) -> list:
    """tb (lanes, B) 0/1 with CRC-24A -> [(lanes, K_r) int64] of the blocks:
    F zero fillers at the start of block 0, bits in order, CRC-24B each."""
    lanes, out, pos = tb.shape[0], [], 0
    for r, K in enumerate(seg["sizes"]):
        body = K - (L_CRC if seg["segmented"] else 0)
        fill = seg["F"] if r == 0 else 0
        blk = torch.cat([tb.new_zeros(lanes, fill), tb[:, pos:pos + body - fill]], dim=1)
        pos += body - fill
        if seg["segmented"]:
            blk = torch.cat([blk, crc(blk, CRC24B)], dim=1)
        out.append(blk)
    return out


# -- the turbo code ---------------------------------------------------------------

def qpp(K: int) -> np.ndarray:
    f1, f2 = QPP[K]
    i = np.arange(K, dtype=np.int64)
    return (f1 * i + f2 * i * i) % K


def rsc(c: np.ndarray):
    """One RSC encoder over blocks c (n, K) 0/1: (a, z) each (n, K + 3), a
    the feedback bits (what the simulator sends as systematic) and z the
    parity, three tail steps of zero feedback at the end. The recursion
    runs bit-sliced: eight blocks a byte, so each step is a few XORs of
    one packed row."""
    n, K = c.shape
    rows = np.ascontiguousarray(np.packbits(c.astype(np.uint8), axis=0).T)   # (K, ⌈n/8⌉)
    a = np.zeros((K + 3, rows.shape[1]), np.uint8)
    z = np.zeros_like(a)
    s0 = np.zeros(rows.shape[1], np.uint8)      # a_{k-1}
    s1 = np.zeros_like(s0)                      # a_{k-2}
    s2 = np.zeros_like(s0)                      # a_{k-3}
    for k in range(K + 3):
        fb = rows[k] ^ s1 ^ s2 if k < K else np.zeros_like(s0)
        a[k] = fb
        z[k] = fb ^ s0 ^ s2
        s0, s1, s2 = fb, s0, s1
    return (np.unpackbits(a.T, axis=0, count=n), np.unpackbits(z.T, axis=0, count=n))


def turbo_encode(c: torch.Tensor) -> torch.Tensor:
    """Blocks (n, K) 0/1 -> (n, 3K + 12) uint8 in the simulator's layout, on
    the blocks' device (the two recursions on the host)."""
    n, K = c.shape
    perm = torch.as_tensor(qpp(K), device=c.device)
    host = c.to(torch.uint8).cpu()
    a1, z1, a2, z2 = (torch.as_tensor(x, device=c.device)
                      for blocks in (host, host[:, perm.cpu()]) for x in rsc(blocks.numpy()))
    body = torch.stack([a1[:, :K], z1[:, :K], z2[:, :K]], dim=-1).reshape(n, 3 * K)
    return torch.cat([body, a1[:, K:], z1[:, K:], a2[:, K:], z2[:, K:]], dim=1)


@functools.lru_cache(maxsize=8)
def circular_buffer(K: int) -> np.ndarray:
    """The encoder-output index (3K + 12) at each circular-buffer position,
    −1 where the position is empty."""
    n3 = np.arange(K)
    d0 = np.concatenate([3 * n3, 3 * K + np.arange(3), 3 * K + 6 + np.arange(3)])
    d1 = np.concatenate([3 * n3 + 1, 3 * K + 3 + np.arange(3)])
    d2 = np.concatenate([3 * n3 + 2, 3 * K + 9 + np.arange(3)])
    width = K + 6
    buf = np.full(3 * width, -1, np.int64)
    for j, d in enumerate((d0, d1, d2)):
        rows = -(-len(d) // 32)
        order = [col * rows + r for r in range(rows) for col in SUBBLOCK_P]
        v = d[[i for i in order if i < len(d)]]
        buf[j:j + 3 * len(v):3] = v
    return buf


def rv_positions(K: int, E: int, rv: int) -> np.ndarray:
    """The circular-buffer positions of the E bits sent at rv."""
    n_cb = 3 * (K + 6)
    return (n_cb * rv // 4 + np.arange(E)) % n_cb


def rate_match(enc: torch.Tensor, K: int, E: int, rv: int) -> torch.Tensor:
    """Encoder outputs (n, 3K + 12) -> the E bits sent at rv (n, E), an
    empty position a 0 bit."""
    src = torch.as_tensor(circular_buffer(K)[rv_positions(K, E, rv)], device=enc.device)
    padded = torch.cat([enc, enc.new_zeros(enc.shape[0], 1)], dim=1)
    return padded[:, torch.where(src < 0, 3 * K + 12, src)]


def rate_dematch(llr: torch.Tensor, K: int, rv: int) -> torch.Tensor:
    """LLRs (n, E) of rv -> (n, 3K + 12) in encoder order, a repeat summed,
    a bit not sent 0."""
    E = llr.shape[-1]
    buf = torch.as_tensor(circular_buffer(K), device=llr.device)
    pos = torch.as_tensor(rv_positions(K, E, rv), device=llr.device)
    src = buf[pos]
    out = llr.new_zeros(llr.shape[0], 3 * K + 12)
    sent = src >= 0
    out.index_add_(1, src[sent], llr[:, sent])
    return out


# -- the max-log BCJR -----------------------------------------------------------------
# State s = (s0 s1 s2) = 4·a_{k-1} + 2·a_{k-2} + a_{k-3}; input c, feedback
# a = c ⊕ s1 ⊕ s2, systematic a, parity a ⊕ s0 ⊕ s2, next state 4a + (s >> 1).
# The 16 edges of a step are laid out (f, m, x): from state p = 2m + x with
# feedback f into state 4f + m, input c = f ⊕ (m & 1) ⊕ x.

def _edge_signs():
    f, m, x = (a.ravel() for a in np.meshgrid(np.arange(2), np.arange(4), np.arange(2),
                                               indexing="ij"))
    par = f ^ (m >> 1) ^ x
    c = f ^ (m & 1) ^ x
    return 1.0 - 2.0 * f, 1.0 - 2.0 * par, 1.0 - 2.0 * c, c


SYS_SIGN, PAR_SIGN, IN_SIGN, EDGE_INPUT = _edge_signs()
SIGNS = np.stack([SYS_SIGN, PAR_SIGN, IN_SIGN])


def _alpha_step(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """α_{k+1}[4f + m] = max_x α_k[2m + x] + γ[f, m, x]; v (..., 8), g (..., 16)."""
    return (v.unflatten(-1, (1, 4, 2)) + g.unflatten(-1, (2, 4, 2))).amax(-1).flatten(-2)


def _beta_step(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """β_k[2m + x] = max_f β_{k+1}[4f + m] + γ[f, m, x]."""
    return (v.unflatten(-1, (2, 4, 1)) + g.unflatten(-1, (2, 4, 2))).amax(-3).flatten(-2)


def _scan(start: torch.Tensor, g: torch.Tensor, step, chunk: int = CHUNK) -> torch.Tensor:
    """The metric before each step of v_{k+1} = step(v_k, g_k), v_0 = start:
    start (n, 8), g (n, K', 16) -> (n, K', 8). Chunks of `chunk` steps are
    composed into 8×8 max-plus transfer matrices (row i: the walk from
    state i), the boundaries carried across them, then every chunk walked
    from its boundary."""
    n, kp = g.shape[:2]
    C = -(-kp // chunk)
    gp = g.new_zeros(n, C * chunk, 16)
    gp[:, :kp] = g
    gp = gp.view(n, C, chunk, 16)
    eye = torch.full((8, 8), -math.inf, dtype=g.dtype, device=g.device)
    eye.fill_diagonal_(0.0)
    T = eye.expand(n, C - 1, 8, 8)
    for j in range(chunk):
        T = step(T, gp[:, :C - 1, j, None, :])
    v = g.new_empty(n, C, 8)
    v[:, 0] = start
    for c in range(C - 1):
        v[:, c + 1] = (v[:, c, :, None] + T[:, c]).amax(1)
    out = g.new_empty(n, C, chunk, 8)
    out[:, :, 0] = v
    for j in range(1, chunk):
        out[:, :, j] = step(out[:, :, j - 1], gp[:, :, j - 1])
    return out.reshape(n, C * chunk, 8)[:, :kp]


def bcjr(l_sys: torch.Tensor, l_par: torch.Tensor, l_apr: torch.Tensor) -> torch.Tensor:
    """Max-log APP LLRs (n, K') of one pass, the trellis started and ended in
    state 0 (LLR > 0: input 0)."""
    sign = torch.as_tensor(SIGNS, dtype=l_sys.dtype, device=l_sys.device)
    g = 0.5 * (l_sys[..., None] * sign[0] + l_par[..., None] * sign[1]
               + l_apr[..., None] * sign[2])
    start = torch.full((g.shape[0], 8), -math.inf, dtype=g.dtype, device=g.device)
    start[:, 0] = 0.0
    alpha = _scan(start, g, _alpha_step)                        # before step k
    beta = _scan(start, g.flip(1), _beta_step).flip(1)          # after step k
    val = (alpha.unflatten(-1, (1, 4, 2)) + g.unflatten(-1, (2, 4, 2))
           + beta.unflatten(-1, (2, 4, 1))).flatten(-3)
    zero = torch.as_tensor(EDGE_INPUT == 0, device=g.device)
    return val[..., zero].amax(-1) - val[..., ~zero].amax(-1)


def turbo_decode(llr: torch.Tensor, K: int, iterations: int) -> torch.Tensor:
    """Encoder-order LLRs (n, 3K + 12) -> hard bits (n, K) int64, computed
    in the LLRs' dtype."""
    n = llr.shape[0]
    perm = torch.as_tensor(qpp(K), device=llr.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(K, device=llr.device)
    body = llr[:, :3 * K].view(n, K, 3)
    tail = llr[:, 3 * K:]
    sys1 = torch.cat([body[..., 0], tail[:, 0:3]], dim=1)
    par1 = torch.cat([body[..., 1], tail[:, 3:6]], dim=1)
    sys2 = torch.cat([body[..., 0][:, perm], tail[:, 6:9]], dim=1)
    par2 = torch.cat([body[..., 2], tail[:, 9:12]], dim=1)
    zeros3 = llr.new_zeros(n, 3)
    e2 = llr.new_zeros(n, K)
    for _ in range(iterations):
        apr1 = torch.cat([e2[:, inv], zeros3], dim=1)
        e1 = (bcjr(sys1, par1, apr1) - apr1 - sys1)[:, :K]
        apr2 = torch.cat([e1[:, perm], zeros3], dim=1)
        e2 = (bcjr(sys2, par2, apr2) - apr2 - sys2)[:, :K]
    apr1 = torch.cat([e2[:, inv], zeros3], dim=1)
    return (bcjr(sys1, par1, apr1)[:, :K] < 0).to(torch.int64)


# -- the link -----------------------------------------------------------------------

def _modulate(bits: torch.Tensor, num) -> torch.Tensor:
    """0/1 (lanes, n·bps) -> complex128 symbols (lanes, n), MSB first."""
    lanes = bits.shape[0]
    b = bits.reshape(lanes, -1, num.bps).to(torch.int64)
    idx = (b * 2 ** torch.arange(num.bps - 1, -1, -1, device=bits.device)).sum(-1)
    levels, norm = num.levels()
    lv = torch.as_tensor(levels, device=bits.device)
    L = len(levels)
    return torch.complex(lv[idx // L], lv[idx % L]) / norm


def _llrs(z: torch.Tensor, var: torch.Tensor, num) -> torch.Tensor:
    """Max-log LLRs (lanes, n·bps) of symbols z (lanes, n), noise variance
    var (lanes, n): the in-phase axis's bits, then the quadrature's, each
    clipped to ±10."""
    levels, norm = num.levels()
    lv = torch.as_tensor(levels / norm, device=z.device)
    k = num.bps // 2
    q = np.arange(len(levels))
    out = []
    for axis in (z.real, z.imag):
        d2 = (axis[..., None] - lv) ** 2
        for b in range(k):
            one = torch.as_tensor((q >> (k - 1 - b)) & 1 == 1, device=z.device)
            llr = (d2[..., one].amin(-1) - d2[..., ~one].amin(-1)) / (2.0 * var)
            out.append(llr.clamp(-LLR_CLIP, LLR_CLIP))
    return torch.stack(out, dim=-1).reshape(z.shape[0], -1)


class Chain:
    """The sizes and tables of one (numerology, transport-block size). The
    code blocks of one K go through the code as one batch; the K− blocks
    come first, so the groups lie in block order."""

    def __init__(self, cfg: dict, tb_bits: int):
        self.num = _siso().Numerology(cfg)
        if cfg["modulation"] == "QPSK":
            raise ValueError("the simulator's QPSK LLRs are unclipped: not modelled here")
        self.A = int(tb_bits)
        self.seg = segmentation(self.A + L_CRC)
        self.groups = [(K, self.seg["sizes"].count(K)) for K in sorted(set(self.seg["sizes"]))]
        self.coded = sum(n * (3 * K + 12) for K, n in self.groups)
        bps, nd = self.num.bps, self.num.n_data
        self.n_sym = -(-self.coded // bps)
        self.rows = -(-self.n_sym // nd)

    @property
    def samples(self) -> int:
        return self.rows * (self.num.N + self.num.cp)

    def encode(self, bits: torch.Tensor) -> list:
        """Transport blocks (lanes, A) -> each group's turbo output,
        [(lanes, n_K, 3K + 12) uint8] on the bits' device."""
        tb = torch.cat([bits.to(torch.int64), crc(bits, CRC24A)], dim=1)
        blocks = code_blocks(tb, self.seg)
        out, r = [], 0
        for K, n in self.groups:
            c = torch.stack(blocks[r:r + n], dim=1)             # (lanes, n, K)
            out.append(turbo_encode(c.reshape(-1, K)).reshape(c.shape[0], n, -1))
            r += n
        return out

    def rate_match(self, enc: list, rv: int) -> torch.Tensor:
        """Every block's E bits at rv, laid end to end: (lanes, coded)."""
        return torch.cat([rate_match(e.reshape(-1, e.shape[-1]), K, 3 * K + 12, rv)
                          .reshape(e.shape[0], -1) for e, (K, _) in zip(enc, self.groups)], dim=1)

    def transmit(self, coded: torch.Tensor) -> torch.Tensor:
        """Coded bits (lanes, coded) -> time samples (lanes, rows·(N+cp))."""
        num, lanes, nd = self.num, coded.shape[0], self.num.n_data
        pad = self.n_sym * num.bps - self.coded
        syms = _modulate(torch.nn.functional.pad(coded, (0, pad)), num)
        syms = torch.nn.functional.pad(syms, (0, self.rows * nd - self.n_sym))
        data = syms.view(lanes, self.rows, nd).transpose(1, 2).reshape(lanes, self.rows, nd)
        dev = coded.device
        grid = torch.zeros(lanes, self.rows, num.N, dtype=torch.complex128, device=dev)
        grid[..., torch.as_tensor(num.data_idx, device=dev)] = data
        grid[..., torch.as_tensor(num.pilot_idx, device=dev)] = torch.as_tensor(num.pilots,
                                                                                 device=dev)
        t = torch.fft.ifft(grid, dim=-1, norm="ortho")
        return torch.cat([t[..., num.N - num.cp:], t], dim=-1).reshape(lanes, -1)

    def receive(self, y: torch.Tensor, snr_db: torch.Tensor) -> torch.Tensor:
        """Received samples (lanes, samples) -> LLRs (lanes, coded)."""
        num, lanes, nd, dev = self.num, y.shape[0], self.num.n_data, y.device
        spec = torch.fft.fft(y.view(lanes, self.rows, -1)[..., num.cp:], dim=-1, norm="ortho")
        y_data = spec[..., torch.as_tensor(num.data_idx, device=dev)]
        y_pil = spec[:, ::SLOT][..., torch.as_tensor(num.pilot_idx, device=dev)]
        h_pil = y_pil * torch.as_tensor(num.pilots, device=dev).conj()
        w = torch.as_tensor(num.w, device=dev)
        h = ((1.0 - w) * h_pil[..., torch.as_tensor(num.left_i, device=dev)]
             + w * h_pil[..., torch.as_tensor(num.right_i, device=dev)])
        h = h[:, torch.arange(self.rows, device=dev) // SLOT]
        z = y_data / (h + EPS_ZF)

        def deinterleave(x):
            return x.reshape(lanes, nd, self.rows).transpose(1, 2).reshape(lanes, -1)[
                :, :self.n_sym]
        z, h = deinterleave(z), deinterleave(h)
        s2 = (10.0 ** (-snr_db / 10.0))[:, None]
        var = torch.maximum(s2 / (h.abs() ** 2).clamp(1e-6, 1e6), s2 / 4.0)
        return _llrs(z, var, num)[:, :self.coded]

    def dematch(self, llr: torch.Tensor, rv: int) -> list:
        """LLRs (lanes, coded) -> each group's (lanes, n_K, 3K + 12)."""
        out, off, lanes = [], 0, llr.shape[0]
        for K, n in self.groups:
            E = 3 * K + 12
            part = llr[:, off:off + n * E].reshape(lanes * n, E)
            out.append(rate_dematch(part, K, rv).view(lanes, n, -1))
            off += n * E
        return out

    def decode(self, acc: list, iterations: int) -> torch.Tensor:
        """Each group's combined LLRs -> the decoded transport block (lanes, B):
        each block's bits without its CRC-24B, the fillers dropped."""
        blocks = []
        for llr, (K, n) in zip(acc, self.groups):
            bits = turbo_decode(llr.reshape(-1, llr.shape[-1]), K, iterations)
            blocks += list(bits.view(llr.shape[0], n, K).unbind(1))
        body = [K - (L_CRC if self.seg["segmented"] else 0) for K in self.seg["sizes"]]
        return torch.cat([b[:, (self.seg["F"] if r == 0 else 0):body[r]]
                          for r, b in enumerate(blocks)], dim=1)


def harq_lanes(cfg: dict, traffic: dict, snr_db, arrays: dict, frames: int,
               decoder_dtype=torch.float64) -> dict:
    """Each lane's HARQ outcome for the inputs `arrays`: bits (S, frames, A)
    and the noise (T, S·frames, samples) re and im, the lanes point-major:
    {"fail": (lanes, T) 1 where not passed by stage t, "ntx": (lanes,),
    "errs": (lanes,)} int64 and {"papr_db": (lanes,)} float64 of the first
    transmission, on the inputs' device. Lanes go in blocks of LANE_BLOCK;
    a lane is decoded up to its first CRC pass. `decoder_dtype` is the
    dtype of the soft combining and the decoder (a lower one makes a
    control)."""
    chain = Chain(cfg, int(traffic["tb_bits"]))
    rvs = [int(v) for v in traffic["rv_sequence"]]
    iters = int(traffic["num_iterations"])
    if traffic.get("channel_type", "awgn") != "awgn":
        raise ValueError("the coded reference models AWGN alone")
    bits_all = arrays["bits"].reshape(-1, chain.A)
    lanes, T, dev = bits_all.shape[0], len(rvs), bits_all.device
    snr_all = torch.as_tensor(np.repeat(np.asarray(snr_db, np.float32).astype(np.float64),
                                        frames), device=dev)
    fail = torch.ones(lanes, T, dtype=torch.int64, device=dev)
    ntx = torch.full((lanes,), T, dtype=torch.int64, device=dev)
    errs = torch.zeros(lanes, dtype=torch.int64, device=dev)
    papr = torch.zeros(lanes, dtype=torch.float64, device=dev)
    for a in range(0, lanes, LANE_BLOCK):
        sl = torch.arange(a, min(a + LANE_BLOCK, lanes), device=dev)
        bits, snr = bits_all[sl].to(torch.int64), snr_all[sl]
        enc = chain.encode(bits)
        acc, live = None, torch.arange(len(sl), device=dev)     # lanes not yet passed
        for t, rv in enumerate(rvs):
            x = chain.transmit(chain.rate_match(enc, rv)[live])
            power = x.abs() ** 2
            p = power.mean(-1, keepdim=True)
            if t == 0:
                papr[sl] = 10.0 * torch.log10(power.max(-1).values / p[:, 0])
            std = torch.sqrt(p / (10.0 ** (snr[live] / 10.0))[:, None] / 2.0)
            noise = torch.complex(arrays["noise_re"][t][sl[live]].double(),
                                  arrays["noise_im"][t][sl[live]].double())
            dem = [d.to(decoder_dtype)
                   for d in chain.dematch(chain.receive(x + std * noise, snr[live]), rv)]
            acc = dem if acc is None else [c[live_keep] + d for c, d in zip(acc, dem)]
            tb = chain.decode(acc, iters)
            ok = (crc(tb[:, :chain.A], CRC24A) == tb[:, chain.A:]).all(-1)
            lane = sl[live]
            done = ok | (t == T - 1)
            fail[lane[ok], t:] = 0
            ntx[lane[done]] = t + 1
            errs[lane[done]] = (tb[done, :chain.A] != bits[live[done]]).sum(-1)
            live_keep = torch.nonzero(~done).flatten()
            live = live[live_keep]
            if live.numel() == 0:
                break
    return {"fail": fail, "ntx": ntx, "errs": errs, "papr_db": papr}


def sizes(cfg: dict, traffic: dict) -> dict:
    """The sizes of one call's draws and of the decoder's work: OFDM symbols
    and samples a transmission, the code blocks' K."""
    chain = Chain(cfg, int(traffic["tb_bits"]))
    return {"symbols": chain.rows, "samples": chain.samples, "n_fft": chain.num.N,
            "cp": chain.num.cp, "n_data": chain.num.n_data, "n_pilot": chain.num.n_pilot,
            "block_sizes": list(chain.seg["sizes"]), "coded_bits": chain.coded}
