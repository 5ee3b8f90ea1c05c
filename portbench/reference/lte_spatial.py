"""The plain reference of the TM4 spatial-multiplexing link's BER sweep
(num_tx × num_rx, rank = num_tx, PMI 0, MMSE-ordered SIC) over Jakes
multipath, in float64.

Written from the numerology and the link's published semantics, with its
own tables (the per-antenna CRS combs and sequences, their interpolation,
the layer map, the detector); it takes the numerology, the QAM, the DFT
and the Jakes multipath of lte_siso, imports neither JAX, the JAX package
nor the port, and takes nothing the port made. The DFTs are torch.fft in
complex128; float32 products are never allowed to run in TF32.

A frame: `num_ofdm_symbols` symbols of N = 2048 bins with a 144-sample
cyclic prefix. Each symbol's nd = 999 data symbols (QAM from the bits,
MSB first) are zero-padded to a multiple of the rank L and mapped
round-robin onto L layers, symbol i·L + l to layer l at position i, so a
layer holds m = ⌈nd / L⌉ symbols; PMI 0 of the rank-L TM4 codebook is the
identity, so layer t is antenna t's, on the first m data bins of the grid
(the other data bins stay empty). Antenna t sends CRS on every step-th bin
of the CRS comb from offset t (step = min(num_tx, 4)), in every symbol,
(1+j)/√2 · ±1 with the signs from MT19937 seeded by t mod 4, and nothing
on the other antennas' pilot bins. The time signal is the unitary inverse
DFT with the CP prepended; the PAPR of a lane is the mean over the
antennas of each antenna's max|x|²/mean|x|² over the frame.

Channel: every (rx, tx) link fades by its own Jakes taps (lte_siso's
multipath, the phases of link (rx, tx, lane) from the draws), and each RX
sums its num_tx links. RX r's noise has variance P_r/SNR, P_r the mean
power of its faded frame; it is added at the demodulated bins: the layer
bins and every CRS bin of every symbol.

Receiver, per symbol: LS estimates Y·conj(X) of link (r, t) at antenna
t's CRS bins, linearly interpolated to the m layer bins (constant beyond
the outer pilots). The detector is MMSE-ordered SIC with σ² =
10^(−SNR/10): the layers are ordered once by the SINR of the estimated
channel's columns, |h_l|² / (Σ_k |h_k|² − |h_l|² + σ² + 1e-10), strongest
first, the first index on a tie; at each stage an MMSE solve over the
layers still active against the residual, a hard decision (the nearest
constellation point) on the selected layer, and its cancellation from the
residual against the estimated channel. Then the layer demap, the hard
demap and the bit errors.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch


def _load_siso():
    """lte_siso, loaded by path (this file is loaded by path too)."""
    name = "portbench_reference_lte_siso"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, str(Path(__file__).with_name(
        "lte_siso.py")))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


siso = _load_siso()
EPS_SINR = 1e-10


class Layout:
    """The numerology and the antennas' layout: layer bins, CRS combs and
    sequences, and each antenna's interpolation weights to the layer bins."""

    def __init__(self, cfg: dict):
        self.num = num = siso.Numerology(cfg)
        self.num_tx, self.num_rx = int(cfg["num_tx"]), int(cfg["num_rx"])
        self.rank = int(cfg["rank"])
        if self.rank != self.num_tx or int(cfg.get("pmi", 0)) != 0:
            raise ValueError("the reference models PMI 0 at rank = num_tx (the identity "
                             "precoder) alone")
        self.m = -(-num.n_data // self.rank)
        self.layer_bins = num.data_idx[:self.m]
        self.step = min(self.num_tx, 4)
        self.combs, self.pilots, self.interp = [], [], []
        for t in range(self.num_tx):
            comb = num.pilot_idx[t % self.step::self.step]
            signs = np.random.RandomState(t % 4).choice([1, -1], size=len(comb))
            self.combs.append(comb)
            self.pilots.append((1 + 1j) / np.sqrt(2) * signs)
            self.interp.append(_interp_weights(comb, self.layer_bins))


def _interp_weights(pilot_bins: np.ndarray, bins: np.ndarray):
    """(left, right, w) of linear interpolation from the pilots to `bins`:
    H = (1 − w)·Hp[left] + w·Hp[right], constant beyond the outer pilots."""
    p = np.asarray(pilot_bins)
    right = np.searchsorted(p, bins)
    left_i = np.clip(right - 1, 0, len(p) - 1)
    right_i = np.clip(right, 0, len(p) - 1)
    w = (bins - p[left_i]) / np.maximum(p[right_i] - p[left_i], 1)
    w[right == 0] = 0.0
    w[right - 1 >= len(p) - 1] = 0.0
    return left_i, right_i, np.clip(w, 0.0, 1.0)


def transmit(bits: torch.Tensor, lay: Layout, symbols: int):
    """bits (B, n_bits) -> (the layers (B, L, S, m), the antennas' time
    frames (B, tx, S, N+cp)), complex128."""
    num, dev = lay.num, bits.device
    B, L = bits.shape[0], lay.rank
    syms = siso._modulate(bits, num, symbols)                          # (B, S, nd)
    pad = torch.zeros(B, symbols, L * lay.m - num.n_data, dtype=syms.dtype, device=dev)
    layers = torch.cat([syms, pad], dim=-1).reshape(B, symbols, lay.m, L)
    layers = layers.permute(0, 3, 1, 2)                                # (B, L, S, m)
    grid = torch.zeros(B, lay.num_tx, symbols, num.N, dtype=torch.complex128, device=dev)
    grid[..., torch.as_tensor(lay.layer_bins, device=dev)] = layers    # identity precoder
    for t in range(lay.num_tx):
        grid[:, t, :, torch.as_tensor(lay.combs[t], device=dev)] = torch.as_tensor(
            lay.pilots[t], device=dev)
    x = torch.fft.ifft(grid, dim=-1, norm="ortho")
    return layers, torch.cat([x[..., num.N - num.cp:], x], dim=-1)


def papr_db(frames: torch.Tensor) -> torch.Tensor:
    """(B, tx, S, N+cp) -> (B,): the mean over the antennas of each one's
    frame PAPR."""
    p = frames.reshape(frames.shape[0], frames.shape[1], -1).abs() ** 2
    return (10.0 * torch.log10(p.amax(-1) / p.mean(-1))).mean(-1)


def channel(frames: torch.Tensor, phases: torch.Tensor, lay: Layout, profile) -> torch.Tensor:
    """The noiseless received streams (B, rx, S·(N+cp)): RX r sums its links'
    fadings, link (r, t) by the Jakes taps of phases (rx, tx, B, taps, 16)."""
    B = frames.shape[0]
    x = frames.reshape(B, lay.num_tx, -1)
    y = []
    for r in range(lay.num_rx):
        y.append(sum(siso._multipath(x[:, t], lay.num, phases[r, t], profile)
                     for t in range(lay.num_tx)))
    return torch.stack(y, dim=1)


def receive(y: torch.Tensor, lay: Layout, symbols: int, snr_lin: torch.Tensor, noise) -> tuple:
    """The layer bins (B, rx, S, m) and CRS bins (B, rx, S, n_pilot) of the
    received streams y (B, rx, T), each RX's noise of variance P_r/SNR
    added there; `noise` ((data_re, data_im), (pilot_re, pilot_im)) the
    standard normals, (B, rx, S, bins) each."""
    B = y.shape[0]
    std = torch.sqrt((y.abs() ** 2).mean(-1) / snr_lin[:, None] / 2.0)[..., None, None]
    frames = y.reshape(B, lay.num_rx, symbols, -1)
    (dre, dim), (pre, pim) = noise
    y_data = siso._dft_bins(frames, lay.num, lay.layer_bins) + std * siso._noise(dre, dim)
    y_pil = siso._dft_bins(frames, lay.num, lay.num.pilot_idx) + std * siso._noise(pre, pim)
    return y_data, y_pil


def estimate(y_pil: torch.Tensor, lay: Layout) -> torch.Tensor:
    """LS at each antenna's CRS, interpolated to the layer bins:
    (B, rx, S, n_pilot) -> H (B, S, m, rx, tx)."""
    dev = y_pil.device
    h = []
    for t in range(lay.num_tx):
        hp = y_pil[..., t % lay.step::lay.step] * torch.as_tensor(lay.pilots[t], device=dev).conj()
        left, right, w = (torch.as_tensor(a, device=dev) for a in lay.interp[t])
        h.append((1.0 - w) * hp[..., left] + w * hp[..., right])      # (B, rx, S, m)
    return torch.stack(h, dim=-1).permute(0, 2, 3, 1, 4)


def hard(z: torch.Tensor, num) -> torch.Tensor:
    """The nearest constellation point of each of z's symbols."""
    levels, norm = num.levels()
    lv = torch.as_tensor(levels, device=z.device) / norm
    return torch.complex(lv[siso._decide(z.real, num)], lv[siso._decide(z.imag, num)])


def sic(y: torch.Tensor, H: torch.Tensor, sigma2: torch.Tensor, num) -> torch.Tensor:
    """MMSE-ordered SIC: y (..., rx), H (..., rx, L), σ² broadcast against
    the batch -> the hard decisions (..., L)."""
    L = H.shape[-1]
    s2 = sigma2[..., None]
    col = (H.abs() ** 2).sum(-2)                                     # (..., L)
    sinr = col / (col.sum(-1, keepdim=True) - col + s2 + EPS_SINR)
    order = torch.argsort(-sinr, dim=-1, stable=True)
    eye = torch.eye(L, dtype=H.dtype, device=H.device)
    active = torch.ones(col.shape, dtype=torch.float64, device=H.device)
    s_hat = torch.zeros(col.shape, dtype=H.dtype, device=H.device)
    res = y
    for k in range(L):
        sel = order[..., k:k + 1]                                    # (..., 1)
        Ha = H * active[..., None, :]
        G = Ha.mH @ Ha + eye * (s2[..., None] + (1.0 - active[..., None, :]))
        s = torch.linalg.solve(G, (Ha.mH @ res[..., None])[..., 0])
        s_sel = hard(torch.gather(s, -1, sel), num)                  # (..., 1)
        s_hat = s_hat.scatter(-1, sel, s_sel)
        h_sel = torch.gather(H, -1, sel[..., None, :].expand(H.shape[:-1] + (1,)))[..., 0]
        res = res - h_sel * s_sel
        active = active.scatter(-1, sel, 0.0)
    return s_hat


def lanes(cfg: dict, traffic: dict, snr_db_lanes, arrays: dict, sl: slice) -> dict:
    """The link's pieces for the lanes `sl` of the global inputs `arrays`
    (see the harness's spatial adapter) at the lanes' SNRs: the layers, the
    estimates, the decisions, the bit errors and the PAPR of each lane."""
    lay = Layout(cfg)
    num, symbols = lay.num, int(traffic["num_ofdm_symbols"])
    profile = siso.multipath_profile(traffic["itu_profile"], num.fs, traffic.get("velocity_kmh"))
    bits = arrays["bits"][sl]
    dev, B, lanes_all = bits.device, bits.shape[0], arrays["bits"].shape[0]
    snr = torch.as_tensor(np.asarray(snr_db_lanes, np.float32).astype(np.float64)[sl],
                          device=dev)
    layers, frames = transmit(bits, lay, symbols)
    phases = arrays["phases"].reshape(lay.num_rx, lay.num_tx, lanes_all, -1,
                                      siso.SINUSOIDS)[:, :, sl]
    y = channel(frames, phases, lay, profile)

    def per_rx(name):                                   # (rx, lanes, S, k) -> (B, rx, S, k)
        return arrays[name][:, sl].transpose(0, 1)
    y_data, y_pil = receive(y, lay, symbols, 10.0 ** (snr / 10.0),
                            ((per_rx("data_re"), per_rx("data_im")),
                             (per_rx("pilot_re"), per_rx("pilot_im"))))
    H = estimate(y_pil, lay)                                            # (B, S, m, rx, tx)
    sigma2 = (10.0 ** (-snr / 10.0))[:, None, None]
    s_hat = sic(y_data.permute(0, 2, 3, 1), H, sigma2, num)             # (B, S, m, L)
    syms = s_hat.reshape(B, symbols, -1)[..., :num.n_data]
    errors = (siso._demap(syms, num) != bits.to(torch.int64)).sum(-1)
    return {"layers": layers, "H": H, "decisions": s_hat, "errors": errors,
            "papr_db": papr_db(frames)}


def sweep(cfg: dict, traffic: dict, snr_db, arrays: dict, frames: int,
          block: int = 32) -> dict:
    """The sweep's per-point results for the global inputs `arrays`
    (lanes point-major): {"bit_errors": (S,) int64, "total_bits": (S,)
    int64, "papr_db": (S,) float64, the mean over each point's frames}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    snr = np.repeat(np.asarray(snr_db, np.float32), frames)
    n_lanes, n_bits = arrays["bits"].shape
    errors = np.zeros(n_lanes, np.int64)
    papr = np.zeros(n_lanes, np.float64)
    for a in range(0, n_lanes, block):
        sl = slice(a, min(a + block, n_lanes))
        out = lanes(cfg, traffic, snr, arrays, sl)
        errors[sl] = out["errors"].cpu().numpy()
        papr[sl] = out["papr_db"].cpu().numpy()
        del out
    S = len(snr_db)
    return {"bit_errors": errors.reshape(S, frames).sum(1),
            "total_bits": np.full(S, n_bits * frames, np.int64),
            "papr_db": papr.reshape(S, frames).mean(1)}


def sizes(cfg: dict, traffic: dict) -> dict:
    """The sizes of one frame's inputs: bits, DFT, CP, data bins a symbol,
    layer bins, CRS bins, multipath taps and the antennas."""
    lay = Layout(cfg)
    num, symbols = lay.num, int(traffic["num_ofdm_symbols"])
    return {"bits_per_frame": symbols * num.n_data * num.bps, "n_fft": num.N, "cp": num.cp,
            "n_data": num.n_data, "m": lay.m, "n_pilot": num.n_pilot,
            "taps": len(siso.ITU[traffic["itu_profile"]][0]), "num_tx": lay.num_tx,
            "num_rx": lay.num_rx, "rank": lay.rank}

