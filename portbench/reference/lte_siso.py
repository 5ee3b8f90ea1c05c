"""The plain reference of the SISO LTE link's BER sweep, in float64.

Written from the numerology and the link's published semantics, with its
own tables (grid, CRS, interpolation, constellation, multipath profile);
it imports neither JAX, the JAX package nor the port, and takes nothing
the port made. The DFTs are torch.fft in complex128.

A frame: the traffic's `num_ofdm_symbols` OFDM symbols of N = 2048 bins,
each with the same cyclic prefix of 4.7 µs (144 samples at 20 MHz). In
each symbol the used band is Nc bins centred on DC with DC null, CRS
pilots on every bin k with (k − guard_left) mod 6 = 3, data on the rest
(999 bins at 20 MHz), in every symbol. Data symbols come from the bits,
MSB first, through a square QAM with binary row-major indices (the top
half of a symbol's bits picks the in-phase level), levels ±1, ±3, ... over
√(2(M−1)/3). Pilots are (1+j)/√2 · ±1, the signs from NumPy's MT19937
seeded with the cell id. The time signal is the unitary inverse DFT with
the last cp samples prepended; its PAPR is max|x|²/mean|x|² over the
frame.

Channels. AWGN: noise of variance σ² = P/SNR, P the frame's mean power,
added at the demodulated bins (data bins of every symbol, pilot bins of
each slot's first symbol). Jakes/ITU multipath: y(t) = Σ_i g_i h_i(t)
x(t − d_i) (zero before the frame), d_i = round(τ_i·fs), h_i(t) =
√(2/16) Σ_n exp(j(2π f_D cos(2πn/16) t/fs + φ_in)), n = 1..16, then time-
domain noise against the faded frame's mean power.

Receiver: unitary DFT of each symbol after the CP, LS estimates Y·conj(X)
at the pilots of the first symbol of each slot of 14 symbols, linear interpolation across
frequency (constant beyond the outer pilots), held for the slot, ZF
Y/(Ĥ + 1e-6), hard decision to the nearest level on each axis.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# bandwidth (MHz) -> (used bins Nc, DFT size N), TS 36.211 at 15 kHz
PROFILES = {1.25: (76, 128), 2.5: (150, 256), 5.0: (300, 512), 10.0: (600, 1024),
            15.0: (900, 2048), 20.0: (1200, 2048)}
BITS_PER_SYMBOL = {"QPSK": 2, "16-QAM": 4, "64-QAM": 6}
# ITU-R M.1225: delays (µs), powers (dB), default speed (km/h)
ITU = {"Pedestrian_A": ((0.0, 0.11, 0.19, 0.41), (0.0, -9.7, -19.2, -22.8), 5.0)}
SLOT = 14
SINUSOIDS = 16
EPS_ZF = 1e-6


class Numerology:
    def __init__(self, cfg: dict):
        self.Nc, self.N = PROFILES[float(cfg["bandwidth_mhz"])]
        self.fs = self.N * 15e3
        self.cp = int(4.7e-6 * self.fs)
        self.bps = BITS_PER_SYMBOL[cfg["modulation"]]
        self.modulation = cfg["modulation"]
        self.cell_id = int(cfg.get("cell_id", 0))
        left = (self.N - self.Nc) // 2
        k = np.arange(self.N)
        band = (k >= left) & (k < left + self.Nc) & (k != self.N // 2)
        pilot = band & ((k - left) % 6 == 3)
        self.data_idx = np.nonzero(band & ~pilot)[0]
        self.pilot_idx = np.nonzero(pilot)[0]
        signs = np.random.RandomState(self.cell_id).choice([1, -1], size=len(self.pilot_idx))
        self.pilots = (1 + 1j) / np.sqrt(2) * signs
        # linear interpolation weights of every data bin between its two pilots
        p = self.pilot_idx
        right = np.searchsorted(p, self.data_idx)
        self.left_i = np.clip(right - 1, 0, len(p) - 1)
        self.right_i = np.clip(right, 0, len(p) - 1)
        span = np.maximum(p[self.right_i] - p[self.left_i], 1)
        w = (self.data_idx - p[self.left_i]) / span
        w[right == 0] = 0.0
        w[right - 1 >= len(p) - 1] = 0.0
        self.w = np.clip(w, 0.0, 1.0)

    @property
    def n_data(self) -> int:
        return len(self.data_idx)

    @property
    def n_pilot(self) -> int:
        return len(self.pilot_idx)

    def levels(self):
        """(levels by axis index, normalisation) of the square QAM."""
        if self.modulation == "QPSK":
            return np.array([1.0, -1.0]), math.sqrt(2.0)
        L = 2 ** (self.bps // 2)
        return np.arange(-(L - 1), L, 2, dtype=np.float64), math.sqrt(2.0 * (L * L - 1) / 3.0)


def multipath_profile(name: str, fs: float, velocity_kmh=None, carrier_hz: float = 2e9):
    """(integer delays, linear gains, Doppler Hz). The gains keep the
    modelled simulator's double dB-to-linear conversion 10^(10^(dB/20)/20)."""
    delays_us, power_db, v_default = ITU[name]
    v = v_default if velocity_kmh is None else float(velocity_kmh)
    delays = [int(round(d * 1e-6 * fs)) for d in delays_us]
    gains = [10.0 ** ((10.0 ** (p / 20.0)) / 20.0) for p in power_db]
    return delays, gains, (v / 3.6) * carrier_hz / 3e8


def _modulate(bits: torch.Tensor, num: Numerology, symbols: int) -> torch.Tensor:
    """bits (B, symbols·n_data·bps) -> complex128 (B, symbols, n_data)."""
    B = bits.shape[0]
    b = bits.reshape(B, -1, num.bps).to(torch.int64)
    weights = 2 ** torch.arange(num.bps - 1, -1, -1, device=bits.device)
    idx = (b * weights).sum(-1)
    levels, norm = num.levels()
    L = len(levels)
    lv = torch.as_tensor(levels, device=bits.device)
    s = torch.complex(lv[idx // L], lv[idx % L]) / norm
    return s.reshape(B, symbols, num.n_data)


def _decide(x: torch.Tensor, num: Numerology) -> torch.Tensor:
    """Nearest level index on one axis (real tensor)."""
    levels, norm = num.levels()
    lv = torch.as_tensor(levels, device=x.device)
    return (x[..., None] * norm - lv).abs().argmin(-1)


def _demap(z: torch.Tensor, num: Numerology) -> torch.Tensor:
    """Hard bits (B, n) of the equalised symbols z (B, symbols, n_data)."""
    L = len(num.levels()[0])
    idx = _decide(z.real, num) * L + _decide(z.imag, num)
    shifts = torch.arange(num.bps - 1, -1, -1, device=z.device)
    bits = (idx[..., None] >> shifts) & 1
    return bits.reshape(z.shape[0], -1)


def _transmit(bits: torch.Tensor, num: Numerology, symbols: int) -> torch.Tensor:
    """Time frames (B, symbols, N+cp) in complex128."""
    B = bits.shape[0]
    grid = torch.zeros(B, symbols, num.N, dtype=torch.complex128, device=bits.device)
    grid[..., torch.as_tensor(num.data_idx, device=bits.device)] = _modulate(bits, num, symbols)
    grid[..., torch.as_tensor(num.pilot_idx, device=bits.device)] = torch.as_tensor(
        num.pilots, device=bits.device)
    t = torch.fft.ifft(grid, dim=-1, norm="ortho")
    return torch.cat([t[..., num.N - num.cp:], t], dim=-1)


def _dft_bins(frames: torch.Tensor, num: Numerology, bins) -> torch.Tensor:
    spec = torch.fft.fft(frames[..., num.cp:], dim=-1, norm="ortho")
    return spec[..., torch.as_tensor(bins, device=frames.device)]


def _multipath(x: torch.Tensor, num: Numerology, phases: torch.Tensor, profile) -> torch.Tensor:
    """x (B, T) complex128 through the Jakes taps of phases (B, taps, 16)."""
    delays, gains, fd = profile
    B, T = x.shape
    n = torch.arange(1, SINUSOIDS + 1, dtype=torch.float64, device=x.device)
    omega = 2.0 * math.pi * fd * torch.cos(2.0 * math.pi * n / SINUSOIDS)     # (16,)
    t = torch.arange(T, dtype=torch.float64, device=x.device) / num.fs
    y = torch.zeros_like(x)
    for i, (d, g) in enumerate(zip(delays, gains)):
        if d >= T:
            continue
        # Σ_n exp(j(ω_n t + φ_in)) = Σ_n e^{jφ_in} e^{jω_n t}
        h = torch.exp(1j * phases[:, i, :].double()) @ torch.exp(1j * omega[:, None] * t[None, :])
        h = h * math.sqrt(2.0 / SINUSOIDS)
        y[:, d:] += g * h[:, d:] * x[:, :T - d]
    return y


def _noise(re, im) -> torch.Tensor:
    return torch.complex(re.double(), im.double())


def sweep(cfg: dict, traffic: dict, snr_db, arrays: dict, frames: int,
          block: int = 32) -> dict:
    """The sweep's per-point results for the global inputs `arrays`
    (lane-leading, point-major; see the harness's input generator):
    {"bit_errors": (S,) int64, "total_bits": (S,) int64, "papr_db": (S,)
    float64, the mean over each point's frames}."""
    num = Numerology(cfg)
    symbols = int(traffic["num_ofdm_symbols"])
    channel = traffic.get("channel_type", "awgn")
    profile = (multipath_profile(traffic["itu_profile"], num.fs, traffic.get("velocity_kmh"))
               if channel == "rayleigh_mp" else None)
    snr = np.asarray(snr_db, np.float32).astype(np.float64)
    S = len(snr)
    bits_all = arrays["bits"]
    lanes = bits_all.shape[0]
    errors = torch.zeros(lanes, dtype=torch.int64, device=bits_all.device)
    papr = torch.zeros(lanes, dtype=torch.float64, device=bits_all.device)
    slot_starts = torch.arange(0, symbols, SLOT, device=bits_all.device)
    for a in range(0, lanes, block):
        sl = slice(a, min(a + block, lanes))
        bits = bits_all[sl]
        B = bits.shape[0]
        snr_lin = torch.as_tensor(10.0 ** (snr[np.arange(a, a + B) // frames] / 10.0),
                                  device=bits.device)
        tx = _transmit(bits, num, symbols)                          # (B, S, N+cp)
        x = tx.reshape(B, -1)
        p = x.abs() ** 2
        papr[sl] = 10.0 * torch.log10(p.max(-1).values / p.mean(-1))
        if channel == "awgn":
            std = torch.sqrt(p.mean(-1) / snr_lin / 2.0)[:, None, None]
            y_data = _dft_bins(tx, num, num.data_idx) + std * _noise(
                arrays["data_re"][sl], arrays["data_im"][sl])
            y_pil = _dft_bins(tx[:, slot_starts], num, num.pilot_idx) + std * _noise(
                arrays["pilot_re"][sl], arrays["pilot_im"][sl])
        elif channel == "rayleigh_mp":
            y = _multipath(x, num, arrays["phases"][sl], profile)
            std = torch.sqrt((y.abs() ** 2).mean(-1) / snr_lin / 2.0)[:, None]
            y = (y + std * _noise(arrays["noise_re"][sl], arrays["noise_im"][sl]))
            y = y.reshape(B, symbols, -1)
            y_data = _dft_bins(y, num, num.data_idx)
            y_pil = _dft_bins(y[:, slot_starts], num, num.pilot_idx)
        else:
            raise ValueError(f"channel {channel!r} has no reference")
        known = torch.as_tensor(num.pilots, device=bits.device)
        h_pil = y_pil * known.conj()                                # (B, slots, n_pilot)
        dev = bits.device
        w = torch.as_tensor(num.w, device=dev)
        h = ((1.0 - w) * h_pil[..., torch.as_tensor(num.left_i, device=dev)]
             + w * h_pil[..., torch.as_tensor(num.right_i, device=dev)])
        h = h[:, torch.arange(symbols, device=dev) // SLOT]           # (B, S, n_data)
        z = y_data / (h + EPS_ZF)
        errors[sl] = (_demap(z, num) != bits.to(torch.int64)).sum(-1)
    n_bits = bits_all.shape[1]
    return {"bit_errors": errors.reshape(S, frames).sum(1).cpu().numpy(),
            "total_bits": np.full(S, n_bits * frames, np.int64),
            "papr_db": papr.reshape(S, frames).mean(1).cpu().numpy()}


def sizes(cfg: dict, traffic: dict) -> dict:
    """The sizes of one frame's inputs: bits, DFT, CP, data and pilot bins,
    and the multipath taps of the traffic's channel (0 over AWGN)."""
    num = Numerology(cfg)
    symbols = int(traffic["num_ofdm_symbols"])
    taps = (len(ITU[traffic["itu_profile"]][0])
            if traffic.get("channel_type", "awgn") == "rayleigh_mp" else 0)
    return {"bits_per_frame": symbols * num.n_data * num.bps, "n_fft": num.N, "cp": num.cp,
            "n_data": num.n_data, "n_pilot": num.n_pilot, "taps": taps}
