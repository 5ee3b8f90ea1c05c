"""SISO OFDM simulation: the 20 MHz AWGN link with CRS estimation and ZF.

Port of the main branch of ofdm_lte_tpu/sim/siso.py — mode "lte",
channel_type "awgn", enable_equalization=True:

    bits -> QAM -> grid scatter + IDFT + CP (one complex GEMM) -> PAPR
         -> DFT to the data bins and the slot-start pilot bins (two GEMMs)
         -> CN noise at the bins -> LS + interpolation + slot hold -> ZF
         -> hard demap -> bit errors

The noise is injected at the demodulated bins, as in the JAX package: the
modem's DFT is unitary and the receiver discards the CP samples and the
guard/DC bins, so time-domain CN(0, σ²) noise reaches the detector only as
i.i.d. CN(0, σ²) at those bins.

`SisoLink` is an nn.Module holding one configuration's constant tables as
buffers; `simulate_siso` is the functional form. Leading axes of `bits`
are independent Monte-Carlo lanes. The other branches of the JAX
package's simulate_siso raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..cplx import C
from ..config import LTEConfig
from ..device import resolve_device
from ..grid import grid_for, interp_table, pilot_sequence
from ..ops import ofdm, qam
from ..ops.ofdm import DemodTables, ModTables
from ..rx import estimation as est


class SisoResult(NamedTuple):
    bits_rx: torch.Tensor        # (..., n_bits), the caller's bit dtype
    bit_errors: torch.Tensor     # (...,)
    ber: torch.Tensor            # (...,)
    papr_db: torch.Tensor        # (...,)
    pilot_snr_db: torch.Tensor   # (...,)
    symbols_rx: C                # (..., S, n_data) equalized data symbols
    signal_tx: C                 # (..., S·(N+cp))


class RxTables(NamedTuple):
    """Device tables of the equalized receiver."""
    data: DemodTables            # DFT to the data bins
    pilot: DemodTables           # DFT to the pilot bins
    known: C                     # CRS pilot sequence
    interp: tuple                # (left, right, w) at the data bins


def _check_branch(mode: str, channel_type: str, enable_equalization: bool) -> None:
    if mode != "lte":
        raise NotImplementedError(f"simulate_siso mode={mode!r}: ROADMAP item A9")
    if not enable_equalization:
        raise NotImplementedError("simulate_siso enable_equalization=False: ROADMAP item A9")
    if channel_type == "fading":
        raise NotImplementedError("simulate_siso channel_type='fading': ROADMAP item A9")
    if channel_type == "rayleigh_mp":
        raise NotImplementedError("simulate_siso channel_type='rayleigh_mp': ROADMAP item A10")
    if channel_type != "awgn":
        raise ValueError(f"unknown channel_type {channel_type}")


def bits_per_frame(config: LTEConfig, num_ofdm_symbols: int, mode: str = "lte") -> int:
    n_data = grid_for(config).num_data if mode in ("lte", "sc-fdm") else config.Nc
    return num_ofdm_symbols * n_data * config.bits_per_symbol


def num_symbols_for_bits(config: LTEConfig, n_bits: int, mode: str = "lte") -> int:
    per = bits_per_frame(config, 1, mode)
    return int(np.ceil(n_bits / per))


def pad_bits(bits: np.ndarray, config: LTEConfig, mode: str = "lte") -> np.ndarray:
    """Zero-pad a bit array to a whole number of OFDM symbols."""
    per = bits_per_frame(config, 1, mode)
    S = int(np.ceil(len(bits) / per))
    out = np.zeros(S * per, dtype=np.int32)
    out[:len(bits)] = bits
    return out


def transmit(bits: torch.Tensor, config: LTEConfig, mode: str = "lte",
             cell_id: int = 0, tables: Optional[ModTables] = None) -> C:
    """bits (..., S·n_data·bps) -> CP-prefixed sample stream (..., S·(N+cp))."""
    if mode != "lte":
        raise NotImplementedError(f"transmit mode={mode!r}: ROADMAP item A9")
    n_data = grid_for(config).num_data
    lead = tuple(bits.shape[:-1])
    S = bits.shape[-1] // (n_data * config.bits_per_symbol)
    syms = qam.modulate(bits, config.modulation).reshape(lead + (S, n_data))
    tx = ofdm.modulate_symbols(syms, config, cell_id, tables)      # (..., S, N+cp)
    return tx.reshape(lead + (S * config.samples_per_ofdm_symbol,))


def _detect_from_bins(y_data: C, y_pil: C, config: LTEConfig, mode: str = "lte",
                      cell_id: int = 0, tables: Optional[RxTables] = None):
    """Equalized back half of the receiver: CRS LS estimation from the
    slot-start pilot bins, slot-periodic interpolation, per-symbol ZF, hard
    demap. Returns (bits, equalized symbols, pilot SNR dB)."""
    if mode != "lte":
        raise NotImplementedError(f"_detect_from_bins mode={mode!r}: ROADMAP item A9")
    g = grid_for(config)
    known = tables.known if tables is not None else None
    interp = tables.interp if tables is not None else None
    S = y_data.shape[-2]
    h_pil = est.ls_at_pilots(y_pil, cell_id, known)                # (..., n_slots, n_pil)
    psnr = est.pilot_snr_db(y_pil, cell_id, axis=(-2, -1), known=known)
    h_data_slots = est.interpolate(h_pil, config, out_bins=g.data_idx, table=interp)
    h_data = est.slot_periodic(h_data_slots, S)                    # (..., S, n_data)
    x_eq = est.zf_equalize(y_data, h_data)

    lead = tuple(x_eq.shape[:-2])
    flat = x_eq.reshape(lead + (S * g.num_data,))
    return qam.demodulate(flat, config.modulation), x_eq, psnr


def _snr_linear(snr_db, device):
    """10^(snr/10) in float32: a Python float for a scalar (no host-to-device
    copy on the hot path), else a tensor on `device`."""
    if isinstance(snr_db, torch.Tensor):
        return 10.0 ** (snr_db.to(device=device, dtype=torch.float32) / 10.0)
    snr = np.asarray(snr_db, np.float32)
    if snr.ndim == 0:
        return float(np.float32(10.0) ** (snr / np.float32(10.0)))
    return 10.0 ** (torch.as_tensor(snr, device=device) / 10.0)


def _planar(x, shape, device, what: str) -> C:
    re, im = (torch.as_tensor(v, dtype=torch.float32, device=device) for v in x)
    if tuple(re.shape) != tuple(shape) or tuple(im.shape) != tuple(shape):
        raise ValueError(f"{what} noise planes {tuple(re.shape)}/{tuple(im.shape)}, "
                         f"expected {tuple(shape)}")
    return C(re, im)


def _receive_awgn_freq(signal: C, snr_db, config: LTEConfig, mode: str, measure_axes,
                       cell_id: int = 0, generator: Optional[torch.Generator] = None,
                       noise=None, tables: Optional[RxTables] = None):
    """AWGN receive with the noise injected at the demodulated bins.

    σ² is measured against the mean TX power (per lane when measure_axes is
    -1). `noise=(data_noise, pilot_noise)`, planar pairs of standard normals
    shaped like the data bins (..., S, n_data) and the slot-start pilot bins
    (..., n_slots, n_pil), replaces the generator's draws; the scale stays
    σ/√2 per leg."""
    device = signal.re.device
    snr_lin = _snr_linear(snr_db, device)
    p = signal.abs2()
    sig_power = p.mean() if measure_axes is None else p.mean(dim=measure_axes)
    std = torch.sqrt((sig_power / snr_lin)[..., None, None] / 2.0)

    g = grid_for(config)
    y = ofdm.frame_stream(signal, config)
    y_data = ofdm.demodulate_bins(y, config, g.data_idx,
                                  tables.data if tables is not None else None)
    # slot-start symbols as a strided view: a row gather the GEMM reads in place
    y_slot = y[..., ::est.SLOT_SIZE, :]
    y_pil = ofdm.demodulate_bins(y_slot, config, g.pilot_idx,
                                 tables.pilot if tables is not None else None)

    if noise is None:
        def draw(shape):
            return C(torch.randn(shape, generator=generator, device=device),
                     torch.randn(shape, generator=generator, device=device))
        n_data, n_pil = draw(y_data.shape), draw(y_pil.shape)
    else:
        n_data = _planar(noise[0], y_data.shape, device, "data")
        n_pil = _planar(noise[1], y_pil.shape, device, "pilot")

    def add_cn(x: C, n: C) -> C:
        return C(x.re + n.re * std, x.im + n.im * std)

    return _detect_from_bins(add_cn(y_data, n_data), add_cn(y_pil, n_pil),
                             config, mode, cell_id, tables)


def reference_tables(config: LTEConfig, cell_id: int = 0) -> Dict[str, np.ndarray]:
    """The link's constant tables, by name, from the port's NumPy copies.

    The same names built from the JAX package's functions load into a
    SisoLink through load_reference_tables."""
    g = grid_for(config)
    N, cp = config.N, config.cp_length
    B_re, B_im, pw_re, pw_im = ofdm._mod_consts(N, config.Nc, cp, cell_id)
    Gd_re, Gd_im = ofdm._demod_consts(N, cp, tuple(int(b) for b in g.data_idx))
    Gp_re, Gp_im = ofdm._demod_consts(N, cp, tuple(int(b) for b in g.pilot_idx))
    left, right, w = interp_table(N, config.Nc)
    return {"mod_b_re": B_re, "mod_b_im": B_im,
            "pilot_wave_re": pw_re, "pilot_wave_im": pw_im,
            "demod_data_re": Gd_re, "demod_data_im": Gd_im,
            "demod_pilot_re": Gp_re, "demod_pilot_im": Gp_im,
            "interp_left": left, "interp_right": right, "interp_w": w,
            "pilot_seq": pilot_sequence(cell_id, g.num_pilot)}


class SisoLink(nn.Module):
    """The AWGN/CRS/ZF SISO link for one LTEConfig, its tables as buffers.

    forward(bits, snr_db, generator=None, noise=None) -> SisoResult runs one
    Monte-Carlo step; see _receive_awgn_freq for the noise seam. The tables
    live on `device`: the CUDA card when none is given (resolve_device)."""

    def __init__(self, config: LTEConfig, device=None, cell_id: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.cell_id = cell_id
        for name, arr in self._buffers_from(reference_tables(config, cell_id)).items():
            self.register_buffer(name, torch.tensor(arr, device=device))

    def _buffers_from(self, t: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        data_idx = grid_for(self.config).data_idx
        f32 = np.float32
        # row-major copies: the GEMM kernel needs unit inner stride, and
        # _mod_consts' B is a transposed view
        return {k: np.ascontiguousarray(v) for k, v in {
            "mod_b_re": t["mod_b_re"].astype(f32), "mod_b_im": t["mod_b_im"].astype(f32),
            "mod_bsum": (t["mod_b_re"] + t["mod_b_im"]).astype(f32),
            "pilot_wave_re": t["pilot_wave_re"].astype(f32),
            "pilot_wave_im": t["pilot_wave_im"].astype(f32),
            "demod_data_re": t["demod_data_re"].astype(f32),
            "demod_data_im": t["demod_data_im"].astype(f32),
            "demod_data_sum": (t["demod_data_re"] + t["demod_data_im"]).astype(f32),
            "demod_pilot_re": t["demod_pilot_re"].astype(f32),
            "demod_pilot_im": t["demod_pilot_im"].astype(f32),
            "demod_pilot_sum": (t["demod_pilot_re"] + t["demod_pilot_im"]).astype(f32),
            "pilot_seq_re": t["pilot_seq"].real.astype(f32),
            "pilot_seq_im": t["pilot_seq"].imag.astype(f32),
            "interp_left": t["interp_left"][data_idx].astype(np.int64),
            "interp_right": t["interp_right"][data_idx].astype(np.int64),
            "interp_w": t["interp_w"][data_idx].astype(f32),
        }.items()}

    def load_reference_tables(self, tables: Dict[str, np.ndarray]) -> None:
        """Overwrite the buffers with tables built elsewhere (same names and
        shapes as reference_tables gives)."""
        want = reference_tables(self.config, self.cell_id)
        if set(tables) != set(want):
            raise KeyError(f"table names {sorted(tables)}, expected {sorted(want)}")
        for name, arr in want.items():
            if np.shape(tables[name]) != arr.shape:
                raise ValueError(f"table {name}: shape {np.shape(tables[name])}, "
                                 f"expected {arr.shape}")
        with torch.no_grad():
            for name, arr in self._buffers_from(
                    {k: np.asarray(v) for k, v in tables.items()}).items():
                buf = getattr(self, name)
                buf.copy_(torch.as_tensor(arr, dtype=buf.dtype))

    @property
    def mod_tables(self) -> ModTables:
        return ModTables(C(self.mod_b_re, self.mod_b_im), self.mod_bsum,
                         C(self.pilot_wave_re, self.pilot_wave_im))

    @property
    def rx_tables(self) -> RxTables:
        return RxTables(
            DemodTables(C(self.demod_data_re, self.demod_data_im), self.demod_data_sum),
            DemodTables(C(self.demod_pilot_re, self.demod_pilot_im), self.demod_pilot_sum),
            C(self.pilot_seq_re, self.pilot_seq_im),
            (self.interp_left, self.interp_right, self.interp_w))

    def transmit(self, bits: torch.Tensor) -> C:
        return transmit(bits, self.config, "lte", self.cell_id, self.mod_tables)

    def forward(self, bits: torch.Tensor, snr_db,
                generator: Optional[torch.Generator] = None, noise=None) -> SisoResult:
        signal_tx = self.transmit(bits)
        papr = ofdm.papr_db(signal_tx, axis=-1)
        measure_axes = -1 if bits.ndim > 1 else None
        bits_rx, x_eq, psnr = _receive_awgn_freq(
            signal_tx, snr_db, self.config, "lte", measure_axes, self.cell_id,
            generator, noise, self.rx_tables)
        # follow the caller's bit dtype
        bits_rx = bits_rx.to(bits.dtype)
        errors = (bits_rx != bits).sum(dim=-1, dtype=torch.int32)
        ber = errors / bits.shape[-1]
        return SisoResult(bits_rx, errors, ber, papr, psnr, x_eq, signal_tx)


def simulate_siso(bits: torch.Tensor, snr_db, config: LTEConfig,
                  generator: Optional[torch.Generator] = None, device=None,
                  noise=None, mode: str = "lte", channel_type: str = "awgn",
                  enable_equalization: bool = True) -> SisoResult:
    """End-to-end SISO Monte-Carlo step.

    bits: (..., n_bits) with n_bits a multiple of bits_per_frame (pad first
    with pad_bits), on `device` (default: the device of `bits`). Leading
    axes are independent lanes; snr_db broadcasts against them."""
    _check_branch(mode, channel_type, enable_equalization)
    device = bits.device if device is None else torch.device(device)
    link = SisoLink(config, device=device)
    return link(bits.to(device), snr_db, generator=generator, noise=noise)
