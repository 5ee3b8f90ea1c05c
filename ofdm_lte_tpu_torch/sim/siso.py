"""SISO OFDM / SC-FDM simulation: every branch of the link.

Port of ofdm_lte_tpu/sim/siso.py:

    bits -> QAM [-> SC-FDM DFT precoding] -> grid scatter + IDFT + CP (one
    complex GEMM) -> PAPR -> channel -> DFT to the bins the receiver needs
    -> LS + interpolation + slot hold -> ZF [-> SC-FDM IDFT] -> hard demap
    -> bit errors

- mode: "lte" (OFDM on the LTE grid with CRS pilots), "sc-fdm" (the same
  grid with DFT-precoded data) or "simple" (sequential mapping onto the
  first Nc bins, no pilots, no equalization);
- channel_type: "awgn", "fading" (per-sample flat Rayleigh) or
  "rayleigh_mp" (Jakes taps over an ITU power-delay profile);
- enable_equalization=False detects the raw data bins and reports the pilot
  SNR over every symbol's pilot bins.

Over AWGN with equalization ("lte" and "sc-fdm") the noise is injected at
the demodulated bins (`_receive_awgn_freq`), as in the JAX package: the
modem's DFT is unitary and the receiver discards the CP samples and the
guard/DC bins, so time-domain CN(0, σ²) noise reaches the detector only as
i.i.d. CN(0, σ²) at those bins. Every other combination sends the sample
stream through `_apply_channel` and the time-domain `receive`.

`SisoLink` is an nn.Module that takes mode, channel and equalization at
construction and holds every constant table that configuration needs as
buffers; `simulate_siso` is the functional form. Both run on the CUDA card
unless the caller passes `device="cpu"`. Leading axes of `bits` are
independent Monte-Carlo lanes. Randomness comes from one torch.Generator
per call; `noise` (bin-domain AWGN) and `draws` (time-domain channels) are
the seams through which a caller supplies the random numbers.

Under a torch.profiler `forward` records its stages as sibling spans
(utils/profiling.span): `modem.tx`, `modem.papr`, the channel
(`channel.awgn`, twice over AWGN at the bins: σ, then the noise;
`channel.multipath`, `channel.fading`), `modem.rx_dft`, `modem.estimate`,
`modem.demap` and `link.errors`. A channel span never holds a modem span,
nor the reverse.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..channel.awgn import awgn, snr_linear, standard_normals
from ..channel.rayleigh import flat_fading, make_profile, rayleigh_multipath
from ..cplx import C
from ..config import LTEConfig
from ..device import resolve_device
from ..grid import grid_for, interp_table, pilot_sequence
from ..ops import ofdm, qam, scfdm
from ..ops.ofdm import ModTables
from ..rx import estimation as est
from ..utils.profiling import span
from .links import cached_link

MODES = ("lte", "sc-fdm", "simple")
CHANNEL_TYPES = ("awgn", "fading", "rayleigh_mp")


class SisoResult(NamedTuple):
    bits_rx: torch.Tensor        # (..., n_bits), the caller's bit dtype
    bit_errors: torch.Tensor     # (...,)
    ber: torch.Tensor            # (...,)
    papr_db: torch.Tensor        # (...,)
    pilot_snr_db: torch.Tensor   # (...,)
    symbols_rx: C                # (..., S, n_data) equalized data symbols
    signal_tx: C                 # (..., S·(N+cp))


class RxTables(NamedTuple):
    """Device tables of the receiver; a mode leaves what it does not use None."""
    data: C                                  # DFT to the data bins
    pilot: Optional[C] = None                # DFT to the pilot bins
    known: Optional[C] = None                # CRS pilot sequence
    interp: Optional[tuple] = None           # (left, right, w) at the data bins
    scfdm: Optional[C] = None                # SC-FDM IDFT


def check_branch(mode: str, channel_type: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; pick from {MODES}")
    if channel_type not in CHANNEL_TYPES:
        raise ValueError(f"unknown channel_type {channel_type!r}; pick from {CHANNEL_TYPES}")


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
             cell_id: int = 0, tables: Optional[ModTables] = None,
             scfdm_tables: Optional[C] = None) -> C:
    """bits (..., S·n_data·bps) -> CP-prefixed sample stream (..., S·(N+cp)).

    'simple' maps the symbols onto the first Nc bins and carries no pilots:
    its GEMM runs over the (Nc, N+cp) rows of the IDFT table alone, which
    gives what scattering into a zero N-bin grid and `ofdm.modulate_grid`
    give, without the scatter and the zero rows."""
    n_data = grid_for(config).num_data if mode in ("lte", "sc-fdm") else config.Nc
    lead = tuple(bits.shape[:-1])
    S = bits.shape[-1] // (n_data * config.bits_per_symbol)
    syms = qam.modulate(bits, config.modulation).reshape(lead + (S, n_data))
    if mode == "sc-fdm":
        syms = scfdm.precode(syms, n_data, scfdm_tables)
    if mode in ("lte", "sc-fdm"):
        tx = ofdm.modulate_symbols(syms, config, cell_id, tables)  # (..., S, N+cp)
    else:
        tx = ofdm.modulate_custom(syms, config, np.arange(config.Nc), (), cell_id, tables)
    return tx.reshape(lead + (S * config.samples_per_ofdm_symbol,))


def _hard_bits(x_eq: C, config: LTEConfig) -> torch.Tensor:
    lead = tuple(x_eq.shape[:-2])
    flat = x_eq.reshape(lead + (x_eq.shape[-2] * x_eq.shape[-1],))
    return qam.demodulate(flat, config.modulation)


def receive(signal: C, config: LTEConfig, mode: str = "lte", cell_id: int = 0,
            enable_equalization: bool = True, tables: Optional[RxTables] = None):
    """Sample stream -> (bits, equalized data symbols, pilot SNR dB).

    Frame, per-bin DFT, slot-periodic CRS estimation, per-symbol ZF,
    optional SC-FDM IDFT, hard detection, bit demap."""
    g = grid_for(config)
    t = tables if tables is not None else RxTables(None)

    if mode == "simple":
        # sequential mapping: first Nc bins, no pilots, no equalization
        with span("modem.rx_dft"):
            y_bins = ofdm.demodulate_bins(ofdm.frame_stream(signal, config), config,
                                          np.arange(config.Nc), t.data)
        with span("modem.demap"):
            zero = torch.zeros(tuple(y_bins.shape[:-2]), dtype=torch.float32,
                               device=y_bins.re.device)
            return _hard_bits(y_bins, config), y_bins, zero

    with span("modem.rx_dft"):
        y = ofdm.frame_stream(signal, config)                          # (..., S, N+cp)
        y_data = ofdm.demodulate_bins(y, config, g.data_idx, t.data)   # (..., S, n_data)
        # with equalization the slot-start symbols alone, as a strided view: a
        # row gather the GEMM reads in place
        y_pil = ofdm.demodulate_bins(y[..., ::est.SLOT_SIZE, :] if enable_equalization else y,
                                     config, g.pilot_idx, t.pilot)
    if enable_equalization:
        return _detect_from_bins(y_data, y_pil, config, mode, cell_id, tables)

    with span("modem.estimate"):
        psnr = est.pilot_snr_db(y_pil, cell_id, axis=(-2, -1), known=t.known)
    with span("modem.demap"):
        x_eq = y_data
        if mode == "sc-fdm":
            x_eq = scfdm.decode(x_eq, g.num_data, t.scfdm)
        return _hard_bits(x_eq, config), x_eq, psnr


def _detect_from_bins(y_data: C, y_pil: C, config: LTEConfig, mode: str = "lte",
                      cell_id: int = 0, tables: Optional[RxTables] = None):
    """Equalized back half of the receiver: CRS LS estimation from the
    slot-start pilot bins, slot-periodic interpolation, per-symbol ZF,
    optional SC-FDM decode, hard demap. Returns (bits, equalized symbols,
    pilot SNR dB)."""
    g = grid_for(config)
    t = tables if tables is not None else RxTables(None)
    S = y_data.shape[-2]
    with span("modem.estimate"):
        h_pil = est.ls_at_pilots(y_pil, cell_id, t.known)          # (..., n_slots, n_pil)
        psnr = est.pilot_snr_db(y_pil, cell_id, axis=(-2, -1), known=t.known)
        h_data_slots = est.interpolate(h_pil, config, out_bins=g.data_idx, table=t.interp)
        h_data = est.slot_periodic(h_data_slots, S)                # (..., S, n_data)
        x_eq = est.zf_equalize(y_data, h_data)
    with span("modem.demap"):
        if mode == "sc-fdm":
            x_eq = scfdm.decode(x_eq, g.num_data, t.scfdm)
        return _hard_bits(x_eq, config), x_eq, psnr


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
    with span("channel.awgn"):
        snr_lin = snr_linear(snr_db, device)
        p = signal.abs2()
        sig_power = p.mean() if measure_axes is None else p.mean(dim=measure_axes)
        std = torch.sqrt((sig_power / snr_lin)[..., None, None] / 2.0)

    g = grid_for(config)
    with span("modem.rx_dft"):
        y = ofdm.frame_stream(signal, config)
        y_data = ofdm.demodulate_bins(y, config, g.data_idx,
                                      tables.data if tables is not None else None)
        # slot-start symbols as a strided view: a row gather the GEMM reads in place
        y_slot = y[..., ::est.SLOT_SIZE, :]
        y_pil = ofdm.demodulate_bins(y_slot, config, g.pilot_idx,
                                     tables.pilot if tables is not None else None)

    def add_cn(x: C, n: C) -> C:
        return C(x.re + n.re * std, x.im + n.im * std)

    with span("channel.awgn"):
        noise = (None, None) if noise is None else noise
        n_data = standard_normals(y_data.shape, generator, device, noise[0], "data noise")
        n_pil = standard_normals(y_pil.shape, generator, device, noise[1], "pilot noise")
        y_data, y_pil = add_cn(y_data, n_data), add_cn(y_pil, n_pil)
    return _detect_from_bins(y_data, y_pil, config, mode, cell_id, tables)


def _apply_channel(signal: C, snr_db, channel_type: str, profile, measure_axes,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None) -> C:
    """The time-domain channel. `draws` carries the seams by name: "noise"
    (every channel), "phases" (rayleigh_mp), "fading" (fading)."""
    draws = draws or {}
    if channel_type == "awgn":
        with span("channel.awgn"):
            return awgn(signal, snr_db, measure_axes, generator, draws.get("noise"))
    if channel_type == "rayleigh_mp":
        with span("channel.multipath"):
            return rayleigh_multipath(signal, snr_db, profile, measure_axes, generator,
                                      draws.get("phases"), draws.get("noise"))
    if channel_type == "fading":
        with span("channel.fading"):
            return flat_fading(signal, snr_db, generator, draws.get("fading"),
                               draws.get("noise"))
    raise ValueError(f"unknown channel_type {channel_type}")


def reference_tables(config: LTEConfig, cell_id: int = 0, mode: str = "lte"
                     ) -> Dict[str, np.ndarray]:
    """The link's constant tables, by name, from the port's NumPy copies.

    The same names built from the JAX package's functions load into a
    SisoLink through load_reference_tables."""
    g = grid_for(config)
    N, cp = config.N, config.cp_length
    if mode == "simple":
        bins = tuple(range(config.Nc))
        B_re, B_im, pw_re, pw_im = ofdm._mod_consts_custom(N, cp, bins, (), cell_id)
        G_re, G_im = ofdm._demod_consts(N, cp, bins)
        return {"mod_b_re": B_re, "mod_b_im": B_im,
                "pilot_wave_re": pw_re, "pilot_wave_im": pw_im,
                "demod_data_re": G_re, "demod_data_im": G_im}
    B_re, B_im, pw_re, pw_im = ofdm._mod_consts(N, config.Nc, cp, cell_id)
    Gd_re, Gd_im = ofdm._demod_consts(N, cp, tuple(int(b) for b in g.data_idx))
    Gp_re, Gp_im = ofdm._demod_consts(N, cp, tuple(int(b) for b in g.pilot_idx))
    left, right, w = interp_table(N, config.Nc)
    tables = {"mod_b_re": B_re, "mod_b_im": B_im,
              "pilot_wave_re": pw_re, "pilot_wave_im": pw_im,
              "demod_data_re": Gd_re, "demod_data_im": Gd_im,
              "demod_pilot_re": Gp_re, "demod_pilot_im": Gp_im,
              "interp_left": left, "interp_right": right, "interp_w": w,
              "pilot_seq": pilot_sequence(cell_id, g.num_pilot)}
    if mode == "sc-fdm":
        for name, inverse in (("scfdm_w", False), ("scfdm_winv", True)):
            tables[name + "_re"], tables[name + "_im"] = scfdm._dft_consts(g.num_data, inverse)
    return tables


# the table prefixes of the GEMMs' B operands, each stored as two row-major
# planes, re and im
_GEMMS = ("mod_b", "demod_data", "demod_pilot", "scfdm_w", "scfdm_winv")


class SisoLink(nn.Module):
    """One SISO link (mode, channel, equalization) for one LTEConfig, its
    tables as buffers.

    forward(bits, snr_db, generator=None, noise=None, draws=None) ->
    SisoResult runs one Monte-Carlo step; see _receive_awgn_freq for the
    `noise` seam and _apply_channel for `draws`. The tables live on
    `device`: the CUDA card when none is given (resolve_device)."""

    def __init__(self, config: LTEConfig, device=None, cell_id: int = 0,
                 mode: str = "lte", channel_type: str = "awgn",
                 enable_equalization: bool = True, itu_profile: str = "Pedestrian_A",
                 velocity_kmh: Optional[float] = None, frequency_ghz: float = 2.0):
        super().__init__()
        check_branch(mode, channel_type)
        device = resolve_device(device)
        self.config = config
        self.cell_id = cell_id
        self.mode = mode
        self.channel_type = channel_type
        self.enable_equalization = enable_equalization
        self.profile = (make_profile(itu_profile, config.fs, velocity_kmh, frequency_ghz)
                        if channel_type == "rayleigh_mp" else None)
        for name, arr in self._buffers_from(reference_tables(config, cell_id, mode)).items():
            self.register_buffer(name, torch.tensor(arr, device=device))

    def _buffers_from(self, t: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        f32 = np.float32
        out = {}
        for prefix in _GEMMS:
            if prefix + "_re" in t:
                out[prefix + "_re"] = t[prefix + "_re"].astype(f32)
                out[prefix + "_im"] = t[prefix + "_im"].astype(f32)
        out["pilot_wave_re"] = t["pilot_wave_re"].astype(f32)
        out["pilot_wave_im"] = t["pilot_wave_im"].astype(f32)
        if "pilot_seq" in t:
            data_idx = grid_for(self.config).data_idx
            out["pilot_seq_re"] = t["pilot_seq"].real.astype(f32)
            out["pilot_seq_im"] = t["pilot_seq"].imag.astype(f32)
            out["interp_left"] = t["interp_left"][data_idx].astype(np.int64)
            out["interp_right"] = t["interp_right"][data_idx].astype(np.int64)
            out["interp_w"] = t["interp_w"][data_idx].astype(f32)
        # row-major copies: the GEMM kernel needs unit inner stride, and
        # _mod_consts' B is a transposed view
        return {k: np.ascontiguousarray(v) for k, v in out.items()}

    def load_reference_tables(self, tables: Dict[str, np.ndarray]) -> None:
        """Overwrite the buffers with tables built elsewhere (same names and
        shapes as reference_tables gives for this link's mode)."""
        want = reference_tables(self.config, self.cell_id, self.mode)
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

    def _gemm(self, prefix: str) -> Optional[C]:
        if not hasattr(self, prefix + "_re"):
            return None
        return C(getattr(self, prefix + "_re"), getattr(self, prefix + "_im"))

    @property
    def mod_tables(self) -> ModTables:
        return ModTables(self._gemm("mod_b"), C(self.pilot_wave_re, self.pilot_wave_im))

    @property
    def rx_tables(self) -> RxTables:
        if self.mode == "simple":
            return RxTables(self._gemm("demod_data"))
        return RxTables(
            self._gemm("demod_data"), self._gemm("demod_pilot"),
            C(self.pilot_seq_re, self.pilot_seq_im),
            (self.interp_left, self.interp_right, self.interp_w),
            self._gemm("scfdm_winv"))

    def transmit(self, bits: torch.Tensor) -> C:
        return transmit(bits, self.config, self.mode, self.cell_id, self.mod_tables,
                        self._gemm("scfdm_w"))

    def forward(self, bits: torch.Tensor, snr_db,
                generator: Optional[torch.Generator] = None, noise=None,
                draws: Optional[dict] = None) -> SisoResult:
        with span("modem.tx"):
            signal_tx = self.transmit(bits)
        with span("modem.papr"):
            papr = ofdm.papr_db(signal_tx, axis=-1)
        measure_axes = -1 if bits.ndim > 1 else None
        if (self.channel_type == "awgn" and self.mode in ("lte", "sc-fdm")
                and self.enable_equalization):
            bits_rx, x_eq, psnr = _receive_awgn_freq(
                signal_tx, snr_db, self.config, self.mode, measure_axes, self.cell_id,
                generator, noise, self.rx_tables)
        else:
            if noise is not None:
                raise ValueError("`noise` is the bin-domain AWGN seam; this link's channel "
                                 "runs in the time domain and takes `draws`")
            signal_rx = _apply_channel(signal_tx, snr_db, self.channel_type, self.profile,
                                       measure_axes, generator, draws)
            bits_rx, x_eq, psnr = receive(signal_rx, self.config, self.mode, self.cell_id,
                                          self.enable_equalization, self.rx_tables)
        with span("link.errors"):
            # follow the caller's bit dtype
            bits_rx = bits_rx.to(bits.dtype)
            errors = (bits_rx != bits).sum(dim=-1, dtype=torch.int32)
            ber = errors / bits.shape[-1]
        return SisoResult(bits_rx, errors, ber, papr, psnr, x_eq, signal_tx)


def simulate_siso(bits: torch.Tensor, snr_db, config: LTEConfig,
                  generator: Optional[torch.Generator] = None, device=None,
                  noise=None, mode: str = "lte", channel_type: str = "awgn",
                  itu_profile: str = "Pedestrian_A", velocity_kmh: Optional[float] = None,
                  frequency_ghz: float = 2.0, enable_equalization: bool = True,
                  draws: Optional[dict] = None) -> SisoResult:
    """End-to-end SISO Monte-Carlo step.

    bits: (..., n_bits) with n_bits a multiple of bits_per_frame (pad first
    with pad_bits). They are moved to `device`: the CUDA card when none is
    given, which raises where there is no card (resolve_device); pass
    device="cpu" for the CPU. Leading axes are independent lanes; snr_db
    broadcasts against them. The link of these arguments is built on the
    first call and kept (sim.links)."""
    link = cached_link(SisoLink, config, resolve_device(device), 0, mode, channel_type,
                       enable_equalization, itu_profile, velocity_kmh, frequency_ghz)
    bits = bits.to(link.mod_b_re.device)
    return link(bits, snr_db, generator=generator, noise=noise, draws=draws)
