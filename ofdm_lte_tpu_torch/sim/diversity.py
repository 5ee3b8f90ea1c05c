"""Receive/transmit diversity links: SIMO MRC and 2-TX Alamouti SFBC.

Port of ofdm_lte_tpu/sim/diversity.py:

- simulate_simo: 1×N receive diversity. One channel per RX antenna
  (time-domain noise per leg), per-antenna CRS estimation, frequency-domain
  MRC, hard demap.
- simulate_sfbc: 2×N Alamouti SFBC over the even count of data bins (998 of
  999 at 20 MHz). TX0 carries the pilots [0::2] of cell 0 and TX1 [1::2] of
  cell 1; the noise is injected per RX at the demodulated bins; each RX is
  decoded with per-TX slot-periodic CRS estimates and the RX mean is taken
  before detection. simulate_miso is num_rx = 1, simulate_mimo num_rx > 1.

The antennas are a leading array axis that the modem's GEMMs fold into M.
`SimoLink` and `SfbcLink` are nn.Modules that hold their tables as
buffers; the functional forms build the link of their arguments once and
keep it (sim.links). All run on the CUDA card unless the caller passes
`device="cpu"`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import cplx
from ..channel.awgn import standard_normals
from ..channel.mimo import mimo_mix_noiseless, transmit_simo
from ..channel.rayleigh import make_profile
from ..cplx import C
from ..config import LTEConfig
from ..device import resolve_device
from ..grid import grid_for
from ..ops import ofdm, qam
from ..ops.ofdm import ModTables
from ..rx import alamouti
from ..rx import estimation as est
from ..rx.mimo_estimation import TxEstTables, estimate_per_tx, per_tx_tables
from . import siso as siso_mod
from .links import cached_link

CHANNEL_TYPES = ("awgn", "rayleigh_mp")


class DiversityResult(NamedTuple):
    bits_rx: torch.Tensor
    bit_errors: torch.Tensor
    ber: torch.Tensor
    papr_db: torch.Tensor
    symbols_rx: C


def _check_channel(channel_type: str) -> None:
    if channel_type not in CHANNEL_TYPES:
        raise ValueError(f"unknown channel_type {channel_type!r}; pick from {CHANNEL_TYPES}")


def _add_cn(x: C, noise_power: torch.Tensor,
            generator: Optional[torch.Generator] = None, noise=None) -> C:
    """CN(0, noise_power) at the demodulated bins; noise_power (rx, ...)
    aligns against x (rx, ..., S, bins). `noise` is the (re, im) seam of
    standard normals shaped like x."""
    std = torch.sqrt(noise_power[..., None, None] / 2.0)
    n = standard_normals(x.shape, generator, x.re.device, noise)
    return C(x.re + n.re * std, x.im + n.im * std)


def _result(symbols: C, bits: torch.Tensor, papr: torch.Tensor,
            config: LTEConfig) -> DiversityResult:
    lead = tuple(symbols.shape[:-2])
    flat = symbols.reshape(lead + (symbols.shape[-2] * symbols.shape[-1],))
    bits_rx = qam.demodulate(flat, config.modulation).to(bits.dtype)
    errors = (bits_rx != bits).sum(dim=-1, dtype=torch.int32)
    return DiversityResult(bits_rx, errors, errors / bits.shape[-1], papr, symbols)


# ---------------------------------------------------------------------------
# SIMO with frequency-domain MRC
# ---------------------------------------------------------------------------

def simo_receive(y: C, config: LTEConfig, tables: Optional[siso_mod.RxTables] = None) -> C:
    """Per-leg received streams y (num_rx, ..., T) -> MRC-combined data
    symbols (..., S, n_data): per-antenna slot-periodic CRS estimates, then
    maximum-ratio combining over the antenna axis."""
    g = grid_for(config)
    t = tables if tables is not None else siso_mod.RxTables(None)
    yf = ofdm.frame_stream(y, config)                          # (num_rx, ..., S, sps)
    S = yf.shape[-2]
    y_data = ofdm.demodulate_bins(yf, config, g.data_idx, t.data)
    y_pil = ofdm.demodulate_bins(yf[..., ::est.SLOT_SIZE, :], config, g.pilot_idx, t.pilot)
    h_pil = est.ls_at_pilots(y_pil, 0, t.known)                # (num_rx, ..., n_slots, np)
    h_data_slots = est.interpolate(h_pil, config, out_bins=g.data_idx, table=t.interp)
    h_data = est.slot_periodic(h_data_slots, S)                # (num_rx, ..., S, nd)
    return est.mrc_combine(y_data, h_data, antenna_axis=0)     # (..., S, nd)


class SimoLink(nn.Module):
    """The 1×num_rx MRC link for one LTEConfig and channel.

    forward(bits, snr_db, generator=None, draws=None) -> DiversityResult.
    `draws` carries the channel's seams by name: "noise" (standard normals
    shaped (num_rx, ..., T)) and, over multipath, "phases". The tables are
    those of the SISO link in its "lte" mode, held by `self.siso`."""

    def __init__(self, config: LTEConfig, num_rx: int = 2, device=None,
                 channel_type: str = "awgn", itu_profile: str = "Pedestrian_A",
                 velocity_kmh: Optional[float] = None, frequency_ghz: float = 2.0):
        super().__init__()
        _check_channel(channel_type)
        self.config = config
        self.num_rx = num_rx
        self.channel_type = channel_type
        self.siso = siso_mod.SisoLink(config, device, 0, "lte", channel_type, True,
                                      itu_profile, velocity_kmh, frequency_ghz)

    def forward(self, bits: torch.Tensor, snr_db,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None) -> DiversityResult:
        draws = draws or {}
        signal_tx = self.siso.transmit(bits)                   # (..., T)
        papr = ofdm.papr_db(signal_tx, axis=-1)
        y = transmit_simo(signal_tx, snr_db, self.num_rx, self.channel_type,
                          self.siso.profile, generator, draws.get("phases"),
                          draws.get("noise"))                   # (num_rx, ..., T)
        combined = simo_receive(y, self.config, self.siso.rx_tables)
        return _result(combined, bits, papr, self.config)


def simulate_simo(bits: torch.Tensor, snr_db, config: LTEConfig, num_rx: int = 2,
                  channel_type: str = "awgn", itu_profile: str = "Pedestrian_A",
                  velocity_kmh: Optional[float] = None, frequency_ghz: float = 2.0,
                  generator: Optional[torch.Generator] = None, device=None,
                  draws: Optional[dict] = None) -> DiversityResult:
    """1×N receive diversity: independent channel per RX antenna, per-antenna
    CRS estimation, frequency-domain MRC combining, hard demap. Runs on
    `device`: the CUDA card when none is given."""
    link = cached_link(SimoLink, config, num_rx, resolve_device(device), channel_type,
                       itu_profile, velocity_kmh, frequency_ghz)
    bits = bits.to(link.siso.mod_b_re.device)
    return link(bits, snr_db, generator=generator, draws=draws)


# ---------------------------------------------------------------------------
# 2-TX Alamouti SFBC (MISO / MIMO)
# ---------------------------------------------------------------------------

def sfbc_data_bins(config: LTEConfig) -> np.ndarray:
    """Data bins for SFBC: an even count; the last is dropped if odd."""
    d = grid_for(config).data_idx
    return d[:len(d) - (len(d) % 2)]


def sfbc_bits_per_frame(config: LTEConfig, num_ofdm_symbols: int) -> int:
    return len(sfbc_data_bins(config)) * config.bits_per_symbol * num_ofdm_symbols


class SfbcTables(NamedTuple):
    """Device tables of the SFBC link."""
    mod: ModTables            # B over the SFBC data bins, pilot wave (2, N+cp)
    data: C                   # DFT to the SFBC data bins
    pilot: C                  # DFT to all CRS pilot bins
    per_tx: list              # [2] TxEstTables


def sfbc_tables(config: LTEConfig, device=None) -> SfbcTables:
    g = grid_for(config)
    dbins = sfbc_data_bins(config)
    return SfbcTables(
        ofdm.mod_tables_multi(config, dbins, (g.pilot_idx[0::2], g.pilot_idx[1::2]),
                              (0, 1), device),
        ofdm.demod_tables(config, dbins, device),
        ofdm.demod_tables(config, g.pilot_idx, device),
        per_tx_tables(config, 2, dbins, device=device))


def sfbc_transmit(bits: torch.Tensor, config: LTEConfig,
                  tables: Optional[SfbcTables] = None) -> C:
    """bits (..., S·n_even·bps) -> TX signals (2, ..., S·(N+cp)).

    Orthogonal CRS: TX0 on the even pilot positions (cell 0's sequence),
    TX1 on the odd ones (cell 1's). Both antennas share the table of the
    SFBC data bins, so they go through one GEMM with the antenna axis
    folded into M."""
    if tables is None:
        tables = sfbc_tables(config, bits.device)
    g = grid_for(config)
    dbins = sfbc_data_bins(config)
    n_even = len(dbins)
    lead = tuple(bits.shape[:-1])
    S = bits.shape[-1] // (n_even * config.bits_per_symbol)

    syms = qam.modulate(bits, config.modulation).reshape(lead + (S, n_even))
    out = ofdm.modulate_custom_multi(
        cplx.stack(alamouti.encode(syms), axis=0), config, dbins,
        (g.pilot_idx[0::2], g.pilot_idx[1::2]), (0, 1), tables.mod)  # (2, ..., S, N+cp)
    return out.reshape((2,) + lead + (S * config.samples_per_ofdm_symbol,))


def sfbc_receive(y: C, config: LTEConfig, noise_power: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, noise=None,
                 tables: Optional[SfbcTables] = None) -> C:
    """Per-RX SFBC decode with slot-periodic per-TX CRS estimates.

    y: (num_rx, ..., T) -> decoded symbols per RX (num_rx, ..., S, n_even).
    noise_power (num_rx, ...): inject per-RX CN noise at the demodulated
    bins; None = y already carries its noise. `noise=(data, pilot)` is the
    seam: (re, im) standard normals shaped like the data and pilot bins."""
    if tables is None:
        tables = sfbc_tables(config, y.re.device)
    g = grid_for(config)
    dbins = sfbc_data_bins(config)
    yf = ofdm.frame_stream(y, config)
    S = yf.shape[-2]

    y_data = ofdm.demodulate_bins(yf, config, dbins, tables.data)
    y_pil = ofdm.demodulate_bins(yf[..., ::est.SLOT_SIZE, :], config, g.pilot_idx,
                                 tables.pilot)
    if noise_power is not None:
        noise = (None, None) if noise is None else noise
        y_data = _add_cn(y_data, noise_power, generator, noise[0])
        y_pil = _add_cn(y_pil, noise_power, generator, noise[1])
    h_tx = estimate_per_tx(y_pil, config, 2, dbins, tables=tables.per_tx)
    # (num_rx, ..., n_slots, 2, n_even): hold each slot's estimate over its symbols
    h_tx = est.slot_periodic(h_tx.reshape(tuple(h_tx.shape[:-2]) + (-1,)), S)
    h_tx = h_tx.reshape(tuple(h_tx.shape[:-1]) + (2, len(dbins)))
    return alamouti.decode(y_data, h_tx[..., 0, :], h_tx[..., 1, :])


class SfbcLink(nn.Module):
    """The 2×num_rx Alamouti SFBC link for one LTEConfig and channel.

    forward(bits, snr_db, generator=None, draws=None) -> DiversityResult.
    `draws`: "noise" ((data, pilot) pairs for the bins, see sfbc_receive)
    and, over multipath, "phases"."""

    def __init__(self, config: LTEConfig, num_rx: int = 1, device=None,
                 channel_type: str = "awgn", itu_profile: str = "Pedestrian_A",
                 velocity_kmh: Optional[float] = None, frequency_ghz: float = 2.0):
        super().__init__()
        _check_channel(channel_type)
        device = resolve_device(device)
        self.config = config
        self.num_rx = num_rx
        self.channel_type = channel_type
        self.profile = (make_profile(itu_profile, config.fs, velocity_kmh, frequency_ghz)
                        if channel_type == "rayleigh_mp" else None)
        t = sfbc_tables(config, device)
        for name, b in (("mod_b", t.mod.b), ("demod_data", t.data), ("demod_pilot", t.pilot)):
            self.register_buffer(name + "_re", b.re)
            self.register_buffer(name + "_im", b.im)
        self.register_buffer("pilot_wave_re", t.mod.pilot_wave.re)
        self.register_buffer("pilot_wave_im", t.mod.pilot_wave.im)
        for tx, e in enumerate(t.per_tx):
            self.register_buffer(f"pilot_seq{tx}_re", e.known.re)
            self.register_buffer(f"pilot_seq{tx}_im", e.known.im)
            for part, v in zip(("left", "right", "w"), e.interp):
                self.register_buffer(f"interp{tx}_{part}", v)

    def _gemm(self, name: str) -> C:
        return C(getattr(self, name + "_re"), getattr(self, name + "_im"))

    @property
    def tables(self) -> SfbcTables:
        return SfbcTables(
            ModTables(self._gemm("mod_b"), C(self.pilot_wave_re, self.pilot_wave_im)),
            self._gemm("demod_data"), self._gemm("demod_pilot"),
            [TxEstTables(C(getattr(self, f"pilot_seq{tx}_re"),
                           getattr(self, f"pilot_seq{tx}_im")),
                         tuple(getattr(self, f"interp{tx}_{part}")
                               for part in ("left", "right", "w")))
             for tx in range(2)])

    def forward(self, bits: torch.Tensor, snr_db,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None) -> DiversityResult:
        draws = draws or {}
        tables = self.tables
        signals_tx = sfbc_transmit(bits, self.config, tables)  # (2, ..., T)
        papr = ofdm.papr_db(signals_tx, axis=-1).mean(dim=0)
        y, _H, npow = mimo_mix_noiseless(signals_tx, snr_db, self.num_rx,
                                         self.channel_type, self.profile, generator,
                                         draws.get("phases"))  # (num_rx, ..., T)
        decoded_per_rx = sfbc_receive(y, self.config, npow, generator,
                                      draws.get("noise"), tables)
        decoded = decoded_per_rx.mean(axis=0)                  # (..., S, n_even)
        # the RX mean comes before the hard decision
        return _result(qam.detect(decoded, self.config.modulation), bits, papr,
                       self.config)._replace(symbols_rx=decoded)


def simulate_sfbc(bits: torch.Tensor, snr_db, config: LTEConfig, num_rx: int = 1,
                  channel_type: str = "awgn", itu_profile: str = "Pedestrian_A",
                  velocity_kmh: Optional[float] = None, frequency_ghz: float = 2.0,
                  generator: Optional[torch.Generator] = None, device=None,
                  draws: Optional[dict] = None) -> DiversityResult:
    """2×num_rx Alamouti SFBC: num_rx=1 is simulate_miso, num_rx>1 is
    simulate_mimo (per-RX decode, then the mean across RX). Runs on
    `device`: the CUDA card when none is given."""
    link = cached_link(SfbcLink, config, num_rx, resolve_device(device), channel_type,
                       itu_profile, velocity_kmh, frequency_ghz)
    bits = bits.to(link.mod_b_re.device)
    return link(bits, snr_db, generator=generator, draws=draws)


def simulate_miso(bits, snr_db, config, **kw) -> DiversityResult:
    """2×1 Alamouti SFBC."""
    return simulate_sfbc(bits, snr_db, config, num_rx=1, **kw)


def simulate_mimo(bits, snr_db, config, num_rx: int = 2, **kw) -> DiversityResult:
    """2×N Alamouti SFBC with the mean across RX."""
    return simulate_sfbc(bits, snr_db, config, num_rx=num_rx, **kw)
