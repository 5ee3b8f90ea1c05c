"""TM4 spatial multiplexing: layer mapping, codebook precoding, orthogonal
CRS, MMSE/ZF/SIC/MRC detection.

Port of ofdm_lte_tpu/sim/spatial.py:

- rank and PMI are decided once per call, on the host, from an initial
  channel draw (`decide_rank_pmi`): the chosen rank sets array shapes;
- per OFDM symbol: nd QAM symbols -> zero-pad to a multiple of the rank ->
  layers (rank, m); precoded onto the first m data bins only, the rest stay
  zero;
- orthogonal CRS per TX on every step-th pilot bin;
- channel: flat iid CN(0,1) per link and lane ("awgn"), or per-link Jakes
  multipath ("rayleigh_mp");
- CRS estimation of H[rx, tx, k] on every symbol (not once per slot);
- (rank×rank) MIMO detection with the TX precoder W, layer demap, hard
  demap, BER.

The flat channel runs at the bins by default (`channel_impl="bins"`): for a
flat channel the modem's DFT round trip is the identity on the occupied
bins, so Y[rx, k] = Σ_tx H[rx, tx]·X[tx, k] + noise holds exactly and no RX
time signal is made. The TX time signals are still synthesized, in one GEMM
over the antenna axis, because PAPR and the measured-power noise convention
(P_rx = mean_t |y_rx(t)|²) are time-domain quantities; P_rx follows from the
TX cross-correlation matrix R[t1, t2] = mean_t x_t1(t)·x_t2*(t). The time
path (`channel_impl="time"`, always over multipath) mixes the sample
streams and demodulates the data bins and all pilot bins of every symbol.

`SpatialLink` is an nn.Module with its tables as buffers;
`simulate_spatial_multiplexing` is the functional form, which keeps the
link of its arguments (sim.links). Both run on the CUDA card unless the
caller passes `device="cpu"`.

Under a torch.profiler `forward` records its stages as sibling spans
(utils/profiling.span): `modem.tx` (QAM, layer map, precoder, the TX
GEMM), `modem.papr`, the channel (`channel.multipath`, the links' Jakes
taps and FIR, one fused pass on a card; or `channel.fading`, the flat H
and its mix), in the time path `modem.rx_dft`, then `channel.awgn` (the
bins' noise: P_rx, the draws, the sum), `modem.estimate`, the detector
(`detector.sic`: σ², the effective channel, the SIC stages and the
decisions, one ops/sic_detect launch on a card; or `detector.heff`, the
effective channel and σ², then `detector.mmse` (MMSE, IRC, ZF); MRC and the
unbiased MMSE `detector.detect` alone), `modem.demap` (the layer demap
and the hard demap) and `link.errors`. No channel, modem or detector span
holds another.
"""
from __future__ import annotations

import functools
import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import cplx
from ..channel.awgn import snr_linear, standard_normals
from ..channel.mimo import spatial_mix_noiseless
from ..channel.rayleigh import flat_mimo_matrix, make_profile
from ..cplx import C
from ..config import LTEConfig
from ..device import resolve_device
from ..grid import grid_for, make_grid, orthogonal_pilot_indices, pilot_sequence, pilot_step
from ..mimo import codebook as cb
from ..mimo import detector, layer_mapper
from ..mimo.rank_adaptation import get_feedback
from ..ops import ofdm, qam
from ..ops.ofdm import ModTables
from ..ops.sic_detect import sic_detect
from ..rx.mimo_estimation import TxEstTables, estimate_per_tx_planes, per_tx_tables
from ..utils.profiling import span
from .links import cached_link

CHANNEL_TYPES = ("awgn", "rayleigh_mp")
CHANNEL_IMPLS = ("bins", "time")
PLANE_DETECTORS = ("MMSE", "IRC", "ZF", "SIC")


class SpatialResult(NamedTuple):
    bits_rx: torch.Tensor
    bit_errors: torch.Tensor
    ber: torch.Tensor
    symbols_rx: C
    papr_db: torch.Tensor    # (...,) mean over the TX antennas


def decide_rank_pmi(num_tx: int, num_rx: int, snr_db: float, rank="adaptive", seed: int = 0):
    """Host-side rank/PMI decision from an initial CN(0, 1/num_tx) draw of
    NumPy's MT19937(seed). Returns (rank_used, pmi, W numpy (num_tx, rank));
    a fixed rank takes PMI 0 of its TM4 codebook."""
    if rank == "adaptive":
        rng = np.random.RandomState(seed)
        H0 = (rng.randn(num_rx, num_tx) + 1j * rng.randn(num_rx, num_tx)) / np.sqrt(2 * num_tx)
        fb = get_feedback(H0, snr_db)
        return fb["ri"], fb["pmi"], fb["W"]
    rank_used = int(rank)
    return rank_used, 0, cb.get_precoder(0, num_tx, "TM4", rank_used)


@functools.lru_cache(maxsize=None)
def _pilot_bin_union_values(N: int, Nc: int, num_tx: int, layout: str = "reference"):
    """Per-TX transmitted values over the union CRS pilot grid: TX t carries
    pilot_sequence(t%4) on every step-th union bin with offset t, zeros on
    the other TXs' bins. A list of num_tx complex (n_pilot_union,) vectors.

    Under the reference layout at 8 TX, TX t and t+4 share bins, so what is
    received there is the sum of both sequences (the collision that the
    "extended" layout removes)."""
    g = make_grid(N, Nc)
    step = pilot_step(num_tx, layout)
    out = []
    for tx in range(num_tx):
        v = np.zeros(g.num_pilot, np.complex128)
        v[tx % step::step] = pilot_sequence(tx % 4, len(g.pilot_idx[tx % step::step]))
        out.append(v)
    return out


def bits_per_frame(config: LTEConfig, num_ofdm_symbols: int) -> int:
    return grid_for(config).num_data * config.bits_per_symbol * num_ofdm_symbols


def _channel_impl(channel_type: str, channel_impl: Optional[str] = None) -> str:
    """Multipath runs in the time domain; the flat channel at the bins unless
    OFDM_LTE_TPU_TORCH_SPATIAL_CHANNEL (or the caller) says "time"."""
    if channel_type == "rayleigh_mp":
        return "time"
    if channel_impl is None:
        channel_impl = os.environ.get("OFDM_LTE_TPU_TORCH_SPATIAL_CHANNEL", "bins").lower()
    if channel_impl not in CHANNEL_IMPLS:
        raise ValueError(f"OFDM_LTE_TPU_TORCH_SPATIAL_CHANNEL={channel_impl!r}; "
                         f"pick from {list(CHANNEL_IMPLS)}")
    return channel_impl


def _add_cn(x: C, std: torch.Tensor, n: C) -> C:
    return C(x.re + n.re * std, x.im + n.im * std)


class SpatialLink(nn.Module):
    """The num_tx×num_rx TM4 link of one LTEConfig, rank, detector, channel
    and pilot layout, its tables as buffers.

    forward(bits, snr_db, W=None, generator=None, draws=None) -> SpatialResult.
    bits (lanes..., S·nd·bps); snr_db a scalar or one value per lane; W the
    (num_tx, rank) precoder as NumPy complex or a C pair (default: PMI 0 of
    the rank's TM4 codebook, held as a buffer; under rank adaptation the
    caller passes what decide_rank_pmi chose). `draws` carries the seams by
    name, each replacing the generator's draws, with S symbols,
    m = ⌈nd/rank⌉ data bins a layer and n_pilot CRS bins:

    - "noise": ((data_re, data_im), (pilot_re, pilot_im)) standard normals
      shaped (num_rx, lanes..., S, m) and (num_rx, lanes..., S, n_pilot),
      drawn in that order (both paths add the noise at the bins);
    - "fading" (flat channel): (re, im) standard normals of H, shaped
      (lanes..., num_rx, num_tx);
    - "phases" (multipath): Jakes phases (num_rx·num_tx·lanes·taps, 16), the
      links in (rx, tx, lane, tap) order.
    """

    def __init__(self, config: LTEConfig, num_tx: int = 4, num_rx: int = 2,
                 rank_used: int = 2, detector_type: str = "MMSE", device=None,
                 channel_type: str = "awgn", pilot_layout: str = "reference",
                 channel_impl: Optional[str] = None, itu_profile: str = "Pedestrian_A",
                 velocity_kmh: Optional[float] = 3.0, frequency_ghz: float = 2.0):
        super().__init__()
        if channel_type not in CHANNEL_TYPES:
            raise ValueError(f"unknown channel_type {channel_type!r}; "
                             f"pick from {CHANNEL_TYPES}")
        device = resolve_device(device)
        self.config = config
        self.num_tx, self.num_rx, self.rank_used = num_tx, num_rx, int(rank_used)
        self.detector_type = detector_type
        self.channel_type = channel_type
        self.pilot_layout = pilot_layout
        self.channel_impl = _channel_impl(channel_type, channel_impl)
        self.profile = (make_profile(itu_profile, config.fs, velocity_kmh, frequency_ghz)
                        if channel_type == "rayleigh_mp" else None)

        g = grid_for(config)
        self.m = layer_mapper.padded_length(g.num_data, self.rank_used) // self.rank_used
        self.data_bins = g.data_idx[:self.m]
        pil_idx = orthogonal_pilot_indices(config, num_tx, pilot_layout)
        mod = ofdm.mod_tables_multi(config, self.data_bins, pil_idx,
                                    tuple(tx % 4 for tx in range(num_tx)), device)
        gemms = {"mod_b": mod.b}
        if self.channel_impl == "time":
            for name, bins in (("demod_data", self.data_bins), ("demod_pilot", g.pilot_idx)):
                gemms[name] = ofdm.demod_tables(config, bins, device)
        else:
            self._register_c("pilot_vals", cplx.const(np.stack(_pilot_bin_union_values(
                config.N, config.Nc, num_tx, pilot_layout)), device))   # (tx, n_pilot)
        self._uses_basis = []
        for tx, e in enumerate(per_tx_tables(config, num_tx, self.data_bins, pilot_layout,
                                             device)):
            self._register_c(f"pilot_seq{tx}", e.known)
            if e.basis is not None:
                gemms[f"tap_basis{tx}"] = e.basis
            else:
                for part, v in zip(("left", "right", "w"), e.interp):
                    self.register_buffer(f"interp{tx}_{part}", v)
            self._uses_basis.append(e.basis is not None)
        for name, b in gemms.items():
            self._register_c(name, b)
        self._register_c("pilot_wave", mod.pilot_wave)
        self._register_c("precoder", cplx.const(
            cb.get_precoder(0, num_tx, "TM4", self.rank_used), device))

    def _register_c(self, name: str, x: C) -> None:
        self.register_buffer(name + "_re", x.re)
        self.register_buffer(name + "_im", x.im)

    def _c(self, name: str) -> C:
        return C(getattr(self, name + "_re"), getattr(self, name + "_im"))

    @property
    def mod_tables(self) -> ModTables:
        return ModTables(self._c("mod_b"), self._c("pilot_wave"))

    @property
    def per_tx(self) -> List[TxEstTables]:
        return [TxEstTables(self._c(f"pilot_seq{tx}"), None, self._c(f"tap_basis{tx}"))
                if basis else
                TxEstTables(self._c(f"pilot_seq{tx}"),
                            tuple(getattr(self, f"interp{tx}_{part}")
                                  for part in ("left", "right", "w")))
                for tx, basis in enumerate(self._uses_basis)]

    def _precoder(self, W) -> C:
        if W is None:
            return self._c("precoder")
        dev = self.mod_b_re.device
        W = (C(W.re.to(dev), W.im.to(dev)) if isinstance(W, C)
             else cplx.const(np.asarray(W), dev))
        if tuple(W.shape) != (self.num_tx, self.rank_used):
            raise ValueError(f"precoder {tuple(W.shape)}, expected "
                             f"{(self.num_tx, self.rank_used)}")
        return W

    def precode(self, bits: torch.Tensor, W: Optional[C] = None) -> C:
        """bits (..., S·nd·bps) -> precoded layer symbols per antenna,
        x[tx, ..., s, k] = Σ_l W[tx, l]·layers[..., s, l, k], (tx, ..., S, m):
        QAM, zero-pad to a multiple of the rank, round-robin layers, W. The
        antenna axis leads, so every antenna's plane is contiguous."""
        cfg, L = self.config, self.rank_used
        W = self._precoder(W)
        nd = grid_for(cfg).num_data
        lead = tuple(bits.shape[:-1])
        S = bits.shape[-1] // (nd * cfg.bits_per_symbol)
        syms = qam.modulate(bits, cfg.modulation).reshape(lead + (S, nd))
        syms = cplx.pad(syms, [(0, 0)] * (syms.ndim - 1) + [(0, L * self.m - nd)])
        layers = layer_mapper.map_to_layers(syms, L)               # (..., S, L, m)
        # a tiny (tx × L) contraction: a broadcast multiply-sum, W[tx, l]
        # against every (..., S, m) plane of layer l
        w = W.reshape((self.num_tx,) + (1,) * (layers.ndim - 2) + (L, 1))
        return (w * C(layers.re[None], layers.im[None])).sum(axis=-2)

    # -- the two channel implementations: each takes the precoded layer
    # symbols x (tx, ..., S, m) and their time symbols sig (tx, ..., S, N+cp)
    # and returns the received data bins (rx, ..., S, m), pilot bins
    # (rx, ..., S, n_pilot) and PAPR (...,)
    def _through_bins(self, x: C, sig: C, snr_db, generator, draws: dict):
        num_tx, num_rx = self.num_tx, self.num_rx
        lead = tuple(x.shape[1:-2])
        dev = x.re.device
        with span("modem.papr"):
            papr = ofdm.papr_db(sig, axis=(-2, -1)).mean(dim=0)
        S, n_pilot = x.shape[-2], self.pilot_vals_re.shape[-1]
        with span("channel.fading"):
            H = flat_mimo_matrix(num_rx, num_tx, lead, generator, dev, draws.get("fading"))
            # the pilot bins carry Σ_t H[r, t]·p_t, the same on every symbol
            Hr = H.transpose(H.ndim - 2, *range(H.ndim - 2), H.ndim - 1)   # (rx, ..., tx)
            y_pil = cplx.matmul_small(Hr, self._c("pilot_vals"))[..., None, :]
            y_pil = C(y_pil.re.expand((num_rx,) + lead + (S, n_pilot)),
                      y_pil.im.expand((num_rx,) + lead + (S, n_pilot)))
            y = []
            for r in range(num_rx):
                acc = None
                for t in range(num_tx):
                    term = C(H.re[..., r, t, None, None], H.im[..., r, t, None, None]) * x[t]
                    acc = term if acc is None else acc + term
                y.append(acc)
            y = cplx.stack(y, axis=0)

        with span("channel.awgn"):
            # P_rx[r] = Σ_{t1,t2} Re(H[r,t1]·H*[r,t2]·R[t1,t2]) with the Hermitian
            # R (..., tx, tx): the big passes run over the planes once per pair
            # t1 <= t2, the small (rx, tx, tx) contraction as one broadcast sum
            zero = torch.zeros(lead, dtype=torch.float32, device=dev)
            R = [[None] * num_tx for _ in range(num_tx)]
            for t1 in range(num_tx):
                R[t1][t1] = C(sig[t1].abs2().mean(dim=(-2, -1)), zero)
                for t2 in range(t1 + 1, num_tx):
                    R[t1][t2] = (sig[t1] * sig[t2].conj()).mean(axis=(-2, -1))
                    R[t2][t1] = R[t1][t2].conj()
            R = cplx.stack([cplx.stack(row, axis=-1) for row in R], axis=-2)  # (..., tx, tx)
            HH = C(H.re[..., :, None], H.im[..., :, None]) \
                * C(H.re[..., None, :], -H.im[..., None, :])           # (..., rx, tx, tx)
            p_rx = (HH * C(R.re[..., None, :, :], R.im[..., None, :, :])).re.sum(dim=(-2, -1))
            npow = p_rx.movedim(-1, 0) / snr_linear(snr_db, dev)       # (rx, ...)
            std = torch.sqrt(npow[..., None, None] / 2.0)
            noise = draws.get("noise") or (None, None)
            n_data = standard_normals((num_rx,) + lead + (S, self.m), generator, dev,
                                      noise[0], "data noise")
            n_pil = standard_normals((num_rx,) + lead + (S, n_pilot), generator, dev,
                                     noise[1], "pilot noise")
            return _add_cn(y, std, n_data), _add_cn(y_pil, std, n_pil), papr

    def _through_time(self, x: C, sig: C, snr_db, generator, draws: dict):
        lead = tuple(x.shape[1:-2])
        S = x.shape[-2]
        dev = x.re.device
        with span("modem.papr"):
            # each antenna's symbols lie end to end: the sample streams are a view
            signals_tx = sig.reshape(
                (self.num_tx,) + lead + (S * self.config.samples_per_ofdm_symbol,))
            papr = ofdm.papr_db(signals_tx, axis=-1).mean(dim=0)
        with span("channel.multipath" if self.channel_type == "rayleigh_mp"
                  else "channel.fading"):
            y, _H, npow = spatial_mix_noiseless(
                signals_tx, snr_db, self.num_rx, self.channel_type, self.profile, generator,
                draws.get("phases"), draws.get("fading"))           # (rx, ..., T)
        with span("modem.rx_dft"):
            yf = ofdm.frame_stream(y, self.config)               # (rx, ..., S, sps)
            y_data = ofdm.demodulate_bins(yf, self.config, None, self._c("demod_data"))
            y_pil = ofdm.demodulate_bins(yf, self.config, None, self._c("demod_pilot"))
        with span("channel.awgn"):
            # per-RX CN(0, P_rx/snr) at the demodulated bins: the DFT is unitary
            # and the detector sees only these bins
            std = torch.sqrt(npow[..., None, None] / 2.0)
            noise = draws.get("noise") or (None, None)
            n_data = standard_normals(y_data.shape, generator, dev, noise[0], "data noise")
            n_pil = standard_normals(y_pil.shape, generator, dev, noise[1], "pilot noise")
            return _add_cn(y_data, std, n_data), _add_cn(y_pil, std, n_pil), papr

    def _detect(self, y_data: C, h_tx: List[C], W: C, snr_db) -> C:
        """The layers' symbol estimates (..., S, m, L) from the received data
        bins (rx, ..., S, m) and the per-TX estimates."""
        L = self.rank_used
        dt = self.detector_type.upper()
        if dt == "SIC" and L in (1, 2, 3, 4):
            with span("detector.sic"):
                # σ² = 10^(-snr/10) against unit-power symbols, a float or one per lane;
                # the effective channel, the SIC stages and the decisions in one pass
                noise_var = _noise_var(snr_db, y_data.re.device)
                return sic_detect(y_data, h_tx, W, noise_var, self.config.modulation)
        if dt in PLANE_DETECTORS and L in (1, 2, 3, 4):
            with span("detector.heff"):
                noise_var = _noise_var(snr_db, y_data.re.device)
                heff = detector.effective_planes(h_tx, W)          # (rx, L, ..., S, m)
            with span("detector.mmse"):
                # ZF is the same regularized Gram solve with σ² -> ε
                s_planes = detector.mmse_planes(
                    [y_data[r] for r in range(self.num_rx)],
                    [[heff[r, l] for l in range(L)] for r in range(self.num_rx)],
                    1e-9 if dt == "ZF" else noise_var)
                return cplx.stack(s_planes, axis=-1)
        # MRC and the unbiased MMSE: the stacked (..., S, m, rx[, tx]) layout
        with span("detector.detect"):
            noise_var = _noise_var(snr_db, y_data.re.device)
            nr = y_data.ndim
            y_det = y_data.transpose(*range(1, nr), 0)            # (..., S, m, rx)
            h_det = cplx.stack(h_tx, axis=-1).transpose(*range(1, nr), 0, nr)
            return detector.detect(y_det, h_det, noise_var, self.detector_type, W,
                                   self.config.modulation)

    def forward(self, bits: torch.Tensor, snr_db, W=None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None) -> SpatialResult:
        draws = draws or {}
        cfg = self.config
        nd = grid_for(cfg).num_data
        lead = tuple(bits.shape[:-1])
        S = bits.shape[-1] // (nd * cfg.bits_per_symbol)
        with span("modem.tx"):
            W = self._precoder(W)                                # (tx, L)
            x = self.precode(bits, W)                            # (tx, ..., S, m)
            sig = ofdm.modulate_custom_multi(x, cfg, None, None, None,
                                             self.mod_tables)    # (tx, ..., S, sps)

        through = self._through_bins if self.channel_impl == "bins" else self._through_time
        y_data, y_pil, papr = through(x, sig, snr_db, generator, draws)

        # ---- per-symbol CRS estimation, all RX at once: [tx] planes of
        # (rx, ..., S, m) with the subcarrier axis minor ----
        with span("modem.estimate"):
            h_tx = estimate_per_tx_planes(y_pil, cfg, self.num_tx, self.data_bins,
                                          self.pilot_layout, self.per_tx)

        layers = self._detect(y_data, h_tx, W, snr_db)           # (..., S, m, L)
        with span("modem.demap"):
            # layer demap: the minor layer axis interleaves them into symbol order
            syms_rx = layers.reshape(lead + (S, self.m * self.rank_used))[..., :nd]
            bits_rx = qam.demodulate(syms_rx.reshape(lead + (S * nd,)), cfg.modulation)
        with span("link.errors"):
            bits_rx = bits_rx.to(bits.dtype)
            errors = (bits_rx != bits).sum(dim=-1, dtype=torch.int32)
            ber = errors / bits.shape[-1]
        return SpatialResult(bits_rx, errors, ber, syms_rx, papr)


def _noise_var(snr_db, device):
    """σ² = 10^(-snr/10): a float for a scalar SNR, else one value per lane."""
    return snr_linear(-snr_db if isinstance(snr_db, torch.Tensor)
                      else -np.asarray(snr_db, np.float32), device)


def simulate_spatial_multiplexing(bits: torch.Tensor, snr_db,
                                  config: Optional[LTEConfig] = None, num_tx: int = 4,
                                  num_rx: int = 2, rank="adaptive",
                                  detector_type: str = "MMSE",
                                  modulation: Optional[str] = None,
                                  channel_type: str = "awgn",
                                  itu_profile: str = "Pedestrian_A",
                                  velocity_kmh: float = 3.0, frequency_ghz: float = 2.0,
                                  seed: int = 0, pilot_layout: str = "reference",
                                  generator: Optional[torch.Generator] = None, device=None,
                                  draws: Optional[dict] = None) -> SpatialResult:
    """One TM4 Monte-Carlo step. rank="adaptive" decides rank and PMI from
    the mean SNR and `seed` (decide_rank_pmi); a fixed rank uses PMI 0.
    pilot_layout="extended" gives every TX its own CRS comb (beyond 4 TX the
    reference layout's combs collide pairwise); identical to "reference" up
    to 4 TX. Runs on `device`: the CUDA card when none is given. `draws`:
    see SpatialLink."""
    if config is None:
        config = LTEConfig(modulation=modulation or "64-QAM")
    if rank == "adaptive":
        # the rank decision needs one concrete SNR: shapes depend on it
        snr_host = snr_db.detach().cpu().numpy() if isinstance(snr_db, torch.Tensor) else snr_db
        snr_static = float(np.asarray(snr_host).mean())
    else:
        snr_static = 0.0       # unused for a fixed rank
    rank_used, _pmi, W = decide_rank_pmi(num_tx, num_rx, snr_static, rank, seed)
    link = cached_link(SpatialLink, config, num_tx, num_rx, rank_used, detector_type,
                       resolve_device(device), channel_type, pilot_layout,
                       _channel_impl(channel_type), itu_profile, velocity_kmh, frequency_ghz)
    bits = bits.to(link.mod_b_re.device)
    return link(bits, snr_db, W=W, generator=generator, draws=draws)
