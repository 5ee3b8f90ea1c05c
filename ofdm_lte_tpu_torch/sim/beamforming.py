"""TM6/TM4 rank-1 codebook beamforming with CSI feedback.

Port of ofdm_lte_tpu/sim/beamforming.py, both of its simulations in one
link object:

- channel_model "static": one flat H ~ CN(0, 1) per lane for the whole
  call, so the feedback loop over OFDM symbols collapses to one PMI and
  every symbol goes through one batched op;
- channel_model "jakes": H over time, flat_mimo_time_varying (one sample a
  symbol, one complex GEMM through the hand-written kernel on a card), W
  recomputed from the current H every `update_period` symbols and held,
  stale, in between.

Both run the frequency-domain link y = H·(W s) + n per data subcarrier (no
IFFT or CP, so no PAPR), with the noise variance ABSOLUTE, 10^(−snr/10),
not measured signal power. W is MRT under update_mode "adaptive" and the
PMI feedback's codeword under "static"/"codebook". The receiver combines
by MRC with the true effective channel H_eff = HW, normalized by Σ|H_eff|².

The link asks the feedback only for what it returns: the PMI and W, through
mimo.codebook.select_best_pmi and precoder_for_pmi on its own codebook
buffer. CQI and RI (mimo.csi.generate_feedback, which runs an eigensolver)
are not made: under jit the JAX package drops them, and here they would
cost a cuSOLVER call and a host sync a step. The update instants are
strided slices and the hold a broadcast, so `forward` makes no index
tensor and no host sync.

`BeamformingLink` is an nn.Module with its codebook as a buffer;
`simulate_beamforming` and `simulate_beamforming_time_varying` are the
functional forms, which keep the link of their arguments (sim.links). All
run on the CUDA card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import cplx
from ..channel.awgn import snr_linear, standard_normals
from ..channel.rayleigh import flat_mimo_matrix, flat_mimo_time_varying
from ..config import LTEConfig
from ..cplx import C
from ..device import resolve_device
from ..grid import grid_for
from ..mimo import beamforming as bf
from ..mimo import codebook as cb
from ..ops import qam
from .links import cached_link

CHANNEL_MODELS = ("static", "jakes")
UPDATE_MODES = ("adaptive", "static", "codebook")


class BeamformingResult(NamedTuple):
    bits_rx: torch.Tensor
    bit_errors: torch.Tensor
    ber: torch.Tensor
    beamforming_gain_db: torch.Tensor
    pmi: torch.Tensor
    symbols_rx: C


class TimeVaryingBeamformingResult(NamedTuple):
    bits_rx: torch.Tensor
    bit_errors: torch.Tensor
    ber: torch.Tensor
    beamforming_gain_db: torch.Tensor       # (...,) mean realized gain
    gain_history_db: torch.Tensor           # (..., S) per-symbol realized gain
    pmi_history: torch.Tensor               # (..., S) int32, per OFDM symbol
    update_period: int                      # W recompute cadence (symbols)
    symbols_rx: C


def bits_per_frame(config: LTEConfig, num_ofdm_symbols: int) -> int:
    return grid_for(config).num_data * config.bits_per_symbol * num_ofdm_symbols


def _hold(x: torch.Tensor, period: int, S: int, axis: int) -> torch.Tensor:
    """Repeat each entry along `axis` `period` times and keep the first S:
    x[..., u, ...] stands for symbols u·period .. u·period + period − 1."""
    axis = axis % x.ndim
    x = x.unsqueeze(axis + 1)
    shape = list(x.shape)
    shape[axis + 1] = period
    x = x.expand(shape).flatten(axis, axis + 1)
    return x.narrow(axis, 0, S)


def _noise_std(snr_db, device, trailing: int):
    """√(σ²/2) of the absolute noise variance σ² = 10^(−snr/10): a Python
    float for a scalar SNR, else one per lane, shaped to align against
    `trailing` axes after the lanes."""
    if isinstance(snr_db, torch.Tensor):
        nv = snr_linear(-snr_db.to(torch.float32), device)
    else:
        nv = snr_linear(-np.asarray(snr_db, np.float32), device)
    if not isinstance(nv, torch.Tensor):
        return float(np.sqrt(np.float32(nv) / np.float32(2.0)))
    std = torch.sqrt(nv / 2.0)
    return std.reshape(tuple(std.shape) + (1,) * trailing)


class BeamformingLink(nn.Module):
    """The num_tx×num_rx rank-1 beamforming link of one LTEConfig, codebook,
    update mode and channel model.

    forward(bits, snr_db, generator=None, draws=None) -> BeamformingResult
    ("static") or TimeVaryingBeamformingResult ("jakes"). bits (lanes...,
    S·nd·bps), nd the data bins a symbol; snr_db a scalar or one value per
    lane. `draws` carries the seams by name, each replacing the generator's
    draws (drawn in this order):

    - "H" (static): (re, im) standard normals of H, (lanes..., num_rx,
      num_tx); H is them over √2;
    - "phases" (jakes): the Jakes phases, (16, lanes·num_rx·num_tx), the
      links in (lane, rx, tx) order, as flat_mimo_time_varying takes them;
    - "noise": (re, im) standard normals, (lanes..., num_rx, S·nd) for the
      static channel and (lanes..., S, num_rx, nd) for the Jakes one.
    """

    def __init__(self, config: LTEConfig, num_tx: int = 2, num_rx: int = 1,
                 codebook_type: str = "TM6", update_mode: str = "adaptive",
                 channel_model: str = "static", update_period: int = 1,
                 doppler_hz: float = 5.56, device=None):
        super().__init__()
        if channel_model not in CHANNEL_MODELS:
            raise ValueError(f"unknown channel_model {channel_model!r}; pick from "
                             f"{CHANNEL_MODELS}")
        if update_mode not in UPDATE_MODES:
            raise ValueError(f"unknown update_mode {update_mode!r}; pick from {UPDATE_MODES}")
        device = resolve_device(device)
        self.config = config
        self.num_tx, self.num_rx = int(num_tx), int(num_rx)
        self.codebook_type, self.update_mode = codebook_type, update_mode
        self.channel_model = channel_model
        self.update_period = max(1, int(update_period))
        self.doppler_hz = float(doppler_hz)
        table = cplx.const(cb.codebook(num_tx, codebook_type, 1), device)   # (P, tx, 1)
        self.register_buffer("codebook_re", table.re)
        self.register_buffer("codebook_im", table.im)

    @property
    def codebook(self) -> C:
        return C(self.codebook_re, self.codebook_im)

    def feedback(self, H: C):
        """(pmi (...,), W (..., tx, 1)) for H (..., rx, tx): the PMI always
        (it is returned), W by MRT or from the PMI."""
        pmi, _ = cb.select_best_pmi(H, self.num_tx, self.codebook_type, 1, "capacity",
                                    table=self.codebook)
        if self.update_mode == "adaptive":
            return pmi, bf.mrt_weights(H)
        return pmi, cb.precoder_for_pmi(pmi, self.num_tx, self.codebook_type, 1,
                                        table=self.codebook)

    def _detect(self, He: C, syms: C, snr_db, generator, noise, trailing: int) -> C:
        """y = He·s + n over the RX axis (-2), then MRC: Σ_rx conj(He)·y / Σ|He|²."""
        y = He * syms
        n = standard_normals(y.shape, generator, y.re.device, noise, "noise")
        std = _noise_std(snr_db, y.re.device, trailing)
        y = C(y.re + n.re * std, y.im + n.im * std)
        num = (He.conj() * y).sum(axis=-2)
        den = He.abs2().sum(dim=(-2, -1))[..., None]
        return C(num.re / den, num.im / den)

    def forward(self, bits: torch.Tensor, snr_db, generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        draws = draws or {}
        cfg = self.config
        dev = self.codebook_re.device
        lead = tuple(bits.shape[:-1])
        syms = qam.modulate(bits, cfg.modulation)                     # (..., S·nd)
        if self.channel_model == "static":
            H = flat_mimo_matrix(self.num_rx, self.num_tx, lead, generator, dev,
                                 draws.get("H"))                      # (..., rx, tx)
            pmi, W = self.feedback(H)
            He = cplx.matmul_small(H, W)                              # (..., rx, 1)
            s_hat = self._detect(He, C(syms.re[..., None, :], syms.im[..., None, :]),
                                 snr_db, generator, draws.get("noise"), 2)
            bits_rx = qam.demodulate(s_hat, cfg.modulation).to(bits.dtype)
            errors = (bits_rx != bits).sum(dim=-1, dtype=torch.int32)
            return BeamformingResult(bits_rx, errors, errors / bits.shape[-1],
                                     bf.beamforming_gain_db(H, W, He), pmi, s_hat)

        nd, period = grid_for(cfg).num_data, self.update_period
        S = bits.shape[-1] // (nd * cfg.bits_per_symbol)
        H = flat_mimo_time_varying(self.num_rx, self.num_tx, S, self.doppler_hz,
                                   batch_shape=lead, generator=generator, device=dev,
                                   phases=draws.get("phases"))        # (..., S, rx, tx)
        # feedback at the update instants u·period only, W held in between
        pmi_up, W_up = self.feedback(H[..., ::period, :, :])          # (..., U), (..., U, tx, 1)
        ax = len(lead)
        W = C(_hold(W_up.re, period, S, ax), _hold(W_up.im, period, S, ax))
        pmi_history = _hold(pmi_up, period, S, ax)                    # (..., S)
        He = cplx.matmul_small(H, W)                                  # (..., S, rx, 1)
        gain_hist = bf.beamforming_gain_db(H, W, He)                  # (..., S)
        s_hat = self._detect(He, syms.reshape(lead + (S, 1, nd)), snr_db, generator,
                             draws.get("noise"), 3)
        s_hat = s_hat.reshape(lead + (S * nd,))
        bits_rx = qam.demodulate(s_hat, cfg.modulation).to(bits.dtype)
        errors = (bits_rx != bits).sum(dim=-1, dtype=torch.int32)
        return TimeVaryingBeamformingResult(
            bits_rx, errors, errors / bits.shape[-1], gain_hist.mean(dim=-1), gain_hist,
            pmi_history, period, s_hat)


def link_for(config: LTEConfig, num_tx: int = 2, num_rx: int = 1, codebook_type: str = "TM6",
             update_mode: str = "adaptive", channel_model: str = "static",
             update_period: int = 1, doppler_hz: float = 5.56, device=None) -> BeamformingLink:
    """The kept link of these arguments (sim.links), on `device`: the CUDA
    card when none is given. The static channel has no update period and
    no Doppler, so those two do not tell its links apart."""
    if channel_model == "static":
        update_period, doppler_hz = 1, 5.56
    return cached_link(BeamformingLink, config, num_tx, num_rx, codebook_type, update_mode,
                       channel_model, int(update_period), float(doppler_hz),
                       resolve_device(device))


def simulate_beamforming(bits: torch.Tensor, snr_db, config: LTEConfig, num_tx: int = 2,
                         num_rx: int = 1, codebook_type: str = "TM6",
                         update_mode: str = "adaptive",
                         generator: Optional[torch.Generator] = None, device=None,
                         draws: Optional[dict] = None) -> BeamformingResult:
    """One beamforming step over the static flat channel; bits (..., S·nd·bps),
    the leading axes Monte-Carlo lanes. Runs on `device`: the CUDA card when
    none is given. `draws`: see BeamformingLink."""
    link = link_for(config, num_tx, num_rx, codebook_type, update_mode, device=device)
    return link(bits.to(link.codebook_re.device), snr_db, generator=generator, draws=draws)


def simulate_beamforming_time_varying(
        bits: torch.Tensor, snr_db, config: LTEConfig, num_tx: int = 2, num_rx: int = 1,
        codebook_type: str = "TM6", update_mode: str = "adaptive", update_period: int = 1,
        doppler_hz: float = 5.56, generator: Optional[torch.Generator] = None, device=None,
        draws: Optional[dict] = None) -> TimeVaryingBeamformingResult:
    """Beamforming over the Jakes time-varying flat MIMO channel with W
    recomputed every `update_period` symbols (derive it with
    mimo.beamforming.update_period_symbols(velocity) and `doppler_hz` with
    config.doppler_hz(velocity)). Between updates W is stale: at high
    Doppler the realized gain ‖H(t)W(t₀)‖² decays toward the unprecoded
    average. Runs on `device`: the CUDA card when none is given."""
    link = link_for(config, num_tx, num_rx, codebook_type, update_mode, "jakes", update_period,
                    doppler_hz, device)
    return link(bits.to(link.codebook_re.device), snr_db, generator=generator, draws=draws)
