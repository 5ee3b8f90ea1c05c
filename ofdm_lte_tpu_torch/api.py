"""High-level object API: the facade of ofdm_lte_tpu/api.py.

OFDMSimulator.simulate_{siso, simo, miso, mimo, spatial_multiplexing,
beamforming}, run_ber_sweep and run_ber_sweep_all_modulations,
OFDMModule.transmit / run_ber_sweep and the create_simulator presets take
and return NumPy and the same dict keys as the JAX package. Randomness
comes from one `torch.Generator` per simulator, seeded from `seed` on
`device`. A simulator builds one link per
(pipeline, antennas, rank, detector) on first use and keeps it, tables on
`device`; the coded methods use the kept link of their transport-block
size (sim.coded.link_for). With no `device` given the objects run on the
CUDA card and raise where there is none (device.resolve_device);
`device="cpu"` asks for the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import MODULATION_SCHEMES, LTEConfig
from .config import doppler_hz as _doppler_hz
from .device import resolve_device
from .mimo import beamforming as _bfp
from .mimo import csi as _csi
from .ops import qam
from .sim import beamforming as _bf
from .sim import coded as _coded
from .sim import diversity as _div
from .sim import siso as _siso
from .sim import spatial as _spatial
from .utils import metrics as _metrics


class OFDMSimulator:
    """Seeded simulator for one LTEConfig on one device."""

    def __init__(self, config: Optional[LTEConfig] = None,
                 channel_type: str = "awgn", mode: str = "lte",
                 enable_sc_fdm: bool = False, itu_profile: str = "Pedestrian_A",
                 frequency_ghz: float = 2.0, velocity_kmh: float = 0.0,
                 seed: int = 0, device=None):
        self.config = config or LTEConfig()
        self.channel_type = channel_type
        self.mode = "sc-fdm" if enable_sc_fdm else mode
        self.enable_sc_fdm = enable_sc_fdm or mode == "sc-fdm"
        self.itu_profile = itu_profile
        self.frequency_ghz = frequency_ghz
        self.velocity_kmh = velocity_kmh if velocity_kmh else None
        _siso.check_branch(self.mode, channel_type)
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._links = {}
        self.last_results = None

    # -- internals ---------------------------------------------------------
    def _chan_kwargs(self):
        return dict(channel_type=self.channel_type, itu_profile=self.itu_profile,
                    velocity_kmh=self.velocity_kmh, frequency_ghz=self.frequency_ghz)

    def _link(self, pipeline: str, num_rx: int = 1):
        """The link of one (pipeline, num_rx), built on first use."""
        key = (pipeline, num_rx)
        if key not in self._links:
            if pipeline == "siso":
                link = _siso.SisoLink(self.config, self.device, mode=self.mode,
                                      **self._chan_kwargs())
            elif pipeline == "simo":
                link = _div.SimoLink(self.config, num_rx, self.device, **self._chan_kwargs())
            else:
                link = _div.SfbcLink(self.config, num_rx, self.device, **self._chan_kwargs())
            self._links[key] = link
        return self._links[key]

    @property
    def link(self) -> _siso.SisoLink:
        return self._link("siso")

    @staticmethod
    def _trim(bits_rx: np.ndarray, n: int) -> np.ndarray:
        if len(bits_rx) < n:
            return np.pad(bits_rx, (0, n - len(bits_rx)))
        return bits_rx[:n]

    def _run(self, link, bits: np.ndarray, per_symbol: int, snr_db: float, **link_kw):
        """Pad to whole OFDM symbols, run one step, count errors on the host."""
        n = len(bits)
        padded = np.zeros(int(np.ceil(n / per_symbol)) * per_symbol, np.int32)
        padded[:n] = bits
        r = link(torch.as_tensor(padded, device=self.device), float(snr_db),
                 generator=self.generator, **link_kw)
        bits_rx = self._trim(r.bits_rx.cpu().numpy(), n)
        errors = int(np.sum(bits_rx != bits))
        res = {"transmitted_bits": n, "received_bits": n,
               "bits_received_array": bits_rx, "bit_errors": errors,
               "errors": errors, "ber": errors / n, "snr_db": float(snr_db)}
        if hasattr(r, "papr_db"):            # the beamforming link makes no time signal
            res["papr_db"] = float(r.papr_db)
        return r, res

    # -- SISO --------------------------------------------------------------
    def simulate_siso(self, bits: np.ndarray, snr_db: float = 10.0) -> Dict:
        bits = np.asarray(bits).astype(np.int32)
        r, res = self._run(self.link, bits,
                           _siso.bits_per_frame(self.config, 1, self.mode), snr_db)
        res.update({
            "papr_linear": float(10 ** (res["papr_db"] / 10)),
            "pilot_snr_db": float(r.pilot_snr_db),
            "evm_percent": _metrics.evm_percent(
                qam.detect(r.symbols_rx, self.config.modulation), r.symbols_rx),
            "symbols_rx": r.symbols_rx.to_numpy().reshape(-1),
            "signal_tx": r.signal_tx.to_numpy(),
        })
        self.last_results = res
        return res

    # -- SIMO / MISO / MIMO ------------------------------------------------
    def simulate_simo(self, bits: np.ndarray, snr_db: float = 10.0,
                      num_rx: int = 2, combining: str = "mrc") -> Dict:
        bits = np.asarray(bits).astype(np.int32)
        _, res = self._run(self._link("simo", num_rx), bits,
                           _siso.bits_per_frame(self.config, 1), snr_db)
        res.update({"num_rx": num_rx, "combining_method": combining,
                    "diversity_level": num_rx})
        self.last_results = res
        return res

    def _simulate_sfbc(self, bits, snr_db, num_rx) -> Dict:
        bits = np.asarray(bits).astype(np.int32)
        _, res = self._run(self._link("sfbc", num_rx), bits,
                           _div.sfbc_bits_per_frame(self.config, 1), snr_db)
        res.update({"num_tx": 2, "num_rx": num_rx,
                    "mode": "MISO-SFBC" if num_rx == 1 else "MIMO-SFBC",
                    "diversity_order": 2 * num_rx})
        self.last_results = res
        return res

    def simulate_miso(self, bits: np.ndarray, snr_db: float = 10.0) -> Dict:
        return self._simulate_sfbc(bits, snr_db, num_rx=1)

    def simulate_mimo(self, bits: np.ndarray, snr_db: float = 10.0,
                      num_rx: int = 2) -> Dict:
        return self._simulate_sfbc(bits, snr_db, num_rx=num_rx)

    # -- TM4 spatial multiplexing -------------------------------------------
    def simulate_spatial_multiplexing(self, bits: np.ndarray, snr_db: float = 15.0,
                                      num_tx: int = 4, num_rx: int = 2, rank="adaptive",
                                      detector_type: str = "MMSE") -> Dict:
        """One TM4 step: flat iid fading per link unless the simulator's
        channel is "rayleigh_mp"; rank="adaptive" decides rank and PMI from
        snr_db (sim.spatial.decide_rank_pmi)."""
        bits = np.asarray(bits).astype(np.int32)
        channel = self.channel_type if self.channel_type == "rayleigh_mp" else "awgn"
        rank_used, _pmi, W = _spatial.decide_rank_pmi(num_tx, num_rx, float(snr_db), rank)
        key = ("spatial", num_tx, num_rx, rank_used, detector_type)
        if key not in self._links:
            self._links[key] = _spatial.SpatialLink(
                self.config, num_tx, num_rx, rank_used, detector_type, self.device,
                channel_type=channel, itu_profile=self.itu_profile,
                velocity_kmh=self.velocity_kmh or 3.0, frequency_ghz=self.frequency_ghz)
        _, res = self._run(self._links[key], bits, _spatial.bits_per_frame(self.config, 1),
                           snr_db, W=W)
        res.update({"num_tx": num_tx, "num_rx": num_rx, "detector_type": detector_type,
                    "mode": "Spatial Multiplexing TM4"})
        self.last_results = res
        return res

    # -- TM6/TM4 beamforming with CSI feedback -------------------------------
    def simulate_beamforming(self, bits: np.ndarray, snr_db: float = 10.0,
                             num_tx: int = 2, num_rx: int = 1,
                             codebook_type: str = "TM6", velocity_kmh: float = 3.0,
                             update_mode: str = "adaptive",
                             channel_model: str = "static") -> Dict:
        """channel_model "static": one constant H per call, so the
        per-symbol PMI history is S equal entries; "jakes": a time-varying
        channel with W recomputed every update_period_symbols(velocity)
        symbols (sim.beamforming.BeamformingLink)."""
        if channel_model not in _bf.CHANNEL_MODELS:
            raise ValueError(f"unknown channel_model {channel_model!r}")
        bits = np.asarray(bits).astype(np.int32)
        per = _bf.bits_per_frame(self.config, 1)
        S = -(-len(bits) // per)
        if channel_model == "jakes":
            period = _bfp.update_period_symbols(velocity_kmh, self.frequency_ghz)
            doppler = float(_doppler_hz(velocity_kmh, self.frequency_ghz))
        else:
            period, doppler = 1, 5.56
        key = ("beamforming", num_tx, num_rx, codebook_type, update_mode, channel_model,
               period, doppler)
        if key not in self._links:
            self._links[key] = _bf.BeamformingLink(self.config, num_tx, num_rx, codebook_type,
                                                   update_mode, channel_model, period, doppler,
                                                   self.device)
        r, res = self._run(self._links[key], bits, per, snr_db)
        extra = {}
        if channel_model == "jakes":
            pmi_history = [int(p) for p in r.pmi_history.cpu().numpy()]
            extra = {"update_period_symbols": int(r.update_period),
                     "gain_history_db": r.gain_history_db.cpu().numpy()}
        else:
            # a constant H: the per-symbol feedback logs one PMI S times
            pmi_history = [int(r.pmi)] * S
        stats = _csi.pmi_statistics(pmi_history, num_tx, codebook_type)
        res.update({
            "num_tx": num_tx, "num_rx": num_rx, "mode": "Beamforming",
            "codebook_type": codebook_type,
            "beamforming_gain_db": float(r.beamforming_gain_db),
            "pmi_history": pmi_history,
            "unique_pmis": stats["unique_pmis"],
            "pmi_statistics": stats,
            "velocity_kmh": velocity_kmh,
            **extra,
        })
        self.last_results = res
        return res

    # -- turbo-coded SISO --------------------------------------------------
    def _coded_kwargs(self):
        return dict(channel_type=self.channel_type, itu_profile=self.itu_profile,
                    velocity_kmh=self.velocity_kmh, generator=self.generator,
                    device=self.device)

    def simulate_siso_coded(self, bits: np.ndarray, snr_db: float = 10.0,
                            use_max_log: Optional[bool] = None, rv: int = 0) -> Dict:
        """One transport block through the TS 36.212 chain (sim.coded.
        simulate_siso_coded). use_max_log: None follows coding.turbo.
        USE_MAX_LOG_MAP, False is exact log-MAP; rv the redundancy version."""
        r = _coded.simulate_siso_coded(bits, float(snr_db), self.config, use_max_log=use_max_log,
                                       rv=rv, **self._coded_kwargs())
        res = {
            "transmitted_bits": len(bits), "received_bits": len(bits),
            "bits_received_array": r.bits_rx,
            "bit_errors": r.bit_errors, "ber": r.ber,
            "crc_pass": r.crc_pass, "snr_db": float(snr_db),
            "papr_db": r.papr_db, "coded_bits_length": r.coded_bits_length,
            "channel_snr_db": r.channel_snr_db,
        }
        self.last_results = res
        return res

    def simulate_siso_coded_harq(self, bits: np.ndarray, snr_db: float = 10.0,
                                 rv_sequence=(0, 1, 2, 3),
                                 use_max_log: Optional[bool] = None) -> Dict:
        """HARQ retransmissions with LLR chase combining across redundancy
        versions until CRC-24A passes (sim.coded.simulate_siso_coded_harq)."""
        r = _coded.simulate_siso_coded_harq(bits, float(snr_db), self.config,
                                            rv_sequence=tuple(rv_sequence),
                                            use_max_log=use_max_log, **self._coded_kwargs())
        res = {
            "transmitted_bits": len(bits), "received_bits": len(bits),
            "bits_received_array": r.bits_rx,
            "bit_errors": r.bit_errors, "ber": r.ber,
            "crc_pass": r.crc_pass, "snr_db": float(snr_db),
            "num_transmissions": r.num_transmissions,
            "rv_history": list(r.rv_history),
            "crc_history": list(r.crc_history),
        }
        self.last_results = res
        return res

    # -- sweeps ------------------------------------------------------------
    def run_ber_sweep(self, bits: np.ndarray, snr_range, num_trials: int = 1,
                      progress_callback=None, confidence: float = 0.95) -> Dict:
        """Sequential sweep of simulate_siso with per-point t-distribution
        confidence intervals over the trials."""
        snr_list = list(snr_range)
        snrs, bers, paprs, ci_lo, ci_hi = [], [], [], [], []
        for i, snr in enumerate(snr_list):
            trial_bers = []
            papr = 0.0
            for _ in range(num_trials):
                r = self.simulate_siso(bits, snr_db=float(snr))
                trial_bers.append(r["ber"])
                papr = r["papr_db"]
            m, lo, hi = _metrics.ber_confidence_interval(trial_bers, confidence)
            snrs.append(float(snr))
            bers.append(m)
            ci_lo.append(lo)
            ci_hi.append(hi)
            paprs.append(papr)
            if progress_callback:
                progress_callback(i + 1, len(snr_list))
        return {"snr_values": np.asarray(snrs), "ber_values": np.asarray(bers),
                "ber_ci_low": np.asarray(ci_lo), "ber_ci_high": np.asarray(ci_hi),
                "papr_values": np.asarray(paprs)}

    def run_ber_sweep_all_modulations(self, bits: np.ndarray, snr_range,
                                      num_trials: int = 1) -> Dict:
        """Sweep every modulation scheme, with a fresh simulator per scheme."""
        out = {}
        for mod in MODULATION_SCHEMES:
            sim = OFDMSimulator(self.config.copy(modulation=mod),
                                channel_type=self.channel_type, mode=self.mode,
                                enable_sc_fdm=self.enable_sc_fdm,
                                itu_profile=self.itu_profile,
                                velocity_kmh=self.velocity_kmh or 0.0,
                                device=self.device)
            out[mod] = sim.run_ber_sweep(bits, snr_range, num_trials)
        return out


class OFDMModule:
    """Backward-compatible facade over OFDMSimulator."""

    def __init__(self, config: Optional[LTEConfig] = None,
                 channel_type: str = "awgn", mode: str = "lte",
                 enable_sc_fdm: bool = False, seed: int = 0, **kw):
        self.config = config or LTEConfig()
        self.simulator = OFDMSimulator(self.config, channel_type=channel_type,
                                       mode=mode, enable_sc_fdm=enable_sc_fdm,
                                       seed=seed, **kw)

    @property
    def modulation(self):
        return self.config.modulation

    @property
    def bandwidth(self):
        return self.config.bandwidth

    def transmit(self, bits: np.ndarray, snr_db: float = 10.0) -> Dict:
        return self.simulator.simulate_siso(bits, snr_db)

    def run_ber_sweep(self, bits, snr_range, num_trials: int = 1,
                      progress_callback=None) -> Dict:
        return self.simulator.run_ber_sweep(bits, snr_range, num_trials, progress_callback)


def create_simulator(preset: str = "5MHz_QPSK", **kw) -> OFDMSimulator:
    """Preset factory."""
    presets = {
        "5MHz_QPSK": LTEConfig(5.0, modulation="QPSK"),
        "10MHz_16QAM": LTEConfig(10.0, modulation="16-QAM"),
        "10MHz_64QAM": LTEConfig(10.0, modulation="64-QAM"),
        "20MHz_16QAM": LTEConfig(20.0, modulation="16-QAM"),
        "20MHz_64QAM": LTEConfig(20.0, modulation="64-QAM"),
    }
    if preset not in presets:
        raise ValueError(f"Unknown preset {preset}. Options: {list(presets)}")
    return OFDMSimulator(presets[preset], **kw)
