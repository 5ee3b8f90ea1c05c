"""High-level object API: the SISO surface of ofdm_lte_tpu/api.py.

OFDMSimulator.simulate_siso and OFDMModule.transmit take and return NumPy
and the same dict keys as the JAX package. Randomness comes from one
`torch.Generator` per simulator, seeded from `seed` on `device`; the
link's tables live on `device` in a SisoLink. The other methods of the
JAX package's facade wait for their slices (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import LTEConfig
from .ops import qam
from .sim import siso as _siso
from .utils import metrics as _metrics


class OFDMSimulator:
    """Seeded simulator for one LTEConfig on one device."""

    def __init__(self, config: Optional[LTEConfig] = None,
                 channel_type: str = "awgn", mode: str = "lte",
                 enable_sc_fdm: bool = False, seed: int = 0, device=None):
        self.config = config or LTEConfig()
        self.channel_type = channel_type
        self.mode = "sc-fdm" if enable_sc_fdm else mode
        self.enable_sc_fdm = enable_sc_fdm or mode == "sc-fdm"
        self.device = torch.device(device if device is not None else "cpu")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.link = _siso.SisoLink(self.config, device=self.device)
        self.last_results = None

    @staticmethod
    def _trim(bits_rx: np.ndarray, n: int) -> np.ndarray:
        if len(bits_rx) < n:
            return np.pad(bits_rx, (0, n - len(bits_rx)))
        return bits_rx[:n]

    def simulate_siso(self, bits: np.ndarray, snr_db: float = 10.0) -> Dict:
        _siso._check_branch(self.mode, self.channel_type, True)
        bits = np.asarray(bits).astype(np.int32)
        n = len(bits)
        padded = torch.as_tensor(_siso.pad_bits(bits, self.config, self.mode),
                                 device=self.device)
        r = self.link(padded, float(snr_db), generator=self.generator)
        bits_rx = self._trim(r.bits_rx.cpu().numpy(), n)
        errors = int(np.sum(bits_rx != bits))
        papr = float(r.papr_db)
        res = {
            "transmitted_bits": n, "received_bits": n,
            "bits_received_array": bits_rx,
            "bit_errors": errors, "errors": errors, "ber": errors / n,
            "snr_db": float(snr_db),
            "papr_db": papr,
            "papr_linear": float(10 ** (papr / 10)),
            "pilot_snr_db": float(r.pilot_snr_db),
            "evm_percent": _metrics.evm_percent(
                qam.detect(r.symbols_rx, self.config.modulation), r.symbols_rx),
            "symbols_rx": r.symbols_rx.to_numpy().reshape(-1),
            "signal_tx": r.signal_tx.to_numpy(),
        }
        self.last_results = res
        return res


class OFDMModule:
    """Backward-compatible facade over OFDMSimulator."""

    def __init__(self, config: Optional[LTEConfig] = None,
                 channel_type: str = "awgn", mode: str = "lte",
                 enable_sc_fdm: bool = False, seed: int = 0, device=None):
        self.config = config or LTEConfig()
        self.simulator = OFDMSimulator(self.config, channel_type=channel_type,
                                       mode=mode, enable_sc_fdm=enable_sc_fdm,
                                       seed=seed, device=device)

    @property
    def modulation(self):
        return self.config.modulation

    @property
    def bandwidth(self):
        return self.config.bandwidth

    def transmit(self, bits: np.ndarray, snr_db: float = 10.0) -> Dict:
        return self.simulator.simulate_siso(bits, snr_db)
