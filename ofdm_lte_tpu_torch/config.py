"""Static LTE configuration: a NumPy-only copy of ofdm_lte_tpu/config.py.

The port imports nothing of the JAX package, so the numerology is copied
here; tests/test_torch_tables.py holds every field equal to the JAX
package's for all six bandwidths and three modulations.

- LTE profiles (BW -> (Nc, N)), CP durations (µs), derived fs, Ts,
  cp_length and bits per symbol, exactly as ofdm_lte_tpu.config.LTEConfig.
- ITU-R M.1225 power-delay profiles, their default velocities and the
  Doppler shift.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LTE_PROFILES = {
    1.25: (76, 128),
    2.5: (150, 256),
    5.0: (300, 512),
    10.0: (600, 1024),
    15.0: (900, 2048),
    20.0: (1200, 2048),
}

CP_VALUES_US = {
    "normal": 4.7,
    "extended_15khz": 16.6,
    "extended_7.5khz": 33.0,
}

MODULATION_SCHEMES = ("QPSK", "16-QAM", "64-QAM")

BITS_PER_SYMBOL = {"QPSK": 2, "16-QAM": 4, "64-QAM": 6}

# ITU-R M.1225 tapped delay line profiles (delays in µs, tap power in dB).
ITU_CHANNEL_MODELS = {
    "Pedestrian_A": {
        "delays_us": (0.0, 0.11, 0.19, 0.41),
        "power_db": (0.0, -9.7, -19.2, -22.8),
    },
    "Pedestrian_B": {
        "delays_us": (0.0, 0.2, 0.8, 1.2, 2.3, 3.7),
        "power_db": (0.0, -0.9, -4.9, -8.0, -7.8, -23.9),
    },
    "Vehicular_A": {
        "delays_us": (0.0, 0.31, 0.71, 1.09, 1.73, 2.51),
        "power_db": (0.0, -1.0, -9.0, -10.0, -15.0, -20.0),
    },
    "Vehicular_B": {
        "delays_us": (0.0, 0.3, 0.7, 1.09, 1.73, 2.51, 3.7, 4.53),
        "power_db": (0.0, -1.0, -9.0, -10.0, -13.0, -16.0, -21.6, -24.0),
    },
    "Bad_Urban": {
        "delays_us": (0.0, 0.1, 0.3, 0.5, 0.9, 1.3, 1.9, 2.6),
        "power_db": (0.0, -3.0, -5.0, -7.0, -9.0, -11.0, -13.0, -15.0),
    },
}

# Default mobile velocity per ITU profile (km/h), from which the Doppler
# frequency follows when none is given.
ITU_DEFAULT_VELOCITY_KMH = {
    "Pedestrian_A": 5.0,
    "Pedestrian_B": 5.0,
    "Vehicular_A": 30.0,
    "Vehicular_B": 120.0,
    "Bad_Urban": 10.0,
}


def _next_power_of_2(x: int) -> int:
    return int(2 ** np.ceil(np.log2(x)))


@dataclasses.dataclass(frozen=True)
class LTEConfig:
    """Frozen, hashable LTE numerology."""

    bandwidth: float = 5.0
    delta_f: float = 15.0      # kHz
    modulation: str = "QPSK"
    cp_type: str = "normal"

    # derived (filled in __post_init__)
    Nc: int = dataclasses.field(init=False)
    N: int = dataclasses.field(init=False)
    fs: float = dataclasses.field(init=False)
    Ts: float = dataclasses.field(init=False)
    T_symbol: float = dataclasses.field(init=False)
    cp_duration_us: float = dataclasses.field(init=False)
    cp_length: int = dataclasses.field(init=False)
    bits_per_symbol: int = dataclasses.field(init=False)
    samples_per_ofdm_symbol: int = dataclasses.field(init=False)

    def __post_init__(self):
        if self.modulation not in MODULATION_SCHEMES:
            raise ValueError(
                f"Unsupported modulation: {self.modulation}. Options: {MODULATION_SCHEMES}")

        if self.bandwidth in LTE_PROFILES:
            nc, n = LTE_PROFILES[self.bandwidth]
        else:
            nc = int((self.bandwidth * 1e3) / self.delta_f)
            n = _next_power_of_2(nc)

        fs = n * self.delta_f * 1e3
        if self.cp_type == "normal":
            cp_us = CP_VALUES_US["normal"]
        elif self.cp_type == "extended":
            cp_us = CP_VALUES_US["extended_15khz" if self.delta_f == 15.0
                                 else "extended_7.5khz"]
        else:
            cp_us = CP_VALUES_US["normal"]
        cp_len = int(cp_us * 1e-6 * fs)

        object.__setattr__(self, "Nc", nc)
        object.__setattr__(self, "N", n)
        object.__setattr__(self, "fs", fs)
        object.__setattr__(self, "Ts", 1.0 / fs)
        object.__setattr__(self, "T_symbol", n / fs)
        object.__setattr__(self, "cp_duration_us", cp_us)
        object.__setattr__(self, "cp_length", cp_len)
        object.__setattr__(self, "bits_per_symbol", BITS_PER_SYMBOL[self.modulation])
        object.__setattr__(self, "samples_per_ofdm_symbol", n + cp_len)

    def get_info(self) -> dict:
        return {
            "Bandwidth (MHz)": self.bandwidth,
            "Subcarrier Spacing (kHz)": self.delta_f,
            "Modulation": self.modulation,
            "CP Type": self.cp_type,
            "Useful Subcarriers (Nc)": self.Nc,
            "FFT Points (N)": self.N,
            "Sampling Frequency (MHz)": self.fs / 1e6,
            "Sampling Period (ns)": self.Ts * 1e9,
            "OFDM Symbol Duration (μs)": self.T_symbol * 1e6,
            "CP Duration (μs)": self.cp_duration_us,
            "CP Length (samples)": self.cp_length,
            "Bits per Symbol": self.bits_per_symbol,
            "Samples per OFDM Symbol": self.samples_per_ofdm_symbol,
        }

    def copy(self, **updates) -> "LTEConfig":
        keep = {k: getattr(self, k)
                for k in ("bandwidth", "delta_f", "modulation", "cp_type")}
        keep.update(updates)
        return LTEConfig(**keep)


def doppler_hz(velocity_kmh: float, frequency_ghz: float = 2.0) -> float:
    """Maximum Doppler shift f_D = v·fc/c."""
    return (velocity_kmh / 3.6) * (frequency_ghz * 1e9) / 3e8
