"""The one input generator: every call's bits and random draws, made on the
card from (seed, stream, call) and handed to the sweep through its seams
(`bits=`, `seams=`), so that the reference can be given the same.

The entry's adapter (entries/<entry>.py) says which arrays a call draws,
in which order, through `generator` and `draw`. Each SNR point carries
`frames` frames; the lanes are point-major, lane s·frames + f. A
`ber_sweep` call (`Shape`, `call_inputs`, `sweep_args`) draws lane-leading
arrays:

- bits (lanes, n_bits) int8 0/1;
- over AWGN, the bin-domain noise of the link: standard normals at the data
  bins (lanes, symbols, n_data) and at the slot-start pilot bins (lanes,
  slots, n_pilot), re and im;
- over Jakes multipath, the phases (lanes, taps, 16), U(0, 2π), and the
  time-domain noise (lanes, symbols·(N+cp)), re and im.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SLOT = 14
SINUSOIDS = 16
WINDOW, WARMUP, TRACED = 0, 1, 2        # streams of calls


def seed_word(*parts: int) -> int:
    """A 63-bit generator seed of integers of any size (a seed above 2**32
    keeps all its bits)."""
    words = []
    for p in parts:
        p = int(p)
        words += [p & 0xFFFFFFFF, (p >> 32) & 0xFFFFFFFF, 1 if p < 0 else 0]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


class Shape(NamedTuple):
    """The sizes a call's inputs take, from the numerology and the mix."""
    points: int
    frames: int           # a point
    n_bits: int
    symbols: int
    n_fft: int
    cp: int
    n_data: int
    n_pilot: int
    channel: str          # "awgn" | "rayleigh_mp"
    taps: int

    @property
    def lanes(self) -> int:
        return self.points * self.frames

    @property
    def slots(self) -> int:
        return -(-self.symbols // SLOT)

    @property
    def samples(self) -> int:
        return self.symbols * (self.n_fft + self.cp)

    def arrays(self) -> list:
        """(name, per-lane shape, law) of the draws, in the order drawn."""
        if self.channel == "awgn":
            d, p = (self.symbols, self.n_data), (self.slots, self.n_pilot)
            return [("data_re", d, "normal"), ("data_im", d, "normal"),
                    ("pilot_re", p, "normal"), ("pilot_im", p, "normal")]
        if self.channel == "rayleigh_mp":
            return [("phases", (self.taps, SINUSOIDS), "phase"),
                    ("noise_re", (self.samples,), "normal"),
                    ("noise_im", (self.samples,), "normal")]
        raise ValueError(f"no draws are defined for channel {self.channel!r}")


def generator(seed: int, stream: int, call: int, device) -> torch.Generator:
    """The generator of one call's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_word(seed, stream, call))
    return gen


def draw(gen: torch.Generator, shape: tuple, law: str, device) -> torch.Tensor:
    """One array of `shape` under `law`: "bits" (int8 0/1), "normal"
    (standard normals) or "phase" (U(0, 2π))."""
    if law == "bits":
        return torch.randint(0, 2, shape, generator=gen, device=device, dtype=torch.int8)
    if law == "normal":
        return torch.randn(shape, generator=gen, device=device)
    if law == "phase":
        return torch.rand(shape, generator=gen, device=device) * (2.0 * np.pi)
    raise ValueError(f"no law {law!r}")


def call_inputs(shape: Shape, seed: int, stream: int, call: int, device) -> dict:
    """The arrays of one call, drawn by a generator of its own."""
    gen = generator(seed, stream, call, device)
    n = shape.lanes
    out = {"bits": draw(gen, (n, shape.n_bits), "bits", device)}
    for name, per, law in shape.arrays():
        out[name] = draw(gen, (n,) + per, law, device)
    return out


def sweep_args(shape: Shape, arrays: dict) -> tuple:
    """(bits, seams) as ber_sweep takes them: bits (S, frames, n_bits) and
    the link's seams with S·frames lanes."""
    bits = arrays["bits"].reshape(shape.points, shape.frames, shape.n_bits)
    if shape.channel == "awgn":
        seams = {"noise": ((arrays["data_re"], arrays["data_im"]),
                           (arrays["pilot_re"], arrays["pilot_im"]))}
    else:
        seams = {"draws": {"phases": arrays["phases"].reshape(-1, SINUSOIDS),
                           "noise": (arrays["noise_re"], arrays["noise_im"])}}
    return bits, seams
