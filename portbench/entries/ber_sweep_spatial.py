"""The adapter of `ofdm_lte_tpu_torch.parallel.sweep.ber_sweep` with
`pipeline="spatial"`: TM4 spatial multiplexing, num_tx × num_rx at a fixed
rank (PMI 0), over Jakes multipath.

A call draws, from (seed, stream, call) on the card through
harness/inputs (`generator`, `draw`), in this order:

- bits (lanes, n_bits) int8 0/1, the lanes point-major;
- the Jakes phases (rx·tx·lanes·taps, 16), U(0, 2π), the links in
  (rx, tx, lane, tap) order;
- the data-bin noise, standard normals re and im, each (rx, lanes, S, m):
  m = ⌈n_data / rank⌉ layer bins;
- the CRS-bin noise, re and im, each (rx, lanes, S, n_pilot);

as `SpatialLink.forward(draws={"phases": ..., "noise": ((data_re,
data_im), (pilot_re, pilot_im))})` takes them, and calls

    ber_sweep(cfg, snr, frames=, num_ofdm_symbols=, channel_type=,
              itu_profile=, velocity_kmh=, pipeline="spatial", num_tx=,
              num_rx=, detector_type=, rank=, bits=, seams={"draws": ...},
              device=)

and reads each point's bit errors, bits and mean PAPR; `check.compare`
holds them to the reference's `sweep` (reference/lte_spatial.py).

The cell's per-layer metrics read the detector's spans, which a program
that does not mark the `detector` layer (utils/profiling.LAYERS) lacks:
on such a program the adapter refuses the cell before the first call.
"""
from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np

from harness import check, inputs

ENTRY = "parallel.sweep.ber_sweep"


class Shape(NamedTuple):
    """The sizes of a call's inputs and products."""
    points: int
    frames: int          # a point
    n_bits: int
    symbols: int
    n_fft: int
    cp: int
    n_data: int          # data bins a symbol
    m: int               # layer bins a symbol, ⌈n_data / rank⌉
    n_pilot: int
    taps: int
    num_tx: int
    num_rx: int
    rank: int

    @property
    def lanes(self) -> int:
        return self.points * self.frames

    @property
    def samples(self) -> int:
        return self.symbols * (self.n_fft + self.cp)

    def arrays(self) -> list:
        """(name, shape, law) of the draws, in the order drawn."""
        n, rx = self.lanes, self.num_rx
        data, pilot = (rx, n, self.symbols, self.m), (rx, n, self.symbols, self.n_pilot)
        return [("bits", (n, self.n_bits), "bits"),
                ("phases", (rx * self.num_tx * n * self.taps, inputs.SINUSOIDS), "phase"),
                ("data_re", data, "normal"), ("data_im", data, "normal"),
                ("pilot_re", pilot, "normal"), ("pilot_im", pilot, "normal")]


def shape(config: dict, traffic: dict, reference) -> Shape:
    z = reference.sizes(config, traffic)
    return Shape(points=len(traffic["snr_db"]), frames=int(traffic["frames"]),
                 n_bits=z["bits_per_frame"], symbols=int(traffic["num_ofdm_symbols"]),
                 n_fft=z["n_fft"], cp=z["cp"], n_data=z["n_data"], m=z["m"],
                 n_pilot=z["n_pilot"], taps=z["taps"], num_tx=z["num_tx"], num_rx=z["num_rx"],
                 rank=z["rank"])


def _program_marks_detector() -> bool:
    prof = importlib.import_module("ofdm_lte_tpu_torch.utils.profiling")
    return "detector" in getattr(prof, "LAYERS", ())


def kwargs(config: dict, traffic: dict) -> dict:
    """The sweep's keyword arguments that every call shares."""
    if not _program_marks_detector():
        raise RuntimeError("the program marks no `detector` stage (utils/profiling.LAYERS), "
                           "which this cell's per-layer metrics read: it cannot run the cell")
    c, t = config, traffic
    return dict(frames=int(t["frames"]), num_ofdm_symbols=int(t["num_ofdm_symbols"]),
                channel_type=t["channel_type"], itu_profile=t["itu_profile"],
                velocity_kmh=t.get("velocity_kmh"), pipeline=c["pipeline"],
                num_tx=int(c["num_tx"]), num_rx=int(c["num_rx"]),
                detector_type=c["detector"], rank=int(c["rank"]))


def call_inputs(shape: Shape, seed: int, stream: int, call: int, device) -> dict:
    gen = inputs.generator(seed, stream, call, device)
    return {name: inputs.draw(gen, per, law, device) for name, per, law in shape.arrays()}


def sweep_args(shape: Shape, arrays: dict) -> dict:
    """bits (S, frames, n_bits) and the link's draws, as ber_sweep takes them."""
    return {"bits": arrays["bits"].reshape(shape.points, shape.frames, shape.n_bits),
            "seams": {"draws": {"phases": arrays["phases"],
                                "noise": ((arrays["data_re"], arrays["data_im"]),
                                          (arrays["pilot_re"], arrays["pilot_im"]))}}}


def call(fn, cfg, snr, shape: Shape, args: dict, kw: dict, device):
    return fn(cfg, snr, device=device, **args, **kw)


def results(shape: Shape, r) -> dict:
    """The call's results as host numbers."""
    return {"bit_errors": np.asarray(r.bit_errors), "total_bits": np.asarray(r.total_bits),
            "papr_db": np.asarray(r.papr_db)}


def info_bits(res: dict) -> int:
    return int(np.sum(res["total_bits"]))


def products(shape: Shape, costs) -> list:
    """(name, m, k, n) of a call's complex products, in the order the link
    launches them: the antennas' TX product (layer bins to CP-extended
    time), the links' Jakes tap product P (rx·tx·lanes·taps, 16) @ E (16,
    samples), and the RX DFTs of every RX's symbols to the layer bins and
    to the CRS bins."""
    s = shape
    rows_tx, rows_rx = s.num_tx * s.lanes * s.symbols, s.num_rx * s.lanes * s.symbols
    return [("tx", rows_tx, s.m, s.n_fft + s.cp),
            ("jakes", s.num_rx * s.num_tx * s.lanes * s.taps, inputs.SINUSOIDS, s.samples),
            ("rx_data", rows_rx, s.n_fft, s.m),
            ("rx_pilot", rows_rx, s.n_fft, s.n_pilot)]


def reference(ref, config: dict, traffic: dict, snr, arrays: dict, shape: Shape) -> dict:
    return ref.sweep(config, traffic, snr, arrays, shape.frames)


compare = check.compare
