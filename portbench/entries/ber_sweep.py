"""The adapter of `ofdm_lte_tpu_torch.parallel.sweep.ber_sweep`.

A call draws its bits and the link's noise lane-leading (harness/inputs:
`Shape`, `call_inputs`, `sweep_args`), calls

    ber_sweep(cfg, snr, frames=, num_ofdm_symbols=, mode=, channel_type=,
              pipeline=[, itu_profile=, velocity_kmh=], bits=, seams=, device=)

and reads each point's bit errors, bits and mean PAPR; `check.compare`
holds them to the reference's `sweep`.
"""
from __future__ import annotations

import numpy as np

from harness import check, inputs

ENTRY = "parallel.sweep.ber_sweep"


def shape(config: dict, traffic: dict, reference) -> inputs.Shape:
    """The sizes a call's inputs take, from the numerology and the mix."""
    t = traffic
    sizes = reference.sizes(config, t)
    return inputs.Shape(points=len(t["snr_db"]), frames=int(t["frames"]),
                        n_bits=sizes["bits_per_frame"], symbols=int(t["num_ofdm_symbols"]),
                        n_fft=sizes["n_fft"], cp=sizes["cp"], n_data=sizes["n_data"],
                        n_pilot=sizes["n_pilot"], channel=t.get("channel_type", "awgn"),
                        taps=sizes["taps"])


def kwargs(config: dict, traffic: dict) -> dict:
    """The sweep's keyword arguments that every call shares."""
    c, t = config, traffic
    out = dict(frames=int(t["frames"]), num_ofdm_symbols=int(t["num_ofdm_symbols"]),
               mode=c.get("mode", "lte"), channel_type=t.get("channel_type", "awgn"),
               pipeline=c["pipeline"])
    if out["channel_type"] != "awgn":
        out.update(itu_profile=t["itu_profile"], velocity_kmh=t.get("velocity_kmh"))
    return out


def call_inputs(shape: inputs.Shape, seed: int, stream: int, call: int, device) -> dict:
    return inputs.call_inputs(shape, seed, stream, call, device)


def sweep_args(shape: inputs.Shape, arrays: dict) -> dict:
    bits, seams = inputs.sweep_args(shape, arrays)
    return {"bits": bits, "seams": seams}


def call(fn, cfg, snr, shape: inputs.Shape, args: dict, kw: dict, device):
    return fn(cfg, snr, device=device, **args, **kw)


def results(shape: inputs.Shape, r) -> dict:
    """The call's results as host numbers."""
    return {"bit_errors": np.asarray(r.bit_errors), "total_bits": np.asarray(r.total_bits),
            "papr_db": np.asarray(r.papr_db)}


def info_bits(res: dict) -> int:
    return int(np.sum(res["total_bits"]))


def products(shape: inputs.Shape, costs) -> list:
    """(name, m, k, n) of a call's complex products: one SISO link step over
    the call's lanes, with the Jakes tap product over multipath."""
    s = shape
    return costs.siso_products(s.lanes, s.symbols, s.n_fft, s.cp, s.n_data, s.n_pilot,
                               jakes_taps=s.taps)


def reference(ref, config: dict, traffic: dict, snr, arrays: dict, shape: inputs.Shape) -> dict:
    return ref.sweep(config, traffic, snr, arrays, shape.frames)


compare = check.compare
