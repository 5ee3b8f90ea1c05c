"""The adapter of `ofdm_lte_tpu_torch.sim.coded.simulate_siso_coded_harq_batched`:
the turbo-coded chain's IR-HARQ over a batch of lanes, S SNR points ×
`frames` transport blocks, each lane's outcome returned. (`harq_sweep` runs
the same batch and returns only each point's sums, which cannot hold the
products' precision: see PERF.md.)

A call draws, from (seed, stream, call) on the card, in this order:

- bits (S, frames, tb_bits) int8 0/1;
- the time-domain noise of each transmission, standard normals re and im,
  each (T, S·frames, samples): T = len(rv_sequence), the lanes point-major,
  samples = OFDM symbols a transmission × (N + cp), as
  `CodedLink.harq(draws={"noise": (re, im)})` takes them;

calls

    simulate_siso_coded_harq_batched(bits (S·frames, tb_bits), snr (S·frames,),
        cfg, rv_sequence=, num_iterations=, channel_type=, device=,
        draws={"noise": (re, im)})

with the lanes' SNRs copied to the card in the call, and reads each lane's
outcome back in one copy: passed by each stage, transmissions, residual
information-bit errors, and the PAPR of its first transmission. A call
carries S·frames·tb_bits information bits. `compare` holds them to the
reference's (reference/lte_coded.harq_lanes), lane by lane:

- `stage_fail_gap`: Σ over lanes and stages |fail(port) − fail(ref)|;
- `tx_gap`: Σ over lanes |transmissions(port) − (ref)|;
- `error_gap_bits`: |Σ errors(port) − Σ errors(ref)| over the lanes that
  fail on both sides (a failed decode's residual errors part between any
  two roundings, so only their sum is compared);
- `crc_mismatch_lanes`: the lanes where one side's CRC outcome and bit
  errors disagree (passed with errors, or failed with none) and the
  other's agree: CRC-24A makes them agree, so the reference has none;
- `papr_gap_db`: the largest |PAPR(port) − PAPR(ref)| of a lane, which
  holds the TX product to its precision.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from harness import inputs

ENTRY = "sim.coded.simulate_siso_coded_harq_batched"


class Shape(NamedTuple):
    """The sizes of a call's inputs, products and decoder work."""
    points: int
    frames: int              # transport blocks a point
    tb_bits: int
    transmissions: int       # T, the rv schedule's length
    samples: int             # a transmission's time samples a lane
    block_sizes: tuple       # K of each code block of a transport block
    symbols: int             # OFDM symbols a transmission
    n_fft: int
    cp: int
    n_data: int
    n_pilot: int

    @property
    def lanes(self) -> int:
        return self.points * self.frames

    def arrays(self) -> list:
        """(name, shape, law) of the draws, in the order drawn."""
        noise = (self.transmissions, self.lanes, self.samples)
        return [("bits", (self.points, self.frames, self.tb_bits), "bits"),
                ("noise_re", noise, "normal"), ("noise_im", noise, "normal")]


def shape(config: dict, traffic: dict, reference) -> Shape:
    z = reference.sizes(config, traffic)
    return Shape(points=len(traffic["snr_db"]), frames=int(traffic["frames"]),
                 tb_bits=int(traffic["tb_bits"]), transmissions=len(traffic["rv_sequence"]),
                 samples=int(z["samples"]), block_sizes=tuple(z["block_sizes"]),
                 symbols=int(z["symbols"]), n_fft=int(z["n_fft"]), cp=int(z["cp"]),
                 n_data=int(z["n_data"]), n_pilot=int(z["n_pilot"]))


def kwargs(config: dict, traffic: dict) -> dict:
    t = traffic
    return dict(rv_sequence=tuple(int(v) for v in t["rv_sequence"]),
                num_iterations=int(t["num_iterations"]),
                channel_type=t.get("channel_type", "awgn"))


def call_inputs(shape: Shape, seed: int, stream: int, call: int, device) -> dict:
    gen = inputs.generator(seed, stream, call, device)
    return {name: inputs.draw(gen, per, law, device) for name, per, law in shape.arrays()}


def sweep_args(shape: Shape, arrays: dict) -> dict:
    return {"bits": arrays["bits"].reshape(shape.lanes, shape.tb_bits),
            "draws": {"noise": (arrays["noise_re"], arrays["noise_im"])}}


def call(fn, cfg, snr, shape: Shape, args: dict, kw: dict, device):
    lanes_snr = torch.as_tensor(np.repeat(np.asarray(snr, np.float32), shape.frames),
                                device=device)
    return fn(args["bits"], lanes_snr, cfg, device=device, draws=args["draws"], **kw)


def results(shape: Shape, r) -> dict:
    """Each lane's outcome as host numbers, read back in one copy."""
    T = shape.transmissions
    host = torch.cat([(~r.crc_pass_stage).to(torch.float32),
                      r.num_transmissions[:, None].to(torch.float32),
                      r.bit_errors[:, None].to(torch.float32),
                      r.papr_db[:, None].to(torch.float32)], dim=1).cpu().numpy()
    return {"fail": host[:, :T].astype(np.int64), "ntx": host[:, T].astype(np.int64),
            "errs": host[:, T + 1].astype(np.int64), "papr_db": host[:, T + 2].astype(np.float64),
            "info_bits": np.int64(host.shape[0]) * shape.tb_bits}


def info_bits(res: dict) -> int:
    return int(res["info_bits"])


def products(shape: Shape, costs) -> list:
    """(name, m, k, n) of a call's complex products: every lane runs every
    transmission, each the SISO link's TX, RX-data and RX-pilot products
    over the transmission's symbols."""
    one = costs.siso_products(shape.lanes, shape.symbols, shape.n_fft, shape.cp, shape.n_data,
                              shape.n_pilot)
    return [(f"{name}.{t}", m, k, n) for t in range(shape.transmissions) for name, m, k, n in one]


def reference(ref, config: dict, traffic: dict, snr, arrays: dict, shape: Shape,
              decoder_dtype=torch.float64) -> dict:
    out = ref.harq_lanes(config, traffic, snr, arrays, shape.frames, decoder_dtype)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _crc_mismatch(res: dict) -> np.ndarray:
    return (res["fail"][:, -1] == 0) != (res["errs"] == 0)


def compare(port: dict, ref: dict) -> dict:
    names = ("stage_fail_gap", "tx_gap", "error_gap_bits", "crc_mismatch_lanes", "papr_gap_db")
    if any(np.shape(port[k]) != np.shape(ref[k]) for k in ("fail", "ntx", "errs", "papr_db")):
        return {k: float("inf") for k in names}
    failed_both = (port["fail"][:, -1] == 1) & (ref["fail"][:, -1] == 1)
    papr = np.abs(np.asarray(port["papr_db"], np.float64) - np.asarray(ref["papr_db"]))
    gaps = (np.abs(port["fail"] - ref["fail"]).sum(),
            np.abs(port["ntx"] - ref["ntx"]).sum(),
            abs(int(port["errs"][failed_both].sum()) - int(ref["errs"][failed_both].sum())),
            (_crc_mismatch(port) != _crc_mismatch(ref)).sum(),
            papr.max() if np.all(np.isfinite(papr)) else float("inf"))
    return {k: float(v) for k, v in zip(names, gaps)}
