"""The TM4 link at 8 TX against the JAX package under the JAX package's own
draws (see test_torch_spatial.py, whose helpers this file uses): the
reference CRS layout with its pairwise collisions, and the extended layout,
which alone reaches the tap-basis GEMM (over multipath here)."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_spatial import check, run_both

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.sim import spatial as tsp

torch.set_num_threads(2)

CASES = {
    "8x4_r2_mmse_reference_flat": (dict(num_tx=8, num_rx=4, rank=2, detector_type="MMSE"),
                                   [15.0, 25.0]),
    "8x4_r2_mmse_extended_mp": (dict(num_tx=8, num_rx=4, rank=2, detector_type="MMSE",
                                     channel_type="rayleigh_mp", pilot_layout="extended"),
                                25.0),
    "4x2_r2_sic_extended_is_reference": (dict(num_tx=4, num_rx=2, rank=2, detector_type="SIC",
                                              pilot_layout="extended"), 20.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_8tx_and_extended_layout_same_draws_match_jax(name):
    kw, snr = CASES[name]
    j, t, bits = run_both(5.0, "16-QAM", snr, lanes=2, S=14, seed=4, **kw)
    check(j, t, bits, (0.0, 0.5))


def test_extended_layout_beats_reference_at_8tx():
    """The reference layout's combs collide at 8 TX (BER near 0.4 in both
    packages); disjoint combs with the delay-domain basis make it usable."""
    cfg = LTEConfig(5.0, modulation="QPSK")
    bits = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, (4, tsp.bits_per_frame(cfg, 14))).astype(np.int32))
    ber = {}
    for layout in ("reference", "extended"):
        r = tsp.simulate_spatial_multiplexing(
            bits, 30.0, cfg, num_tx=8, num_rx=4, rank=2, pilot_layout=layout,
            generator=torch.Generator().manual_seed(0), device="cpu")
        ber[layout] = r.ber.mean().item()
    assert ber["extended"] < 0.02 < 0.2 < ber["reference"], ber
