"""The port's TM4 4×4 rank-4 SIC link over Pedestrian A, as ber_sweep runs
it (pipeline "spatial"), against the benchmark's plain float64 reference
(portbench/reference/lte_spatial.py) at 1.25 MHz on the CPU, under the
same draws: the sweep's per-point errors, PAPR and bits; each lane's
channel estimates and SIC decisions against the reference's pieces; the
MMSE detector in SIC's place fails the same limit; and the reference
takes nothing of JAX, the JAX package or the port."""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.ops import ofdm
from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep, sweep_link
from ofdm_lte_tpu_torch.rx.mimo_estimation import estimate_per_tx_planes

REFERENCE = Path(__file__).resolve().parents[1] / "portbench" / "reference"
CONFIG = {"bandwidth_mhz": 1.25, "modulation": "64-QAM", "num_tx": 4, "num_rx": 4, "rank": 4,
          "pmi": 0, "cell_id": 0}
TRAFFIC = {"num_ofdm_symbols": 14, "itu_profile": "Pedestrian_A", "velocity_kmh": 3.0}
SNR = [0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0, 35.0]
FRAMES = 2
KW = dict(frames=FRAMES, num_ofdm_symbols=14, channel_type="rayleigh_mp",
          itu_profile="Pedestrian_A", velocity_kmh=3.0, pipeline="spatial", num_tx=4, num_rx=4,
          rank=4, device="cpu")
# The port computes in float32, the reference in float64: a hard decision
# parts only where the two soft values straddle a decision boundary, and in
# SIC a parted decision is cancelled into the later stages of its site, so
# one parting costs at most its site's 4 layers × 6 bits. The limit allows
# one such site over the call (16 lanes × 14 symbols × 16 layer bins).
ERROR_GAP_BITS = 24
PAPR_GAP_DB = 1e-5


def load_reference():
    spec = importlib.util.spec_from_file_location("portbench_reference_lte_spatial",
                                                  REFERENCE / "lte_spatial.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = load_reference()


@pytest.fixture(scope="module")
def draws():
    """The benchmark adapter's draws, in its order and shapes."""
    z = ref.sizes(CONFIG, TRAFFIC)
    lanes = len(SNR) * FRAMES
    g = torch.Generator().manual_seed(2 ** 33 + 21)
    out = {"bits": torch.randint(0, 2, (lanes, z["bits_per_frame"]), generator=g,
                                 dtype=torch.int8),
           "phases": torch.rand((16 * lanes * z["taps"], 16), generator=g) * (2 * np.pi)}
    for name, k in (("data", z["m"]), ("pilot", z["n_pilot"])):
        for part in ("re", "im"):
            out[f"{name}_{part}"] = torch.randn((4, lanes, 14, k), generator=g)
    return out


def port_sweep(arrays, detector_type="SIC"):
    seams = {"draws": {"phases": arrays["phases"],
                       "noise": ((arrays["data_re"], arrays["data_im"]),
                                 (arrays["pilot_re"], arrays["pilot_im"]))}}
    bits = arrays["bits"].reshape(len(SNR), FRAMES, -1)
    return ber_sweep(LTEConfig(1.25, modulation="64-QAM"), SNR, bits=bits, seams=seams,
                     detector_type=detector_type, **KW)


def gaps(port, reference):
    return (int(np.abs(port.bit_errors - reference["bit_errors"]).sum()),
            float(np.abs(port.papr_db - reference["papr_db"]).max()),
            int(np.abs(port.total_bits - reference["total_bits"]).sum()))


@pytest.fixture(scope="module")
def reference_sweep(draws):
    return ref.sweep(CONFIG, TRAFFIC, SNR, draws, FRAMES)


def test_the_sweep_matches_the_float64_reference(draws, reference_sweep):
    port = port_sweep(draws)
    error_gap, papr_gap, bits_gap = gaps(port, reference_sweep)
    assert error_gap <= ERROR_GAP_BITS and papr_gap <= PAPR_GAP_DB and bits_gap == 0
    # the link does work: errors fall from the noise-limited end
    ber = reference_sweep["bit_errors"] / reference_sweep["total_bits"]
    assert ber[0] > 0.2 and ber[0] > ber[-1]


def test_the_mmse_detector_in_sics_place_fails_the_limit(draws, reference_sweep):
    error_gap, _, _ = gaps(port_sweep(draws, "MMSE"), reference_sweep)
    assert error_gap > 3 * ERROR_GAP_BITS


def test_estimates_and_decisions_lane_by_lane(draws):
    """The port's stages, called as SpatialLink.forward calls them, against
    the reference's pieces of the same lanes."""
    cfg = LTEConfig(1.25, modulation="64-QAM")
    link = sweep_link(cfg, "spatial", torch.device("cpu"), channel_type="rayleigh_mp",
                      num_tx=4, num_rx=4, detector_type="SIC", rank=4, velocity_kmh=3.0)
    snr = torch.as_tensor(np.repeat(np.float32(SNR), FRAMES))
    W = link._c("precoder")
    x = link.precode(draws["bits"], W)
    sig = ofdm.modulate_custom_multi(x, cfg, None, None, None, link.mod_tables)
    noise = ((draws["data_re"], draws["data_im"]), (draws["pilot_re"], draws["pilot_im"]))
    y_data, y_pil, _ = link._through_time(x, sig, snr, None,
                                          {"phases": draws["phases"], "noise": noise})
    h_tx = estimate_per_tx_planes(y_pil, cfg, 4, link.data_bins, "reference", link.per_tx)
    layers = link._detect(y_data, h_tx, W, snr)                  # (lanes, S, m, L)
    want = ref.lanes(CONFIG, TRAFFIC, snr.numpy(), draws, slice(None))
    # the layers sent: the port's precoded symbols are the reference's layers
    sent = want["layers"].numpy()                                # (lanes, L, S, m)
    np.testing.assert_allclose(x.to_numpy().transpose(1, 0, 2, 3), sent, atol=1e-6)
    # the estimates (lanes, S, m, rx, tx), to float32 rounding of their size
    H = np.stack([h.to_numpy() for h in h_tx]).transpose(2, 3, 4, 1, 0)
    H_ref = want["H"].numpy()
    assert H.shape == H_ref.shape
    for lane in range(H.shape[0]):
        scale = np.abs(H_ref[lane]).max()
        np.testing.assert_allclose(H[lane], H_ref[lane], rtol=0, atol=2e-5 * scale)
    # the SIC decisions, lane by lane: the same constellation points, with
    # at most one site's layers parted a lane (see ERROR_GAP_BITS)
    got, decided = layers.to_numpy(), want["decisions"].numpy()
    assert got.shape == decided.shape
    for lane in range(got.shape[0]):
        assert int((np.abs(got[lane] - decided[lane]) > 1e-5).sum()) <= 4, lane
    # and the errors the reference counts are the port's, lane by lane
    port_errors = port_sweep(draws).bit_errors
    np.testing.assert_array_equal(want["errors"].numpy().reshape(len(SNR), FRAMES).sum(1),
                                  port_errors)


def test_the_reference_imports_no_jax_and_nothing_of_the_port():
    for path in (REFERENCE / "lte_spatial.py", REFERENCE / "lte_siso.py"):
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert names <= {"__future__", "importlib", "math", "sys", "pathlib", "numpy",
                         "torch"}, (path.name, names)
    text = (REFERENCE / "lte_spatial.py").read_text()
    assert "allow_tf32 = False" in text
