"""The port's entry points take the CUDA card unless told otherwise: with no
device given and no card they raise; `device="cpu"` runs on the CPU."""
import numpy as np
import pytest
import torch

from ofdm_lte_tpu_torch import LTEConfig, OFDMModule, OFDMSimulator
from ofdm_lte_tpu_torch.device import resolve_device
from ofdm_lte_tpu_torch.parallel import sweep
from ofdm_lte_tpu_torch.sim import diversity, siso, spatial

torch.set_num_threads(2)

CFG = LTEConfig(1.25, modulation="QPSK")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [OFDMModule, OFDMSimulator, siso.SisoLink],
                         ids=["OFDMModule", "OFDMSimulator", "SisoLink"])
def test_no_device_and_no_card_raises(entry, no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry(CFG)


def test_resolve_device_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)


def test_resolve_device_takes_the_card_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu"), "cuda:1", "meta"])
def test_resolve_device_passes_explicit_device_through(device, no_card):
    assert resolve_device(device) == torch.device(device)


@pytest.mark.parametrize("entry", [OFDMModule, OFDMSimulator],
                         ids=["OFDMModule", "OFDMSimulator"])
def test_facade_on_cpu_when_asked(entry, no_card):
    obj = entry(CFG, seed=1, device="cpu")
    sim = obj.simulator if entry is OFDMModule else obj
    assert sim.device == torch.device("cpu")
    assert sim.generator.device == torch.device("cpu")
    bits = np.random.default_rng(0).integers(0, 2, 300)
    res = obj.transmit(bits, 60.0) if entry is OFDMModule else obj.simulate_siso(bits, 60.0)
    assert res["ber"] == 0.0 and res["transmitted_bits"] == 300


def test_link_on_cpu_when_asked(no_card):
    link = siso.SisoLink(CFG, device="cpu")
    assert all(b.device == torch.device("cpu") for b in link.buffers())
    bits = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (2, siso.bits_per_frame(CFG, 14))).astype(np.int32))
    assert int(link(bits, 60.0).bit_errors.sum()) == 0


def test_simulate_siso_follows_the_bits(no_card):
    """The functional form does not follow its `bits`: CPU bits and no device
    ask for the card, and where there is none that raises; device="cpu" runs."""
    bits = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2, siso.bits_per_frame(CFG, 14)).astype(np.int32))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        siso.simulate_siso(bits, 60.0, CFG)
    r = siso.simulate_siso(bits, 60.0, CFG, device="cpu")
    assert r.bits_rx.device == torch.device("cpu") and int(r.bit_errors) == 0


FUNCTIONAL = {"simulate_siso": siso.simulate_siso, "simulate_simo": diversity.simulate_simo,
              "simulate_sfbc": diversity.simulate_sfbc, "simulate_miso": diversity.simulate_miso,
              "simulate_mimo": diversity.simulate_mimo,
              "simulate_spatial_multiplexing": spatial.simulate_spatial_multiplexing}


@pytest.mark.parametrize("name", list(FUNCTIONAL))
def test_functional_entry_points_resolve_the_device(name, no_card, monkeypatch):
    """device=None goes through resolve_device (the card, or raise), and the
    bits are moved to the device that it names."""
    fn = FUNCTIONAL[name]
    n = (diversity.sfbc_bits_per_frame(CFG, 14)
         if name in ("simulate_sfbc", "simulate_miso", "simulate_mimo")
         else siso.bits_per_frame(CFG, 14))
    bits = torch.from_numpy(np.random.default_rng(3).integers(0, 2, n).astype(np.int32))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn(bits, 60.0, CFG)
    r = fn(bits, 60.0, CFG, device="cpu")
    assert r.bits_rx.device == torch.device("cpu") and int(r.bit_errors) == 0
    # with a card present, no device means the card: stand "meta" in for it
    asked = []
    for mod in (siso, diversity, spatial):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda d=None: asked.append(d) or torch.device("meta"))
    try:
        fn(bits, 60.0, CFG)
    except (NotImplementedError, RuntimeError, ValueError):
        pass                                  # a meta tensor cannot run the link to its end
    assert asked and asked[0] is None


def test_ber_sweep_resolves_the_device(no_card, monkeypatch):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sweep.ber_sweep(CFG, [60.0], frames=1, num_ofdm_symbols=14)
    r = sweep.ber_sweep(CFG, [60.0], frames=1, num_ofdm_symbols=14, device="cpu")
    assert int(r.bit_errors.sum()) == 0
    asked = []
    monkeypatch.setattr(sweep, "resolve_device",
                        lambda d=None: asked.append(d) or torch.device("cpu"))
    sweep.ber_sweep(CFG, [60.0], frames=1, num_ofdm_symbols=14, pipeline="spatial")
    assert asked == [None]


@pytest.mark.parametrize("entry", [diversity.SimoLink, diversity.SfbcLink, spatial.SpatialLink],
                         ids=["SimoLink", "SfbcLink", "SpatialLink"])
def test_diversity_links_take_the_card_or_raise(entry, no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry(CFG)
    link = entry(CFG, device="cpu")
    assert all(b.device == torch.device("cpu") for b in link.buffers())
