"""The port's layer spans (utils/profiling.span): free and shared when no
profiler records; under a CPU torch.profiler one `link.sweep` a sweep call,
the link's stages as siblings inside `link.forward` (the SISO link over
AWGN and multipath, the 4×4 rank-4 SIC spatial link over multipath),
channel, modem and detector spans never nested in each other, every aten
op of the link inside a stage, and the sweep's results bit for bit those
of an unprofiled call. On
the card (marked `cuda`), the `link.host_sync` spans of each benchmark
cell's sweep call are the points where torch's sync debug mode sees the
host wait."""
import contextlib
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.grid import grid_for
from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep, harq_sweep, sweep_link
from ofdm_lte_tpu_torch.sim import coded, siso
from ofdm_lte_tpu_torch.utils import profiling

CFG = LTEConfig(1.25, modulation="64-QAM")
SNR = [0.0, 12.0, 60.0]
LINK_STAGES = {
    "awgn": ["modem.tx", "modem.papr", "channel.awgn", "modem.rx_dft", "channel.awgn",
             "modem.estimate", "modem.demap", "link.errors"],
    "rayleigh_mp": ["modem.tx", "modem.papr", "channel.multipath", "modem.rx_dft",
                    "modem.estimate", "modem.demap", "link.errors"],
    "spatial": ["modem.tx", "modem.papr", "channel.multipath", "modem.rx_dft", "channel.awgn",
                "modem.estimate", "detector.sic", "modem.demap", "link.errors"]}
# the sweep's arguments of each link: the SISO link's channels, and the
# spatial link of the benchmark's sic4x4_peda
LINKS = {"awgn": dict(channel_type="awgn"), "rayleigh_mp": dict(channel_type="rayleigh_mp"),
         "spatial": dict(channel_type="rayleigh_mp", pipeline="spatial", num_tx=4, num_rx=4,
                         detector_type="SIC", rank=4)}
STAGE_LAYERS = ("channel", "modem", "detector")


def sweep(link, seed=5):
    return ber_sweep(CFG, SNR, frames=2, num_ofdm_symbols=14, **LINKS[link],
                     generator=torch.Generator().manual_seed(seed), device="cpu")


PROGRAM = ("link.", "modem.", "channel.", "detector.", "coding.")


def is_span(e):
    return e.name.startswith(PROGRAM) and e.device_type == torch.autograd.DeviceType.CPU


def spans_of(events):
    return [e for e in events if is_span(e)]


def ancestors(e):
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e)
    return out


def span_children(e):
    """The spans directly below e (aten ops between them skipped)."""
    out = []
    for c in e.cpu_children:
        out += [c] if is_span(c) else span_children(c)
    return out


@pytest.fixture(scope="module", params=sorted(LINKS))
def traced(request):
    sweep(request.param, seed=1)                       # the link built outside the window
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = sweep(request.param)
    return request.param, prof.events(), result


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("link.sweep"), profiling.span("modem.tx")
    assert a is b is profiling._NO_SPAN
    assert isinstance(a, contextlib.nullcontext)
    with a as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("link.test"):
            with profiling.span("modem.test"):
                torch.ones(3).sum()
    assert isinstance(profiling.span("x"), contextlib.nullcontext)
    outer, inner = spans_of(prof.events())
    assert (outer.name, inner.name, inner.cpu_parent) == ("link.test", "modem.test", outer)
    assert [c.name for c in inner.cpu_children] == ["aten::ones", "aten::sum"]


def test_a_sweep_call_records_one_link_sweep_with_its_stages(traced):
    channel_type, events, _ = traced
    tops = [e for e in spans_of(events) if e.name == "link.sweep"]
    assert len(tops) == 1 and not [a for a in ancestors(tops[0]) if is_span(a)]
    top = tops[0]
    assert [c.name for c in span_children(top)] == ["link.setup", "link.forward",
                                                    "link.readback"]
    setup, forward, readback = span_children(top)
    assert [c.name for c in span_children(setup)] == ["link.host_sync"]
    assert [c.name for c in span_children(forward)] == LINK_STAGES[channel_type]
    assert [c.name for c in span_children(readback)] == ["link.host_sync"] * 2
    # every span of the call lies under link.sweep, in a layer the program
    # names, and a stage holds no span
    for e in spans_of(events):
        assert e is top or top in ancestors(e), e.name
        assert e.name.split(".")[0] in profiling.LAYERS, e.name
    for stage in span_children(forward) + span_children(setup) + span_children(readback):
        assert span_children(stage) == [], stage.name


def test_channel_and_modem_spans_never_nest(traced):
    _, events, _ = traced
    for e in spans_of(events):
        if e.name.split(".")[0] in STAGE_LAYERS:
            assert not [a.name for a in ancestors(e)
                        if a.name.split(".")[0] in STAGE_LAYERS], e.name


def test_every_aten_op_of_the_link_lies_in_a_stage_span(traced):
    _, events, _ = traced
    under = 0
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        spans = [a for a in ancestors(e) if is_span(a)]
        if any(a.name == "link.forward" for a in spans):
            under += 1
            assert spans[0].name != "link.forward", (e.name, [a.name for a in spans])
            assert spans[0].name.split(".")[0] in STAGE_LAYERS + ("link",)
    assert under > 20


def test_results_are_bit_identical_with_and_without_the_profiler(traced):
    channel_type, _, traced_result = traced
    plain = sweep(channel_type)
    for a, b in zip(traced_result, plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_the_coded_link_and_harq_record_the_coding_spans():
    cfg = LTEConfig(1.25, modulation="QPSK")
    kw = dict(frames=1, tb_bits=120, rv_sequence=(0, 1), device="cpu")
    harq_sweep(cfg, [3.0], generator=torch.Generator().manual_seed(0), **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = harq_sweep(cfg, [3.0], generator=torch.Generator().manual_seed(2), **kw)
        coded.simulate_siso_coded(np.zeros(120, np.uint8), 30.0, cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    names = [e.name for e in spans_of(prof.events())]
    for stage in ("coding.crc", "coding.encode", "coding.rate_match", "coding.decode",
                  "coding.harq_combine", "modem.tx", "channel.awgn", "modem.demap"):
        assert stage in names, stage
    # the sweep's two waits (the SNR points in, the counts out) and the host decode's
    assert names.count("link.host_sync") == 3 and names.count("link.sweep") == 1
    for e in spans_of(prof.events()):
        layer = e.name.split(".")[0]
        if layer in ("coding", "channel", "modem"):
            assert not [a.name for a in ancestors(e)
                        if is_span(a) and a.name.split(".")[0] in
                        {"coding", "channel", "modem"}], e.name
    plain = harq_sweep(cfg, [3.0], generator=torch.Generator().manual_seed(2), **kw)
    np.testing.assert_array_equal(r.stage_failures, plain.stage_failures)
    np.testing.assert_array_equal(r.bit_errors, plain.bit_errors)


# the benchmark's cells (BENCHMARK.json): 20 MHz 64-QAM, 8 points 0-21 dB,
# (frames a point, symbols, channel), the inputs handed over as seams
CELLS = {"siso64_awgn": (32, 14, "awgn"), "siso64_peda": (32, 14, "rayleigh_mp"),
         "siso64_awgn_wide": (64, 28, "awgn")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync debug mode watches the card's stream")
    return torch.device("cuda")


def cell_call(name, device, seed):
    frames, symbols, channel = CELLS[name]
    cfg = LTEConfig(20.0, modulation="64-QAM")
    snr = [3.0 * i for i in range(8)]
    kw = dict(frames=frames, num_ofdm_symbols=symbols, channel_type=channel)
    link = sweep_link(cfg, "siso", device, channel_type=channel)
    g = torch.Generator(device=device).manual_seed(seed)
    lanes, n_bits, grid = len(snr) * frames, siso.bits_per_frame(cfg, symbols), grid_for(cfg)
    bits = torch.randint(0, 2, (len(snr), frames, n_bits), generator=g, device=device,
                         dtype=torch.int8)

    def normals(*shape):
        return (torch.randn(shape, generator=g, device=device),
                torch.randn(shape, generator=g, device=device))
    if channel == "awgn":
        seams = {"noise": (normals(lanes, symbols, grid.num_data),
                           normals(lanes, -(-symbols // 14), grid.num_pilot))}
    else:
        T = symbols * cfg.samples_per_ofdm_symbol
        phases = torch.rand((lanes * link.profile.num_taps, 16), generator=g,
                            device=device) * (2 * np.pi)
        seams = {"draws": {"phases": phases, "noise": normals(lanes, T)}}
    torch.cuda.synchronize(device)
    return lambda: ber_sweep(cfg, snr, bits=bits, seams=seams, device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_host_sync_spans_are_where_the_host_waits_for_the_card(card, name):
    call = cell_call(name, card, 11)
    call()                                             # the link and its kernels built
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "called a synchronizing CUDA operation" in str(w.message)]
    spans = [e for e in spans_of(prof.events()) if e.name == "link.host_sync"]
    assert len(syncs) == len(spans) >= 3, [str(w.message) for w in seen]
