"""The readers of the program's spans (channel.device_ms, modem.device_ms,
coding.device_ms, link.host_syncs) against small synthetic breakdown windows: the sums a
call, the span prefixes, the lost-trace rule, and silence on a program
that marks no stage."""
import pytest

from harness import core, devtrace, inputs
from pb_helpers import BENCH


def metric(name):
    return core.load_module(BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


class FakeCell:
    traffic = {}
    entry = core.load_module(BENCH / "entries" / "ber_sweep.py", "t_spans_ber_entry")


def ctx_of(host):
    shape = inputs.Shape(points=8, frames=32, n_bits=83916, symbols=14, n_fft=2048, cp=144,
                         n_data=999, n_pilot=200, channel="awgn", taps=0)
    return core.Context(FakeCell(), shape, None, host)


def window(spans, kernels, calls=2):
    """A breakdown window: host spans [(name, start, dur)] and kernels
    [(name, launched_at, dur)], each kernel running 1000 µs after its
    launch."""
    ks = [(n, t + 1000.0, d) for n, t, d in kernels]
    return devtrace.Reduced(ks, ks, (0.0, 5000.0), calls, spans, {}, [t for _, t, _ in kernels])


# two calls of a sweep: the program's spans nest as ber_sweep records them
SPANS = [(core.SWEEP, 0, 1000), ("link.sweep", 1, 998), ("link.setup", 2, 10),
         ("link.host_sync", 3, 5), ("link.forward", 20, 900), ("modem.tx", 21, 100),
         ("modem.papr", 130, 10), ("channel.awgn", 150, 10), ("modem.rx_dft", 170, 100),
         ("channel.awgn", 280, 20), ("modem.estimate", 310, 50), ("modem.demap", 370, 50),
         ("link.errors", 430, 10), ("link.readback", 930, 60), ("link.host_sync", 940, 10),
         ("link.host_sync", 960, 10)]
SPANS = SPANS + [(n, s + 2000, d) for n, s, d in SPANS]
KERNELS = [("draw", -50, 400.0),                  # the harness's draw, outside every span
           ("gemm_tx", 50, 900.0), ("abs2", 155, 40.0), ("gemm_rx", 200, 800.0),
           ("randn_add", 290, 60.0), ("zf", 320, 100.0), ("demap", 380, 200.0),
           ("errors", 435, 30.0), ("sum", 945, 20.0)]
KERNELS = KERNELS + [(n, t + 2000, d) for n, t, d in KERNELS]


def test_device_ms_sums_the_kernels_launched_in_each_layers_spans():
    w = window(SPANS, KERNELS)
    assert metric("channel.device_ms").read(ctx_of(w)) == pytest.approx((40 + 60) * 1e-3)
    assert metric("modem.device_ms").read(ctx_of(w)) == pytest.approx(
        (900 + 800 + 100 + 200) * 1e-3)


def test_coding_device_ms_sums_the_coding_spans():
    spans = [(core.SWEEP, 0, 1000), ("coding.crc", 10, 20), ("coding.encode", 40, 20),
             ("modem.tx", 70, 50), ("coding.decode", 200, 300), ("coding.harq_combine", 600, 10)]
    kernels = [("crc_gemm", 15, 4.0), ("encode", 45, 6.0), ("gemm_tx", 80, 50.0),
               ("bcjr_kernel", 250, 870.0), ("where", 605, 2.0), ("draw", -40, 9.0)]
    got = metric("coding.device_ms").read(ctx_of(window(spans, kernels, calls=2)))
    assert got == pytest.approx((4 + 6 + 870 + 2) * 1e-3 / 2)


def test_host_syncs_counts_the_sync_spans_a_call():
    assert metric("link.host_syncs").read(ctx_of(window(SPANS, KERNELS))) == 3.0
    no_sync = [s for s in SPANS if s[0] != "link.host_sync"]
    assert metric("link.host_syncs").read(ctx_of(window(no_sync, KERNELS))) == 0.0


def test_a_span_prefix_is_its_layer_and_nothing_else():
    m = metric("channel.device_ms")
    # a modem span named like a channel's, and a kernel launched in no span
    spans = [("modem.channel_est", 0, 100), ("channel.multipath", 200, 100)]
    kernels = [("a", 50, 7.0), ("b", 250, 3.0), ("c", 400, 11.0)]
    assert m.read(ctx_of(window(spans, kernels, calls=1))) == pytest.approx(3e-3)
    assert metric("modem.device_ms").read(ctx_of(window(spans, kernels, calls=1))) == \
        pytest.approx(7e-3)


def test_a_kernel_with_no_launch_record_counts_in_no_span():
    spans = [("channel.awgn", 0, 100)]
    ks = [("a", 1000.0, 5.0), ("b", 1010.0, 5.0)]
    w = devtrace.Reduced(ks, ks, (0.0, 2000.0), 1, spans, {}, [50.0, None])
    assert metric("channel.device_ms").read(ctx_of(w)) == pytest.approx(5e-3)


@pytest.mark.parametrize("name,drop", [("channel.device_ms", "channel."),
                                       ("modem.device_ms", "modem."),
                                       ("coding.device_ms", "coding."),
                                       ("link.host_syncs", "link.")])
def test_a_window_with_kernels_and_no_span_of_the_layer_is_a_lost_trace(name, drop):
    spans = [s for s in SPANS if not s[0].startswith(drop)]
    with pytest.raises(core.LostTrace):
        metric(name).read(ctx_of(window(spans, KERNELS)))
    # no kernel, or no breakdown window: nothing to read
    assert metric(name).read(ctx_of(window(spans, []))) is None
    assert metric(name).read(ctx_of(None)) is None


@pytest.mark.parametrize("name", ["channel.device_ms", "modem.device_ms", "coding.device_ms",
                                  "link.host_syncs"])
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    import ofdm_lte_tpu_torch.utils.profiling as prof
    monkeypatch.delattr(prof, "span")
    assert metric(name).read(ctx_of(window([(core.SWEEP, 0, 1000)], KERNELS))) is None
