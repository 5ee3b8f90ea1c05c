"""Repairs of the port, each held by a test: the functional entry points
keep the link of their arguments (one construction for two calls, the same
results as a fresh link); the Jakes sinusoid table is made once and held,
bit-identical to building it every step; the plain versions of the complex
GEMM leave `allow_tf32` as they found it; the time-varying flat MIMO
channel's product goes through the modem's one GEMM entry; and a link keeps
each GEMM's constant operand as its re and im planes alone."""
import numpy as np
import pytest
import torch

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch import cplx as tcplx
from ofdm_lte_tpu_torch.channel import rayleigh as tray
from ofdm_lte_tpu_torch.cplx import C
from ofdm_lte_tpu_torch.ops import cmatmul as cm
from ofdm_lte_tpu_torch.sim import diversity, links, siso, spatial

torch.set_num_threads(2)

CFG = LTEConfig(1.25, modulation="QPSK")

ENTRIES = {
    "simulate_siso": (siso.simulate_siso, siso.SisoLink, siso.bits_per_frame, {}),
    "simulate_siso_mp": (siso.simulate_siso, siso.SisoLink, siso.bits_per_frame,
                         {"channel_type": "rayleigh_mp"}),
    "simulate_simo": (diversity.simulate_simo, diversity.SimoLink, siso.bits_per_frame,
                      {"num_rx": 2}),
    "simulate_sfbc": (diversity.simulate_sfbc, diversity.SfbcLink,
                      diversity.sfbc_bits_per_frame, {"num_rx": 2}),
    "simulate_spatial_multiplexing": (spatial.simulate_spatial_multiplexing,
                                      spatial.SpatialLink, spatial.bits_per_frame,
                                      {"num_tx": 4, "num_rx": 2, "rank": 2}),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_two_calls_construct_one_link(name, monkeypatch, rng):
    fn, cls, n_bits, kw = ENTRIES[name]
    links.clear_link_cache()
    built = []
    init = cls.__init__

    def counting_init(self, *a, **k):
        built.append(type(self).__name__)
        init(self, *a, **k)

    monkeypatch.setattr(cls, "__init__", counting_init)
    bits = torch.from_numpy(rng.integers(0, 2, (2, n_bits(CFG, 14))).astype(np.int32))
    runs = [fn(bits, 8.0, CFG, generator=torch.Generator().manual_seed(5), device="cpu", **kw)
            for _ in range(2)]
    assert built.count(cls.__name__) == 1, built
    assert torch.equal(runs[0].bits_rx, runs[1].bits_rx)
    # other arguments are another link; the first is still kept
    fn(bits, 8.0, LTEConfig(1.25, modulation="16-QAM"), device="cpu", **kw)
    fn(bits, 8.0, CFG, device="cpu", **kw)
    assert built.count(cls.__name__) == 2, built
    # and a fresh link gives the same result under the same draws
    links.clear_link_cache()
    fresh = fn(bits, 8.0, CFG, generator=torch.Generator().manual_seed(5), device="cpu", **kw)
    assert built.count(cls.__name__) == 3
    assert torch.equal(fresh.bits_rx, runs[0].bits_rx)
    assert torch.equal(fresh.papr_db, runs[0].papr_db)


def test_link_cache_is_bounded_and_drops_the_least_recent():
    links.clear_link_cache()

    class Probe:
        def __init__(self, tag):
            self.tag = tag

    first = links.cached_link(Probe, 0)
    for tag in range(1, links.MAX_LINKS):
        links.cached_link(Probe, tag)
    assert links.cached_link(Probe, 0) is first            # refreshed: now the most recent
    links.cached_link(Probe, links.MAX_LINKS)              # drops tag 1, the oldest
    assert len(links._links) == links.MAX_LINKS
    assert links.cached_link(Probe, 0) is first
    assert (Probe, 1) not in links._links
    links.clear_link_cache()
    assert not links._links


def _taps_rebuilt_every_step(profile, T, batch, stride, phases):
    """jakes_taps as it was: E = expi(ω_n·t) built on every call."""
    t = torch.arange(T, dtype=torch.float32) * (stride / profile.fs)
    omega = torch.as_tensor(tray._omega(profile.doppler_hz))
    E = tcplx.expi(omega[:, None] * t[None, :])
    L = int(np.prod(batch)) * profile.num_taps
    P = tcplx.expi(torch.as_tensor(phases, dtype=torch.float32)) * float(np.sqrt(2.0 / 16))
    return cm.cmatmul_plain(P, E).reshape(tuple(batch) + (profile.num_taps, T))


@pytest.mark.parametrize("stride", [1, 4])
def test_jakes_taps_bit_identical_with_the_table_held(stride, rng):
    prof = tray.make_profile("Vehicular_A", 7.68e6, velocity_kmh=120.0)
    phases = rng.uniform(0, 2 * np.pi, (3 * 2 * prof.num_taps, 16)).astype(np.float32)
    want = _taps_rebuilt_every_step(prof, 4096, (3, 2), stride, phases)
    tray._tables.clear()
    for _ in range(2):                       # the table made, then the table kept
        got = tray.jakes_taps(prof, 4096, (3, 2), sample_stride=stride, device="cpu",
                              phases=phases)
        assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert len(tray._tables) == 1
    kept = tray.jakes_table(prof.doppler_hz, prof.fs, 4096, stride, "cpu")
    assert tray.jakes_table(prof.doppler_hz, prof.fs, 4096, stride, torch.device("cpu")) is kept
    # a bounded number of tables is kept, the least recently used dropped first
    for T in range(100, 100 + tray.MAX_TABLES):
        tray.jakes_table(prof.doppler_hz, prof.fs, T)
        assert tray.jakes_table(prof.doppler_hz, prof.fs, 4096, stride) is kept
    assert len(tray._tables) == tray.MAX_TABLES
    assert not any(key[2] == 100 for key in tray._tables)


@pytest.mark.parametrize("link_of", ["siso", "simo", "sfbc", "spatial"])
def test_a_multipath_step_runs_no_expi_over_time(link_of, monkeypatch, rng):
    """After the first step the sinusoid table is kept: no later step
    calls expi on anything as long as the sample axis."""
    kw = dict(device="cpu", channel_type="rayleigh_mp")
    link, n_bits = {
        "siso": (lambda: siso.SisoLink(CFG, **kw), siso.bits_per_frame),
        "simo": (lambda: diversity.SimoLink(CFG, 2, **kw), siso.bits_per_frame),
        "sfbc": (lambda: diversity.SfbcLink(CFG, 2, **kw), diversity.sfbc_bits_per_frame),
        "spatial": (lambda: spatial.SpatialLink(CFG, 2, 2, 2, **kw), spatial.bits_per_frame),
    }[link_of]
    link = link()
    bits = torch.from_numpy(rng.integers(0, 2, (2, n_bits(CFG, 14))).astype(np.int32))
    T = 14 * CFG.samples_per_ofdm_symbol
    tray._tables.clear()
    seen = []
    expi = tcplx.expi
    monkeypatch.setattr(tcplx, "expi", lambda theta: seen.append(tuple(theta.shape))
                        or expi(theta))
    gen = torch.Generator().manual_seed(0)
    link(bits, 20.0, generator=gen)
    assert sum(shape[-1] == T for shape in seen) == 1      # the table, made once
    del seen[:]
    first = link(bits, 20.0, generator=gen)
    assert seen and not any(shape[-1] == T for shape in seen), seen
    assert 0.0 <= first.ber.mean().item() < 0.5


@pytest.mark.parametrize("flag", [True, False])
def test_true_fp32_products_restores_allow_tf32(flag):
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        with cm.true_fp32_products():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        with pytest.raises(RuntimeError, match="inside"):
            with cm.true_fp32_products():
                raise RuntimeError("inside")
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        # on CPU tensors the plain versions never touch it
        a = C(torch.randn(5, 7), torch.randn(5, 7))
        b = C(torch.randn(7, 3), torch.randn(7, 3))
        for plain in (cm.cmatmul_plain, cm.cmatmul_plain_tf32x3,
                      cm.cmatmul_plain_gauss_tf32x3):
            plain(a, b)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
        with cm.true_fp32_products(on_cuda=False):
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_flat_mimo_time_varying_goes_through_the_modem_gemm(monkeypatch, rng):
    """One product, through ops.ofdm._cmm like every other, and the result is
    what the four library matmuls gave under the same phases."""
    phi = rng.uniform(0, 2 * np.pi, (16, 5 * 2 * 3)).astype(np.float32)
    calls = []
    cmm = tray._cmm
    monkeypatch.setattr(tray, "_cmm", lambda a, b: calls.append((tuple(a.shape), tuple(b.shape)))
                        or cmm(a, b))
    h = tray.flat_mimo_time_varying(2, 3, 28, 70.0, batch_shape=(5,), device="cpu", phases=phi)
    assert calls == [((28, 16), (16, 30))]
    t = torch.arange(28, dtype=torch.float32) * (1.0 / 15000.0)
    E = tcplx.expi(t[:, None] * torch.as_tensor(tray._omega(70.0))[None, :])
    want = tcplx.matmul(E, tcplx.expi(torch.from_numpy(phi))) * float(np.sqrt(1.0 / 16))
    want = want.reshape(28, 5, 2, 3).transpose(1, 0, 2, 3)
    assert torch.equal(h.re, want.re) and torch.equal(h.im, want.im)


# links whose constant GEMM operands are tables: both SISO modes with a DFT
# precoder or not, SFBC, and the spatial link's time path with the 8-TX
# extended layout's tap basis
TABLE_LINKS = {
    "siso_lte": lambda: siso.SisoLink(CFG, device="cpu"),
    "siso_scfdm": lambda: siso.SisoLink(CFG, device="cpu", mode="sc-fdm"),
    "sfbc": lambda: diversity.SfbcLink(CFG, 2, device="cpu"),
    "spatial_8tx_time": lambda: spatial.SpatialLink(
        CFG, 8, 4, 2, "MMSE", device="cpu", pilot_layout="extended", channel_impl="time"),
}


@pytest.mark.parametrize("name", list(TABLE_LINKS))
def test_gemm_operands_are_re_and_im_planes_alone(name):
    """Each GEMM's B operand lives as two row-major planes, re and im, and
    nothing beside them: every kernel forms Br + Bi in registers, so no link
    keeps a Gauss-sum plane."""
    bufs = dict(TABLE_LINKS[name]().named_buffers())
    assert not [n for n in bufs if "sum" in n]
    planes = [n[:-3] for n in bufs if n.endswith("_re")]
    assert "mod_b" in planes
    for n in planes:
        re, im = bufs[n + "_re"], bufs[n + "_im"]
        assert re.shape == im.shape and re.is_contiguous() and im.is_contiguous(), n
    assert len(bufs) == 2 * len(planes) + sum(not n.endswith(("_re", "_im")) for n in bufs)
