"""The one-device ber_sweep and harq_sweep: their counts equal the sum of
the per-point link calls under the same bits and draws, for every pipeline,
and equal the JAX package's sweeps on a one-device mesh under those sweeps'
own bits and per-lane draws; an unknown argument is an error."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu.parallel import sweep as jsweep

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.parallel import sweep as tsweep
from ofdm_lte_tpu_torch.parallel.sweep import SweepResult, ber_sweep, harq_sweep
from ofdm_lte_tpu_torch.sim import coded, diversity, siso, spatial
from ofdm_lte_tpu_torch.sim.links import clear_link_cache

torch.set_num_threads(2)

CFG = LTEConfig(1.25, modulation="QPSK")
SNRS = [0.0, 6.0, 12.0]
F, SYMBOLS = 3, 14


def _normals(rng, *shape):
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _case(pipeline, rng):
    """(sweep arguments, seams for S·F lanes, per-point runner)."""
    g = siso.grid_for(CFG)
    lanes = len(SNRS) * F
    T = SYMBOLS * CFG.samples_per_ofdm_symbol
    if pipeline == "siso":
        seams = {"noise": (_normals(rng, lanes, SYMBOLS, g.num_data),
                           _normals(rng, lanes, 1, g.num_pilot))}
        return {}, seams, siso.SisoLink(CFG, device="cpu")
    if pipeline == "siso_mp":
        kw = dict(channel_type="rayleigh_mp", velocity_kmh=30.0)
        seams = {"draws": {"phases": rng.uniform(0, 2 * np.pi, (lanes * 4, 16)),
                           "noise": _normals(rng, lanes, T)}}
        return kw, seams, siso.SisoLink(CFG, device="cpu", **kw)
    if pipeline == "simo":
        seams = {"draws": {"noise": _normals(rng, 2, lanes, T)}}
        return dict(num_rx=2), seams, diversity.SimoLink(CFG, 2, device="cpu")
    if pipeline == "sfbc":
        n_even = len(diversity.sfbc_data_bins(CFG))
        seams = {"draws": {"noise": (_normals(rng, 2, lanes, SYMBOLS, n_even),
                                     _normals(rng, 2, lanes, 1, g.num_pilot))}}
        return dict(num_rx=2), seams, diversity.SfbcLink(CFG, 2, device="cpu")
    if pipeline == "coded":
        link = coded.CodedLink(CFG, CODED_BITS, device="cpu")
        seams = {"draws": {"noise": _normals(rng, lanes, _coded_samples(link))}}
        return dict(coded_tb_bits=CODED_BITS), seams, link
    m = -(-g.num_data // 2)
    seams = {"draws": {"fading": _normals(rng, lanes, 2, 4),
                       "noise": (_normals(rng, 2, lanes, SYMBOLS, m),
                                 _normals(rng, 2, lanes, SYMBOLS, g.num_pilot))}}
    return (dict(num_tx=4, num_rx=2, detector_type="SIC"), seams,
            spatial.SpatialLink(CFG, 4, 2, 2, "SIC", device="cpu"))


CODED_BITS = 1000        # one block of K 1024: 8 iterations stay cheap on the CPU


def _coded_samples(link) -> int:
    """Samples of one transmission of a coded link's transport block."""
    n_sym = -(-link.coded_len // CFG.bits_per_symbol)
    return -(-n_sym // siso.grid_for(CFG).num_data) * CFG.samples_per_ofdm_symbol


def _lane_slice(seams, lane_axis_of, lo, hi):
    """The seams of lanes lo:hi: every array is cut along its lane axis."""
    def cut(x, path):
        if isinstance(x, dict):
            return {k: cut(v, path + (k,)) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(cut(v, path) for v in x)
        axis = lane_axis_of(path)
        if path[-1] == "phases":                 # (links·lanes·taps, 16), lanes inside links
            links = x.shape[0] // (len(SNRS) * F * 4)
            return x.reshape(links, len(SNRS) * F, 4, 16)[:, lo:hi].reshape(-1, 16)
        return np.take(x, range(lo, hi), axis=axis)
    return cut(seams, ())


@pytest.mark.parametrize("pipeline", ["siso", "siso_mp", "simo", "sfbc", "spatial", "coded"])
def test_counts_equal_the_sum_of_per_point_link_calls(pipeline, rng):
    kw, seams, link = _case(pipeline, rng)
    name = "siso" if pipeline == "siso_mp" else pipeline
    n_bits = tsweep._bits_per_frame(CFG, SYMBOLS, "lte", name, kw.get("coded_tb_bits", 6000))
    bits = torch.from_numpy(rng.integers(0, 2, (len(SNRS), F, n_bits)).astype(np.int8))
    r = ber_sweep(CFG, SNRS, frames=F, num_ofdm_symbols=SYMBOLS, pipeline=name, device="cpu",
                  bits=bits, seams=seams, **kw)
    assert isinstance(r, SweepResult) and r.frames == F
    assert r.bit_errors.dtype == np.int64 and r.total_bits.tolist() == [F * n_bits] * 3
    # antenna axis first where the seam has one; siso's and coded's start with the lanes
    lane_axis = 0 if name in ("siso", "coded") else 1

    def axis_of(path):
        return 0 if path[-1] == "fading" else lane_axis

    for i, snr in enumerate(SNRS):
        one = link(bits[i], snr, **_lane_slice(seams, axis_of, i * F, (i + 1) * F))
        assert int(one.bit_errors.sum()) == r.bit_errors[i], (pipeline, i)
        np.testing.assert_allclose(one.papr_db.mean().item(), r.papr_db[i], rtol=1e-5)
    np.testing.assert_allclose(r.ber, r.bit_errors / r.total_bits)
    assert r.ber[0] > r.ber[2]


def _jax_normals(key, shape):
    kr, ki = jax.random.split(key)
    return (np.array(jax.random.normal(kr, shape, jnp.float32)),
            np.array(jax.random.normal(ki, shape, jnp.float32)))


def _jax_sweep_inputs(key, pipeline, n_points, frames, n_bits, num_tx, num_rx, rank_used):
    """The bits and the per-lane draws of `jsweep.ber_sweep(key, ...)` on a
    one-device mesh, as the port's `bits=` and `seams=`: device 0 folds 0 into
    the key, splits it into the bits' key and the lanes' keys, and every lane
    draws from its own key as its pipeline's single-lane function does."""
    kb, kc = jax.random.split(jax.random.fold_in(key, 0))
    bits = np.array(jax.random.bernoulli(kb, 0.5, (n_points, frames, n_bits)), np.int8)
    g = siso.grid_for(CFG)

    def stack(per_lane, axis):
        return tuple(np.stack([lane[part] for lane in per_lane], axis=axis) for part in (0, 1))

    data, pilot, fading = [], [], []
    for k in jax.random.split(kc, n_points * frames):
        if pipeline == "siso":               # noise at the bins: data, slot-start pilots
            kd, kp = jax.random.split(k)
            data.append(_jax_normals(kd, (SYMBOLS, g.num_data)))
            pilot.append(_jax_normals(kp, (1, g.num_pilot)))
        else:                                # the flat spatial channel at the bins
            kch, kd, kp = jax.random.split(k, 3)
            m = -(-g.num_data // rank_used)
            fading.append(_jax_normals(kch, (num_rx, num_tx)))
            data.append(_jax_normals(kd, (num_rx, SYMBOLS, m)))
            pilot.append(_jax_normals(kp, (num_rx, SYMBOLS, g.num_pilot)))
    if pipeline == "siso":
        return bits, {"noise": (stack(data, 0), stack(pilot, 0))}
    return bits, {"draws": {"fading": stack(fading, 0),
                            "noise": (stack(data, 1), stack(pilot, 1))}}


@pytest.mark.parametrize("pipeline,kw", [
    ("siso", {}),
    ("spatial", dict(num_tx=4, num_rx=2)),                          # rank=None: min(tx, rx)
    ("spatial", dict(num_tx=4, num_rx=4, rank=3, detector_type="SIC")),
], ids=["siso", "spatial_4x2_rank_none_mmse", "spatial_4x4_rank3_sic"])
def test_counts_equal_the_jax_sweep_on_one_device(pipeline, kw):
    """The sweep's composition against ofdm_lte_tpu.parallel.sweep.ber_sweep:
    argument defaults (rank, velocity, detector), lane order (point-major),
    error sums and the per-point mean of the PAPR."""
    snrs, frames = [2.0, 9.0], 2
    jc = jcfg.LTEConfig(1.25, modulation="QPSK")
    key = jax.random.PRNGKey(7)
    j = jsweep.ber_sweep(key, jc, snrs, frames_per_device=frames, num_ofdm_symbols=SYMBOLS,
                         mesh=jsweep.make_mesh(jax.devices()[:1]), pipeline=pipeline, **kw)
    n_bits = tsweep._bits_per_frame(CFG, SYMBOLS, "lte", pipeline)
    num_tx, num_rx = kw.get("num_tx", 2), kw.get("num_rx", 2)
    rank_used = kw.get("rank") or min(num_tx, num_rx)
    bits, seams = _jax_sweep_inputs(key, pipeline, len(snrs), frames, n_bits, num_tx, num_rx,
                                    rank_used)
    t = ber_sweep(CFG, snrs, frames=frames, num_ofdm_symbols=SYMBOLS, pipeline=pipeline,
                  device="cpu", bits=torch.from_numpy(bits), seams=seams, **kw)
    assert t.frames == j.frames == frames
    assert t.total_bits.tolist() == np.asarray(j.total_bits).tolist()
    assert t.bit_errors.tolist() == np.asarray(j.bit_errors).tolist()
    assert t.bit_errors[0] > t.bit_errors[1] > 0
    np.testing.assert_allclose(t.ber, np.asarray(j.ber), rtol=1e-6)
    np.testing.assert_allclose(t.papr_db, np.asarray(j.papr_db), atol=1e-4)   # dB


@pytest.mark.parametrize("pipeline", ["siso", "simo", "sfbc", "spatial", "beamforming"])
def test_sweep_on_its_own_generator(pipeline):
    """Bits and channel from one generator: reproducible, falling with SNR,
    clean at 60 dB; bits per frame as in the JAX package."""
    jc = jcfg.LTEConfig(1.25, modulation="QPSK")
    assert tsweep._bits_per_frame(CFG, 28, "lte", pipeline) == \
        jsweep._bits_per_frame(jc, 28, "lte", pipeline)
    runs = [ber_sweep(CFG, [0.0, 60.0], frames=4, num_ofdm_symbols=SYMBOLS, pipeline=pipeline,
                      generator=torch.Generator().manual_seed(3), device="cpu")
            for _ in range(2)]
    assert runs[0].bit_errors.tolist() == runs[1].bit_errors.tolist()
    assert runs[0].bit_errors[0] > runs[0].bit_errors[1] == 0
    assert runs[0].papr_db.shape == (2,) and np.isfinite(runs[0].papr_db).all()


def test_spatial_rank_defaults_to_min_of_antennas():
    clear_link_cache()
    link = tsweep.sweep_link(CFG, "spatial", torch.device("cpu"), num_tx=4, num_rx=2)
    assert (link.rank_used, link.detector_type, link.channel_impl) == (2, "MMSE", "bins")
    assert tsweep.sweep_link(CFG, "spatial", torch.device("cpu"), num_tx=4, num_rx=4,
                             rank=3).rank_used == 3
    # the same arguments give the same link object
    assert tsweep.sweep_link(CFG, "spatial", torch.device("cpu"), num_tx=4, num_rx=2) is link


def _jax_lane_keys(key, n_points, frames, n_bits):
    """The bits and the per-lane keys of a JAX sweep on a one-device mesh."""
    kb, kc = jax.random.split(jax.random.fold_in(key, 0))
    bits = np.array(jax.random.bernoulli(kb, 0.5, (n_points, frames, n_bits)), np.int8)
    return bits, jax.random.split(kc, n_points * frames)


def test_coded_pipeline_against_the_jax_sweep_on_one_device():
    """Lane order, bits and per-lane AWGN of jsweep.ber_sweep(pipeline="coded"):
    PAPR equal, the clean point equal; at 0 dB every lane fails to decode in
    both, and a failed decode's error count moves with the LLRs' rounding."""
    snrs, frames = [0.0, 6.0], 2
    key = jax.random.PRNGKey(9)
    j = jsweep.ber_sweep(key, jcfg.LTEConfig(1.25, modulation="QPSK"), snrs,
                         frames_per_device=frames, mesh=jsweep.make_mesh(jax.devices()[:1]),
                         pipeline="coded", coded_tb_bits=CODED_BITS)
    bits, keys = _jax_lane_keys(key, len(snrs), frames, CODED_BITS)
    n = _coded_samples(coded.link_for(CFG, CODED_BITS, "cpu"))
    noise = [_jax_normals(k, (n,)) for k in keys]
    t = ber_sweep(CFG, snrs, frames=frames, pipeline="coded", coded_tb_bits=CODED_BITS,
                  device="cpu", bits=torch.from_numpy(bits),
                  seams={"draws": {"noise": tuple(np.stack([d[p] for d in noise])
                                                  for p in (0, 1))}})
    assert t.total_bits.tolist() == np.asarray(j.total_bits).tolist() == [2000, 2000]
    np.testing.assert_allclose(t.papr_db, np.asarray(j.papr_db), atol=1e-4)
    jerr = np.asarray(j.bit_errors)
    assert t.bit_errors[1] == jerr[1] == 0
    assert abs(int(t.bit_errors[0]) - int(jerr[0])) <= 0.25 * jerr[0] and jerr[0] > 0


def test_harq_sweep_counters_equal_the_jax_sweep_on_one_device():
    """jsweep.harq_sweep's exact integer counters under its own bits and
    per-lane, per-transmission draws (transmission t under fold_in(key, t))."""
    snrs, frames, rvs = [1.0, 6.0], 2, (0, 1, 2)
    key = jax.random.PRNGKey(4)
    j = jsweep.harq_sweep(key, jcfg.LTEConfig(1.25, modulation="QPSK"), snrs,
                          frames_per_device=frames, tb_bits=CODED_BITS, rv_sequence=rvs,
                          mesh=jsweep.make_mesh(jax.devices()[:1]))
    bits, keys = _jax_lane_keys(key, len(snrs), frames, CODED_BITS)
    n = _coded_samples(coded.link_for(CFG, CODED_BITS, "cpu"))
    noise = [[_jax_normals(jax.random.fold_in(k, tx), (n,)) for k in keys] for tx in range(3)]
    draws = {"noise": tuple(np.stack([np.stack([d[p] for d in per_t]) for per_t in noise])
                            for p in (0, 1))}
    t = harq_sweep(CFG, snrs, frames=frames, tb_bits=CODED_BITS, rv_sequence=rvs, device="cpu",
                   bits=torch.from_numpy(bits), seams={"draws": draws})
    assert t.frames == j.frames == frames
    for field in ("stage_failures", "tx_sum", "bit_errors", "tb_failures"):
        got, want = getattr(t, field), np.asarray(getattr(j, field))
        assert got.dtype == np.int64 and got.tolist() == want.tolist(), field
    np.testing.assert_allclose(t.bler_per_stage, np.asarray(j.bler_per_stage))
    np.testing.assert_allclose(t.avg_transmissions, np.asarray(j.avg_transmissions))
    assert t.stage_failures[0, 0] == frames and t.tx_sum[0] > frames      # 1 dB needs HARQ
    assert t.stage_failures[1].tolist() == [0, 0, 0] and t.tx_sum[1] == frames


def test_harq_sweep_counts_equal_the_batched_harq(rng):
    snrs, frames = [-2.0, 2.0], 3
    link = coded.link_for(CFG, CODED_BITS, "cpu")
    bits = torch.from_numpy(rng.integers(0, 2, (2, frames, CODED_BITS)).astype(np.int8))
    noise = _normals(rng, 4, 2 * frames, _coded_samples(link))
    t = harq_sweep(CFG, snrs, frames=frames, tb_bits=CODED_BITS, device="cpu", bits=bits,
                   seams={"draws": {"noise": noise}})
    r = link.harq(bits.reshape(2 * frames, -1), torch.tensor(snrs).repeat_interleave(frames),
                  draws={"noise": noise})
    fails = (~r.crc_pass_stage).reshape(2, frames, 4).sum(dim=1)
    assert t.stage_failures.tolist() == fails.tolist()
    assert t.tx_sum.tolist() == r.num_transmissions.reshape(2, frames).sum(dim=1).tolist()
    assert t.bit_errors.tolist() == r.bit_errors.reshape(2, frames).sum(dim=1).tolist()
    np.testing.assert_allclose(t.ber, t.bit_errors / (CODED_BITS * frames))
    assert t.tb_failures.tolist() == t.stage_failures[:, -1].tolist()


def test_unknown_arguments_raise():
    with pytest.raises(TypeError):
        ber_sweep(CFG, SNRS, device="cpu", frame_chunk=4)
    with pytest.raises(TypeError):
        ber_sweep(CFG, SNRS, device="cpu", mesh=None)
    with pytest.raises(ValueError, match="pipeline"):
        ber_sweep(CFG, SNRS, device="cpu", pipeline="nope")
    with pytest.raises(ValueError, match="bits"):
        ber_sweep(CFG, SNRS, frames=2, device="cpu", bits=torch.zeros(3, 2, 5, dtype=torch.int8))
    with pytest.raises(TypeError):
        harq_sweep(CFG, SNRS, device="cpu", mesh=None)
    with pytest.raises(ValueError, match="bits"):
        harq_sweep(CFG, SNRS, frames=2, tb_bits=40, device="cpu",
                   bits=torch.zeros(3, 2, 5, dtype=torch.int8))
