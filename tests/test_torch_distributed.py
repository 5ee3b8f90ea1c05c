"""The N-process sweeps over torch.distributed (parallel.distributed,
parallel.sweep with a layout, parallel.mp_bench's workers) on the CPU: two
gloo ranks in fresh interpreters give exactly the counts of the
one-process sweep under the same global bits and seams, for every pipeline
and HARQ, on the 1-D layout and on 2 SNR shards over 3 points; their
layout equals the JAX package's 2-D mesh on the virtual CPU devices."""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu.parallel import sweep as jsweep

import ofdm_lte_tpu_torch
from ofdm_lte_tpu_torch.parallel import distributed, mp_bench
from ofdm_lte_tpu_torch.parallel.sweep import ber_sweep, take_lanes

torch.set_num_threads(2)

BASE = {"bandwidth": 1.25, "modulation": "QPSK", "symbols": 14, "frames": 2, "seed": 11}
PIPELINES = {"siso": {}, "simo": {"num_rx": 2}, "sfbc": {"num_rx": 2},
             "spatial": {"num_tx": 2, "num_rx": 2}, "beamforming": {"num_tx": 4, "num_rx": 2},
             "coded": {"tb_bits": 104}}
SNRS = {1: [0.0, 8.0], 2: [0.0, 4.0, 8.0]}         # SNR shards -> points (3 pad to 4)
CASES = {f"{p}-{k}shard": {**BASE, "pipeline": p, "snr": SNRS[k], "shards": k, **kw}
         for k in (1, 2) for p, kw in PIPELINES.items()}
for k, snr in ((1, [-2.0, 6.0]), (2, [-2.0, 2.0, 6.0])):
    CASES[f"harq-{k}shard"] = {**BASE, "pipeline": "harq", "snr": snr, "shards": k,
                               "tb_bits": 104, "rv": [0, 1], "iterations": 2}
CASES["siso-drawn"] = {**BASE, "pipeline": "siso", "snr": [6.0, 60.0], "seams": False}


@pytest.fixture(scope="module")
def two_ranks():
    """Every case in two gloo ranks, spawned once: {case: (rank 0, rank 1)}."""
    ranks = mp_bench.spawn(2, [{"job": "case", "case": c} for c in CASES.values()], "cpu",
                           timeout_s=300)
    return {name: (ranks[0][i], ranks[1][i]) for i, name in enumerate(CASES)}


def _counts(res):
    return {k: v for k, v in res.items() if k not in ("launches", "share")}


@pytest.mark.parametrize("name", [n for n in CASES if n != "siso-drawn"])
def test_two_ranks_equal_the_one_process_sweep(two_ranks, name):
    case = CASES[name]
    mc = 2 // case["shards"]
    r0, r1 = (_counts(r) for r in two_ranks[name])
    one = mp_bench.run_case({**case, "frames": case["frames"] * mc}, None, "cpu")
    assert r0 == r1                                       # both ranks hold the reduced counts
    assert r0["frames"] == one["frames"] == case["frames"] * mc
    assert r0["snr_db"] == np.float32(case["snr"]).tolist()   # the padding is trimmed
    for key, want in one.items():
        if key == "papr_db":
            np.testing.assert_allclose(r0[key], want, rtol=1e-6)
        else:
            assert r0[key] == want, key
    assert two_ranks[name][0]["launches"] == {"tf32x3": 0, "turbo_bcjr": 0}   # CPU: no kernel
    # the reduction is the sum of each rank's lanes run as a one-device sweep
    for key in ("bit_errors", "stage_failures", "tx_sum"):
        if key in one:
            assert mp_bench.sum_of_shares(two_ranks[name], key, len(case["snr"])) == r0[key]


def test_drawn_sweep_ranks_agree_and_differ_from_one_process(two_ranks):
    """Without seams each rank draws from its own generator: the reduced
    counts agree, are those of 4 frames a point, and are not the
    one-process stream's."""
    r0, r1 = (_counts(r) for r in two_ranks["siso-drawn"])
    case = CASES["siso-drawn"]
    assert r0 == r1 and r0["frames"] == 4 and r0["bit_errors"][1] == 0
    one = mp_bench.run_case({**case, "frames": 4}, None, "cpu")
    assert one["bit_errors"][0] > 0 and r0["bit_errors"][0] > 0
    assert r0["bit_errors"][0] != one["bit_errors"][0]


def test_2d_layout_matches_the_jax_mesh(two_ranks):
    """2 SNR shards over 3 points on two ranks: the trimmed SNR axis, the
    counts' shape and `frames` equal JAX's ber_sweep on a 2×1 mesh of the
    virtual CPU devices, frames_per_device alike."""
    mesh = jsweep.make_mesh_2d(2, jax.devices()[:2])
    assert dict(mesh.shape) == {"snr": 2, "mc": 1}
    j = jsweep.ber_sweep(jax.random.PRNGKey(0), jcfg.LTEConfig(1.25, modulation="QPSK"),
                         SNRS[2], frames_per_device=BASE["frames"], num_ofdm_symbols=14,
                         mesh=mesh)
    t = two_ranks["siso-2shard"][0]
    assert t["snr_db"] == np.asarray(j.snr_db).tolist()
    assert t["frames"] == j.frames == BASE["frames"]
    assert len(t["bit_errors"]) == np.asarray(j.bit_errors).shape[0] == 3
    assert t["total_bits"] == np.asarray(j.total_bits).tolist()


def test_one_process_layout_and_its_errors():
    lay = distributed.layout(1, "cpu")
    assert lay == distributed.Layout(1, 0, 1, 1, 0, 0, torch.device("cpu"))
    with pytest.raises(ValueError) as ours:
        distributed.layout(2, "cpu")
    with pytest.raises(ValueError) as theirs:
        jsweep.make_mesh_2d(2, jax.devices()[:1])
    assert str(ours.value) == str(theirs.value) == "1 devices not divisible into 2 SNR shards"
    assert distributed.initialize() is False                    # one process: a no-op
    with pytest.raises(RuntimeError, match="2 attempts"):
        distributed.initialize("tcp://127.0.0.1:1", world_size=2, rank=1, backend="gloo",
                               retries=2, retry_delay_s=0.0, timeout_s=1.0)
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_is_the_one_device_call():
    """layout(1) without a group runs today's sweep, bit for bit."""
    cfg = ofdm_lte_tpu_torch.LTEConfig(1.25, modulation="QPSK")
    out = []
    for lay in (None, distributed.layout(1, "cpu")):
        gen = torch.Generator().manual_seed(3)
        out.append(ber_sweep(cfg, [2.0, 8.0], frames=3, num_ofdm_symbols=14, generator=gen,
                             device="cpu" if lay is None else None, layout=lay))
    assert out[0].bit_errors[0] > 0
    for a, b in zip(*out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rank_generators_are_distinct_and_reproducible():
    draws = {}
    for rank in (0, 1, 0):
        caller = torch.Generator().manual_seed(7)
        gen = distributed.rank_generator(caller, rank, "cpu")
        draws.setdefault(rank, []).append(torch.rand(4, generator=gen))
    torch.testing.assert_close(draws[0][0], draws[0][1], rtol=0, atol=0)
    assert not torch.equal(draws[0][0], draws[1][0])
    other = distributed.rank_generator(torch.Generator().manual_seed(8), 0, "cpu")
    assert not torch.equal(torch.rand(4, generator=other), draws[0][0])


LAYOUTS = {
    "lanes first (lanes, S, n)": ((6, 3, 2), 0, 1),
    "RX first (rx, lanes, T)": ((2, 6, 5), 1, 1),
    "folded phases (links·lanes·taps, 16)": ((3 * 6 * 4, 16), 0, 3),
    "Jakes (16, lanes·rx·tx)": ((16, 6 * 8), 1, 1),
    "HARQ (T, lanes, n)": ((4, 6, 5), 1, 1),
    "HARQ phases (T, lanes·taps, 16)": ((4, 6 * 4, 16), 1, 1),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_take_lanes_unfolds_every_seam_layout(layout, kind):
    """Each entry holds its lane number: the lanes taken are the asked ones,
    in order, with the links before them and the taps after them kept."""
    shape, axis, before = LAYOUTS[layout]
    lanes, idx = 6, [4, 1, 5]
    n = shape[axis]
    after = n // (before * lanes)
    lane_of = (np.arange(n) // after) % lanes                   # (before, lane, after) order
    x = np.broadcast_to(np.expand_dims(lane_of, [a for a in range(len(shape)) if a != axis]),
                        shape).astype(np.float32)
    if kind == "torch":
        x = torch.from_numpy(x.copy())
    y = take_lanes(x, axis, lanes, idx, before)
    assert type(y) is type(x)
    rows = np.moveaxis(np.asarray(y), axis, 0)
    want = np.tile(np.repeat(idx, after), before)               # (before, idx, after) order
    assert rows.shape == (before * len(idx) * after,) + tuple(np.delete(shape, axis))
    assert (rows.reshape(len(want), -1) == want[:, None]).all()
    with pytest.raises(ValueError):
        take_lanes(x, axis, 7, idx, before)


def test_dryrun_on_two_processes():
    out = distributed.dryrun(2, "cpu")
    assert out["siso"][1] == 0.0 and out["snr_x_mc"][1] == 0.0 and out["coded"] == [0.0]
    assert out["spatial2x2"][0] < 0.1 and out["harq_bler"] == [0.0]
    assert {"sfbc2x1", "simo1x4", "beamforming4x2"} <= set(out)


NEW_MODULES = ["parallel/distributed.py", "parallel/mp_bench.py", "parallel/sweep.py",
               "native_ext.py", "utils/profiling.py", "coding/crc.py", "cli.py"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_imports_no_jax_nor_the_jax_package(module):
    """No import anywhere in the module of jax or ofdm_lte_tpu (the card's
    machine has no JAX), and none of PIL or matplotlib at module level."""
    path = pathlib.Path(ofdm_lte_tpu_torch.__file__).parent / module
    tree = ast.parse(path.read_text())

    def names(node):
        if isinstance(node, ast.Import):
            return [a.name for a in node.names]
        if isinstance(node, ast.ImportFrom):
            return [("." * node.level) + (node.module or "")]
        return []

    for node in ast.walk(tree):
        for n in names(node):
            assert n.split(".")[0] not in ("jax", "jaxlib", "ofdm_lte_tpu"), (module, n)
    for node in tree.body:
        for n in names(node):
            assert n.split(".")[0] not in ("PIL", "matplotlib"), (module, n)


ENTRY_POINTS = {
    "layout": lambda: distributed.layout(1),
    "rank_device": lambda: distributed.rank_device(None),
    "ber_sweep layout": lambda: ber_sweep(ofdm_lte_tpu_torch.LTEConfig(1.25), [0.0], frames=1,
                                          layout=distributed.layout(1)),
    "spawn": lambda: mp_bench.spawn(1, [], None),
    "dryrun": lambda: distributed.dryrun(2),
    "measure": lambda: mp_bench.measure((1,)),
    "run_case": lambda: mp_bench.run_case(CASES["siso-1shard"]),
    "case_inputs": lambda: mp_bench.case_inputs(CASES["siso-1shard"]),
    "scaling_efficiency": lambda: distributed.scaling_efficiency(
        ofdm_lte_tpu_torch.LTEConfig(1.25), (1,)),
}


@pytest.mark.parametrize("device,ranks,want", [("cpu", 2, "gloo"), ("cuda", 2, "nccl"),
                                                ("cuda", 3, "gloo"), ("cuda:0", 2, "gloo"),
                                                ("cuda:1", 1, "gloo")])
def test_backend_for_takes_nccl_only_for_a_card_a_rank(monkeypatch, device, ranks, want):
    """On a host of two cards: NCCL when each rank has a card of its own,
    gloo for CPU ranks, more ranks than cards, or a card named by index
    (every rank on it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    assert distributed.backend_for(device, ranks) == want


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_no_device_and_no_card_raises(entry, monkeypatch):
    """The new entry points take the card when given no device, and raise
    where there is none: they never carry on on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[entry]()
