"""The port's NumPy tables against the JAX package's, and the port's
independence from JAX."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ofdm_lte_tpu import config as jcfg
from ofdm_lte_tpu import grid as jgrid
from ofdm_lte_tpu.ops import ofdm as jofdm

from ofdm_lte_tpu_torch import config as tcfg
from ofdm_lte_tpu_torch import grid as tgrid
from ofdm_lte_tpu_torch.ops import ofdm as tofdm
from ofdm_lte_tpu_torch.sim import siso as tsiso

torch.set_num_threads(2)

BANDWIDTHS = [1.25, 2.5, 5.0, 10.0, 15.0, 20.0]
MODULATIONS = ["QPSK", "16-QAM", "64-QAM"]


def test_profile_tables_equal():
    assert tcfg.LTE_PROFILES == jcfg.LTE_PROFILES
    assert tcfg.CP_VALUES_US == jcfg.CP_VALUES_US
    assert tcfg.BITS_PER_SYMBOL == jcfg.BITS_PER_SYMBOL
    assert tcfg.MODULATION_SCHEMES == jcfg.MODULATION_SCHEMES


@pytest.mark.parametrize("modulation", MODULATIONS)
@pytest.mark.parametrize("bw", BANDWIDTHS)
def test_lte_config_fields(bw, modulation):
    t = tcfg.LTEConfig(bw, modulation=modulation)
    j = jcfg.LTEConfig(bw, modulation=modulation)
    names = [f.name for f in dataclasses.fields(j)]
    assert [f.name for f in dataclasses.fields(t)] == names
    for name in names:
        assert getattr(t, name) == getattr(j, name), name
    assert t.get_info() == j.get_info()
    assert t.copy(modulation="QPSK") == tcfg.LTEConfig(bw, modulation="QPSK")


def test_lte_config_20mhz_numerology():
    cfg = tcfg.LTEConfig(20.0, modulation="64-QAM")
    g = tgrid.grid_for(cfg)
    assert (cfg.N, cfg.Nc, cfg.cp_length) == (2048, 1200, 144)
    assert (g.num_data, g.num_pilot) == (999, 200)


@pytest.mark.parametrize("bw", BANDWIDTHS)
def test_grid_tables_exact(bw):
    t = tcfg.LTEConfig(bw)
    tg, jg = tgrid.grid_for(t), jgrid.grid_for(jcfg.LTEConfig(bw))
    for f in ("N", "Nc", "guard_left", "guard_right", "dc_index"):
        assert getattr(tg, f) == getattr(jg, f)
    for f in ("data_idx", "pilot_idx", "guard_idx"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
        assert getattr(tg, f).dtype == getattr(jg, f).dtype
    np.testing.assert_array_equal(tgrid.pilot_sequence(0, tg.num_pilot),
                                  jgrid.pilot_sequence(0, jg.num_pilot))
    np.testing.assert_array_equal(tgrid.pilot_sequence(7, tg.num_pilot),
                                  jgrid.pilot_sequence(7, jg.num_pilot))
    for a, b in zip(tgrid.interp_table(t.N, t.Nc), jgrid.interp_table(t.N, t.Nc)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("layout", ["reference", "extended"])
@pytest.mark.parametrize("num_tx", [1, 2, 4, 8])
@pytest.mark.parametrize("bw", BANDWIDTHS)
def test_orthogonal_pilots_and_custom_interp_exact(bw, num_tx, layout):
    t, j = tcfg.LTEConfig(bw), jcfg.LTEConfig(bw)
    assert tgrid.pilot_step(num_tx, layout) == jgrid.pilot_step(num_tx, layout)
    ours = tgrid.orthogonal_pilot_indices(t, num_tx, layout)
    theirs = jgrid.orthogonal_pilot_indices(j, num_tx, layout)
    assert len(ours) == len(theirs) == num_tx
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        key = tuple(int(i) for i in a)
        for x, y in zip(tgrid.interp_table_custom(key, t.N), jgrid.interp_table_custom(key, j.N)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


def test_pilot_step_rejects_unknown_layout():
    with pytest.raises(ValueError):
        tgrid.pilot_step(2, "nope")


@pytest.mark.parametrize("bw", [1.25, 20.0])
def test_modem_consts_exact(bw):
    cfg = tcfg.LTEConfig(bw)
    g = tgrid.grid_for(cfg)
    for a, b in zip(tofdm._mod_consts(cfg.N, cfg.Nc, cfg.cp_length, 0),
                    jofdm._mod_consts(cfg.N, cfg.Nc, cfg.cp_length, 0)):
        np.testing.assert_array_equal(a, b)
    for bins in (g.data_idx, g.pilot_idx):
        key = tuple(int(b) for b in bins)
        for a, b in zip(tofdm._demod_consts(cfg.N, cfg.cp_length, key),
                        jofdm._demod_consts(cfg.N, cfg.cp_length, key)):
            np.testing.assert_array_equal(a, b)


def _jax_tables(cfg):
    """The link's tables by name, built with the JAX package's functions."""
    g = jgrid.grid_for(jcfg.LTEConfig(cfg.bandwidth, modulation=cfg.modulation))
    N, cp = cfg.N, cfg.cp_length
    B_re, B_im, pw_re, pw_im = jofdm._mod_consts(N, cfg.Nc, cp, 0)
    Gd = jofdm._demod_consts(N, cp, tuple(int(b) for b in g.data_idx))
    Gp = jofdm._demod_consts(N, cp, tuple(int(b) for b in g.pilot_idx))
    left, right, w = jgrid.interp_table(N, cfg.Nc)
    return {"mod_b_re": B_re, "mod_b_im": B_im,
            "pilot_wave_re": pw_re, "pilot_wave_im": pw_im,
            "demod_data_re": Gd[0], "demod_data_im": Gd[1],
            "demod_pilot_re": Gp[0], "demod_pilot_im": Gp[1],
            "interp_left": left, "interp_right": right, "interp_w": w,
            "pilot_seq": jgrid.pilot_sequence(0, g.num_pilot)}


@pytest.mark.parametrize("bw", [1.25, 20.0])
def test_load_reference_tables_round_trip(bw):
    cfg = tcfg.LTEConfig(bw, modulation="64-QAM")
    own = tsiso.SisoLink(cfg, device="cpu")
    loaded = tsiso.SisoLink(cfg, device="cpu")
    for buf in loaded.buffers():
        buf.zero_()
    loaded.load_reference_tables(_jax_tables(cfg))
    a, b = own.state_dict(), loaded.state_dict()
    # the three GEMMs' re and im planes, the pilot wave, the pilot sequence
    # and the three interpolation tables
    assert set(a) == set(b) and len(a) == 13
    for k in a:
        assert a[k].dtype == b[k].dtype
        assert a[k].is_contiguous() and b[k].is_contiguous(), k
        assert torch.equal(a[k], b[k]), k


def test_load_reference_tables_rejects_bad_input():
    cfg = tcfg.LTEConfig(1.25)
    link = tsiso.SisoLink(cfg, device="cpu")
    tables = _jax_tables(cfg)
    with pytest.raises(KeyError):
        link.load_reference_tables({k: v for k, v in tables.items() if k != "interp_w"})
    tables["mod_b_re"] = tables["mod_b_re"][:, :-1]
    with pytest.raises(ValueError):
        link.load_reference_tables(tables)


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor the JAX package."""
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import ofdm_lte_tpu_torch, ofdm_lte_tpu_torch.api, ofdm_lte_tpu_torch._build\n"
        "import ofdm_lte_tpu_torch.sim.siso, ofdm_lte_tpu_torch.channel.awgn\n"
        "import ofdm_lte_tpu_torch.ops.cmatmul, ofdm_lte_tpu_torch.precision\n"
        "import ofdm_lte_tpu_torch.sim.diversity, ofdm_lte_tpu_torch.channel.mimo\n"
        "import ofdm_lte_tpu_torch.channel.rayleigh, ofdm_lte_tpu_torch.ops.scfdm\n"
        "import ofdm_lte_tpu_torch.rx.alamouti, ofdm_lte_tpu_torch.rx.mimo_estimation\n"
        "import ofdm_lte_tpu_torch.utils.metrics\n"
        "import ofdm_lte_tpu_torch.mimo.layer_mapper, ofdm_lte_tpu_torch.mimo.codebook\n"
        "import ofdm_lte_tpu_torch.mimo.rank_adaptation, ofdm_lte_tpu_torch.mimo.detector\n"
        "import ofdm_lte_tpu_torch.sim.spatial, ofdm_lte_tpu_torch.sim.links\n"
        "import ofdm_lte_tpu_torch.parallel.sweep, ofdm_lte_tpu_torch.sim.beamforming\n"
        "import ofdm_lte_tpu_torch.mimo.beamforming, ofdm_lte_tpu_torch.mimo.csi\n"
        "import ofdm_lte_tpu_torch.coding.crc, ofdm_lte_tpu_torch.coding.segmentation\n"
        "import ofdm_lte_tpu_torch.coding.rate_matching, ofdm_lte_tpu_torch.coding.tables\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'ofdm_lte_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ofdm_lte_tpu)\b(?!_torch)", re.M)
    for src in (root / "ofdm_lte_tpu_torch").rglob("*.py"):
        assert not pattern.search(src.read_text()), src
