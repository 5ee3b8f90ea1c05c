"""The BER bands that chip_smoke.py holds its paths to, and where they come
from: the JAX package, run on the CPU at chip_smoke's configuration (20 MHz
64-QAM, 14 symbols; the coded paths' transport blocks) and working SNRs with
fewer lanes.

    JAX_PLATFORMS=cpu python tests/test_torch_chip_bands.py

prints the JAX_BER table to paste into chip_smoke.py: per path the mean
BER, the standard deviation of the per-lane BER, the lanes and the bits,
and for the coded paths the BLER after each transmission, then the
JAX_DECODE_BER table of phase 6's whole decode and the
JAX_BFCOMPARE_SFBC_BER table of phase 7's `bfcompare` SFBC rows (under a
minute on two cores for the SISO and diversity paths, about three more for
the four spatial ones, some 20 s for coded_6000_awgn, two minutes for
harq_75376_awgn, half a minute for the decode and 40 s for the SFBC rows;
path names on the command line, or `turbo_decode` or `bfcompare_sfbc`,
restrict the run). Its
output is kept beside this file, test_torch_chip_bands.txt. chip_smoke.py
then accepts a mean BER within 4σ, σ² = lane_std²·(1/lanes here + 1/lanes
there), and a BLER within 4σ, σ² = p(1−p)(1/lanes here + 1/lanes there)
(one-sided, about 3/64 wide, where the JAX BLER is 0 or 1). The working
SNRs of the coded paths were picked with this script: where the JAX BLER
of coded_6000_awgn lies between 0.2 and 0.8 (its waterfall runs from BLER
1.0 at 20.6 dB to 0.0 at 21.25), and where the first stage's BLER of
harq_75376_awgn is above 0.5, the fourth's below 0.2 and the second's
between 0.2 and 0.8 (16.2 dB; at 16.0 the stages read 1, 1, 1, 0.56 over
16 lanes, at 16.5 1, 0, 0, 0).
The test below holds chip_smoke's constants to that kept output; the port
itself is held to the JAX package under the same draws, at a small size,
by the other tests/test_torch_*.py."""
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.sim import beamforming as tbf
from ofdm_lte_tpu_torch.sim import diversity as tdiv
from ofdm_lte_tpu_torch.sim import siso as tsiso
from ofdm_lte_tpu_torch.sim import spatial as tspatial

torch.set_num_threads(2)

JAX_LANES = 64
JAX_DECODE_LANES = 256


def _n_bits(kind, cfg, mode="lte"):
    if kind == "sfbc":
        return tdiv.sfbc_bits_per_frame(cfg, chip_smoke.SYMBOLS)
    if kind == "spatial":
        return tspatial.bits_per_frame(cfg, chip_smoke.SYMBOLS)
    if kind == "beamforming":
        return tbf.bits_per_frame(cfg, chip_smoke.SYMBOLS)
    return tsiso.bits_per_frame(cfg, chip_smoke.SYMBOLS, mode)


def _path_bits(spec) -> int:
    if spec["kind"] == "coded":
        return spec["kw"]["tb_bits"]
    return _n_bits(spec["kind"], LTEConfig(20.0, modulation="64-QAM"),
                   spec["kw"].get("mode", "lte"))


def jax_ber(name, snr_db, lanes=JAX_LANES, seed=0):
    """Per-lane BER of the JAX package on one path of chip_smoke.PATHS."""
    import jax
    import jax.numpy as jnp
    from ofdm_lte_tpu import config as jcfg
    from ofdm_lte_tpu.sim import diversity as jdiv
    from ofdm_lte_tpu.sim import siso as jsiso
    jax.config.update("jax_platforms", "cpu")
    spec = chip_smoke.PATHS[name]
    cfg = jcfg.LTEConfig(20.0, modulation="64-QAM")
    n = _path_bits(spec)
    bits = np.random.default_rng(seed).integers(0, 2, (lanes, n)).astype(np.int8)
    if spec["kind"] == "coded":
        return _jax_coded(spec["kw"], bits, snr_db, cfg, seed), lanes * n
    if spec["kind"] == "spatial":
        return _jax_spatial_ber(spec["kw"], bits, snr_db, cfg, seed), lanes * n
    if spec["kind"] == "beamforming":
        return _jax_beamforming_ber(spec["kw"], bits, snr_db, cfg, seed), lanes * n
    fn = {"siso": jsiso.simulate_siso, "simo": jdiv.simulate_simo,
          "sfbc": jdiv.simulate_sfbc}[spec["kind"]]
    return np.asarray(fn(jax.random.PRNGKey(seed), jnp.asarray(bits), snr_db, cfg,
                         **spec["kw"]).ber, np.float64), lanes * n


def jax_decode_ber(K, sigma=None, lanes=JAX_DECODE_LANES, seed=None):
    """Per-block BER of the JAX package's turbo_decode (max-log,
    chip_smoke.DECODE_ITERATIONS iterations) on `lanes` random blocks of K
    bits, BPSK over AWGN of σ `sigma`: LLR = 2·(±1 + σ·n)/σ², drawn with
    numpy from `seed` (K by default)."""
    import jax
    import jax.numpy as jnp
    from ofdm_lte_tpu.coding import turbo as jturbo
    jax.config.update("jax_platforms", "cpu")
    sigma = chip_smoke.DECODE_SIGMA if sigma is None else sigma
    rng = np.random.default_rng(K if seed is None else seed)
    bits = rng.integers(0, 2, (lanes, K)).astype(np.int32)
    code = np.asarray(jturbo.turbo_encode(jnp.asarray(bits), K))
    llr = ((2.0 / sigma ** 2) * ((1.0 - 2.0 * code) + sigma * rng.standard_normal(code.shape)))
    out = jturbo.turbo_decode(jnp.asarray(llr, jnp.float32), K, chip_smoke.DECODE_ITERATIONS,
                              use_max_log=True)
    return (np.asarray(out) != bits).mean(axis=1)


def bfcompare_defaults():
    """The arguments `bfcompare` runs with when given none (the CLI's parser)."""
    from ofdm_lte_tpu_torch import cli
    return cli.build_parser().parse_args(["bfcompare"])


def jax_bfcompare_sfbc_ber(num_rx, lanes=JAX_LANES):
    """Per-run BER of the JAX package on `bfcompare`'s 2×num_rx SFBC row at
    its defaults (10 MHz 64-QAM, 15 dB): the CLI's payload, 1,620,000 bits
    from default_rng(seed), padded to whole symbols and run as ONE frame
    through simulate_sfbc over the fixed-phase AWGN channel, as
    run_bf_comparison runs it, `lanes` times under keys folded from 0."""
    import jax
    import jax.numpy as jnp
    from ofdm_lte_tpu import config as jcfg
    from ofdm_lte_tpu.sim import diversity as jdiv
    jax.config.update("jax_platforms", "cpu")
    d = bfcompare_defaults()
    cfg = jcfg.LTEConfig(d.bandwidth, modulation=d.modulation)
    bits = np.random.default_rng(d.seed).integers(0, 2, d.num_bits).astype(np.int32)
    per = jdiv.sfbc_bits_per_frame(cfg, 1)
    padded = np.zeros(-(-d.num_bits // per) * per, np.int32)
    padded[:d.num_bits] = bits
    bers = []
    for i in range(lanes):
        r = jdiv.simulate_sfbc(jax.random.fold_in(jax.random.PRNGKey(0), i),
                               jnp.asarray(padded), d.snr, cfg, num_rx=num_rx,
                               channel_type="awgn")
        bers.append(np.mean(np.asarray(r.bits_rx)[:d.num_bits] != bits))
    return np.asarray(bers, np.float64)


def _jax_spatial_ber(link_kw, bits, snr_db, cfg, seed, chunk=16):
    """The spatial link's arguments as the JAX function takes them
    (`rank_used` is its `rank`, `channel_impl` its environment variable), run
    `chunk` lanes at a time under keys folded from the seed: the multipath
    tap planes of all lanes at once would take gigabytes here."""
    import jax
    import jax.numpy as jnp
    from ofdm_lte_tpu.sim import spatial as jspatial
    kw = dict(link_kw)
    kw["rank"] = kw.pop("rank_used")
    impl = kw.pop("channel_impl", None)
    saved = os.environ.get("OFDM_LTE_TPU_SPATIAL_CHANNEL")
    if impl is not None:
        os.environ["OFDM_LTE_TPU_SPATIAL_CHANNEL"] = impl
    try:
        bers = [np.asarray(jspatial.simulate_spatial_multiplexing(
            jax.random.fold_in(jax.random.PRNGKey(seed), i), jnp.asarray(bits[i:i + chunk]),
            snr_db, cfg, **kw).ber, np.float64) for i in range(0, len(bits), chunk)]
    finally:
        if impl is not None:
            if saved is None:
                del os.environ["OFDM_LTE_TPU_SPATIAL_CHANNEL"]
            else:
                os.environ["OFDM_LTE_TPU_SPATIAL_CHANNEL"] = saved
    return np.concatenate(bers)


def _jax_beamforming_ber(link_kw, bits, snr_db, cfg, seed):
    """The beamforming link's arguments as the JAX functions take them: the
    static channel's simulate_beamforming, or with channel_model "jakes"
    simulate_beamforming_time_varying."""
    import jax
    import jax.numpy as jnp
    from ofdm_lte_tpu.sim import beamforming as jbf
    kw = dict(link_kw)
    fn = (jbf.simulate_beamforming_time_varying if kw.pop("channel_model", "static") == "jakes"
          else jbf.simulate_beamforming)
    return np.asarray(fn(jax.random.PRNGKey(seed), jnp.asarray(bits), snr_db, cfg, **kw).ber,
                      np.float64)


def _jax_coded(link_kw, bits, snr_db, cfg, seed):
    """(per-lane BER, BLER after each transmission) of the JAX package's
    batched coded chain: one transmission, or HARQ over the rv sequence."""
    import jax
    import jax.numpy as jnp
    from ofdm_lte_tpu.sim import coded as jcoded
    rvs, key = link_kw["rv_sequence"], jax.random.PRNGKey(seed)
    if len(rvs) == 1:
        r = jcoded.simulate_siso_coded_batched(key, jnp.asarray(bits, jnp.int32), snr_db, cfg,
                                               rv=rvs[0])
        passed = np.asarray(r.crc_pass)[:, None]
    else:
        r = jcoded.simulate_siso_coded_harq_batched(key, jnp.asarray(bits, jnp.int32), snr_db,
                                                    cfg, rv_sequence=rvs)
        passed = np.asarray(r.crc_pass_stage)
    return np.asarray(r.ber, np.float64), 1.0 - passed.mean(axis=0)


def _kept_section(table: str) -> str:
    """The lines of one table (`JAX_BER = {` to its `}`) of the kept output."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "test_torch_chip_bands.txt")) as f:
        text = f.read()
    start = text.index(table + " = {")
    return text[start:text.index("\n}", start)]


def kept_output() -> dict:
    """The JAX_BER table as the generator printed it."""
    rows = re.findall(r'"(\w+)": dict\(mean=(\S+), lane_std=(\S+), lanes=(\d+), bits=(\d+)'
                      r'(?:, bler=\[([^\]]*)\])?\)', _kept_section("JAX_BER"))
    out = {}
    for name, mean, std, lanes, bits, bler in rows:
        out[name] = dict(mean=float(mean), lane_std=float(std), lanes=int(lanes), bits=int(bits))
        if bler:
            out[name]["bler"] = [float(p) for p in bler.split(",")]
    return out


def _kept_int_keyed(table: str) -> dict:
    rows = re.findall(r'(\d+): dict\(mean=(\S+), lane_std=(\S+), lanes=(\d+), bits=(\d+)\)',
                      _kept_section(table))
    return {int(k): dict(mean=float(mean), lane_std=float(std), lanes=int(lanes), bits=int(bits))
            for k, mean, std, lanes, bits in rows}


def kept_decode_output() -> dict:
    """The JAX_DECODE_BER table as the generator printed it."""
    return _kept_int_keyed("JAX_DECODE_BER")


def kept_bfcompare_output() -> dict:
    """The JAX_BFCOMPARE_SFBC_BER table as the generator printed it."""
    return _kept_int_keyed("JAX_BFCOMPARE_SFBC_BER")


@pytest.mark.parametrize("name", list(chip_smoke.PATHS))
def test_band_constants_are_the_generator_output(name):
    spec, ref = chip_smoke.PATHS[name], chip_smoke.JAX_BER[name]
    assert ref == kept_output()[name]
    assert ref["lanes"] == JAX_LANES and ref["bits"] == JAX_LANES * _path_bits(spec)
    lo, hi = chip_smoke.ber_band(ref, chip_smoke.LANES)
    if spec["kind"] == "coded":
        # a HARQ schedule that every lane passes leaves no residual error
        assert 0.0 <= lo <= ref["mean"] <= hi < 0.6
        bler = ref["bler"]
        assert len(bler) == len(spec["kw"]["rv_sequence"])
        assert all(0.0 <= p <= 1.0 for p in bler) and list(bler) == sorted(bler, reverse=True)
        if len(bler) == 1:
            assert 0.2 <= bler[0] <= 0.8                      # mid-waterfall
        else:                                               # HARQ combining recovers,
            assert bler[0] > 0.5 and bler[-1] < 0.2 and 0.2 < bler[1] < 0.8  # on the waterfall
    else:
        assert 0.0 <= lo < ref["mean"] < hi < 0.6


@pytest.mark.parametrize("shape", chip_smoke.DECODE_SHAPES, ids=lambda s: s[0])
def test_decode_band_constants_are_the_generator_output(shape):
    _, n_blocks, K = shape
    ref = chip_smoke.JAX_DECODE_BER[K]
    assert ref == kept_decode_output()[K]
    assert ref["lanes"] == JAX_DECODE_LANES and ref["bits"] == JAX_DECODE_LANES * K
    # on the waterfall: some blocks fail, and the band is far from the BER of
    # a decoder that fails every block (about 0.35 at σ 0.75)
    lo, hi = chip_smoke.ber_band(ref, n_blocks)
    assert 0.0 < lo < ref["mean"] < hi < 0.3


@pytest.mark.parametrize("num_rx", [1, 2, 4])
def test_bfcompare_band_constants_are_the_generator_output(num_rx):
    ref = chip_smoke.JAX_BFCOMPARE_SFBC_BER[num_rx]
    assert ref == kept_bfcompare_output()[num_rx]
    assert ref["lanes"] == JAX_LANES and ref["bits"] == JAX_LANES * bfcompare_defaults().num_bits
    # the card runs the row once: a band for one run
    lo, hi = chip_smoke.ber_band(ref, 1)
    assert 0.0 < lo < ref["mean"] < hi < 0.1


def test_bler_band():
    # a BLER of 0 or 1 over 64 JAX lanes: one-sided, about 3/64 wide
    lo, hi = chip_smoke.bler_band(0.0, 256)
    assert lo == 0.0 and 2.5 / 64 < hi < 3.5 / 64
    lo1, hi1 = chip_smoke.bler_band(1.0, 256)
    assert hi1 == 1.0 and abs(lo1 - (1.0 - hi)) < 1e-12
    lo, hi = chip_smoke.bler_band(0.5, 256)
    assert abs(0.5 - lo - 4 * np.sqrt(0.25 * (1 / 256 + 1 / 64))) < 1e-12 and hi == 1.0 - lo
    # a coded path with no residual failure: BER below half the BLER limit
    ref = dict(mean=0.0, lane_std=0.0, lanes=64, bits=64, bler=[1.0, 0.0])
    assert chip_smoke.ber_band(ref, 256) == (0.0, 0.5 * chip_smoke.bler_band(0.0, 256)[1])


if __name__ == "__main__":
    # the paths named on the command line (`turbo_decode` for phase 6's
    # decode, `bfcompare_sfbc` for phase 7's SFBC rows), or all of them
    wanted = sys.argv[1:] or list(chip_smoke.PATHS) + ["turbo_decode", "bfcompare_sfbc"]
    paths = [path for path in chip_smoke.PATHS if path in wanted]
    if paths:
        print("JAX_BER = {")
    for path in paths:
        spec_ = chip_smoke.PATHS[path]
        clean_snr = chip_smoke.CODED_CLEAN_SNR if spec_["kind"] == "coded" else 60.0
        ber, n_bits = jax_ber(path, spec_["snr"])
        clean, _ = jax_ber(path, clean_snr, lanes=8)
        extra = ""
        if spec_["kind"] == "coded":                # (per-lane BER, BLER by stage)
            (ber, bler), clean = ber, clean[0]
            extra = f", bler=[{', '.join(f'{p:.6g}' for p in bler)}]"
        print(f'    "{path}": dict(mean={ber.mean():.6g}, lane_std={ber.std(ddof=1):.6g}, '
              f'lanes={JAX_LANES}, bits={n_bits}{extra}),   # {spec_["snr"]} dB; at '
              f'{clean_snr:g} dB, 8 lanes: {clean.mean():.3g}', flush=True)
    if paths:
        print("}")
    if "bfcompare_sfbc" in wanted:
        print("JAX_BFCOMPARE_SFBC_BER = {")
        for rx in (1, 2, 4):
            ber = jax_bfcompare_sfbc_ber(rx)
            print(f'    {rx}: dict(mean={ber.mean():.6g}, lane_std={ber.std(ddof=1):.6g}, '
                  f'lanes={JAX_LANES}, bits={JAX_LANES * bfcompare_defaults().num_bits}),'
                  f'   # 2x{rx} SFBC, one frame of the whole payload a run', flush=True)
        print("}")
    if "turbo_decode" in wanted:
        print("JAX_DECODE_BER = {")
        for _, _, K_ in chip_smoke.DECODE_SHAPES:
            ber = jax_decode_ber(K_)
            above = jax_decode_ber(K_, sigma=0.75, lanes=JAX_LANES)
            print(f'    {K_}: dict(mean={ber.mean():.6g}, lane_std={ber.std(ddof=1):.6g}, '
                  f'lanes={JAX_DECODE_LANES}, bits={JAX_DECODE_LANES * K_}),   # sigma '
                  f'{chip_smoke.DECODE_SIGMA}; at sigma 0.75, {JAX_LANES} lanes: '
                  f'{above.mean():.6g}, blocks decoded {int((above == 0).sum())}', flush=True)
        print("}")
