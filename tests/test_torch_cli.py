"""The port's CLI (ofdm_lte_tpu_torch/cli.py) against the JAX package's
(ofdm_lte_tpu/cli.py): the cases of tests/test_cli.py at 1.25 MHz, each
command run in-process through cli.main(argv) with `--device cpu`, and held
to the JAX CLI on the same arguments where the two can agree (printed
numerology, PAPR, JSON keys, the parser, the published table, a checkpoint
the JAX CLI wrote)."""
import json
import os

import numpy as np
import pytest
import torch

from ofdm_lte_tpu import cli as jcli
from ofdm_lte_tpu_torch import cli

torch.set_num_threads(2)

PIPELINES = ["siso", "siso-coded", "harq", "simo", "miso", "mimo", "beamforming", "spatial"]


def _run(capsys, module, argv):
    module.main(argv)
    return capsys.readouterr().out


def _port(capsys, argv):
    return _run(capsys, cli, argv + ["--device", "cpu"])


@pytest.mark.parametrize("argv", [["--bandwidth", "1.25"],
                                  ["--bandwidth", "20", "--modulation", "64-QAM"],
                                  ["--bandwidth", "5", "--cp-type", "extended"]],
                         ids=["1.25MHz", "20MHz-64QAM", "5MHz-extended-cp"])
def test_info_prints_the_jax_lines(capsys, argv):
    ours = _port(capsys, ["info"] + argv)
    assert "Data Subcarriers" in ours
    assert ours == _run(capsys, jcli, ["info"] + argv)


def test_papr_matches_jax(capsys, tmp_path):
    png = str(tmp_path / "ccdf.png")
    argv = ["papr", "--bandwidth", "1.25", "--num-symbols", "40", "--seed", "3"]
    ours = json.loads(_port(capsys, argv + ["--plot", png]))
    ref = json.loads(_run(capsys, jcli, argv))
    assert list(ours) == list(ref)
    for label, row in ref.items():
        assert list(ours[label]) == list(row)
        for k, v in row.items():
            assert abs(ours[label][k] - v) < 1e-3, (label, k)
    # SC-FDM must show lower PAPR than plain OFDM
    assert ours["QPSK/SC-FDM"]["mean_db"] < ours["QPSK/OFDM"]["mean_db"]
    assert os.path.getsize(png) > 0


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_run_keys_match_jax(capsys, tmp_path, pipeline):
    argv = ["run", "--bandwidth", "1.25", "--snr", "60", "--num-bits", "2000",
            "--pipeline", pipeline, "--rank", "2"]
    extra = []
    if pipeline == "siso":
        extra = ["--constellation", str(tmp_path / "const.png")]
    ours = json.loads(_port(capsys, argv + extra))
    ref = json.loads(_run(capsys, jcli, argv))
    ours.pop("wall_time_s")
    ref.pop("wall_time_s")
    assert sorted(ours) == sorted(ref)
    assert ours["transmitted_bits"] == ref["transmitted_bits"] == 2000
    if ref["ber"] == 0.0:
        assert ours["ber"] == 0.0
    if pipeline == "siso":
        assert os.path.getsize(tmp_path / "const.png") > 0


def test_published_table_is_the_jax_one():
    assert cli.PUBLISHED_BF_COMPARISON == jcli.PUBLISHED_BF_COMPARISON


def _options(parser):
    """{subcommand: {dest: (flags, default, choices, type, required)}}."""
    sub = next(a for a in parser._actions if a.choices and a.dest == "command")
    out = {}
    for name, sp in sub.choices.items():
        out[name] = {a.dest: (tuple(a.option_strings), a.default, a.choices,
                              getattr(a.type, "__name__", a.type), a.required)
                     for a in sp._actions if a.dest != "help"}
        out[name]["defaults"] = {k: v for k, v in sp._defaults.items() if k != "fn"}
    return out


def test_parser_matches_jax_but_device_and_frame_chunk():
    ours, ref = _options(cli.build_parser()), _options(jcli.build_parser())
    assert list(ours) == list(ref)
    for name in ref:
        assert ours[name].pop("device")[:2] == (("--device",), None)
        if name == "sweep":
            assert ref[name].pop("frame_chunk")[0] == ("--frame-chunk",)
            # the same flag, default and type; only its help differs
            assert ours[name]["snr_shards"] == ref[name]["snr_shards"]
        assert ours[name] == ref[name], name


def test_snr_shards_above_one_raises(capsys):
    for pipeline in ("siso", "harq"):
        with pytest.raises(ValueError, match="A19"):
            _port(capsys, ["sweep", "--bandwidth", "1.25", "--pipeline", pipeline,
                           "--snr-shards", "2"])


SWEEP = ["sweep", "--bandwidth", "1.25", "--snr-min", "4", "--snr-max", "8", "--snr-step",
         "4", "--frames", "1", "--num-symbols", "14"]


def test_resumes_a_jax_checkpoint(capsys, tmp_path):
    """The state a JAX sweep banked carries over: the port adds its round."""
    ckpt = str(tmp_path / "state.json")
    argv = SWEEP + ["--checkpoint", ckpt]
    _run(capsys, jcli, argv)
    jax_state = json.load(open(ckpt))
    out = json.loads(_port(capsys, argv))
    state = json.load(open(ckpt))
    from ofdm_lte_tpu_torch import LTEConfig
    from ofdm_lte_tpu_torch.sim import siso
    per_round = siso.bits_per_frame(LTEConfig(1.25), 14)
    assert state["workload"] == jax_state["workload"] == "siso/QPSK/1.25/2x2/awgn"
    assert state["rounds"] == 2 and len(state["round_bers"]) == 2
    assert state["round_bers"][0] == jax_state["round_bers"][0]
    assert state["total"] == [t + per_round for t in jax_state["total"]]
    assert all(e >= j for e, j in zip(state["errors"], jax_state["errors"]))
    assert out["total_bits"] == state["total"]
    assert out["ci_method"] == "t-dist over rounds"


def test_resumed_sweep_draws_new_rounds(capsys, tmp_path):
    """A resumed round is not the banked one redrawn; the same runs give the
    same states (cf. test_cli_sweep_checkpoint_resume)."""
    states = []
    for name in ("a.json", "b.json"):
        ckpt, png = str(tmp_path / name), str(tmp_path / "ber.png")
        argv = SWEEP + ["--checkpoint", ckpt, "--plot", png]
        out1 = json.loads(_port(capsys, argv))
        state1 = json.load(open(ckpt))
        out2 = json.loads(_port(capsys, argv))
        states.append(json.load(open(ckpt)))
        assert out1["snr_db"] == [4.0, 8.0] and out1["ci_method"] == "binomial"
        assert out2["ci_method"] == "t-dist over rounds" and len(out2["ber_ci95"]) == 2
        assert states[-1]["rounds"] == 2
        assert states[-1]["total"] == [2 * t for t in state1["total"]]
        assert os.path.getsize(png) > 0
    first, second = states[0]["round_bers"]
    assert first[0] > 0.0 and first[0] != second[0]     # 4 dB QPSK is noisy
    assert states[0] == states[1]


def test_harq_sweep_keys_and_checkpoint(capsys, tmp_path):
    """The HARQ sweep's JSON is the JAX CLI's, and its integer counters
    accumulate across runs, from a checkpoint the JAX CLI wrote too."""
    ckpt = str(tmp_path / "harq.json")
    argv = ["sweep", "--bandwidth", "1.25", "--pipeline", "harq", "--snr-min", "0",
            "--snr-max", "30", "--snr-step", "30", "--frames", "2", "--tb-bits", "104",
            "--rv-sequence", "0,1", "--checkpoint", ckpt]
    ref = json.loads(_run(capsys, jcli, argv))
    jax_state = json.load(open(ckpt))
    out1 = json.loads(_port(capsys, argv))
    state1 = json.load(open(ckpt))
    out2 = json.loads(_port(capsys, argv))
    state2 = json.load(open(ckpt))
    banked = jax_state["frames"]
    assert list(out1) == list(ref) == ["snr_db", "bler", "bler_per_stage",
                                       "avg_transmissions", "ber", "tbs_per_point",
                                       "rv_sequence"]
    assert list(state2) == list(jax_state)
    assert state2["workload"] == jax_state["workload"] == "harq/QPSK/1.25/awgn/tb104/rv0,1"
    assert (out1["tbs_per_point"], out2["tbs_per_point"]) == (banked + 2, banked + 4)
    for out in (out1, out2):
        assert out["snr_db"] == [0.0, 30.0] and out["rv_sequence"] == [0, 1]
        assert out["bler"][1] == 0.0 and out["avg_transmissions"][1] == 1.0
        assert out["bler_per_stage"][0][1] <= out["bler_per_stage"][0][0]
    for key in ("tb_failures", "tx_sum", "errors"):
        assert all(a <= b <= c for a, b, c in zip(jax_state[key], state1[key], state2[key]))
    assert state2["tx_sum"][1] == banked + 4


def test_spatial_sweep_with_detector_and_rank(capsys):
    out = json.loads(_port(capsys, [
        "sweep", "--bandwidth", "1.25", "--pipeline", "spatial", "--detector", "SIC",
        "--rank", "2", "--snr-min", "30", "--snr-max", "30", "--snr-step", "1",
        "--frames", "1", "--num-symbols", "14"]))
    assert out["ber"] == [0.0]


def test_fullsweep_keys_match_jax(capsys):
    argv = ["fullsweep", "--bandwidth", "1.25", "--modulations", "QPSK", "--rx-list", "1,2",
            "--snr-min", "6", "--snr-max", "10", "--snr-step", "4", "--iterations", "1",
            "--num-symbols", "14"]
    ours = json.loads(_port(capsys, argv))
    ref = json.loads(_run(capsys, jcli, argv))
    assert sorted(ours) == sorted(ref)
    assert list(ours["curves"]) == list(ref["curves"]) == ["QPSK/1rx", "QPSK/2rx"]
    for label, curve in ours["curves"].items():
        assert list(curve) == list(ref["curves"][label])
        assert curve["snr_db"] == [6.0, 10.0]
    assert ours["cells"] == 2 and ours["snr_points"] == 2
    assert ours["frames_per_point"] == 1          # one process: the iterations


def test_bfcompare_rows_match_jax(capsys, tmp_path):
    table, png = tmp_path / "bfc.txt", tmp_path / "overlay.png"
    argv = ["bfcompare", "--bandwidth", "1.25", "--modulation", "QPSK", "--num-bits", "4000",
            "--lanes", "2"]
    ours = json.loads(_port(capsys, argv + [
        "--output", str(table), "--snr-min", "10", "--snr-max", "20", "--snr-step", "10",
        "--sweep-frames", "1", "--sweep-plot", str(png)]))
    ref = json.loads(_run(capsys, jcli, argv))
    assert len(ours["rows"]) == len(ref["rows"]) == 12       # 3 RX x (1 SFBC + 3 BF)
    for row, jrow in zip(ours["rows"], ref["rows"]):
        assert list(row) == list(jrow)
        assert row["name"] == jrow["name"]
    assert all("published_ber" in r and "gain_db" in r for r in ours["rows"]
               if r["kind"] == "bf")
    txt = table.read_text()
    assert "8x4 Beamforming" in txt and "Array Gain" in txt
    assert os.path.getsize(png) > 0


def test_image_input_png_at_60_db_is_exact(capsys, tmp_path):
    from PIL import Image
    src, cmp_png = str(tmp_path / "in.png"), str(tmp_path / "cmp.png")
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (16, 16, 3), dtype=np.uint8)
                    ).save(src)
    out = json.loads(_port(capsys, ["image", "--bandwidth", "1.25", "--snr", "60",
                                    "--input", src, "--output", cmp_png]))
    assert list(out) == ["ber", "bit_errors", "psnr_db", "ssim", "snr_db", "pipeline",
                         "wall_time_s"]
    assert out["ber"] == 0.0 and out["psnr_db"] == float("inf") and out["ssim"] == 1.0
    assert os.path.getsize(cmp_png) > 0


def test_transmit_image_takes_the_array():
    """The array part of `image`, as chip_smoke drives it: no file, no PIL."""
    args = cli.build_parser().parse_args(["image", "--input", "unused", "--bandwidth", "1.25",
                                          "--snr", "60", "--device", "cpu"])
    original = np.random.default_rng(1).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    received, out = cli.transmit_image(cli._mk_sim(args), original, "siso", 60.0, args)
    np.testing.assert_array_equal(received, original)
    assert out["psnr_db"] == float("inf") and out["ssim"] == 1.0 and out["bit_errors"] == 0


@pytest.mark.parametrize("argv", [
    ["run", "--bandwidth", "1.25", "--num-bits", "200"],
    ["sweep", "--bandwidth", "1.25", "--frames", "1"],
    ["papr", "--bandwidth", "1.25"]], ids=["run", "sweep", "papr"])
def test_no_card_and_no_device_raises(monkeypatch, argv):
    """With no card, a command given no --device raises before it runs
    anything: it does not carry on on the CPU."""
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("cmd_run", "cmd_sweep", "cmd_papr"):
        monkeypatch.setattr(cli, name, lambda args, name=name: ran.append(name))
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.main(argv)
    assert ran == []


def test_seeds_are_independent_and_repeatable():
    seeds = {cli._seed(a, b) for a in range(4) for b in range(4)}
    assert len(seeds) == 16 and all(0 <= s < 2 ** 63 for s in seeds)
    assert cli._seed(3, 1) == cli._seed(3, 1) and 0 <= cli._seed(-1, 0) < 2 ** 63
