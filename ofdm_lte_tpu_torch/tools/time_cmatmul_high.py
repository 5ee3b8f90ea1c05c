"""Time the `high` (TF32) complex GEMMs against another tree's and the library,
in turns, on one CUDA card.

    python3 -m ofdm_lte_tpu_torch.tools.time_cmatmul_high [--parent DIR] [--reps N] [--split]
        [--step] [--seeds N]

At the modem's shapes (20 MHz, 256 lanes: TX, RX data on the CP-stripped
view, RX pilot on the slot-start view, SC-FDM, the Jakes product at K = 16,
the beamforming Jakes path's 14x16x2048 product and the extended CRS
layout's K = 25 tap-basis product; random operands with the paths' strides)
it times `cmatmul_tf32` and `cmatmul_tf32_gauss` of this tree through
ops.cmatmul (workspace and all), the same two kernels of the tree at DIR (a
checkout of another commit, e.g. from `git archive`), built there by that
tree's own _build and called through their C interface, and the library's
TF32 complex GEMM (torch.matmul on complex64 with allow_tf32), in the order
there, here, here, there (CUDA events, 3 warm-up runs, the device parked
first so that the host runs ahead). Each time is printed beside the bound
(chip_smoke.bound_ms's rule: the larger of the planes' bytes over 3.35 TB/s
and one TF32 product's operations over 495 TFLOP/s) and each kernel's
largest error against its plain version (max|d|/max|C|). With --split, a
torch.profiler trace of 10 calls of each of this tree's kernels splits its
device time by launch: B's prep, A's copy, the GEMM, the split-K sum.
--step times two paths' steps at `high` in both forms, in a fresh
interpreter for each tree, in the order there, here, here, there: the
flagship (sim.siso.SisoLink, 20 MHz 64-QAM, 256 lanes of 14 symbols at 15
dB) and bf_8x1_tm6_jakes_30kmh (sim.beamforming.BeamformingLink, 8x1, Jakes
at 30 km/h, 256 lanes, whose one GEMM a step is the 14x16x2048 product);
20 steps by CUDA events after 3 warm-ups, bits and seed changed every step,
chip_smoke.py's phase 6 loop. --seeds N holds this tree's kernels to their
plain versions at the flagship's TX and RX data GEMMs (K = 999 and 2048, the
largest K of any path; the modem's own tables and signals) over N draws of
the bits and prints each error beside its tolerance (chip_smoke.TOL). The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from ..cplx import C
from ..ops import cmatmul as cm
from ..utils.profiling import DATASHEET

KERNELS = ("tf32", "tf32_gauss")


def _cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)        # let the host run ahead of the device
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _bound_ms(gauss: bool, M: int, K: int, N: int) -> float:
    t_bytes = 4 * (2 * M * K + 2 * K * N + 2 * M * N) / DATASHEET["hbm"]
    t_ops = (6 if gauss else 8) * M * K * N / DATASHEET["tf32"]
    return 1e3 * max(t_bytes, t_ops)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in KERNELS:
        getattr(lib, "cmatmul_" + name).argtypes = [p, p, i, p, p, i, p, p, i, i, i, i, p, i, p]
        getattr(lib, f"cmatmul_{name}_splits").argtypes = [i, i, i, i]
        if hasattr(lib, f"cmatmul_{name}_workspace"):
            getattr(lib, f"cmatmul_{name}_workspace").argtypes = [p, p, i, i, i, i, i]
            getattr(lib, f"cmatmul_{name}_workspace").restype = ctypes.c_longlong
    return lib


def _parent_library(root: Path) -> ctypes.CDLL:
    """The kernel library of the tree at `root`, built by its own _build."""
    code = "from ofdm_lte_tpu_torch import _build; print(_build.build())"
    env = dict(os.environ, PYTHONPATH=str(root))
    run = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True)
    if run.returncode != 0:
        raise RuntimeError(f"the build at {root} failed:\n{run.stderr[-3000:]}")
    return _bind(ctypes.CDLL(run.stdout.strip().splitlines()[-1]))


def _lib_call(lib, name: str, a: C, b: C, sms: int) -> C:
    """A call of a kernel through its C interface, as its wrapper makes it: a
    workspace of the size the library asks for, or, for a library without
    that query, 2·splits·M·N floats of scratch for a K split."""
    (M, K), N = a.re.shape, b.re.shape[1]
    cr = torch.empty((M, N), device=a.re.device)
    ci = torch.empty((M, N), device=a.re.device)
    splits = getattr(lib, f"cmatmul_{name}_splits")(M, N, K, sms)
    lda = a.re.stride(0) if M > 1 else K
    if hasattr(lib, f"cmatmul_{name}_workspace"):
        floats = getattr(lib, f"cmatmul_{name}_workspace")(a.re.data_ptr(), a.im.data_ptr(),
                                                           lda, M, N, K, splits)
    else:
        floats = 2 * splits * M * N if splits > 1 else 0
    scratch = torch.empty(floats, device=a.re.device) if floats else None
    rc = getattr(lib, "cmatmul_" + name)(
        a.re.data_ptr(), a.im.data_ptr(), lda, b.re.data_ptr(), b.im.data_ptr(),
        b.re.stride(0), cr.data_ptr(), ci.data_ptr(), N, M, N, K,
        scratch.data_ptr() if floats else None, splits,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cmatmul_{name} failed: CUDA error {rc}")
    return C(cr, ci)


def _split(fn, calls: int = 10) -> dict:
    """Device time a call of fn by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in ("prep_b", "copy_a", "wgmma_tf32_kernel", "splitk_sum")
                         if k in e.name), e.name[:40])
            out[name] = out.get(name, 0.0) + e.device_time / 1e3 / calls
    return out


# one tree's steps at `high`: run with that tree first on sys.path
STEP_PROBE = r"""
import json, os, sys
import torch
os.environ["OFDM_LTE_TPU_TORCH_MATMUL_PRECISION"] = "high"
torch.backends.cuda.matmul.allow_tf32 = False
from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.sim import beamforming, siso
cfg = LTEConfig(20.0, modulation="64-QAM")
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
links = {
    "flagship": (siso.SisoLink(cfg, device=dev), siso.bits_per_frame(cfg, 14)),
    "bf_8x1_tm6_jakes_30kmh": (beamforming.BeamformingLink(
        cfg, num_tx=8, num_rx=1, update_mode="static", channel_model="jakes",
        update_period=4, doppler_hz=30.0 / 3.6 * 2e9 / 3e8, device=dev),
        beamforming.bits_per_frame(cfg, 14)),
}
out = {}
for path, (link, n_bits) in links.items():
    pool = []
    for i in range(20):
        gen.manual_seed(1000 + i)
        pool.append(torch.randint(0, 2, (256, n_bits), generator=gen, device=dev,
                                  dtype=torch.int8))
    for form in ("fma4", "gauss"):
        os.environ["OFDM_LTE_TPU_TORCH_CMATMUL"] = form
        count = [0]

        def step():
            count[0] += 1
            gen.manual_seed(5000 + count[0])
            return link(pool[count[0] % 20], 15.0, generator=gen).bit_errors

        for _ in range(3):
            step()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        for _ in range(20):
            step()
        e1.record()
        torch.cuda.synchronize()
        out[f"{path}/{form}"] = e0.elapsed_time(e1) / 20
print(json.dumps(out))
"""


def _step_ms(root: Path) -> dict:
    """The steps at `high` of the tree at `root`, in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(root))
    run = subprocess.run([sys.executable, "-c", STEP_PROBE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"the step at {root} failed:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--split", action="store_true")
    parser.add_argument("--step", action="store_true")
    parser.add_argument("--seeds", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_cmatmul_high needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["OFDM_LTE_TPU_TORCH_MATMUL_PRECISION"] = "high"
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = {}
    if args.parent:
        libs["parent"] = _parent_library(args.parent.resolve())

    if args.step:
        here = Path(__file__).resolve().parents[2]
        trees = ([("parent", args.parent.resolve())] if args.parent else []) + [("here", here)]
        steps = {tag: [] for tag, _ in trees}
        for tag, root in trees + trees[::-1]:
            steps[tag].append(_step_ms(root))
        for tag, runs in steps.items():
            for key in runs[0]:
                ts = [r[key] for r in runs]
                path, form = key.split("/")
                print(f"[{card}] {path} step at high/{form}, {tag}: "
                      f"{sum(ts) / len(ts):.4f} ms (passes {', '.join(f'{t:.4f}' for t in ts)})")

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def randc(*shape) -> C:
        return C(torch.randn(shape, generator=g, device=dev),
                 torch.randn(shape, generator=g, device=dev))

    y = randc(3584, 2192)
    shapes = {"tx": (randc(3584, 999), randc(999, 2192)),
              "rx_data": (y[:, 144:], randc(2048, 999)),
              "rx_pilot": (y[::14, 144:], randc(2048, 200)),
              "scfdm": (randc(3584, 999), randc(999, 999)),
              "jakes": (randc(1024, 16), randc(16, 30688)),
              "bf_jakes": (randc(14, 16), randc(16, 2048)),
              "tap_basis": (randc(14336, 25), randc(25, 500))}
    for name, (a, b) in shapes.items():
        (M, K), N = a.re.shape, b.re.shape[1]
        ac = torch.complex(a.re, a.im).contiguous()
        bc = torch.complex(b.re, b.im)

        def library():
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return torch.matmul(ac, bc)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False

        runs = {"library": library}
        for kernel in KERNELS:
            gauss = kernel.endswith("gauss")
            runs[kernel] = lambda gauss=gauss: cm.cmatmul(a, b, gauss=gauss)
            for tag, lib in libs.items():
                runs[f"{tag}_{kernel}"] = lambda kernel=kernel, lib=lib: _lib_call(
                    lib, kernel, a, b, sms)
        order = [f"{tag}_{k}" for tag in libs for k in KERNELS] + list(KERNELS)
        order = ["library"] + order + order[::-1] + ["library"]
        t = dict.fromkeys(runs, 0.0)
        count = dict.fromkeys(runs, 0)
        for which in order:
            t[which] += _cuda_ms(runs[which], args.reps)
            count[which] += 1
        for which in runs:
            kernel = "tf32_gauss" if which.endswith("tf32_gauss") else "tf32"
            ms = t[which] / count[which]
            line = f"[{card}] {name} ({M}x{K})@({K}x{N}) {which}: {ms:.4f} ms"
            if which != "library":
                gauss = kernel.endswith("gauss")
                out, ref = runs[which](), cm.PLAIN[kernel](a, b)
                scale = max(ref.re.abs().max().item(), ref.im.abs().max().item())
                err = max((out.re - ref.re).abs().max().item(),
                          (out.im - ref.im).abs().max().item()) / scale
                bound = _bound_ms(gauss, M, K, N)
                line += (f", bound {bound:.4f} ms (share {bound / ms:.3f}), "
                         f"{ms / (t['library'] / count['library']):.3f} of the library's, "
                         f"vs plain {err:.3e}")
            print(line)
        for kernel in KERNELS if args.split else ():
            print(f"[{card}] {name} {kernel} device time a call by launch: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in _split(runs[kernel]).items()))
        del ac, bc
        torch.cuda.empty_cache()

    if args.seeds:
        _seed_errors(args.seeds, card, dev)


def _seed_errors(seeds: int, card: str, dev: torch.device) -> None:
    """This tree's kernels against their plain versions at the TX and RX data
    GEMMs of the flagship (20 MHz 64-QAM, 256 lanes of 14 symbols, the
    operands that chip_smoke.py's phase 9 makes), each draw of bits a seed."""
    from chip_smoke import TOL
    from ..config import LTEConfig
    from ..ops import ofdm, qam
    from ..sim import siso
    cfg = LTEConfig(20.0, modulation="64-QAM")
    link = siso.SisoLink(cfg, device=dev)
    gen = torch.Generator(device=dev)
    errs = {(name, kernel): [] for name in ("tx", "rx_data") for kernel in KERNELS}
    shapes = {}
    for seed in range(seeds):
        gen.manual_seed(100 + seed)
        bits = torch.randint(0, 2, (256, siso.bits_per_frame(cfg, 14)), generator=gen,
                             device=dev, dtype=torch.int8)
        y = ofdm.frame_stream(link.transmit(bits), cfg)
        gemms = {"tx": (qam.modulate(bits, cfg.modulation).reshape(256, 14, -1),
                        link.mod_tables.b),
                 "rx_data": (y[..., cfg.cp_length:], link.rx_tables.data.g)}
        for name, (a, b) in gemms.items():
            shapes[name] = (a.re.numel() // a.shape[-1], a.shape[-1], b.re.shape[1])
            for kernel in KERNELS:
                out = cm.cmatmul(a, b, gauss=kernel.endswith("gauss"))
                ref = cm.PLAIN[kernel](a, b)
                scale = max(ref.re.abs().max().item(), ref.im.abs().max().item())
                errs[name, kernel].append(max((out.re - ref.re).abs().max().item(),
                                              (out.im - ref.im).abs().max().item()) / scale)
    for (name, kernel), e in errs.items():
        M, K, N = shapes[name]
        print(f"[{card}] {name} ({M}x{K})@({K}x{N}) {kernel} vs plain over {seeds} draws of "
              f"bits: max {max(e):.3e}, mean {sum(e) / len(e):.3e}, tolerance "
              f"{TOL[kernel]:.0e}, margin {TOL[kernel] / max(e):.2f}x "
              f"({', '.join(f'{x:.3e}' for x in e)})")


if __name__ == "__main__":
    main(sys.argv[1:])
