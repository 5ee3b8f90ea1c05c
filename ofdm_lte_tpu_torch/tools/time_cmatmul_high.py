"""Time the wgmma complex GEMMs of `high` (TF32) or `default` (bf16) against
other trees' and the library, in turns, on one CUDA card.

    python3 -m ofdm_lte_tpu_torch.tools.time_cmatmul_high [--precision high|default]
        [--parent DIR ...] [--reps N] [--split] [--step] [--seeds N]

At the modem's shapes (20 MHz, 256 lanes: TX, RX data on the CP-stripped
view, RX pilot on the slot-start view, SC-FDM, the Jakes product at K = 16,
the beamforming Jakes path's 14x16x2048 product and the extended CRS
layout's K = 25 tap-basis product; random operands with the paths' strides)
it times the precision's two kernels of this tree (`cmatmul_tf32[_gauss]`
or `cmatmul_bf16[_gauss]`) through ops.cmatmul (workspace and all), the same
two kernels of each tree given by --parent (a checkout of another commit,
e.g. from `git archive`; the flag repeats, each tree named by its
directory), built there by that tree's own _build and called through their
C interface, and the library, in the order there, here, here, there (CUDA
events, 3 warm-up runs, the device parked first so that the host runs
ahead). The library at `high` is the TF32 complex GEMM (torch.matmul on
complex64 with allow_tf32); at `default` two bf16 stand-ins with bf16 out,
their operands made outside the timed window: four real torch.matmuls of
the rounded planes, and one of the real block form [Ar | Ai] (M, 2K') @
[[Br, Bi], [-Bi, Br]] (2K', 2N') with K and N padded to K', N', multiples of
8, with zeros (chip_smoke.bf16_stand_ins); the faster is the yardstick.
Each time is printed beside the bound (chip_smoke.bound_ms's rule: the
larger of the fp32 planes' bytes over 3.35 TB/s and one product's operations
over 495 TFLOP/s at TF32 or 989 at bf16) and each kernel's largest error
against its plain version (max|d|/max|C|). With --split, a torch.profiler
trace of 10 calls of each of this tree's kernels splits its device time by
launch: B's prep, A's prep (`default`) or copy (`high`), the GEMM, the
split-K sum. --step times two paths' steps at the precision in both
forms, in a fresh interpreter for each tree, in the order there, here, here,
there: the flagship (sim.siso.SisoLink, 20 MHz 64-QAM, 256 lanes of 14
symbols at 15 dB) and bf_8x1_tm6_jakes_30kmh (sim.beamforming.BeamformingLink,
8x1, Jakes at 30 km/h, 256 lanes, whose one GEMM a step is the 14x16x2048
product); 20 steps by CUDA events after 3 warm-ups, bits and seed changed
every step, chip_smoke.py's phase 6 loop. --seeds N holds this tree's kernels
to their plain versions at the flagship's TX and RX data GEMMs (K = 999 and
2048, the largest K of any path; the modem's own tables and signals) over N
draws of the bits and prints each error beside its tolerance
(chip_smoke.draw_errors). The card's name and power limit come first.
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

# each precision's two wgmma kernels
KERNELS = {"high": ("tf32", "tf32_gauss"), "default": ("bf16", "bf16_gauss")}
RATE = {"high": "tf32", "default": "bf16"}


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


def _bound_ms(precision: str, gauss: bool, M: int, K: int, N: int) -> float:
    t_bytes = 4 * (2 * M * K + 2 * K * N + 2 * M * N) / DATASHEET["hbm"]
    t_ops = (6 if gauss else 8) * M * K * N / DATASHEET[RATE[precision]]
    return 1e3 * max(t_bytes, t_ops)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in KERNELS["high"] + KERNELS["default"]:
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
            name = next((k for k in ("prep_b", "prep_a", "copy_a", "wgmma_tf32_kernel",
                                     "wgmma_bf16_kernel", "splitk_sum")
                         if k in e.name), e.name[:40])
            out[name] = out.get(name, 0.0) + e.device_time / 1e3 / calls
    return out


# one tree's steps at the precision in argv: run with that tree first on sys.path
STEP_PROBE = r"""
import json, os, sys
import torch
os.environ["OFDM_LTE_TPU_TORCH_MATMUL_PRECISION"] = sys.argv[1]
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


def _step_ms(root: Path, precision: str) -> dict:
    """The steps at `precision` of the tree at `root`, in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(root))
    run = subprocess.run([sys.executable, "-c", STEP_PROBE, precision], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"the step at {root} failed:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--precision", choices=tuple(KERNELS), default="high")
    parser.add_argument("--parent", type=Path, action="append", default=[])
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
    precision, kernels = args.precision, KERNELS[args.precision]
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["OFDM_LTE_TPU_TORCH_MATMUL_PRECISION"] = precision
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parents = [(root.resolve().name, root.resolve()) for root in args.parent]
    libs = {tag: _parent_library(root) for tag, root in parents}

    if args.step:
        trees = parents + [("here", Path(__file__).resolve().parents[2])]
        steps = {tag: [] for tag, _ in trees}
        for tag, root in trees + trees[::-1]:
            steps[tag].append(_step_ms(root, precision))
        for tag, runs in steps.items():
            for key in runs[0]:
                ts = [r[key] for r in runs]
                path, form = key.split("/")
                print(f"[{card}] {path} step at {precision}/{form}, {tag}: "
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
        if precision == "high":
            ac = torch.complex(a.re, a.im).contiguous()
            bc = torch.complex(b.re, b.im)

            def library():
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    return torch.matmul(ac, bc)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False

            runs = {"library": library}
        else:
            from chip_smoke import bf16_stand_ins
            runs = bf16_stand_ins(a, b)
        lib_names = list(runs)
        for kernel in kernels:
            gauss = kernel.endswith("gauss")
            runs[kernel] = lambda gauss=gauss: cm.cmatmul(a, b, gauss=gauss)
            for tag, lib in libs.items():
                runs[f"{tag}_{kernel}"] = lambda kernel=kernel, lib=lib: _lib_call(
                    lib, kernel, a, b, sms)
        order = [f"{tag}_{k}" for tag in libs for k in kernels] + list(kernels)
        order = lib_names + order + order[::-1] + lib_names[::-1]
        t = dict.fromkeys(runs, 0.0)
        count = dict.fromkeys(runs, 0)
        for which in order:
            t[which] += _cuda_ms(runs[which], args.reps)
            count[which] += 1
        ms = {which: t[which] / count[which] for which in runs}
        yardstick = min(lib_names, key=ms.get)
        for which in runs:
            line = f"[{card}] {name} ({M}x{K})@({K}x{N}) {which}: {ms[which]:.4f} ms"
            if which not in lib_names:
                kernel = kernels[1] if which.endswith("gauss") else kernels[0]
                out, ref = runs[which](), cm.PLAIN[kernel](a, b)
                scale = max(ref.re.abs().max().item(), ref.im.abs().max().item())
                err = max((out.re - ref.re).abs().max().item(),
                          (out.im - ref.im).abs().max().item()) / scale
                bound = _bound_ms(precision, kernel.endswith("gauss"), M, K, N)
                line += (f", bound {bound:.4f} ms (share {bound / ms[which]:.3f}), "
                         f"{ms[which] / ms[yardstick]:.3f} of {yardstick}'s, vs plain {err:.3e}")
            print(line)
        for kernel in kernels if args.split else ():
            print(f"[{card}] {name} {kernel} device time a call by launch: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in _split(runs[kernel]).items()))
        del runs
        torch.cuda.empty_cache()

    if args.seeds:
        from chip_smoke import draw_errors
        draw_errors(kernels, args.seeds, card, dev)


if __name__ == "__main__":
    main(sys.argv[1:])
