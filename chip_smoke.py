"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the 20 MHz 64-QAM SISO link over AWGN with CRS
estimation and ZF, at 256 Monte-Carlo lanes of 14-symbol frames
(21.5 M bits per step), as ofdm_lte_tpu_torch.sim.siso.SisoLink runs it.
Its three complex GEMMs go through the tensor-core kernel `cmatmul_tf32x3`
(`tc`); the CUDA-core kernel `cmatmul_f32` (`ffma`: 4-dot and Gauss forms)
is driven beside it. Phases, each of which raises on failure:

1. require a CUDA card; print its name and power limit;
2. build the CUDA kernels from ofdm_lte_tpu_torch/csrc into build/;
3. hold the three kernels against their plain PyTorch versions (fp32, TF32
   off) at the path's three GEMM shapes, with the strided operands the
   path makes, and at two small ragged shapes: `tc` against `cmatmul_plain`
   and `cmatmul_plain_tf32x3`, `ffma` 4-dot and Gauss against
   `cmatmul_plain` of the same form. Print each one's error against a
   float64 product (a yardstick). Run the split-K pilot GEMM twice and
   require identical bits;
4. run the OFDMModule facade once;
5. run the link at 60 dB (BER must be 0) and 15 dB (BER in
   [0.0836, 0.0880], around the JAX package's 0.08586), once per kernel,
   counting kernel launches (3 per step); and hold the CUDA path
   against the CPU path on a small input with the same injected noise;
6. time the link (CUDA events, bits and seed changed every step) through
   `tc` and through `ffma`, and each GEMM through `tc`, `ffma`, the plain
   version and one library call (torch.matmul on complex64 operands made
   before the timed window), beside its bound: the larger of bytes moved
   over 3.35 TB/s and operations over the peak rate of their type
   (TF32 tensor cores 495 TFLOP/s for `tc`, which does three TF32 products
   per fp32 product; fp32 CUDA cores 67 TFLOP/s for `ffma`).

The second-to-last line is a JSON object describing each kernel (its times
are sums over the step's three GEMMs); the last is
{"ok": true, "device": {...}}. Needs one card and no network.

    python3 chip_smoke.py --profile

also traces 10 steps with torch.profiler before those two lines and prints
where a step's device time goes: all kernels, the GEMM kernels, the number
of kernels a step, and the device's idle share of the traced wall time.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

LANES = 256
SYMBOLS = 14
STEPS = 20
BER_15DB = (0.0836, 0.0880)
# max|Δ| / max|C| against the plain version of the same form. tc and ffma
# 4-dot: the same products in another sum order; Gauss: one extra rounding.
TOL = {"tf32x3": 1e-5, "f32_fma4": 1e-5, "f32_gauss": 1e-4}
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"tf32": 495e12, "fp32": 67e12}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, run_ahead: bool = False) -> float:
    """Mean device time of fn() over reps runs after 3 warm-up runs.

    run_ahead=True first parks the device on a spin kernel, so that the host
    has every launch enqueued before the first one runs and the events see
    device time alone (for kernels shorter than their launch)."""
    for _ in range(3):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if run_ahead:
        torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_steps(step, steps: int = 10) -> None:
    """Print the split of a step's device time from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            step()
        enqueue_ms = 1e3 * (time.perf_counter() - t1) / steps
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1) / steps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity")
    dev_ms = sum(e.device_time for e in kernels) / 1e3 / steps
    gemm = [e for e in kernels if "cmatmul" in e.name or "splitk" in e.name]
    gemm_ms = sum(e.device_time for e in gemm) / 1e3 / steps
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.device_time / 1e3 / steps
    print(f"profile over {steps} steps: wall {wall_ms:.3f} ms/step, host enqueue "
          f"{enqueue_ms:.3f} ms/step, device kernels {dev_ms:.3f} ms/step in "
          f"{len(kernels) / steps:.1f} kernels, of which GEMM kernels {gemm_ms:.3f} ms/step "
          f"in {len(gemm) / steps:.1f}; device idle share {1 - dev_ms / wall_ms:.3f} "
          f"(set-up of the trace {1e3 * (t1 - t0):.0f} ms, outside)")
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:.4f} ms/step  {name[:110]}")


def bound_ms(kernel: str, M: int, K: int, N: int):
    """(ms, which) — the least time the card could take: every plane of A and
    B read once and C written once, against the operations at their peak."""
    planes = 2 * M * K + 2 * K * N + 2 * M * N + (K * N if kernel == "f32_gauss" else 0)
    t_bytes = 4 * planes / HBM_BYTES_PER_S
    if kernel == "tf32x3":
        t_ops = 3 * 8 * M * K * N / PEAK_FLOPS["tf32"]
    else:
        t_ops = (6 if kernel == "f32_gauss" else 8) * M * K * N / PEAK_FLOPS["fp32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ofdm_lte_tpu_torch import LTEConfig, OFDMModule, _build
    from ofdm_lte_tpu_torch.cplx import C
    from ofdm_lte_tpu_torch.ops import ofdm, qam
    from ofdm_lte_tpu_torch.ops.cmatmul import (cmatmul, cmatmul_plain,
                                                cmatmul_plain_tf32x3, default_variant)
    from ofdm_lte_tpu_torch.rx.estimation import SLOT_SIZE
    from ofdm_lte_tpu_torch.sim import siso

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    print(_build.build_log.strip())

    dev = torch.device("cuda")
    cfg = LTEConfig(20.0, modulation="64-QAM")
    link = siso.SisoLink(cfg, device=dev)
    gen = torch.Generator(device=dev)
    n_bits = siso.bits_per_frame(cfg, SYMBOLS)

    def random_bits(lanes: int, seed: int) -> torch.Tensor:
        gen.manual_seed(seed)
        return torch.randint(0, 2, (lanes, n_bits), generator=gen, device=dev,
                             dtype=torch.int8)

    # -- 3. kernel vs plain at the path's shapes ---------------------------
    bits = random_bits(LANES, 1)
    data = qam.modulate(bits, cfg.modulation).reshape(LANES, SYMBOLS, -1)
    y = ofdm.frame_stream(link.transmit(bits), cfg)                 # (L, S, N+cp)
    rx = link.rx_tables
    gemms = {
        "tx": (data, link.mod_tables.b, link.mod_tables.bsum),
        "rx_data": (y[..., cfg.cp_length:], rx.data.g, rx.data.gsum),
        "rx_pilot": (y[..., ::SLOT_SIZE, cfg.cp_length:], rx.pilot.g, rx.pilot.gsum),
    }
    g = torch.Generator(device=dev)
    g.manual_seed(7)

    def randc(*shape):
        return C(torch.randn(shape, generator=g, device=dev),
                 torch.randn(shape, generator=g, device=dev))

    ragged = {"ragged_28x999x300": (randc(28, 999), randc(999, 300), None),
              "ragged_5x7x3": (randc(5, 7), randc(7, 3), None)}

    def c128(x: C) -> torch.Tensor:
        return torch.complex(x.re.double(), x.im.double())

    def max_diff(x, y) -> float:
        return max((x.re - y.re).abs().max().item(), (x.im - y.im).abs().max().item())

    def run_kernel(kernel, a, b, bsum):
        if kernel == "f32_gauss":
            return cmatmul(a, b, gauss=True, bsum=bsum)
        return cmatmul(a, b, variant="tc" if kernel == "tf32x3" else "ffma")

    max_err = dict.fromkeys(TOL, 0.0)
    for name, (a, b, bsum) in {**gemms, **ragged}.items():
        M, K, N = int(np.prod(a.shape[:-1])), b.shape[0], b.shape[1]
        a2 = C(a.re.reshape(M, K), a.im.reshape(M, K))
        plain = {False: cmatmul_plain(a2, b), True: cmatmul_plain(a2, b, gauss=True)}
        exact = c128(a2) @ c128(b)
        scale = exact.abs().max().item()
        err64 = {"plain": (c128(plain[False]) - exact).abs().max().item() / scale}
        for kernel, tol in TOL.items():
            out = run_kernel(kernel, a2, b, bsum)
            torch.cuda.synchronize()
            refs = {"plain": plain[kernel == "f32_gauss"]}
            if kernel == "tf32x3":
                refs["plain_tf32x3"] = cmatmul_plain_tf32x3(a2, b)
            for ref_name, ref in refs.items():
                err = max_diff(out, ref)
                rel = err / max(ref.re.abs().max().item(), ref.im.abs().max().item())
                print(f"check {name} {kernel} vs {ref_name} (M={M}, K={K}, N={N}, "
                      f"lda={a2.re.stride(0)}): max|d| {err:.3e}  max|d|/max|C| {rel:.3e}  "
                      f"tol {tol:.0e}")
                if not (rel <= tol):
                    raise AssertionError(f"kernel {kernel} disagrees with {ref_name} at "
                                         f"{name}: {rel:.3e} > {tol:.0e}")
                if ref_name == "plain":
                    max_err[kernel] = max(max_err[kernel], err)
            err64[kernel] = (c128(out) - exact).abs().max().item() / scale
        print(f"accuracy {name} against float64, max|d|/max|C|: " +
              "  ".join(f"{k} {v:.3e}" for k, v in err64.items()))

    # the pilot GEMM's grid is split along K; its partial sums are added in a
    # fixed order, so two runs give the same bits
    a, b, _ = gemms["rx_pilot"]
    splits = _build.library().cmatmul_tf32x3_splits(
        int(np.prod(a.shape[:-1])), b.shape[1], b.shape[0],
        torch.cuda.get_device_properties(dev).multi_processor_count)
    first, second = cmatmul(a, b), cmatmul(a, b)
    torch.cuda.synchronize()
    same = torch.equal(first.re, second.re) and torch.equal(first.im, second.im)
    print(f"determinism rx_pilot tf32x3: K split {splits} ways, two runs identical: {same}")
    if splits < 2 or not same:
        raise AssertionError("the split-K pilot GEMM is not split or not reproducible")

    # -- 4. the facade, once -----------------------------------------------
    cmatmul.launches = 0
    res = OFDMModule(cfg, device=dev, seed=3).transmit(
        np.random.default_rng(3).integers(0, 2, n_bits), 60.0)
    if res["ber"] != 0 or cmatmul.launches != 3 or not np.isfinite(res["papr_db"]):
        raise AssertionError(f"facade: ber {res['ber']} launches {cmatmul.launches} "
                             f"papr {res['papr_db']}")
    print(f"facade OFDMModule.transmit at 60 dB: ber {res['ber']} papr_db "
          f"{res['papr_db']:.3f} evm% {res['evm_percent']:.4f} launches {cmatmul.launches}")

    # -- 5. the main path, once per kernel ----------------------------------
    def main_path_through(kernel):
        """Context in which the link's GEMMs go to `kernel`."""
        os.environ["OFDM_LTE_TPU_TORCH_CMATMUL"] = "gauss" if kernel == "f32_gauss" else "fma4"
        return default_variant("ffma") if kernel == "f32_fma4" else contextlib.nullcontext()

    launches = {}
    for kernel in TOL:
        with main_path_through(kernel):
            for k in cmatmul.launches_by_kernel:
                cmatmul.launches_by_kernel[k] = 0
            bers = {}
            for step, snr in enumerate((60.0, 15.0)):
                bits = random_bits(LANES, 100 + step)
                gen.manual_seed(200 + step)
                r = siso.simulate_siso(bits, snr, cfg, generator=gen)
                if r.bits_rx.shape != bits.shape or r.bits_rx.dtype != bits.dtype:
                    raise AssertionError(f"bits_rx {r.bits_rx.shape} {r.bits_rx.dtype}")
                if r.ber.shape != (LANES,) or not torch.isfinite(r.papr_db).all():
                    raise AssertionError("ber shape or non-finite PAPR")
                bers[snr] = r.ber.mean().item()
            counts = dict(cmatmul.launches_by_kernel)
        launches[kernel] = counts[kernel]
        print(f"main path {kernel}: {LANES} lanes x {SYMBOLS} symbols, BER@60dB "
              f"{bers[60.0]:.6g}, BER@15dB {bers[15.0]:.6g}, launches {counts}")
        if bers[60.0] != 0.0 or not (BER_15DB[0] <= bers[15.0] <= BER_15DB[1]):
            raise AssertionError(f"{kernel}: BER {bers} outside 0 / {BER_15DB}")
        if counts[kernel] != 3 * 2 or sum(counts.values()) != 3 * 2:
            raise AssertionError(f"{kernel}: launches {counts}, expected 6 of {kernel} alone")
    os.environ["OFDM_LTE_TPU_TORCH_CMATMUL"] = "fma4"

    # CUDA path vs CPU path on a small input with the same injected noise
    small = LTEConfig(5.0, modulation="64-QAM")
    rng = np.random.default_rng(11)
    sb = rng.integers(0, 2, (4, siso.bits_per_frame(small, 28))).astype(np.int32)
    nd = siso.grid_for(small).num_data
    npil = siso.grid_for(small).num_pilot
    noise = ((rng.standard_normal((4, 28, nd)), rng.standard_normal((4, 28, nd))),
             (rng.standard_normal((4, 2, npil)), rng.standard_normal((4, 2, npil))))
    r_gpu = siso.simulate_siso(torch.as_tensor(sb, device=dev), 20.0, small, noise=noise)
    r_cpu = siso.simulate_siso(torch.as_tensor(sb), 20.0, small, noise=noise)
    mism = int((r_gpu.bits_rx.cpu() != r_cpu.bits_rx).sum())
    print(f"cuda vs cpu, same noise, 5 MHz 64-QAM 20 dB: {mism} of {sb.size} bits differ, "
          f"ber {r_gpu.ber.mean().item():.6g} vs {r_cpu.ber.mean().item():.6g}")
    if mism > 1e-4 * sb.size:
        raise AssertionError("CUDA path disagrees with the CPU path")

    # -- 6. timing --------------------------------------------------------
    pool = [random_bits(LANES, 1000 + i) for i in range(STEPS)]
    step_i = [0]

    def step():
        i = step_i[0] % STEPS
        step_i[0] += 1
        gen.manual_seed(5000 + step_i[0])
        return link(pool[i], 15.0, generator=gen).bit_errors

    torch.cuda.synchronize()
    # tc, ffma, ffma, tc: the step before and after the tensor-core kernel
    ms_step = {"tf32x3": cuda_ms(step, STEPS)}
    with default_variant("ffma"):
        ms_step["f32_fma4"] = (cuda_ms(step, STEPS) + cuda_ms(step, STEPS)) / 2
    ms_step["tf32x3"] = (ms_step["tf32x3"] + cuda_ms(step, STEPS)) / 2
    for kernel, t in ms_step.items():
        print(f"[{card}] main path 20 MHz 64-QAM through {kernel}, {LANES} lanes: "
              f"{t:.4f} ms/step, {LANES / (t / 1e3):.1f} frames/s, "
              f"{LANES * n_bits / (t / 1e3) / 1e9:.3f} Gbit/s")

    ms = dict.fromkeys(TOL, 0.0)
    plain_ms = dict.fromkeys(TOL, 0.0)
    bounds = dict.fromkeys(TOL, 0.0)
    bound_by = {kernel: set() for kernel in TOL}
    library_ms = 0.0
    for name, (a, b, bsum) in gemms.items():
        M, K, N = int(np.prod(a.shape[:-1])), b.shape[0], b.shape[1]
        # the library call: one cuBLAS cgemm on interleaved complex64; the
        # planar -> interleaved conversion happens here, outside the timing
        ac = torch.complex(a.re, a.im).reshape(M, K).contiguous()
        bc = torch.complex(b.re, b.im).contiguous()
        runs = {"plain": lambda: cmatmul_plain(a, b),
                "plain_gauss": lambda: cmatmul_plain(a, b, gauss=True),
                "library": lambda: torch.matmul(ac, bc)}
        for kernel in TOL:
            runs[kernel] = (lambda kernel=kernel: run_kernel(kernel, a, b, bsum))
        # one interleaved sequence, there and back; each time is its mean
        t = dict.fromkeys(runs, 0.0)
        for which in list(runs) + list(reversed(runs)):
            t[which] += cuda_ms(runs[which], 10, run_ahead=True) / 2
        library_ms += t["library"]
        for kernel in TOL:
            plain = t["plain_gauss" if kernel == "f32_gauss" else "plain"]
            bound, by = bound_ms(kernel, M, K, N)
            ms[kernel] += t[kernel]
            plain_ms[kernel] += plain
            bounds[kernel] += bound
            bound_by[kernel].add(by)
            fl = (6 if kernel == "f32_gauss" else 8) * M * K * N
            print(f"[{card}] gemm {name} {kernel} ({M}x{K})@({K}x{N}): kernel "
                  f"{t[kernel]:.4f} ms ({fl / t[kernel] / 1e9:.1f} TFLOP/s fp32-equivalent), "
                  f"plain {plain:.4f} ms, library cgemm {t['library']:.4f} ms, bound "
                  f"{bound:.4f} ms by {by} (share reached {bound / t[kernel]:.3f})")

    if "--profile" in sys.argv[1:]:
        profile_steps(step)

    sources = {"tf32x3": ("cmatmul_tf32x3", "cmatmul_tc.cu", "41"),
               "f32_fma4": ("cmatmul_f32 (fma4)", "cmatmul.cu", "41"),
               "f32_gauss": ("cmatmul_f32 (gauss)", "cmatmul.cu", "56")}
    kernels = [{
        "name": sources[kernel][0],
        "route": "cuda",
        "source": "ofdm_lte_tpu_torch/csrc/" + sources[kernel][1],
        "replaces": "ofdm_lte_tpu/ops/pallas_kernels.py:" + sources[kernel][2],
        "launches": launches[kernel],
        "max_abs_err": max_err[kernel],
        "ms": ms[kernel],
        "plain_ms": plain_ms[kernel],
        "bound_ms": bounds[kernel],
        "bound_by": "/".join(sorted(bound_by[kernel])),
        "library_ms": library_ms,
    } for kernel in TOL]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
