"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the 20 MHz 64-QAM SISO link over AWGN with CRS
estimation and ZF, at 256 Monte-Carlo lanes of 14-symbol frames
(21.5 M bits per step), as ofdm_lte_tpu_torch.sim.siso.SisoLink runs it.
Phases, each of which raises on failure:

1. require a CUDA card; print its name and power limit;
2. build the CUDA kernels from ofdm_lte_tpu_torch/csrc into build/;
3. hold the complex-GEMM kernel, both forms, against its plain PyTorch
   version (fp32, TF32 off) at the path's three GEMM shapes, with the
   strided operands the path makes, and at two small ragged shapes;
4. run the OFDMModule facade once;
5. run the link at 60 dB (BER must be 0) and 15 dB (BER in
   [0.0836, 0.0880], around the JAX package's 0.08586), once per GEMM
   form, counting kernel launches (3 per step); and hold the CUDA path
   against the CPU path on a small input with the same injected noise;
6. time the link (CUDA events, bits and seed changed every step) and each
   GEMM through the kernel and through the plain version.

The second-to-last line is a JSON object describing each kernel; the last
is {"ok": true, "device": {...}}. Needs one card and no network.
"""
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
TOL = {False: 1e-5, True: 1e-4}    # max|Δ| / max|C|: 4-dot, Gauss (one extra rounding)
FORMS = {False: "fma4", True: "gauss"}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs after 3 warm-up runs."""
    for _ in range(3):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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
    from ofdm_lte_tpu_torch.ops.cmatmul import cmatmul, cmatmul_plain
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
    max_err = {False: 0.0, True: 0.0}
    for name, (a, b, bsum) in {**gemms, **ragged}.items():
        M = int(np.prod(a.shape[:-1]))
        for gauss in (False, True):
            out = cmatmul(a, b, gauss=gauss, bsum=bsum)
            ref = cmatmul_plain(a, b, gauss=gauss)
            torch.cuda.synchronize()
            err = max((out.re - ref.re).abs().max().item(), (out.im - ref.im).abs().max().item())
            scale = max(ref.re.abs().max().item(), ref.im.abs().max().item())
            rel = err / scale
            print(f"check {name} {FORMS[gauss]} (M={M}, K={b.shape[0]}, N={b.shape[1]}, "
                  f"lda={a.re.stride(-2)}): max|d| {err:.3e}  max|d|/max|C| {rel:.3e}  "
                  f"tol {TOL[gauss]:.0e}")
            if not (rel <= TOL[gauss]):
                raise AssertionError(f"kernel {FORMS[gauss]} disagrees with plain at {name}: "
                                     f"{rel:.3e} > {TOL[gauss]:.0e}")
            max_err[gauss] = max(max_err[gauss], err)
    torch.cuda.synchronize()

    # -- 4. the facade, once -----------------------------------------------
    cmatmul.launches = 0
    res = OFDMModule(cfg, device=dev, seed=3).transmit(
        np.random.default_rng(3).integers(0, 2, n_bits), 60.0)
    if res["ber"] != 0 or cmatmul.launches != 3 or not np.isfinite(res["papr_db"]):
        raise AssertionError(f"facade: ber {res['ber']} launches {cmatmul.launches} "
                             f"papr {res['papr_db']}")
    print(f"facade OFDMModule.transmit at 60 dB: ber {res['ber']} papr_db "
          f"{res['papr_db']:.3f} evm% {res['evm_percent']:.4f} launches {cmatmul.launches}")

    # -- 5. the main path, once per GEMM form ------------------------------
    launches = {}
    for gauss in (False, True):
        os.environ["OFDM_LTE_TPU_TORCH_CMATMUL"] = FORMS[gauss]
        cmatmul.launches = 0
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
        launches[gauss] = cmatmul.launches
        print(f"main path {FORMS[gauss]}: {LANES} lanes x {SYMBOLS} symbols, BER@60dB "
              f"{bers[60.0]:.6g}, BER@15dB {bers[15.0]:.6g}, launches {launches[gauss]}")
        if bers[60.0] != 0.0 or not (BER_15DB[0] <= bers[15.0] <= BER_15DB[1]):
            raise AssertionError(f"{FORMS[gauss]}: BER {bers} outside 0 / {BER_15DB}")
        if launches[gauss] != 3 * 2:
            raise AssertionError(f"{FORMS[gauss]}: {launches[gauss]} launches, expected 6")
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
    ms_step = cuda_ms(step, STEPS)
    fps = LANES / (ms_step / 1e3)
    print(f"[{card}] main path 20 MHz 64-QAM fma4, {LANES} lanes: {ms_step:.4f} ms/step, "
          f"{fps:.1f} frames/s, {LANES * n_bits / (ms_step / 1e3) / 1e9:.3f} Gbit/s")

    ms = {False: 0.0, True: 0.0}
    plain_ms = {False: 0.0, True: 0.0}
    for name, (a, b, bsum) in gemms.items():
        M, K, N = int(np.prod(a.shape[:-1])), b.shape[0], b.shape[1]
        for gauss in (False, True):
            fl = (6 if gauss else 8) * M * K * N
            # plain, kernel, kernel, plain; each side's time is its mean
            tp = cuda_ms(lambda: cmatmul_plain(a, b, gauss), 10)
            tk = cuda_ms(lambda: cmatmul(a, b, gauss=gauss, bsum=bsum), 10)
            tk = (tk + cuda_ms(lambda: cmatmul(a, b, gauss=gauss, bsum=bsum), 10)) / 2
            tp = (tp + cuda_ms(lambda: cmatmul_plain(a, b, gauss), 10)) / 2
            ms[gauss] += tk
            plain_ms[gauss] += tp
            print(f"[{card}] gemm {name} {FORMS[gauss]} ({M}x{K})@({K}x{N}): kernel "
                  f"{tk:.4f} ms ({fl / tk / 1e9:.1f} TFLOP/s), plain {tp:.4f} ms "
                  f"({fl / tp / 1e9:.1f} TFLOP/s)")

    kernels = [{
        "name": f"cmatmul_f32 ({FORMS[gauss]})",
        "route": "cuda",
        "source": "ofdm_lte_tpu_torch/csrc/cmatmul.cu",
        "replaces": "ofdm_lte_tpu/ops/pallas_kernels.py:" + ("56" if gauss else "41"),
        "launches": launches[gauss],
        "max_abs_err": max_err[gauss],
        "ms": ms[gauss],
        "plain_ms": plain_ms[gauss],
    } for gauss in (False, True)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
