"""Time design variants of the two tensor-core complex GEMMs (4-dot and
Gauss) against each other, and measure the card's mma.sync TF32 and bf16
rates, on one CUDA card.

    python3 -m ofdm_lte_tpu_torch.tools.tune_cmatmul_tc [VARIANT ...]

A VARIANT is a comma-separated list of the compile-time choices that
csrc/cmatmul_tc.cu and csrc/cmatmul_tc.cuh document (TC_WARPS_M, TC_CHAIN,
TC_SPLIT_CVT, TC_SPLIT_TRUNC, TC_STAGES, TC_NO_COPIES), e.g.
`TC_WARPS_M=4,TC_CHAIN=1`; `default` is the 4-dot source as the package
builds it. A VARIANT that starts with `gauss` is the Gauss kernel,
csrc/cmatmul_tc_gauss.cu: `gauss` alone as the package builds it, or
`gauss:` and its choices (TCG_WARPS_M, TCG_WARPS_N, TCG_MF, TCG_NF,
TCG_COLS, TCG_CHAIN, TCG_ACC3 and the shared TC_ ones), e.g.
`gauss:TCG_COLS=2,TCG_CHAIN=2`. With no arguments it runs the
sets behind the design notes in PERF.md. Each variant is compiled by its own
nvcc, all started together, into build/tune/, and run through its C
interface at the main path's three GEMM shapes (20 MHz, 256 lanes; random
operands with the path's strides) in one interleaved sequence, there and
back, beside the plain versions, the CUDA-core kernels and the library
call (torch.matmul on complex64). For each it prints registers and spills
(-Xptxas -v), the time, and the error against a float64 product.

The probe is a loop of independent mma.sync.m16n8k8 TF32 instructions, and
one of mma.sync.m16n8k16 bf16 instructions, on every SM: the rate each
instruction reaches with nothing else in its way. utils/profiling.CEILINGS keeps the highest reading of each.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from .. import _build
from ..cplx import C
from ..ops.cmatmul import cmatmul, cmatmul_plain

DEFAULT_VARIANTS = ("default", "TC_WARPS_M=4", "TC_CHAIN=1", "TC_CHAIN=2", "TC_CHAIN=0",
                    "TC_SPLIT_CVT=1", "TC_STAGES=3", "TC_STAGES=4", "TC_NO_COPIES=1",
                    "TC_SPLIT_TRUNC=1",
                    "gauss", "gauss:TCG_CHAIN=2", "gauss:TCG_CHAIN=1", "gauss:TCG_CHAIN=1,TCG_ACC3=1",
                    "gauss:TCG_COLS=1,TCG_CHAIN=1,TCG_ACC3=1", "gauss:TCG_COLS=2,TCG_CHAIN=2",
                    "gauss:TCG_COLS=2", "gauss:TCG_WARPS_M=4",
                    "gauss:TCG_MF=1,TCG_WARPS_M=4,TCG_COLS=1,TCG_CHAIN=1,TCG_ACC3=1",
                    "gauss:TC_SPLIT_TRUNC=1", "gauss:TC_NO_COPIES=1")

PROBE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
// BF16 = 0: mma.sync.m16n8k8 tf32 (2048 flops); 1: m16n8k16 bf16 (4096)
template <int BF16, int NACC>
__global__ void __launch_bounds__(256, 1) probe(float* out, int iters) {
  float d[NACC][4];
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b[2] = {threadIdx.x * 3, threadIdx.x * 5};
#pragma unroll
  for (int i = 0; i < NACC; ++i) for (int v = 0; v < 4; ++v) d[i][v] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NACC; ++i) for (int v = 0; v < 4; ++v) s += d[i][v];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int BF16, int NACC>
void run(int threads, int sms) {
  float* out; cudaMalloc(&out, sms * 256 * sizeof(float));
  const int iters = 20000;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  probe<BF16, NACC><<<sms, threads>>>(out, 100);
  cudaEventRecord(e0);
  probe<BF16, NACC><<<sms, threads>>>(out, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)sms * (threads / 32) * NACC * iters;
  printf("probe mma.sync %s: %d warps an SM, %d independent accumulators a warp: "
         "%.1f TFLOP/s, %.2f ns an MMA per SM quarter\n",
         BF16 ? "m16n8k16 bf16" : "m16n8k8 tf32", threads / 32, NACC,
         mmas * (BF16 ? 4096 : 2048) / ms / 1e9, ms * 1e6 / (mmas / sms / 4));
  cudaFree(out);
}
template <int BF16>
void run_all(int sms) {
  run<BF16, 1>(128, sms); run<BF16, 4>(128, sms); run<BF16, 8>(128, sms);
  run<BF16, 8>(256, sms); run<BF16, 16>(256, sms);
}
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run_all<0>(sms);
  run_all<1>(sms);
  return 0;
}
"""


def _cuda_ms(fn, reps: int = 10) -> float:
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


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("tune_cmatmul_tc needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    variants = list(argv) or list(DEFAULT_VARIANTS)
    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    probe_src = out_dir / "probe.cu"
    probe_src.write_text(PROBE_CU)
    procs = [subprocess.Popen([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                               str(out_dir / "probe"), str(probe_src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for i, v in enumerate(variants):
        gauss = v.startswith("gauss")
        choices = v.partition(":")[2] if gauss else ("" if v == "default" else v)
        defs = [f"-D{d}" for d in choices.split(",") if d]
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", *defs, "-o", str(out_dir / f"v{i}.so"),
             str(_build.CSRC / ("cmatmul_tc_gauss.cu" if gauss else "cmatmul_tc.cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    print(subprocess.run([str(out_dir / "probe")], capture_output=True, text=True,
                         check=True).stdout.strip())

    libs = {}
    for i, (v, log) in enumerate(zip(variants, logs[1:])):
        used = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "Used" in line or "spill" in line]
        # the first four entries are the four copy-width forms of the kernel
        print(f"build {v}: " + " | ".join(used[:8]))
        lib = ctypes.CDLL(str(out_dir / f"v{i}.so"))
        p, n = ctypes.c_void_p, ctypes.c_int
        name = "cmatmul_tf32x3_gauss" if v.startswith("gauss") else "cmatmul_tf32x3"
        gemm, splits_fn = getattr(lib, name), getattr(lib, name + "_splits")
        gemm.argtypes = [p, p, n, p, p, n, p, p, n, n, n, n, p, n, p]
        splits_fn.argtypes = [n, n, n, n]
        libs[v] = (gemm, splits_fn)

    def run(fns, a: C, b: C) -> C:
        gemm, splits_fn = fns
        (M, K), N = a.re.shape, b.re.shape[1]
        cr = torch.empty((M, N), device=dev)
        ci = torch.empty((M, N), device=dev)
        splits = splits_fn(M, N, K, sms)
        scratch = torch.empty((2 * splits, M, N), device=dev) if splits > 1 else None
        rc = gemm(a.re.data_ptr(), a.im.data_ptr(), a.re.stride(0),
                  b.re.data_ptr(), b.im.data_ptr(), b.re.stride(0),
                  cr.data_ptr(), ci.data_ptr(), N, M, N, K,
                  scratch.data_ptr() if splits > 1 else None, splits,
                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{gemm.__name__} failed: CUDA error {rc}")
        return C(cr, ci)

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def randc(*shape) -> C:
        return C(torch.randn(shape, generator=g, device=dev),
                 torch.randn(shape, generator=g, device=dev))

    y = randc(3584, 2192)
    shapes = {"tx": (randc(3584, 999), randc(999, 2192)),
              "rx_data": (y[:, 144:], randc(2048, 999)),
              "rx_pilot": (y[::14, 144:], randc(2048, 200))}
    for name, (a, b) in shapes.items():
        exact = torch.complex(a.re.double(), a.im.double()) @ torch.complex(b.re.double(),
                                                                          b.im.double())
        scale = exact.abs().max().item()
        ac = torch.complex(a.re, a.im).contiguous()
        bc = torch.complex(b.re, b.im)
        bsum = b.re + b.im

        def library():
            out = torch.matmul(ac, bc)
            return C(out.real, out.imag)

        runs = {"plain": lambda: cmatmul_plain(a, b),
                "plain_gauss": lambda: cmatmul_plain(a, b, gauss=True),
                "library": library,
                "ffma": lambda: cmatmul(a, b, variant="ffma"),
                "ffma_gauss": lambda: cmatmul(a, b, gauss=True, bsum=bsum, variant="ffma")}
        runs.update({v: (lambda fns=fns: run(fns, a, b)) for v, fns in libs.items()})
        t = dict.fromkeys(runs, 0.0)
        for which in list(runs) + list(reversed(runs)):
            t[which] += _cuda_ms(runs[which]) / 2
        for which, fn in runs.items():
            out = fn()
            err = (torch.complex(out.re.double(), out.im.double()) - exact).abs().max().item()
            print(f"[{card}] {name} {tuple(a.re.shape)}@{tuple(b.re.shape)} {which}: "
                  f"{t[which]:.4f} ms, max|d|/max|C| against float64 {err / scale:.3e}")


if __name__ == "__main__":
    main(sys.argv[1:])
