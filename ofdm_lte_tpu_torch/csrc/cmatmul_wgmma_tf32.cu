// Planar complex GEMM for Hopper (sm_90a) at the `high` precision: one TF32
// product of the operands rounded to TF32, on wgmma with TMA, in the 4-dot
// form (`cmatmul_tf32`) and the 3-product Gauss form (`cmatmul_tf32_gauss`).
//
//   C = A @ B with A (M, K), B (K, N), C (M, N), each a pair of float32
//   planes (re, im), row-major, unit inner stride, row strides lda/ldb/ldc.
//
//   4-dot:  Cr = Ar·Br − Ai·Bi          Ci = Ar·Bi + Ai·Br
//   Gauss:  t1 = Ar·Br  t2 = Ai·Bi  t3 = (Ar+Ai)·(Br+Bi)
//           Cr = t1 − t2                Ci = t3 − t1 − t2
//
// Replaces the TPU kernel ofdm_lte_tpu/ops/pallas_kernels.py:_cmatmul_kernel
// (driven by cmatmul_pallas_2d) at its `high` precision, in both forms. Every
// operand is rounded once to TF32, to nearest with ties away from zero (the
// head of ops/cmatmul.py:tf32_split, what cvt.rna.tf32.f32 gives); in the
// Gauss form Ar+Ai and Br+Bi are added in fp32 and then rounded. The products
// of two TF32 values are exact, so the kernel differs from its plain version
// (ops/cmatmul.py:cmatmul_plain_tf32, cmatmul_plain_gauss_tf32) only in the
// order of the sums. `highest` (3xTF32) stays in cmatmul_tc.cu and
// cmatmul_tc_gauss.cu, `default` (bf16) in cmatmul_bf16.cu.
//
// What bounds it here: operations, on the tensor cores at the TF32 rate (495
// TFLOP/s dense): 8·M·K·N (4-dot) or 6·M·K·N (Gauss). At the modem's shapes
// the operands are reused hundreds of times, so device memory is some 4x from
// the limit; at K = 16 (the Jakes product) the output's bytes bound it.
// Measured on an H100 (700 W; tools/time_cmatmul_high.py and, in PERF.md,
// the readings of a clock trace and of probe builds of this loop): a 32-deep
// slab takes some 1,550 clocks where the tensor cores need 1,024 (4-dot)
// or 768 (Gauss). Two things hold it there: the wgmmas with A from
// registers issue at about two thirds of the tensor cores' rate (with A read
// from shared memory they go some 14% faster), and the TMA ring supplies a
// 48 or 56 KB slab no faster than one per 1,160 or 1,440 clocks (about 40
// bytes a clock an SM), which is where the Gauss form stays.
//
// What the design does:
//   - operands in a layout that TMA and wgmma accept, each value rounded once.
//     wgmma reads both TF32 operands K-major and cuts a raw fp32 value (it does
//     not round), so B, a constant table read by every row tile, is prepared
//     per call by prep_b_kernel into the caller's workspace: transposed to
//     (N, Kp), rounded, K padded with zeros to Kp, a multiple of the 32-deep
//     slab, and for the Gauss form a third plane rnd(Br + Bi). A, the large
//     operand (58.7 MB at the RX data GEMM, where preparing it would cost a
//     fifth of the GEMM), is read raw by TMA and rounded in registers: wgmma
//     takes A from registers (the RS form), in mma.sync's m16n8k8 fragment
//     layout, so each consumer thread loads its fragment from the swizzled
//     tile, rounds it (two integer instructions a value), forms rnd(Ar + Ai)
//     for Gauss and −rnd(Ai) for the 4-dot form's Cr by a sign flip. Where TMA
//     cannot read A (a base that is not 16-byte aligned or a row pitch that is
//     not a multiple of 16 bytes: K = 999 at TX, any lda), copy_a_kernel
//     copies the raw planes into the workspace at pitch Kp first;
//   - one block per SM, persistent over the (row tile, column tile, K split)
//     units: a producer warpgroup, one thread of which keeps TMA loads of
//     [Ar | Ai | B planes] in flight into a ring of 4 stages tracked by full
//     and empty mbarriers, and two consumer warpgroups, each 64 rows of the
//     128x64 complex tile, that run wgmma.mma_async m64n64k8 TF32. The ring
//     runs on across units, so a tile's loads overlap the previous one's
//     epilogue (at K = 16 the whole kernel is loads and stores). Registers
//     are granted a warpgroup at a time, so the producer is a warpgroup of
//     its own that gives all but 40 a thread to the consumers (setmaxnreg:
//     232 a consumer thread, where 384 threads would get 168 each and the
//     compiler serialises the wgmmas and spills);
//   - short chains: the wgmmas of CHAIN = 4 slabs (128 of K) run as a
//     chain from zero (scale-d 0 on the first), and its result joins an fp32
//     running sum on the CUDA cores. Summing all of K in the tensor cores'
//     truncating adder cost a digit at K = 2048 (1.5e-5 of max|C| on the
//     mma.sync kernel); chains of 128 cost 5.85e-6 of max|C| against the
//     plain version at K = 2048 where chains of one slab cost 5.1e-6, and
//     adding after every slab took 6-17% longer. ops/cmatmul.py's
//     WGMMA_BK and WGMMA_CHAIN repeat BK and CHAIN for the plain twin, and a
//     test holds them to this file. The Gauss
//     form folds its three chains into Cr += t1 − t2 and Ci += t3 − t1 − t2;
//   - a slab's A fragments are all loaded and rounded first, then one
//     wgmma.fence and the slab's 16 (Gauss: 12) wgmmas go out back to back
//     (a fence before each k8 step's four took 12% longer at TX);
//   - the second consumer warpgroup issues its first batch of wgmmas after
//     the first warpgroup's (a named barrier, once), so that one's chain
//     completes, and is added on the CUDA cores, while the other's runs on
//     the tensor cores; each batch then queues behind the other's, which
//     keeps them apart. Started together off one full barrier, they would
//     wait and add at the same time and leave the tensor cores idle;
//   - TMA with 128-byte swizzle: a slab row is 32 fp32 = 128 bytes, so the
//     wgmma descriptor of B is the canonical K-major SW128 one, advanced 32
//     bytes a k8 step, and the A fragment loads fall on 32 banks; rows and
//     columns past M, N and K are zero-filled by TMA, so nothing is masked in
//     the main loop;
//   - C is stored from registers, two columns a thread as one 8-byte store
//     where ldc and the planes allow it (a warp writes eight full 32-byte
//     sectors an instruction), masked at M and N, into the caller's (M, N)
//     planes at any ldc;
//   - a tile grid smaller than the card (the pilot GEMM: 2x4 tiles) is split
//     along K into partial planes in the workspace, which splitk_sum_kernel
//     adds in ascending order: the same bits every run;
//   - the TMA descriptors are built on the host at every call (the operands
//     move), by cuTensorMapEncodeTiled from the driver entry point that the
//     runtime hands out, so the library needs no -lcuda; they reach the
//     kernel as __grid_constant__ parameters.
//
// The ring, the persistent walk, the chains and the host side are shared with
// the `default` kernels (cmatmul_bf16.cu) through wgmma_cmatmul.cuh; this file
// holds what is TF32's: the rounding, the m64n64k8 wgmma and B's prep.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_cmatmul.cuh"  // the ring, the persistent main loop, the host side

namespace {
namespace wg {

constexpr int BK = 32;       // depth of a slab: 128 bytes of fp32, one swizzle row
constexpr int STAGES = 4;    // stages of the TMA ring
constexpr int CHAIN = 4;     // slabs a chain of wgmmas sums from zero (128 of K)

// x rounded to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero: split_tf32's head, by integer arithmetic on the bit pattern.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d (64x64 fp32, 32 a thread) = (scale_d ? d : 0) + a · b, with a (64x8 TF32)
// in registers in the m16n8k8 fragment layout (warp w of the warpgroup holds
// rows 16w..16w+15) and b (8x64) K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// B (K, N) at ldb -> bt[p] (N, Kp): transposed, rounded, zero past K; p = 0
// Br, 1 Bi, and for Gauss 2 rnd(Br + Bi) with the sum in fp32. One 32x32
// tile a block, through shared memory.
template <bool GAUSS>
__global__ void __launch_bounds__(256)
prep_b_kernel(const float* __restrict__ br, const float* __restrict__ bi, int64_t ldb,
              float* __restrict__ bt, int N, int K, int kp) {
  __shared__ float s_r[32][33], s_i[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int x = threadIdx.x, y = threadIdx.y;
#pragma unroll
  for (int i = y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + x;
    const bool ok = k < K && n < N;
    s_r[i][x] = ok ? br[(int64_t)k * ldb + n] : 0.f;
    s_i[i][x] = ok ? bi[(int64_t)k * ldb + n] : 0.f;
  }
  __syncthreads();
  const int64_t plane = (int64_t)N * kp;
#pragma unroll
  for (int i = y; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= N) continue;
    const float xr = s_r[x][i], xi = s_i[x][i];
    const int64_t off = (int64_t)n * kp + k0 + x;
    bt[off] = __uint_as_float(tf32_rna(xr));
    bt[plane + off] = __uint_as_float(tf32_rna(xi));
    if (GAUSS) bt[2 * plane + off] = __uint_as_float(tf32_rna(__fadd_rn(xr, xi)));
  }
}

// What the shared main loop and host side take from the TF32 kernels.
struct Tf32 {
  static constexpr int BK = wg::BK, CHAIN = wg::CHAIN;
  static constexpr int A_ELEM = 4, B_ELEM = 4;       // A raw fp32, B as TF32 in fp32 words
  static constexpr bool PREPARES_A = false;          // A read in place, or copied
  static constexpr CUtensorMapDataType A_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapDataType B_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  template <bool GAUSS> static constexpr int a_planes() { return 2; }
  template <bool GAUSS> static constexpr int stages() { return wg::STAGES; }

  // A's two fp32 planes, each from its own tensor (in place or copied)
  static __device__ __forceinline__ void load_a(uint32_t dst, const CUtensorMap* ta_r,
                                                const CUtensorMap* ta_i, uint32_t bar, int k0,
                                                int row0) {
    wgc::tma_load_2d(dst, ta_r, bar, k0, row0);
    wgc::tma_load_2d(dst + wgc::BM * BK * 4, ta_i, bar, k0, row0);
  }

  // One warpgroup's wgmmas of a slab. Its thread's fragments of the slab's
  // four k8 steps (rows 16w+g (+8), k 8kk+t (+4)) are loaded from the
  // 128-byte-swizzled fp32 tile at `a` (16-byte chunk c of row r at c ^
  // (r & 7)) and rounded, with rnd(Ar+Ai) (Gauss) or −rnd(Ai) (4-dot) beside
  // them; then one fence and the slab's 16 (Gauss: 12) wgmmas back to back.
  template <bool GAUSS>
  static __device__ __forceinline__ void slab(float (&ch)[GAUSS ? 3 : 2][32], const uint8_t* a,
                                              uint32_t, uint32_t b0, bool chain_starts, int w,
                                              int g, int t) {
    constexpr int A_BYTES = wgc::BM * BK * 4, B_BYTES = wgc::BN * BK * 4;
    uint32_t xr[BK / 8][4], xi[BK / 8][4], xs[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = 16 * w + g + 8 * (v & 1);
        const int off = r * 128 + (((2 * kk + (v >> 1)) ^ g) << 4) + 4 * t;
        const float fr = *reinterpret_cast<const float*>(a + off);
        const float fi = *reinterpret_cast<const float*>(a + A_BYTES + off);
        xr[kk][v] = tf32_rna(fr);
        xi[kk][v] = tf32_rna(fi);
        xs[kk][v] = GAUSS ? tf32_rna(__fadd_rn(fr, fi)) : (xi[kk][v] ^ 0x80000000u);
      }
    }
    wgc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t d_br = wgc::sw128_desc(b0 + 32 * kk);
      const uint64_t d_bi = wgc::sw128_desc(b0 + B_BYTES + 32 * kk);
      const int sc = kk > 0 || !chain_starts;
      if constexpr (GAUSS) {
        const uint64_t d_bs = wgc::sw128_desc(b0 + 2 * B_BYTES + 32 * kk);
        wgmma_tf32(ch[0], xr[kk], d_br, sc);          // t1 = Ar·Br
        wgmma_tf32(ch[1], xi[kk], d_bi, sc);          // t2 = Ai·Bi
        wgmma_tf32(ch[2], xs[kk], d_bs, sc);          // t3 = (Ar+Ai)·(Br+Bi)
      } else {
        wgmma_tf32(ch[0], xr[kk], d_br, sc);          // Cr = Ar·Br
        wgmma_tf32(ch[0], xs[kk], d_bi, 1);           //    + (−Ai)·Bi
        wgmma_tf32(ch[1], xr[kk], d_bi, sc);          // Ci = Ar·Bi
        wgmma_tf32(ch[1], xi[kk], d_br, 1);           //    + Ai·Br
      }
    }
  }

  template <bool GAUSS>
  static void prep_b(const float* br, const float* bi, int ldb, void* bt, int N, int K, int kp,
                     cudaStream_t st) {
    prep_b_kernel<GAUSS><<<dim3((N + 31) / 32, kp / 32), dim3(32, 8), 0, st>>>(
        br, bi, ldb, static_cast<float*>(bt), N, K, kp);
  }
};

template <bool GAUSS>
__global__ void __launch_bounds__(wgc::THREADS, 1)
cmatmul_wgmma_tf32_kernel(const __grid_constant__ CUtensorMap ta_r,
                          const __grid_constant__ CUtensorMap ta_i,
                          const __grid_constant__ CUtensorMap tb,
                          float* __restrict__ cr, float* __restrict__ ci, int64_t ldc,
                          int64_t split_stride, int slabs_per_split, int n_slabs_all,
                          int M, int N, int m_tiles, int n_tiles, int units, int vec2) {
  wgc::cmatmul_body<Tf32, GAUSS>(&ta_r, &ta_i, &tb, cr, ci, ldc, split_stride, slabs_per_split,
                                 n_slabs_all, M, N, m_tiles, n_tiles, units, vec2);
}

}  // namespace wg
}  // namespace

// How many ways each kernel wants K split for this problem on a card of `sms`
// multiprocessors (splits_for over the 128x64 tile and 32-deep slabs).
extern "C" int cmatmul_tf32_splits(int M, int N, int K, int sms) {
  return splits_for<wgc::SplitTile<wg::Tf32>>(M, N, K, sms);
}

extern "C" int cmatmul_tf32_gauss_splits(int M, int N, int K, int sms) {
  return splits_for<wgc::SplitTile<wg::Tf32>>(M, N, K, sms);
}

// The floats of workspace one call needs, for these operand pointers and lda.
extern "C" long long cmatmul_tf32_workspace(const float* ar, const float* ai, int lda, int M,
                                            int N, int K, int splits) {
  return wgc::workspace_floats<wg::Tf32, false>(ar, ai, lda, M, N, K, splits);
}

extern "C" long long cmatmul_tf32_gauss_workspace(const float* ar, const float* ai, int lda,
                                                  int M, int N, int K, int splits) {
  return wgc::workspace_floats<wg::Tf32, true>(ar, ai, lda, M, N, K, splits);
}

// The dynamic shared memory a block of either kernel takes (the ring, its
// barriers, the alignment slack).
extern "C" int cmatmul_tf32_smem_bytes(int gauss) {
  return gauss ? wgc::Layout<wg::Tf32, true>::SMEM_BYTES
               : wgc::Layout<wg::Tf32, false>::SMEM_BYTES;
}

// C = A @ B at `high`, 4-dot form. `scratch` is the workspace.
extern "C" int cmatmul_tf32(const float* ar, const float* ai, int lda,
                            const float* br, const float* bi, int ldb,
                            float* cr, float* ci, int ldc,
                            int M, int N, int K,
                            float* scratch, int splits, void* stream) {
  return wgc::run<wg::Tf32, false>(wg::cmatmul_wgmma_tf32_kernel<false>, ar, ai, lda, br, bi,
                                   ldb, cr, ci, ldc, M, N, K, scratch, splits, stream);
}

// The same in the Gauss form.
extern "C" int cmatmul_tf32_gauss(const float* ar, const float* ai, int lda,
                                  const float* br, const float* bi, int ldb,
                                  float* cr, float* ci, int ldc,
                                  int M, int N, int K,
                                  float* scratch, int splits, void* stream) {
  return wgc::run<wg::Tf32, true>(wg::cmatmul_wgmma_tf32_kernel<true>, ar, ai, lda, br, bi,
                                  ldb, cr, ci, ldc, M, N, K, scratch, splits, stream);
}
