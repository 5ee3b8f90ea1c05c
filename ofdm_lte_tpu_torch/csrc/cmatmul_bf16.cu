// Planar complex GEMM for Hopper (sm_90a) at the `default` precision: bf16
// operands and fp32 sums, on wgmma with TMA, in the 4-dot form
// (`cmatmul_bf16`) and the 3-product Gauss form (`cmatmul_bf16_gauss`).
//
//   C = A @ B with A (M, K), B (K, N), C (M, N), each a pair of float32
//   planes (re, im), row-major, unit inner stride, row strides lda/ldb/ldc.
//
//   4-dot:  Cr = Ar·Br − Ai·Bi          Ci = Ar·Bi + Ai·Br
//   Gauss:  t1 = Ar·Br  t2 = Ai·Bi  t3 = (Ar+Ai)·(Br+Bi)
//           Cr = t1 − t2                Ci = t3 − t1 − t2
//
// Replaces the TPU kernel ofdm_lte_tpu/ops/pallas_kernels.py:_cmatmul_kernel
// (driven by cmatmul_pallas_2d) at its `default` precision, in both forms:
// every operand rounded to bf16, to nearest even (what Tensor.to(torch.bfloat16)
// and cvt.rn.bf16x2.f32 do), the products exact, the sums in fp32. In the
// Gauss form Ar+Ai and Br+Bi are added in fp32 and then rounded. So the
// kernel differs from its plain version (ops/cmatmul.py:cmatmul_plain_bf16,
// cmatmul_plain_gauss_bf16) only in the order of the sums. `highest` (3xTF32)
// is cmatmul_tc.cu and cmatmul_tc_gauss.cu, `high` (TF32) cmatmul_wgmma_tf32.cu.
//
// What bounds it here: operations, on the tensor cores at the bf16 rate (989
// TFLOP/s dense, twice TF32's): 8·M·K·N (4-dot) or 6·M·K·N (Gauss). The
// tensor cores need 1,024 clocks (4-dot; Gauss 768) for a 64-deep slab of the
// 128x64 complex tile. What the SM can be fed is the nearer limit: the `high`
// kernels' loop with bf16 operands and fp32 A (PERF.md, PR 15, design 1) took
// some 1,130 clocks for a 32-deep slab, and each of its halves alone nearly
// as long: the ring's supply of the slab's 40 KB (some 40 bytes a clock an
// SM; multicasting A to a cluster of two, which halves L2's reads, gained
// nothing) and the consumers' loads, roundings and register-A wgmmas.
//
// What the design does: the `high` kernels' persistent wgmma loop
// (wgmma_cmatmul.cuh: a producer warpgroup keeping a ring of TMA loads in
// flight, two consumer warpgroups of 64 rows under setmaxnreg, chains of
// slabs summed from zero in the tensor cores and added in fp32 on the CUDA
// cores, split-K summed in a fixed order) with both operands prepared per
// call as bf16, so that a slab carries half the bytes and the consumers only
// issue wgmmas:
//   - B, a constant table read by every row tile, is prepared by
//     prep_b_kernel into the caller's workspace: transposed to (N, Kp),
//     K-major (the layout that the TF32 kernels' prep and descriptors use;
//     the transpose through shared memory costs what a streaming pass would,
//     the bytes being the same), rounded to nearest even, K padded with zeros
//     to Kp, a multiple of the 64-deep slab, and for the Gauss form a third
//     plane rnd(Br + Bi), the sum in fp32;
//   - A, the large operand (58.7 MB of fp32 at RX data), is rounded by
//     prep_a_kernel in one streaming pass into (M, Kp) bf16 planes in the
//     workspace: rnd(Ar), rnd(Ai) and, for the Gauss form, rnd(Ar + Ai), the
//     sum in fp32. The pass reads A once in place at any lda and alignment
//     (so no copy for TMA, as at `high`, is needed) and halves the bytes that
//     every column tile then pulls from L2;
//   - both operands reach the ring by TMA with 128-byte swizzle (a slab row
//     is 64 bf16, 128 bytes), A as one 3-D load of its planes; a slab is four
//     k16 steps of wgmma.mma_async m64n64k16 bf16 with both operands read
//     from shared memory (the SS form): 4-dot Cr = Ar·Br − Ai·Bi (the
//     product negated by the instruction's scale of A) and Ci = Ar·Bi +
//     Ai·Br, four wgmmas a step; Gauss t1, t2, t3, three;
//   - a 64-deep slab of A and B is 48 KB (Gauss 72 KB): four stages (Gauss
//     three) in the ring;
//   - chains of CHAIN = 2 slabs, 128 of K, the length that the `high`
//     kernels measured: ops/cmatmul.py's WGMMA_BK and WGMMA_CHAIN repeat BK
//     and CHAIN for the plain twin, and a test holds them to this file.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_cmatmul.cuh"  // the ring, the persistent main loop, the host side

namespace {
namespace bf {

constexpr int BK = 64;       // depth of a slab: 64 bf16, one 128-byte swizzle row
constexpr int CHAIN = 2;     // slabs a chain of wgmmas sums from zero (128 of K)

// Two fp32 values as one register of two bf16, `lo` in the low half (the
// lower k), each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d (64x64 fp32, 32 a thread) = (scale_d ? d : 0) + SCALE_A · a · b, with a
// (64x16 bf16) and b (16x64 bf16) K-major in shared memory.
template <int SCALE_A>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, %35, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(SCALE_A));
}

// B (K, N) at ldb -> bt[p] (N, Kp) bf16: transposed, rounded to nearest
// even, zero past K; p = 0 Br, 1 Bi, and for Gauss 2 rnd(Br + Bi) with the
// sum in fp32. One 64 (k) x 32 (n) tile a block, through shared memory; a
// thread writes two k of a row as one 4-byte word.
template <bool GAUSS>
__global__ void __launch_bounds__(256)
prep_b_kernel(const float* __restrict__ br, const float* __restrict__ bi, int64_t ldb,
              uint32_t* __restrict__ bt, int N, int K, int kp) {
  __shared__ float s_r[64][33], s_i[64][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 64;
  const int x = threadIdx.x, y = threadIdx.y;
#pragma unroll
  for (int i = y; i < 64; i += 8) {
    const int k = k0 + i, n = n0 + x;
    const bool ok = k < K && n < N;
    s_r[i][x] = ok ? br[(int64_t)k * ldb + n] : 0.f;
    s_i[i][x] = ok ? bi[(int64_t)k * ldb + n] : 0.f;
  }
  __syncthreads();
  const int64_t plane = (int64_t)N * kp / 2;          // words a plane
#pragma unroll
  for (int i = y; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= N) continue;
    const float r0 = s_r[2 * x][i], r1 = s_r[2 * x + 1][i];
    const float i0 = s_i[2 * x][i], i1 = s_i[2 * x + 1][i];
    const int64_t off = ((int64_t)n * kp + k0) / 2 + x;
    bt[off] = pack_bf16(r0, r1);
    bt[plane + off] = pack_bf16(i0, i1);
    if (GAUSS) bt[2 * plane + off] = pack_bf16(__fadd_rn(r0, i0), __fadd_rn(r1, i1));
  }
}

// A (M, K) at lda -> at[p] (M, Kp) bf16, rounded to nearest even, zero past
// K; p = 0 Ar, 1 Ai, and for Gauss 2 rnd(Ar + Ai) with the sum in fp32. A
// thread makes two k of a row, one 4-byte word of each plane; a warp reads
// 256 contiguous bytes of each fp32 plane and writes 128 of each bf16 one.
template <bool GAUSS>
__global__ void __launch_bounds__(256)
prep_a_kernel(const float* __restrict__ ar, const float* __restrict__ ai, int64_t lda,
              uint32_t* __restrict__ at, int M, int K, int kp) {
  const int64_t words = (int64_t)kp / 2, plane = (int64_t)M * words;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < plane;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t m = idx / words;
    const int k = 2 * (int)(idx - m * words);
    const float* rr = ar + m * lda + k;
    const float* ri = ai + m * lda + k;
    const float r0 = k < K ? rr[0] : 0.f, r1 = k + 1 < K ? rr[1] : 0.f;
    const float i0 = k < K ? ri[0] : 0.f, i1 = k + 1 < K ? ri[1] : 0.f;
    at[idx] = pack_bf16(r0, r1);
    at[plane + idx] = pack_bf16(i0, i1);
    if (GAUSS) at[2 * plane + idx] = pack_bf16(__fadd_rn(r0, i0), __fadd_rn(r1, i1));
  }
}

// What the shared main loop and host side take from the bf16 kernels.
struct Bf16 {
  static constexpr int BK = bf::BK, CHAIN = bf::CHAIN;
  static constexpr int A_ELEM = 2, B_ELEM = 2;       // both operands prepared as bf16
  static constexpr bool PREPARES_A = true;
  static constexpr CUtensorMapDataType A_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType B_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  template <bool GAUSS> static constexpr int a_planes() { return GAUSS ? 3 : 2; }
  template <bool GAUSS> static constexpr int stages() { return GAUSS ? 3 : 4; }

  // A's prepared planes, one 3-D tensor (planes, M, Kp)
  static __device__ __forceinline__ void load_a(uint32_t dst, const CUtensorMap* ta,
                                                const CUtensorMap*, uint32_t bar, int k0,
                                                int row0) {
    wgc::tma_load_3d(dst, ta, bar, k0, row0, 0);
  }

  // One warpgroup's wgmmas of a slab: its 64 rows of each A plane from
  // `a_addr` (the planes 16 KB apart), the B planes from b0 (8 KB apart),
  // four k16 steps of 32 bytes each; one fence, then back to back.
  template <bool GAUSS>
  static __device__ __forceinline__ void slab(float (&ch)[GAUSS ? 3 : 2][32], const uint8_t*,
                                              uint32_t a_addr, uint32_t b0, bool chain_starts,
                                              int, int, int) {
    constexpr int A_BYTES = wgc::BM * BK * 2, B_BYTES = wgc::BN * BK * 2;
    wgc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t d_ar = wgc::sw128_desc(a_addr + 32 * kk);
      const uint64_t d_ai = wgc::sw128_desc(a_addr + A_BYTES + 32 * kk);
      const uint64_t d_br = wgc::sw128_desc(b0 + 32 * kk);
      const uint64_t d_bi = wgc::sw128_desc(b0 + B_BYTES + 32 * kk);
      const int sc = kk > 0 || !chain_starts;
      if constexpr (GAUSS) {
        const uint64_t d_as = wgc::sw128_desc(a_addr + 2 * A_BYTES + 32 * kk);
        const uint64_t d_bs = wgc::sw128_desc(b0 + 2 * B_BYTES + 32 * kk);
        wgmma_bf16<1>(ch[0], d_ar, d_br, sc);        // t1 = Ar·Br
        wgmma_bf16<1>(ch[1], d_ai, d_bi, sc);        // t2 = Ai·Bi
        wgmma_bf16<1>(ch[2], d_as, d_bs, sc);        // t3 = (Ar+Ai)·(Br+Bi)
      } else {
        wgmma_bf16<1>(ch[0], d_ar, d_br, sc);        // Cr = Ar·Br
        wgmma_bf16<-1>(ch[0], d_ai, d_bi, 1);        //    − Ai·Bi
        wgmma_bf16<1>(ch[1], d_ar, d_bi, sc);        // Ci = Ar·Bi
        wgmma_bf16<1>(ch[1], d_ai, d_br, 1);         //    + Ai·Br
      }
    }
  }

  template <bool GAUSS>
  static void prep_b(const float* br, const float* bi, int ldb, void* bt, int N, int K, int kp,
                     cudaStream_t st) {
    prep_b_kernel<GAUSS><<<dim3((N + 31) / 32, kp / 64), dim3(32, 8), 0, st>>>(
        br, bi, ldb, static_cast<uint32_t*>(bt), N, K, kp);
  }

  template <bool GAUSS>
  static void prep_a(const float* ar, const float* ai, int lda, void* at, int M, int K, int kp,
                     int sms, cudaStream_t st) {
    const int64_t blocks = ((int64_t)M * (kp / 2) + 255) / 256;
    prep_a_kernel<GAUSS><<<(int)(blocks < 8LL * sms ? blocks : 8LL * sms), 256, 0, st>>>(
        ar, ai, lda, static_cast<uint32_t*>(at), M, K, kp);
  }
};

template <bool GAUSS>
__global__ void __launch_bounds__(wgc::THREADS, 1)
cmatmul_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap ta_r,
                          const __grid_constant__ CUtensorMap ta_i,
                          const __grid_constant__ CUtensorMap tb,
                          float* __restrict__ cr, float* __restrict__ ci, int64_t ldc,
                          int64_t split_stride, int slabs_per_split, int n_slabs_all,
                          int M, int N, int m_tiles, int n_tiles, int units, int vec2) {
  wgc::cmatmul_body<Bf16, GAUSS>(&ta_r, &ta_i, &tb, cr, ci, ldc, split_stride, slabs_per_split,
                                 n_slabs_all, M, N, m_tiles, n_tiles, units, vec2);
}

}  // namespace bf
}  // namespace
// How many ways each kernel wants K split for this problem on a card of `sms`
// multiprocessors (splits_for over the 128x64 tile and 64-deep slabs). For
// splits > 1 the workspace holds the partial planes.
extern "C" int cmatmul_bf16_splits(int M, int N, int K, int sms) {
  return splits_for<wgc::SplitTile<bf::Bf16>>(M, N, K, sms);
}

extern "C" int cmatmul_bf16_gauss_splits(int M, int N, int K, int sms) {
  return splits_for<wgc::SplitTile<bf::Bf16>>(M, N, K, sms);
}

// The floats of workspace one call needs, for these operand pointers and lda.
extern "C" long long cmatmul_bf16_workspace(const float* ar, const float* ai, int lda, int M,
                                            int N, int K, int splits) {
  return wgc::workspace_floats<bf::Bf16, false>(ar, ai, lda, M, N, K, splits);
}

extern "C" long long cmatmul_bf16_gauss_workspace(const float* ar, const float* ai, int lda,
                                                  int M, int N, int K, int splits) {
  return wgc::workspace_floats<bf::Bf16, true>(ar, ai, lda, M, N, K, splits);
}

// The dynamic shared memory a block of either kernel takes (the ring, its
// barriers, the alignment slack).
extern "C" int cmatmul_bf16_smem_bytes(int gauss) {
  return gauss ? wgc::Layout<bf::Bf16, true>::SMEM_BYTES
               : wgc::Layout<bf::Bf16, false>::SMEM_BYTES;
}

// C = A @ B at `default`, 4-dot form. `scratch` is the workspace.
extern "C" int cmatmul_bf16(const float* ar, const float* ai, int lda,
                            const float* br, const float* bi, int ldb,
                            float* cr, float* ci, int ldc,
                            int M, int N, int K,
                            float* scratch, int splits, void* stream) {
  return wgc::run<bf::Bf16, false>(bf::cmatmul_wgmma_bf16_kernel<false>, ar, ai, lda, br, bi,
                                   ldb, cr, ci, ldc, M, N, K, scratch, splits, stream);
}

// The same in the Gauss form.
extern "C" int cmatmul_bf16_gauss(const float* ar, const float* ai, int lda,
                                  const float* br, const float* bi, int ldb,
                                  float* cr, float* ci, int ldc,
                                  int M, int N, int K,
                                  float* scratch, int splits, void* stream) {
  return wgc::run<bf::Bf16, true>(bf::cmatmul_wgmma_bf16_kernel<true>, ar, ai, lda, br, bi,
                                   ldb, cr, ci, ldc, M, N, K, scratch, splits, stream);
}
