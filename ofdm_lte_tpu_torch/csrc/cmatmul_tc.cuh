// What the mma.sync complex GEMM cmatmul_tc_gauss.cu (3-product Gauss form,
// `highest`) builds on; the wgmma kernels (cmatmul_wgmma_tf32x3.cu,
// cmatmul_wgmma_tf32.cu, cmatmul_bf16.cu) take its split-K pieces alone,
// through wgmma_cmatmul.cuh. Everything here is in an unnamed namespace.
//
//   - the tile geometry (Tile) and the staging of one K slab of the four
//     planes [Ar | Ai | Br | Bi] into shared memory with cp.async, 4 or 16
//     bytes wide by each operand's alignment, zero fill on every edge
//     (issue_slab);
//   - the split of an fp32 value into two TF32 operands (split_tf32) and the
//     mma.sync.m16n8k8 TF32 wrappers;
//   - split-K: how many ways a small tile grid is split (splits_for), the
//     second kernel that adds the partial planes in ascending order
//     (splitk_sum_kernel), and the host side of a call (run_gemm).
//
// Design notes are in cmatmul_tc_gauss.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 2;    // shared-memory stages of the cp.async ring

// A block of WARPS_M x WARPS_N warps computes a BM x BN tile of C; each warp
// a (16·MF) x (8·NF) tile of MF x NF mma fragments. A warp tile of two row
// fragments needs about 250 registers a thread, so 8 warps fit an SM: two
// blocks of four.
struct Tile {
  static constexpr int WARPS_M = 2;
  static constexpr int WARPS_N = 2;
  static constexpr int MF = 2;                       // m16 fragments a warp
  static constexpr int NF = 4;                       // n8 fragments a warp
  static constexpr int BM = 16 * MF * WARPS_M;       // rows of C per block
  static constexpr int BN = 8 * NF * WARPS_N;        // columns of C per block
  static constexpr int BK = 32;                      // depth of one staged slab
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int BLOCKS_PER_SM = 8 / (WARPS_M * WARPS_N);
  static constexpr int AP = BK + 4;                  // A pitch: banks 4g+t
  static constexpr int BP = BN + 8;                  // B pitch: banks 8t+g
  static constexpr int A_PLANE = BM * AP;
  static constexpr int B_PLANE = BK * BP;
  static constexpr int STAGE_FLOATS = 2 * A_PLANE + 2 * B_PLANE;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);  // 73,728 at 64x64, 2 stages
};

__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo', both TF32 operands: hi is x rounded to nearest (ties away
// from zero) to TF32's 10 mantissa bits, by integer arithmetic on the bit
// pattern; lo' = x − hi is exact in fp32, and the tensor core reads its top
// 10 mantissa bits only, so the pair stands for x to within 2^-21 |x|.
// (cvt.rna.tf32.f32 gives the same hi, but conversions run at a quarter
// of the integer rate, and two a value made them the kernel's limit.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16x8, row) · b (8x8, col). With g = lane >> 2, t = lane & 3:
// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4];
// b0 = B[t][g], b1 = B[t+4][g];
// d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t], d3 = D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a · b.
__device__ __forceinline__ void mma_tf32_from_zero(float (&d)[4], const uint32_t (&a)[4],
                                                   const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// Start the copies of one K slab into one stage: [Ar | Ai | Br | Bi].
template <class T, bool AVEC, bool BVEC>
__device__ __forceinline__ void issue_slab(
    float* stage, const float* __restrict__ ar, const float* __restrict__ ai,
    int64_t lda, const float* __restrict__ br, const float* __restrict__ bi,
    int64_t ldb, int row0, int col0, int k0, int M, int N, int K, int tid) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, AP = T::AP, BP = T::BP;
  constexpr int THREADS = T::THREADS;
  float* s_ar = stage;
  float* s_ai = stage + T::A_PLANE;
  float* s_br = stage + 2 * T::A_PLANE;
  float* s_bi = stage + 2 * T::A_PLANE + T::B_PLANE;

  if constexpr (AVEC) {
    const int c = tid % (BK / 4);               // 16-byte chunk along k
    const int r0 = tid / (BK / 4);
    const int gk = k0 + 4 * c;
    const int kbytes = min(max((K - gk) * 4, 0), 16);
#pragma unroll
    for (int i = 0; i < BM / (THREADS / (BK / 4)); ++i) {
      const int r = r0 + i * (THREADS / (BK / 4));
      const int gr = row0 + r;
      const int bytes = gr < M ? kbytes : 0;
      const int64_t off = bytes ? (int64_t)gr * lda + gk : 0;
      cp_async_16(&s_ar[r * AP + 4 * c], ar + off, bytes);
      cp_async_16(&s_ai[r * AP + 4 * c], ai + off, bytes);
    }
  } else {
    const int k = tid % BK;
    const int r0 = tid / BK;
    const int gk = k0 + k;
#pragma unroll
    for (int i = 0; i < BM / (THREADS / BK); ++i) {
      const int r = r0 + i * (THREADS / BK);
      const int gr = row0 + r;
      const bool ok = gr < M && gk < K;
      const int64_t off = ok ? (int64_t)gr * lda + gk : 0;
      cp_async_4(&s_ar[r * AP + k], ar + off, ok);
      cp_async_4(&s_ai[r * AP + k], ai + off, ok);
    }
  }

  if constexpr (BVEC) {
    const int c = tid % (BN / 4);               // 16-byte chunk along n
    const int k0r = tid / (BN / 4);
    const int gn = col0 + 4 * c;
    const int nbytes = min(max((N - gn) * 4, 0), 16);
#pragma unroll
    for (int i = 0; i < BK / (THREADS / (BN / 4)); ++i) {
      const int k = k0r + i * (THREADS / (BN / 4));
      const int gk = k0 + k;
      const int bytes = gk < K ? nbytes : 0;
      const int64_t off = bytes ? (int64_t)gk * ldb + gn : 0;
      cp_async_16(&s_br[k * BP + 4 * c], br + off, bytes);
      cp_async_16(&s_bi[k * BP + 4 * c], bi + off, bytes);
    }
  } else {
    const int n = tid % BN;
    const int k0r = tid / BN;
    const int gn = col0 + n;
#pragma unroll
    for (int i = 0; i < BK / (THREADS / BN); ++i) {
      const int k = k0r + i * (THREADS / BN);
      const int gk = k0 + k;
      const bool ok = gk < K && gn < N;
      const int64_t off = ok ? (int64_t)gk * ldb + gn : 0;
      cp_async_4(&s_br[k * BP + n], br + off, ok);
      cp_async_4(&s_bi[k * BP + n], bi + off, ok);
    }
  }
}

// C = the sum of the partial planes in ascending split order.
__global__ void splitk_sum_kernel(const float* __restrict__ part_r,
                                  const float* __restrict__ part_i,
                                  int64_t split_stride, int splits,
                                  float* __restrict__ cr, float* __restrict__ ci,
                                  int64_t ldc, int M, int N) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)M * N) return;
  float sr = 0.f, si = 0.f;
  for (int z = 0; z < splits; ++z) {
    sr += part_r[z * split_stride + idx];
    si += part_i[z * split_stride + idx];
  }
  const int64_t off = (idx / N) * ldc + idx % N;
  cr[off] = sr;
  ci[off] = si;
}

// How many ways K is split for this problem on a card of `sms`
// multiprocessors: 1 when the tile grid fills the card, else as many as
// bring the grid up to it, with no split left empty.
template <class T>
int splits_for(int M, int N, int K, int sms) {
  if (M <= 0 || N <= 0 || K <= 0) return 1;
  const int tiles = ((N + T::BN - 1) / T::BN) * ((M + T::BM - 1) / T::BM);
  const int n_slabs = (K + T::BK - 1) / T::BK;
  const int want = sms / tiles < n_slabs ? sms / tiles : n_slabs;
  if (want <= 1) return 1;
  const int per = (n_slabs + want - 1) / want;
  return (n_slabs + per - 1) / per;
}

// The signature of both forms' kernels: one block computes a BM x BN tile of
// C over the K slabs [blockIdx.z * slabs_per_split, ...). With gridDim.z > 1
// the tile is a partial sum and goes to split blockIdx.z of the scratch
// planes (cr + z * split_stride, same for ci).
using TileKernel = void (*)(const float*, const float*, int64_t, const float*, const float*,
                            int64_t, float*, float*, int64_t, int64_t, int, int, int, int);

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The host side of one product: pick the kernel by each operand's alignment
// (kernels[2 * avec + bvec]), launch it over the tile grid and the splits,
// and add the partial planes. For splits > 1 the caller provides a scratch
// buffer of 2 * splits * M * N floats.
template <class T>
int run_gemm(const TileKernel (&kernels)[4], const float* ar, const float* ai, int lda,
             const float* br, const float* bi, int ldb, float* cr, float* ci, int ldc,
             int M, int N, int K, float* scratch, int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || (splits > 1 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_slabs = (K + T::BK - 1) / T::BK;
  const int per = (n_slabs + splits - 1) / splits;

  const int64_t plane = (int64_t)M * N;
  float* out_r = splits > 1 ? scratch : cr;
  float* out_i = splits > 1 ? scratch + splits * plane : ci;
  const int64_t out_ld = splits > 1 ? N : ldc;

  const bool avec = aligned16(ar) && aligned16(ai) && lda % 4 == 0;
  const bool bvec = aligned16(br) && aligned16(bi) && ldb % 4 == 0;
  const TileKernel kernel = kernels[2 * avec + bvec];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, st>>>(ar, ai, lda, br, bi, ldb, out_r, out_i,
                                                  out_ld, plane, per, M, N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;

  const int threads = 256;
  const int blocks = (int)((plane + threads - 1) / threads);
  splitk_sum_kernel<<<blocks, threads, 0, st>>>(out_r, out_i, plane, splits,
                                                cr, ci, ldc, M, N);
  return (int)cudaGetLastError();
}

}  // namespace
