// Planar complex GEMM for Hopper (sm_90a) on the tensor cores with bf16
// operands and fp32 accumulation, in the 4-dot form (`cmatmul_bf16`) and the
// 3-product Gauss form (`cmatmul_bf16_gauss`).
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
// every operand rounded to bf16 (round to nearest even, what
// Tensor.to(torch.bfloat16) does), the products exact, the sums in fp32. In
// the Gauss form Ar+Ai and Br+Bi are added in fp32 and then rounded like the
// other planes. The `highest` precision is cmatmul_tc.cu and
// cmatmul_tc_gauss.cu, whose tile, staging and split-K this file shares
// through cmatmul_tc.cuh; `high` is cmatmul_wgmma_tf32.cu.
//
// What bounds it here: operations, on the tensor cores at the bf16 rate
// (989 TFLOP/s dense, twice TF32's): 8·M·K·N (4-dot) or 6·M·K·N (Gauss)
// over it. That is a sixth of the 3xTF32 kernel's MMA time, so the fp32
// staging copies and the conversions are expected to set the pace.
//
// What the design does (simple first; wgmma and TMA are later work):
//   - warp-level mma.sync.m16n8k16 bf16 with fp32 accumulation, on the 3xTF32
//     kernels' 64x64 tile of 4 warps (32x32 complex a warp, 2x4 fragments),
//     two blocks an SM, a 2-stage cp.async ring of fp32 slabs of 32 along K
//     (issue_slab: 4- or 16-byte copies by alignment, zero fill on every
//     edge); a slab is two k16 steps;
//   - the planes stay fp32 in device and shared memory and are converted as
//     the fragments are loaded, two values a cvt.rn.bf16x2.f32. So the
//     operands are read once, as the callers hold them (the CP-stripped and
//     slot-start views through lda, the constant DFT tables), and nothing
//     else is written;
//   - pitches for the k16 fragments: A [m][k] at 40 floats, so that a
//     thread's pair (2t, 2t+1) is one 8-byte load and a half-warp's 16 loads
//     fall in 32 different banks (8g + 2t); B [k][n] at 68, so that rows 2t
//     and 2t+1 of column g fall in banks 8t + g and 8t + g + 4;
//   - the short chain of the TF32 kernels: a slab's MMAs summed in the
//     tensor cores from zero, then added to the running sums in rounded fp32
//     on the CUDA cores (the tensor cores' adder truncates, which over all
//     of K = 2048 costs a digit). The Gauss form folds its three chain sums,
//     Cr += t1 − t2 and Ci += t3 − t1 − t2, at the end of each slab;
//   - −Bi is the converted Bi with both sign bits flipped; the Gauss form
//     needs no negation;
//   - a tile grid smaller than the card is split along K across blockIdx.z
//     and summed in ascending order by splitk_sum_kernel: the same bits
//     every run.

#include "cmatmul_tc.cuh"

namespace {

// The TF32 kernels' tile with the pitches of the k16 fragments.
struct TileBf16 : Tile<2, 2, 4> {
  static constexpr int AP = BK + 8;                  // 40: banks 8g + 2t for an 8-byte pair
  static constexpr int BP = BN + 4;                  // 68: rows 2t, 2t+1 in banks 8t+g, 8t+g+4
  static constexpr int A_PLANE = BM * AP;
  static constexpr int B_PLANE = BK * BP;
  static constexpr int STAGE_FLOATS = 2 * A_PLANE + 2 * B_PLANE;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);  // 75,776
};

using T = TileBf16;
constexpr int MF = T::MF, NF = T::NF;
constexpr int BM = T::BM, BN = T::BN, BK = T::BK, AP = T::AP, BP = T::BP;
static_assert(BK % 16 == 0, "a slab is whole k16 steps");
static_assert(AP % 4 == 0 && BP % 4 == 0, "cp.async 16-byte rows");

// Two fp32 values as one register of two bf16, `lo` in the low half (the
// lower k or column index), each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a (16x16, row) · b (16x8, col), bf16 in, fp32 sums. With g = lane >> 2,
// t = lane & 3, each register two bf16 along k, the lower k in the low half:
// a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1], a2 = A[g][2t+8..2t+9],
// a3 = A[g+8][2t+8..2t+9]; b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
// d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t], d3 = D[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a · b.
__device__ __forceinline__ void mma_bf16_from_zero(float (&d)[4], const uint32_t (&a)[4],
                                                   const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16_chain(bool from_zero, float (&d)[4],
                                               const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  if (from_zero)
    mma_bf16_from_zero(d, a, b);
  else
    mma_bf16(d, a, b);
}

// One block computes a BM x BN tile of C over the K slabs
// [blockIdx.z * slabs_per_split, ...). With gridDim.z > 1 the tile is a
// partial sum and goes to split blockIdx.z of the scratch planes
// (cr + z * split_stride, same for ci).
template <bool GAUSS, bool AVEC, bool BVEC>
__global__ void __launch_bounds__(T::THREADS, T::BLOCKS_PER_SM)
cmatmul_bf16_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                    int64_t lda,
                    const float* __restrict__ br, const float* __restrict__ bi,
                    int64_t ldb,
                    float* __restrict__ cr, float* __restrict__ ci, int64_t ldc,
                    int64_t split_stride, int slabs_per_split,
                    int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NP = GAUSS ? 3 : 2;                 // chain sums: t1, t2, t3 or Cr, Ci

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp % T::WARPS_M) * (MF * 16);
  const int wn = (warp / T::WARPS_M) * (NF * 8);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  const int n_slabs_all = (K + BK - 1) / BK;
  const int slab_lo = blockIdx.z * slabs_per_split;
  const int n_slabs = max(min(n_slabs_all - slab_lo, slabs_per_split), 0);

  float acc_r[MF][NF][4], acc_i[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc_r[i][j][v] = 0.f;
        acc_i[i][j][v] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs)
      issue_slab<T, AVEC, BVEC>(smem + s * T::STAGE_FLOATS, ar, ai, lda, br, bi, ldb,
                                row0, col0, (slab_lo + s) * BK, M, N, K, tid);
    cp_async_commit();
  }

  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();      // slab s has landed (this thread's part)
    __syncthreads();                  // ... everyone's; and slab s-1 is consumed
    if (s + STAGES - 1 < n_slabs)
      issue_slab<T, AVEC, BVEC>(smem + ((s + STAGES - 1) % STAGES) * T::STAGE_FLOATS,
                                ar, ai, lda, br, bi, ldb, row0, col0,
                                (slab_lo + s + STAGES - 1) * BK, M, N, K, tid);
    cp_async_commit();

    const float* stage = smem + (s % STAGES) * T::STAGE_FLOATS;
    const float* s_ar = stage;
    const float* s_ai = stage + T::A_PLANE;
    const float* s_br = stage + 2 * T::A_PLANE;
    const float* s_bi = stage + 2 * T::A_PLANE + T::B_PLANE;

    // the slab's chain sums, from zero at its first k16 step
    float chain[NP][MF][NF][4];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const bool first = kk == 0;
      // the warp's A fragments of this k16 step: Ar, Ai (and Ar+Ai)
      uint32_t a[NP][MF][4];                        // [plane][fragment][register]
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int off = (wm + 16 * i + g + 8 * (v & 1)) * AP + kk + 2 * t + 8 * (v >> 1);
          const float2 xr = *reinterpret_cast<const float2*>(s_ar + off);
          const float2 xi = *reinterpret_cast<const float2*>(s_ai + off);
          a[0][i][v] = pack_bf16(xr.x, xr.y);
          a[1][i][v] = pack_bf16(xi.x, xi.y);
          if constexpr (GAUSS)
            a[NP - 1][i][v] = pack_bf16(__fadd_rn(xr.x, xi.x), __fadd_rn(xr.y, xi.y));
        }

#pragma unroll
      for (int j = 0; j < NF; ++j) {
        // B fragments: 4-dot Br, Bi, −Bi; Gauss Br, Bi, Br+Bi
        uint32_t b[3][2];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int off = (kk + 2 * t + 8 * v) * BP + wn + 8 * j + g;
          const float r0 = s_br[off], r1 = s_br[off + BP];
          const float i0 = s_bi[off], i1 = s_bi[off + BP];
          b[0][v] = pack_bf16(r0, r1);
          b[1][v] = pack_bf16(i0, i1);
          b[2][v] = GAUSS ? pack_bf16(__fadd_rn(r0, i0), __fadd_rn(r1, i1))
                          : b[1][v] ^ 0x80008000u;
        }
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          if constexpr (GAUSS) {
#pragma unroll
            for (int p = 0; p < 3; ++p) mma_bf16_chain(first, chain[p][i][j], a[p][i], b[p]);
          } else {
            // Cr = Ar·Br + Ai·(−Bi), Ci = Ar·Bi + Ai·Br
            mma_bf16_chain(first, chain[0][i][j], a[0][i], b[0]);
            mma_bf16_chain(first, chain[1][i][j], a[0][i], b[1]);
            mma_bf16(chain[0][i][j], a[1][i], b[2]);
            mma_bf16(chain[1][i][j], a[1][i], b[0]);
          }
        }
      }
    }

    // the slab's chains join the running sums in rounded fp32
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if constexpr (GAUSS) {
            const float t1 = chain[0][i][j][v], t2 = chain[1][i][j][v];
            acc_r[i][j][v] += t1 - t2;
            acc_i[i][j][v] += chain[2][i][j][v] - t1 - t2;
          } else {
            acc_r[i][j][v] += chain[0][i][j][v];
            acc_i[i][j][v] += chain[1][i][j][v];
          }
        }
  }

  float* out_r = cr + (int64_t)blockIdx.z * split_stride;
  float* out_i = ci + (int64_t)blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = row0 + wm + 16 * i + g + 8 * (v >> 1);
        const int n = col0 + wn + 8 * j + 2 * t + (v & 1);
        if (r < M && n < N) {
          const int64_t off = (int64_t)r * ldc + n;
          out_r[off] = acc_r[i][j][v];
          out_i[off] = acc_i[i][j][v];
        }
      }
}

template <bool GAUSS>
const TileKernel KERNELS[4] = {
    cmatmul_bf16_kernel<GAUSS, false, false>, cmatmul_bf16_kernel<GAUSS, false, true>,
    cmatmul_bf16_kernel<GAUSS, true, false>, cmatmul_bf16_kernel<GAUSS, true, true>};

}  // namespace

// How many ways cmatmul_bf16[_gauss] wants K split for this problem on a
// card of `sms` multiprocessors (splits_for). For splits > 1 the caller
// provides a scratch buffer of 2 * splits * M * N floats.
extern "C" int cmatmul_bf16_splits(int M, int N, int K, int sms) {
  return splits_for<T>(M, N, K, sms);
}

extern "C" int cmatmul_bf16_gauss_splits(int M, int N, int K, int sms) {
  return splits_for<T>(M, N, K, sms);
}

extern "C" int cmatmul_bf16(const float* ar, const float* ai, int lda,
                            const float* br, const float* bi, int ldb,
                            float* cr, float* ci, int ldc,
                            int M, int N, int K,
                            float* scratch, int splits, void* stream) {
  return run_gemm<T>(KERNELS<false>, ar, ai, lda, br, bi, ldb, cr, ci, ldc, M, N, K,
                     scratch, splits, stream);
}

extern "C" int cmatmul_bf16_gauss(const float* ar, const float* ai, int lda,
                                  const float* br, const float* bi, int ldb,
                                  float* cr, float* ci, int ldc,
                                  int M, int N, int K,
                                  float* scratch, int splits, void* stream) {
  return run_gemm<T>(KERNELS<true>, ar, ai, lda, br, bi, ldb, cr, ci, ldc, M, N, K,
                     scratch, splits, stream);
}
