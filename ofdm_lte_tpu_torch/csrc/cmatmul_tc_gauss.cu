// Planar complex GEMM for Hopper (sm_90a) on the tensor cores in the
// 3-product Gauss form, as accurate as fp32 (3xTF32, `cmatmul_tf32x3_gauss`).
//
//   C = A @ B with A (M, K), B (K, N), C (M, N), each a pair of float32
//   planes (re, im), row-major, unit inner stride, row strides lda/ldb/ldc.
//
//   t1 = Ar·Br   t2 = Ai·Bi   t3 = (Ar+Ai)·(Br+Bi)
//   Cr = t1 − t2               Ci = t3 − t1 − t2
//
// Replaces the TPU kernel ofdm_lte_tpu/ops/pallas_kernels.py:_cmatmul_kernel
// (driven by cmatmul_pallas_2d) in its Gauss form (`gauss=True`) at its
// `highest` precision, on mma.sync with cmatmul_tc.cuh (staging, TF32 split,
// MMA wrappers, split-K). It was built beside an mma.sync kernel of the 4-dot
// form ("the 4-dot kernel" below), which cmatmul_wgmma_tf32x3.cu (wgmma and
// TMA) has since replaced; the `high` (TF32) Gauss kernel is in
// cmatmul_wgmma_tf32.cu, the `default` (bf16) one in cmatmul_bf16.cu.
//
// What bounds it here: operations, on the tensor cores: three real products
// of three TF32 MMAs each (hi·lo, lo·hi, hi·hi), so 3 x 6·M·K·N over the
// card's TF32 rate of 495 TFLOP/s; device memory is 10-30x from the limit at
// the modem's shapes. Per 16x8x8 complex fragment step that is 9 MMAs where
// the 4-dot form runs 12. Measured on an H100 (700 W) it reaches 0.31 of
// that bound at the two large shapes and is 2-5% faster than the 4-dot
// kernel, not 25%: the Gauss form splits three planes of A and B (Ar, Ai,
// Ar+Ai) where 4-dot splits two, so a warp k step runs 72 MMAs beside
// some 280 other instructions (4-dot: 96 beside 180), and with 8 warps an
// SM the two kinds overlap little; the copies into shared memory cost
// another 18-20% of its time. chip_smoke.py measures these; PERF.md
// records them.
//
// What the design does:
//   - no fifth plane. Staging Br+Bi from a plane the caller precomputes
//     made an fp32 CUDA-core Gauss kernel shared-memory bound. Here the
//     block stages the four planes [Ar | Ai | Br | Bi] exactly as the 4-dot
//     kernel does (same 64x64 tile, same 73,728 bytes for 2 stages, 2
//     blocks an SM), and each thread forms Ar+Ai and Br+Bi from the
//     fragments it has loaded: one rounded fp32 add a value, the same bits
//     as b.re + b.im;
//   - registers are the scarce resource: 247-254 a thread, 0 bytes of spill.
//     The warp tile is 32x32 complex as in the 4-dot kernel. Three running
//     sums (t1, t2, t3: 96 a thread) beside three chain sums (96) and the
//     split A fragments of three planes (48) cannot fit in 255, so the
//     running sums are Cr and Ci (64): the nine MMAs a fragment and k step
//     run as chains from zero over one K slab (4 k steps, 36 MMAs a
//     fragment, the small terms of each k step first), and at the end of a
//     slab the three chain sums are folded, Cr += t1 − t2 and
//     Ci += t3 − t1 − t2, in rounded fp32 on the CUDA cores. The tensor
//     cores' own adder truncates, which over all of K costs a digit, and
//     the fold cancels, so the chains stay one slab long. The fold is
//     linear, so a K split stores two partial planes like the 4-dot kernel.
//     Layouts timed against this one on an H100 that lost: chains of one or
//     two k steps (more adds), chains for one or two of the warp's four
//     columns at a time (fewer chain registers, but with chains longer than
//     a k step the A fragments are loaded and split again), three running
//     sums folded once at the end (spills), a 16-row warp tile with 16 warps
//     an SM; and, in the TF32 split, cvt.rna.tf32.f32 or a head left for the
//     tensor core to cut, 3 or 4 stages of the ring (PERF.md);
//   - everything else is the 4-dot kernel's: pitches 36 and 72 (no bank
//     conflicts), a 2-stage cp.async ring, copies 4 or 16 bytes wide by each
//     operand's alignment with zero fill on every edge (K included), A read
//     in place through lda, a tile grid smaller than the card split along K
//     across blockIdx.z and summed in ascending order by splitk_sum_kernel.

#include "cmatmul_tc.cuh"

namespace {

using T = Tile;
constexpr int MF = T::MF, NF = T::NF;
constexpr int BM = T::BM, BN = T::BN, BK = T::BK, AP = T::AP, BP = T::BP;

template <bool AVEC, bool BVEC>
__global__ void __launch_bounds__(T::THREADS, T::BLOCKS_PER_SM)
cmatmul_tc_gauss_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                        int64_t lda,
                        const float* __restrict__ br, const float* __restrict__ bi,
                        int64_t ldb,
                        float* __restrict__ cr, float* __restrict__ ci, int64_t ldc,
                        int64_t split_stride, int slabs_per_split,
                        int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];

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

  // running sums: Cr, Ci
  float acc[2][MF][NF][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[p][i][j][v] = 0.f;

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

    // One chain: the products of the slab's BK / 8 k steps for the warp's NF
    // columns, summed inside the tensor cores from zero, the small terms of
    // each k step first; then added to the running sums in rounded fp32.
    float chain[3][MF][NF][4];                      // [t1, t2, t3]
#pragma unroll
    for (int q = 0; q < BK / 8; ++q) {
      const int kk = q * 8;
      // the warp's A fragments of one k step, split: planes Ar, Ai, Ar+Ai
      uint32_t a_hi[3][MF][4], a_lo[3][MF][4];      // [plane][fragment][register]
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int base = (wm + 16 * i + g) * AP + kk + t;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int off = base + (v & 1) * 8 * AP + (v >> 1) * 4;
          const float xr = s_ar[off], xi = s_ai[off];
          split_tf32(xr, a_hi[0][i][v], a_lo[0][i][v]);
          split_tf32(xi, a_hi[1][i][v], a_lo[1][i][v]);
          split_tf32(__fadd_rn(xr, xi), a_hi[2][i][v], a_lo[2][i][v]);
        }
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        uint32_t b_hi[3][2], b_lo[3][2];            // [Br, Bi, Br+Bi][register]
        const int base = (kk + t) * BP + wn + 8 * j + g;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float xr = s_br[base + 4 * BP * v], xi = s_bi[base + 4 * BP * v];
          split_tf32(xr, b_hi[0][v], b_lo[0][v]);
          split_tf32(xi, b_hi[1][v], b_lo[1][v]);
          split_tf32(__fadd_rn(xr, xi), b_hi[2][v], b_lo[2][v]);
        }
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int i = 0; i < MF; ++i) {
            if (q == 0)
              mma_tf32_from_zero(chain[p][i][j], a_hi[p][i], b_lo[p]);
            else
              mma_tf32(chain[p][i][j], a_hi[p][i], b_lo[p]);
          }
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int i = 0; i < MF; ++i) mma_tf32(chain[p][i][j], a_lo[p][i], b_hi[p]);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int i = 0; i < MF; ++i) mma_tf32(chain[p][i][j], a_hi[p][i], b_hi[p]);
      }
    }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float t1 = chain[0][i][j][v], t2 = chain[1][i][j][v];
          const float t3 = chain[2][i][j][v];
          acc[0][i][j][v] += t1 - t2;
          acc[1][i][j][v] += t3 - t1 - t2;
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
          out_r[off] = acc[0][i][j][v];
          out_i[off] = acc[1][i][j][v];
        }
      }
}

const TileKernel KERNELS[4] = {
    cmatmul_tc_gauss_kernel<false, false>, cmatmul_tc_gauss_kernel<false, true>,
    cmatmul_tc_gauss_kernel<true, false>, cmatmul_tc_gauss_kernel<true, true>};

}  // namespace

// How many ways cmatmul_tf32x3_gauss wants K split for this problem on a
// card of `sms` multiprocessors (splits_for). For splits > 1 the caller
// provides a scratch buffer of 2 * splits * M * N floats.
extern "C" int cmatmul_tf32x3_gauss_splits(int M, int N, int K, int sms) {
  return splits_for<T>(M, N, K, sms);
}

extern "C" int cmatmul_tf32x3_gauss(const float* ar, const float* ai, int lda,
                                    const float* br, const float* bi, int ldb,
                                    float* cr, float* ci, int ldc,
                                    int M, int N, int K,
                                    float* scratch, int splits, void* stream) {
  return run_gemm<T>(KERNELS, ar, ai, lda, br, bi, ldb, cr, ci, ldc, M, N, K,
                     scratch, splits, stream);
}
