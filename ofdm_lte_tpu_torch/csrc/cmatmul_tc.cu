// Planar complex GEMM for Hopper (sm_90a) on the tensor cores, as accurate
// as fp32: three TF32 products per real product (3xTF32, `cmatmul_tf32x3`).
//
//   C = A @ B with A (M, K), B (K, N), C (M, N), each a pair of float32
//   planes (re, im), row-major, unit inner stride, row strides lda/ldb/ldc.
//
//   Cr = Ar·Br − Ai·Bi        Ci = Ar·Bi + Ai·Br          (4-dot form)
//
// Replaces the TPU kernel ofdm_lte_tpu/ops/pallas_kernels.py:_cmatmul_kernel
// (driven by cmatmul_pallas_2d), in its 4-dot form at its `highest`
// precision. The Gauss form of the same TPU kernel is cmatmul_tc_gauss.cu,
// which shares cmatmul_tc.cuh with this file; its `high` precision (one TF32
// product of operands rounded to TF32, both forms) is cmatmul_wgmma_tf32.cu
// and its `default` precision (bf16) cmatmul_bf16.cu; the fp32 CUDA-core
// kernel of cmatmul.cu stays beside them as their yardstick.
//
// What bounds it here: operations, on the tensor cores. At the modem's
// shapes the operands are reused hundreds of times, so device memory is
// 10-30x from the limit; an fp32-accurate product costs three TF32 MMAs
// (hi·lo, lo·hi, hi·hi; lo·lo lies below fp32's last bit), so the bound is
// 3x the FLOPs over the card's TF32 rate of 495 TFLOP/s. Measured on an
// H100 (700 W): the kernel reaches 0.40 of that bound at the two large
// shapes. `mma.sync` itself tops out at 0.66 of it (328 TFLOP/s in a loop
// of MMAs alone); of the rest, the copies from L2 into shared memory cost
// about a sixth of the kernel's time and the last, partly filled wave of
// tiles 7-15%. chip_smoke.py and tools/tune_cmatmul_tc.py measure these;
// PERF.md records them.
//
// What the design does:
//   - warp-level mma.sync.m16n8k8 TF32 with fp32 accumulation. Each fp32
//     operand is split in registers into a TF32 head and tail (split_tf32);
//     per 16x8x8 complex fragment step the warp issues 12 MMAs into two
//     fragments, the small terms first. −Bi is the split Bi with its sign
//     bits flipped. Every loaded fragment feeds two real products, so the
//     kernel is MMA-bound and not shared-memory-bound;
//   - the tensor cores' own accumulation is kept short (one K slab, from
//     zero) and the running sums are added on the CUDA cores in rounded
//     fp32: accumulating all of K in the MMA's accumulator lost a digit at
//     K = 2048 (truncation in the tensor cores' adder);
//   - a 64x64 complex output tile per block of 4 warps (2 along M, 2 along
//     N), a 32x32 complex warp tile (2x4 fragments, 64 running sums and 64
//     slab sums a thread, about 250 registers), two blocks on an SM so that
//     one block's barrier and fragment loads hide behind the other's MMAs,
//     and a loop over K inside the block in slabs of 32 in place of the
//     Pallas grid's sequential K axis;
//   - A is staged as [m][k] with pitch 36 and B as [k][n] with pitch 72, so
//     both fragment loads touch 32 different banks (4g+t and 8t+g);
//   - a 2-stage cp.async ring (the next slab is copied while this one is
//     multiplied; deeper rings measured slower), one __syncthreads a slab.
//     Copies are 4 bytes wide, since K = 999 and N = 999 leave rows without
//     16-byte alignment and lda may be any stride (the CP-stripped view and
//     the slot-start row gather are read in place), and 16 bytes wide per
//     operand where its pointers and pitch allow it. Every edge is masked
//     with zero fill, K included (cp.async's src-size), and no row is read
//     past its end. Staging through registers, as the CUDA-core kernel
//     does, would hold 48 more registers a thread, and none is free;
//   - a tile grid smaller than the card (the pilot GEMM: 4x4 tiles on 132
//     SMs) is split along K across blockIdx.z into partial sums in a
//     scratch buffer of the caller, which a second kernel adds in ascending
//     order: no float atomics, so the result is the same bits every run.

#include "cmatmul_tc.cuh"

namespace {

// Two more choices of the design that the compiler's command line can set
// (see cmatmul_tc.cuh for the shared ones).
#ifndef TC_WARPS_M
#define TC_WARPS_M 2      // warps along M: 2 (64x64 tile, 2 blocks an SM) or 4 (128x64, 1)
#endif
#ifndef TC_CHAIN
#define TC_CHAIN 4        // k steps summed inside the tensor cores: 1, 2, 4, or 0 for all of K
#endif

using T = Tile<TC_WARPS_M, 2, 4>;
constexpr int WARPS_M = T::WARPS_M;
constexpr int BM = T::BM, BN = T::BN, BK = T::BK;
constexpr int THREADS = T::THREADS;                // 128 (or 256)
constexpr int BLOCKS_PER_SM = T::BLOCKS_PER_SM;
constexpr int CHAIN = TC_CHAIN;
static_assert(WARPS_M == 2 || WARPS_M == 4, "TC_WARPS_M is 2 or 4");
static_assert(CHAIN == 0 || CHAIN == 1 || CHAIN == 2 || CHAIN == 4, "TC_CHAIN is 0, 1, 2 or 4");
constexpr int MF = T::MF;                          // 2 m16 fragments a warp
constexpr int NF = T::NF;                          // 4 n8 fragments a warp
constexpr int AP = T::AP, BP = T::BP;
constexpr int A_PLANE = T::A_PLANE, B_PLANE = T::B_PLANE;
constexpr int STAGE_FLOATS = T::STAGE_FLOATS;

// One block computes a BM x BN tile of C over the K slabs
// [blockIdx.z * slabs_per_split, ...). With gridDim.z > 1 the tile is a
// partial sum and goes to split blockIdx.z of the scratch planes
// (cr + z * split_stride, same for ci).
template <bool AVEC, bool BVEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
cmatmul_tc_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
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
  const int wm = (warp % WARPS_M) * (MF * 16);
  const int wn = (warp / WARPS_M) * (NF * 8);
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
      issue_slab<T, AVEC, BVEC>(smem + s * STAGE_FLOATS, ar, ai, lda, br, bi, ldb,
                                row0, col0, (slab_lo + s) * BK, M, N, K, tid);
    cp_async_commit();
  }

  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();      // slab s has landed (this thread's part)
    __syncthreads();                  // ... everyone's; and slab s-1 is consumed
    if (!TC_NO_COPIES && s + STAGES - 1 < n_slabs)
      issue_slab<T, AVEC, BVEC>(smem + ((s + STAGES - 1) % STAGES) * STAGE_FLOATS,
                                ar, ai, lda, br, bi, ldb, row0, col0,
                                (slab_lo + s + STAGES - 1) * BK, M, N, K, tid);
    cp_async_commit();

    const float* stage = smem + (s % STAGES) * STAGE_FLOATS;
    const float* s_a[2] = {stage, stage + A_PLANE};
    const float* s_b[2] = {stage + 2 * A_PLANE, stage + 2 * A_PLANE + B_PLANE};

    // The tensor cores truncate when they add into a long running sum, which
    // over K = 2048 costs a digit. So the MMAs of CHAIN k steps (one slab)
    // run as a chain that starts from zero (24 MMAs a fragment, the small
    // terms of each k step first), and the chain's result joins the running
    // sum by a rounded fp32 add on the CUDA cores. CHAIN = 0 sums all of K
    // in the tensor cores, for comparison.
    float chain_r[MF][NF][4], chain_i[MF][NF][4];
    auto& tr = *(CHAIN ? &chain_r : &acc_r);
    auto& ti = *(CHAIN ? &chain_i : &acc_i);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const bool chain_starts = CHAIN && (kk / 8) % (CHAIN ? CHAIN : 1) == 0;
      const bool chain_ends = CHAIN && (kk / 8) % (CHAIN ? CHAIN : 1) == CHAIN - 1;
      uint32_t a_hi[2][MF][4], a_lo[2][MF][4];      // [plane][fragment][register]
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          const float* base = s_a[p] + (wm + 16 * i + g) * AP + kk + t;
          split_tf32(base[0], a_hi[p][i][0], a_lo[p][i][0]);
          split_tf32(base[8 * AP], a_hi[p][i][1], a_lo[p][i][1]);
          split_tf32(base[4], a_hi[p][i][2], a_lo[p][i][2]);
          split_tf32(base[8 * AP + 4], a_hi[p][i][3], a_lo[p][i][3]);
        }

#pragma unroll
      for (int j = 0; j < NF; ++j) {
        uint32_t b_hi[3][2], b_lo[3][2];            // [plane][register]: Br, Bi, −Bi
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float* base = s_b[p] + (kk + t) * BP + wn + 8 * j + g;
          split_tf32(base[0], b_hi[p][0], b_lo[p][0]);
          split_tf32(base[4 * BP], b_hi[p][1], b_lo[p][1]);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          b_hi[2][v] = b_hi[1][v] ^ 0x80000000u;
          b_lo[2][v] = b_lo[1][v] ^ 0x80000000u;
        }
        // tr += xa[par]·xb[pbr], ti += xa[pai]·xb[pbi], for both row fragments
        auto term = [&](bool from_zero, const uint32_t (&xa)[2][MF][4], int par, int pai,
                        const uint32_t (&xb)[3][2], int pbr, int pbi) {
#pragma unroll
          for (int i = 0; i < MF; ++i) {
            if (from_zero) {
              mma_tf32_from_zero(tr[i][j], xa[par][i], xb[pbr]);
              mma_tf32_from_zero(ti[i][j], xa[pai][i], xb[pbi]);
            } else {
              mma_tf32(tr[i][j], xa[par][i], xb[pbr]);
              mma_tf32(ti[i][j], xa[pai][i], xb[pbi]);
            }
          }
        };
        // Cr = Ar·Br + Ai·(−Bi), Ci = Ar·Bi + Ai·Br: hi·lo, lo·hi, then hi·hi
        term(chain_starts, a_hi, 0, 0, b_lo, 0, 1);
        term(false, a_lo, 0, 0, b_hi, 0, 1);
        term(false, a_hi, 1, 1, b_lo, 2, 0);
        term(false, a_lo, 1, 1, b_hi, 2, 0);
        term(false, a_hi, 0, 0, b_hi, 0, 1);
        term(false, a_hi, 1, 1, b_hi, 2, 0);
        if (chain_ends) {
#pragma unroll
          for (int i = 0; i < MF; ++i)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              acc_r[i][j][v] += tr[i][j][v];
              acc_i[i][j][v] += ti[i][j][v];
            }
        }
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

const TileKernel KERNELS[4] = {cmatmul_tc_kernel<false, false>, cmatmul_tc_kernel<false, true>,
                               cmatmul_tc_kernel<true, false>, cmatmul_tc_kernel<true, true>};

}  // namespace

// How many ways cmatmul_tf32x3 wants K split for this problem on a card of
// `sms` multiprocessors (splits_for). For splits > 1 the caller provides a
// scratch buffer of 2 * splits * M * N floats.
extern "C" int cmatmul_tf32x3_splits(int M, int N, int K, int sms) {
  return splits_for<T>(M, N, K, sms);
}

extern "C" int cmatmul_tf32x3(const float* ar, const float* ai, int lda,
                              const float* br, const float* bi, int ldb,
                              float* cr, float* ci, int ldc,
                              int M, int N, int K,
                              float* scratch, int splits, void* stream) {
  return run_gemm<T>(KERNELS, ar, ai, lda, br, bi, ldb, cr, ci, ldc, M, N, K,
                     scratch, splits, stream);
}
