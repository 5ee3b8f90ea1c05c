// Planar complex GEMM for Hopper (sm_90a) on the tensor cores, as accurate
// as fp32: three TF32 products per real product (3xTF32).
//
//   C = A @ B with A (M, K), B (K, N), C (M, N), each a pair of float32
//   planes (re, im), row-major, unit inner stride, row strides lda/ldb/ldc.
//
//   Cr = Ar·Br − Ai·Bi        Ci = Ar·Bi + Ai·Br          (4-dot form)
//
// Replaces the TPU kernel ofdm_lte_tpu/ops/pallas_kernels.py:_cmatmul_kernel
// (driven by cmatmul_pallas_2d), in its 4-dot form at its `highest`
// precision. The fp32 CUDA-core kernel of cmatmul.cu stays beside it: it
// serves the Gauss form and is this kernel's yardstick.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Five choices of the design can be set from the compiler's command line,
// so that tools/tune_cmatmul_tc.py can time them against each other; the
// defaults are what the package builds.
#ifndef TC_WARPS_M
#define TC_WARPS_M 2      // warps along M: 2 (64x64 tile, 2 blocks an SM) or 4 (128x64, 1)
#endif
#ifndef TC_CHAIN
#define TC_CHAIN 4        // k steps summed inside the tensor cores: 1, 2, 4, or 0 for all of K
#endif
#ifndef TC_SPLIT_CVT
#define TC_SPLIT_CVT 0    // 1: split with cvt.rna.tf32.f32 instead of integer arithmetic
#endif
#ifndef TC_STAGES
#define TC_STAGES 2       // shared-memory stages of the cp.async ring: 2, 3 or 4
#endif
#ifndef TC_NO_COPIES
#define TC_NO_COPIES 0    // 1: copy the first slabs only (wrong results; times the multiply alone)
#endif

constexpr int WARPS_M = TC_WARPS_M;
constexpr int WARPS_N = 2;
constexpr int BM = 32 * WARPS_M;   // rows of C per block
constexpr int BN = 32 * WARPS_N;   // columns of C per block
constexpr int BK = 32;             // depth of one staged slab
constexpr int THREADS = 32 * WARPS_M * WARPS_N;    // 128 (or 256)
constexpr int BLOCKS_PER_SM = 4 / WARPS_M;
constexpr int CHAIN = TC_CHAIN;
static_assert(WARPS_M == 2 || WARPS_M == 4, "TC_WARPS_M is 2 or 4");
static_assert(CHAIN == 0 || CHAIN == 1 || CHAIN == 2 || CHAIN == 4, "TC_CHAIN is 0, 1, 2 or 4");
constexpr int MF = BM / WARPS_M / 16;              // 2 m16 fragments a warp
constexpr int NF = BN / WARPS_N / 8;               // 4 n8 fragments a warp
constexpr int AP = BK + 4;         // A pitch: banks 4g+t
constexpr int BP = BN + 8;         // B pitch: banks 8t+g
constexpr int STAGES = TC_STAGES;
constexpr int A_PLANE = BM * AP;
constexpr int B_PLANE = BK * BP;
constexpr int STAGE_FLOATS = 2 * A_PLANE + 2 * B_PLANE;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);   // 73,728 at 64x64

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
// (cvt.rna.tf32.f32 gives the same hi, but conversions issue at a quarter
// of the integer rate, and two a value made them the kernel's limit.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
#if TC_SPLIT_CVT
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
#else
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
#endif
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
template <bool AVEC, bool BVEC>
__device__ __forceinline__ void issue_slab(
    float* stage, const float* __restrict__ ar, const float* __restrict__ ai,
    int64_t lda, const float* __restrict__ br, const float* __restrict__ bi,
    int64_t ldb, int row0, int col0, int k0, int M, int N, int K, int tid) {
  float* s_ar = stage;
  float* s_ai = stage + A_PLANE;
  float* s_br = stage + 2 * A_PLANE;
  float* s_bi = stage + 2 * A_PLANE + B_PLANE;

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
      issue_slab<AVEC, BVEC>(smem + s * STAGE_FLOATS, ar, ai, lda, br, bi, ldb,
                             row0, col0, (slab_lo + s) * BK, M, N, K, tid);
    cp_async_commit();
  }

  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();      // slab s has landed (this thread's part)
    __syncthreads();                  // ... everyone's; and slab s-1 is consumed
    if (!TC_NO_COPIES && s + STAGES - 1 < n_slabs)
      issue_slab<AVEC, BVEC>(smem + ((s + STAGES - 1) % STAGES) * STAGE_FLOATS,
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool AVEC, bool BVEC>
cudaError_t launch(const float* ar, const float* ai, int lda, const float* br,
                   const float* bi, int ldb, float* cr, float* ci, int64_t ldc,
                   int64_t split_stride, int slabs_per_split, int splits,
                   int M, int N, int K, cudaStream_t st) {
  auto kernel = cmatmul_tc_kernel<AVEC, BVEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, SMEM_BYTES, st>>>(ar, ai, lda, br, bi, ldb, cr, ci, ldc,
                                           split_stride, slabs_per_split, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// How many ways cmatmul_tf32x3 wants K split for this problem on a card of
// `sms` multiprocessors: 1 when the tile grid fills the card, else as many
// as bring the grid up to it, with no split left empty. For splits > 1 the
// caller provides a scratch buffer of 2 * splits * M * N floats.
extern "C" int cmatmul_tf32x3_splits(int M, int N, int K, int sms) {
  if (M <= 0 || N <= 0 || K <= 0) return 1;
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int n_slabs = (K + BK - 1) / BK;
  const int want = sms / tiles < n_slabs ? sms / tiles : n_slabs;
  if (want <= 1) return 1;
  const int per = (n_slabs + want - 1) / want;
  return (n_slabs + per - 1) / per;
}

extern "C" int cmatmul_tf32x3(const float* ar, const float* ai, int lda,
                              const float* br, const float* bi, int ldb,
                              float* cr, float* ci, int ldc,
                              int M, int N, int K,
                              float* scratch, int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || (splits > 1 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_slabs = (K + BK - 1) / BK;
  const int per = (n_slabs + splits - 1) / splits;

  const int64_t plane = (int64_t)M * N;
  float* out_r = splits > 1 ? scratch : cr;
  float* out_i = splits > 1 ? scratch + splits * plane : ci;
  const int64_t out_ld = splits > 1 ? N : ldc;

  const bool avec = aligned16(ar) && aligned16(ai) && lda % 4 == 0;
  const bool bvec = aligned16(br) && aligned16(bi) && ldb % 4 == 0;
  cudaError_t err;
  if (avec && bvec)
    err = launch<true, true>(ar, ai, lda, br, bi, ldb, out_r, out_i, out_ld, plane, per, splits, M, N, K, st);
  else if (avec)
    err = launch<true, false>(ar, ai, lda, br, bi, ldb, out_r, out_i, out_ld, plane, per, splits, M, N, K, st);
  else if (bvec)
    err = launch<false, true>(ar, ai, lda, br, bi, ldb, out_r, out_i, out_ld, plane, per, splits, M, N, K, st);
  else
    err = launch<false, false>(ar, ai, lda, br, bi, ldb, out_r, out_i, out_ld, plane, per, splits, M, N, K, st);
  if (err != cudaSuccess || splits == 1) return (int)err;

  const int threads = 256;
  const int blocks = (int)((plane + threads - 1) / threads);
  splitk_sum_kernel<<<blocks, threads, 0, st>>>(out_r, out_i, plane, splits,
                                                cr, ci, ldc, M, N);
  return (int)cudaGetLastError();
}
