// What the wgmma complex GEMMs share: cmatmul_wgmma_tf32x3.cu (`highest`,
// 3xTF32, 4-dot form), cmatmul_wgmma_tf32.cu (`high`, TF32) and
// cmatmul_bf16.cu (`default`, bf16) include this header, each into its own
// translation unit (everything here is in an unnamed namespace), and supply a
// precision policy P: the slab depth BK (one 128-byte row of A: 32 fp32 or 64
// bf16), the element types and planes of A and B in the ring, its stages, the
// chain length CHAIN, how a warpgroup runs the wgmmas of one slab (P::slab:
// A from registers, split or rounded as loaded, at `highest` and `high`; A
// from shared memory, prepared per call, at `default`), how A's planes are
// loaded (P::load_a), and the kernels that prepare B (and A) per call.
//
//   - the Hopper machinery: mbarriers, TMA loads, named barriers, the wgmma
//     fence, commit and wait, setmaxnreg; the TMA descriptors, encoded on the
//     host by cuTensorMapEncodeTiled from the driver's entry point that the
//     runtime hands out (no -lcuda);
//   - the persistent main loop (cmatmul_body): one block an SM walks the
//     (row tile, column tile, K split) units; a producer warpgroup, one
//     thread of which keeps TMA loads of [A planes | B planes] in flight into
//     a ring of stages tracked by full and empty mbarriers; two consumer
//     warpgroups, each 64 rows of the 128x64 complex tile, run a chain of
//     wgmmas over CHAIN slabs from zero, which then joins an fp32 running sum
//     on the CUDA cores (the tensor cores' adder truncates); the Gauss form
//     folds its three chains into Cr += t1 − t2, Ci += t3 − t1 − t2;
//   - the TF32 head of an fp32 value (tf32_rna), which the TF32 policies use;
//   - A copied (copy_a_kernel) where TMA cannot read it in place at
//     `highest` and `high`, and the host side of a call (run): B's prep, A's
//     prep or copy, the descriptors, the launch, the split-K sum in ascending
//     order (the same bits every run).
//
// Design notes and measurements are in the three sources.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "cmatmul_tc.cuh"    // splitk_sum_kernel, splits_for

namespace {
namespace wgc {

constexpr int BM = 128;      // rows of C a tile: two consumer warpgroups of 64
constexpr int BN = 64;       // columns of C a tile
constexpr int CONSUMER_THREADS = 256;                 // warpgroups 0 and 1 multiply
constexpr int THREADS = CONSUMER_THREADS + 128;       // warpgroup 2 loads
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // setmaxnreg: 64,512 of 65,536

template <class P, bool GAUSS>
struct Layout {
  static constexpr int A_PLANES = P::template a_planes<GAUSS>();  // (Ar, Ai, Ar+Ai)
  static constexpr int B_PLANES = P::template b_planes<GAUSS>();  // P's layout of B
  static constexpr int A_BYTES = BM * P::BK * P::A_ELEM;  // a plane of A's slab
  static constexpr int B_BYTES = BN * P::BK * P::B_ELEM;  // a plane of B's slab
  static constexpr int STAGES = P::template stages<GAUSS>();
  static constexpr int STAGE_BYTES = A_PLANES * A_BYTES + B_PLANES * B_BYTES;
  static constexpr int BARRIER_OFFSET = STAGES * STAGE_BYTES;
  // the ring, its 2·STAGES barriers, and slack to align the ring to 1024
  static constexpr int SMEM_BYTES = BARRIER_OFFSET + 2 * STAGES * 8 + 1024;
  static_assert(SMEM_BYTES <= 232448, "the ring exceeds 227 KB");
  static_assert(P::BK * P::A_ELEM == 128, "a slab row of A is one 128-byte swizzle row");
  static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0, "swizzle atoms stay aligned");
};

// the tile that splits_for reads
template <class P>
struct SplitTile {
  static constexpr int BM = wgc::BM, BN = wgc::BN, BK = P::BK;
};

template <class P>
inline int padded_k(int K) { return (K + P::BK - 1) / P::BK * P::BK; }

// TMA reads a plane through a 16-byte-aligned base and a row pitch that is a
// multiple of 16 bytes; else A is copied first.
inline bool a_needs_copy(const float* ar, const float* ai, int lda) {
  return (reinterpret_cast<uintptr_t>(ar) & 15) || (reinterpret_cast<uintptr_t>(ai) & 15)
         || lda % 4 != 0;
}

// The floats of workspace a call needs: B prepared, (N, Kp) a plane of
// P::B_ELEM bytes a value; A prepared, (M, Kp) a plane of P::A_ELEM bytes,
// where P prepares it, else A copied, (M, Kp) fp32 a plane, where TMA cannot
// read it; the partial planes of a K split.
template <class P, bool GAUSS>
int64_t workspace_floats(const float* ar, const float* ai, int lda, int M, int N, int K,
                         int splits) {
  using L = Layout<P, GAUSS>;
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const int64_t kp = padded_k<P>(K);
  int64_t floats = L::B_PLANES * (int64_t)N * kp * P::B_ELEM / 4;
  if (P::PREPARES_A) floats += L::A_PLANES * (int64_t)M * kp * P::A_ELEM / 4;
  else if (a_needs_copy(ar, ai, lda)) floats += 2 * (int64_t)M * kp;
  if (splits > 1) floats += 2 * (int64_t)splits * M * N;
  return floats;
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero: the head of ops/cmatmul.py:tf32_split, by integer arithmetic on the
// bit pattern (cvt.rna.tf32.f32 gives the same at a quarter of the rate).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that never ends
// (a fault in the ring's bookkeeping) traps after some 2^24 polls, a second
// or more, rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && ++polls == (1u << 24)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3}], [%4];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4}], [%5];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
                  "r"(bar)
               : "memory");
}

// The wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); the leading offset is unused.
// A k step of 32 bytes (8 TF32 or 16 bf16) adds 32 to the address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Named barrier 1 (barrier 0 is __syncthreads'), between the two consumer
// warpgroups: one syncs, the other arrives.
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMER_THREADS) : "memory");
}

__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive 1, %0;\n" :: "n"(CONSUMER_THREADS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator across the wait.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A (M, K) at lda -> at[p] (M, Kp), raw, zero past K: for an A that TMA
// cannot read in place (the TF32 kernels, which split or round A in
// registers).
__global__ void __launch_bounds__(256)
copy_a_kernel(const float* __restrict__ ar, const float* __restrict__ ai, int64_t lda,
              float* __restrict__ at, int M, int K, int kp) {
  const int64_t plane = (int64_t)M * kp;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < plane;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t m = idx / kp;
    const int k = (int)(idx - m * kp);
    const bool ok = k < K;
    at[idx] = ok ? ar[m * lda + k] : 0.f;
    at[plane + idx] = ok ? ai[m * lda + k] : 0.f;
  }
}

// The main loop of every precision's kernels; each source's __global__
// kernel is this body for its policy. One block an SM walks the units u =
// blockIdx.x, blockIdx.x + gridDim.x, ...: u = (split · m_tiles + row tile) ·
// n_tiles + column tile. A split's unit covers the slabs [split ·
// slabs_per_split, ...) and writes its partial planes to cr + split ·
// split_stride (ldc N); else C itself.
template <class P, bool GAUSS>
__device__ __forceinline__ void cmatmul_body(const CUtensorMap* ta_r, const CUtensorMap* ta_i,
                                             const CUtensorMap* tb, float* __restrict__ cr,
                                             float* __restrict__ ci, int64_t ldc,
                                             int64_t split_stride, int slabs_per_split,
                                             int n_slabs_all, int M, int N, int m_tiles,
                                             int n_tiles, int units, int vec2) {
  using L = Layout<P, GAUSS>;
  constexpr int STAGES = L::STAGES, BK = P::BK, CHAIN = P::CHAIN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + L::BARRIER_OFFSET;     // full[s] at full + 8s
  const uint32_t empty = full + 8 * STAGES;           // empty[s] at empty + 8s

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                     // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMER_THREADS / 32);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto decode = [&](int u, int& row0, int& col0, int& slab0, int& n_slabs) {
    const int nt = u % n_tiles;
    const int rest = u / n_tiles;
    const int mt = rest % m_tiles;
    const int split = rest / m_tiles;
    row0 = mt * BM;
    col0 = nt * BN;
    slab0 = split * slabs_per_split;
    n_slabs = min(slabs_per_split, n_slabs_all - slab0);
    return split;
  };

  if (tid >= CONSUMER_THREADS) {
    // the producer warpgroup gives its registers to the consumers; one of its
    // threads keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (tid != CONSUMER_THREADS) return;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int row0, col0, slab0, n_slabs;
      decode(u, row0, col0, slab0, n_slabs);
      for (int s = 0; s < n_slabs; ++s, ++it) {
        const int stage = it % STAGES;
        const int round = it / STAGES;
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const uint32_t bar = full + 8 * stage;
        const uint32_t dst = ring + stage * L::STAGE_BYTES;
        const int k0 = (slab0 + s) * BK;
        mbar_expect_tx(bar, L::STAGE_BYTES);
        P::load_a(dst, ta_r, ta_i, bar, k0, row0);
        tma_load_3d(dst + L::A_PLANES * L::A_BYTES, tb, bar, k0, col0, 0);
      }
    }
    return;
  }

  // the consumers: warpgroup q multiplies rows 64q..64q+63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int q = tid >> 7;
  const int w = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int NCH = GAUSS ? 3 : 2;
  float acc_r[32], acc_i[32], ch[NCH][32];
#pragma unroll
  for (int p = 0; p < NCH; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) ch[p][i] = 0.f;

  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int row0, col0, slab0, n_slabs;
    const int split = decode(u, row0, col0, slab0, n_slabs);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_r[i] = acc_i[i] = 0.f;

    for (int s = 0; s < n_slabs; ++s, ++it) {
      const int stage = it % STAGES;
      mbar_wait(full + 8 * stage, (it / STAGES) & 1);
      if (q == 1 && it == 0) named_sync();     // after warpgroup 0's first batch
      // this warpgroup's rows of the stage's first A plane (the others follow
      // A_BYTES apart), as a pointer and as a shared address, and the B planes
      const int a_off = stage * L::STAGE_BYTES + q * 64 * 128;
      const uint32_t b0 = ring + stage * L::STAGE_BYTES + L::A_PLANES * L::A_BYTES;
      // a chain of wgmmas runs over CHAIN slabs from zero, then joins the
      // running sums (the last chain of a unit may be shorter)
      const bool chain_starts = s % CHAIN == 0;
      const bool chain_ends = s % CHAIN == CHAIN - 1 || s == n_slabs - 1;
      P::template slab<GAUSS>(ch, smem + a_off, ring + a_off, b0, chain_starts, w, g, t);
      wgmma_commit();
      if (q == 0 && it == 0) named_arrive();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < NCH; ++p) fence_operands(ch[p]);
      if (lane == 0) mbar_arrive(empty + 8 * stage);   // the slab is read
      if (chain_ends) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if constexpr (GAUSS) {
            const float t1 = ch[0][i], t2 = ch[1][i], t3 = ch[2][i];
            acc_r[i] += t1 - t2;
            acc_i[i] += t3 - t1 - t2;
          } else {
            acc_r[i] += ch[0][i];
            acc_i[i] += ch[1][i];
          }
        }
      }
    }

    // register i holds row 16w + g + 8·((i >> 1) & 1), column 8·(i >> 2) +
    // 2t + (i & 1) of the warpgroup's 64x64 block
    float* out_r = cr + (int64_t)split * split_stride;
    float* out_i = ci + (int64_t)split * split_stride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 64 * q + 16 * w + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = col0 + 8 * j + 2 * t;
        const int i = 4 * j + 2 * h;
        const int64_t off = (int64_t)r * ldc + n;
        if (vec2 && n + 1 < N) {
          *reinterpret_cast<float2*>(out_r + off) = make_float2(acc_r[i], acc_r[i + 1]);
          *reinterpret_cast<float2*>(out_i + off) = make_float2(acc_i[i], acc_i[i + 1]);
        } else {
          if (n < N) {
            out_r[off] = acc_r[i];
            out_i[off] = acc_i[i];
          }
          if (n + 1 < N) {
            out_r[off + 1] = acc_r[i + 1];
            out_i[off + 1] = acc_i[i + 1];
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes beside CUDA's: the driver's entry point is missing, or it
// refused a descriptor (1000 + its CUresult).
constexpr int ERR_NO_ENCODER = 999;

// A tiled descriptor with zero fill out of bounds.
inline int encode(CUtensorMap* map, CUtensorMapDataType type, CUtensorMapSwizzle swizzle,
                  const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* pitches,
                  const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, pitches, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

inline bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

// The host side of one product through `kernel` (the source's __global__
// kernel for P and GAUSS). `ws` holds workspace_floats<P, GAUSS>(...) floats:
// B prepared, then A prepared or copied, then the partial planes.
template <class P, bool GAUSS, class Kernel>
int run(Kernel kernel, const float* ar, const float* ai, int lda, const float* br,
        const float* bi, int ldb, float* cr, float* ci, int ldc, int M, int N, int K, float* ws,
        int splits, void* stream) {
  using L = Layout<P, GAUSS>;
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (K <= 0) {
    err = cudaMemset2DAsync(cr, (size_t)ldc * 4, 0, (size_t)N * 4, M, st);
    if (err == cudaSuccess) err = cudaMemset2DAsync(ci, (size_t)ldc * 4, 0, (size_t)N * 4, M, st);
    return (int)err;
  }
  if (splits < 1 || ws == nullptr) return (int)cudaErrorInvalidValue;
  const int kp = padded_k<P>(K);
  const int n_slabs_all = kp / P::BK;
  const int per = (n_slabs_all + splits - 1) / splits;
  const bool a_copy = !P::PREPARES_A && a_needs_copy(ar, ai, lda);
  float* bt = ws;
  float* at = bt + L::B_PLANES * (int64_t)N * kp * P::B_ELEM / 4;
  float* part = at + (P::PREPARES_A ? L::A_PLANES * (int64_t)M * kp * P::A_ELEM / 4
                                    : a_copy ? 2 * (int64_t)M * kp : 0);

  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  P::template prep_b<GAUSS>(br, bi, ldb, bt, N, K, kp, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (P::PREPARES_A) {
    P::template prep_a<GAUSS>(ar, ai, lda, at, M, K, kp, sms, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  } else if (a_copy) {
    const int64_t blocks = ((int64_t)M * kp + 255) / 256;
    copy_a_kernel<<<(int)(blocks < 8LL * sms ? blocks : 8LL * sms), 256, 0, st>>>(
        ar, ai, lda, at, M, K, kp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  // A: the prepared planes as one 3-D tensor (planes, M, Kp), or the fp32
  // planes read in place or copied, one 2-D tensor each
  CUtensorMap ta_r, ta_i, tb;
  int rc;
  if constexpr (P::PREPARES_A) {
    const cuuint64_t a_dims[3] = {(cuuint64_t)kp, (cuuint64_t)M, (cuuint64_t)L::A_PLANES};
    const cuuint64_t a_pitch[2] = {(cuuint64_t)kp * P::A_ELEM, (cuuint64_t)kp * M * P::A_ELEM};
    const cuuint32_t a_box[3] = {(cuuint32_t)P::BK, BM, L::A_PLANES};
    rc = encode(&ta_r, P::A_TYPE, CU_TENSOR_MAP_SWIZZLE_128B, at, 3, a_dims, a_pitch, a_box);
    ta_i = ta_r;
  } else {
    const float* a_re = a_copy ? at : ar;
    const float* a_im = a_copy ? at + (int64_t)M * kp : ai;
    const cuuint64_t a_dims[2] = {(cuuint64_t)(a_copy ? kp : K), (cuuint64_t)M};
    const cuuint64_t a_pitch[1] = {(cuuint64_t)(a_copy ? kp : lda) * 4};
    const cuuint32_t a_box[2] = {(cuuint32_t)P::BK, BM};
    rc = encode(&ta_r, P::A_TYPE, CU_TENSOR_MAP_SWIZZLE_128B, a_re, 2, a_dims, a_pitch, a_box);
    if (rc == 0)
      rc = encode(&ta_i, P::A_TYPE, CU_TENSOR_MAP_SWIZZLE_128B, a_im, 2, a_dims, a_pitch, a_box);
  }
  const cuuint64_t b_dims[3] = {(cuuint64_t)kp, (cuuint64_t)N, (cuuint64_t)L::B_PLANES};
  const cuuint64_t b_pitch[2] = {(cuuint64_t)kp * P::B_ELEM, (cuuint64_t)kp * N * P::B_ELEM};
  const cuuint32_t b_box[3] = {(cuuint32_t)P::BK, BN, L::B_PLANES};
  if (rc == 0) rc = encode(&tb, P::B_TYPE, CU_TENSOR_MAP_SWIZZLE_128B, bt, 3, b_dims, b_pitch,
                           b_box);
  if (rc != 0) return rc;

  const int64_t plane = (int64_t)M * N;
  float* out_r = splits > 1 ? part : cr;
  float* out_i = splits > 1 ? part + splits * plane : ci;
  const int64_t out_ld = splits > 1 ? N : ldc;
  const int vec2 = out_ld % 2 == 0 && aligned8(out_r) && aligned8(out_i)
                   && (splits == 1 || plane % 2 == 0);
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int64_t units = (int64_t)m_tiles * n_tiles * splits;
  if (units >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  static bool raised[64];        // the shared-memory limit, raised once a device
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev] = true;
  }
  kernel<<<(int)(units < sms ? units : sms), THREADS, L::SMEM_BYTES, st>>>(
      ta_r, ta_i, tb, out_r, out_i, out_ld, plane, per, n_slabs_all, M, N, m_tiles, n_tiles,
      (int)units, vec2);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return (int)err;

  const int threads = 256;
  const int blocks = (int)((plane + threads - 1) / threads);
  splitk_sum_kernel<<<blocks, threads, 0, st>>>(out_r, out_i, plane, splits, cr, ci, ldc, M, N);
  return (int)cudaGetLastError();
}

}  // namespace wgc
}  // namespace
