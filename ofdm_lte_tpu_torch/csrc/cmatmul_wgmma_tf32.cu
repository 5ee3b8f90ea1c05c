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

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "cmatmul_tc.cuh"    // splitk_sum_kernel, splits_for

namespace {
namespace wg {

constexpr int BM = 128;      // rows of C a tile: two consumer warpgroups of 64
constexpr int BN = 64;       // columns of C a tile
constexpr int BK = 32;       // depth of a slab: 128 bytes of fp32, one swizzle row
constexpr int STAGES = 4;    // stages of the TMA ring
constexpr int CHAIN = 4;     // slabs a chain of wgmmas sums from zero (128 of K)
constexpr int CONSUMER_THREADS = 256;                 // warpgroups 0 and 1 multiply
constexpr int THREADS = CONSUMER_THREADS + 128;       // warpgroup 2 loads
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // setmaxnreg: 64,512 of 65,536
constexpr int A_BYTES = BM * BK * 4;                  // a plane of A's slab, 16 KB
constexpr int B_BYTES = BN * BK * 4;                  // a plane of B's slab, 8 KB

template <bool GAUSS>
struct Layout {
  static constexpr int B_PLANES = GAUSS ? 3 : 2;      // Br, Bi (, Br+Bi)
  static constexpr int STAGE_BYTES = 2 * A_BYTES + B_PLANES * B_BYTES;
  static constexpr int BARRIER_OFFSET = STAGES * STAGE_BYTES;
  // the ring, its 2·STAGES barriers, and slack to align the ring to 1024
  static constexpr int SMEM_BYTES = BARRIER_OFFSET + 2 * STAGES * 8 + 1024;
};
static_assert(Layout<true>::SMEM_BYTES <= 232448, "the ring exceeds 227 KB");

// the tile that splits_for reads
struct SplitTile {
  static constexpr int BM = wg::BM, BN = wg::BN, BK = wg::BK;
};

inline int padded_k(int K) { return (K + BK - 1) / BK * BK; }

// TMA reads a plane through a 16-byte-aligned base and a row pitch that is a
// multiple of 16 bytes; else A is copied first.
inline bool a_needs_copy(const float* ar, const float* ai, int lda) {
  return (reinterpret_cast<uintptr_t>(ar) & 15) || (reinterpret_cast<uintptr_t>(ai) & 15)
         || lda % 4 != 0;
}

// The floats of workspace a call needs: B prepared, (N, Kp) a plane; A
// copied, (M, Kp) a plane, where TMA cannot read it; the partial planes of a
// K split.
template <bool GAUSS>
int64_t workspace_floats(const float* ar, const float* ai, int lda, int M, int N, int K,
                         int splits) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const int64_t kp = padded_k(K);
  int64_t floats = Layout<GAUSS>::B_PLANES * (int64_t)N * kp;
  if (a_needs_copy(ar, ai, lda)) floats += 2 * (int64_t)M * kp;
  if (splits > 1) floats += 2 * (int64_t)splits * M * N;
  return floats;
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero: split_tf32's head, by integer arithmetic on the bit pattern.
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

// A (M, K) at lda -> at[p] (M, Kp), raw, zero past K: for an A that TMA
// cannot read in place.
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

// One block an SM walks the units u = blockIdx.x, blockIdx.x + gridDim.x, ...:
// u = (split · m_tiles + row tile) · n_tiles + column tile. A split's unit
// covers the slabs [split · slabs_per_split, ...) and writes its partial
// planes to cr + split · split_stride (ldc N); else C itself.
template <bool GAUSS>
__global__ void __launch_bounds__(THREADS, 1)
cmatmul_wgmma_tf32_kernel(const __grid_constant__ CUtensorMap ta_r,
                          const __grid_constant__ CUtensorMap ta_i,
                          const __grid_constant__ CUtensorMap tb,
                          float* __restrict__ cr, float* __restrict__ ci, int64_t ldc,
                          int64_t split_stride, int slabs_per_split, int n_slabs_all,
                          int M, int N, int m_tiles, int n_tiles, int units, int vec2) {
  using L = Layout<GAUSS>;
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
        tma_load_2d(dst, &ta_r, bar, k0, row0);
        tma_load_2d(dst + A_BYTES, &ta_i, bar, k0, row0);
        tma_load_3d(dst + 2 * A_BYTES, &tb, bar, k0, col0, 0);
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
      const uint8_t* a_r = smem + stage * L::STAGE_BYTES + q * 64 * 128;
      const uint8_t* a_i = a_r + A_BYTES;
      const uint32_t b0 = ring + stage * L::STAGE_BYTES + 2 * A_BYTES;
      // a chain of wgmmas runs over CHAIN slabs from zero, then joins the
      // running sums (the last chain of a unit may be shorter)
      const bool chain_starts = s % CHAIN == 0;
      const bool chain_ends = s % CHAIN == CHAIN - 1 || s == n_slabs - 1;
      // this thread's fragments of the slab's four k8 steps: rows 16w+g (+8),
      // k 8kk+t (+4), from the 128-byte-swizzled tile (16-byte chunk c of row
      // r at c ^ (r & 7)), rounded, and Ar+Ai (Gauss) or −Ai (4-dot)
      uint32_t xr[BK / 8][4], xi[BK / 8][4], xs[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = 16 * w + g + 8 * (v & 1);
          const int off = r * 128 + (((2 * kk + (v >> 1)) ^ g) << 4) + 4 * t;
          const float fr = *reinterpret_cast<const float*>(a_r + off);
          const float fi = *reinterpret_cast<const float*>(a_i + off);
          xr[kk][v] = tf32_rna(fr);
          xi[kk][v] = tf32_rna(fi);
          xs[kk][v] = GAUSS ? tf32_rna(__fadd_rn(fr, fi)) : (xi[kk][v] ^ 0x80000000u);
        }
      }
      // one fence, then the slab's wgmmas back to back
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t d_br = sw128_desc(b0 + 32 * kk);
        const uint64_t d_bi = sw128_desc(b0 + B_BYTES + 32 * kk);
        const int sc = kk > 0 || !chain_starts;
        if constexpr (GAUSS) {
          const uint64_t d_bs = sw128_desc(b0 + 2 * B_BYTES + 32 * kk);
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
EncodeTiled encode_tiled() {
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

// A tiled fp32 descriptor with 128-byte swizzle and zero fill out of bounds.
int encode(CUtensorMap* map, const float* base, int rank, const cuuint64_t* dims,
           const cuuint64_t* pitches, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base),
                        dims, pitches, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

inline bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

// The host side of one product. `ws` holds workspace_floats<GAUSS>(...) floats.
template <bool GAUSS>
int run(const float* ar, const float* ai, int lda, const float* br, const float* bi, int ldb,
        float* cr, float* ci, int ldc, int M, int N, int K, float* ws, int splits,
        void* stream) {
  using L = Layout<GAUSS>;
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (K <= 0) {
    err = cudaMemset2DAsync(cr, (size_t)ldc * 4, 0, (size_t)N * 4, M, st);
    if (err == cudaSuccess) err = cudaMemset2DAsync(ci, (size_t)ldc * 4, 0, (size_t)N * 4, M, st);
    return (int)err;
  }
  if (splits < 1 || ws == nullptr) return (int)cudaErrorInvalidValue;
  const int kp = padded_k(K);
  const int n_slabs_all = kp / BK;
  const int per = (n_slabs_all + splits - 1) / splits;
  const bool a_copy = a_needs_copy(ar, ai, lda);
  float* bt = ws;
  float* at = bt + L::B_PLANES * (int64_t)N * kp;
  float* part = at + (a_copy ? 2 * (int64_t)M * kp : 0);

  prep_b_kernel<GAUSS><<<dim3((N + 31) / 32, kp / 32), dim3(32, 8), 0, st>>>(
      br, bi, ldb, bt, N, K, kp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if (a_copy) {
    const int64_t blocks = ((int64_t)M * kp + 255) / 256;
    copy_a_kernel<<<(int)(blocks < 8LL * sms ? blocks : 8LL * sms), 256, 0, st>>>(
        ar, ai, lda, at, M, K, kp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  CUtensorMap ta_r, ta_i, tb;
  const float* a_re = a_copy ? at : ar;
  const float* a_im = a_copy ? at + (int64_t)M * kp : ai;
  const cuuint64_t a_dims[2] = {(cuuint64_t)(a_copy ? kp : K), (cuuint64_t)M};
  const cuuint64_t a_pitch[1] = {(cuuint64_t)(a_copy ? kp : lda) * 4};
  const cuuint32_t a_box[2] = {BK, BM};
  const cuuint64_t b_dims[3] = {(cuuint64_t)kp, (cuuint64_t)N, (cuuint64_t)L::B_PLANES};
  const cuuint64_t b_pitch[2] = {(cuuint64_t)kp * 4, (cuuint64_t)kp * N * 4};
  const cuuint32_t b_box[3] = {BK, BN, L::B_PLANES};
  int rc = encode(&ta_r, a_re, 2, a_dims, a_pitch, a_box);
  if (rc == 0) rc = encode(&ta_i, a_im, 2, a_dims, a_pitch, a_box);
  if (rc == 0) rc = encode(&tb, bt, 3, b_dims, b_pitch, b_box);
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
  const auto kernel = cmatmul_wgmma_tf32_kernel<GAUSS>;
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

}  // namespace wg
}  // namespace

// How many ways each kernel wants K split for this problem on a card of `sms`
// multiprocessors (splits_for over the 128x64 tile and 32-deep slabs).
extern "C" int cmatmul_tf32_splits(int M, int N, int K, int sms) {
  return splits_for<wg::SplitTile>(M, N, K, sms);
}

extern "C" int cmatmul_tf32_gauss_splits(int M, int N, int K, int sms) {
  return splits_for<wg::SplitTile>(M, N, K, sms);
}

// The floats of workspace one call needs, for these operand pointers and lda.
extern "C" long long cmatmul_tf32_workspace(const float* ar, const float* ai, int lda, int M,
                                            int N, int K, int splits) {
  return wg::workspace_floats<false>(ar, ai, lda, M, N, K, splits);
}

extern "C" long long cmatmul_tf32_gauss_workspace(const float* ar, const float* ai, int lda,
                                                  int M, int N, int K, int splits) {
  return wg::workspace_floats<true>(ar, ai, lda, M, N, K, splits);
}

// The dynamic shared memory a block of either kernel takes (the ring, its
// barriers, the alignment slack).
extern "C" int cmatmul_tf32_smem_bytes(int gauss) {
  return gauss ? wg::Layout<true>::SMEM_BYTES : wg::Layout<false>::SMEM_BYTES;
}

// C = A @ B at `high`, 4-dot form. `scratch` is the workspace.
extern "C" int cmatmul_tf32(const float* ar, const float* ai, int lda,
                            const float* br, const float* bi, int ldb,
                            float* cr, float* ci, int ldc,
                            int M, int N, int K,
                            float* scratch, int splits, void* stream) {
  return wg::run<false>(ar, ai, lda, br, bi, ldb, cr, ci, ldc, M, N, K, scratch, splits, stream);
}

// The same in the Gauss form.
extern "C" int cmatmul_tf32_gauss(const float* ar, const float* ai, int lda,
                                  const float* br, const float* bi, int ldb,
                                  float* cr, float* ci, int ldc,
                                  int M, int N, int K,
                                  float* scratch, int splits, void* stream) {
  return wg::run<true>(ar, ai, lda, br, bi, ldb, cr, ci, ldc, M, N, K, scratch, splits, stream);
}
