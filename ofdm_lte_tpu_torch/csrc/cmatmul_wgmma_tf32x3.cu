// Planar complex GEMM for Hopper (sm_90a) at the `highest` precision, as
// accurate as fp32: three TF32 products per real product (3xTF32), on wgmma
// with TMA, in the 4-dot form (`cmatmul_tf32x3`).
//
//   C = A @ B with A (M, K), B (K, N), C (M, N), each a pair of float32
//   planes (re, im), row-major, unit inner stride, row strides lda/ldb/ldc.
//
//   Cr = Ar·Br − Ai·Bi        Ci = Ar·Bi + Ai·Br
//
// Replaces the TPU kernel ofdm_lte_tpu/ops/pallas_kernels.py:_cmatmul_kernel
// (driven by cmatmul_pallas_2d) in its 4-dot form at its `highest`
// precision, and the mma.sync kernel that served it on this card before
// (a 64x64 tile, two blocks an SM, a 2-stage cp.async ring). Every fp32
// operand x is split as ops/cmatmul.py:tf32_split splits it: a head hi, x
// rounded to TF32 to nearest with ties away from zero, and a tail lo, x − hi
// (exact in fp32) cut to TF32; each real product is hi·lo + lo·hi + hi·hi
// (lo·lo lies below fp32's last bit). The products of TF32 values are exact,
// so the kernel differs from its plain version (cmatmul_plain_tf32x3) only in
// the order of the sums. The Gauss form at `highest` is cmatmul_tc_gauss.cu
// (mma.sync), `high` (TF32) cmatmul_wgmma_tf32.cu, `default` (bf16)
// cmatmul_bf16.cu.
//
// What bounds it here: operations, on the tensor cores at the TF32 rate (495
// TFLOP/s dense): 3 x 8·M·K·N. A 32-deep slab of the 128x64 complex tile is
// 3,072 clocks of tensor work, three times `high`'s 1,024, where the ring
// supplies its 80 KB in some 2,000 (about 40 bytes a clock an SM, measured at
// `high`), so this form is bound by the tensor cores, not the ring. The
// mma.sync kernel it replaces stood at 0.40 of this bound: mma.sync tops out
// at 0.66 of the TF32 rate on this card, and its cp.async staging cost 15-20%.
// At K = 16 (the Jakes product) the output's bytes bound it. Measured on an
// H100 (700 W; tools/time_cmatmul_high.py --precision highest): TX 0.544 ms
// and RX data 0.541 at 256 lanes of 14 symbols, 0.70 and 0.66 of the bound,
// against 0.946 and 0.926 for the mma.sync kernel, with the same error
// against float64; of that, B's split takes 0.02 ms and, at TX, A's copy
// 0.027, and the last, partly filled wave of tiles 7% (TX) and 15% (RX data).
//
// What the design does: the `high` kernels' persistent wgmma loop
// (wgmma_cmatmul.cuh: a producer warpgroup keeping a ring of TMA loads in
// flight, two consumer warpgroups of 64 rows under setmaxnreg, split-K summed
// in a fixed order) under this policy:
//   - B, a constant table read by every row tile, is split once a call by
//     prep_b_kernel into the caller's workspace: transposed to (N, Kp),
//     K-major, K padded with zeros to Kp, a multiple of the 32-deep slab, as
//     six planes, the heads of −Bi, Br, Bi, then their tails. −Bi's planes
//     let one wgmma of 64x128 serve both halves of the complex product: with
//     the accumulator [Cr | Ci] (the two chains of the loop side by side), Ar
//     times the rows [Br | Bi] adds [Ar·Br | Ar·Bi], and Ai times the rows
//     [−Bi | Br] adds [−Ai·Bi | Ai·Br]. Six m64n128k8 wgmmas a k8 step
//     where m64n64k8 would take twelve: half the instructions, and half the
//     A fragments read from registers a multiply-add, for the same tensor
//     work (register-A wgmmas of 64 columns issued at two thirds of the
//     tensor cores' rate at `high`);
//   - A, the large operand (58.7 MB at the RX data GEMM), is read raw by TMA
//     (copy_a_kernel copies it first where TMA cannot read it: K = 999 at
//     TX) and split in registers: each consumer thread loads its m16n8k8
//     fragments of the slab from the swizzled tile, as `high` does, and
//     splits each value into head and tail (four integer and float
//     instructions a value), so the wgmmas take A from registers (the RS
//     form). A slab's fragments are all loaded and split first, then one
//     wgmma.fence and the slab's 24 wgmmas go out back to back, the small
//     terms of each k8 step first;
//   - a slab of A (32 KB) and B (48 KB) is 80 KB: two stages in the ring;
//   - chains of one slab (CHAIN = 1): the 24 wgmmas of a slab run as a chain
//     from zero in the tensor cores, whose adder truncates, and the chain
//     joins the fp32 running sums on the CUDA cores; the add is some 64
//     instructions a thread beside 3,072 clocks of tensor work. Summing all
//     of K in the tensor cores cost a digit at K = 2048 (1.5e-5 of max|C|
//     against float64 on the mma.sync kernel, 4e-7 to 6e-7 with chains of
//     one slab). ops/cmatmul.py's WGMMA_BK and WGMMA_CHAIN repeat BK and
//     CHAIN for the plain twin, and a test holds them to this file;
//   - the rest is the loop's: TMA with 128-byte swizzle (a slab row of 32
//     fp32 is one swizzle row, so the descriptor of a pair of B planes is
//     the canonical K-major SW128 one over 128 rows), zero fill past M, N and
//     K, the second consumer warpgroup a batch behind the first, C stored
//     from registers at any ldc, a tile grid smaller than the card split
//     along K.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_cmatmul.cuh"  // the ring, the persistent main loop, the host side

namespace {
namespace w3 {

constexpr int BK = 32;       // depth of a slab: 128 bytes of fp32, one swizzle row
constexpr int STAGES = 2;    // stages of the TMA ring: 80 KB each
constexpr int CHAIN = 1;     // slabs a chain of wgmmas sums from zero (32 of K)
constexpr int B_PLANES = 6;  // the heads of −Bi, Br, Bi, then their tails

// x = hi + lo as tf32_split splits it: hi the TF32 head, lo = x − hi (exact
// in fp32) cut to TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = wgc::tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// [c0 | c1] (64x128 fp32, 64 a thread: c0 the first 64 columns) = (scale_d ?
// [c0 | c1] : 0) + a · b, with a (64x8 TF32) in registers in the m16n8k8
// fragment layout (warp w of the warpgroup holds rows 16w..16w+15) and b
// (8x128) K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&c)[2][32], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]), "+f"(c[0][4]),
        "+f"(c[0][5]), "+f"(c[0][6]), "+f"(c[0][7]), "+f"(c[0][8]), "+f"(c[0][9]),
        "+f"(c[0][10]), "+f"(c[0][11]), "+f"(c[0][12]), "+f"(c[0][13]), "+f"(c[0][14]),
        "+f"(c[0][15]), "+f"(c[0][16]), "+f"(c[0][17]), "+f"(c[0][18]), "+f"(c[0][19]),
        "+f"(c[0][20]), "+f"(c[0][21]), "+f"(c[0][22]), "+f"(c[0][23]), "+f"(c[0][24]),
        "+f"(c[0][25]), "+f"(c[0][26]), "+f"(c[0][27]), "+f"(c[0][28]), "+f"(c[0][29]),
        "+f"(c[0][30]), "+f"(c[0][31]), "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]),
        "+f"(c[1][3]), "+f"(c[1][4]), "+f"(c[1][5]), "+f"(c[1][6]), "+f"(c[1][7]),
        "+f"(c[1][8]), "+f"(c[1][9]), "+f"(c[1][10]), "+f"(c[1][11]), "+f"(c[1][12]),
        "+f"(c[1][13]), "+f"(c[1][14]), "+f"(c[1][15]), "+f"(c[1][16]), "+f"(c[1][17]),
        "+f"(c[1][18]), "+f"(c[1][19]), "+f"(c[1][20]), "+f"(c[1][21]), "+f"(c[1][22]),
        "+f"(c[1][23]), "+f"(c[1][24]), "+f"(c[1][25]), "+f"(c[1][26]), "+f"(c[1][27]),
        "+f"(c[1][28]), "+f"(c[1][29]), "+f"(c[1][30]), "+f"(c[1][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// B (K, N) at ldb -> bt[p] (N, Kp): transposed, split, zero past K; p = 0, 1,
// 2 the heads of −Bi, Br, Bi, p = 3, 4, 5 their tails (−Bi's by a sign flip
// of Bi's: the split is odd). One 32x32 tile a block, through shared memory.
__global__ void __launch_bounds__(256)
prep_b_kernel(const float* __restrict__ br, const float* __restrict__ bi, int64_t ldb,
              uint32_t* __restrict__ bt, int N, int K, int kp) {
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
  const uint32_t neg = k0 + x < K ? 0x80000000u : 0u;   // the padding stays +0
#pragma unroll
  for (int i = y; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= N) continue;
    uint32_t rh, rl, ih, il;
    split(s_r[x][i], rh, rl);
    split(s_i[x][i], ih, il);
    uint32_t* out = bt + (int64_t)n * kp + k0 + x;
    out[0] = ih ^ neg;
    out[plane] = rh;
    out[2 * plane] = ih;
    out[3 * plane] = il ^ neg;
    out[4 * plane] = rl;
    out[5 * plane] = il;
  }
}

// What the shared main loop and host side take from this kernel.
struct Tf32x3 {
  static constexpr int BK = w3::BK, CHAIN = w3::CHAIN;
  static constexpr int A_ELEM = 4, B_ELEM = 4;       // A raw fp32, B split, TF32 in fp32 words
  static constexpr bool PREPARES_A = false;          // A read in place, or copied
  static constexpr CUtensorMapDataType A_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapDataType B_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  template <bool GAUSS> static constexpr int a_planes() { return 2; }
  template <bool GAUSS> static constexpr int b_planes() { return w3::B_PLANES; }
  template <bool GAUSS> static constexpr int stages() { return w3::STAGES; }

  // A's two fp32 planes, each from its own tensor (in place or copied)
  static __device__ __forceinline__ void load_a(uint32_t dst, const CUtensorMap* ta_r,
                                                const CUtensorMap* ta_i, uint32_t bar, int k0,
                                                int row0) {
    wgc::tma_load_2d(dst, ta_r, bar, k0, row0);
    wgc::tma_load_2d(dst + wgc::BM * BK * 4, ta_i, bar, k0, row0);
  }

  // One warpgroup's wgmmas of a slab into the chain [ch[0] | ch[1]] = [Cr |
  // Ci]. Its thread's fragments of the slab's four k8 steps (rows 16w+g
  // (+8), k 8kk+t (+4)) are loaded from the 128-byte-swizzled fp32 tile at
  // `a` (16-byte chunk c of row r at c ^ (r & 7)) and split; then one fence
  // and the slab's 24 wgmmas back to back. The B planes lie 8 KB apart from
  // b0, so planes p and p + 1 are one 128-row operand.
  template <bool GAUSS>
  static __device__ __forceinline__ void slab(float (&ch)[GAUSS ? 3 : 2][32], const uint8_t* a,
                                              uint32_t, uint32_t b0, bool chain_starts, int w,
                                              int g, int t) {
    static_assert(!GAUSS, "the Gauss form at `highest` is cmatmul_tc_gauss.cu");
    constexpr int A_BYTES = wgc::BM * BK * 4, B_BYTES = wgc::BN * BK * 4;
    uint32_t rh[BK / 8][4], rl[BK / 8][4], ih[BK / 8][4], il[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = 16 * w + g + 8 * (v & 1);
        const int off = r * 128 + (((2 * kk + (v >> 1)) ^ g) << 4) + 4 * t;
        split(*reinterpret_cast<const float*>(a + off), rh[kk][v], rl[kk][v]);
        split(*reinterpret_cast<const float*>(a + A_BYTES + off), ih[kk][v], il[kk][v]);
      }
    }
    wgc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t hi_ri = wgc::sw128_desc(b0 + B_BYTES + 32 * kk);      // [Br | Bi] heads
      const uint64_t hi_nr = wgc::sw128_desc(b0 + 32 * kk);                // [−Bi | Br] heads
      const uint64_t lo_ri = wgc::sw128_desc(b0 + 4 * B_BYTES + 32 * kk);  // tails
      const uint64_t lo_nr = wgc::sw128_desc(b0 + 3 * B_BYTES + 32 * kk);
      const int sc = kk > 0 || !chain_starts;
      wgmma_n128(ch, rh[kk], lo_ri, sc);      // [Cr | Ci] = Ar.hi·[Br | Bi].lo
      wgmma_n128(ch, rl[kk], hi_ri, 1);       //  + Ar.lo·[Br | Bi].hi
      wgmma_n128(ch, ih[kk], lo_nr, 1);       //  + Ai.hi·[−Bi | Br].lo
      wgmma_n128(ch, il[kk], hi_nr, 1);       //  + Ai.lo·[−Bi | Br].hi
      wgmma_n128(ch, rh[kk], hi_ri, 1);       //  + Ar.hi·[Br | Bi].hi
      wgmma_n128(ch, ih[kk], hi_nr, 1);       //  + Ai.hi·[−Bi | Br].hi
    }
  }

  template <bool GAUSS>
  static void prep_b(const float* br, const float* bi, int ldb, void* bt, int N, int K, int kp,
                     cudaStream_t st) {
    prep_b_kernel<<<dim3((N + 31) / 32, kp / 32), dim3(32, 8), 0, st>>>(
        br, bi, ldb, static_cast<uint32_t*>(bt), N, K, kp);
  }
};

__global__ void __launch_bounds__(wgc::THREADS, 1)
cmatmul_wgmma_tf32x3_kernel(const __grid_constant__ CUtensorMap ta_r,
                            const __grid_constant__ CUtensorMap ta_i,
                            const __grid_constant__ CUtensorMap tb,
                            float* __restrict__ cr, float* __restrict__ ci, int64_t ldc,
                            int64_t split_stride, int slabs_per_split, int n_slabs_all,
                            int M, int N, int m_tiles, int n_tiles, int units, int vec2) {
  wgc::cmatmul_body<Tf32x3, false>(&ta_r, &ta_i, &tb, cr, ci, ldc, split_stride,
                                   slabs_per_split, n_slabs_all, M, N, m_tiles, n_tiles, units,
                                   vec2);
}

}  // namespace w3
}  // namespace

// How many ways the kernel wants K split for this problem on a card of `sms`
// multiprocessors (splits_for over the 128x64 tile and 32-deep slabs).
extern "C" int cmatmul_tf32x3_splits(int M, int N, int K, int sms) {
  return splits_for<wgc::SplitTile<w3::Tf32x3>>(M, N, K, sms);
}

// The floats of workspace one call needs, for these operand pointers and lda.
extern "C" long long cmatmul_tf32x3_workspace(const float* ar, const float* ai, int lda, int M,
                                              int N, int K, int splits) {
  return wgc::workspace_floats<w3::Tf32x3, false>(ar, ai, lda, M, N, K, splits);
}

// The dynamic shared memory a block takes (the ring, its barriers, the
// alignment slack).
extern "C" int cmatmul_tf32x3_smem_bytes() { return wgc::Layout<w3::Tf32x3, false>::SMEM_BYTES; }

// C = A @ B at `highest`, 4-dot form. `scratch` is the workspace.
extern "C" int cmatmul_tf32x3(const float* ar, const float* ai, int lda,
                              const float* br, const float* bi, int ldb,
                              float* cr, float* ci, int ldc,
                              int M, int N, int K,
                              float* scratch, int splits, void* stream) {
  return wgc::run<w3::Tf32x3, false>(w3::cmatmul_wgmma_tf32x3_kernel, ar, ai, lda, br, bi, ldb,
                                     cr, ci, ldc, M, N, K, scratch, splits, stream);
}
