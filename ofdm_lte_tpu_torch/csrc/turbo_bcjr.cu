// One BCJR pass of the LTE turbo decoder over every code block of a batch,
// and, folded into the same launch, the half-iteration around it.
//
// Replaces the two lax.scans of ofdm_lte_tpu/coding/turbo.py:424-448 (the
// "scan" form of _bcjr): α forward from state 0, β backward from state 0 at
// K', and the a-posteriori LLR of every step,
//
//   γ_k[s,i] = (L_sys·sys_sign + L_par·par_sign + L_apr·in_sign)·0.5
//   α_{k+1}[s'] = ⊕_{(s,i) -> s'} α_k[s] + γ_k[s,i]       α_0 = (0, -1e9, ...)
//   β_k[s]      = ⊕_i β_{k+1}[ns(s,i)] + γ_k[s,i]           β_K' = (0, -1e9, ...)
//   APP_k = ⊕_s (α_k[s] + γ_k[s,0]) + β_{k+1}[ns(s,0)] − ⊕_s (… input 1)
//
// with ⊕ = max (max-log) or log-sum-exp (log-MAP), a template flag. No
// renormalisation, as in the JAX package. Every add is __fadd_rn in the
// JAX package's order, so no contraction changes a sum: under max-log the
// result equals the "scan" form's as floats. The trellis is the 8-state RSC
// with the reference's quirk (systematic output = feedback bit), state
// (s0<<2)|(s1<<1)|s2: fb = i ^ s1 ^ s2, ns = (fb<<2) | (s>>1), sys = fb,
// par = fb ^ s0 ^ s2.
//
// Three output modes, a template parameter:
// - APP: out[k] = APP_k for every k < K', the a-priori a dense plane;
// - extrinsic: one half-iteration of the decoder (ofdm_lte_tpu/coding/
//   turbo.py:495-517). The a-priori of step k < K = K' − 3 is read through
//   an index, apr_k = ext_in[idx[k]] (the QPP π or π⁻¹ applied on the way
//   in), 0 on the three tail steps and everywhere when ext_in is null (the
//   first iteration); out[k] = (APP_k − apr_k) − L_sys,k for k < K, in this
//   decoder's own trellis order. Both extrinsic planes are step-major,
//   (K, n_blocks): the blocks of a CTA then gather from the same sectors;
// - hard: the same a-priori, out[k] = APP_k < 0 (int32) for k < K.
//
// Design. A half-warp owns one code block: threads 0-7 of it (group A)
// run α, threads 8-15 (group B) run β, one thread per state, so a warp
// holds 2 blocks and a 64-thread CTA 4. A warp past the last block leaves
// whole; in a warp with one block left the second half-warp runs along on
// it and stores nothing, so every shuffle (width 8) names the full warp.
// - Phase 1: A runs α forward over [0, mid) and stores α_k at row k of a
//   global scratch (n_blocks, K', 8); B runs β backward over [mid, K') and
//   stores β_{k+1} at row k. mid is a multiple of the chunk at or below
//   K'/2. __syncwarp then makes each group's stores visible to the other.
// - Phase 2: A carries α on over [mid, K'), B carries β on down [0, mid),
//   each keeping its metric rows of the last two chunks in shared memory.
//   One chunk behind the recursion, each thread forms the APP of its own
//   elements of a chunk (those whose LLRs it loaded) from its group's row
//   (shared) and the other group's row of phase 1 (global, loaded a chunk
//   ahead), over the 8 states in its registers: no shuffle, and a group's
//   8 threads store 8 consecutive steps. So the sequential depth is about
//   K' steps, not 2·K', and a step of either phase is a recursion step.
// - Both groups run the same instruction stream: a thread's direction,
//   its recursion's source lanes and its edges' sign masks are per-thread
//   values, so the warp never diverges between A and B.
// - The LLRs come in chunks of kChunk steps, each thread loading kChunk/8
//   steps of each plane (the group's loads are 32-byte segments), one chunk
//   ahead of the recursion, and the a-priori's index a chunk before that;
//   a recursion step takes its three LLRs from the group by __shfl_sync. So
//   no load (nor the a-priori's gather) waits on the α or β chain.
// - A chunk is straight-line code, stores included (predicated, not
//   branched around). A chunk that has steps outside its group's range
//   (past K', the idle turn of the shorter group) runs the masked copy of
//   the body: zero LLRs, stores off, the metric held by a select. Whether a
//   chunk needs it depends on the chunk's index and K' alone, so the branch
//   is uniform over the whole grid.
//
// Bound. What a pass must move is 3 LLR inputs and 1 output, 16 B a step a
// block over 3.35 TB/s: 3,328 blocks of K' 5,827 (a 256-lane 75,376-bit
// transport block) move 0.31 GB, 0.093 ms. This design adds the scratch,
// written and read (64 B a step a block: half α, half β, 1.24 GB and 0.37
// ms there), which is what binds a large batch; keeping it on chip is
// later work. The operations (some 110 a step a block) are far below the
// card's rate. What binds a small batch is the sequential depth: about K'
// dependent steps, each two shuffles, two adds and a ⊕.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kThreads = 64;                // a CTA: 4 code blocks
constexpr int kGroups = kThreads / 8;
constexpr int kChunk = 32;                  // steps loaded a chunk ahead
constexpr int kPer = kChunk / 8;            // steps of a chunk each thread loads
// a group's two chunks of metric rows in shared memory: 12 floats a row, so
// that the two 16-byte reads of a row by the group's 8 threads hit distinct
// banks, and 8 more floats a group, so that the 4 groups of a warp store
// their rows to distinct banks
constexpr int kRow = 12;
constexpr int kGroupStride = 2 * kChunk * kRow + 8;

enum Mode { kApp = 0, kExtrinsic = 1, kHard = 2 };

constexpr unsigned kSign = 0x80000000u;

// x with its sign flipped where `sign` has the sign bit: x·(−1)^bit exactly
__device__ __forceinline__ float flip(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ sign);
}

// γ of an edge from its three LLRs, each already signed for the edge, added
// in the JAX package's order
__device__ __forceinline__ float gamma(float xs, float yp, float zi) {
  return __fmul_rn(__fadd_rn(__fadd_rn(xs, yp), zi), 0.5f);
}

// ⊕ of two metrics; log-MAP as jax.nn.logsumexp computes it
template <bool kMaxLog>
__device__ __forceinline__ float oplus(float a, float b) {
  if (kMaxLog) return fmaxf(a, b);
  float m = fmaxf(a, b);
  m = isfinite(m) ? m : 0.f;
  return __fadd_rn(logf(__fadd_rn(expf(__fsub_rn(a, m)), expf(__fsub_rn(b, m)))), m);
}

// *p = v where `on`, as one predicated store: a branch around a store would
// end the basic block, and the compiler could no longer overlap one step's
// off-chain work (the APP reduction) with the next step's recursion
__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile("{ .reg .pred q; setp.ne.b32 q, %2, 0; @q st.global.f32 [%0], %1; }"
               :: "l"(p), "f"(v), "r"((int)on));
}
__device__ __forceinline__ void store_if(int* p, int v, bool on) {
  asm volatile("{ .reg .pred q; setp.ne.b32 q, %2, 0; @q st.global.b32 [%0], %1; }"
               :: "l"(p), "r"(v), "r"((int)on));
}

// ⊕ of 8 metrics held by one thread: the max in any order; log-MAP's sum
// in the order of an XOR butterfly over 8 lanes (partners 4, 2, 1), the
// order in which a ⊕ across a group's threads would add it
template <bool kMaxLog>
__device__ __forceinline__ float oplus8(const float (&v)[8]) {
  float m = fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
                  fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
  if (kMaxLog) return m;
  m = isfinite(m) ? m : 0.f;
  float e[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) e[t] = expf(__fsub_rn(v[t], m));
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(e[0], e[4]), __fadd_rn(e[2], e[6])),
                              __fadd_rn(__fadd_rn(e[1], e[5]), __fadd_rn(e[3], e[7])));
  return __fadd_rn(logf(sum), m);
}

// APP of one step from α_k and β_{k+1} of all 8 states and the step's LLRs:
// ⊕_s (α_k[s] + γ(s,0)) + β_{k+1}[ns(s,0)] − ⊕_s (… input 1). γ of an edge
// with bits (sys, par, in) is ((±x ± y) ± z)·0.5; negating all three inputs
// negates the float exactly, so the 8 sign patterns are ± four values.
template <bool kMaxLog>
__device__ __forceinline__ float app_of(const float (&alpha)[8], const float (&beta)[8],
                                        float x, float y, float z) {
  const float xpy = __fadd_rn(x, y), xmy = __fadd_rn(x, -y);
  const float g[4] = {__fmul_rn(__fadd_rn(xpy, z), 0.5f), __fmul_rn(__fadd_rn(xpy, -z), 0.5f),
                      __fmul_rn(__fadd_rn(xmy, z), 0.5f), __fmul_rn(__fadd_rn(xmy, -z), 0.5f)};
  float v[2][8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int t0 = (t >> 2) & 1, t1 = (t >> 1) & 1, t2 = t & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int fb = i ^ t1 ^ t2, par = fb ^ t0 ^ t2, ns = (fb << 2) | (t >> 1);
      // bits (fb, par, i): g[(par ^ fb) << 1 | (i ^ fb)], negated where fb
      const float gi = g[((par ^ fb) << 1) | (i ^ fb)];
      v[i][t] = __fadd_rn(__fadd_rn(alpha[t], fb ? -gi : gi), beta[ns]);
    }
  }
  return __fsub_rn(oplus8<kMaxLog>(v[0]), oplus8<kMaxLog>(v[1]));
}

// A group's walk over the trellis in one phase: chunk c, element j is step
// base + dir·(kChunk·c + j); chunks c < n are its own, the rest idle.
struct Walk {
  int base, dir, n;
  __device__ __forceinline__ int step(int c, int j) const { return base + dir * (kChunk * c + j); }
  __device__ __forceinline__ bool valid(int c, int k, int kp) const {
    return (unsigned)c < (unsigned)n && (unsigned)k < (unsigned)kp;
  }
  // every step of chunk c is the group's and inside [0, K')
  __device__ __forceinline__ bool full(int c, int kp) const {
    const int a = step(c, 0), b = step(c, kChunk - 1);
    return c < n && min(a, b) >= 0 && max(a, b) < kp;
  }
};

template <bool kMaxLog, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
bcjr_kernel(const float* __restrict__ l_sys, const float* __restrict__ l_par,
            const float* __restrict__ l_apr, const int* __restrict__ index, int n_apr,
            void* __restrict__ out, float* scratch, int n_blocks, int kp) {
  const int lane = threadIdx.x & 31;
  const int s = lane & 7;                            // this thread's state
  const bool is_b = (lane >> 3) & 1;                 // group B: β
  const int64_t first = ((int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31)) >> 4;
  if (first >= n_blocks) return;                     // the whole warp leaves
  // a warp with one block left: its second half-warp runs along on that
  // block and stores nothing, so every shuffle names the full warp
  const bool live = first + (lane >> 4) < n_blocks;
  const int64_t blk = live ? first + (lane >> 4) : first;
  constexpr unsigned mask = 0xFFFFFFFFu;

  const float* ls = l_sys + blk * kp;
  const float* lp = l_par + blk * kp;
  // the a-priori: a block-major plane (APP mode) or the other decoder's
  // step-major extrinsic (K, n_blocks), whose QPP gather then reads the
  // blocks of neighbouring threads from one 32-byte sector
  const int64_t apr_stride = kMode == kApp ? 1 : n_blocks;
  const float* la = l_apr ? l_apr + (kMode == kApp ? blk * n_apr : blk) : nullptr;
  const float* apr = la ? la : ls;                   // a valid base for the gather
  float* scr = scratch + blk * (int64_t)kp * 8 + s;
  const int n_out = kMode == kApp ? kp : kp - 3;

  const int s0 = (s >> 2) & 1, s1 = (s >> 1) & 1, s2 = s & 1;
  // the edges out of s under input i: feedback fb_i = i ^ s1 ^ s2, next
  // state (fb_i << 2) | (s >> 1), parity fb_i ^ s0 ^ s2 (input 1 flips all)
  const int fb0 = s1 ^ s2;
  const int ns0 = (fb0 << 2) | (s >> 1), ns1 = ns0 ^ 4;
  const unsigned out_sys = (unsigned)fb0 << 31, out_par = (unsigned)(fb0 ^ s0 ^ s2) << 31;
  // the recursion's two edges. α (into s): from p_e = 2·(s & 3) + e with
  // feedback s0, input s0 ^ s2 ^ e, parity s0 ^ s1 ^ e. β (out of s): the
  // edges above. Edge 1 flips the parity and input signs of edge 0, and
  // for β the systematic sign too.
  const int src0 = is_b ? ns0 : (s & 3) << 1, src1 = is_b ? ns1 : ((s & 3) << 1) | 1;
  const unsigned rec_sys = is_b ? out_sys : (unsigned)s0 << 31;
  const unsigned rec_par = is_b ? out_par : (unsigned)(s0 ^ s1) << 31;
  const unsigned rec_in = is_b ? 0u : (unsigned)(s0 ^ s2) << 31;
  const unsigned rec_flip_sys = is_b ? kSign : 0u;

  const int mid = kp / 2 / kChunk * kChunk;
  const int n_a = mid / kChunk, n_b = (kp - mid + kChunk - 1) / kChunk;
  const int turns = max(n_a, n_b);                   // chunks of each phase
  const Walk a1{0, 1, n_a}, b1{mid + kChunk * n_b - 1, -1, n_b};
  const Walk a2{mid, 1, n_b}, b2{mid - 1, -1, n_a};

  // this thread's share of chunk c of walk w: elements s + 8r, r < kPer,
  // of each LLR plane (0 outside the walk). The a-priori's source offsets
  // (`ix`, -1 for none) are read a chunk before its gather, so the gather
  // never waits on the index.
  float cx[kPer], cy[kPer], cz[kPer], nx[kPer], ny[kPer], nz[kPer];
  int ix[kPer];
  auto load_index = [&](const Walk& w, int c) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = w.step(c, s + 8 * r);
      ix[r] = (la && w.valid(c, k, kp) && k < n_apr) ? (index ? __ldg(index + k) : k) : -1;
    }
  };
  auto load_llrs = [&](const Walk& w, int c, float (&x)[kPer], float (&y)[kPer],
                       float (&z)[kPer]) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = w.step(c, s + 8 * r);
      const bool in = w.valid(c, k, kp);
      x[r] = in ? __ldg(ls + k) : 0.f;
      y[r] = in ? __ldg(lp + k) : 0.f;
      // always a load (of offset 0 where there is none), then a select: no
      // branch in the chunk's code
      const float v = __ldg(apr + max(ix[r], 0) * apr_stride);
      z[r] = ix[r] >= 0 ? v : 0.f;
    }
  };
  auto rotate = [&] {
#pragma unroll
    for (int r = 0; r < kPer; ++r) { cx[r] = nx[r]; cy[r] = ny[r]; cz[r] = nz[r]; }
  };
  // the LLRs of element j, from the thread that loaded them
  auto llrs = [&](int j, float& x, float& y, float& z) {
    x = __shfl_sync(mask, cx[j >> 3], j & 7, 8);
    y = __shfl_sync(mask, cy[j >> 3], j & 7, 8);
    z = __shfl_sync(mask, cz[j >> 3], j & 7, 8);
  };
  // one step of this thread's recursion, α or β, on the step's LLRs
  float m = s == 0 ? 0.f : kNeg;                     // α_0 (A) or β_K' (B)
  auto recur = [&](float x, float y, float z) {
    const float xs = flip(x, rec_sys), yp = flip(y, rec_par), zi = flip(z, rec_in);
    const float g0 = gamma(xs, yp, zi);
    const float g1 = gamma(flip(xs, rec_flip_sys), -yp, -zi);
    const float r0 = __shfl_sync(mask, m, src0, 8);
    const float r1 = __shfl_sync(mask, m, src1, 8);
    return oplus<kMaxLog>(__fadd_rn(r0, g0), __fadd_rn(r1, g1));
  };

  // -- phase 1: α up to mid, β down to mid, each stored ------------------
  const Walk w1 = is_b ? b1 : a1;
  auto step1 = [&](int c, int j, bool masked) {
    const int k = w1.step(c, j);
    const bool valid = !masked || w1.valid(c, k, kp);
    store_if(scr + (int64_t)k * 8, m, live && valid);    // α_k, or β_{k+1}
    float x, y, z;
    llrs(j, x, y, z);
    const float next = recur(x, y, z);
    m = valid ? next : m;
  };
  load_index(w1, 0);
  load_llrs(w1, 0, cx, cy, cz);
  load_index(w1, 1);
  for (int c = 0; c < turns; ++c) {
    load_llrs(w1, c + 1, nx, ny, nz);
    load_index(w1, c + 2);
    if (a1.full(c, kp) && b1.full(c, kp)) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) step1(c, j, false);
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) step1(c, j, true);
    }
    rotate();
  }
  __syncwarp(mask);

  // -- phase 2: each group goes on over the other's half, forming APP ------
  // The recursion goes on as in phase 1, its metric kept in shared memory
  // (`mine`: this group's rows of the last two chunks). One chunk behind
  // it, each thread forms the APP of its own elements of the chunk, s + 8r,
  // whose LLRs it loaded itself: from the row of its group's metric
  // (shared) and the other group's (global, stored in phase 1, loaded a
  // chunk ahead), over the 8 states in registers. So the APP costs no
  // shuffle, and a group's 8 threads write 8 steps at once.
  const Walk w2 = is_b ? b2 : a2;
  __shared__ __align__(16) float rows[kGroups * kGroupStride];
  float* mine = rows + (threadIdx.x >> 3) * kGroupStride;
  const float* scratch_blk = scratch + blk * (int64_t)kp * 8;
  float4 oc[kPer][2], on[kPer][2];                   // other rows: due, next
  float px[kPer], py[kPer], pz[kPer];                // LLRs of the chunk due
  auto load_rows = [&](int c, float4 (&o)[kPer][2]) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = w2.step(c, s + 8 * r);
      const float4* row = reinterpret_cast<const float4*>(
          scratch_blk + (int64_t)(w2.valid(c, k, kp) ? k : 0) * 8);
      o[r][0] = row[0];
      o[r][1] = row[1];
    }
  };
  auto step2 = [&](int c, int j, bool masked) {
    const int k = w2.step(c, j);
    const bool valid = !masked || w2.valid(c, k, kp);
    mine[(c & 1) * kChunk * kRow + j * kRow + s] = m;        // α_k, or β_{k+1}
    float x, y, z;
    llrs(j, x, y, z);
    const float next = recur(x, y, z);
    m = valid ? next : m;
  };
  // the APP of this thread's elements of chunk c (rows of chunk c in mine
  // and oc, its LLRs in px, py, pz)
  auto app_chunk = [&](int c) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = s + 8 * r, k = w2.step(c, j);
      const float4* own = reinterpret_cast<const float4*>(
          mine + (c & 1) * kChunk * kRow + j * kRow);
      const float4 o0 = own[0], o1 = own[1];
      const float v_own[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
      const float v_oth[8] = {oc[r][0].x, oc[r][0].y, oc[r][0].z, oc[r][0].w,
                              oc[r][1].x, oc[r][1].y, oc[r][1].z, oc[r][1].w};
      float alpha[8], beta[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        alpha[t] = is_b ? v_oth[t] : v_own[t];
        beta[t] = is_b ? v_own[t] : v_oth[t];
      }
      const float x = px[r], z = pz[r];
      const float app = app_of<kMaxLog>(alpha, beta, x, py[r], z);
      const bool write = live && w2.valid(c, k, kp) && k < n_out;
      if (kMode == kApp)
        store_if(static_cast<float*>(out) + blk * kp + k, app, write);
      if (kMode == kExtrinsic)
        store_if(static_cast<float*>(out) + (int64_t)k * n_blocks + blk,
                 __fsub_rn(__fsub_rn(app, z), x), write);
      if (kMode == kHard)
        store_if(static_cast<int*>(out) + blk * n_out + k, app < 0.f, write);
    }
  };
  load_index(w2, 0);
  load_llrs(w2, 0, cx, cy, cz);
  load_index(w2, 1);
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    px[r] = py[r] = pz[r] = 0.f;
    oc[r][0] = oc[r][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = 0; c < turns; ++c) {
    load_llrs(w2, c + 1, nx, ny, nz);
    load_index(w2, c + 2);
    load_rows(c, on);
    // the recursion of chunk c and the APP of chunk c - 1 (none at c = 0:
    // no element of chunk -1 is valid) in one straight-line block
    if (a2.full(c, kp) && b2.full(c, kp)) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) step2(c, j, false);
      app_chunk(c - 1);
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) step2(c, j, true);
      app_chunk(c - 1);
    }
    __syncwarp(mask);                                // chunk c's rows in mine
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      px[r] = cx[r]; py[r] = cy[r]; pz[r] = cz[r];
      oc[r][0] = on[r][0]; oc[r][1] = on[r][1];
    }
    rotate();
  }
  app_chunk(turns - 1);
}

template <int kMode>
void launch(const float* l_sys, const float* l_par, const float* l_apr, const int* index,
            int n_apr, void* out, float* scratch, int n_blocks, int kp, int max_log,
            cudaStream_t stream) {
  const int per_cta = kThreads / 16;
  const dim3 grid((n_blocks + per_cta - 1) / per_cta);
  if (max_log)
    bcjr_kernel<true, kMode><<<grid, kThreads, 0, stream>>>(l_sys, l_par, l_apr, index, n_apr,
                                                            out, scratch, n_blocks, kp);
  else
    bcjr_kernel<false, kMode><<<grid, kThreads, 0, stream>>>(l_sys, l_par, l_apr, index, n_apr,
                                                             out, scratch, n_blocks, kp);
}

}  // namespace

// l_sys, l_par: (n_blocks, kp) float32, contiguous. The a-priori of block
// b at step k < n_apr (0 for k >= n_apr, and for all k if l_apr is null),
// with j = index ? index[k] : k: mode 0 (APP), l_apr[b·n_apr + j] (a
// (n_blocks, kp) plane), out (n_blocks, kp) float32; modes 1 and 2, with
// n_apr = K = kp − 3, l_apr[j·n_blocks + b] (a step-major (K, n_blocks)
// extrinsic plane), and out of mode 1 (extrinsic) (K, n_blocks) float32,
// (APP − a-priori) − L_sys, of mode 2 (hard) (n_blocks, K) int32, APP < 0.
// scratch: n_blocks·kp·8 floats. Returns the launch's cudaError_t.
extern "C" int turbo_bcjr(const float* l_sys, const float* l_par, const float* l_apr,
                          const int* index, int n_apr, void* out, float* scratch, int n_blocks,
                          int kp, int mode, int max_log, cudaStream_t stream) {
  if (n_blocks <= 0 || kp <= 0) return 0;
  if (mode == kApp)
    launch<kApp>(l_sys, l_par, l_apr, index, n_apr, out, scratch, n_blocks, kp, max_log, stream);
  else if (mode == kExtrinsic)
    launch<kExtrinsic>(l_sys, l_par, l_apr, index, n_apr, out, scratch, n_blocks, kp, max_log,
                       stream);
  else if (mode == kHard)
    launch<kHard>(l_sys, l_par, l_apr, index, n_apr, out, scratch, n_blocks, kp, max_log, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
