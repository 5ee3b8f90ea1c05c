// One BCJR pass of the LTE turbo decoder over every code block of a batch.
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
// Design. A group of 8 threads owns one code block, one thread per state,
// so a warp holds 4 blocks and a 128-thread CTA 16; a group past the last
// block leaves whole, so the shuffles name only live lanes.
// - The LLRs come in chunks of 32 steps, each thread loading 4 steps of
//   each plane (the group's loads are 32-byte segments), one chunk ahead
//   of the recursion; a step takes its three LLRs from the group by
//   __shfl_sync. So no load waits on the α or β chain.
// - Forward: thread s' takes α_k of its two predecessors from the group by
//   __shfl_sync, forms γ of those edges in registers, and stores α_k to a
//   global scratch (n_blocks, K', 8): the group's 8 floats are one 32-byte
//   store.
// - Backward: thread s carries β, reads back its own α of the chunk (loaded
//   a chunk ahead, like the LLRs), forms APP_k on the fly (⊕ over the group
//   by three XOR shuffles) and the group's thread 0 writes it.
// - A chunk's 32 steps are straight-line code: the steps past K' (the last
//   chunk forward, the first backward) run on zero LLRs, their α stores
//   and APP stores predicated off and β held by a select. So the compiler
//   interleaves a step's off-chain work (the LLR shuffles, γ, the APP
//   reduction) with its neighbours', and in-order issue does not wait on it.
//
// Bound. What a pass must move is 3 LLR inputs and 1 output, 16 B a step a
// block over 3.35 TB/s: 3,328 blocks of K' 5,827 (a 256-lane 75,376-bit
// transport block) move 0.31 GB, 0.093 ms. This design adds the α scratch,
// written and read (64 B a step a block, 80 B in all: 1.55 GB, 0.46 ms);
// keeping α on chip is later work. The operations (some 110 a step a
// block) are far below the card's rate. What binds a small batch is the
// sequential depth: K' dependent steps, each two shuffles, two adds and a
// ⊕; with 256 blocks (16 CTAs) the card holds 64 warps and each waits on
// its own chain. The prefetch keeps memory latency off that chain and the
// straight-line chunks keep the rest of a step off it: some 140 cycles a
// forward-and-backward step remain (PERF.md). Running α and β from both
// ends at once and fusing a whole decode into one launch are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kThreads = 128;               // 16 code blocks a CTA
constexpr int kChunk = 32;                  // steps of LLRs (and α) loaded a chunk ahead
constexpr int kPer = kChunk / 8;            // of which each thread of a group loads 4

__device__ __forceinline__ float signed_llr(float x, int bit) { return bit ? -x : x; }

// γ of an edge with systematic bit `sys`, parity bit `par` and input `in`,
// added in the JAX package's order
__device__ __forceinline__ float branch(float ls, float lp, float la, int sys, int par, int in) {
  return __fmul_rn(__fadd_rn(__fadd_rn(signed_llr(ls, sys), signed_llr(lp, par)),
                             signed_llr(la, in)), 0.5f);
}

// ⊕ of two metrics; log-MAP as jax.nn.logsumexp computes it
template <bool kMaxLog>
__device__ __forceinline__ float oplus(float a, float b) {
  if (kMaxLog) return fmaxf(a, b);
  float m = fmaxf(a, b);
  m = isfinite(m) ? m : 0.f;
  return __fadd_rn(logf(__fadd_rn(expf(__fsub_rn(a, m)), expf(__fsub_rn(b, m)))), m);
}

// ⊕ over the 8 threads of a group
template <bool kMaxLog>
__device__ __forceinline__ float group_oplus(float v, unsigned mask) {
  float m = v;
  m = fmaxf(m, __shfl_xor_sync(mask, m, 4, 8));
  m = fmaxf(m, __shfl_xor_sync(mask, m, 2, 8));
  m = fmaxf(m, __shfl_xor_sync(mask, m, 1, 8));
  if (kMaxLog) return m;
  m = isfinite(m) ? m : 0.f;
  float e = expf(__fsub_rn(v, m));
  e = __fadd_rn(e, __shfl_xor_sync(mask, e, 4, 8));
  e = __fadd_rn(e, __shfl_xor_sync(mask, e, 2, 8));
  e = __fadd_rn(e, __shfl_xor_sync(mask, e, 1, 8));
  return __fadd_rn(logf(e), m);
}

// This thread's share of the chunk of 32 steps at `base`: steps base + s + 8r,
// r < 4, of each LLR plane (0 outside [0, kp))
__device__ __forceinline__ void load_llrs(const float* ls, const float* lp, const float* la,
                                          int base, int kp, int s, float (&x)[kPer],
                                          float (&y)[kPer], float (&z)[kPer]) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int k = base + s + 8 * r;
    const bool in = (unsigned)k < (unsigned)kp;
    x[r] = in ? __ldg(ls + k) : 0.f;
    y[r] = in ? __ldg(lp + k) : 0.f;
    z[r] = in ? __ldg(la + k) : 0.f;
  }
}

template <bool kMaxLog>
__global__ void __launch_bounds__(kThreads, 1)
bcjr_kernel(const float* __restrict__ l_sys, const float* __restrict__ l_par,
            const float* __restrict__ l_apr, float* __restrict__ app,
            float* __restrict__ alpha, int n_blocks, int kp) {
  const int s = threadIdx.x & 7;                     // this thread's state
  const int64_t blk = (int64_t)blockIdx.x * (kThreads / 8) + (threadIdx.x >> 3);
  if (blk >= n_blocks) return;                       // the whole group leaves
  const unsigned mask = 0xFFu << (threadIdx.x & 24);

  const float* ls = l_sys + blk * kp;
  const float* lp = l_par + blk * kp;
  const float* la = l_apr + blk * kp;
  float* al = alpha + blk * (int64_t)kp * 8 + s;

  const int s0 = (s >> 2) & 1, s1 = (s >> 1) & 1, s2 = s & 1;
  // forward: the edges into s come from p_e = 2·(s & 3) + e with feedback
  // bit s0 (the new state's most recent bit), input s0 ^ s2 ^ e, parity
  // s0 ^ s1 ^ e
  const int p0 = (s & 3) << 1, p1 = p0 | 1;
  const int in0 = s0 ^ s2, par0 = s0 ^ s1;
  // backward: the edges out of s under input i have feedback bit
  // fb_i = i ^ s1 ^ s2, next state (fb_i << 2) | (s >> 1), parity fb_i ^ s0 ^ s2
  const int fb0 = s1 ^ s2, fb1 = fb0 ^ 1;
  const int ns0 = (fb0 << 2) | (s >> 1), ns1 = (fb1 << 2) | (s >> 1);
  const int pb0 = fb0 ^ s0 ^ s2, pb1 = fb1 ^ s0 ^ s2;

  float cx[kPer], cy[kPer], cz[kPer], nx[kPer], ny[kPer], nz[kPer];
  auto rotate = [&] {
#pragma unroll
    for (int r = 0; r < kPer; ++r) { cx[r] = nx[r]; cy[r] = ny[r]; cz[r] = nz[r]; }
  };

  // forward step k = base + j. Past K' (the last chunk) α goes on unused and
  // unstored, on zero LLRs, so the loop body has no branch.
  float a = s == 0 ? 0.f : kNeg;
  auto forward = [&](int base, int j) {
    const int k = base + j;
    if (k < kp) al[(int64_t)k * 8] = a;
    const float x = __shfl_sync(mask, cx[j >> 3], j & 7, 8);
    const float y = __shfl_sync(mask, cy[j >> 3], j & 7, 8);
    const float z = __shfl_sync(mask, cz[j >> 3], j & 7, 8);
    const float g0 = branch(x, y, z, s0, par0, in0);
    const float g1 = branch(x, y, z, s0, par0 ^ 1, in0 ^ 1);
    const float a0 = __shfl_sync(mask, a, p0, 8);
    const float a1 = __shfl_sync(mask, a, p1, 8);
    a = oplus<kMaxLog>(__fadd_rn(a0, g0), __fadd_rn(a1, g1));
  };
  load_llrs(ls, lp, la, 0, kp, s, cx, cy, cz);
  for (int base = 0; base < kp; base += kChunk) {
    load_llrs(ls, lp, la, base + kChunk, kp, s, nx, ny, nz);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) forward(base, j);
    rotate();
  }

  // α of a chunk, this thread's state: step base + j in ca[j]
  float ca[kChunk], na[kChunk];
  auto load_alpha = [&](int base, float (&v)[kChunk]) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      v[j] = (base >= 0 && base + j < kp) ? al[(int64_t)(base + j) * 8] : 0.f;
  };
  const int last = (kp - 1) / kChunk * kChunk;
  load_llrs(ls, lp, la, last, kp, s, cx, cy, cz);
  load_alpha(last, ca);
  // backward step k = base + j; `tail` (the top chunk alone) keeps β at its
  // start value past K' and writes no APP there
  float b = s == 0 ? 0.f : kNeg;
  float* out = app + blk * kp;
  auto backward = [&](int base, int j, bool tail) {
    const int k = base + j;
    const float x = __shfl_sync(mask, cx[j >> 3], j & 7, 8);
    const float y = __shfl_sync(mask, cy[j >> 3], j & 7, 8);
    const float z = __shfl_sync(mask, cz[j >> 3], j & 7, 8);
    const float g0 = branch(x, y, z, fb0, pb0, 0);
    const float g1 = branch(x, y, z, fb1, pb1, 1);
    const float b0 = __shfl_sync(mask, b, ns0, 8);
    const float b1 = __shfl_sync(mask, b, ns1, 8);
    const float ak = ca[j];
    const float v0 = group_oplus<kMaxLog>(__fadd_rn(__fadd_rn(ak, g0), b0), mask);
    const float v1 = group_oplus<kMaxLog>(__fadd_rn(__fadd_rn(ak, g1), b1), mask);
    const float bk = oplus<kMaxLog>(__fadd_rn(b0, g0), __fadd_rn(b1, g1));
    if (!tail || k < kp) {
      if (s == 0) out[k] = __fsub_rn(v0, v1);
      b = bk;
    }
  };
  for (int base = last; base >= 0; base -= kChunk) {
    load_llrs(ls, lp, la, base - kChunk, kp, s, nx, ny, nz);   // none at base 0
    load_alpha(base - kChunk, na);
    if (base == last) {
#pragma unroll
      for (int j = kChunk - 1; j >= 0; --j) backward(base, j, true);
    } else {
#pragma unroll
      for (int j = kChunk - 1; j >= 0; --j) backward(base, j, false);
    }
    rotate();
#pragma unroll
    for (int j = 0; j < kChunk; ++j) ca[j] = na[j];
  }
}

}  // namespace

// l_sys, l_par, l_apr, app: (n_blocks, kp) float32, contiguous; alpha: a
// scratch of n_blocks·kp·8 floats. Returns the launch's cudaError_t.
extern "C" int turbo_bcjr(const float* l_sys, const float* l_par, const float* l_apr,
                          float* app, float* alpha, int n_blocks, int kp, int max_log,
                          cudaStream_t stream) {
  if (n_blocks <= 0 || kp <= 0) return 0;
  const int per_cta = kThreads / 8;
  const dim3 grid((n_blocks + per_cta - 1) / per_cta);
  if (max_log)
    bcjr_kernel<true><<<grid, kThreads, 0, stream>>>(l_sys, l_par, l_apr, app, alpha,
                                                     n_blocks, kp);
  else
    bcjr_kernel<false><<<grid, kThreads, 0, stream>>>(l_sys, l_par, l_apr, app, alpha,
                                                      n_blocks, kp);
  return (int)cudaGetLastError();
}
