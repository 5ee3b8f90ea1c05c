// The spatial link's SIC detector in one pass: the effective channel, the
// Gram and matched filter, the SINR order, L masked MMSE stages, the hard
// decisions and the cancellation, all in registers, one thread a site.
//
// Replaces no Pallas kernel: the JAX package runs SIC as a chain of `lax`
// array ops (ofdm_lte_tpu/mimo/detector.sic_planes over the effective
// channel of ofdm_lte_tpu/sim/spatial.py). It fuses the port's plain chain,
// the product heff[rx, l] = Σ_t h_tx[t][rx]·W[t, l] and
// mimo/detector.sic_stacked, which ops/sic_detect.sic_detect_plain runs:
// some 800 launches over (L, L, sites) planes on a card, here one.
//
// A site is one (lane, symbol, layer bin): it reads num_rx received values
// and num_tx·num_rx channel estimates (160 B at 4×4), does a few thousand
// fp32 operations in registers and writes L decisions. What bounds it on
// this card is the bytes: 143.36 MB read at 256 lanes × 14 symbols × 250
// bins, 0.0428 ms at 3.35 TB/s. So each input plane is read once,
// coalesced (the planes are (rx, sites) with the sites minor, thread j of a
// block on site j), nothing in between reaches device memory, and the
// decisions are written once in the (sites, L) layout that the layer demap
// reads as a view.
//
// Rounding. The decisions equal sic_stacked's on the card bit for bit, so
// the kernel repeats its operations one for one, in its order: every
// operation is one of __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which
// nvcc never contracts into an FMA (torch runs each of those operations as a
// kernel of its own, rounding each); each sum over rx, t or layers runs in
// the plane code's order; a complex product is (ar·br − ai·bi, ar·bi +
// ai·br); a division by a Python scalar, which torch's CUDA kernels compute
// as a multiply by its fp32 reciprocal, is that multiply here (the
// quantizer's 1/norm, which the wrapper hands over, and its 1/2). Where the
// two differ at all it is in the sign of a zero (the lower triangle of the
// Gram is the upper's conjugate here, and masked entries are +0 here where
// torch's multiply by 0 keeps the sign), which no decision can see: no
// division of the chain has a zero divisor that a nonzero value does not
// decide. The order breaks SINR ties to the lowest layer index, as
// torch.argmax does.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTx = 8;
constexpr int kThreads = 128;

struct Cf {
  float r, i;
};

__device__ __forceinline__ Cf cmul(Cf a, Cf b) {
  return {__fsub_rn(__fmul_rn(a.r, b.r), __fmul_rn(a.i, b.i)),
          __fadd_rn(__fmul_rn(a.r, b.i), __fmul_rn(a.i, b.r))};
}
__device__ __forceinline__ Cf cadd(Cf a, Cf b) {
  return {__fadd_rn(a.r, b.r), __fadd_rn(a.i, b.i)};
}
__device__ __forceinline__ Cf csub(Cf a, Cf b) {
  return {__fsub_rn(a.r, b.r), __fsub_rn(a.i, b.i)};
}
__device__ __forceinline__ Cf cneg(Cf a) { return {-a.r, -a.i}; }

// detector._reciprocal: (d.re / |d|², −d.im / |d|²)
__device__ __forceinline__ Cf crecip(Cf d) {
  const float n = __fadd_rn(__fmul_rn(d.r, d.r), __fmul_rn(d.i, d.i));
  return {__fdiv_rn(d.r, n), __fdiv_rn(-d.i, n)};
}

// detector._solve2_s: x0 = (G11·z0 − G01·z1)·inv, x1 = (G00·z1 − G10·z0)·inv
__device__ __forceinline__ void solve2(const Cf (&G)[2][2], const Cf (&z)[2], Cf (&x)[2]) {
  const Cf inv = crecip(csub(cmul(G[0][0], G[1][1]), cmul(G[0][1], G[1][0])));
  x[0] = cmul(csub(cmul(G[1][1], z[0]), cmul(G[0][1], z[1])), inv);
  x[1] = cmul(csub(cmul(G[0][0], z[1]), cmul(G[1][0], z[0])), inv);
}

// detector._solve4_s: the 2×2-block Schur complement, each block operation
// in the order of _m2_inv_s, _m2_vec_s and _m2_mul_s
__device__ __forceinline__ void solve4(const Cf (&G)[4][4], const Cf (&z)[4], Cf (&x)[4]) {
  Cf Ainv[2][2];
  {
    const Cf inv = crecip(csub(cmul(G[0][0], G[1][1]), cmul(G[0][1], G[1][0])));
    Ainv[0][0] = cmul(G[1][1], inv);
    Ainv[0][1] = cneg(cmul(G[0][1], inv));
    Ainv[1][0] = cneg(cmul(G[1][0], inv));
    Ainv[1][1] = cmul(G[0][0], inv);
  }
  Cf b1[2], AinvB[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    b1[i] = cadd(cmul(Ainv[i][0], z[0]), cmul(Ainv[i][1], z[1]));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      AinvB[i][j] = cadd(cmul(Ainv[i][0], G[0][2 + j]), cmul(Ainv[i][1], G[1][2 + j]));
  }
  Cf S[2][2], rhs[2], x2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      S[i][j] = csub(G[2 + i][2 + j],
                     cadd(cmul(G[2 + i][0], AinvB[0][j]), cmul(G[2 + i][1], AinvB[1][j])));
    rhs[i] = csub(z[2 + i], cadd(cmul(G[2 + i][0], b1[0]), cmul(G[2 + i][1], b1[1])));
  }
  solve2(S, rhs, x2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[i] = csub(b1[i], cadd(cmul(AinvB[i][0], x2[0]), cmul(AinvB[i][1], x2[1])));
    x[2 + i] = x2[i];
  }
}

// detector._solve_s for L in 1..4: L = 3 pads to the 4×4 path with a
// decoupled unit fourth equation
template <int L>
__device__ __forceinline__ void solve(const Cf (&G)[L][L], const Cf (&z)[L], Cf (&x)[L]) {
  if constexpr (L == 1) {
    x[0] = cmul(z[0], crecip(G[0][0]));
  } else if constexpr (L == 2) {
    solve2(G, z, x);
  } else {
    Cf G4[4][4], z4[4], x4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        G4[i][j] = (i < L && j < L) ? G[i < L ? i : 0][j < L ? j : 0] : Cf{0.f, 0.f};
      z4[i] = i < L ? z[i < L ? i : 0] : Cf{0.f, 0.f};
    }
    if constexpr (L == 3) G4[3][3] = Cf{1.f, 0.f};
    solve4(G4, z4, x4);
#pragma unroll
    for (int i = 0; i < L; ++i) x[i] = x4[i];
  }
}

// qam.detect on one axis: Q levels; QPSK (Q = 2) is the sign (index 0 is +1,
// a tie at 0 goes to it), else round((x·norm + Q − 1)/2) clamped to the
// levels, level 2q − (Q − 1); the level times 1/norm
template <int Q>
__device__ __forceinline__ float quantize(float x, float norm, float inv_norm) {
  if constexpr (Q == 2) {
    return __fmul_rn(x < 0.f ? -1.f : 1.f, inv_norm);
  } else {
    float q = rintf(__fmul_rn(__fadd_rn(__fmul_rn(x, norm), (float)(Q - 1)), 0.5f));
    q = fminf(fmaxf(q, 0.f), (float)(Q - 1));     // a NaN goes to index 0, as torch's cast
    return __fmul_rn((float)(2 * (int)q - (Q - 1)), inv_norm);
  }
}

struct Channel {
  const float* hr[kMaxTx];    // h_tx[t] real planes, (num_rx, sites)
  const float* hi[kMaxTx];
};

template <int L, int Q>
__global__ void __launch_bounds__(kThreads)
sic_detect_kernel(const float* __restrict__ yr, const float* __restrict__ yi, const Channel ch,
                  const float* __restrict__ wr, const float* __restrict__ wi,
                  const float* __restrict__ s2v, float s2_scalar, int s2_per,
                  float* __restrict__ outr, float* __restrict__ outi, int num_rx, int num_tx,
                  int sites, float norm, float inv_norm) {
  __shared__ float w_r[kMaxTx * L], w_i[kMaxTx * L];
  for (int k = threadIdx.x; k < num_tx * L; k += kThreads) {
    w_r[k] = wr[k];
    w_i[k] = wi[k];
  }
  __syncthreads();
  const int site = blockIdx.x * kThreads + threadIdx.x;
  if (site >= sites) return;
  const float s2 = s2v != nullptr ? __ldg(s2v + site / s2_per) : s2_scalar;

  // the base Gram's upper triangle and the matched filter, summed over rx in
  // rx order, of heff[rx, l] = Σ_t h[t][rx]·W[t, l] summed in t order
  Cf g[L][L] = {}, z[L] = {};
  for (int r = 0; r < num_rx; ++r) {
    const size_t o = (size_t)r * sites + site;
    const Cf y = {__ldg(yr + o), __ldg(yi + o)};
    Cf h[L] = {};
#pragma unroll
    for (int t = 0; t < kMaxTx; ++t) {
      if (t < num_tx) {
        const Cf x = {__ldg(ch.hr[t] + o), __ldg(ch.hi[t] + o)};
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const Cf term = cmul(x, Cf{w_r[t * L + l], w_i[t * L + l]});
          h[l] = t == 0 ? term : cadd(h[l], term);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      // conj(h_i)·h_j and conj(h_i)·y
#pragma unroll
      for (int j = i; j < L; ++j) {
        const Cf term = {__fadd_rn(__fmul_rn(h[i].r, h[j].r), __fmul_rn(h[i].i, h[j].i)),
                         __fsub_rn(__fmul_rn(h[i].r, h[j].i), __fmul_rn(h[i].i, h[j].r))};
        g[i][j] = r == 0 ? term : cadd(g[i][j], term);
      }
      const Cf term = {__fadd_rn(__fmul_rn(h[i].r, y.r), __fmul_rn(h[i].i, y.i)),
                       __fsub_rn(__fmul_rn(h[i].r, y.i), __fmul_rn(h[i].i, y.r))};
      z[i] = r == 0 ? term : cadd(z[i], term);
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) g[i][j] = Cf{g[j][i].r, -g[j][i].i};

  // the order: SINR_l = p_l / (total − p_l + σ² + 1e-10) of the column powers
  float sinr[L];
  {
    float total = g[0][0].r;
#pragma unroll
    for (int l = 1; l < L; ++l) total = __fadd_rn(total, g[l][l].r);
#pragma unroll
    for (int l = 0; l < L; ++l)
      sinr[l] = __fdiv_rn(g[l][l].r,
                          __fadd_rn(__fadd_rn(__fsub_rn(total, g[l][l].r), s2), (float)1e-10));
  }

  bool active[L];
  Cf s_hat[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    active[l] = true;
    s_hat[l] = Cf{0.f, 0.f};
  }
#pragma unroll
  for (int stage = 0; stage < L; ++stage) {
    // the strongest active layer, the lowest index on a tie
    int sel = -1;
    float best = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (active[l] && (sel < 0 || sinr[l] > best)) {
        sel = l;
        best = sinr[l];
      }
    }
    // the masked system: inactive rows and columns zero, their diagonal σ² + 1
    Cf G[L][L], zm[L], s_all[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
#pragma unroll
      for (int j = 0; j < L; ++j)
        G[i][j] = (active[i] && active[j]) ? g[i][j] : Cf{0.f, 0.f};
      G[i][i] = active[i] ? Cf{__fadd_rn(g[i][i].r, s2), g[i][i].i}
                          : Cf{__fadd_rn(s2, 1.f), 0.f};
      zm[i] = active[i] ? z[i] : Cf{0.f, 0.f};
    }
    solve<L>(G, zm, s_all);
    Cf s = s_all[0];
#pragma unroll
    for (int l = 1; l < L; ++l)
      if (sel == l) s = s_all[l];
    const Cf hard = {quantize<Q>(s.r, norm, inv_norm), quantize<Q>(s.i, norm, inv_norm)};
    // cancel in the Gram domain against the original columns:
    // z_i ← z_i − g[i][sel]·ŝ
#pragma unroll
    for (int i = 0; i < L; ++i) {
      Cf gs = g[i][0];
#pragma unroll
      for (int l = 1; l < L; ++l)
        if (sel == l) gs = g[i][l];
      z[i] = csub(z[i], cmul(gs, hard));
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (sel == l) {
        s_hat[l] = hard;
        active[l] = false;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    outr[(size_t)site * L + l] = s_hat[l].r;
    outi[(size_t)site * L + l] = s_hat[l].i;
  }
}

template <int L, int Q>
int launch(const float* yr, const float* yi, const Channel& ch, const float* wr, const float* wi,
           const float* s2v, float s2_scalar, int s2_per, float* outr, float* outi, int num_rx,
           int num_tx, int sites, float norm, float inv_norm, cudaStream_t stream) {
  const int blocks = (sites + kThreads - 1) / kThreads;
  sic_detect_kernel<L, Q><<<blocks, kThreads, 0, stream>>>(
      yr, yi, ch, wr, wi, s2v, s2_scalar, s2_per, outr, outi, num_rx, num_tx, sites, norm,
      inv_norm);
  return (int)cudaGetLastError();
}

template <int L>
int launch_levels(int levels, const float* yr, const float* yi, const Channel& ch,
                  const float* wr, const float* wi, const float* s2v, float s2_scalar,
                  int s2_per, float* outr, float* outi, int num_rx, int num_tx, int sites,
                  float norm, float inv_norm, cudaStream_t stream) {
  switch (levels) {
    case 2:
      return launch<L, 2>(yr, yi, ch, wr, wi, s2v, s2_scalar, s2_per, outr, outi, num_rx,
                          num_tx, sites, norm, inv_norm, stream);
    case 4:
      return launch<L, 4>(yr, yi, ch, wr, wi, s2v, s2_scalar, s2_per, outr, outi, num_rx,
                          num_tx, sites, norm, inv_norm, stream);
    case 8:
      return launch<L, 8>(yr, yi, ch, wr, wi, s2v, s2_scalar, s2_per, outr, outi, num_rx,
                          num_tx, sites, norm, inv_norm, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The L hard decisions (sites, L) of the received planes y (num_rx, sites),
// the per-TX channel planes h_tx[t] (num_rx, sites), t < num_tx ≤ 8, and the
// precoder W (num_tx, L) on the card; σ² one value for every site (s2v null)
// or s2v[site / s2_per]; `levels` the constellation's levels an axis (2, 4,
// 8) and norm, inv_norm its scale and the fp32 reciprocal of it. Returns a
// CUDA error code, 0 when the kernel was launched.
extern "C" int sic_detect(const float* yr, const float* yi, const void* const* hr,
                          const void* const* hi, const float* wr, const float* wi,
                          const float* s2v, float s2_scalar, int s2_per, float* outr,
                          float* outi, int num_rx, int num_tx, int L, int levels, int sites,
                          float norm, float inv_norm, cudaStream_t stream) {
  if (sites <= 0) return 0;
  if (num_rx < 1 || num_tx < 1 || num_tx > kMaxTx || s2_per < 1)
    return (int)cudaErrorInvalidValue;
  Channel ch = {};
  for (int t = 0; t < num_tx; ++t) {
    ch.hr[t] = static_cast<const float*>(hr[t]);
    ch.hi[t] = static_cast<const float*>(hi[t]);
  }
  switch (L) {
    case 1:
      return launch_levels<1>(levels, yr, yi, ch, wr, wi, s2v, s2_scalar, s2_per, outr, outi,
                              num_rx, num_tx, sites, norm, inv_norm, stream);
    case 2:
      return launch_levels<2>(levels, yr, yi, ch, wr, wi, s2v, s2_scalar, s2_per, outr, outi,
                              num_rx, num_tx, sites, norm, inv_norm, stream);
    case 3:
      return launch_levels<3>(levels, yr, yi, ch, wr, wi, s2v, s2_scalar, s2_per, outr, outi,
                              num_rx, num_tx, sites, norm, inv_norm, stream);
    case 4:
      return launch_levels<4>(levels, yr, yi, ch, wr, wi, s2v, s2_scalar, s2_per, outr, outi,
                              num_rx, num_tx, sites, norm, inv_norm, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
