// The time-varying multipath channel of a batch of links in one pass: the
// Jakes taps made in registers, the delayed multiply-adds and the sum over
// the TX antennas.
//
// Replaces none in the JAX package: it fuses the call site of the Jakes tap
// product (channel/rayleigh.jakes_taps, a complex GEMM P @ E through
// ops/cmatmul) with the FIR of channel/rayleigh.apply_multipath (an addcmul_
// pass a tap over a zeroed (rx, tx, lanes, T) buffer) and the sum over TX of
// channel/mimo._multipath_links. For RX leg r, lane b and output sample t:
//
//   y[r, b, t] = Σ_tx Σ_i h_{r,tx,b,i}(t) · x[tx, b, t − d_i]    (x = 0 before 0)
//   h(t)       = g_i · Σ_n P_n · E_n(t // hold),   E_n(t) = exp(j·ω_n·t)
//
// P is the row's 16 scaled Jakes phases (expi(φ)·√(2/16)), E the kept
// sinusoid table (fp32, evaluated on the host), g_i and d_i the profile's
// linear gains and integer delays.
//
// What bounds it. Making a tap is 16 complex MACs a (link, tap, sample), 64
// FFMAs, and the delayed multiply-add 4 more: at 4×4 links × 256 lanes ×
// 30,688 samples × 4 taps that is 34 G FFMA against the 0.5 GB of x and y
// the pass has to move. The CUDA cores' fp32 FMA rate bounds it, not the
// memory, so the design cuts the arithmetic, exactly:
// - Sinusoid folding. With α_n = 2πn/16 the table's rows come in groups
//   whose values are equal or exact conjugates (cos equal, sin negated), bit
//   for bit: ω_1 = ω_15 = −ω_7 = −ω_9, and so on. The host finds the groups
//   in the kept table itself (ops/multipath_fir.sinusoid_fold) and hands the
//   kernel the distinct rows (c_k, s_k) and each n's group and sign σ_n. A
//   block forms A_k = g·Σ_{n∈k} P_n and B_k = g·Σ σ_n·P_n once per row, and
//   a tap is then h = Σ_k c_k·A_k + j·s_k·B_k: 4 FFMAs a group, 24 for the
//   6 groups the cells' Dopplers give (4 groups and 2 single terms), against
//   64. The same sum in another order, not an approximation.
// - A sample's table values are shared by every row: a thread keeps them for
//   its V samples in registers and reuses them over each (rx, tx, tap) row
//   of its lane. The rows' coefficients lie in shared memory, and all the
//   threads of a block read the same one at once (a broadcast).
// - The sums over TX and taps stay in registers: y is written once, and no
//   tap plane, per-TX buffer or zeroed buffer reaches device memory.
//
// Layout. Planar fp32: x (n_tx, lanes, T), P (n_rx, n_tx, lanes, taps, 16),
// the distinct rows c, s (D, Tg) with Tg = T / hold (rows past the groups
// zero, D a template size), y (n_rx, lanes, T). A block owns one lane, a
// chunk of RXC RX legs and kSegment samples; thread j takes the samples
// t0 + v·kThreads + j, v < V, so a warp's loads of x, c and s and its stores
// of y are 128-byte lines. x(t − d_i) comes through L1, which serves the
// taps' overlapping windows. Every sum is an fmaf in a fixed order (TX, then
// taps; within a tap the groups in order), which
// ops/multipath_fir.multipath_fir_plain repeats.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kSinusoids = 16;
constexpr int kMaxTaps = 16;
constexpr int kThreads = 128;
constexpr int kSegment = 2048;          // output samples a block
constexpr int kMaxSmem = 232448;        // dynamic shared memory a block may have

struct Fir {
  int group[kSinusoids];                // sinusoid n -> its row of (c, s)
  int sign[kSinusoids];                 // +1: that row; -1: its conjugate
  int delay[kMaxTaps];
  float gain[kMaxTaps];
};

template <int D, int V, int RXC>
__global__ void __launch_bounds__(kThreads)
multipath_fir_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     const float* __restrict__ pr, const float* __restrict__ pi,
                     const float* __restrict__ cr, const float* __restrict__ ci,
                     float* __restrict__ yr, float* __restrict__ yi, int n_rx, int n_tx,
                     int lanes, int taps, int T, int hold, int Tg, int segments,
                     const Fir fir) {
  extern __shared__ float4 coef[];      // (nr, n_tx, taps, D): A.re, A.im, B.re, B.im
  __shared__ int delay[kMaxTaps];
  __shared__ float gain[kMaxTaps];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) {   // constant indices: the struct stays in params
      delay[j] = fir.delay[j];
      gain[j] = fir.gain[j];
    }
  }
  const int seg = blockIdx.x % segments;
  const int rest = blockIdx.x / segments;
  const int b = rest % lanes;
  const int r0 = (rest / lanes) * RXC;
  const int nr = min(RXC, n_rx - r0);
  const int rows = nr * n_tx * taps;
  __syncthreads();

  // the folded coefficients of the block's rows, each from its 16 phases
  for (int row = threadIdx.x; row < rows; row += kThreads) {
    const int i = row % taps;
    const int tx = (row / taps) % n_tx;
    const int r = r0 + row / (taps * n_tx);
    const size_t base = ((((size_t)r * n_tx + tx) * lanes + b) * taps + i) * kSinusoids;
    float p_r[kSinusoids], p_i[kSinusoids];
#pragma unroll
    for (int n = 0; n < kSinusoids; ++n) {
      p_r[n] = pr[base + n];
      p_i[n] = pi[base + n];
    }
    const float g = gain[i];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float ar = 0.f, ai = 0.f, br = 0.f, bi = 0.f;
#pragma unroll
      for (int n = 0; n < kSinusoids; ++n) {
        if (fir.group[n] == k) {
          ar = __fadd_rn(ar, p_r[n]);
          ai = __fadd_rn(ai, p_i[n]);
          if (fir.sign[n] > 0) {
            br = __fadd_rn(br, p_r[n]);
            bi = __fadd_rn(bi, p_i[n]);
          } else {
            br = __fsub_rn(br, p_r[n]);
            bi = __fsub_rn(bi, p_i[n]);
          }
        }
      }
      coef[row * D + k] = make_float4(__fmul_rn(ar, g), __fmul_rn(ai, g), __fmul_rn(br, g),
                                      __fmul_rn(bi, g));
    }
  }
  __syncthreads();

  const int t_end = min(T, (seg + 1) * kSegment);
  const size_t rx_stride = (size_t)n_tx * taps * D;
  for (int t0 = seg * kSegment; t0 < t_end; t0 += V * kThreads) {
    int t[V];
    bool ok[V];
    float c[D][V], s[D][V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      t[v] = t0 + v * kThreads + threadIdx.x;
      ok[v] = t[v] < t_end;
      const int col = ok[v] ? t[v] / hold : 0;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        c[k][v] = ok[v] ? __ldg(cr + (size_t)k * Tg + col) : 0.f;
        s[k][v] = ok[v] ? __ldg(ci + (size_t)k * Tg + col) : 0.f;
      }
    }
    float acc_r[RXC][V], acc_i[RXC][V];
#pragma unroll
    for (int rl = 0; rl < RXC; ++rl)
#pragma unroll
      for (int v = 0; v < V; ++v) acc_r[rl][v] = acc_i[rl][v] = 0.f;

    for (int tx = 0; tx < n_tx; ++tx) {
      const float* x_r = xr + ((size_t)tx * lanes + b) * T;
      const float* x_i = xi + ((size_t)tx * lanes + b) * T;
      for (int i = 0; i < taps; ++i) {
        const int d = delay[i];
        float xv_r[V], xv_i[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int src = t[v] - d;
          const bool in = ok[v] && src >= 0;
          xv_r[v] = in ? __ldg(x_r + src) : 0.f;
          xv_i[v] = in ? __ldg(x_i + src) : 0.f;
        }
        const float4* q = coef + (size_t)(tx * taps + i) * D;
#pragma unroll
        for (int rl = 0; rl < RXC; ++rl) {
          if (rl < nr) {
            float h_r[V], h_i[V];
#pragma unroll
            for (int v = 0; v < V; ++v) h_r[v] = h_i[v] = 0.f;
#pragma unroll
            for (int k = 0; k < D; ++k) {
              const float4 a = q[rl * rx_stride + k];
#pragma unroll
              for (int v = 0; v < V; ++v) {
                h_r[v] = fmaf(c[k][v], a.x, h_r[v]);
                h_r[v] = fmaf(-s[k][v], a.w, h_r[v]);
                h_i[v] = fmaf(c[k][v], a.y, h_i[v]);
                h_i[v] = fmaf(s[k][v], a.z, h_i[v]);
              }
            }
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc_r[rl][v] = fmaf(h_r[v], xv_r[v], acc_r[rl][v]);
              acc_r[rl][v] = fmaf(-h_i[v], xv_i[v], acc_r[rl][v]);
              acc_i[rl][v] = fmaf(h_r[v], xv_i[v], acc_i[rl][v]);
              acc_i[rl][v] = fmaf(h_i[v], xv_r[v], acc_i[rl][v]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int rl = 0; rl < RXC; ++rl) {
      if (rl < nr) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (ok[v]) {
            const size_t o = ((size_t)(r0 + rl) * lanes + b) * T + t[v];
            yr[o] = acc_r[rl][v];
            yi[o] = acc_i[rl][v];
          }
        }
      }
    }
  }
}

// RX legs a block takes: all of one or two, else chunks of four
int rx_chunk(int n_rx) { return n_rx <= 2 ? n_rx : 4; }

template <int D, int V, int RXC>
int launch(const float* xr, const float* xi, const float* pr, const float* pi, const float* cr,
           const float* ci, float* yr, float* yi, int n_rx, int n_tx, int lanes, int taps, int T,
           int hold, int Tg, const Fir& fir, cudaStream_t stream) {
  const int segments = (T + kSegment - 1) / kSegment;
  const long long blocks = (long long)segments * lanes * ((n_rx + RXC - 1) / RXC);
  const long long smem = (long long)RXC * n_tx * taps * D * (long long)sizeof(float4);
  if (blocks > INT_MAX || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = multipath_fir_kernel<D, V, RXC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      xr, xi, pr, pi, cr, ci, yr, yi, n_rx, n_tx, lanes, taps, T, hold, Tg, segments, fir);
  return (int)cudaGetLastError();
}

template <int D, int V>
int launch_rx(const float* xr, const float* xi, const float* pr, const float* pi,
              const float* cr, const float* ci, float* yr, float* yi, int n_rx, int n_tx,
              int lanes, int taps, int T, int hold, int Tg, const Fir& fir,
              cudaStream_t stream) {
  switch (rx_chunk(n_rx)) {
    case 1:
      return launch<D, V, 1>(xr, xi, pr, pi, cr, ci, yr, yi, n_rx, n_tx, lanes, taps, T, hold,
                             Tg, fir, stream);
    case 2:
      return launch<D, V, 2>(xr, xi, pr, pi, cr, ci, yr, yi, n_rx, n_tx, lanes, taps, T, hold,
                             Tg, fir, stream);
    default:
      return launch<D, V, 4>(xr, xi, pr, pi, cr, ci, yr, yi, n_rx, n_tx, lanes, taps, T, hold,
                             Tg, fir, stream);
  }
}

}  // namespace

// y (n_rx, lanes, T) from x (n_tx, lanes, T), the phase rows P (n_rx, n_tx,
// lanes, taps, 16), the table's distinct rows c, s (groups, Tg) with groups 6
// or 16 (zero rows past those found), the fold (group, sign: 16 each) and the
// profile (delay, gain: taps each, taps ≤ 16). Returns a CUDA error code, 0
// when the kernel was launched.
extern "C" int multipath_fir(const float* xr, const float* xi, const float* pr, const float* pi,
                             const float* cr, const float* ci, float* yr, float* yi, int n_rx,
                             int n_tx, int lanes, int taps, int T, int hold, int Tg, int groups,
                             const int* group, const int* sign, const int* delay,
                             const float* gain, cudaStream_t stream) {
  if (n_rx <= 0 || n_tx <= 0 || lanes <= 0 || T <= 0) return 0;
  if (taps <= 0 || taps > kMaxTaps || hold <= 0 || (long long)Tg * hold != T)
    return (int)cudaErrorInvalidValue;
  Fir fir = {};
  for (int n = 0; n < kSinusoids; ++n) {
    if (group[n] < 0 || group[n] >= groups) return (int)cudaErrorInvalidValue;
    fir.group[n] = group[n];
    fir.sign[n] = sign[n];
  }
  for (int i = 0; i < taps; ++i) {
    fir.delay[i] = delay[i];
    fir.gain[i] = gain[i];
  }
  if (groups == 6)
    return launch_rx<6, 4>(xr, xi, pr, pi, cr, ci, yr, yi, n_rx, n_tx, lanes, taps, T, hold, Tg,
                           fir, stream);
  if (groups == 16)
    return launch_rx<16, 2>(xr, xi, pr, pi, cr, ci, yr, yi, n_rx, n_tx, lanes, taps, T, hold, Tg,
                            fir, stream);
  return (int)cudaErrorInvalidValue;
}
