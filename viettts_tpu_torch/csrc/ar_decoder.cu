// The autoregressive acoustic-decoder loop (K1): the whole decode in one
// persistent launch over a grid of co-resident CTAs.
//
// Replaces the TPU kernel viettts_tpu/ops/ar_decoder.py::ar_decode
// (_ar_kernel), which kept every decoder weight resident in VMEM and
// streamed the conditioning gates chunk by chunk through its sequential
// grid.  Per frame t:
//
//   p1 = relu(mel_{t-1} @ Wfc1) * keep1_t * s        p = relu(p1 @ Wfc2) * keep2_t * s
//   g1 = g1c_t + [p, h1] @ W1m -> (h1, c1)           g2 = g2c_t + [p, h1', h2] @ W2m -> (h2, c2)
//   mel_t = [h1', h2'] @ Wp + b
//
// What bounds it on the H100: the frames are strictly sequential and each
// frame is a chain of dependent matrix-vector products over 17.45 MB of
// float32 weights (H=512, P=256, D=80), ~8.7 MFLOP at B=1: ~0.13 us of the
// card's float32 peak.  One SM streaming those weights from L2 every frame
// took ~340 us a frame.  Spread over the grid with the weights resident,
// what is left is latency: for each of the 5 dependent phases of a frame,
// one grid-wide hand-off through L2 (a producer's store reaching L2, a
// consumer's load coming back), times the frames.
//
// Design.  G CTAs (one per SM at most: 128 at H=512 on 132 SMs), each
// owning U hidden units (4 at H=512; 5 on a 114-SM card, the last CTA
// partly empty), hold all four gate columns of their units for both
// LSTM layers in shared memory for the whole launch (131 KB at H=512, U=4),
// plus their columns of the prenet weights and of the projection: the
// 17.45 MB are spread over the grid and loaded once per launch, so no
// weight byte moves in the frame loop.  The vectors that cross CTAs go
// through a global exchange buffer:
//
//   A  [h1, h2] -> mel_{t-1} (projection columns; also written out)
//   B  mel -> p1 (prenet 1 columns)       C  p1 -> p (prenet 2 columns)
//   D  p -> LSTM 1 gates of own units -> h1', c1
//   E  h1' -> LSTM 2 gates of own units -> h2', c2
//
// The grid barrier between dependent phases is the data itself: every
// exchanged value is one 64-bit word, float bits and the frame number
// (+1), stored and loaded relaxed at GPU scope (single-copy atomic, never
// a stale L1 line), and a reader spins on its words until all carry the
// frame it waits for, so a hand-off costs one L2 round trip and no
// separate barrier.  Buffers alternate by frame parity; a CTA can only
// reach frame t + 2 after every CTA has published frame t + 1's h, which
// each publishes after its last read of frame t's buffers, so no value is
// overwritten before it is read.  Work that does not feed the next phase
// runs after a CTA has published (h2 @ Wh2 after A, p @ W2p after D,
// h1' @ Wh1 for the next frame after E) and is kept, with the
// conditioning gates, as gate partial sums in shared memory beside the
// cell states.  A CTA's own work per phase is a chain of latencies
// (shared-memory loads, a shuffle tree, barriers), so the weights are
// stored column by column and a warp sums whole columns (up to 3 of the
// 4U gate columns a warp) in 16-byte loads, everything is inlined and the
// CTA has 256 threads, which leaves the registers to avoid spills.  The
// kernel is instantiated per U (1..kMaxUnits), so that splitting a gate
// column index into gate and unit is a division by a constant.  The rows
// a CTA stages at once (S) and the rows of its gate sums and cell states
// (R, the launch's batch) size its shared memory, so a plan fits the
// batch it runs.  Every dot is summed in a fixed order inside one CTA:
// the same inputs give the same bits.  expf/tanhf without fast-math keep
// parity with the plain PyTorch loop.  Spinning needs every CTA resident:
// the launch is cooperative (a cooperative node when a CUDA graph captures
// it) and refused (never shrunk) when the occupancy does not allow G CTAs
// on the card; ``viettts_ar_decode_prepare`` opts the kernel in to its
// shared memory and checks that occupancy once per device and plan,
// outside any capture.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 16;    // batch rows staged at once, at most
constexpr int kChunk = 8;     // batch rows summed per matrix-vector pass
constexpr int kRows = 64;     // batch rows per launch (gate sums and c stay in shared memory)
constexpr int kMaxUnits = 6;  // hidden units per CTA: 4U gate columns, at most 3 a warp
static_assert(4 * kMaxUnits <= 3 * kWarps, "gate columns per warp");

typedef unsigned long long word;  // float bits | frame tag << 32

struct Dims {
  int B, L, H, P, D;
  int G, PK, DK;  // CTAs, prenet / projection columns per CTA
  int S;          // batch rows staged at once
  float scale;
};

__host__ __device__ inline int max3(int a, int b, int c) {
  const int m = a > b ? a : b;
  return m > c ? m : c;
}

// n floats rounded up to whole 16-byte words
__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) & ~(size_t)3; }

// floats of dynamic shared memory for U units, PK / DK columns, S staged
// rows and R rows of state; ops/ar_decoder.py::plan_decode mirrors it
__host__ __device__ inline size_t smem_floats(int H, int P, int D, int U, int PK, int DK, int S, int R) {
  const size_t nc = 4 * (size_t)U, ncm = max3(4 * U, PK, DK);
  return pad4((size_t)S * max3(2 * H, P, D)) + (size_t)kWarps * kChunk + pad4((size_t)S * ncm) +
         (size_t)R * 2 * nc + pad4((size_t)R * 2 * U) + ((size_t)(P + H) + (P + 2 * H)) * nc +
         (size_t)(D + P) * PK + (size_t)(2 * H + 1) * DK;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void publish(word* p, float v, unsigned tag) {
  const word w = ((word)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ word peek(const word* p) {
  word w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// xs[b * K + k] = the value of src[(b0 + b) * ld + k] once it carries
// `tag`, for b < nb, k < K.  Each thread spins on its own words, kIlp
// loads in flight, re-reading only those that have not arrived.
__device__ __forceinline__ void gather(float* xs, const word* src, int ld, int b0, int nb, int K, unsigned tag) {
  constexpr int kIlp = 4;
  const int n = nb * K;
  for (int i0 = threadIdx.x; i0 < n; i0 += kIlp * kThreads) {
    const word* at[kIlp];
    unsigned pending = 0;
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int i = i0 + u * kThreads, b = nb == 1 ? 0 : i / K;
      at[u] = src + (size_t)(b0 + b) * ld + (i - b * K);
      if (i < n) pending |= 1u << u;
    }
    word w[kIlp];
    while (pending) {
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        if (pending >> u & 1) w[u] = peek(at[u]);
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        if ((pending >> u & 1) && (unsigned)(w[u] >> 32) == tag) {
          xs[i0 + u * kThreads] = __uint_as_float((unsigned)w[u]);
          pending &= ~(1u << u);
        }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int log2i(int pow2) { return __ffs(pow2) - 1; }

// res[b * NC + c] = sum_k xs[b * ldx + k] * Wt[c * K + k] for b < nb <= NB,
// c < NC, the weights stored column by column.  Below kWarps columns (NC
// a power of two) each column is split over kWarps / NC warps, each
// summing one part of the rows; from kWarps columns on, warp w sums the
// CPW columns from w * CPW (CPW * kWarps >= NC; columns past NC repeat
// the last one and are not stored).  Each lane takes 4 rows at a time in
// 16-byte loads of the columns and of each staged row when they are
// aligned; a shuffle tree sums the lanes, then the parts add in order.
// Fixed order: the same inputs give the same bits.
template <int NB, int CPW>
__device__ __forceinline__ void matvec_nb(const float* xs, int ldx, int nb, const float* Wt, int NC,
                                          int K, float* red, float* res) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lgw = NC < kWarps ? log2i(kWarps) - log2i(NC) : 0;  // log2 of the parts per column
  const int part = warp & ((1 << lgw) - 1), c0 = (warp >> lgw) * CPW;
  const int span = (((K + (1 << lgw) - 1) >> lgw) + 3) & ~3;
  const int k_lo = min(K, part * span), k_hi = min(K, k_lo + span);
  const bool vec = ((reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(Wt) |
                     (unsigned)ldx * 4u | (unsigned)K * 4u) & 15) == 0;
  const float* col[CPW];
#pragma unroll
  for (int j = 0; j < CPW; ++j) col[j] = Wt + (size_t)min(c0 + j, NC - 1) * K;
  float acc[CPW][NB];
#pragma unroll
  for (int j = 0; j < CPW; ++j)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[j][b] = 0.f;
  // whole 128-row blocks in 16-byte steps, then one row per lane
  const int k_vec = vec ? k_lo + ((k_hi - k_lo) & ~127) : k_lo;
#pragma unroll 2
  for (int k = k_lo + 4 * lane; k < k_vec; k += 128) {
    float4 wv[CPW];
#pragma unroll
    for (int j = 0; j < CPW; ++j) wv[j] = *reinterpret_cast<const float4*>(col[j] + k);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float4 x = *reinterpret_cast<const float4*>(xs + b * ldx + k);
#pragma unroll
      for (int j = 0; j < CPW; ++j)
        acc[j][b] = fmaf(x.w, wv[j].w, fmaf(x.z, wv[j].z, fmaf(x.y, wv[j].y, fmaf(x.x, wv[j].x, acc[j][b]))));
    }
  }
  for (int k = k_vec + lane; k < k_hi; k += 32) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float x = xs[b * ldx + k];
#pragma unroll
      for (int j = 0; j < CPW; ++j) acc[j][b] = fmaf(x, col[j][k], acc[j][b]);
    }
  }
#pragma unroll
  for (int j = 0; j < CPW; ++j)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[j][b] += __shfl_xor_sync(0xffffffffu, acc[j][b], off);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < CPW; ++j)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (b < nb && c0 + j < NC) {
          if (lgw == 0)
            res[b * NC + c0 + j] = acc[j][b];
          else
            red[(part * NB + b) * NC + c0 + j] = acc[j][b];
        }
  }
  __syncthreads();
  if (lgw > 0) {
    const int t = threadIdx.x;
    if (t < nb * NC) {
      float s = 0.f;
      for (int i = 0; i < (1 << lgw); ++i) s += red[i * NB * NC + t];
      res[t] = s;
    }
    __syncthreads();
  }
}

// the same for nb <= kStage rows, in passes of up to kChunk rows
template <int CPW>
__device__ __forceinline__ void matvec(const float* xs, int ldx, int nb, const float* Wt, int NC,
                                       int K, float* red, float* res) {
  for (int p0 = 0; p0 < nb; p0 += kChunk) {
    const int n = min(kChunk, nb - p0);
    const float* x = xs + p0 * ldx;
    float* r = res + p0 * NC;
    if (n == 1)
      matvec_nb<1, CPW>(x, ldx, 1, Wt, NC, K, red, r);
    else
      matvec_nb<kChunk, CPW>(x, ldx, n, Wt, NC, K, red, r);
  }
}

// NC a power of two <= 2 * kWarps (the prenet and projection columns)
__device__ __forceinline__ void matvec_pow2(const float* xs, int ldx, int nb, const float* Wt, int NC,
                                            int K, float* red, float* res) {
  if (NC > kWarps)
    matvec<2>(xs, ldx, nb, Wt, NC, K, red, res);
  else
    matvec<1>(xs, ldx, nb, Wt, NC, K, red, res);
}

template <int U>
__global__ void __launch_bounds__(kThreads, 1) ar_decode_grid(
    const float* __restrict__ g1c,      // [B, L, 4H]
    const float* __restrict__ g2c,      // [B, L, 4H]
    const uint8_t* __restrict__ keep1,  // [L, B, P] (bool)
    const uint8_t* __restrict__ keep2,  // [L, B, P]
    const float* __restrict__ w_fc1,    // [D, P]
    const float* __restrict__ w_fc2,    // [P, P]
    const float* __restrict__ w1m,      // [P + H, 4H]
    const float* __restrict__ w2m,      // [P + 2H, 4H]
    const float* __restrict__ wp,       // [2H, D]
    const float* __restrict__ bp,       // [D]
    float* __restrict__ out,            // [B, L, D]
    word* exchange,                     // 2 parities x [h1 | h2, mel, p1, p], zeroed
    Dims d) {
  constexpr int NC = 4 * U;                           // gate columns of the CTA
  constexpr int CPW = (NC + kWarps - 1) / kWarps;     // of them per warp
  extern __shared__ __align__(16) float sm[];
  const int B = d.B, L = d.L, H = d.H, P = d.P, D = d.D, G = d.G, S = d.S;
  const int PK = d.PK, DK = d.DK, H2 = 2 * H, H4 = 4 * H;
  const int lgPK = log2i(PK), lgDK = log2i(DK);
  const int cta = blockIdx.x, tid = threadIdx.x, j0 = cta * U;

  // shared memory: the staged vector and the sums, gate partial sums and
  // cell states, then the resident weights, column by column
  float* xs = sm;                                          // [S][max(2H, P, D)]
  float* red = xs + pad4((size_t)S * max3(H2, P, D));      // [kWarps * kChunk] partial sums
  float* res = red + kWarps * kChunk;                      // [S][max(NC, PK, DK)]
  float* Rs = res + pad4((size_t)S * max3(NC, PK, DK));    // [B][2][NC] gate sums, layer 1 | layer 2
  float* Cs = Rs + (size_t)B * 2 * NC;                     // [B][2][U]  cell states
  float* WD = Cs + pad4((size_t)B * 2 * U);                // [2NC][P]: w1m | w2m rows of p, own gate columns
  float* WE = WD + 2 * NC * P;                             // [2NC][H]: w2m rows of h1' | w1m rows of h1
  float* W2h = WE + 2 * NC * H;                            // [NC][H]:  w2m rows of h2
  float* F1 = W2h + NC * H;                                // [PK][D] prenet 1 columns cta + c * G
  float* F2 = F1 + PK * D;                                 // [PK][P] prenet 2 columns
  float* WP = F2 + PK * P;                                 // [DK][2H] projection columns cta + c * G
  float* BPs = WP + DK * H2;                               // [DK]

  // exchange of parity q: [B][2H] h1 | h2, [B][D] mel, [B][P] p1, [B][P] p
  const size_t per_parity = (size_t)B * (H2 + D + 2 * P);
  auto hx = [&](int q) { return exchange + q * per_parity; };
  auto melx = [&](int q) { return hx(q) + (size_t)B * H2; };
  auto p1x = [&](int q) { return melx(q) + (size_t)B * D; };
  auto px = [&](int q) { return p1x(q) + (size_t)B * P; };

  // local gate column c = gate * U + u is global column gate * H + j0 + u;
  // the last CTA's units past H are empty
  auto gcol = [&](int c) { return (c / U) * H + j0 + c % U; };
  auto own = [&](int c) { return j0 + c % U < H; };

  // one-time weight load: dst[c][r] = src[r0 + r][gate column c] for r < K
  auto load_gates = [&](float* dst, const float* src, int r0, int K) {
    for (int i = tid; i < K * NC; i += kThreads) {
      const int r = i / NC, c = i % NC;
      dst[c * K + r] = own(c) ? src[(size_t)(r0 + r) * H4 + gcol(c)] : 0.f;
    }
  };
  // dst[c][r] = src[r][cta + c * G] (0 past n columns) for r < K, c < 2^lg
  auto load_cols = [&](float* dst, const float* src, int n, int K, int lg) {
    for (int i = tid; i < K << lg; i += kThreads) {
      const int r = i >> lg, c = i & ((1 << lg) - 1), col = cta + c * G;
      dst[c * K + r] = col < n ? src[(size_t)r * n + col] : 0.f;
    }
  };
  load_gates(WD, w1m, 0, P);
  load_gates(WD + NC * P, w2m, 0, P);
  load_gates(WE, w2m, P, H);
  load_gates(WE + NC * H, w1m, P, H);
  load_gates(W2h, w2m, P + H, H);
  load_cols(F1, w_fc1, P, D, lgPK);
  load_cols(F2, w_fc2, P, P, lgPK);
  load_cols(WP, wp, D, H2, lgDK);
  for (int c = tid; c < DK; c += kThreads) BPs[c] = cta + c * G < D ? bp[cta + c * G] : 0.f;
  // frame 0 starts from zero state: its gate sums are the conditioning gates
  for (int i = tid; i < B * NC; i += kThreads) {
    const int b = i / NC, c = i % NC;
    const size_t g = (size_t)b * L * H4 + gcol(c);
    Rs[(b * 2 + 0) * NC + c] = own(c) ? g1c[g] : 0.f;
    Rs[(b * 2 + 1) * NC + c] = own(c) ? g2c[g] : 0.f;
  }
  for (int i = tid; i < B * 2 * U; i += kThreads) Cs[i] = 0.f;
  __syncthreads();

  // A: mel_{t-1} = [h1, h2] @ Wp + b from frame t-1's h (tag t), published
  // for frame t; then R2 = g2c_t + h2 @ Wh2
  auto project = [&](int t) {
    for (int b0 = 0; b0 < B; b0 += S) {
      const int nb = min(S, B - b0);
      gather(xs, hx((t - 1) & 1), H2, b0, nb, H2, t);
      if (cta < D) {
        matvec_pow2(xs, H2, nb, WP, DK, H2, red, res);
        if (tid < (nb << lgDK)) {
          const int bl = tid >> lgDK, c = tid & (DK - 1), col = cta + c * G;
          if (col < D) {
            const float v = res[tid] + BPs[c];
            if (t < L) publish(melx(t & 1) + (size_t)(b0 + bl) * D + col, v, t + 1);
            out[((size_t)(b0 + bl) * L + t - 1) * D + col] = v;
          }
        }
      }
      if (t == L) continue;
      const int b = b0 + tid / NC, c = tid % NC;
      const bool mine = tid < nb * NC;
      const float cond = mine && own(c) ? g2c[((size_t)b * L + t) * H4 + gcol(c)] : 0.f;
      __syncthreads();  // res is read above
      matvec<CPW>(xs + H, H2, nb, W2h, NC, H, red, res);
      if (mine) Rs[(b * 2 + 1) * NC + c] = cond + res[tid];
    }
  };

  // B, C: relu(x @ F) * keep_t * s for own prenet columns (x = 0 without src)
  auto prenet = [&](int t, const word* src, int K, const float* F, const uint8_t* keep, word* dst) {
    for (int b0 = 0; b0 < B; b0 += S) {
      const int nb = min(S, B - b0);
      const int bl = tid >> lgPK, col = cta + (tid & (PK - 1)) * G;
      const bool mine = tid < (nb << lgPK) && col < P;
      const size_t at = (size_t)(b0 + bl) * P + col;
      const bool kept = mine && keep[(size_t)t * B * P + at];  // loads while the input arrives
      if (src) {
        gather(xs, src, K, b0, nb, K, t + 1);
      } else {
        for (int i = tid; i < nb * K; i += kThreads) xs[i] = 0.f;
        __syncthreads();
      }
      matvec_pow2(xs, K, nb, F, PK, K, red, res);
      if (mine) publish(dst + at, kept ? fmaxf(res[tid], 0.f) * d.scale : 0.f, t + 1);
    }
  };

  // D (layer 0), E (layer 1): gates = x @ W[:NC] + Rs[layer] -> cell
  // update of own units -> h published (tag t + 1); then, from the same
  // x, the other layer's partial sums x @ W[NC:]: D: R2 += p @ W2p,
  // E: R1 = g1c_{t+1} + h1' @ Wh1.
  auto lstm = [&](int t, const word* src, int ld, int K, const float* W, int layer) {
    for (int b0 = 0; b0 < B; b0 += S) {
      const int nb = min(S, B - b0);
      const int b = b0 + tid / NC, c = tid % NC;
      const bool mine = tid < nb * NC;
      const bool next = layer == 1 && t + 1 < L;
      const float cond = mine && next && own(c) ? g1c[((size_t)b * L + t + 1) * H4 + gcol(c)] : 0.f;
      gather(xs, src, ld, b0, nb, K, t + 1);
      matvec<CPW>(xs, K, nb, W, NC, K, red, res);
      if (mine) res[tid] += Rs[(b * 2 + layer) * NC + c];
      __syncthreads();
      if (tid < nb * U) {
        const int bl = tid / U, u = tid % U, j = j0 + u;
        if (j < H) {
          const float* g = res + bl * NC;
          float* cs = Cs + ((b0 + bl) * 2 + layer) * U + u;
          const float cn = sigmoid(g[2 * U + u] + 1.f) * *cs + sigmoid(g[u]) * tanhf(g[U + u]);
          *cs = cn;
          publish(hx(t & 1) + (size_t)(b0 + bl) * H2 + layer * H + j,
                  sigmoid(g[3 * U + u]) * tanhf(cn), t + 1);
        }
      }
      if (layer == 1 && !next) continue;
      __syncthreads();
      matvec<CPW>(xs, K, nb, W + NC * K, NC, K, red, res);
      if (mine) {
        float* other = Rs + (b * 2 + 1 - layer) * NC + c;
        *other = (layer == 0 ? *other : cond) + res[tid];
      }
    }
  };

  for (int t = 0; t < L; ++t) {
    const int q = t & 1;
    if (t > 0) project(t);
    if (cta < P) {
      prenet(t, t > 0 ? melx(q) : nullptr, D, F1, keep1, p1x(q));
      prenet(t, p1x(q), P, F2, keep2, px(q));
    }
    lstm(t, px(q), P, P, WD, 0);
    lstm(t, hx(q), H2, H, WE, 1);
  }
  project(L);
}

typedef void (*Kernel)(const float*, const float*, const uint8_t*, const uint8_t*, const float*,
                       const float*, const float*, const float*, const float*, const float*, float*,
                       word*, Dims);

Kernel kernel_for(int U) {
  switch (U) {
    case 1: return ar_decode_grid<1>;
    case 2: return ar_decode_grid<2>;
    case 3: return ar_decode_grid<3>;
    case 4: return ar_decode_grid<4>;
    case 5: return ar_decode_grid<5>;
    case 6: return ar_decode_grid<6>;
    default: return nullptr;
  }
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// The plan's shapes as the kernel takes them: a grid that covers H with
// its last CTA non-empty, per-CTA counts it is instantiated for, one
// output per thread for S staged rows, and the shared memory the plan
// claims.
bool valid_plan(int B, int H, int P, int D, int G, int U, int PK, int DK, int S, int R, int smem_bytes) {
  return B >= 1 && B <= R && R <= kRows && S >= 1 && S <= kStage && S <= R && G * U >= H &&
         (G - 1) * U < H && U >= 1 && U <= kMaxUnits && pow2(PK) && pow2(DK) &&
         PK <= 2 * kWarps && DK <= 2 * kWarps && S * max3(4 * U, PK, DK) <= kThreads &&
         (size_t)smem_bytes == sizeof(float) * smem_floats(H, P, D, U, PK, DK, S, R);
}

}  // namespace

// Opt the kernel for plan (G, U, ..., R) in to the largest dynamic shared
// memory of the current device and check that G CTAs of smem_bytes can be
// co-resident.  Call it once per device and plan, outside any stream
// capture, before viettts_ar_decode launches that plan.
extern "C" int viettts_ar_decode_prepare(int H, int P, int D, int G, int U, int PK, int DK, int S,
                                         int R, int smem_bytes) {
  if (!valid_plan(1, H, P, D, G, U, PK, DK, S, R, smem_bytes)) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(U);
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem_bytes > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  // the CTAs spin on each other's results: all must be resident; refuse, never shrink
  if (per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

// One cooperative launch of a prepared plan on `stream`; under stream
// capture it becomes a cooperative kernel node.  B <= R rows.
extern "C" int viettts_ar_decode(const void* g1c, const void* g2c, const void* keep1,
                                 const void* keep2, const void* w_fc1, const void* w_fc2,
                                 const void* w1m, const void* w2m, const void* wp,
                                 const void* bp, void* out, void* exchange, int B, int L, int H,
                                 int P, int D, int G, int U, int PK, int DK, int S, int R,
                                 int smem_bytes, float scale, void* stream) {
  if (L < 1 || !valid_plan(B, H, P, D, G, U, PK, DK, S, R, smem_bytes))
    return (int)cudaErrorInvalidValue;
  Dims d{B, L, H, P, D, G, PK, DK, S, scale};
  void* args[] = {&g1c, &g2c, &keep1, &keep2, &w_fc1, &w_fc2, &w1m, &w2m, &wp, &bp, &out,
                  &exchange, &d};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(G);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = (size_t)smem_bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelExC(&config, (const void*)kernel_for(U), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
