// One HiFi-GAN generator stage (K2): ConvTranspose prologue, the MRF
// resblock convs, and the conv_post epilogue.
//
// Replaces the TPU kernel viettts_tpu/ops/mrf.py::fused_mrf (_mrf_kernel,
// mrf.py:181), which packed narrow channels space-to-depth to fill the
// 128-lane MXU and kept a whole stage's intermediates in VMEM.  Neither
// carries over: on Hopper each MRF conv is an implicit GEMM over [L, C]
// (M = time, N = C_out, K = taps x C_in), so there is no packing here.
//
// What bounds it on the H100: a stage's 18 MRF convs (ResBlock1, kernels
// 3/7/11 x dilations 1/3/5, 126 taps) cost 2 * B * L * C^2 * 126 FLOP,
// 17-68 GFLOP per stage at B=2 and 128 mel frames, about 97% of the
// stage's work.  Their bytes are small: each conv reads and writes one
// float32 [B, L, C] tensor (2-8.4 MB, about 0.45 GB per stage, 0.13 ms at
// 3.35 TB/s), and a stage's live buffers (~34 MB) stay in the 50 MB L2.
// So the convs are compute-bound, and on the CUDA cores (the first version
// of this file) they ran at 10-16 TFLOP/s.  This version runs them on the
// tensor cores with mma.sync:
//
// * bf16 route: A = bf16(lrelu(x)), rounded as the float32 input window
//   is staged into shared memory, B = the bf16 weights, float32
//   accumulation (m16n8k16).  That is the TPU kernel's DEFAULT-precision
//   dot, which rounds f32 operands to bf16 in a single pass
//   (viettts_tpu/ops/mrf.py:336-340).
// * float32 route: 3xTF32 (m16n8k8).  Each operand is split into TF32
//   parts hi = rna(v) and lo = rna(v - hi); acc += a_lo*b_hi + a_hi*b_lo +
//   a_hi*b_hi.  The weights come split once, [2 (hi, lo), k, C_out, C_in]
//   (ops/mrf.py::tf32_split); the activations are split as they are
//   staged into shared memory.
//
// Each block owns a BM (time) x BN (C_out) output tile and walks K as
// (input-channel chunk, tap).  Per chunk one input window, the tile plus
// the dilated halo (BM + (k-1)*dil rows), sits in shared memory; tap t
// reads it shifted by t*dil rows (ldmatrix takes any 16-byte-aligned row
// address), so one load serves all k taps.  The raw float32 window of the
// next chunk is fetched with cp.async in k slices, one per tap of the
// current chunk, and each thread converts (lrelu, rounding) the slots it
// fetched itself; the per-tap weight tiles are double-buffered with
// cp.async.  Tile shapes are picked per launch so that narrow stages and
// B=1 still put about 8 warps on every SM.
//
// SAME zero padding at the true sequence edges is applied as the input
// window is loaded (positions outside [0, L) read 0, and lrelu(0) = 0), so
// every conv's output equals the TPU kernel's re-zeroed intermediates.
//
// The float routes' ConvTranspose prologue runs on the same kernel, as u
// interleaved stride-1 convs (one output phase per grid z): on the CUDA
// cores it took 12-59% of a stage once the MRF convs moved to the tensor
// cores, on them 4-6%.  The int8 route keeps the CUDA-core prologue with
// float64 sums (convt_kernel), which its quantizer needs.  The conv_post
// epilogue (1-4 output channels) stays on the CUDA cores.
//
// Storage: weights and the stage's input/output are float32 or bfloat16;
// biases, intermediates between convs and accumulation are float32.

#include <cstdint>

#include "mrf_common.cuh"

namespace {

using viettts::fit_smem;
using viettts::lrelu;
using viettts::NT;
using viettts::TL;
using viettts::TN;
using viettts::to_f;

constexpr int TK = 8;    // prologue: input channels per shared-memory stage
constexpr int PT = 256;  // epilogue: output rows per block (one per thread)
constexpr int PK = 32;   // epilogue: input channels per shared-memory stage
constexpr int MAX_CP = 4;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The int8 route's ConvTranspose prologue, on the CUDA cores:
// y[b, n, co] = bias[co] + sum_{t, ci} lrelu(x[b, i, ci]) * w[t, ci, co]
// over taps with n = i*u + pad_a - t (JAX's SAME conv_transpose).  The
// prologue feeds a quantizer, so it sums the exact float32 products in
// float64, rounded once to float32 and then added to the bias: kernel and
// twin agree on every int8 code instead of flipping a few where their
// float32 sums round apart.
template <typename TI, typename TW>
__global__ void __launch_bounds__(NT) convt_kernel(
    const TI* __restrict__ x, const TW* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ y, int L_in, int C_in, int C_out, int k, int u, int pad_a, int win) {
  extern __shared__ float sm[];
  float* xs = sm;              // [win][TK]
  float* ws = sm + win * TK;   // [k][TK][TN]
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * TL;
  const int c0n = blockIdx.y * TN;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int L = L_in * u;
  const int i_lo = floor_div(n0 - pad_a, u);
  const TI* xb = x + (size_t)b * L_in * C_in;
  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

  for (int c0 = 0; c0 < C_in; c0 += TK) {
    __syncthreads();
    for (int e = tid; e < win * TK; e += NT) {
      const int r = e / TK, kk = e % TK;
      const int i = i_lo + r, ci = c0 + kk;
      float v = 0.f;
      if (i >= 0 && i < L_in && ci < C_in) v = lrelu(to_f(xb[(size_t)i * C_in + ci]), 0.1f);
      xs[e] = v;
    }
    for (int e = tid; e < k * TK * TN; e += NT) {
      const int t = e / (TK * TN), kk = (e / TN) % TK, n = e % TN;
      const int ci = c0 + kk, co = c0n + n;
      ws[e] = (ci < C_in && co < C_out) ? to_f(w[((size_t)t * C_in + ci) * C_out + co]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = n0 + ty + 32 * i - pad_a;
      const int t0 = ((-m) % u + u) % u;
      for (int t = t0; t < k; t += u) {
        const float* xr = xs + ((m + t) / u - i_lo) * TK;  // m + t is a multiple of u
        const float* wt = ws + t * TK * TN;
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          const double a = xr[kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fma(a, double(wt[kk * TN + tx + 8 * j]), acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 32 * i;
    if (n >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0n + tx + 8 * j;
      if (co < C_out) y[((size_t)b * L + n) * C_out + co] = __fadd_rn(float(acc[i][j]), bias[co]);
    }
  }
}

// --- tensor-core building blocks (sm_80+ PTX, run on sm_90a) -------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes < 16 zero-fills the rest (0: all zero).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n (0 <= n <= 3) cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

__device__ __forceinline__ void ldsm_x4(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned& r0, unsigned& r1, unsigned& r2,
                                              unsigned& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TF32 round to nearest, ties away from zero; the low 13 bits are cleared
// so that the result is also the float32 value it stands for.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// Tile shapes of the MRF conv: BM x BN outputs per block, WM x WN per warp,
// and KS warp groups that split each chunk's k-steps between them (their
// sums meet in shared memory before the epilogue).  KS = 2 doubles the
// warps on a tile: it keeps 32 x 32 warp tiles where a narrow problem
// (stage 0 at B=1: 1264 x 256 outputs) has few tiles.
struct Tile {
  int bm, bn, warps;
};
constexpr Tile TILES[] = {
    {128, 64, 8},  // warps 32 x 32
    {64, 64, 8},   // warps 32 x 32, KS = 2
    {128, 32, 8},  // warps 32 x 16
    {64, 32, 8},   // warps 32 x 16, KS = 2
    {32, 32, 8},   // warps 16 x 16, KS = 2
};
constexpr int N_TILES = sizeof(TILES) / sizeof(TILES[0]);
// Weight tiles in flight: the ring's depth (4 and 5 were no faster on the
// default stages).
constexpr int STAGES = 3;
static_assert(STAGES >= 2 && STAGES - 2 <= 3, "cp_async_wait_upto waits for at most 3 groups");

// Shared-memory layout of the two routes.  Per chunk of KC input channels:
// raw [win][KC] float32 x (cp.async), then the A window, APARTS x [win][SA];
// per (chunk, tap) a weight tile in a ring of STAGES slots, each WPARTS x
// [WROWS][SW].  Every row stride is 144 bytes (or 144 + 64*j), so the 8 row
// addresses of an ldmatrix hit 8 different 16-byte bank groups.
template <bool BF16, int KC_>
struct ConvTraits {  // bf16 mma: A = bf16(lrelu(x)), weights [k][C_in][C_out] bf16
  using TA = __nv_bfloat16;
  static constexpr int KC = KC_;  // 64 (4 k16 steps), or 32 where C_in <= 32
  static constexpr int KSTEP = 16;
  static constexpr int SA = KC + 8;
  static constexpr int APARTS = 1;
  static constexpr int WPARTS = 1;
  static constexpr int VW = 8;  // weight elements per 16-byte copy
  template <int BN> static constexpr int WROWS = KC;  // [ci][co]: ldmatrix.trans
  template <int BN> static constexpr int SW = BN + 8;
};
template <int KC_>
struct ConvTraits<false, KC_> {  // 3xTF32: A and weights split into hi, lo; weights [2][k][C_out][C_in]
  using TA = float;
  static constexpr int KC = KC_;  // 32 (4 k8 steps)
  static constexpr int KSTEP = 8;
  static constexpr int SA = KC + 4;
  static constexpr int APARTS = 2;
  static constexpr int WPARTS = 2;
  static constexpr int VW = 4;
  template <int BN> static constexpr int WROWS = BN;  // [co][ci]: ldmatrix
  template <int BN> static constexpr int SW = KC + 4;
};

template <int BM, int BN, int KS, bool BF16, int KC>
constexpr size_t conv_smem_bytes(int win) {
  using T = ConvTraits<BF16, KC>;
  const size_t pipe = (size_t)win * T::KC * 4 +
                      (size_t)T::APARTS * win * T::SA * sizeof(typename T::TA) +
                      (size_t)STAGES * T::WPARTS * T::template WROWS<BN> * T::template SW<BN> *
                          sizeof(typename T::TA);
  const size_t red = (size_t)(KS - 1) * BM * BN * 4;  // the k-groups' partial sums
  return pipe > red ? pipe : red;
}

// A conv of A = lrelu(x) (x [B, L_in, C_in] float32) on the tensor cores,
// in one of u output phases p = blockIdx.z % u:
//   v[b, m*u + p, co] = bias[co] + sum_{j, ci} A[b, m + s + j*dil, ci] * w[t0 + j*u, ci, co] (+ res)
// over the taps j of phase p: t0 = (pad_a - p) mod u, s = (p - pad_a + t0) / u.
// * MRF conv: u = 1, pad_a = (k-1)/2 * dil, so s = -pad_a (SAME).
// * ConvTranspose prologue (stride u, JAX SAME): dil = 1; output row n takes
//   input row i through tap t where n = i*u + pad_a - t, which for n = m*u + p
//   is a stride-1 conv of the taps t = t0 + j*u, interleaved into the output.
// mode 0: y = v;  mode 1: y += v;  mode 2: out = ((y ? y : 0) + v) / div,
// out bf16 if out_bf16 else float32.  res may alias y (each element is read
// and written by one thread); x never does.
// vec_x / vec_w: 16-byte copies are legal (channel counts and pointers aligned).
template <int BM, int BN, int WM, int WN, int KS, bool BF16, int KC_>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * KS * 32) mma_conv_kernel(
    const float* __restrict__ x, const void* __restrict__ wv, const float* __restrict__ bias,
    const float* res, float* y, void* out, int out_bf16, int L_in, int u, int pad_a, int C_in,
    int C_out, int k, int dil, int mode, float div, int vec_x, int vec_w) {
  using T = ConvTraits<BF16, KC_>;
  using TA = typename T::TA;
  constexpr int NWM = BM / WM, NWG = NWM * (BN / WN), NTH = NWG * KS * 32;
  constexpr int KC = T::KC, SA = T::SA, VW = T::VW, KSTEP = T::KSTEP;
  constexpr int WROWS = T::template WROWS<BN>, SW = T::template SW<BN>;
  constexpr int WTILE = WROWS * SW;  // elements of one weight part of one slot
  constexpr int MT = WM / 16, NT8 = WN / 8;
  constexpr int KQ = KC / 4;  // 16-byte pieces per raw window row
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BN % VW == 0, "tile shape");
  static_assert((KC / KSTEP) % KS == 0, "the k-groups split a chunk's k-steps evenly");

  extern __shared__ __align__(16) unsigned char smem[];
  const int win = BM + ((k + u - 1) / u - 1) * dil;  // taps of the longest phase
  float* raw = reinterpret_cast<float*>(smem);              // [win][KC]
  TA* xa = reinterpret_cast<TA*>(raw + (size_t)win * KC);   // [APARTS][win][SA]
  TA* ws = xa + (size_t)T::APARTS * win * SA;               // [STAGES][WPARTS][WTILE]

  const int b = blockIdx.z / u, p = blockIdx.z % u;
  const int t0 = ((pad_a - p) % u + u) % u;
  const int s = (p - pad_a + t0) / u;   // exact: p - pad_a + t0 is a multiple of u
  const int kp = (k - t0 + u - 1) / u;  // taps of this phase
  const int l0 = blockIdx.x * BM;       // first output row of the phase
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kg = warp / NWG, wg = warp % NWG;  // k-group, warp position in the tile
  const int wm = wg % NWM, wn = wg / NWM;
  const float* xb = x + (size_t)b * L_in * C_in;
  const int n_raw = win * KQ;
  const int n_per = (n_raw + NTH - 1) / NTH;  // raw pieces per thread
  const int nc = (C_in + KC - 1) / KC;
  const size_t w_part = (size_t)k * C_in * C_out;  // TF32: offset of the lo part

  // Raw window of chunk c, this thread's pieces i = part, part + step, ...
  // (piece e = tid + i*NTH: a thread converts only what it fetched itself).
  auto load_raw = [&](int c, int part, int step) {
    for (int i = part; i < n_per; i += step) {
      const int e = tid + i * NTH;
      if (e >= n_raw) break;
      const int r = e / KQ, q = e % KQ;
      const int l = l0 + s + r, ci = c * KC + 4 * q;
      float* dst = raw + r * KC + 4 * q;
      const bool row_ok = l >= 0 && l < L_in;
      if (vec_x) {
        const bool ok = row_ok && ci < C_in;
        cp_async16(dst, ok ? xb + (size_t)l * C_in + ci : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = (row_ok && ci + j < C_in) ? xb[(size_t)l * C_in + ci + j] : 0.f;
      }
    }
  };
  // raw -> A window: lrelu, then bf16 rounding, or the TF32 split.
  auto convert = [&]() {
    for (int i = 0; i < n_per; ++i) {
      const int e = tid + i * NTH;
      if (e >= n_raw) break;
      const int r = e / KQ, q = e % KQ;
      const float4 v = *reinterpret_cast<const float4*>(raw + r * KC + 4 * q);
      const float a[4] = {lrelu(v.x, 0.1f), lrelu(v.y, 0.1f), lrelu(v.z, 0.1f),
                          lrelu(v.w, 0.1f)};
      if constexpr (BF16) {
        __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(xa + r * SA + 4 * q);
        d[0] = __floats2bfloat162_rn(a[0], a[1]);
        d[1] = __floats2bfloat162_rn(a[2], a[3]);
      } else {
        float hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hi[j] = __uint_as_float(tf32_rna(a[j]));
          lo[j] = __uint_as_float(tf32_rna(a[j] - hi[j]));
        }
        *reinterpret_cast<float4*>(xa + r * SA + 4 * q) = make_float4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<float4*>(xa + ((size_t)win + r) * SA + 4 * q) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  };
  // Weight tile of (chunk c, tap t) into ring slot `slot`.
  auto load_w = [&](int c, int t, int slot) {
    const TA* w = static_cast<const TA*>(wv);
    constexpr int PIECES = KC * BN / VW;
#pragma unroll
    for (int pt = 0; pt < T::WPARTS; ++pt) {
      TA* dst0 = ws + (size_t)(slot * T::WPARTS + pt) * WTILE;
#pragma unroll
      for (int e0 = 0; e0 < PIECES; e0 += NTH) {
        const int e = e0 + tid;
        if (PIECES % NTH != 0 && e >= PIECES) break;
        int ci, co;
        size_t src;
        TA* dst;
        if constexpr (BF16) {  // row ci of [k][C_in][C_out]: VW output channels
          const int kr = e / (BN / VW), q = e % (BN / VW);
          ci = c * KC + kr;
          co = n0 + VW * q;
          src = ((size_t)t * C_in + ci) * C_out + co;
          dst = dst0 + kr * SW + VW * q;
        } else {  // row co of [2][k][C_out][C_in]: VW input channels
          const int nr = e / (KC / VW), q = e % (KC / VW);
          co = n0 + nr;
          ci = c * KC + VW * q;
          src = pt * w_part + ((size_t)t * C_out + co) * C_in + ci;
          dst = dst0 + nr * SW + VW * q;
        }
        const bool ok = ci < C_in && co < C_out;
        if (vec_w) {
          cp_async16(dst, ok ? w + src : wv, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            const bool in = BF16 ? (ci < C_in && co + j < C_out) : (co < C_out && ci + j < C_in);
            dst[j] = in ? w[src + j] : TA(0.f);
          }
        }
      }
    }
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // ldmatrix lane addressing: lanes 8j..8j+7 give the row addresses of matrix j
  const int lrow = (lane % 8) + ((lane / 8) % 2) * 8;  // matrices 1, 3: rows 8-15
  const int lcol = lane / 16;                           // matrices 2, 3: second column block
  const int g = lane / 4, tq = lane % 4;

  // Pipeline: iteration (chunk c, tap j).  Weight tiles run STAGES - 1
  // iterations ahead (chunk cw, tap jw); the next chunk's raw window is
  // fetched in slices on the first R taps.  At a chunk's first tap, the
  // groups younger than the last slice (kp - R of them) may stay in flight.
  const int n_it = nc * kp;
  const int R = kp - STAGES + 2 > 1 ? kp - STAGES + 2 : 1;
  load_raw(0, 0, 1);
  int cw = 0, jw = 0, slot_w = 0;
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_it) load_w(cw, t0 + jw * u, slot_w);
    cp_async_commit();
    if (++jw == kp) jw = 0, ++cw;
    slot_w = slot_w + 1 == STAGES ? 0 : slot_w + 1;
  }
  int c = 0, j = 0, slot = 0;
  for (int it = 0; it < n_it; ++it) {
    // weights of this iteration (and at j == 0 the raw window of chunk c) have landed
    cp_async_wait_upto(j == 0 && c > 0 ? kp - R : STAGES - 2);
    __syncthreads();  // all warps are done with the previous iteration
    if (j == 0) {
      convert();
      __syncthreads();
    }
    if (c + 1 < nc && j < R) load_raw(c + 1, j, R);
    if (it + STAGES - 1 < n_it) load_w(cw, t0 + jw * u, slot_w);
    cp_async_commit();
    if (++jw == kp) jw = 0, ++cw;
    slot_w = slot_w + 1 == STAGES ? 0 : slot_w + 1;

    const TA* xt = xa + (size_t)(j * dil + wm * WM) * SA;
    const TA* wt = ws + (size_t)slot * T::WPARTS * WTILE;
#pragma unroll
    for (int kk = 0; kk < KC / KSTEP / KS; ++kk) {
      const int ks = (kk * KS + kg) * KSTEP;  // this k-group's k-steps
      if constexpr (BF16) {
        unsigned af[MT][4], bfr[NT8][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                  xt + (mi * 16 + lrow) * SA + ks + lcol * 8);
#pragma unroll
        for (int nj = 0; nj < NT8 / 2; ++nj)
          ldsm_x4_trans(bfr[2 * nj][0], bfr[2 * nj][1], bfr[2 * nj + 1][0], bfr[2 * nj + 1][1],
                        wt + (ks + lrow) * SW + wn * WN + nj * 16 + lcol * 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT8; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
      } else {
        const TA* xlo = xt + (size_t)win * SA;
        unsigned ahi[MT][4], alo[MT][4], bhi[NT8][2], blo[NT8][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int o = (mi * 16 + lrow) * SA + ks + lcol * 4;
          ldsm_x4(ahi[mi][0], ahi[mi][1], ahi[mi][2], ahi[mi][3], xt + o);
          ldsm_x4(alo[mi][0], alo[mi][1], alo[mi][2], alo[mi][3], xlo + o);
        }
        // [co][ci] tiles: lanes 0-7 / 8-15 / 16-23 / 24-31 address b0 and b1
        // of n-tile 2nj, then b0 and b1 of n-tile 2nj + 1
#pragma unroll
        for (int nj = 0; nj < NT8 / 2; ++nj) {
          const int o = (wn * WN + nj * 16 + lane % 8 + lcol * 8) * SW + ks + ((lane / 8) % 2) * 4;
          ldsm_x4(bhi[2 * nj][0], bhi[2 * nj][1], bhi[2 * nj + 1][0], bhi[2 * nj + 1][1], wt + o);
          ldsm_x4(blo[2 * nj][0], blo[2 * nj][1], blo[2 * nj + 1][0], blo[2 * nj + 1][1],
                  wt + WTILE + o);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT8; ++ni) {
            mma_tf32(acc[mi][ni], alo[mi], bhi[ni][0], bhi[ni][1]);
            mma_tf32(acc[mi][ni], ahi[mi], blo[ni][0], blo[ni][1]);
            mma_tf32(acc[mi][ni], ahi[mi], bhi[ni][0], bhi[ni][1]);
          }
      }
    }
    if (++j == kp) j = 0, ++c;
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  if constexpr (KS > 1) {  // k-groups 1.. hand their sums to group 0 through shared memory
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);  // [KS-1][MT*NT8*4][NWG*32]
    constexpr int NA = MT * NT8 * 4;
    const int me = wg * 32 + lane;
    if (kg > 0) {
#pragma unroll
      for (int i = 0; i < NA; ++i)
        red[((size_t)(kg - 1) * NA + i) * NWG * 32 + me] = (&acc[0][0][0])[i];
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int q = 1; q < KS; ++q)
#pragma unroll
      for (int i = 0; i < NA; ++i)
        (&acc[0][0][0])[i] += red[((size_t)(q - 1) * NA + i) * NWG * 32 + me];
  }

  // accumulator element r of tile (mi, ni): row g + 8*(r/2), column 2*tq + r%2
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = l0 + wm * WM + mi * 16 + g + 8 * (r / 2);
        const int co = n0 + wn * WN + ni * 8 + 2 * tq + r % 2;
        if (m >= L_in || co >= C_out) continue;
        const size_t o = ((size_t)b * L_in * u + (size_t)m * u + p) * C_out + co;
        float v = acc[mi][ni][r] + bias[co];
        if (res) v += res[o];
        if (mode == 0) {
          y[o] = v;
        } else if (mode == 1) {
          y[o] += v;
        } else {
          const float mean = ((y ? y[o] : 0.f) + v) / div;
          if (out_bf16)
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(mean);
          else
            static_cast<float*>(out)[o] = mean;
        }
      }
}

// out[b, l, q] = tanh(bias[q] + sum_{t, c} lrelu_0.01(x[b, l + t - (k-1)/2, c]) * w[t, c, q])
template <typename TW>
__global__ void __launch_bounds__(PT) post_kernel(
    const float* __restrict__ x, const TW* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int L, int C, int Cp, int k) {
  extern __shared__ float sm[];
  const int win = PT + k - 1;
  float* xs = sm;                    // [win][PK + 1] (padded rows: no bank conflicts)
  float* ws = sm + win * (PK + 1);   // [k][PK][Cp]
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * PT;
  const int tid = threadIdx.x;
  const int half = (k - 1) / 2;
  const float* xb = x + (size_t)b * L * C;
  float acc[MAX_CP];
#pragma unroll
  for (int q = 0; q < MAX_CP; ++q) acc[q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += PK) {
    __syncthreads();
    for (int e = tid; e < win * PK; e += PT) {
      const int r = e / PK, kk = e % PK;
      const int l = l0 - half + r, c = c0 + kk;
      float v = 0.f;
      if (l >= 0 && l < L && c < C) v = lrelu(xb[(size_t)l * C + c], 0.01f);
      xs[r * (PK + 1) + kk] = v;
    }
    for (int e = tid; e < k * PK * Cp; e += PT) {
      const int t = e / (PK * Cp), kk = (e / Cp) % PK, q = e % Cp;
      const int c = c0 + kk;
      ws[e] = c < C ? to_f(w[((size_t)t * C + c) * Cp + q]) : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < k; ++t) {
      const float* xr = xs + (tid + t) * (PK + 1);
      const float* wt = ws + t * PK * Cp;
      for (int kk = 0; kk < PK; ++kk) {
        const float a = xr[kk];
#pragma unroll
        for (int q = 0; q < MAX_CP; ++q)
          if (q < Cp) acc[q] = fmaf(a, wt[kk * Cp + q], acc[q]);
      }
    }
  }
  const int l = l0 + tid;
  if (l < L) {
#pragma unroll
    for (int q = 0; q < MAX_CP; ++q)
      if (q < Cp) out[((size_t)b * L + l) * Cp + q] = tanhf(acc[q] + bias[q]);
  }
}

__global__ void to_f32_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                              long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = __bfloat162float(x[i]);
}

template <typename TI, typename TW>
int launch_convt(const void* x, const void* w, const void* bias, void* y, int B, int L_in,
                 int C_in, int C_out, int k, int u, int pad_a, cudaStream_t s) {
  const int win = (TL + k - 2) / u + 2;
  const size_t smem = sizeof(float) * ((size_t)win * TK + (size_t)k * TK * TN);
  cudaError_t err = fit_smem(convt_kernel<TI, TW>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L_in * u + TL - 1) / TL, (C_out + TN - 1) / TN, B);
  convt_kernel<TI, TW><<<grid, NT, smem, s>>>(
      static_cast<const TI*>(x), static_cast<const TW*>(w), static_cast<const float*>(bias),
      static_cast<float*>(y), L_in, C_in, C_out, k, u, pad_a, win);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// The largest tile that still puts about 8 warps on every SM; BN = 64 only
// where C_out fills it.
int pick_tile(int B, int L, int C_out) {
  const long long want = 8LL * sm_count();
  for (int i = 0; i < N_TILES; ++i) {
    const Tile& tl = TILES[i];
    if (tl.bn > 32 && C_out <= 32) continue;
    const long long blocks =
        (long long)((L + tl.bm - 1) / tl.bm) * ((C_out + tl.bn - 1) / tl.bn) * B;
    if (blocks * tl.warps >= want) return i;
  }
  return N_TILES - 1;
}

// Arguments of one launch of mma_conv_kernel (see there).
struct ConvArgs {
  const void *x, *w, *bias, *res;
  void *y, *out;
  int out_bf16, B, L_in, u, pad_a, C_in, C_out, k, dil, mode;
  float div;
};

template <int BM, int BN, int WM, int WN, int KS, bool BF16, int KC = BF16 ? 64 : 32>
int launch_mma_conv(const ConvArgs& a, cudaStream_t s) {
  constexpr int NTH = (BM / WM) * (BN / WN) * KS * 32;
  auto kernel = mma_conv_kernel<BM, BN, WM, WN, KS, BF16, KC>;
  const size_t smem =
      conv_smem_bytes<BM, BN, KS, BF16, KC>(BM + ((a.k + a.u - 1) / a.u - 1) * a.dil);
  cudaError_t err = fit_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_x = a.C_in % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const int vec_w = (BF16 ? a.C_out : a.C_in) % ConvTraits<BF16, KC>::VW == 0 &&
                    reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  dim3 grid((a.L_in + BM - 1) / BM, (a.C_out + BN - 1) / BN, a.B * a.u);
  kernel<<<grid, NTH, smem, s>>>(
      static_cast<const float*>(a.x), a.w, static_cast<const float*>(a.bias),
      static_cast<const float*>(a.res), static_cast<float*>(a.y), a.out, a.out_bf16, a.L_in, a.u,
      a.pad_a, a.C_in, a.C_out, a.k, a.dil, a.mode, a.div, vec_x, vec_w);
  return (int)cudaGetLastError();
}

// tile < 0 picks the tile shape from the problem size, else indexes TILES.
// bf16 convs of at most 32 input channels take 32-channel chunks (the
// last stage: a 64-channel chunk would be half zeros).
template <bool BF16>
int launch_conv(int tile, const ConvArgs& a, cudaStream_t s) {
  if (tile < 0) tile = pick_tile(a.B * a.u, a.L_in, a.C_out);
  if constexpr (BF16) {
    if (a.C_in <= 32) switch (tile) {
        case 2: return launch_mma_conv<128, 32, 32, 16, 1, true, 32>(a, s);
        case 3: return launch_mma_conv<64, 32, 32, 16, 2, true, 32>(a, s);
        case 4: return launch_mma_conv<32, 32, 16, 16, 2, true, 32>(a, s);
      }
  }
  switch (tile) {
    case 0: return launch_mma_conv<128, 64, 32, 32, 1, BF16>(a, s);
    case 1: return launch_mma_conv<64, 64, 32, 32, 2, BF16>(a, s);
    case 2: return launch_mma_conv<128, 32, 32, 16, 1, BF16>(a, s);
    case 3: return launch_mma_conv<64, 32, 32, 16, 2, BF16>(a, s);
    case 4: return launch_mma_conv<32, 32, 16, 16, 2, BF16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TW>
int launch_post(const void* x, const void* w, const void* bias, void* out, int B, int L, int C,
                int Cp, int k, cudaStream_t s) {
  if (Cp > MAX_CP) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(PT + k - 1) * (PK + 1) + (size_t)k * PK * Cp);
  cudaError_t err = fit_smem(post_kernel<TW>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + PT - 1) / PT, B);
  post_kernel<TW><<<grid, PT, smem, s>>>(static_cast<const float*>(x),
                                         static_cast<const TW*>(w),
                                         static_cast<const float*>(bias),
                                         static_cast<float*>(out), L, C, Cp, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The int8 route's prologue (float64 sums).  x and w are both bfloat16
// (bf16 != 0) or both float32.
extern "C" int viettts_mrf_convt(int bf16, const void* x, const void* w, const void* bias, void* y,
                                 int B, int L_in, int C_in, int C_out, int k, int u, int pad_a,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_convt<__nv_bfloat16, __nv_bfloat16>(x, w, bias, y, B, L_in, C_in, C_out, k, u,
                                                      pad_a, s);
  return launch_convt<float, float>(x, w, bias, y, B, L_in, C_in, C_out, k, u, pad_a, s);
}

// The float routes' ConvTranspose prologue on the tensor cores, as u
// interleaved stride-1 convs.  x is float32 [B, L_in, C_in]; w is bf16
// [k, C_in, C_out] (w_bf16) or the float32 TF32 split [2, k, C_out, C_in];
// y float32 [B, L_in * u, C_out].
extern "C" int viettts_mrf_convt_mma(int w_bf16, const void* x, const void* w, const void* bias,
                                     void* y, int B, int L_in, int C_in, int C_out, int k, int u,
                                     int pad_a, int tile, void* stream) {
  const ConvArgs a{x, w, bias, nullptr, y, nullptr, 0, B, L_in, u, pad_a, C_in, C_out, k, 1, 0, 1.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_bf16 ? launch_conv<true>(tile, a, s) : launch_conv<false>(tile, a, s);
}

// One MRF conv on the tensor cores (SAME, dilation dil).  w_bf16: w is bf16
// [k, C_in, C_out] (bf16 mma); else the float32 TF32 split [2, k, C_out,
// C_in] (3xTF32).  tile < 0 picks the tile shape from the problem size.
extern "C" int viettts_mrf_conv(int w_bf16, int out_bf16, const void* x, const void* w,
                                const void* bias, const void* res, void* y, void* out, int B,
                                int L, int C_in, int C_out, int k, int dil, int mode, int tile,
                                float div, void* stream) {
  const ConvArgs a{x, w, bias, res, y, out, out_bf16, B, L, 1, (k - 1) / 2 * dil,
                   C_in, C_out, k, dil, mode, div};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_bf16 ? launch_conv<true>(tile, a, s) : launch_conv<false>(tile, a, s);
}

extern "C" int viettts_mrf_post(int w_bf16, const void* x, const void* w, const void* bias,
                                void* out, int B, int L, int C, int Cp, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16) return launch_post<__nv_bfloat16>(x, w, bias, out, B, L, C, Cp, k, s);
  return launch_post<float>(x, w, bias, out, B, L, C, Cp, k, s);
}

extern "C" int viettts_mrf_to_f32(const void* x, void* y, long long n, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  to_f32_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(static_cast<const __nv_bfloat16*>(x),
                                                       static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}

extern "C" const char* viettts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
