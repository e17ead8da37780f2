// One HiFi-GAN generator stage (K2): ConvTranspose prologue, the MRF
// resblock convs, and the conv_post epilogue, on the float32 and bf16
// routes.
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
// of this file) they ran at 10-16 TFLOP/s.  They run on the tensor cores
// with mma.sync, in the pipeline of mrf_common.cuh (mma_conv_kernel):
//
// * bf16 route (Bf16Mma): A = bf16(lrelu(x)), rounded as the float32 input
//   window is staged into shared memory, B = the bf16 weights, float32
//   accumulation (m16n8k16).  That is the TPU kernel's DEFAULT-precision
//   dot, which rounds f32 operands to bf16 in a single pass
//   (viettts_tpu/ops/mrf.py:336-340).
// * float32 route (Tf32Mma): 3xTF32 (m16n8k8).  Each operand is split into
//   TF32 parts hi = rna(v) and lo = rna(v - hi); acc += a_lo*b_hi +
//   a_hi*b_lo + a_hi*b_hi.  The weights come split once, [2 (hi, lo), k,
//   C_out, C_in] (ops/mrf.py::tf32_split); the activations are split as
//   they are staged into shared memory.
//
// On the bf16 route the fused pipeline (mrf_fused.cuh, viettts_mrf_fused
// below) takes the MRF convs of the stages that ops/mrf.py::plan_fused
// gives it: one launch runs whole resblocks for time tiles on chip, on
// wgmma with TMA, as the TPU kernel kept its tiles in VMEM.  The C = 256
// and 128 stages take the per-conv wgmma pipeline (mrf_conv_wgmma.cuh,
// viettts_mrf_conv_wgmma below), whose epilogues write the next conv's
// bf16 operand.  The float32 route's MRF convs take the same pipeline in
// 3xTF32 where its plan says so (mrf_tf32.cu), elsewhere mma_conv_kernel.
//
// The float routes' ConvTranspose prologue runs on the same kernel, as u
// interleaved stride-1 convs (one output phase per grid z): on the CUDA
// cores it took 12-59% of a stage once the MRF convs moved to the tensor
// cores, on them 4-6%.  (The int8 route's MRF convs and its float64
// prologue are K3, mrf_int8.cu.)  The conv_post epilogue (1-4 output
// channels) stays on the CUDA cores.
//
// Storage: weights and the stage's input/output are float32 or bfloat16;
// biases, intermediates between convs and accumulation are float32.

#include <cstdint>

#include "mrf_common.cuh"
#include "mrf_conv_wgmma.cuh"
#include "mrf_fused.cuh"

namespace {

using viettts::Bf16Mma;
using viettts::ConvArgs;
using viettts::launch_mma_conv;
using viettts::launch_tile;
using viettts::lrelu;
using viettts::opt_in_smem_once;
using viettts::pick_tile;
using viettts::Tf32Mma;
using viettts::to_f;

constexpr int PT = 256;  // epilogue: output rows per block (one per thread)
constexpr int PK = 32;   // epilogue: input channels per shared-memory stage
constexpr int MAX_CP = 4;

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

// tile < 0 picks the tile shape from the problem size, else indexes TILES.
// bf16 convs of at most 32 input channels take 32-channel chunks (the
// last stage: a 64-channel chunk would be half zeros).
template <bool BF16>
int launch_conv(int tile, const ConvArgs& a, cudaStream_t s) {
  if (tile < 0) tile = pick_tile(a.B * a.u, a.L_in, a.C_out);
  if constexpr (BF16) {
    if (a.C_in <= 32) switch (tile) {
        case 2: return launch_mma_conv<Bf16Mma<32>, 128, 32, 32, 16, 1>(a, s);
        case 3: return launch_mma_conv<Bf16Mma<32>, 64, 32, 32, 16, 2>(a, s);
        case 4: return launch_mma_conv<Bf16Mma<32>, 32, 32, 16, 16, 2>(a, s);
      }
    return launch_tile<Bf16Mma<64>>(tile, a, s);
  } else {
    return launch_tile<Tf32Mma>(tile, a, s);
  }
}

template <typename TW>
int launch_post(const void* x, const void* w, const void* bias, void* out, int B, int L, int C,
                int Cp, int k, cudaStream_t s) {
  if (Cp > MAX_CP) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(PT + k - 1) * (PK + 1) + (size_t)k * PK * Cp);
  static std::atomic<int> opted_on[viettts::MAX_DEVICES];
  const cudaError_t err = opt_in_smem_once(post_kernel<TW>, opted_on);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + PT - 1) / PT, B);
  post_kernel<TW><<<grid, PT, smem, s>>>(static_cast<const float*>(x),
                                         static_cast<const TW*>(w),
                                         static_cast<const float*>(bias),
                                         static_cast<float*>(out), L, C, Cp, k);
  return (int)cudaGetLastError();
}

}  // namespace

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

// A stage's MRF convs (plan rows of viettts::PLAN_FIELDS, see there), each
// as viettts_mrf_conv with the tile picked by shape; stops at the first error.
extern "C" int viettts_mrf_conv_plan(int w_bf16, int out_bf16, int B, int L, int C, float div,
                                     int n, const void* plan, void* stream) {
  const long long* rows = static_cast<const long long*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    const ConvArgs a = viettts::plan_conv(rows + (size_t)i * viettts::PLAN_FIELDS, out_bf16, B, L, C, div);
    const int err = w_bf16 ? launch_conv<true>(-1, a, s) : launch_conv<false>(-1, a, s);
    if (err != 0) return err;
  }
  return 0;
}

// The MRF of a bf16-route stage on the fused pipeline (mrf_fused.cuh):
// x the float32 stage input [B, L, C], res n_res rows of
// viettts::FUSED_RES_FIELDS (w1, w2: bf16 [units, k, C, C]), out the mean
// of the resblocks (bf16 if out_bf16).  win, bm, stages and ctas:
// ops/mrf.py::plan_fused.
extern "C" int viettts_mrf_fused(int out_bf16, int B, int L, int C, int n_res, int win, int bm, int stages,
                                 int ctas, const void* x, const void* res, void* out, void* stream) {
  return viettts::fused_launch<viettts::FRoute::kBf16>(out_bf16, B, L, C, n_res, win, bm, stages, ctas, x, res,
                                                       nullptr, out, static_cast<cudaStream_t>(stream));
}

// The MRF convs of a bf16-route stage of width C = 128 or 256 on the
// per-conv wgmma pipeline (mrf_conv_wgmma.cuh): n rows of
// viettts::CONV_FIELDS int64, one launch each, planned by
// mrf_conv_plan.h.
extern "C" int viettts_mrf_conv_wgmma(int out_bf16, int B, int L, int C, float div, int n, const void* table,
                                      void* stream) {
  return viettts::conv_wgmma_stage<viettts::FRoute::kBf16>(out_bf16, B, L, C, div, n, table, 0,
                                                           static_cast<cudaStream_t>(stream));
}

// The bf16 operand lrelu(h) of a stage input h float32 [B, L, C],
// chunk-major [B][C / 8][L][8] (rows: n x (out, unused) int64).
extern "C" int viettts_mrf_conv_operands(int B, int L, int C, const void* h, int n, const void* rows,
                                         void* stream) {
  return viettts::conv_operands<viettts::FRoute::kBf16>(B, L, C, h, n, rows, 0, static_cast<cudaStream_t>(stream));
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
