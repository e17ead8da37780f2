// One HiFi-GAN generator stage (K2): ConvTranspose prologue, the MRF
// resblock convs, and the conv_post epilogue.
//
// Replaces the TPU kernel viettts_tpu/ops/mrf.py::fused_mrf (_mrf_kernel),
// which packed narrow channels space-to-depth to fill the 128-lane MXU and
// kept a whole stage's intermediates in VMEM.  Neither carries over: on
// Hopper each conv is a plain implicit GEMM over [L, C] (M = time,
// N = C_out, K = taps x C_in), so there is no packing here.
//
// What bounds it on the H100: the stage's 18 convs are compute-heavy
// (about 38 GFLOP per second of 16 kHz audio at the default widths) but
// narrow (C = 256 .. 32), and each conv's activations make a round trip
// through device memory (4 B x L x C in, the same out).  This first
// version computes in float32 on the CUDA cores: each block stages an
// input window (tile + dilated halo) and a weight tile in shared memory
// and each thread accumulates a 4 x 4 register tile, so every input and
// weight value loaded is reused across 4 outputs.  Tensor cores (wgmma on
// bf16 operands) and keeping the whole stage on chip are later work.
//
// SAME zero padding at the true sequence edges is applied as the input
// window is loaded (positions outside [0, L) read 0, and lrelu(0) = 0), so
// every conv's output equals the TPU kernel's re-zeroed intermediates.
//
// Storage: weights and the stage's input/output are float32 or bfloat16;
// biases, intermediates and all arithmetic are float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TL = 128;  // output rows (time) per block
constexpr int TN = 32;   // output channels per block
constexpr int TK = 8;    // input channels per shared-memory stage
constexpr int NT = 256;  // threads: 32 row groups x 8 column groups, 4 x 4 each
constexpr int PT = 256;  // epilogue: output rows per block (one per thread)
constexpr int PK = 32;   // epilogue: input channels per shared-memory stage
constexpr int MAX_CP = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float lrelu(float v, float slope) { return v > 0.f ? v : slope * v; }

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// y[b, n, co] = bias[co] + sum_{t, ci} lrelu(x[b, i, ci]) * w[t, ci, co]
// over taps with n = i*u + pad_a - t (JAX's SAME conv_transpose).
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
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
          const float a = xr[kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wt[kk * TN + tx + 8 * j], acc[i][j]);
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
      if (co < C_out) y[((size_t)b * L + n) * C_out + co] = acc[i][j] + bias[co];
    }
  }
}

// v = bias[co] + sum_{t, ci} lrelu(x[b, l + (t - (k-1)/2) * dil, ci]) * w[t, ci, co] (+ res)
// mode 0: y = v;  mode 1: y += v;  mode 2: out = ((y ? y : 0) + v) / div.
// res may alias y (each element is read and written by one thread); x never does.
template <typename TW, typename TO>
__global__ void __launch_bounds__(NT) conv_kernel(
    const float* __restrict__ x, const TW* __restrict__ w, const float* __restrict__ bias,
    const float* res, float* y, TO* out, int L, int C_in, int C_out, int k, int dil,
    int mode, float div) {
  extern __shared__ float sm[];
  const int win = TL + (k - 1) * dil;
  float* xs = sm;              // [win][TK]
  float* ws = sm + win * TK;   // [k][TK][TN]
  const int b = blockIdx.z;
  const int l0 = blockIdx.x * TL;
  const int c0n = blockIdx.y * TN;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int half = (k - 1) / 2 * dil;
  const float* xb = x + (size_t)b * L * C_in;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C_in; c0 += TK) {
    __syncthreads();
    for (int e = tid; e < win * TK; e += NT) {
      const int r = e / TK, kk = e % TK;
      const int l = l0 - half + r, ci = c0 + kk;
      float v = 0.f;
      if (l >= 0 && l < L && ci < C_in) v = lrelu(xb[(size_t)l * C_in + ci], 0.1f);
      xs[e] = v;
    }
    for (int e = tid; e < k * TK * TN; e += NT) {
      const int t = e / (TK * TN), kk = (e / TN) % TK, n = e % TN;
      const int ci = c0 + kk, co = c0n + n;
      ws[e] = (ci < C_in && co < C_out) ? to_f(w[((size_t)t * C_in + ci) * C_out + co]) : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < k; ++t) {
      const float* xt = xs + t * dil * TK;
      const float* wt = ws + t * TK * TN;
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[4], bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xt[(ty + 32 * i) * TK + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = wt[kk * TN + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty + 32 * i;
    if (l >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0n + tx + 8 * j;
      if (co >= C_out) continue;
      const size_t o = ((size_t)b * L + l) * C_out + co;
      float v = acc[i][j] + bias[co];
      if (res) v += res[o];
      if (mode == 0) {
        y[o] = v;
      } else if (mode == 1) {
        y[o] += v;
      } else {
        out[o] = from_f<TO>(((y ? y[o] : 0.f) + v) / div);
      }
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

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename K>
cudaError_t fit_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

template <typename TW, typename TO>
int launch_conv(const void* x, const void* w, const void* bias, const void* res, void* y,
                void* out, int B, int L, int C_in, int C_out, int k, int dil, int mode,
                float div, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((size_t)(TL + (k - 1) * dil) * TK + (size_t)k * TK * TN);
  cudaError_t err = fit_smem(conv_kernel<TW, TO>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + TL - 1) / TL, (C_out + TN - 1) / TN, B);
  conv_kernel<TW, TO><<<grid, NT, smem, s>>>(
      static_cast<const float*>(x), static_cast<const TW*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(y), static_cast<TO*>(out), L, C_in,
      C_out, k, dil, mode, div);
  return (int)cudaGetLastError();
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

// x and w are both bfloat16 (bf16 != 0) or both float32.
extern "C" int viettts_mrf_convt(int bf16, const void* x, const void* w, const void* bias,
                                 void* y, int B, int L_in, int C_in, int C_out, int k, int u,
                                 int pad_a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_convt<__nv_bfloat16, __nv_bfloat16>(x, w, bias, y, B, L_in, C_in, C_out, k,
                                                      u, pad_a, s);
  return launch_convt<float, float>(x, w, bias, y, B, L_in, C_in, C_out, k, u, pad_a, s);
}

extern "C" int viettts_mrf_conv(int w_bf16, int out_bf16, const void* x, const void* w,
                                const void* bias, const void* res, void* y, void* out, int B,
                                int L, int C_in, int C_out, int k, int dil, int mode,
                                float div, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16 && out_bf16)
    return launch_conv<__nv_bfloat16, __nv_bfloat16>(x, w, bias, res, y, out, B, L, C_in,
                                                     C_out, k, dil, mode, div, s);
  if (w_bf16)
    return launch_conv<__nv_bfloat16, float>(x, w, bias, res, y, out, B, L, C_in, C_out, k,
                                             dil, mode, div, s);
  if (out_bf16)
    return launch_conv<float, __nv_bfloat16>(x, w, bias, res, y, out, B, L, C_in, C_out, k,
                                             dil, mode, div, s);
  return launch_conv<float, float>(x, w, bias, res, y, out, B, L, C_in, C_out, k, dil, mode,
                                   div, s);
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
