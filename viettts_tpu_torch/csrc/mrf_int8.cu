// The int8 MRF conv of a HiFi-GAN generator stage (K3), and the per-row
// amax reduce its dynamic mode needs.
//
// Replaces the quantize_int8 mode of the TPU kernel
// viettts_tpu/ops/mrf.py::fused_mrf (_mrf_kernel, mrf.py:280-357 in the
// kernel, :568-600 on the host), which ran each of a stage's 18 MRF convs
// as int8 x int8 -> int32 MXU passes over space-to-depth packed tiles.
// Here each conv is a tiled direct conv, the same call shape as K2's
// conv_kernel (mrf.cu), with the same modes for residual and block mean:
//
//   q[l, ci] = rint(lrelu(x[l, ci]) * inv)     (static: clipped to +-127)
//   v[l, co] = float(sum_{t, ci} q[l + (t - (k-1)/2) * dil, ci] * w[t, ci, co])
//              * mult[co] + bias[co] (+ res[l, co])
//
// static:  a = max(act, 1e-12), inv = 127 / a, mult = scale[co] * (a / 127)
// dynamic: a = amax of |lrelu(x)| over the batch row, inv = 127 / max(a, 1e-30),
//          mult = (a * (1/127)) * scale[co]
//
// in exactly the float32 operations and order of the TPU kernel and of the
// plain twin (ops/mrf.py::_conv_int8): explicit _rn intrinsics keep nvcc
// from contracting the dequant multiply and the bias add into one FMA, and
// rounding is half to even (__float2int_rn, as jnp.round), never roundf.
// The integer dot is exact, so the kernel differs from the twin only where
// an upstream float32 value (the prologue's sums) rounds differently and
// flips an int8 code.
//
// What bounds it on the H100: the same narrow convs as K2 with a 4x denser
// inner product: each thread accumulates a 4 x 4 int32 register tile with
// __dp4a (four int8 products per instruction on the CUDA cores), from
// codes packed four input channels to a 32-bit word in shared memory.
// The input window is quantized as it is loaded (SAME zero padding at the
// true sequence edges stays a zero code), so activations cross device
// memory in float32 once per conv, as in K2.  Tensor-core int8
// (mma.sync / wgmma) is later work.

#include <cstdint>

#include "mrf_common.cuh"

namespace {

using viettts::fit_smem;
using viettts::from_f;
using viettts::lrelu;
using viettts::NT;
using viettts::TL;
using viettts::TN;

constexpr int QK = 32;       // input channels per shared-memory stage
constexpr int QW = QK / 4;   // ... as packed 32-bit words of four codes
constexpr float INV127 = (float)(1.0 / 127.0);  // the f32 constant JAX uses
constexpr int RT = 256;      // amax reduce: threads per block

// Packs the int8 codes of up to four consecutive input channels.
__device__ __forceinline__ int pack4(int word, int q, int j) {
  return word | ((q & 0xff) << (8 * j));
}

// amax[b] = max(amax[b], max_i |lrelu(x[b, i])|) over the n values of row b.
// amax must start at 0: non-negative floats order like their bit patterns.
__global__ void __launch_bounds__(RT) absmax_kernel(const float* __restrict__ x,
                                                    float* __restrict__ amax, long long n) {
  const float* xb = x + (long long)blockIdx.y * n;
  float m = 0.f;
  for (long long i = blockIdx.x * (long long)RT + threadIdx.x; i < n;
       i += (long long)gridDim.x * RT)
    m = fmaxf(m, fabsf(lrelu(xb[i], 0.1f)));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[RT / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < RT / 32 ? part[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(reinterpret_cast<int*>(amax + blockIdx.y), __float_as_int(m));
  }
}

// mode 0: y = v;  mode 1: y += v;  mode 2: out = ((y ? y : 0) + v) / div.
// res may alias y (each element is read and written by one thread); x never does.
// act[b * act_stride] is the activation amax of batch row b (stride 0: one
// calibrated value for all rows).
template <typename TO>
__global__ void __launch_bounds__(NT) conv_int8_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ act, int act_stride, int dynamic,
    const float* res, float* y, TO* out, int L, int C_in, int C_out, int k, int dil, int mode,
    float div) {
  extern __shared__ int smq[];
  const int win = TL + (k - 1) * dil;
  int* xs = smq;               // [win][QW] codes of lrelu(x)
  int* ws = smq + win * QW;    // [k][QW][TN] weight codes
  const int b = blockIdx.z;
  const int l0 = blockIdx.x * TL;
  const int c0n = blockIdx.y * TN;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int half = (k - 1) / 2 * dil;
  const float* xb = x + (size_t)b * L * C_in;
  const float a_raw = act[(size_t)b * act_stride];
  const float a = dynamic ? a_raw : fmaxf(a_raw, 1e-12f);
  const float inv = __fdiv_rn(127.f, dynamic ? fmaxf(a, 1e-30f) : a);
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int c0 = 0; c0 < C_in; c0 += QK) {
    __syncthreads();
    for (int e = tid; e < win * QW; e += NT) {
      const int r = e / QW, kw = e % QW;
      const int l = l0 - half + r;
      int word = 0;
      if (l >= 0 && l < L) {
        const float* xr = xb + (size_t)l * C_in;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = c0 + 4 * kw + j;
          if (ci < C_in) {
            float v = __fmul_rn(lrelu(xr[ci], 0.1f), inv);
            if (!dynamic) v = fminf(fmaxf(v, -127.f), 127.f);
            word = pack4(word, __float2int_rn(v), j);
          }
        }
      }
      xs[e] = word;
    }
    for (int e = tid; e < k * QW * TN; e += NT) {
      const int t = e / (QW * TN), kw = (e / TN) % QW, n = e % TN;
      const int co = c0n + n;
      int word = 0;
      if (co < C_out) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = c0 + 4 * kw + j;
          if (ci < C_in) word = pack4(word, w[((size_t)t * C_in + ci) * C_out + co], j);
        }
      }
      ws[e] = word;
    }
    __syncthreads();
    for (int t = 0; t < k; ++t) {
      const int* xt = xs + t * dil * QW;
      const int* wt = ws + t * QW * TN;
#pragma unroll
      for (int kw = 0; kw < QW; ++kw) {
        int av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = xt[(ty + 32 * i) * QW + kw];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = wt[kw * TN + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = c0n + tx + 8 * j;
    if (co >= C_out) continue;
    const float mult = dynamic ? __fmul_rn(__fmul_rn(a, INV127), scale[co])
                               : __fmul_rn(scale[co], __fdiv_rn(a, 127.f));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + ty + 32 * i;
      if (l >= L) continue;
      const size_t o = ((size_t)b * L + l) * C_out + co;
      float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), mult), bias[co]);
      if (res) v = __fadd_rn(v, res[o]);
      if (mode == 0) {
        y[o] = v;
      } else if (mode == 1) {
        y[o] = __fadd_rn(y[o], v);
      } else {
        out[o] = from_f<TO>(__fdiv_rn(y ? __fadd_rn(y[o], v) : v, div));
      }
    }
  }
}

template <typename TO>
int launch_conv_int8(const void* x, const void* w, const void* scale, const void* bias,
                     const void* act, int act_stride, int dynamic, const void* res, void* y,
                     void* out, int B, int L, int C_in, int C_out, int k, int dil, int mode,
                     float div, cudaStream_t s) {
  const size_t smem = sizeof(int) * ((size_t)(TL + (k - 1) * dil) * QW + (size_t)k * QW * TN);
  cudaError_t err = fit_smem(conv_int8_kernel<TO>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + TL - 1) / TL, (C_out + TN - 1) / TN, B);
  conv_int8_kernel<TO><<<grid, NT, smem, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(act), act_stride, dynamic, static_cast<const float*>(res),
      static_cast<float*>(y), static_cast<TO*>(out), L, C_in, C_out, k, dil, mode, div);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int viettts_mrf_conv_int8(int out_bf16, const void* x, const void* w,
                                     const void* scale, const void* bias, const void* act,
                                     int act_stride, int dynamic, const void* res, void* y,
                                     void* out, int B, int L, int C_in, int C_out, int k,
                                     int dil, int mode, float div, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_conv_int8<__nv_bfloat16>(x, w, scale, bias, act, act_stride, dynamic, res, y,
                                           out, B, L, C_in, C_out, k, dil, mode, div, s);
  return launch_conv_int8<float>(x, w, scale, bias, act, act_stride, dynamic, res, y, out, B, L,
                                 C_in, C_out, k, dil, mode, div, s);
}

// amax [B] float32, zeroed by the caller; x [B, n] float32.
extern "C" int viettts_mrf_absmax(const void* x, void* amax, int B, long long n, void* stream) {
  long long blocks = (n + RT - 1) / RT;
  if (blocks > 1024) blocks = 1024;
  absmax_kernel<<<dim3((unsigned)blocks, B), RT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(amax), n);
  return (int)cudaGetLastError();
}
