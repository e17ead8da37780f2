// The autoregressive acoustic-decoder loop (K1), whole sequence in one launch.
//
// Replaces the TPU kernel viettts_tpu/ops/ar_decoder.py::ar_decode
// (_ar_kernel), which kept every decoder weight resident in VMEM and
// streamed the conditioning gates chunk by chunk through its sequential
// grid.
//
// What bounds it on the H100: the decode is strictly sequential (frame t's
// prenet reads frame t-1's mel), and each frame is a handful of
// matrix-vector products over about 16.7 MB of float32 weights (at
// H=512, P=256, D=80): far more than one SM's shared memory, but inside
// the 50 MB L2.  Per frame the work is tiny and the dependent phases
// (prenet 1, prenet 2, LSTM 1, LSTM 2, projection) each need a barrier,
// so launch and synchronisation latency, not FLOPs, dominate if every
// phase is its own kernel.
//
// Design: one CTA per batch row with H threads, and the frame loop inside
// the kernel: one launch per decode.  Thread j owns hidden unit j of both
// LSTM layers and computes its four gate columns (j, H+j, 2H+j, 3H+j), so
// the cell update and c stay in registers; row-major [K, 4H] weights make
// those reads coalesced across the CTA.  p, h1 and h2 are broadcast
// through shared memory with __syncthreads() between the phases.  The mel
// projection is split across warps (each sums a slice of [h1, h2] for all
// D outputs) and reduced in shared memory.  Weights are read from global
// memory every frame and stay resident in L2; the limit is then one SM's
// L2 bandwidth, which spreading gate columns across CTAs and bf16 weights
// (later work) address.  expf/tanhf without fast-math keep parity with
// the plain PyTorch loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void ar_decode_kernel(
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
    int B, int L, int H, int P, int D, float scale) {
  extern __shared__ float sm[];
  float* mel = sm;        // [D] previous frame
  float* p1 = mel + D;    // [P] prenet layer 1
  float* pp = p1 + P;     // [P] prenet output
  float* h1 = pp + P;     // [H] } contiguous: [h1, h2] feeds the projection
  float* h2 = h1 + H;     // [H] }
  float* h1n = h2 + H;    // [H] layer-1 output of this frame
  float* part = h1n + H;  // [H / 32][D] projection partial sums
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int H4 = 4 * H;
  const int nwarps = blockDim.x / 32;
  const int warp = j / 32, lane = j % 32;
  const int rows_per_warp = 2 * H / nwarps;

  for (int d = j; d < D; d += blockDim.x) mel[d] = 0.f;
  h1[j] = 0.f;
  h2[j] = 0.f;
  float c1 = 0.f, c2 = 0.f;
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const size_t kbase = ((size_t)t * B + b) * P;
    for (int k = j; k < P; k += blockDim.x) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(mel[d], w_fc1[(size_t)d * P + k], s);
      p1[k] = keep1[kbase + k] ? fmaxf(s, 0.f) * scale : 0.f;
    }
    __syncthreads();
    for (int k = j; k < P; k += blockDim.x) {
      float s = 0.f;
      for (int m = 0; m < P; ++m) s = fmaf(p1[m], w_fc2[(size_t)m * P + k], s);
      pp[k] = keep2[kbase + k] ? fmaxf(s, 0.f) * scale : 0.f;
    }
    __syncthreads();

    // LSTM layer 1: gates = g1c_t + [p, h1] @ W1m
    const size_t gbase = ((size_t)b * L + t) * H4;
    float gi = g1c[gbase + j], gg = g1c[gbase + H + j];
    float gf = g1c[gbase + 2 * H + j], go = g1c[gbase + 3 * H + j];
#pragma unroll 4
    for (int m = 0; m < P + H; ++m) {
      const float v = m < P ? pp[m] : h1[m - P];
      const float* r = w1m + (size_t)m * H4;
      gi = fmaf(v, r[j], gi);
      gg = fmaf(v, r[H + j], gg);
      gf = fmaf(v, r[2 * H + j], gf);
      go = fmaf(v, r[3 * H + j], go);
    }
    c1 = sigmoid(gf + 1.f) * c1 + sigmoid(gi) * tanhf(gg);
    h1n[j] = sigmoid(go) * tanhf(c1);
    __syncthreads();

    // LSTM layer 2: gates = g2c_t + [p, h1', h2] @ W2m
    gi = g2c[gbase + j];
    gg = g2c[gbase + H + j];
    gf = g2c[gbase + 2 * H + j];
    go = g2c[gbase + 3 * H + j];
#pragma unroll 4
    for (int m = 0; m < P + 2 * H; ++m) {
      const float v = m < P ? pp[m] : (m < P + H ? h1n[m - P] : h2[m - P - H]);
      const float* r = w2m + (size_t)m * H4;
      gi = fmaf(v, r[j], gi);
      gg = fmaf(v, r[H + j], gg);
      gf = fmaf(v, r[2 * H + j], gf);
      go = fmaf(v, r[3 * H + j], go);
    }
    c2 = sigmoid(gf + 1.f) * c2 + sigmoid(gi) * tanhf(gg);
    const float h2j = sigmoid(go) * tanhf(c2);
    __syncthreads();  // every read of the old h1, h2 is done
    h1[j] = h1n[j];
    h2[j] = h2j;
    __syncthreads();

    // mel_t = [h1, h2] @ Wp + b: warp w sums rows [w*R, (w+1)*R) for all D
    for (int d = lane; d < D; d += 32) {
      float s = 0.f;
      const int m0 = warp * rows_per_warp;
      for (int m = m0; m < m0 + rows_per_warp; ++m) s = fmaf(h1[m], wp[(size_t)m * D + d], s);
      part[warp * D + d] = s;
    }
    __syncthreads();
    for (int d = j; d < D; d += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += part[w * D + d];
      s += bp[d];
      mel[d] = s;
      out[((size_t)b * L + t) * D + d] = s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int viettts_ar_decode(const void* g1c, const void* g2c, const void* keep1,
                                 const void* keep2, const void* w_fc1, const void* w_fc2,
                                 const void* w1m, const void* w2m, const void* wp,
                                 const void* bp, void* out, int B, int L, int H, int P, int D,
                                 float scale, void* stream) {
  if (H % 32 != 0 || H > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)D + 2 * P + 3 * H + (H / 32) * D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ar_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ar_decode_kernel<<<B, H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g1c), static_cast<const float*>(g2c),
      static_cast<const uint8_t*>(keep1), static_cast<const uint8_t*>(keep2),
      static_cast<const float*>(w_fc1), static_cast<const float*>(w_fc2),
      static_cast<const float*>(w1m), static_cast<const float*>(w2m),
      static_cast<const float*>(wp), static_cast<const float*>(bp), static_cast<float*>(out),
      B, L, H, P, D, scale);
  return (int)cudaGetLastError();
}
