// Pieces shared by the generator-stage kernels K2 (mrf.cu) and K3
// (mrf_int8.cu): storage-type conversions, leaky_relu, the opt-in to more
// than 48 KB of dynamic shared memory, and the per-conv tensor-core
// pipeline (mma_conv_kernel) that both files instantiate, each for its own
// routes.  It runs the ConvTranspose prologues, and the MRF convs of the
// stages that neither the fused pipeline (mrf_fused.cuh) nor the per-conv
// wgmma pipeline (mrf_conv_wgmma.cuh) takes: widths outside their plans,
// and the shapes where the card measured them slower.  Routes:
//
// * Bf16Mma (K2, bf16 route): A = bf16(lrelu(x)), weights bf16, float32
//   accumulation, mma.sync m16n8k16.
// * Tf32Mma (K2, float32 route): 3xTF32, mma.sync m16n8k8.
// * Int8Mma (K3, MRF convs): A = the int8 codes of lrelu(x), quantized as
//   the window is staged, int8 weight codes, exact int32 accumulation,
//   mma.sync m16n8k32 s8 -> s32.
// * F64Mma (K3, ConvTranspose prologue): A = double(lrelu(x)), float64
//   weights, float64 accumulation on the FP64 tensor cores, mma.sync
//   m16n8k8 f64.
//
// Each conv is an implicit GEMM (M = time, N = C_out, K = taps x C_in).  A
// block owns a BM x BN output tile and walks K as (input-channel chunk,
// tap).  Per chunk one input window, the tile plus the dilated halo (BM +
// (k-1)*dil rows), sits in shared memory; tap t reads it shifted by t*dil
// rows (ldmatrix takes any 16-byte-aligned row address), so one load
// serves all k taps.  The raw float32 window of the next chunk is fetched
// with cp.async in slices, one per tap of the current chunk, and each
// thread converts (lrelu, then the route's rounding or quantization) the
// slots it fetched itself; the per-tap weight tiles run in a cp.async ring
// of STAGES slots.  Tile shapes are picked per launch so that narrow
// stages and B=1 still put about 8 warps on every SM.  SAME zero padding
// at the true sequence edges is applied as the window is loaded
// (positions outside [0, L) and channels past C_in read 0, and lrelu(0) =
// 0 quantizes to code 0), so every conv's output equals the TPU kernel's
// re-zeroed intermediates.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace viettts {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float lrelu(float v, float slope) { return v > 0.f ? v : slope * v; }

constexpr float INV127 = (float)(1.0 / 127.0);  // the f32 constant JAX uses

// Host-side results kept per CUDA device: function attributes and device
// properties belong to one device, and a process may launch on several.
constexpr int MAX_DEVICES = 64;

// The current device, or -1 past MAX_DEVICES or on an error.
inline int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return -1;
  return dev;
}

// Opt a kernel in to the most dynamic shared memory a block may have on
// device dev.
template <typename K>
cudaError_t opt_in_smem(K kernel, int dev) {
  int bytes = 0;
  cudaError_t err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

// opt_in_smem once per device instead of an API call per launch (a stage
// launches 18 convs), so that the launches a CUDA graph captures make no
// other API call; a launch that needs more is refused.  ``state`` is
// the kernel's own array of MAX_DEVICES flags (0: not yet, else error + 1),
// a static of the launcher instantiated for that kernel: kernels of one
// signature share a function-pointer type, so a static in here would be
// shared by all of them.  Two threads racing on the first launch both opt
// in, which is harmless.
template <typename K>
cudaError_t opt_in_smem_once(K kernel, std::atomic<int>* state) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  int s = state[dev].load(std::memory_order_acquire);
  if (s == 0) {
    s = (int)opt_in_smem(kernel, dev) + 1;
    state[dev].store(s, std::memory_order_release);
  }
  return (cudaError_t)(s - 1);
}

// --- tensor-core building blocks (sm_80+ PTX, m16n8k8 f64 sm_90) ---------

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
// int8 x int8 -> int32, exact: each register holds 4 codes, the lowest k in
// the lowest byte.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// float64 on the FP64 tensor cores (sm_90).  a0 (row g, k tq), a1 (g+8, tq),
// a2 (g, tq+4), a3 (g+8, tq+4); b0 (k tq, n g), b1 (tq+4, g); the
// accumulators as mma_bf16's.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4], double b0,
                                        double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// TF32 round to nearest, ties away from zero; the low 13 bits are cleared
// so that the result is also the float32 value it stands for.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// Tile shapes of the conv: BM x BN outputs per block, WM x WN per warp, and
// KS warp groups that split each chunk's k-steps between them (their sums
// meet in shared memory before the epilogue).  KS = 2 doubles the warps on
// a tile: it keeps 32 x 32 warp tiles where a narrow problem (stage 0 at
// B=1: 1264 x 256 outputs) has few tiles.
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
// default bf16 stages).
constexpr int STAGES = 3;
static_assert(STAGES >= 2 && STAGES - 2 <= 3, "cp_async_wait_upto waits for at most 3 groups");

// The routes.  Shared-memory layout per chunk of KC input channels: raw
// [win][KC] float32 x (cp.async), then the A window, APARTS x [win][SA]
// elements TA; per (chunk, tap) a weight tile in a ring of STAGES slots,
// each WPARTS x [WROWS][SW].  Row strides are padded so that the 8 row
// addresses of an ldmatrix (or the rows of a quarter-warp's 16-byte loads)
// fall on different 16-byte bank groups: 144, 80, 48 or 192 bytes.
// KMAJOR: the weights are [k][C_out][C_in] (a tile row is one output
// channel, contiguous in C_in: plain ldmatrix); else [k][C_in][C_out]
// (ldmatrix.trans, which moves 16-bit elements only).
enum class Route { kBf16, kTf32, kInt8, kF64 };

template <int KC_>
struct Bf16Mma {
  static constexpr Route R = Route::kBf16;
  using TA = __nv_bfloat16;
  using Acc = float;
  static constexpr int KC = KC_;  // 64 (4 k16 steps), or 32 where C_in <= 32
  static constexpr int KSTEP = 16;
  static constexpr int SA = KC + 8;
  static constexpr int APARTS = 1, WPARTS = 1;
  static constexpr int VW = 8;  // weight elements per 16-byte copy
  static constexpr bool KMAJOR = false;
  template <int BN> static constexpr int WROWS = KC;
  template <int BN> static constexpr int SW = BN + 8;
};
struct Tf32Mma {  // A and weights split into TF32 hi, lo; weights [2][k][C_out][C_in]
  static constexpr Route R = Route::kTf32;
  using TA = float;
  using Acc = float;
  static constexpr int KC = 32;  // 4 k8 steps
  static constexpr int KSTEP = 8;
  static constexpr int SA = KC + 4;
  static constexpr int APARTS = 2, WPARTS = 2;
  static constexpr int VW = 4;
  static constexpr bool KMAJOR = true;
  template <int BN> static constexpr int WROWS = BN;
  template <int BN> static constexpr int SW = KC + 4;
};
template <int KC_>
struct Int8Mma {  // codes; weights [k][C_out][C_in] int8
  static constexpr Route R = Route::kInt8;
  using TA = int8_t;
  using Acc = int;
  static constexpr int KC = KC_;  // 64 (2 k32 steps), or 32 where C_in <= 32 and KS = 1
  static constexpr int KSTEP = 32;
  static constexpr int SA = KC + 16;
  static constexpr int APARTS = 1, WPARTS = 1;
  static constexpr int VW = 16;
  static constexpr bool KMAJOR = true;
  template <int BN> static constexpr int WROWS = BN;
  template <int BN> static constexpr int SW = KC + 16;
};
struct F64Mma {  // weights [k][C_out][C_in] float64
  static constexpr Route R = Route::kF64;
  using TA = double;
  using Acc = double;
  static constexpr int KC = 16;  // 2 k8 steps: 8-byte operands, small chunks
  static constexpr int KSTEP = 8;
  static constexpr int SA = KC + 8;
  static constexpr int APARTS = 1, WPARTS = 1;
  static constexpr int VW = 2;
  static constexpr bool KMAJOR = true;
  template <int BN> static constexpr int WROWS = BN;
  template <int BN> static constexpr int SW = KC + 8;
};

// Arguments of one launch of mma_conv_kernel (see there).
struct ConvArgs {
  const void *x, *w, *bias, *res;
  void *y, *out;
  int out_bf16, B, L_in, u, pad_a, C_in, C_out, k, dil, mode;
  float div;
  // Int8Mma only: per-output-channel weight scales, and the activation
  // amax of batch row b at act[b * act_stride] (stride 0: one calibrated
  // value for all rows), dynamic or calibrated (static: clipped).
  const void *scale, *act;
  int act_stride, dynamic;
  int vec_x, vec_w;  // set by launch_mma_conv: 16-byte copies are legal
};

// A stage's MRF convs as one launch plan (one C call instead of one host
// call per conv, whose cost is about a small conv's device time): row i
// holds conv i's x, w, bias, res, y, out, scale, act (addresses, 0 for
// none), k, dil, mode, act_stride, dynamic.
constexpr int PLAN_FIELDS = 13;

inline ConvArgs plan_conv(const long long* r, int out_bf16, int B, int L, int C, float div) {
  auto ptr = [](long long v) { return reinterpret_cast<void*>(static_cast<uintptr_t>(v)); };
  const int k = (int)r[8], dil = (int)r[9];
  return ConvArgs{ptr(r[0]), ptr(r[1]), ptr(r[2]), ptr(r[3]), ptr(r[4]), ptr(r[5]), out_bf16, B, L, 1,
                  (k - 1) / 2 * dil, C, C, k, dil, (int)r[10], div, ptr(r[6]), ptr(r[7]), (int)r[11],
                  (int)r[12]};
}

template <typename T, int BM, int BN, int KS>
constexpr size_t conv_smem_bytes(int win) {
  const size_t pipe = (size_t)win * T::KC * 4 +
                      (size_t)T::APARTS * win * T::SA * sizeof(typename T::TA) +
                      (size_t)STAGES * T::WPARTS * T::template WROWS<BN> * T::template SW<BN> *
                          sizeof(typename T::TA);
  const size_t red = (size_t)(KS - 1) * BM * BN * sizeof(typename T::Acc);  // k-groups' partial sums
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
// The epilogue turns the sum into v: float routes acc + bias; F64Mma
// float(acc) + bias (one float32 rounding of the float64 sum of exact
// products); Int8Mma float(acc) * mult[co] + bias with mult the two
// scales' product (the TPU kernel's order, mrf.py:280-357, in _rn
// intrinsics so that nvcc fuses nothing).  mode 0: y = v;  mode 1: y += v;
// mode 2: out = (y ? y + v : v) / div, out bf16 if out_bf16 else float32.
// res may alias y (each element is read and written by one thread); x
// never does.
template <typename T, int BM, int BN, int WM, int WN, int KS>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * KS * 32)
    mma_conv_kernel(const ConvArgs args) {
  using TA = typename T::TA;
  using Acc = typename T::Acc;
  constexpr Route R = T::R;
  constexpr int NWM = BM / WM, NWG = NWM * (BN / WN), NTH = NWG * KS * 32;
  constexpr int KC = T::KC, SA = T::SA, VW = T::VW, KSTEP = T::KSTEP;
  constexpr int WROWS = T::template WROWS<BN>, SW = T::template SW<BN>;
  constexpr int WTILE = WROWS * SW;  // elements of one weight part of one slot
  constexpr int MT = WM / 16, NT8 = WN / 8;
  constexpr int KQ = KC / 4;                // 16-byte pieces per raw window row
  constexpr int E16 = 16 / sizeof(TA);      // elements per 16 bytes (an ldmatrix row)
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BN % VW == 0 && KC % VW == 0, "tile shape");
  static_assert((KC / KSTEP) % KS == 0, "the k-groups split a chunk's k-steps evenly");

  const float* __restrict__ x = static_cast<const float*>(args.x);
  const float* __restrict__ bias = static_cast<const float*>(args.bias);
  const float* res = static_cast<const float*>(args.res);
  float* y = static_cast<float*>(args.y);
  const int L_in = args.L_in, u = args.u, pad_a = args.pad_a, C_in = args.C_in;
  const int C_out = args.C_out, k = args.k, dil = args.dil;

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

  // Int8Mma: this batch row's activation scale.  static: am = max(act,
  // 1e-12), inv = 127 / am, mult = scale[co] * (am / 127); dynamic: am = the
  // row's amax, inv = 127 / max(am, 1e-30), mult = (am * (1/127)) * scale[co].
  const bool dynamic = args.dynamic;
  float inv = 0.f, dq = 0.f;
  if constexpr (R == Route::kInt8) {
    const float a_raw = static_cast<const float*>(args.act)[(size_t)b * args.act_stride];
    const float am = dynamic ? a_raw : fmaxf(a_raw, 1e-12f);
    inv = __fdiv_rn(127.f, dynamic ? fmaxf(am, 1e-30f) : am);
    dq = dynamic ? __fmul_rn(am, INV127) : __fdiv_rn(am, 127.f);
  }

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
      if (args.vec_x) {
        const bool ok = row_ok && ci < C_in;
        cp_async16(dst, ok ? xb + (size_t)l * C_in + ci : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = (row_ok && ci + j < C_in) ? xb[(size_t)l * C_in + ci + j] : 0.f;
      }
    }
  };
  // raw -> A window: lrelu, then bf16 rounding, the TF32 split, the int8
  // codes (in the twin's float32 order: x * inv, the static clip, round
  // half to even) or the exact float64 value.
  auto convert = [&]() {
    for (int i = 0; i < n_per; ++i) {
      const int e = tid + i * NTH;
      if (e >= n_raw) break;
      const int r = e / KQ, q = e % KQ;
      const float4 v = *reinterpret_cast<const float4*>(raw + r * KC + 4 * q);
      const float a[4] = {lrelu(v.x, 0.1f), lrelu(v.y, 0.1f), lrelu(v.z, 0.1f),
                          lrelu(v.w, 0.1f)};
      TA* d = xa + r * SA + 4 * q;
      if constexpr (R == Route::kBf16) {
        __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(d);
        d2[0] = __floats2bfloat162_rn(a[0], a[1]);
        d2[1] = __floats2bfloat162_rn(a[2], a[3]);
      } else if constexpr (R == Route::kTf32) {
        float hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hi[j] = __uint_as_float(tf32_rna(a[j]));
          lo[j] = __uint_as_float(tf32_rna(a[j] - hi[j]));
        }
        *reinterpret_cast<float4*>(d) = make_float4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<float4*>(d + (size_t)win * SA) = make_float4(lo[0], lo[1], lo[2], lo[3]);
      } else if constexpr (R == Route::kInt8) {
        unsigned word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float f = __fmul_rn(a[j], inv);
          if (!dynamic) f = fminf(fmaxf(f, -127.f), 127.f);
          word |= (unsigned)(__float2int_rn(f) & 0xff) << (8 * j);
        }
        *reinterpret_cast<unsigned*>(d) = word;
      } else {
        double2* d2 = reinterpret_cast<double2*>(d);
        d2[0] = make_double2(a[0], a[1]);
        d2[1] = make_double2(a[2], a[3]);
      }
    }
  };
  // Weight tile of (chunk c, tap t) into ring slot `slot`.
  auto load_w = [&](int c, int t, int slot) {
    const TA* w = static_cast<const TA*>(args.w);
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
        if constexpr (!T::KMAJOR) {  // row ci of [k][C_in][C_out]: VW output channels
          const int kr = e / (BN / VW), q = e % (BN / VW);
          ci = c * KC + kr;
          co = n0 + VW * q;
          src = ((size_t)t * C_in + ci) * C_out + co;
          dst = dst0 + kr * SW + VW * q;
        } else {  // row co of [(2)][k][C_out][C_in]: VW input channels
          const int nr = e / (KC / VW), q = e % (KC / VW);
          co = n0 + nr;
          ci = c * KC + VW * q;
          src = pt * w_part + ((size_t)t * C_out + co) * C_in + ci;
          dst = dst0 + nr * SW + VW * q;
        }
        const bool ok = ci < C_in && co < C_out;
        if (args.vec_w) {
          cp_async16(dst, ok ? w + src : args.w, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            const bool in =
                T::KMAJOR ? (co < C_out && ci + j < C_in) : (ci < C_in && co + j < C_out);
            dst[j] = in ? w[src + j] : TA(0.f);
          }
        }
      }
    }
  };

  Acc acc[MT][NT8][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = Acc(0);

  // ldmatrix lane addressing: lanes 8j..8j+7 give the row addresses of matrix j
  const int lrow = (lane % 8) + ((lane / 8) % 2) * 8;  // matrices 1, 3: rows 8-15
  const int lcol = lane / 16;                           // matrices 2, 3: second column block
  const int g = lane / 4, tq = lane % 4;

  // Pipeline: iteration (chunk c, tap j).  Weight tiles run STAGES - 1
  // iterations ahead (chunk cw, tap jw); the next chunk's raw window is
  // fetched in slices on the first R taps.  At a chunk's first tap, the
  // groups younger than the last slice (kp - R of them) may stay in flight.
  const int n_it = nc * kp;
  const int RS = kp - STAGES + 2 > 1 ? kp - STAGES + 2 : 1;
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
    cp_async_wait_upto(j == 0 && c > 0 ? kp - RS : STAGES - 2);
    __syncthreads();  // all warps are done with the previous iteration
    if (j == 0) {
      convert();
      __syncthreads();
    }
    if (c + 1 < nc && j < RS) load_raw(c + 1, j, RS);
    if (it + STAGES - 1 < n_it) load_w(cw, t0 + jw * u, slot_w);
    cp_async_commit();
    if (++jw == kp) jw = 0, ++cw;
    slot_w = slot_w + 1 == STAGES ? 0 : slot_w + 1;

    const TA* xt = xa + (size_t)(j * dil + wm * WM) * SA;
    const TA* wt = ws + (size_t)slot * T::WPARTS * WTILE;
#pragma unroll
    for (int kk = 0; kk < KC / KSTEP / KS; ++kk) {
      const int ks = (kk * KS + kg) * KSTEP;  // this k-group's k-steps
      if constexpr (R == Route::kBf16) {
        unsigned af[MT][4], bfr[NT8][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                  xt + (mi * 16 + lrow) * SA + ks + lcol * E16);
#pragma unroll
        for (int nj = 0; nj < NT8 / 2; ++nj)
          ldsm_x4_trans(bfr[2 * nj][0], bfr[2 * nj][1], bfr[2 * nj + 1][0], bfr[2 * nj + 1][1],
                        wt + (ks + lrow) * SW + wn * WN + nj * 16 + lcol * 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT8; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
      } else if constexpr (R == Route::kTf32 || R == Route::kInt8) {
        // A: 16 rows x 16 bytes per matrix, the second column block 16 bytes
        // on; B [co][ci] tiles: lanes 0-7 / 8-15 / 16-23 / 24-31 address b0
        // and b1 of n-tile 2nj, then b0 and b1 of n-tile 2nj + 1.  A TF32
        // k8 step and an int8 k32 step are both 32 bytes of k.
        constexpr int NP = R == Route::kTf32 ? 2 : 1;  // TF32 parts hi, lo
        unsigned af[NP][MT][4], bfr[NP][NT8][2];
#pragma unroll
        for (int pt = 0; pt < NP; ++pt) {
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            ldsm_x4(af[pt][mi][0], af[pt][mi][1], af[pt][mi][2], af[pt][mi][3],
                    xt + (size_t)pt * win * SA + (mi * 16 + lrow) * SA + ks + lcol * E16);
#pragma unroll
          for (int nj = 0; nj < NT8 / 2; ++nj)
            ldsm_x4(bfr[pt][2 * nj][0], bfr[pt][2 * nj][1], bfr[pt][2 * nj + 1][0],
                    bfr[pt][2 * nj + 1][1],
                    wt + pt * WTILE + (wn * WN + nj * 16 + lane % 8 + lcol * 8) * SW + ks +
                        ((lane / 8) % 2) * E16);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT8; ++ni) {
            if constexpr (R == Route::kTf32) {  // lo*hi + hi*lo + hi*hi
              mma_tf32(acc[mi][ni], af[1][mi], bfr[0][ni][0], bfr[0][ni][1]);
              mma_tf32(acc[mi][ni], af[0][mi], bfr[1][ni][0], bfr[1][ni][1]);
              mma_tf32(acc[mi][ni], af[0][mi], bfr[0][ni][0], bfr[0][ni][1]);
            } else {
              mma_s8(acc[mi][ni], af[0][mi], bfr[0][ni][0], bfr[0][ni][1]);
            }
          }
      } else {
        // float64: plain 16-byte loads (ldmatrix has no 8-byte elements).
        // Thread tq's two k positions of a k8 step, tq and tq + 4 in the
        // fragment, are fed the window's k = 2tq and 2tq + 1 in both A and B,
        // a relabelling of k that only reorders the sum.
        double af[MT][4], bfr[NT8][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const double2 lo = *reinterpret_cast<const double2*>(xt + (mi * 16 + g) * SA + ks + 2 * tq);
          const double2 hi =
              *reinterpret_cast<const double2*>(xt + (mi * 16 + g + 8) * SA + ks + 2 * tq);
          af[mi][0] = lo.x;
          af[mi][1] = hi.x;
          af[mi][2] = lo.y;
          af[mi][3] = hi.y;
        }
#pragma unroll
        for (int ni = 0; ni < NT8; ++ni) {
          const double2 v =
              *reinterpret_cast<const double2*>(wt + (wn * WN + ni * 8 + g) * SW + ks + 2 * tq);
          bfr[ni][0] = v.x;
          bfr[ni][1] = v.y;
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT8; ++ni) mma_f64(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
      }
    }
    if (++j == kp) j = 0, ++c;
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  if constexpr (KS > 1) {  // k-groups 1.. hand their sums to group 0 through shared memory
    __syncthreads();
    Acc* red = reinterpret_cast<Acc*>(smem);  // [KS-1][MT*NT8*4][NWG*32]
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
        float v;
        if constexpr (R == Route::kInt8) {
          const float sc = static_cast<const float*>(args.scale)[co];
          const float mult = dynamic ? __fmul_rn(dq, sc) : __fmul_rn(sc, dq);
          v = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][r]), mult), bias[co]);
        } else if constexpr (R == Route::kF64) {
          v = __fadd_rn(__double2float_rn(acc[mi][ni][r]), bias[co]);
        } else {
          v = __fadd_rn(acc[mi][ni][r], bias[co]);
        }
        if (res) v = __fadd_rn(v, res[o]);
        if (args.mode == 0) {
          y[o] = v;
        } else if (args.mode == 1) {
          y[o] = __fadd_rn(y[o], v);
        } else {
          const float mean = __fdiv_rn(y ? __fadd_rn(y[o], v) : v, args.div);
          if (args.out_bf16)
            static_cast<__nv_bfloat16*>(args.out)[o] = __float2bfloat16(mean);
          else
            static_cast<float*>(args.out)[o] = mean;
        }
      }
}

// The current device's SM count, read once per device (132 if unknown).
inline int sm_count() {
  static std::atomic<int> count[MAX_DEVICES];
  const int dev = current_device();
  if (dev < 0) return 132;
  int n = count[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) n = 132;
    count[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// The largest tile that still puts about 8 warps on every SM; BN = 64 only
// where C_out fills it.
inline int pick_tile(int B, int L, int C_out) {
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

template <typename T, int BM, int BN, int WM, int WN, int KS>
int launch_mma_conv(const ConvArgs& a, cudaStream_t s) {
  constexpr int NTH = (BM / WM) * (BN / WN) * KS * 32;
  auto kernel = mma_conv_kernel<T, BM, BN, WM, WN, KS>;
  const size_t smem = conv_smem_bytes<T, BM, BN, KS>(BM + ((a.k + a.u - 1) / a.u - 1) * a.dil);
  static std::atomic<int> opted_on[MAX_DEVICES];
  const cudaError_t opted = opt_in_smem_once(kernel, opted_on);
  if (opted != cudaSuccess) return (int)opted;
  ConvArgs args = a;
  args.vec_x = a.C_in % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  args.vec_w = (T::KMAJOR ? a.C_in : a.C_out) % T::VW == 0 &&
               reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  dim3 grid((a.L_in + BM - 1) / BM, (a.C_out + BN - 1) / BN, a.B * a.u);
  kernel<<<grid, NTH, smem, s>>>(args);
  return (int)cudaGetLastError();
}

// TILES[tile] with route T's chunks.
template <typename T>
int launch_tile(int tile, const ConvArgs& a, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_mma_conv<T, 128, 64, 32, 32, 1>(a, s);
    case 1: return launch_mma_conv<T, 64, 64, 32, 32, 2>(a, s);
    case 2: return launch_mma_conv<T, 128, 32, 32, 16, 1>(a, s);
    case 3: return launch_mma_conv<T, 64, 32, 32, 16, 2>(a, s);
    case 4: return launch_mma_conv<T, 32, 32, 16, 16, 2>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace viettts
