// The int8 route of a HiFi-GAN generator stage (K3): its 18 MRF convs on
// the int8 tensor cores, its ConvTranspose prologue on the FP64 tensor
// cores, and the per-row amax reduce that the dynamic scales need.
//
// Replaces the quantize_int8 mode of the TPU kernel
// viettts_tpu/ops/mrf.py::fused_mrf (_mrf_kernel, mrf.py:280-357 in the
// kernel, :568-600 on the host), which ran each of a stage's 18 MRF convs
// as int8 x int8 -> int32 MXU passes over space-to-depth packed tiles.
// Both convs here run in K2's implicit-GEMM pipeline (mma_conv_kernel,
// mrf_common.cuh), with the same tiles, shifted windows, cp.async ring and
// k-groups:
//
// * MRF conv (Int8Mma, mma.sync m16n8k32 s8 x s8 -> s32):
//     q[l, ci] = rint(lrelu(x[l, ci]) * inv)     (static: clipped to +-127)
//     v[l, co] = float(sum_{t, ci} q[l + (t - (k-1)/2) * dil, ci] * w[t, ci, co])
//                * mult[co] + bias[co] (+ res[l, co])
//   static:  a = max(act, 1e-12), inv = 127 / a, mult = scale[co] * (a / 127)
//   dynamic: a = amax of |lrelu(x)| over the batch row, inv = 127 / max(a, 1e-30),
//            mult = (a * (1/127)) * scale[co]
//   in exactly the float32 operations and order of the TPU kernel and of the
//   plain twin (ops/mrf.py::_conv_int8): explicit _rn intrinsics keep nvcc
//   from contracting the dequant multiply and the bias add into one FMA,
//   and rounding is half to even (__float2int_rn, as jnp.round), never
//   roundf.  The window is quantized as it is staged into shared memory, so
//   activations cross device memory in float32 once per conv, as in K2.
//   The int32 sums are exact (|sum| <= k * C_in * 127^2 < 2^31 for k * C_in
//   below 133,000; the default's largest is 11 * 256), so a conv
//   fed the same float32 input gives bitwise the twin's output.  ldmatrix
//   .trans moves 16-bit elements only, so the weight codes come K-major,
//   [k, C_out, C_in] (Int8Conv.kmajor, made once on the host).
// * ConvTranspose prologue (F64Mma, mma.sync m16n8k8 f64): the u
//   interleaved stride-1 convs of K2's float prologue, with A =
//   double(lrelu(x)), float64 weights [k, C_out, C_in] (F64Conv.kmajor, an
//   exact conversion) and float64 sums, rounded once to float32 and then
//   added to the bias.  A float32 x float32 product is exact in float64,
//   so only the order of the float64 sums differs from the twin's: ~1e-16
//   relative, far below a float32 ulp, and kernel and twin give the first
//   conv's input the same int8 codes (TF32 splits keep 22 of 24 bits and
//   would flip some).
//
// With static (calibrated) scales the MRF convs of the stages that
// ops/mrf.py::plan_fused gives the fused pipeline run there instead
// (mrf_fused.cuh, viettts_mrf_fused_int8 below): wgmma s8 x s8 -> s32
// over whole resblocks on chip, in the same float32 order, so each conv
// stays bitwise the twin's; at C = 128 and 256 they take the per-conv
// wgmma pipeline (mrf_conv_wgmma.cuh, viettts_mrf_conv_wgmma_int8 below),
// whose epilogues write the next conv's int8 codes, bitwise the codes
// mma_conv_kernel computes from the float32 values.  Dynamic scales take
// the same pipeline where its plan says so (viettts_mrf_conv_wgmma_int8_dynamic
// below): a conv's amax spans its whole input row, which no tile can know
// before the previous conv ends, so each producing epilogue writes float32
// and folds its amax, and a quantize pass writes the codes; elsewhere
// mma_conv_kernel, with an absmax pass before each conv.
//
// What bounds it on the H100: the MRF convs' 2 * B * L * C^2 * 126
// operations at the dense int8 rate (1,979 TOP/s), the prologue's
// 2 * B * L * C * C_in * k/u at the FP64 tensor rate (67 TFLOP/s); bytes
// are small (each conv reads and writes one float32 [B, L, C] tensor,
// which the stage keeps in L2).  The per-iteration overhead of the
// pipeline (barriers, the window's conversion) is the same as K2's bf16
// route, whose MRF tensor work an int8 k32 step halves.

#include <cstdint>

#include "mrf_common.cuh"
#include "mrf_conv_wgmma.cuh"
#include "mrf_fused.cuh"

namespace {

using viettts::ConvArgs;
using viettts::F64Mma;
using viettts::Int8Mma;
using viettts::launch_mma_conv;
using viettts::launch_tile;
using viettts::lrelu;
using viettts::pick_tile;

constexpr int RT = 256;  // amax reduce: threads per block

// amax[b] = max(amax[b], max_i |lrelu(x[b, i])|) over the n values of row b.
// amax must start at 0: non-negative floats order like their bit patterns.
// tw.n > 0: row b is tile window b of the full-sequence x [tw.B, tw.seq, C]
// (viettts::TileWin), n = L * C its L rows: the values of its rows inside
// the sequence (the others are 0).
__global__ void __launch_bounds__(RT) absmax_kernel(const float* __restrict__ x,
                                                    float* __restrict__ amax, long long n,
                                                    const viettts::TileWin tw, int C) {
  const float* xb = x + (long long)blockIdx.y * n;
  if (tw.n) {
    const int start = viettts::win_row(tw, blockIdx.y).start;
    const int lo = start < 0 ? 0 : start, hi = min(start + (int)(n / C), tw.seq);
    xb = x + ((long long)(blockIdx.y % tw.B) * tw.seq + lo) * C;
    n = hi > lo ? (long long)(hi - lo) * C : 0;
  }
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

// tile < 0 picks the tile shape from the problem size, else indexes TILES.
// Convs of at most 32 input channels take 32-channel chunks in the tile
// whose single k-group takes a whole chunk (the last stage's pick); a
// tile that splits the k-steps between two groups needs two k32 steps a
// chunk, so it takes 64-channel chunks, half zeros.
int launch_int8(int tile, const ConvArgs& a, cudaStream_t s) {
  if (tile < 0) tile = pick_tile(a.B * a.u, a.L_in, a.C_out);
  if (a.C_in <= 32 && tile == 2) return launch_mma_conv<Int8Mma<32>, 128, 32, 32, 16, 1>(a, s);
  return launch_tile<Int8Mma<64>>(tile, a, s);
}

}  // namespace

// One int8 MRF conv (SAME, dilation dil) on the tensor cores.  x float32
// [B, L, C_in]; w the int8 codes [k, C_out, C_in]; scale [C_out]; act: the
// activation amax of batch row b at act[b * act_stride] (dynamic: this
// row's, else the calibrated one); mode 0: y = v;  1: y += v;  2: out = (y ?
// y + v : v) / div, bf16 if out_bf16 else float32.  res may alias y.
extern "C" int viettts_mrf_conv_int8(int out_bf16, const void* x, const void* w,
                                     const void* scale, const void* bias, const void* act,
                                     int act_stride, int dynamic, const void* res, void* y,
                                     void* out, int B, int L, int C_in, int C_out, int k,
                                     int dil, int mode, int tile, float div, void* stream) {
  const ConvArgs a{x, w, bias, res, y, out, out_bf16, B, L, 1, (k - 1) / 2 * dil, C_in, C_out,
                   k, dil, mode, div, scale, act, act_stride, dynamic};
  return launch_int8(tile, a, static_cast<cudaStream_t>(stream));
}

// The int8 route's ConvTranspose prologue on the FP64 tensor cores, as u
// interleaved stride-1 convs.  x float32 [B, L_in, C_in]; w float64
// [k, C_out, C_in]; y float32 [B, L_in * u, C_out] = float(float64 sum) +
// bias.  tile < 0 picks the tile shape from the problem size.
extern "C" int viettts_mrf_convt_f64(const void* x, const void* w, const void* bias, void* y,
                                     int B, int L_in, int C_in, int C_out, int k, int u,
                                     int pad_a, int tile, void* stream) {
  const ConvArgs a{x, w, bias, nullptr, y, nullptr, 0, B, L_in, u, pad_a, C_in, C_out, k, 1, 0, 1.f};
  if (tile < 0) tile = pick_tile(B * u, L_in, C_out);
  return launch_tile<F64Mma>(tile, a, static_cast<cudaStream_t>(stream));
}

namespace {
int absmax_launch(const void* x, void* amax, int B, long long n, viettts::TileWin tw, int C, cudaStream_t s) {
  long long blocks = (n + RT - 1) / RT;
  if (blocks > 1024) blocks = 1024;
  absmax_kernel<<<dim3((unsigned)blocks, B), RT, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(amax),
                                                          n, tw, C);
  return (int)cudaGetLastError();
}
}  // namespace

// amax [B] float32, zeroed by the caller; x [B, n] float32.
extern "C" int viettts_mrf_absmax(const void* x, void* amax, int B, long long n, void* stream) {
  return absmax_launch(x, amax, B, n, viettts::TileWin{}, 1, static_cast<cudaStream_t>(stream));
}

// A stage's int8 MRF convs (plan rows of viettts::PLAN_FIELDS, see there),
// each as viettts_mrf_conv_int8 with the tile picked by shape, after
// filling its act[b] with the amax of its input's row b where dynamic
// (act zeroed by the caller); stops at the first error.
extern "C" int viettts_mrf_conv_int8_plan(int out_bf16, int B, int L, int C, float div, int n,
                                          const void* plan, void* stream) {
  const long long* rows = static_cast<const long long*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    const ConvArgs a = viettts::plan_conv(rows + (size_t)i * viettts::PLAN_FIELDS, out_bf16, B, L, C, div);
    int err = 0;
    if (a.dynamic) err = viettts_mrf_absmax(a.x, const_cast<void*>(a.act), B, (long long)L * C, stream);
    if (err == 0) err = launch_int8(-1, a, s);
    if (err != 0) return err;
  }
  return 0;
}

// The static-scale int8 MRF of a stage on the fused pipeline
// (mrf_fused.cuh): as viettts_mrf_fused, with w1, w2 the K-major codes
// [units, k, C_out, C_in], s1, s2 their scales [units, C] and act the
// calibrated amaxes in flat conv order (act_scales).
extern "C" int viettts_mrf_fused_int8(int out_bf16, int B, int L, int C, int n_res, int win, int bm, int stages,
                                      int ctas, const void* x, const void* res, const void* act, void* out,
                                      void* stream) {
  return viettts::fused_launch<viettts::FRoute::kInt8>(out_bf16, B, L, C, n_res, win, bm, stages, ctas, x, res,
                                                       act, out, static_cast<cudaStream_t>(stream));
}

// The static-scale int8 MRF convs of a stage of width C = 128 or 256 on the
// per-conv wgmma pipeline (mrf_conv_wgmma.cuh): as viettts_mrf_conv_wgmma,
// w the int8 weight slots, scale and act (act_next) the conv's scales.
extern "C" int viettts_mrf_conv_wgmma_int8(int out_bf16, int B, int L, int C, float div, int n, const void* table,
                                           void* stream) {
  return viettts::conv_wgmma_stage<viettts::FRoute::kInt8>(out_bf16, B, L, C, div, n, table, 0,
                                                           static_cast<cudaStream_t>(stream));
}

// The dynamic-scale int8 MRF convs of a stage on the per-conv wgmma
// pipeline: amax [n_amax, B] float32 is zeroed (a memset node under
// capture), its row 0 filled with the amax of lrelu(h) over each batch row
// (absmax_kernel: the stage input, read by every resblock's first conv),
// h_op gets h's codes at it (chunk-major [B][C / 16][L][16]), then the n
// convs of the table as viettts_mrf_conv_wgmma_int8's, with act and
// act_next their amax rows; a conv with an operand to write writes y,
// folds its amax into act_next and is followed by its quantize pass.
// win_n > 0: the run's B = win_n * win_B rows are the TPU kernel's tile
// windows (viettts::TileWin) of a stage of win_B rows of seq steps, L =
// tile + 2 * halo: h is the full-sequence stage input [win_B, seq, C],
// every row outside the sequence is 0, and with out_win the last conv
// writes each window's tile into out [win_B, seq, C].
extern "C" int viettts_mrf_conv_wgmma_int8_dynamic(int out_bf16, int B, int L, int C, float div, int n,
                                                   const void* table, const void* h, void* h_op, void* amax,
                                                   int n_amax, int win_n, int win_B, int tile, int halo, int seq,
                                                   int out_win, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_amax < 1 || B < 1 || !h || !h_op || !amax) return (int)cudaErrorInvalidValue;
  const viettts::TileWin tw{win_n, win_B, tile, halo, seq};
  if (win_n && (win_n < 1 || win_B < 1 || B != win_n * win_B || L != tile + 2 * halo || tile < 1 || halo < 0 ||
                seq != win_n * tile))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(amax, 0, sizeof(float) * (size_t)n_amax * B, s);
  if (err == 0) err = absmax_launch(h, amax, B, (long long)L * C, tw, C, s);
  if (err == 0) {
    const long long row[2] = {(long long)reinterpret_cast<uintptr_t>(h_op), (long long)reinterpret_cast<uintptr_t>(amax)};
    err = viettts::conv_operands<viettts::FRoute::kInt8>(B, L, C, h, 1, row, 1, s, tw);
  }
  if (err == 0)
    err = viettts::conv_wgmma_stage<viettts::FRoute::kInt8>(out_bf16, B, L, C, div, n, table, 1, s, h, tw, out_win);
  return err;
}

// The int8 codes of lrelu(h), one tensor per calibrated amax: rows n x
// (out, act) int64, out chunk-major [B][C / 16][L][16].
extern "C" int viettts_mrf_conv_operands_int8(int B, int L, int C, const void* h, int n, const void* rows,
                                              void* stream) {
  return viettts::conv_operands<viettts::FRoute::kInt8>(B, L, C, h, n, rows, 0, static_cast<cudaStream_t>(stream));
}
