// The per-conv wgmma pipeline shared by K2 (bf16 route, mrf.cu; the
// float32 route's 3xTF32, mrf_tf32.cu) and K3 (int8 with static or dynamic
// scales, mrf_int8.cu): one launch a MRF conv, on Hopper's wgmma fed by
// TMA, each conv's epilogue writing the next conv's operand (or, with
// dynamic scales, folding its amax).
//
// Replaces, for the stages its plan takes (mrf_conv_plan.h), the MRF convs
// of the TPU kernel viettts_tpu/ops/mrf.py:181 (_mrf_kernel), as
// ops/mrf.py::_mrf_stack runs them.  The TPU kernel kept a time tile of the
// stage in VMEM through all its convs; at C = 256 a tile and its halo do
// not fit 227 KB of shared memory, and at C = 128 the fused pipeline
// (mrf_fused.cuh) did not beat the per-conv one.  What bounds these stages
// on the H100 (B=64, 768 mel frames): 2 * B * L * C^2 * 126 operations,
// 6.6 ms (C = 256) and 13.1 ms (C = 128) at the bf16 rate, three times
// that at the TF32 rate for 3xTF32, and the bytes each conv moves.  The
// per-conv pipeline (mma_conv_kernel, mrf_common.cuh) read a float32
// window and a float32 residual and wrote float32 for every conv (about 50
// passes over a stage-sized tensor: ~24 ms at C = 128), converted each
// window in registers before the tensor cores could use it, and read each
// window once per 64-channel column of outputs.  Here:
//
// * Operands are stored, not recomputed: each conv's epilogue writes
//   op(lrelu(v)) for the conv that reads v next: bf16, the int8 codes at
//   the consuming conv's static scale (fused_code), or the TF32 parts hi =
//   rna(u) and lo = rna(u - hi) of u = lrelu(v) (tf32_rna, as Tf32Mma
//   splits its window: 8 bytes an element, read by TMA straight into the
//   ring; splitting float32 in the consumer's registers would halve those
//   bytes, but at C >= 128 the route's 3xTF32 products, not its bytes,
//   bound it).  float32 stays only where a float32 value is read again
//   (the residual trunk and the resblocks' sum).  ResBlock1's intermediate
//   exists only as its second conv's operand.  The stage input's operand
//   comes from one small pass (conv_operand_kernel; static int8: one code
//   tensor per resblock's first scale).
// * Dynamic int8 scales (one amax a conv and batch row, no clip): a row's
//   amax is final only when every tile of the row is done, so a producing
//   epilogue writes float32 v (the trunk, or a scratch for ResBlock1's
//   intermediate) and folds max |lrelu(v)| into the consuming conv's amax
//   row by atomicMax on its bits (a max: the same result in any order);
//   a quantize pass (conv_operand_kernel) then writes the codes.  The
//   stage input's amax is one absmax pass (mrf_int8.cu), and its codes
//   serve every resblock's first conv.
// * Operand layout, device memory and shared memory alike: chunk-major,
//   [B][planes][L][16 bytes], e = 8 bf16, 16 int8 or 4 TF32 channels a
//   plane (tf32: a chunk of 16 channels is 4 planes of hi, then 4 of lo),
//   so a TMA box of a plane's rows lands as a no-swizzle K-major wgmma
//   operand and tap t of dilation d reads it t * d rows on (every row start
//   is 16-byte aligned).  TMA's zero fill outside [0, L) is SAME padding:
//   lrelu(0) = 0 and code 0, as the twin pads.
// * Work unit: a tile of bm output rows x bn output channels (ops/mrf.py
//   plans it through mrf_conv_plan.h).  K runs as (chunk of 128 bytes a row:
//   64 bf16, 128 int8 or 16 tf32 input channels; C's own 32 or 64 bytes for
//   int8 at C = 32 and 64; tap): the copy warpgroup streams each chunk's
//   window (bm + (k-1) * dil rows, two buffers) and each (chunk, tap)
//   weight slot ([chunk planes][bn][16 bytes], one bulk copy a plane from
//   a layout made once on the host, Bf16Conv.slots / Int8Conv.slots /
//   Tf32Conv.slots) into mbarrier rings; the two compute warpgroups each
//   take bm / 2 rows and all bn channels (m64nNk16 bf16, m64nNk32 s8,
//   m64nNk8 tf32, N = bn: 32, 64 or 128), the window read once a tile,
//   each slot released as soon as the next one's products are issued
//   (wgmma.wait_group 1).
// * Products: bf16 x bf16 -> f32; int8 x int8 -> s32, exact, dequantized
//   in mma_conv_kernel's float32 order (__fmul_rn / __fadd_rn), so each
//   int8 conv is bitwise the twin's _conv_int8 on the same codes, and the
//   codes are bitwise the ones the per-conv pipeline computes in registers;
//   tf32: a_lo * b_hi + a_hi * b_lo + a_hi * b_hi a k-step, Tf32Mma's
//   order.  bf16 and tf32 differ from the per-conv pipeline only in the
//   order of their float32 sums.
// * A persistent grid (at most one block an SM) walks (batch row, row
//   tile, channel tile); the plan picks the tile shape by waves, so B=1
//   takes narrow channel tiles.
// * Capturable in a CUDA graph: the tensor map is encoded on the host and
//   passed as a __grid_constant__ parameter; the launch allocates nothing;
//   the dynamic route's amax rows are zeroed by a memset node.
#pragma once

#include <type_traits>

#include "mrf_common.cuh"
#include "mrf_conv_plan.h"
#include "mrf_fused.cuh"

namespace viettts {

// int64 fields of a conv in a stage's launch table: x (the operand it
// reads), w (its weight slots), bias, scale (int8), act, act_next (int8
// static: this conv's and the consuming conv's calibrated amax; dynamic:
// their amax rows [B]), res, y, out, pout (the operand it writes; dynamic:
// the codes the quantize pass writes from y) as addresses (0 for none),
// then k, dil, mode (mma_conv_kernel's: 0 y = v, 1 y += v, 2 out = (y +
// v) / div).
constexpr int CONV_FIELDS = 13;

// Per route: channels of a 16-byte operand plane and the planes an element
// takes (tf32: hi and lo).
template <FRoute R>
struct ConvTraits;
template <>
struct ConvTraits<FRoute::kBf16> {
  static constexpr int E = 8, PARTS = 1, ROUTE = CONV_ROUTE_BF16;
};
template <>
struct ConvTraits<FRoute::kInt8> {
  static constexpr int E = 16, PARTS = 1, ROUTE = CONV_ROUTE_INT8;
};
template <>
struct ConvTraits<FRoute::kTf32> {
  static constexpr int E = 4, PARTS = 2, ROUTE = CONV_ROUTE_TF32;
};

// The TPU kernel's tile windows of a dynamic int8 stage (ops/mrf.py::
// dynamic_windows): row b' of a run is window b' / B of batch row b' % B,
// the rows [w * tile - halo, w * tile - halo + L) of the stage's sequence
// of seq rows, zero outside [0, seq) (SAME padding: the TPU kernel
// re-zeroes them after every conv).  A run of every window reads the stage
// input (h, a residual) at the window's rows and writes each window's
// tile, rows [halo, halo + tile), into the stage output.  n = 0: none, the
// run's rows are the batch rows.
struct TileWin {
  int n, B, tile, halo, seq;
};

// Run row bp's window: the sequence row of its row 0, and that row's index
// in a full-sequence [B, seq, *] tensor.
struct WinRow {
  int start;
  long long base;
};
__device__ __forceinline__ WinRow win_row(const TileWin& w, int bp) {
  const int start = bp / w.B * w.tile - w.halo;
  return {start, (long long)(bp % w.B) * w.seq + start};
}

// The offset of channel c of the window's row l in a full-sequence [B, seq,
// C] tensor, or -1 where the row lies outside the sequence.
__device__ __forceinline__ long long win_offset(const TileWin& w, WinRow r, int l, int C, int c) {
  return (unsigned)(r.start + l) >= (unsigned)w.seq ? -1 : (r.base + l) * C + c;
}

struct ConvWArgs {
  CUtensorMap x_map;  // the operand [B * planes][L][16 bytes], box {16, xbox, 1}
  const unsigned char* w;
  const float *bias, *scale, *act, *act_next;
  const float* res;
  float* y;
  float* fold;  // dynamic int8: the consuming conv's amax row [B], max |lrelu(v)| folded in
  void *out, *pout;
  int out_bf16, mode, dynamic, L, C, k, dil, bm, win, xbox, stages, mtiles, ntiles, n_tiles;
  float div;
  TileWin tw;           // tile windows (the kernel's WIN variant): rows outside the sequence are zero
  int res_win, out_win;  // res is the stage input / out the stage output, both full-sequence
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// --- wgmma m64nNk* with both operands K-major in shared memory -------------

// D[64 x 64] += A (smem, K-major) x B (smem, K-major), bf16 -> f32
__device__ __forceinline__ void wgmma_bf16_kn64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}
// D[64 x 64] += A (smem, K-major) x B (smem, K-major), s8 -> s32, exact
__device__ __forceinline__ void wgmma_s8_kn64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}
// D[64 x 128] += A (smem, K-major) x B (smem, K-major), bf16 -> f32
__device__ __forceinline__ void wgmma_bf16_kn128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}
// D[64 x 128] += A (smem, K-major) x B (smem, K-major), s8 -> s32, exact
__device__ __forceinline__ void wgmma_s8_kn128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}

// D[64 x 32] += A (smem, K-major) x B (smem, K-major), tf32 -> f32
__device__ __forceinline__ void wgmma_tf32_kn32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}
// D[64 x 64] += A (smem, K-major) x B (smem, K-major), tf32 -> f32
__device__ __forceinline__ void wgmma_tf32_kn64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}
// D[64 x 128] += A (smem, K-major) x B (smem, K-major), tf32 -> f32
__device__ __forceinline__ void wgmma_tf32_kn128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// One k-step of route R into the accumulators of a 64 x N block, both
// operands K-major in shared memory (s8 at N = 32: mrf_fused.cuh's).
template <FRoute R, int N, typename Acc>
__device__ __forceinline__ void wgmma_conv(Acc (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (R == FRoute::kBf16) {
    static_assert(N == 64 || N == 128, "bf16 tiles are 64 or 128 channels wide");
    if constexpr (N == 64) wgmma_bf16_kn64(d, da, db);
    else wgmma_bf16_kn128(d, da, db);
  } else if constexpr (R == FRoute::kTf32) {
    if constexpr (N == 32) wgmma_tf32_kn32(d, da, db);
    else if constexpr (N == 64) wgmma_tf32_kn64(d, da, db);
    else wgmma_tf32_kn128(d, da, db);
  } else {
    if constexpr (N == 32) wgmma_s8_n32(d, da, db);
    else if constexpr (N == 64) wgmma_s8_kn64(d, da, db);
    else wgmma_s8_kn128(d, da, db);
  }
}

// What a lane needs for its 8 output channels c0 .. c0 + 7 of every row:
// the biases and (int8) the dequant multipliers scale[c] * dq, and the
// scale of the operand it writes.
struct EpilogueLane {
  float bias[8], mult[8], inv_next;
};

// The loads of one row l of a lane's 8 channels at o = (b * L + l) * C +
// c0: its residual r and (modes 1, 2) the resblocks' sum y.  WIN (tile
// windows, row b's window wr): a residual that is the stage input
// (res_win) is read at the window's row of it, 0 outside the sequence.
template <bool WIN>
__device__ __forceinline__ void conv_epilogue_loads(const ConvWArgs& a, size_t o, WinRow wr, int l, int c0,
                                                    float (&r)[8], float (&y)[8]) {
  if (a.res) {
    long long ro = (long long)o;
    bool outside = false;
    if constexpr (WIN) {
      if (a.res_win) ro = win_offset(a.tw, wr, l, a.C, c0), outside = ro < 0;
    }
    if (outside) {
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = 0.f;
    } else {
      *reinterpret_cast<float4*>(r) = *reinterpret_cast<const float4*>(a.res + ro);
      *reinterpret_cast<float4*>(r + 4) = *reinterpret_cast<const float4*>(a.res + ro + 4);
    }
  }
  if (a.mode != 0 && a.y) {
    *reinterpret_cast<float4*>(y) = *reinterpret_cast<const float4*>(a.y + o);
    *reinterpret_cast<float4*>(y + 4) = *reinterpret_cast<const float4*>(a.y + o + 4);
  }
}

// One row l of a lane's 8 channels, its loads done: v = acc (dequantized,
// in mma_conv_kernel's float32 order) + bias (+ r), then by mode: 0 y[l]
// = v and the next conv's operand op(lrelu(v)) (dynamic int8: max
// |lrelu(v)| folded into m instead); 1 y[l] += v; 2 out[l] = (y[l] + v) /
// div (v / div without y).  `src` holds the 8 staged sums.  WIN (tile
// windows, row b's window wr): v = 0 outside the sequence, and with
// out_win mode 2 writes only the window's tile, at its rows of out.
template <FRoute R, int BN, bool WIN>
__device__ __forceinline__ void conv_epilogue_row(const ConvWArgs& a, const void* src, int b, int l, int c0,
                                                  WinRow wr, const EpilogueLane& e, const float (&r)[8],
                                                  float (&y)[8], float& m) {
  const size_t o = ((size_t)b * a.L + l) * a.C + c0;
  float v[8];
  if constexpr (R == FRoute::kInt8) {
    int x[8];
    *reinterpret_cast<int4*>(x) = *reinterpret_cast<const int4*>(src);
    *reinterpret_cast<int4*>(x + 4) = *reinterpret_cast<const int4*>(static_cast<const int*>(src) + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(__fmul_rn(__int2float_rn(x[i]), e.mult[i]), e.bias[i]);
  } else {
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(src);
    *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(static_cast<const float*>(src) + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], e.bias[i]);
  }
  if (a.res) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], r[i]);
  }
  if constexpr (WIN) {
    if ((unsigned)(wr.start + l) >= (unsigned)a.tw.seq) {  // outside the sequence: 0
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
  }
  if (a.mode == 0) {
    if (a.y) {
      *reinterpret_cast<float4*>(a.y + o) = *reinterpret_cast<const float4*>(v);
      *reinterpret_cast<float4*>(a.y + o + 4) = *reinterpret_cast<const float4*>(v + 4);
    }
    if constexpr (R == FRoute::kInt8) {
      if (a.fold) {
#pragma unroll
        for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(lrelu(v[i], 0.1f)));
      }
    }
    if (a.pout) {  // chunk-major [B][planes][L][16 bytes]
      constexpr int E = ConvTraits<R>::E;
      if constexpr (R == FRoute::kTf32) {
        // channels c0 .. c0 + 7: planes c0 % 16 / 4 and the next of chunk c0 / 16,
        // hi, and 4 planes on, lo
        const size_t ps = (size_t)a.L * 16;  // bytes from a plane to the next
        unsigned char* row = static_cast<unsigned char*>(a.pout) +
                             (((size_t)b * (a.C / 2) + c0 / 16 * 8 + c0 % 16 / E) * a.L + l) * 16;
        float hi[8], lo[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float u = lrelu(v[i], 0.1f);
          hi[i] = __uint_as_float(tf32_rna(u));
          lo[i] = __uint_as_float(tf32_rna(__fsub_rn(u, hi[i])));
        }
        *reinterpret_cast<float4*>(row) = *reinterpret_cast<const float4*>(hi);
        *reinterpret_cast<float4*>(row + ps) = *reinterpret_cast<const float4*>(hi + 4);
        *reinterpret_cast<float4*>(row + 4 * ps) = *reinterpret_cast<const float4*>(lo);
        *reinterpret_cast<float4*>(row + 5 * ps) = *reinterpret_cast<const float4*>(lo + 4);
      } else if constexpr (R == FRoute::kBf16) {
        unsigned char* row = static_cast<unsigned char*>(a.pout) + (((size_t)b * (a.C / E) + c0 / E) * a.L + l) * 16;
        uint4 w;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(lrelu(v[2 * i], 0.1f), lrelu(v[2 * i + 1], 0.1f));
        *reinterpret_cast<uint4*>(row) = w;
      } else {
        unsigned char* row = static_cast<unsigned char*>(a.pout) + (((size_t)b * (a.C / E) + c0 / E) * a.L + l) * 16;
        uint2 w;
        unsigned* p = reinterpret_cast<unsigned*>(&w);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          unsigned word = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) word |= (unsigned)(fused_code(v[4 * i + k], e.inv_next) & 0xff) << (8 * k);
          p[i] = word;
        }
        *reinterpret_cast<uint2*>(row + c0 % E) = w;
      }
    }
  } else if (a.mode == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = __fadd_rn(y[i], v[i]);
    *reinterpret_cast<float4*>(a.y + o) = *reinterpret_cast<const float4*>(y);
    *reinterpret_cast<float4*>(a.y + o + 4) = *reinterpret_cast<const float4*>(y + 4);
  } else {
    size_t oo = o;
    if constexpr (WIN) {  // out_win: the window's tile only, at its rows of the sequence
      if (a.out_win) {
        if (l < a.tw.halo || l >= a.tw.halo + a.tw.tile) return;
        oo = (size_t)(wr.base + l) * a.C + c0;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fdiv_rn(a.y ? __fadd_rn(y[i], v[i]) : v[i], a.div);
    if (a.out_bf16) {
      uint4 w;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) + oo) = w;
    } else {
      float* out = static_cast<float*>(a.out) + oo;
      *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(v);
      *reinterpret_cast<float4*>(out + 4) = *reinterpret_cast<const float4*>(v + 4);
    }
  }
}

// One MRF conv of a stage: every (batch row, row tile, channel tile) of the
// persistent grid.  Warpgroups 0 and 1 compute, rows [wg * bm / 2, (wg + 1)
// * bm / 2) of the tile in MB blocks of 64 and all BN channels; in
// warpgroup 2, which hands its registers to them (setmaxnreg, as in
// mrf_fused_kernel), lane 0 of its first warp streams the weight slots and
// lane 0 of its second warp the window chunks, PLANES 16-byte planes each.
// WIN: the run's rows are tile windows (ConvWArgs::tw; int8 only).
template <FRoute R, int BN, int MB, int PLANES, bool WIN = false>
__global__ void __launch_bounds__(CONV_THREADS, 1) mrf_conv_wgmma_kernel(const __grid_constant__ ConvWArgs a) {
  using T = ConvTraits<R>;
  using Acc = std::conditional_t<R == FRoute::kInt8, int, float>;
  constexpr int PP = PLANES / T::PARTS;      // planes of a part (tf32: hi, lo)
  constexpr int KSTEPS = PP / 2;             // a k-step (k16 bf16, k32 int8, k8 tf32) is 32 bytes
  constexpr int SLOT = PLANES * BN * 16;     // bytes of a weight slot
  constexpr int NA = BN / 2;                 // accumulators a thread holds for a 64-row block
  constexpr int KC = PP * T::E;              // input channels of a chunk
  constexpr int PL = BN / 8;                 // epilogue: lanes a row (8 channels each)
  constexpr int RPI = 32 / PL;               // epilogue: rows a warp step
  constexpr int EG = 4 / MB;                 // epilogue: rows a lane loads before it stores (no spills)
  static_assert(MB * BN <= 256 && (BN == 32 || BN == 64 || BN == 128) && FUSED_WARPS == CONV_WARPS,
                "at most 128 accumulators a thread; the strips are the compute warps'");
  static_assert(PLANES * 16 <= CONV_CHUNK_BYTES && KSTEPS >= 1, "a chunk holds whole k-steps");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) &
                                                         ~static_cast<uintptr_t>(127));
  const int W = a.win, S = a.stages, k = a.k;
  const int XCHUNK = PLANES * W * 16;                     // bytes of a window chunk
  unsigned char* xwin = ring + (size_t)S * SLOT;          // two window chunks
  constexpr int STRIP = CONV_STRIP_ROWS * (BN + CONV_STRIP_PAD) * 4;  // bytes of a warp's epilogue strip
  unsigned char* stage_base = xwin + 2 * (size_t)XCHUNK;  // the compute warps' strips
  uint64_t* bars = reinterpret_cast<uint64_t*>(stage_base + (size_t)CONV_WARPS * STRIP);
  uint64_t* full = bars;                                  // weight slot s loaded
  uint64_t* empty = bars + CONV_MAX_STAGES;               // weight slot s consumed by every compute warp
  uint64_t* xfull = bars + 2 * CONV_MAX_STAGES;           // window chunk buffer i loaded
  uint64_t* xempty = xfull + 2;                           // window chunk buffer i consumed
  const int nchunks = a.C / KC;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, FUSED_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(xfull + i, 1);
      mbar_init(xempty + i, FUSED_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FUSED_COPY_REGS));
    if (warp == 8 && lane == 0) {  // weights: slot (chunk, tap) = [PLANES][BN][16] of [C/KC][k][PLANES][C][16]
      int slot = 0, phase = 0;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const int n0 = (tile % a.ntiles) * BN;
        for (int kc = 0; kc < nchunks; ++kc)
          for (int t = 0; t < k; ++t) {
            mbar_wait(empty + slot, phase ^ 1);
            mbar_expect_tx(full + slot, (unsigned)SLOT);
            const unsigned char* src = a.w + ((size_t)(kc * k + t) * PLANES * a.C + n0) * 16;
            for (int p = 0; p < PLANES; ++p)
              bulk_load(ring + (size_t)slot * SLOT + p * BN * 16, src + (size_t)p * a.C * 16, BN * 16, full + slot);
            if (++slot == S) slot = 0, phase ^= 1;
          }
      }
    } else if (warp == 9 && lane == 0) {  // window chunks: [PLANES][W][16] from row tile * bm - reach / 2
      int xb = 0, xphase = 0;
      const int planes_per_row = a.C / T::E * T::PARTS;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const int rest = tile / a.ntiles, b = rest / a.mtiles;
        const int row0 = (rest % a.mtiles) * a.bm - (k - 1) / 2 * a.dil;
        for (int kc = 0; kc < nchunks; ++kc) {
          mbar_wait(xempty + xb, xphase ^ 1);
          mbar_expect_tx(xfull + xb, (unsigned)XCHUNK);
          unsigned char* dst = xwin + (size_t)xb * XCHUNK;
          for (int p = 0; p < PLANES; ++p)
            for (int r = 0; r < W; r += a.xbox)
              tma_load_3d(dst + ((size_t)p * W + r) * 16, &a.x_map, 0, row0 + r, b * planes_per_row + kc * PLANES + p,
                          xfull + xb);
          if (++xb == 2) xb = 0, xphase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FUSED_COMPUTE_REGS));
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // fragments: warp wq of warpgroup wg holds rows 16 wq + g (+ 8) of each
    // 64-row block, and the accumulator pair 4q + 2h (+ 1) is row + 8h,
    // channels 8q + 2tq (+ 1) of the tile
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, tq = lane % 4;
    const int half = a.bm / 2;
    int slot = 0, phase = 0, xb = 0, xphase = 0;
    float dq = 0.f, inv_next = 0.f;
    if constexpr (R == FRoute::kInt8) {
      if (!a.dynamic) dq = __fdiv_rn(fmaxf(a.act[0], 1e-12f), 127.f);
      if (a.pout) inv_next = fused_inv(a.act_next, 0);
    }
    Acc acc[MB][NA];

    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      const int nt = tile % a.ntiles, rest = tile / a.ntiles;
      const int b = rest / a.mtiles, l0 = (rest % a.mtiles) * a.bm;
#pragma unroll
      for (int j = 0; j < MB; ++j)
#pragma unroll
        for (int e = 0; e < NA; ++e) {
          acc[j][e] = Acc(0);
          pin(acc[j][e]);
        }
      int pend_slot = -1, pend_x = -1;  // released once the next group's products are issued
      for (int kc = 0; kc < nchunks; ++kc) {
        mbar_wait(xfull + xb, xphase);
        const unsigned char* xw = xwin + (size_t)xb * XCHUNK;
        for (int t = 0; t < k; ++t) {
          mbar_wait(full + slot, phase);
          const unsigned char* ws = ring + (size_t)slot * SLOT;
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < MB; ++j) {
            const int row = wg * half + j * 64 + t * a.dil;
            // A: planes p.. of the window from this block's row; B: planes p.. of the slot
            auto da = [&](int p) { return smem_desc(xw + ((size_t)p * W + row) * 16, W * 16, 128); };
            auto db = [&](int p) { return smem_desc(ws + (size_t)p * BN * 16, BN * 16, 128); };
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) {
              if constexpr (R == FRoute::kTf32) {  // lo * hi + hi * lo + hi * hi, Tf32Mma's order
                wgmma_conv<R, BN>(acc[j], da(PP + 2 * ks), db(2 * ks));
                wgmma_conv<R, BN>(acc[j], da(2 * ks), db(PP + 2 * ks));
                wgmma_conv<R, BN>(acc[j], da(2 * ks), db(2 * ks));
              } else {
                wgmma_conv<R, BN>(acc[j], da(2 * ks), db(2 * ks));
              }
            }
          }
          wgmma_commit();
          wgmma_wait1();
          if (pend_slot >= 0) release(empty + pend_slot);
          if (pend_x >= 0) release(xempty + pend_x);
          pend_slot = slot;
          pend_x = t == k - 1 ? xb : -1;
          if (++slot == S) slot = 0, phase ^= 1;
        }
        if (++xb == 2) xb = 0, xphase ^= 1;
      }
      wgmma_wait0();
      release(empty + pend_slot);
      release(xempty + pend_x);
#pragma unroll
      for (int j = 0; j < MB; ++j)
#pragma unroll
        for (int e = 0; e < NA; ++e) pin(acc[j][e]);

      // epilogue, one 64-row block at a time: each warp stages its 16 rows
      // of the block's accumulators in its own shared-memory strip, then
      // walks them in a compact loop, RPI rows a step, each lane 8
      // channels (16-byte accesses; a row's residual, its sum and its
      // operand planes coalesced), EG steps' loads in flight together.
      // (Unrolled over every accumulator, the epilogue of a 256 x 128 tile
      // cost ~20 us a tile on an H100, 4x its mainloop: straight-line code
      // that runs once a tile.)
      Acc* strip = reinterpret_cast<Acc*>(stage_base + (size_t)warp * STRIP);
      const int pc = lane % PL, c0 = nt * BN + 8 * pc;  // the lane's channels
      WinRow wr{0, 0};
      if constexpr (WIN) wr = win_row(a.tw, b);
      if constexpr (R == FRoute::kInt8) {
        if (a.dynamic) dq = __fmul_rn(a.act[b], INV127);  // this batch row's amax, as mma_conv_kernel
      }
      EpilogueLane ep;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ep.bias[i] = __ldg(a.bias + c0 + i);
        ep.mult[i] = R == FRoute::kInt8 ? __fmul_rn(__ldg(a.scale + c0 + i), dq) : 0.f;
      }
      ep.inv_next = inv_next;
      float m = 0.f;  // dynamic int8: this lane's max |lrelu(v)| over the tile
#pragma unroll
      for (int j = 0; j < MB; ++j) {
#pragma unroll
        for (int q = 0; q < BN / 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            Acc* dst = strip + (g + 8 * h) * (BN + CONV_STRIP_PAD) + 8 * q + 2 * tq;
            dst[0] = acc[j][4 * q + 2 * h];
            dst[1] = acc[j][4 * q + 2 * h + 1];
          }
        __syncwarp();
        const int row0 = l0 + wg * half + j * 64 + 16 * wq;  // sequence row of strip row 0
        // EG rows a lane at a time, every load of the group issued first:
        // res may alias y, so no load moves above an earlier store
#pragma unroll 1
        for (int r0 = lane / PL; r0 < CONV_STRIP_ROWS; r0 += EG * RPI) {
          float rr[EG][8], yy[EG][8];
#pragma unroll
          for (int i = 0; i < EG; ++i) {
            const int l = row0 + r0 + i * RPI;
            if (r0 + i * RPI < CONV_STRIP_ROWS && l < a.L)
              conv_epilogue_loads<WIN>(a, ((size_t)b * a.L + l) * a.C + c0, wr, l, c0, rr[i], yy[i]);
          }
#pragma unroll
          for (int i = 0; i < EG; ++i) {
            const int r = r0 + i * RPI, l = row0 + r;
            if (r < CONV_STRIP_ROWS && l < a.L)
              conv_epilogue_row<R, BN, WIN>(a, strip + r * (BN + CONV_STRIP_PAD) + 8 * pc, b, l, c0, wr, ep, rr[i],
                                            yy[i], m);
          }
        }
        __syncwarp();
      }
      if constexpr (R == FRoute::kInt8) {
        if (a.fold) {  // the warp's max into the consuming conv's amax of row b (non-negative: bits order)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          if (lane == 0) atomicMax(reinterpret_cast<int*>(a.fold + b), __float_as_int(m));
        }
      }
    }
  }
}

// The stage input's operands: out[i] = op(lrelu(h)) chunk-major, the int8
// codes at act[i] (static: each resblock's first conv's calibrated amax;
// dynamic: the amax row [B], no clip), the TF32 parts hi, lo; bf16
// ignores act.  Also the dynamic route's quantize pass of a conv's float32
// output.  h float32 [B, L, C]; one thread an E-channel group of a row.
struct OperandArgs {
  void* out[FUSED_MAX_RES];
  const float* act[FUSED_MAX_RES];
  int n, dynamic;
  TileWin tw;  // tw.n > 0: h is the full sequence [tw.B, tw.seq, C], read at each window's rows
};

template <FRoute R, bool WIN = false>
__global__ void __launch_bounds__(256) conv_operand_kernel(const float* __restrict__ h, const OperandArgs a, int B,
                                                           int L, int C) {
  constexpr int E = ConvTraits<R>::E;
  const int groups = C / E;
  const long long total = (long long)B * groups * L;
  float inv[FUSED_MAX_RES];
#pragma unroll
  for (int i = 0; i < FUSED_MAX_RES; ++i)
    inv[i] = (R == FRoute::kInt8 && !a.dynamic && i < a.n) ? fused_inv(a.act[i], 0) : 0.f;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int l = (int)(e % L);
    const long long rest = e / L;
    const int p = (int)(rest % groups), b = (int)(rest / groups);
    long long so = ((long long)b * L + l) * C + p * E;
    if constexpr (WIN) so = win_offset(a.tw, win_row(a.tw, b), l, C, p * E);
    const float4* src = reinterpret_cast<const float4*>(h + so);
    float v[E];
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 f = WIN && so < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : src[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
#pragma unroll
    for (int i = 0; i < FUSED_MAX_RES; ++i) {
      if (i >= a.n) break;
      if constexpr (R == FRoute::kTf32) {  // hi to plane p % 4 of chunk p / 4, lo 4 planes on
        float hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float u = lrelu(v[q], 0.1f);
          hi[q] = __uint_as_float(tf32_rna(u));
          lo[q] = __uint_as_float(tf32_rna(__fsub_rn(u, hi[q])));
        }
        float4* out = reinterpret_cast<float4*>(a.out[i]) + ((size_t)b * (C / 2) + p / 4 * 8 + p % 4) * L + l;
        out[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
        out[(size_t)4 * L] = make_float4(lo[0], lo[1], lo[2], lo[3]);
        continue;
      }
      uint4 word;
      unsigned* w32 = reinterpret_cast<unsigned*>(&word);
      if constexpr (R == FRoute::kBf16) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 pr = __floats2bfloat162_rn(lrelu(v[2 * q], 0.1f), lrelu(v[2 * q + 1], 0.1f));
          w32[q] = *reinterpret_cast<const unsigned*>(&pr);
        }
      } else if (a.dynamic) {  // mma_conv_kernel's dynamic codes: inv = 127 / max(amax, 1e-30), no clip
        const float iv = __fdiv_rn(127.f, fmaxf(a.act[i][b], 1e-30f));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          unsigned word4 = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            word4 |= (unsigned)(__float2int_rn(__fmul_rn(lrelu(v[4 * q + j], 0.1f), iv)) & 0xff) << (8 * j);
          w32[q] = word4;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          unsigned word4 = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) word4 |= (unsigned)(fused_code(v[4 * q + j], inv[i]) & 0xff) << (8 * j);
          w32[q] = word4;
        }
      }
      reinterpret_cast<uint4*>(a.out[i])[e] = word;
    }
  }
}

// --- host side -----------------------------------------------------------------

template <FRoute R, int BN, int MB, int PLANES, bool WIN = false>
int run_conv_wgmma(const ConvWArgs& args, const ConvPlan& p, cudaStream_t s) {
  auto kernel = mrf_conv_wgmma_kernel<R, BN, MB, PLANES, WIN>;
  static std::atomic<int> opted_on[MAX_DEVICES];
  const cudaError_t opted = opt_in_smem_once(kernel, opted_on);
  if (opted != cudaSuccess) return (int)opted;
  kernel<<<p.ctas, CONV_THREADS, p.smem, s>>>(args);
  return (int)cudaGetLastError();
}

// The kernel of a plan's tile and chunk, among those route R instantiates:
// every route the three full-chunk tiles of C >= 128; tf32 also the narrow
// tiles (16-channel chunks divide C = 64 and 32); int8 those with chunks
// of C's own 64 or 32 bytes, each also as its tile-window variant (WIN).
template <FRoute R, bool WIN = false>
int run_planned(const ConvWArgs& a, const ConvPlan& p, cudaStream_t s) {
  if constexpr (R == FRoute::kInt8 && !WIN) {
    if (a.tw.n) return run_planned<R, true>(a, p, s);
  }
  if (p.planes == 8) {
    if (p.bm == 256 && p.bn == 128) return run_conv_wgmma<R, 128, 2, 8, WIN>(a, p, s);
    if (p.bm == 128 && p.bn == 128) return run_conv_wgmma<R, 128, 1, 8, WIN>(a, p, s);
    if (p.bm == 128 && p.bn == 64) return run_conv_wgmma<R, 64, 1, 8, WIN>(a, p, s);
    if constexpr (R == FRoute::kTf32) {
      if (p.bm == 256 && p.bn == 64) return run_conv_wgmma<R, 64, 2, 8>(a, p, s);
      if (p.bm == 256 && p.bn == 32) return run_conv_wgmma<R, 32, 2, 8>(a, p, s);
      if (p.bm == 128 && p.bn == 32) return run_conv_wgmma<R, 32, 1, 8>(a, p, s);
    }
  }
  if constexpr (R == FRoute::kInt8) {
    if (p.planes == 4 && p.bn == 64)
      return p.bm == 256 ? run_conv_wgmma<R, 64, 2, 4, WIN>(a, p, s) : run_conv_wgmma<R, 64, 1, 4, WIN>(a, p, s);
    if (p.planes == 2 && p.bn == 32)
      return p.bm == 256 ? run_conv_wgmma<R, 32, 2, 2, WIN>(a, p, s) : run_conv_wgmma<R, 32, 1, 2, WIN>(a, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The stage operand pass: n (out, act) rows of int64 addresses over h (tw:
// its tile windows, B and L the run's).
template <FRoute R>
int conv_operands(int B, int L, int C, const void* h, int n, const void* table, int dynamic, cudaStream_t s,
                  TileWin tw = {}) {
  constexpr int E = ConvTraits<R>::E;
  if (n < 1 || n > FUSED_MAX_RES || C % E != 0 || (R == FRoute::kTf32 && C % 16 != 0) || B < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const long long* rows = static_cast<const long long*>(table);
  OperandArgs a{};
  a.n = n;
  a.dynamic = R == FRoute::kInt8 && dynamic;
  a.tw = tw;
  for (int i = 0; i < n; ++i) {
    a.out[i] = reinterpret_cast<void*>(static_cast<uintptr_t>(rows[2 * i]));
    a.act[i] = reinterpret_cast<const float*>(static_cast<uintptr_t>(rows[2 * i + 1]));
    if (!a.out[i] || (R == FRoute::kInt8 && !a.act[i])) return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)B * (C / E) * L;
  long long blocks = (total + 255) / 256;
  if (blocks > 8 * sm_count()) blocks = 8 * sm_count();
  if constexpr (R == FRoute::kInt8) {
    if (tw.n) {
      conv_operand_kernel<R, true><<<(unsigned)blocks, 256, 0, s>>>(static_cast<const float*>(h), a, B, L, C);
      return (int)cudaGetLastError();
    }
  }
  if (tw.n) return (int)cudaErrorInvalidValue;
  conv_operand_kernel<R><<<(unsigned)blocks, 256, 0, s>>>(static_cast<const float*>(h), a, B, L, C);
  return (int)cudaGetLastError();
}

// A stage's MRF convs on this pipeline: n rows of CONV_FIELDS int64 (see
// there), each launched with its plan (mrf_conv_plan.h); stops at the
// first error.  Which stages take this pipeline is the caller's choice
// (conv_takes_stage, through ops/mrf.py::conv_takes); any C the plan
// tiles runs.  The weight slots of a conv are [C / KC][k][planes][C][16
// bytes] (Bf16Conv.slots, Int8Conv.slots, Tf32Conv.slots in ops/mrf.py).
// dynamic (int8): each conv dequantizes with its amax row act[b]; a conv
// with pout writes float32 y, folds max |lrelu(y)| into act_next (zeroed by
// the caller) and is followed by the quantize pass y -> pout at act_next.
// tw (tile windows, B and L the run's): a conv whose res is h reads the
// stage input at the windows' rows, and with out_win the mode-2 conv
// writes each window's tile into the full-sequence out.
template <FRoute R>
int conv_wgmma_stage(int out_bf16, int B, int L, int C, float div, int n, const void* table, int dynamic,
                     cudaStream_t s, const void* h = nullptr, TileWin tw = {}, int out_win = 0) {
  constexpr int E = ConvTraits<R>::E;
  const auto bad = (int)cudaErrorInvalidValue;
  if (n < 1 || (dynamic && R != FRoute::kInt8)) return bad;  // each conv's plan checks the shape
  const int route = R == FRoute::kInt8 && dynamic ? CONV_ROUTE_INT8_DYNAMIC : ConvTraits<R>::ROUTE;
  const long long* rows = static_cast<const long long*>(table);
  auto ptr = [](long long v) { return reinterpret_cast<void*>(static_cast<uintptr_t>(v)); };
  for (int i = 0; i < n; ++i) {
    const long long* r = rows + (size_t)i * CONV_FIELDS;
    ConvWArgs a{};
    a.w = static_cast<const unsigned char*>(ptr(r[1]));
    a.bias = static_cast<const float*>(ptr(r[2]));
    a.scale = static_cast<const float*>(ptr(r[3]));
    a.act = static_cast<const float*>(ptr(r[4]));
    a.act_next = static_cast<const float*>(ptr(r[5]));
    a.res = static_cast<const float*>(ptr(r[6]));
    a.y = static_cast<float*>(ptr(r[7]));
    a.out = ptr(r[8]);
    a.pout = ptr(r[9]);
    a.k = (int)r[10];
    a.dil = (int)r[11];
    a.mode = (int)r[12];
    a.out_bf16 = out_bf16;
    a.dynamic = dynamic;
    a.L = L;
    a.C = C;
    a.div = div;
    a.tw = tw;
    a.res_win = tw.n && h && a.res == h;
    a.out_win = tw.n && out_win && a.mode == 2;
    ConvPlan p{};
    if (!r[0] || !a.w || !a.bias || !conv_plan(route, B, L, C, a.k, a.dil, sm_count(), &p)) return bad;
    if (a.mode < 0 || a.mode > 2 || (a.mode == 1 && !a.y) || (a.mode == 2 && !a.out) || (a.mode != 0 && a.pout))
      return bad;
    if (R == FRoute::kInt8 && (!a.scale || !a.act || (a.pout && !a.act_next))) return bad;
    void* codes = a.pout;
    if (dynamic && codes) {  // the epilogue folds; the quantize pass below writes the codes
      if (!a.y) return bad;
      a.fold = const_cast<float*>(a.act_next);
      a.pout = nullptr;
    }
    a.bm = p.bm;
    a.win = p.win;
    a.xbox = p.xbox;
    a.stages = p.stages;
    a.mtiles = (L + p.bm - 1) / p.bm;
    a.ntiles = C / p.bn;
    a.n_tiles = p.tiles;
    // the operand [B * planes][L][16 bytes] as bytes; rows outside [0, L) read 0
    const cuuint64_t dims[3] = {16, (cuuint64_t)L, (cuuint64_t)B * (C / E * ConvTraits<R>::PARTS)};
    const cuuint64_t strides[2] = {16, (cuuint64_t)L * 16};
    const cuuint32_t box[3] = {16, (cuuint32_t)p.xbox, 1};
    if (!encode_map(&a.x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, ptr(r[0]), dims, strides, box)) return bad;
    int err = run_planned<R>(a, p, s);
    if (err == 0 && dynamic && codes) {
      const long long q[2] = {r[9], r[5]};
      err = conv_operands<R>(B, L, C, a.y, 1, q, 1, s);
    }
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace viettts
