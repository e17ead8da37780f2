// The fused MRF pipeline shared by K2 (bf16 route, mrf.cu) and K3
// (static-scale int8, mrf_int8.cu): one launch runs whole HiFi-GAN
// resblocks for time tiles, each tile on chip from its window's load to
// its contribution to the stage output.
//
// Replaces the TPU kernel viettts_tpu/ops/mrf.py:181 (_mrf_kernel) for
// the stages of width C = 32 and 64, where it beat the per-conv pipeline
// on the H100 (PERF.md §6; at C = 128 it did not, and C = 256 leaves no
// room for a tile beside its halo).  Its design point was VMEM
// residency: a time tile is DMA'd in once with a halo, flows through every
// conv in VMEM, and only the resblock average is written.
// The per-conv pipeline (mma_conv_kernel, mrf_common.cuh) had dropped
// that: each conv reads a float32 window and a float32 residual from
// device memory and writes float32 back, about 50 passes over a
// stage-sized tensor per ResBlock1 stage.  Here each resblock reads its
// stage input once and writes its contribution once; the stage's convs (2
// * B * L * C^2 * taps) bound it, at the bf16 or int8 tensor rate.
//
// What the design does about that bound:
//
// * Work unit: a tile of bm output rows.  Its window (bm + 2 * halo rows,
//   halo = (k-1)/2 * sum(d + 1) over a ResBlock1's units, (k-1)/2 * sum(d)
//   for ResBlock2) comes in by TMA, zero-filled outside [0, L), once for
//   each resblock.  Each conv computes the rows its successors need,
//   shrinking by its reach on both sides, until the last one leaves the bm
//   centre rows.  The halo is recomputed by every tile, so windows run up
//   to 512 rows (1.2-1.3x the MACs of a stage at B=64), narrower where a
//   wider one would leave the persistent grid's last wave short
//   (ops/mrf.py::plan_fused).
// * On chip per tile: the float32 trunk r (the resblock's running sum, the
//   residual) and one row buffer, the bf16 or int8 operand of the next
//   conv (A of wgmma, from shared memory).  Rows are chunk-major,
//   [C/e][W][16 bytes], so a shifted window (tap t of dilation d starts t *
//   d rows on) is a no-swizzle K-major operand at any row: every row start
//   is 16-byte aligned.
// * SAME padding: after every conv, rows outside [0, L) are set to 0, so
//   the next conv's lrelu input there is 0 as in the twin, whose convs pad
//   each input with zeros (the Pallas kernel's `valid` mask, mrf.py:234).
// * Products on wgmma m64nNk*: bf16 x bf16 -> f32; int8 x int8 -> s32,
//   exact, dequantized in mma_conv_kernel's float32 order, so each int8
//   conv is bitwise the twin's _conv_int8 on the same input.  The two
//   compute warpgroups split each conv's output channels (N = C/2 each)
//   and both run every 64-row block of its range: the same instructions
//   in both, so no wgmma sits in a path that ptxas cannot prove uniform
//   (it serializes those), and a range of 3 blocks costs 3, not 4.
// * Copies by TMA: in a third warpgroup (its registers handed to the
//   others by setmaxnreg) one lane streams each conv's weight taps, in
//   slots of up to 16 KB (several taps where C is small), into a ring of
//   2-4 slots (a stage's weights sit in L2), another lane each resblock's
//   window into the trunk once the previous resblock is done with it;
//   mbarriers pace them.
// * A persistent grid (at most one block per SM, from the SM count) walks
//   (batch row, tile).  One launch runs the whole stage, the resblock sum
//   kept in shared memory over the tile's centre rows.
// * Capturable in a CUDA graph: the tensor maps are encoded on the host
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no libcuda
//   link) and passed as a __grid_constant__ parameter; the launch
//   allocates nothing and synchronises nothing.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "mrf_common.cuh"

namespace viettts {

// The wgmma routes: bf16, int8 and (the per-conv pipeline only,
// mrf_conv_wgmma.cuh) tf32, the float32 route's 3xTF32.
enum class FRoute { kBf16, kInt8, kTf32 };

// Launch constants (ops/mrf.py mirrors them as FUSED_*).
constexpr int FUSED_WARPS = 8;                         // compute: two warpgroups
constexpr int FUSED_THREADS = FUSED_WARPS * 32 + 128;  // and a copy warpgroup
// Registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65,536.
constexpr int FUSED_COMPUTE_REGS = 232, FUSED_COPY_REGS = 40;
constexpr int FUSED_SLOT_BYTES = 16384;  // a ring slot holds up to this many weight bytes
constexpr int FUSED_BOX = 256;           // rows of a TMA box: a wider window takes two
constexpr int FUSED_BLOCK = 64;          // rows of a wgmma block
// 64-row blocks a conv's range may span (their accumulators fill the
// registers at C = 64), so window rows: FUSED_BLOCK * FUSED_MAX_BLOCKS.
constexpr int FUSED_MAX_BLOCKS = 8;
constexpr int FUSED_MAX_RES = 4;         // resblocks a launch
constexpr int FUSED_MAX_UNITS = 4;       // dilation units a resblock
constexpr int FUSED_MIN_STAGES = 2, FUSED_MAX_STAGES = 4;  // ring slots
// int64 fields of a resblock in the launch's table: w1, w2, b1, b2, s1, s2
// (addresses, 0 for none), k, units, act0, dil[FUSED_MAX_UNITS]
constexpr int FUSED_RES_FIELDS = 13;

// Per route: bytes of a row-buffer element (the next conv's bf16 operand,
// the int8 codes), of a weight element, and the wgmma k-step.
template <FRoute R>
struct FusedTraits;
template <>
struct FusedTraits<FRoute::kBf16> {
  static constexpr int OP = 2, WE = 2, KSTEP = 16;
};
template <>
struct FusedTraits<FRoute::kInt8> {
  static constexpr int OP = 1, WE = 1, KSTEP = 32;
};

// Bytes of a ring slot: as many weight taps (C x C elements of `we`
// bytes) as fit FUSED_SLOT_BYTES.
__host__ __device__ constexpr int fused_slot_bytes(int we, int C) {
  return FUSED_SLOT_BYTES / (C * C * we) * (C * C * we);
}

// Dynamic shared memory of a launch: 128 bytes of alignment slack and 128
// of mbarriers, the ring, the trunk (float32) and the row buffer of `win`
// rows, and the resblocks' sum over the `bm` centre rows (float32).
inline size_t fused_smem_bytes(int op, int slot, int C, int win, int bm, int stages) {
  return 256 + (size_t)stages * slot + (size_t)win * C * (4 + op) + (size_t)bm * C * 4;
}

struct FusedRes {
  const float *b1, *b2;  // biases [units, C] (b2 null: ResBlock2)
  const float *s1, *s2;  // int8: per-output-channel weight scales [units, C]
  int k, units, halo, act0;  // act0: flat index of its first conv (act_scales)
  int dil[FUSED_MAX_UNITS];
};

struct FusedArgs {
  CUtensorMap x_map;                    // stage input float32 [B, L, C], box {4, xbox, 1}
  CUtensorMap w_map[FUSED_MAX_RES][2];  // each resblock's stacked W1, W2
  FusedRes res[FUSED_MAX_RES];
  const float* act;  // int8: calibrated amaxes, flat conv order
  void* out;         // stage output [B, L, C], bf16 if out_bf16 else float32
  int out_bf16, L, n_res, win, xbox, bm, halo, stages, tiles_per_row, n_tiles;
};

// --- Hopper building blocks: mbarriers, TMA, wgmma -------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of parity `parity` to complete.  A wait of seconds
// is a lost arrival, not a slow copy: trap, so that the launch fails
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 4000000000ull) __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Generic-proxy shared-memory writes of this thread become visible to the
// async proxy (wgmma operands, a later TMA overwrite).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The consumer warpgroups' barrier (named barrier 1: the producer warp
// never takes part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FUSED_WARPS * 32) : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Keep a register's value in place across the asynchronous wgmma.
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void pin(int& v) { asm volatile("" : "+r"(v)::"memory"); }

// A shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x
// 16 bytes, `lbo` bytes apart along K and `sbo` bytes apart along M or N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// --- wgmma m64nNk* wrappers, one per route and width -----------------------

// D[64 x 16] += A (smem, K-major) x B (smem), bf16 -> f32, B N-major
__device__ __forceinline__ void wgmma_bf16_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db));
}
// D[64 x 32] += A (smem, K-major) x B (smem), bf16 -> f32, B N-major
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}
// D[64 x 16] += A (smem, K-major) x B (smem), s8 -> s32, exact, B K-major
__device__ __forceinline__ void wgmma_s8_n16(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(da), "l"(db));
}
// D[64 x 32] += A (smem, K-major) x B (smem), s8 -> s32, exact, B K-major
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 16) wgmma_bf16_n16(d, da, db);
  else wgmma_bf16_n32(d, da, db);
}
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 16) wgmma_s8_n16(d, da, db);
  else wgmma_s8_n32(d, da, db);
}

// --- the kernel --------------------------------------------------------------

// int8: the static scale's reciprocal 127 / max(act, 1e-12) and the code of
// lrelu(v), as mma_conv_kernel's static route quantizes.
__device__ __forceinline__ float fused_inv(const float* act, int ci) {
  return __fdiv_rn(127.f, fmaxf(act[ci], 1e-12f));
}
__device__ __forceinline__ int fused_code(float v, float inv) {
  return __float2int_rn(fminf(fmaxf(__fmul_rn(lrelu(v, 0.1f), inv), -127.f), 127.f));
}

// Row `row`, channels c, c + 1 (c even) of the row buffer: the next conv's
// operand op(lrelu(v)), bf16 or int8 codes at `inv`.  Chunk-major:
// [C / (16 / OP)][W][16 bytes].
template <FRoute R>
__device__ __forceinline__ void put_pair(unsigned char* obuf, int W, int row, int c, float v0, float v1,
                                         float inv) {
  if constexpr (R == FRoute::kBf16) {
    *reinterpret_cast<__nv_bfloat162*>(obuf + ((size_t)(c / 8) * W + row) * 16 + (c % 8) * 2) =
        __floats2bfloat162_rn(lrelu(v0, 0.1f), lrelu(v1, 0.1f));
  } else {
    *reinterpret_cast<char2*>(obuf + ((size_t)(c / 16) * W + row) * 16 + (c % 16)) =
        make_char2((signed char)fused_code(v0, inv), (signed char)fused_code(v1, inv));
  }
}

// One launch: the n_res resblocks of a stage with N = C channels, for
// every (batch row, tile) of the persistent grid: two
// warpgroups compute, each half of every conv's output channels; in the
// third, which hands its registers to them (setmaxnreg), one lane streams
// the weights and another the windows.  (Without setmaxnreg ptxas leaves
// 168 registers a thread and the wider instantiations spilled: 12-30%
// slower on the card.  Issuing the copies from a compute
// thread, 255 registers, was slower still: the issuing warp waited for
// every warp's release of each slot.)
template <FRoute R, int N>
__global__ void __launch_bounds__(FUSED_THREADS, 1) mrf_fused_kernel(const __grid_constant__ FusedArgs a) {
  using T = FusedTraits<R>;
  using Acc = std::conditional_t<R == FRoute::kInt8, int, float>;
  constexpr int TAP = N * N * T::WE;  // bytes of a weight tap
  constexpr int SLOT = fused_slot_bytes(T::WE, N);
  constexpr int TP = SLOT / TAP;       // taps a ring slot
  constexpr int KSTEPS = N / T::KSTEP;
  constexpr int NW = N / 2;  // output channels of a warpgroup
  constexpr int NA = NW / 2;  // accumulators a thread holds for a 64-row block
  constexpr int MB = FUSED_MAX_BLOCKS;
  static_assert(N % T::KSTEP == 0 && N % 32 == 0 && N <= 64 && TP >= 1, "widths");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) &
                                                         ~static_cast<uintptr_t>(127));
  const int W = a.win, S = a.stages;
  float* rbuf = reinterpret_cast<float*>(ring + (size_t)S * SLOT);   // trunk, [N/4][W][4] float32
  unsigned char* obuf = reinterpret_cast<unsigned char*>(rbuf + (size_t)W * N);  // row buffer
  float* accs = reinterpret_cast<float*>(obuf + (size_t)W * N * T::OP);          // [bm][N]
  uint64_t* bars = reinterpret_cast<uint64_t*>(accs + (size_t)a.bm * N);
  uint64_t* full = bars;                           // ring slot s loaded
  uint64_t* empty = bars + FUSED_MAX_STAGES;       // ring slot s consumed by every warp
  uint64_t* win_full = bars + 2 * FUSED_MAX_STAGES;  // a resblock's window loaded
  uint64_t* win_empty = win_full + 1;                // the trunk free for the next window

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, FUSED_WARPS);
    }
    mbar_init(win_full, 1);
    mbar_init(win_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The copy warpgroup.  Lane 0 of its first warp walks every slot of the
  // block in the compute warps' order (tile, resblock, unit, conv, tap
  // group), into the ring as slots come free.  Lane 1 loads each
  // resblock's window into the trunk once the previous resblock is done
  // with it.  Roles by warpgroup, uniform in each warp: setmaxnreg needs
  // the two paths apart to the end of the kernel.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == FUSED_WARPS / 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FUSED_COPY_REGS));
    if (warp == FUSED_WARPS && lane == 0) {
      int slot = 0, phase = 0;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x)
        for (int i = 0; i < a.n_res; ++i) {
          const FusedRes& rs = a.res[i];
          for (int u = 0; u < rs.units; ++u)
            for (int cv = 0; cv < (rs.b2 ? 2 : 1); ++cv) {
              const CUtensorMap* map = &a.w_map[i][cv];
              for (int tg = 0; tg * TP < rs.k; ++tg) {
                const int nt = min(TP, rs.k - tg * TP);
                mbar_wait(empty + slot, phase ^ 1);
                mbar_expect_tx(full + slot, (unsigned)(nt * TAP));
                for (int tt = 0; tt < nt; ++tt) {
                  unsigned char* dst = ring + (size_t)slot * SLOT + tt * TAP;
                  const int t = tg * TP + tt;
                  if constexpr (R == FRoute::kBf16) {  // [k][C_in][C_out]: boxes of 8 outputs -> [N/8][N][8]
                    for (int j = 0; j < N / 8; ++j)
                      tma_load_2d(dst + j * N * 16, map, 8 * j, (u * rs.k + t) * N, full + slot);
                  } else {  // [k][C_out][C_in] codes: boxes of 16 inputs -> [N/16][N][16]
                    for (int q = 0; q < N / 16; ++q)
                      tma_load_2d(dst + q * N * 16, map, 16 * q, (u * rs.k + t) * N, full + slot);
                  }
                }
                if (++slot == S) slot = 0, phase ^= 1;
              }
            }
        }
    } else if (warp == FUSED_WARPS && lane == 1) {
      int n = 0;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x)
        for (int i = 0; i < a.n_res; ++i, ++n) {
          mbar_wait(win_empty, (n & 1) ^ 1);
          mbar_expect_tx(win_full, (unsigned)(W * N * 4));
          const int row0 = (tile % a.tiles_per_row) * a.bm - a.halo;
          for (int c4 = 0; c4 < N / 4; ++c4)  // boxes of 4 channels x xbox rows -> [N/4][W][4]
            for (int r = 0; r < W; r += a.xbox)
              tma_load_3d(rbuf + ((size_t)c4 * W + r) * 4, &a.x_map, 4 * c4, row0 + r, tile / a.tiles_per_row,
                          win_full);
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FUSED_COMPUTE_REGS));
    // A slot is done with once every warp has passed its wgmma wait.
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    };

    // Warpgroup wg takes the output channels [wg * NW, wg * NW + NW) of
    // every 64-row block; in the fragments, warp wq holds rows 16 wq + g
    // (+ 8), and the accumulator pair 4q + 2h (+ 1) is row + 8h, channels
    // wg * NW + 8q + 2tq (+ 1).
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, tq = lane % 4;
    int slot = 0, phase = 0, wi = 0;
    Acc acc[MB][NA];

    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      const int b = tile / a.tiles_per_row, l0 = (tile % a.tiles_per_row) * a.bm;
      const int lbase = l0 - a.halo;  // sequence position of window row 0
      for (int i = 0; i < a.n_res; ++i) {
        const FusedRes& rs = a.res[i];
        const int k = rs.k, pk = (k - 1) / 2, convs = rs.b2 ? 2 : 1;
        int lo = a.halo - rs.halo, hi = lo + a.bm + 2 * rs.halo;
        int ci = rs.act0;  // flat index of the next conv
        mbar_wait(win_full, wi & 1);
        ++wi;
        {  // the first conv's operand op(lrelu(trunk)) at the rows [lo, hi)
          const float inv = R == FRoute::kInt8 ? fused_inv(a.act, ci) : 0.f;
          const int n = hi - lo;
          for (int e = tid; e < n * (N / 4); e += FUSED_WARPS * 32) {
            const int row = lo + e % n, c = 4 * (e / n);
            const float4 v = *reinterpret_cast<const float4*>(rbuf + ((size_t)(c / 4) * W + row) * 4);
            put_pair<R>(obuf, W, row, c, v.x, v.y, inv);
            put_pair<R>(obuf, W, row, c + 2, v.z, v.w, inv);
          }
          fence_proxy_async();  // operand rows for wgmma
          consumer_sync();
        }
        for (int u = 0; u < rs.units; ++u) {
          const bool last_unit = u == rs.units - 1;
          for (int cv = 0; cv < convs; ++cv) {
            const int dil = cv == 0 ? rs.dil[u] : 1;
            lo += pk * dil;
            hi -= pk * dil;
            // The conv computes the rows [lo, hi) of the window from the
            // operand rows [lo - reach, hi + reach), tap t read at the shift
            // (t - (k-1)/2) * dil, in nb blocks of 64 rows: block j covers
            // rows s[j]..s[j]+63; the last starts at hi - 64 (every range
            // holds 64 rows or more) and overlaps its predecessor, whose rows
            // the epilogue skips.
            const int nb = (hi - lo + FUSED_BLOCK - 1) / FUSED_BLOCK;
            int s[MB];
#pragma unroll
            for (int j = 0; j < MB; ++j) s[j] = min(lo + FUSED_BLOCK * j, hi - FUSED_BLOCK);
#pragma unroll
            for (int j = 0; j < MB; ++j)
#pragma unroll
              for (int e = 0; e < NA; ++e) {
                acc[j][e] = Acc(0);
                pin(acc[j][e]);
              }
            // Slots of this conv: tap groups of TP taps, each released as
            // soon as its products are done.  (Keeping a slot's products in
            // flight while the next is issued released each slot one slot
            // later, which 2-3 slot rings could not hide: slower on the card.)
            for (int tg = 0; tg * TP < k; ++tg) {
              mbar_wait(full + slot, phase);
              const unsigned char* ws = ring + (size_t)slot * SLOT;
              wgmma_fence();
#pragma unroll 1
              for (int tt = 0; tt < TP; ++tt) {
                const int t = tg * TP + tt;
                if (t >= k) break;
                const int shift = (t - (k - 1) / 2) * dil;
                const unsigned char* wt = ws + tt * TAP;
#pragma unroll
                for (int j = 0; j < MB; ++j) {
                  if (j >= nb) break;
                  const int row = s[j] + shift;
#pragma unroll
                  for (int ks = 0; ks < KSTEPS; ++ks) {
                    if constexpr (R == FRoute::kBf16) {  // B: this warpgroup's NW / 8 groups of 8 outputs
                      const uint64_t da =
                          smem_desc(obuf + ((size_t)(ks * 2) * W + row) * 16, W * 16, 128);
                      wgmma_bf16<NW>(acc[j], da, smem_desc(wt + ks * 256 + wg * (NW / 8) * N * 16, 128, N * 16));
                    } else {  // B: this warpgroup's NW output rows of each 16-input chunk
                      const uint64_t da =
                          smem_desc(obuf + ((size_t)(ks * 2) * W + row) * 16, W * 16, 128);
                      wgmma_s8<NW>(acc[j], da, smem_desc(wt + (2 * ks * N + wg * NW) * 16, N * 16, 128));
                    }
                  }
                }
              }
              wgmma_commit();
              wgmma_wait0();
              release(slot);
              if (++slot == S) slot = 0, phase ^= 1;
            }
#pragma unroll
            for (int j = 0; j < MB; ++j)
#pragma unroll
              for (int e = 0; e < NA; ++e) pin(acc[j][e]);
            consumer_sync();  // every warpgroup is done reading the operand rows

            const bool resid = cv == convs - 1;  // adds the trunk; the unit's last conv
            const bool out_conv = resid && last_unit;
            const float* bias = (cv == 0 ? rs.b1 : rs.b2) + (size_t)u * N;
            float dq = 0.f, inv_next = 0.f;
            const float* wscale = nullptr;
            if constexpr (R == FRoute::kInt8) {
              dq = __fdiv_rn(fmaxf(a.act[ci], 1e-12f), 127.f);
              wscale = (cv == 0 ? rs.s1 : rs.s2) + (size_t)u * N;
              if (!out_conv) inv_next = fused_inv(a.act, ci + 1);
            }
#pragma unroll
            for (int j = 0; j < MB; ++j) {
              if (j >= nb) break;
              const int first_row = lo + FUSED_BLOCK * j;  // rows before it: an earlier block's
#pragma unroll
              for (int q = 0; q < NW / 8; ++q) {
                const int c = wg * NW + 8 * q + 2 * tq;
                const float bias0 = bias[c], bias1 = bias[c + 1];
                float mult0 = 0.f, mult1 = 0.f;
                if constexpr (R == FRoute::kInt8) {
                  mult0 = __fmul_rn(wscale[c], dq);
                  mult1 = __fmul_rn(wscale[c + 1], dq);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int row = s[j] + 16 * wq + g + 8 * h;
                  if (row < first_row) continue;
                  const int l = lbase + row;
                  const bool valid = l >= 0 && l < a.L;
                  float v[2];
                  const Acc x0 = acc[j][4 * q + 2 * h], x1 = acc[j][4 * q + 2 * h + 1];
                  if constexpr (R == FRoute::kInt8) {
                    v[0] = __fadd_rn(__fmul_rn(__int2float_rn(x0), mult0), bias0);
                    v[1] = __fadd_rn(__fmul_rn(__int2float_rn(x1), mult1), bias1);
                  } else {
                    v[0] = __fadd_rn(x0, bias0);
                    v[1] = __fadd_rn(x1, bias1);
                  }
                  if (!resid) {  // the next conv's input, zero outside [0, L)
                    put_pair<R>(obuf, W, row, c, valid ? v[0] : 0.f, valid ? v[1] : 0.f, inv_next);
                    continue;
                  }
                  float* rp = rbuf + ((size_t)(c / 4) * W + row) * 4 + c % 4;
                  const float2 r = *reinterpret_cast<const float2*>(rp);
                  const float n0 = valid ? __fadd_rn(v[0], r.x) : 0.f, n1 = valid ? __fadd_rn(v[1], r.y) : 0.f;
                  if (!out_conv) {
                    *reinterpret_cast<float2*>(rp) = make_float2(n0, n1);
                    put_pair<R>(obuf, W, row, c, n0, n1, inv_next);
                    continue;
                  }
                  // the resblock's output at the centre rows: add it to the stage sum
                  if (!valid) continue;
                  const int m = row - a.halo;
                  float t0 = n0, t1 = n1;
                  if (i > 0) {
                    const float2 p = *reinterpret_cast<const float2*>(accs + (size_t)m * N + c);
                    t0 = __fadd_rn(p.x, t0);
                    t1 = __fadd_rn(p.y, t1);
                  }
                  if (i < a.n_res - 1) {
                    *reinterpret_cast<float2*>(accs + (size_t)m * N + c) = make_float2(t0, t1);
                    continue;
                  }
                  const size_t o = ((size_t)b * a.L + l) * N + c;
                  const float d = (float)a.n_res;
                  const float m0 = __fdiv_rn(t0, d), m1 = __fdiv_rn(t1, d);
                  if (a.out_bf16)
                    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + o) =
                        __floats2bfloat162_rn(m0, m1);
                  else
                    *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) = make_float2(m0, m1);
                }
              }
            }
            ++ci;
            fence_proxy_async();  // operand rows for wgmma; the trunk before the next window's load
            consumer_sync();
          }
        }
        // the trunk is free: the next window may come in
        if (tid == 0) mbar_arrive(win_empty);
      }
    }
  }
}


// --- host side -----------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up once (cudaGetDriverEntryPoint).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static std::atomic<PFN_cuTensorMapEncodeTiled_v12000> fn{nullptr};
  PFN_cuTensorMapEncodeTiled_v12000 f = fn.load(std::memory_order_acquire);
  if (f == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      f = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    fn.store(f, std::memory_order_release);
  }
  return f;
}

// A tiled, unswizzled tensor map of `rank` dimensions (innermost first);
// out-of-bounds elements read 0.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, type, rank, const_cast<void*>(base), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <FRoute R, int N>
int run_fused(const FusedArgs& args, int ctas, size_t smem, cudaStream_t s) {
  auto kernel = mrf_fused_kernel<R, N>;
  static std::atomic<int> opted_on[MAX_DEVICES];
  const cudaError_t opted = opt_in_smem_once(kernel, opted_on);
  if (opted != cudaSuccess) return (int)opted;
  kernel<<<ctas, FUSED_THREADS, smem, s>>>(args);
  return (int)cudaGetLastError();
}

// The n_res resblocks of a stage (rows of FUSED_RES_FIELDS in `res`) on
// the float32 stage input x [B, L, C] into out, their mean; the plan (win,
// bm, stages, ctas) comes from ops/mrf.py::plan_fused and is checked here:
// the window is bm + 2 * halo rows, at most FUSED_BLOCK * FUSED_MAX_BLOCKS,
// a multiple of 8 (TMA destinations stay 128-byte aligned), of 16 past one
// box (two boxes of win / 2 rows), bm >= 64.
template <FRoute R>
int fused_launch(int out_bf16, int B, int L, int C, int n_res, int win, int bm, int stages, int ctas,
                 const void* x, const void* res, const void* act, void* out, cudaStream_t s) {
  using T = FusedTraits<R>;
  const auto bad = (int)cudaErrorInvalidValue;
  if ((C != 32 && C != 64) || n_res < 1 || n_res > FUSED_MAX_RES || stages < FUSED_MIN_STAGES ||
      stages > FUSED_MAX_STAGES || win % 8 != 0 || win > FUSED_BLOCK * FUSED_MAX_BLOCKS ||
      (win > FUSED_BOX && win % 16 != 0) || bm < FUSED_BLOCK || ctas < 1 || B < 1 || L < 1 ||
      (R == FRoute::kInt8 && !act))
    return bad;
  FusedArgs a{};
  const long long* rows = static_cast<const long long*>(res);
  auto ptr = [](long long v) { return reinterpret_cast<const void*>(static_cast<uintptr_t>(v)); };
  int halo = 0;
  const CUtensorMapDataType wtype = R == FRoute::kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  for (int i = 0; i < n_res; ++i) {
    const long long* r = rows + (size_t)i * FUSED_RES_FIELDS;
    FusedRes& rs = a.res[i];
    rs.b1 = static_cast<const float*>(ptr(r[2]));
    rs.b2 = static_cast<const float*>(ptr(r[3]));
    rs.s1 = static_cast<const float*>(ptr(r[4]));
    rs.s2 = static_cast<const float*>(ptr(r[5]));
    rs.k = (int)r[6];
    rs.units = (int)r[7];
    rs.act0 = (int)r[8];
    const bool two = r[1] != 0;
    if (rs.k < 1 || rs.k % 2 != 1 || rs.units < 1 || rs.units > FUSED_MAX_UNITS || !r[0] || !rs.b1 ||
        two != (rs.b2 != nullptr) || (R == FRoute::kInt8 && (!rs.s1 || (two && !rs.s2))))
      return bad;
    int reach = 0;
    for (int u = 0; u < rs.units; ++u) {
      rs.dil[u] = (int)r[9 + u];
      if (rs.dil[u] < 1) return bad;
      reach += rs.dil[u] + (two ? 1 : 0);
    }
    rs.halo = (rs.k - 1) / 2 * reach;
    halo = halo > rs.halo ? halo : rs.halo;
    for (int cv = 0; cv < (two ? 2 : 1); ++cv) {
      // rows: [units][k][C_in] of C_out (bf16), [units][k][C_out] of C_in
      // (int8 codes, K-major); boxes of 16 bytes a row: 8 outputs x C rows
      // (bf16), 16 inputs x C rows (int8)
      const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rs.units * rs.k * C};
      const cuuint64_t strides[1] = {(cuuint64_t)C * T::WE};
      const cuuint32_t box[2] = {R == FRoute::kBf16 ? 8u : 16u, (cuuint32_t)C};
      if (!encode_map(&a.w_map[i][cv], wtype, 2, ptr(r[cv]), dims, strides, box)) return bad;
    }
  }
  if (win != bm + 2 * halo) return bad;
  // the window: x [B][L][C], boxes of 4 channels x xbox rows, rows outside
  // [0, L) read 0
  const int xbox = win > FUSED_BOX ? win / 2 : win;
  const cuuint64_t xdims[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t xstrides[2] = {(cuuint64_t)C * 4, (cuuint64_t)L * C * 4};
  const cuuint32_t xbox_dims[3] = {4, (cuuint32_t)xbox, 1};
  if (!encode_map(&a.x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, x, xdims, xstrides, xbox_dims)) return bad;
  a.act = static_cast<const float*>(act);
  a.out = out;
  a.out_bf16 = out_bf16;
  a.L = L;
  a.n_res = n_res;
  a.win = win;
  a.xbox = xbox;
  a.bm = bm;
  a.halo = halo;
  a.stages = stages;
  a.tiles_per_row = (L + bm - 1) / bm;
  a.n_tiles = B * a.tiles_per_row;
  if (ctas > a.n_tiles) ctas = a.n_tiles;
  const size_t smem = fused_smem_bytes(T::OP, fused_slot_bytes(T::WE, C), C, win, bm, stages);
  return C == 32 ? run_fused<R, 32>(a, ctas, smem, s) : run_fused<R, 64>(a, ctas, smem, s);
}

}  // namespace viettts
