// The launch plan of the per-conv wgmma pipeline (mrf_conv_wgmma.cuh):
// which generator stages it takes on each route, and each conv's chunk,
// tile shape, weight-ring depth, window rows and persistent grid.  Plain
// C++ with no CUDA header: the kernel library includes it (every launch
// plans here), and mrf_conv_plan.cpp exports it through a C interface to a
// small host library (ops/_build.py::load_plan_library), which ops/mrf.py,
// the FLOP count (utils/flops.py) and the CPU tests call.  So the plan is
// written once, here.
#pragma once

namespace viettts {

constexpr int CONV_THREADS = 384;        // two compute warpgroups and a copy warpgroup
constexpr int CONV_CHUNK_BYTES = 128;    // bytes of one row of a full K chunk (16-byte planes)
constexpr int CONV_MIN_STAGES = 3, CONV_MAX_STAGES = 6;  // weight-ring slots
constexpr int CONV_BOX = 256;            // rows of a TMA box: a longer window takes two
constexpr int CONV_SMEM_LIMIT = 232448;  // shared memory a block may opt in to on the H100
constexpr int CONV_MAX_WIN = 2 * CONV_BOX;
// The epilogue stages each compute warp's 16 rows of a 64-row block in a
// strip of shared memory, rows padded by 4 words.
constexpr int CONV_WARPS = 8, CONV_STRIP_ROWS = 16, CONV_STRIP_PAD = 4;

// The routes (ops/mrf.py::CONV_ROUTES): the operand a conv reads and the
// product it issues.
//   0 bf16: bf16 operands, wgmma bf16 -> f32;
//   1 int8 with static (calibrated) scales: int8 codes, wgmma s8 -> s32;
//   2 tf32, the float32 route: each operand element as its TF32 parts hi
//     and lo (8 bytes), three wgmma tf32 -> f32 products a product (3xTF32);
//   3 int8 with dynamic scales (one amax a conv and batch row): as 1.
constexpr int CONV_ROUTE_BF16 = 0, CONV_ROUTE_INT8 = 1, CONV_ROUTE_TF32 = 2, CONV_ROUTE_INT8_DYNAMIC = 3;

// Bytes a channel takes in one row of a K chunk on a route.
inline int conv_channel_bytes(int route) {
  return route == CONV_ROUTE_BF16 ? 2 : route == CONV_ROUTE_TF32 ? 8 : 1;
}

// 16-byte planes of a K chunk (its row is planes * 16 bytes): a full chunk
// where C fills one, else C's own bytes (32 or 64: int8 at C = 32 and 64),
// so that a wgmma k-step (32 bytes) never reads past C; 0 where no chunk
// divides C.  A tf32 chunk holds 16 channels: 4 planes of hi, 4 of lo.
inline int conv_chunk_planes(int route, int C) {
  if (route < CONV_ROUTE_BF16 || route > CONV_ROUTE_INT8_DYNAMIC || C < 1) return 0;
  const int row = C * conv_channel_bytes(route);
  const int bytes = row < CONV_CHUNK_BYTES ? row : CONV_CHUNK_BYTES;
  if ((bytes != 32 && bytes != 64 && bytes != 128) || row % bytes != 0) return 0;
  return bytes / 16;
}

// Tile shapes (output rows x output channels), largest first.  Each
// compute warpgroup takes bm / 2 rows in 64-row blocks and all bn
// channels: bn / 2 accumulators a block per thread, at most 128.  A tile
// with `only` set serves the stages of that width alone (C = bn: the
// narrow stages of the tf32 and int8 routes).
struct ConvTile {
  int bm, bn, only;
};
constexpr ConvTile CONV_TILES[] = {{256, 128, 0}, {128, 128, 0}, {256, 64, 64}, {128, 64, 0},
                                   {256, 32, 32}, {128, 32, 32}};
constexpr int CONV_N_TILES = sizeof(CONV_TILES) / sizeof(CONV_TILES[0]);

// One conv's launch.  Its fields, in this order, are what the C interface
// returns (CONV_PLAN_FIELDS ints).
struct ConvPlan {
  int bm, bn, planes, stages, win, xbox, tiles, ctas, smem;
};
constexpr int CONV_PLAN_FIELDS = 9;

// Window rows of a tile: its bm rows and the conv's reach, (k - 1) * dil,
// a multiple of 16 (each 16-byte row plane, and each half past one box,
// starts 128-byte aligned, as TMA destinations must).
inline int conv_window(int bm, int k, int dil) {
  const int w = bm + (k - 1) * dil;
  return (w + 15) / 16 * 16;
}

// Dynamic shared memory: 256 bytes of alignment slack and mbarriers, two
// window chunks (win rows of `chunk` bytes), the weight ring (a slot holds
// one tap's chunk for bn outputs: bn rows of `chunk` bytes) and the
// epilogue's strips (4-byte sums).
inline int conv_smem_bytes(int bn, int win, int stages, int chunk = CONV_CHUNK_BYTES) {
  return 256 + 2 * win * chunk + stages * chunk * bn + CONV_WARPS * CONV_STRIP_ROWS * (bn + CONV_STRIP_PAD) * 4;
}

// Whether the pipeline takes the MRF convs of a stage of width C, B rows
// of L steps, on a route: where it beat mma_conv_kernel on an H100
// (PERF.md §6), timed in turns at B=1 (512 mel frames), B=2 (128) and B=64
// (768).  bf16: every C = 256 and 128 stage.  tf32: every stage, C = 256
// to 32.  int8, static or dynamic scales: C = 256 and 128 (dynamic: also
// 64 and 32), but C = 256 below CONV_INT8_MIN_ROWS rows (B=2 x 1,024 rows:
// 64 blocks of 128 x 64 tiles, half the card, lost to mma_conv_kernel by
// 0.04 ms static, 0.02 ms dynamic).
constexpr long long CONV_INT8_MIN_ROWS = 4096;
inline bool conv_takes_stage(int route, int B, int L, int C) {
  if (B < 1 || L < 1) return false;
  const bool wide = C == 128 || C == 256, narrow = C == 64 || C == 32;
  switch (route) {
    case CONV_ROUTE_BF16: return wide;
    case CONV_ROUTE_TF32: return wide || narrow;
    case CONV_ROUTE_INT8:
    case CONV_ROUTE_INT8_DYNAMIC:
      if (C == 256) return (long long)B * L >= CONV_INT8_MIN_ROWS;
      return C == 128 || (route == CONV_ROUTE_INT8_DYNAMIC && narrow);
    default: return false;
  }
}

// The launch of one conv (kernel size k, dilation dil) of such a stage on
// a card of `sms` SMs, or false where no tile fits.  C is a multiple of
// 128, or (tf32, int8) a narrow width of its own tiles (64, 32); the bf16
// kernels come for full chunks only.  Of the tile shapes that divide C, it
// takes the one whose persistent grid costs least: waves (tiles over SMs,
// rounded up) x (bm + 64) x (bn + 64), a tile's outputs with what it pays
// per row (the window) and per channel (the weights); ties go to the
// larger tile.  The ring is as deep as shared memory allows.
inline bool conv_plan(int route, int B, int L, int C, int k, int dil, int sms, ConvPlan* plan) {
  const int planes = conv_chunk_planes(route, C);
  if (B < 1 || L < 1 || planes == 0 || k < 1 || k % 2 != 1 || dil < 1 || sms < 1) return false;
  if (C % 128 != 0 && (route == CONV_ROUTE_BF16 || (C != 64 && C != 32))) return false;
  const int chunk = planes * 16;
  bool found = false;
  long long best = 0;
  for (int i = 0; i < CONV_N_TILES; ++i) {
    const ConvTile t = CONV_TILES[i];
    if (t.bn > C || C % t.bn != 0 || (t.only != 0 && t.only != C)) continue;
    const int win = conv_window(t.bm, k, dil);
    if (win > CONV_MAX_WIN) continue;
    int stages = CONV_MAX_STAGES;
    while (stages >= CONV_MIN_STAGES && conv_smem_bytes(t.bn, win, stages, chunk) > CONV_SMEM_LIMIT) --stages;
    if (stages < CONV_MIN_STAGES) continue;
    const long long tiles = (long long)B * ((L + t.bm - 1) / t.bm) * (C / t.bn);
    const long long waves = (tiles + sms - 1) / sms;
    const long long cost = waves * (t.bm + 64) * (t.bn + 64);
    if (found && cost >= best) continue;
    found = true;
    best = cost;
    plan->bm = t.bm;
    plan->bn = t.bn;
    plan->planes = planes;
    plan->stages = stages;
    plan->win = win;
    plan->xbox = win > CONV_BOX ? win / 2 : win;
    plan->tiles = (int)tiles;
    plan->ctas = (int)(tiles < sms ? tiles : sms);
    plan->smem = conv_smem_bytes(t.bn, win, stages, chunk);
  }
  return found;
}

}  // namespace viettts
