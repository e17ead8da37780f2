// The launch plan of the per-conv wgmma pipeline (mrf_conv_wgmma.cuh):
// which generator stages it takes, and each conv's tile shape, weight-ring
// depth, window rows and persistent grid.  Plain C++ with no CUDA header:
// the kernel library includes it (every launch plans here), and
// mrf_conv_plan.cpp exports it through a C interface to a small host
// library (ops/_build.py::load_plan_library), which ops/mrf.py, the FLOP
// count (utils/flops.py) and the CPU tests call.  So the plan is written
// once, here.
#pragma once

namespace viettts {

constexpr int CONV_THREADS = 384;        // two compute warpgroups and a copy warpgroup
constexpr int CONV_CHUNK_BYTES = 128;    // bytes of one row of a K chunk: 64 bf16 or 128 int8 inputs
constexpr int CONV_MIN_STAGES = 3, CONV_MAX_STAGES = 6;  // weight-ring slots
constexpr int CONV_BOX = 256;            // rows of a TMA box: a longer window takes two
constexpr int CONV_SMEM_LIMIT = 232448;  // shared memory a block may opt in to on the H100
constexpr int CONV_MAX_WIN = 2 * CONV_BOX;
// The epilogue stages each compute warp's 16 rows of a 64-row block in a
// strip of shared memory, rows padded by 4 words.
constexpr int CONV_WARPS = 8, CONV_STRIP_ROWS = 16, CONV_STRIP_PAD = 4;

// Tile shapes (output rows x output channels), largest first.  Each
// compute warpgroup takes bm / 2 rows in 64-row blocks and all bn
// channels: bn / 2 accumulators a block per thread, at most 128.
struct ConvTile {
  int bm, bn;
};
constexpr ConvTile CONV_TILES[] = {{256, 128}, {128, 128}, {128, 64}};
constexpr int CONV_N_TILES = sizeof(CONV_TILES) / sizeof(CONV_TILES[0]);

// One conv's launch.  Its fields, in this order, are what the C interface
// returns (CONV_PLAN_FIELDS ints).
struct ConvPlan {
  int bm, bn, stages, win, xbox, tiles, ctas, smem;
};
constexpr int CONV_PLAN_FIELDS = 8;

// Window rows of a tile: its bm rows and the conv's reach, (k - 1) * dil,
// a multiple of 16 (each 16-byte row plane, and each half past one box,
// starts 128-byte aligned, as TMA destinations must).
inline int conv_window(int bm, int k, int dil) {
  const int w = bm + (k - 1) * dil;
  return (w + 15) / 16 * 16;
}

// Dynamic shared memory: 256 bytes of alignment slack and mbarriers, two
// window chunks (win rows of CONV_CHUNK_BYTES), the weight ring (a slot
// holds one tap's chunk for bn outputs: bn rows of CONV_CHUNK_BYTES) and
// the epilogue's strips (4-byte sums).
inline int conv_smem_bytes(int bn, int win, int stages) {
  return 256 + 2 * win * CONV_CHUNK_BYTES + stages * CONV_CHUNK_BYTES * bn +
         CONV_WARPS * CONV_STRIP_ROWS * (bn + CONV_STRIP_PAD) * 4;
}

// Whether the pipeline takes the MRF convs of a stage of width C, B rows
// of L steps, on a route (0: bf16, 1: int8 with static scales): where it
// beat mma_conv_kernel on an H100 (PERF.md §6): every bf16 stage
// at B=1 (512 mel frames), B=2 (128) and B=64 (768), and int8 but at C =
// 256 below CONV_INT8_MIN_ROWS rows (B=2 x 1,024 rows: 64 blocks of 128 x
// 64 tiles, half the card, lost to its 0.38 ms by 0.04 ms).
constexpr long long CONV_INT8_MIN_ROWS = 4096;
inline bool conv_takes_stage(int route, int B, int L, int C) {
  if (B < 1 || L < 1 || (C != 128 && C != 256)) return false;
  if (route == 0) return true;
  return route == 1 && (C == 128 || (long long)B * L >= CONV_INT8_MIN_ROWS);
}

// The launch of one conv (kernel size k, dilation dil) of such a stage on
// a card of `sms` SMs, or false where no tile fits.  Of the tile shapes
// that divide C, it takes the one whose persistent grid costs least:
// waves (tiles over SMs, rounded up) x (bm + 64) x (bn + 64), a tile's
// outputs with what it pays per row (the window) and per channel (the
// weights); ties go to the larger tile.  The ring is as deep as shared
// memory allows.
inline bool conv_plan(int B, int L, int C, int k, int dil, int sms, ConvPlan* plan) {
  if (B < 1 || L < 1 || C < 64 || C % 128 != 0 || k < 1 || k % 2 != 1 || dil < 1 || sms < 1) return false;
  bool found = false;
  long long best = 0;
  for (int i = 0; i < CONV_N_TILES; ++i) {
    const ConvTile t = CONV_TILES[i];
    if (t.bn > C || C % t.bn != 0) continue;
    const int win = conv_window(t.bm, k, dil);
    if (win > CONV_MAX_WIN) continue;
    int stages = CONV_MAX_STAGES;
    while (stages >= CONV_MIN_STAGES && conv_smem_bytes(t.bn, win, stages) > CONV_SMEM_LIMIT) --stages;
    if (stages < CONV_MIN_STAGES) continue;
    const long long tiles = (long long)B * ((L + t.bm - 1) / t.bm) * (C / t.bn);
    const long long waves = (tiles + sms - 1) / sms;
    const long long cost = waves * (t.bm + 64) * (t.bn + 64);
    if (found && cost >= best) continue;
    found = true;
    best = cost;
    plan->bm = t.bm;
    plan->bn = t.bn;
    plan->stages = stages;
    plan->win = win;
    plan->xbox = win > CONV_BOX ? win / 2 : win;
    plan->tiles = (int)tiles;
    plan->ctas = (int)(tiles < sms ? tiles : sms);
    plan->smem = conv_smem_bytes(t.bn, win, stages);
  }
  return found;
}

}  // namespace viettts
