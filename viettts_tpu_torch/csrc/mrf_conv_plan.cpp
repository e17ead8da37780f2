// The per-conv wgmma pipeline's plan (mrf_conv_plan.h) behind a C
// interface, for a host-only library built with the system's C++ compiler
// (ops/_build.py::load_plan_library): the kernel library plans each launch
// with the same header.

#include "mrf_conv_plan.h"

// 1 if the pipeline takes the MRF convs of a stage (route 0: bf16, 1:
// int8 with static scales, 2: tf32, the float32 route, 3: int8 with
// dynamic scales; B rows of L steps, C channels), else 0.
extern "C" int viettts_conv_wgmma_takes(int route, int B, int L, int C) {
  return viettts::conv_takes_stage(route, B, L, C) ? 1 : 0;
}

// The launch of one conv on a route on a card of `sms` SMs into
// out[CONV_PLAN_FIELDS] (bm, bn, planes, stages, win, xbox, tiles, ctas,
// smem); 0 where no tile fits.
extern "C" int viettts_conv_wgmma_plan(int route, int B, int L, int C, int k, int dil, int sms, int* out) {
  viettts::ConvPlan p{};
  if (!viettts::conv_plan(route, B, L, C, k, dil, sms, &p)) return 0;
  const int fields[viettts::CONV_PLAN_FIELDS] = {p.bm, p.bn, p.planes, p.stages, p.win, p.xbox, p.tiles, p.ctas,
                                                 p.smem};
  for (int i = 0; i < viettts::CONV_PLAN_FIELDS; ++i) out[i] = fields[i];
  return 1;
}
