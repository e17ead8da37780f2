// The float32 route of a HiFi-GAN generator stage (K2) on Hopper: its MRF
// convs on the per-conv wgmma pipeline (mrf_conv_wgmma.cuh) in 3xTF32,
// for the stages its plan takes (mrf_conv_plan.h, route 2); the prologue,
// the epilogue and the other stages stay in mrf.cu (mma_conv_kernel with
// Tf32Mma).  A file of its own so that nvcc builds its instantiations
// beside mrf.cu's, not after them.
//
// Replaces, for those stages, the MRF convs of the TPU kernel
// viettts_tpu/ops/mrf.py:181 (_mrf_kernel) on its float32 route, whose
// dots ran at HIGHEST precision.  3xTF32 as Tf32Mma computes it: each
// operand v split into TF32 parts hi = rna(v) and lo = rna(v - hi)
// (cvt.rna.tf32.f32), acc += a_lo * b_hi + a_hi * b_lo + a_hi * b_hi.  The
// weights come split once on the host (ops/mrf.py::Tf32Conv.slots); each
// producing epilogue writes the next conv's operand split, 4 bytes a part.
// What bounds it on the H100: three TF32 products a product, 3 x 2 * B *
// L * C^2 * 126 operations at 495 TFLOP/s (B=64, 768 mel frames: 39.4 ms
// at C = 256, 78.8 ms at C = 128), above the ~8 bytes an element that
// each conv's operand moves.

#include "mrf_common.cuh"
#include "mrf_conv_wgmma.cuh"

// The float32 route's MRF convs of a stage on the per-conv wgmma pipeline:
// n rows of viettts::CONV_FIELDS int64, one launch each (w the TF32 weight
// slots, pout the next conv's TF32 operand), planned by mrf_conv_plan.h.
extern "C" int viettts_mrf_conv_wgmma_tf32(int out_bf16, int B, int L, int C, float div, int n, const void* table,
                                           void* stream) {
  return viettts::conv_wgmma_stage<viettts::FRoute::kTf32>(out_bf16, B, L, C, div, n, table, 0,
                                                           static_cast<cudaStream_t>(stream));
}

// The TF32 operand lrelu(h) of a stage input h float32 [B, L, C]: for each
// chunk of 16 channels 4 planes of hi, then 4 of lo, [B][C / 2][L][4]
// (rows: n x (out, unused) int64).
extern "C" int viettts_mrf_conv_operands_tf32(int B, int L, int C, const void* h, int n, const void* rows,
                                              void* stream) {
  return viettts::conv_operands<viettts::FRoute::kTf32>(B, L, C, h, n, rows, 0, static_cast<cudaStream_t>(stream));
}
