// K1's host entry points and the resident plans' instantiations
// (ar_decoder_wide.cu holds the grouped or streamed ones); the kernel and
// its design are in ar_decoder.cuh.

#include "ar_decoder.cuh"

namespace {

const void* resident_kernel(int UG) {
  switch (UG) {
    case 1: return (const void*)ar_decode_grid<1, false>;
    case 2: return (const void*)ar_decode_grid<2, false>;
    case 3: return (const void*)ar_decode_grid<3, false>;
    case 4: return (const void*)ar_decode_grid<4, false>;
    case 5: return (const void*)ar_decode_grid<5, false>;
    case 6: return (const void*)ar_decode_grid<6, false>;
    default: return nullptr;
  }
}

const void* kernel_for(int UG, int NG, int streamed) {
  return NG > 1 || streamed ? viettts_k1::wide_kernel(UG) : resident_kernel(UG);
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// The plan's shapes as the kernel takes them: a grid that covers H with
// its last CTA non-empty, per-group counts it is instantiated for, one
// output per thread for S staged rows, and the shared memory the plan
// claims.
bool valid_plan(int B, int H, int P, int D, int G, int UG, int NG, int PK, int DK, int S, int R, int streamed,
                int smem_bytes) {
  const long U = (long)UG * NG;
  return B >= 1 && B <= R && R <= kRows && S >= 1 && S <= kStage && S <= R && UG >= 1 && UG <= kMaxUnits &&
         NG >= 1 && G * U >= H && (G - 1) * U < H && pow2(PK) && pow2(DK) && PK <= 2 * kWarps &&
         DK <= 2 * kWarps && S * max3(4 * UG, PK, DK) <= kThreads && streamed >= 0 && streamed < 1 << kBlocks &&
         (size_t)smem_bytes == sizeof(float) * smem_floats(H, P, D, UG, NG, PK, DK, S, R, streamed);
}

}  // namespace

// Opt the kernel for plan (G, UG, NG, ..., streamed) in to the largest
// dynamic shared memory of the current device and check that G CTAs of
// smem_bytes can be co-resident.  Call it once per device and plan,
// outside any stream capture, before viettts_ar_decode launches that plan.
extern "C" int viettts_ar_decode_prepare(int H, int P, int D, int G, int UG, int NG, int PK, int DK, int S,
                                         int R, int streamed, int smem_bytes) {
  if (!valid_plan(1, H, P, D, G, UG, NG, PK, DK, S, R, streamed, smem_bytes)) return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for(UG, NG, streamed);
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem_bytes > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  // the CTAs spin on each other's results: all must be resident; refuse, never shrink
  if (per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

// One cooperative launch of a prepared plan on `stream`; under stream
// capture it becomes a cooperative kernel node.  B <= R rows.  wstream
// holds G x 4 UG NG x (rows of the streamed blocks) floats (null when
// nothing is streamed); the launch overwrites it.
extern "C" int viettts_ar_decode(const void* g1c, const void* g2c, const void* keep1,
                                 const void* keep2, const void* w_fc1, const void* w_fc2,
                                 const void* w1m, const void* w2m, const void* wp,
                                 const void* bp, void* out, void* exchange, void* wstream, int B, int L,
                                 int H, int P, int D, int G, int UG, int NG, int PK, int DK, int S, int R,
                                 int streamed, int smem_bytes, float scale, void* stream) {
  if (L < 1 || !valid_plan(B, H, P, D, G, UG, NG, PK, DK, S, R, streamed, smem_bytes) ||
      (streamed != 0) != (wstream != nullptr))
    return (int)cudaErrorInvalidValue;
  Dims d{B, L, H, P, D, G, NG, PK, DK, S, streamed, scale};
  void* args[] = {&g1c, &g2c, &keep1, &keep2, &w_fc1, &w_fc2, &w1m, &w2m, &wp, &bp, &out,
                  &exchange, &wstream, &d};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(G);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = (size_t)smem_bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelExC(&config, kernel_for(UG, NG, streamed), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
