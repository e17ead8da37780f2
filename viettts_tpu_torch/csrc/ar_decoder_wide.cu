// K1's instantiations for plans with more than one column group or a
// streamed gate block (ar_decoder.cuh), in a source of their own so that
// nvcc builds them beside the resident ones.

#include "ar_decoder.cuh"

namespace viettts_k1 {

const void* wide_kernel(int UG) {
  switch (UG) {
    case 1: return (const void*)ar_decode_grid<1, true>;
    case 2: return (const void*)ar_decode_grid<2, true>;
    case 3: return (const void*)ar_decode_grid<3, true>;
    case 4: return (const void*)ar_decode_grid<4, true>;
    case 5: return (const void*)ar_decode_grid<5, true>;
    case 6: return (const void*)ar_decode_grid<6, true>;
    default: return nullptr;
  }
}

}  // namespace viettts_k1
