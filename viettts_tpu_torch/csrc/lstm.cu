// The encoders' bidirectional LSTM recurrence: both directions over every
// timestep in one persistent launch over a grid of co-resident CTAs.
//
// Replaces no TPU kernel: the JAX package runs the recurrence as one
// lax.scan under XLA (viettts_tpu/ops/rnn.py:137, unroll_lstm).  The port
// ran it op by op from Python (ops/rnn.py, unroll_lstm: a matmul and about
// a dozen gate ops a timestep and direction, ~29 launches a step pair), so
// a bulk call of two bi-LSTMs at B=64 over 256 tokens issued ~15,000 tiny
// kernels and the card waited for the host that issued them.  Per step and
// direction, with the input projection x @ w_i + b hoisted out as one
// matmul a direction (the caller's):
//
//   gates = xp_t + h_{t-1} @ w_h     (i, g, f, o: haiku's order)
//   c = sigmoid(f + 1) c + sigmoid(i) tanh(g)      h = sigmoid(o) tanh(c)
//
// from a zero state; the backward direction runs from the last timestep to
// the first and zeroes its state before it consumes every position t >=
// length - 1 (haiku's ResetCore), so every position, padded ones included,
// is the loop's function.
//
// What bounds it on the H100: the timesteps are sequential and each is a
// [rows, H] x [H, 4H] product (H=256, B=64: 34 MFLOP, 0.5 us of the card's
// float32 peak) whose input is the previous step's output from every unit.
// So what is left is latency: per step, one hand-off of h between CTAs
// through L2, and a CTA's own product.
//
// Design.  For each direction, the batch rows split into `groups` row
// groups and the hidden units into `slices` of kUnits units; a CTA owns one
// (direction, row group, slice) and holds the four w_h gate columns of its
// units in shared memory for the whole launch (H=256: 64 KB; H=512: 128
// KB).  The CTAs of one (direction, row group) exchange h through a global
// buffer of 64-bit words, float bits and the step number (+1), stored and
// loaded relaxed at GPU scope as K1 does (csrc/ar_decoder.cuh): a reader
// spins on each word until it carries the step it waits for, so a hand-off
// is one L2 round trip and needs no separate barrier.  Buffers alternate
// by step parity; a CTA reaches step s + 2's store for a row only after
// every CTA of its group has published that row at step s + 1, which each
// does after its last read of the row at step s, so no word is
// overwritten before it is read.  Row groups cut what a CTA gathers a step
// (B=64 at H=256: 4 groups of 16 rows, 32 KB a CTA, over 128 CTAs).  A CTA
// stages kPass rows of h at a time; thread (q, p) sums gate columns 2p and
// 2p + 1 over slice q of the rows of w_h for every staged row (16-byte
// loads of h, broadcast in the warp; 8-byte loads of the columns, no bank
// conflict), and the slices add in order: every dot is summed in a fixed
// order inside one CTA, so the same inputs give the same bits.  Float32
// FMA throughout, expf/tanhf without fast-math.  Spinning needs every CTA
// of a group resident: the launch is cooperative (a cooperative node when
// a CUDA graph captures it) and refused, never shrunk, when the occupancy
// does not allow the grid; viettts_bilstm_prepare opts the kernel in to its
// shared memory and checks that occupancy once per device and plan,
// outside any capture.  ops/rnn.py::plan_lstm sizes the grid and mirrors
// the constants and smem_floats below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 16;                 // hidden units a CTA owns
constexpr int kCols = 4 * kUnits;          // their gate columns
constexpr int kPairs = kCols / 2;          // a thread sums two columns ...
constexpr int kParts = kThreads / kPairs;  // ... over one of kParts slices of w_h's rows
constexpr int kPass = 8;                   // batch rows staged and summed at once
constexpr int kMaxH = 512;                 // widest hidden size planned
constexpr int kRows = 64;                  // batch rows a launch takes
static_assert(kPairs == 32, "a warp is one slice of w_h's rows, so its staged h loads broadcast");

typedef unsigned long long word;  // float bits | step tag << 32

struct Dims {
  int B, T, H;
  int slices;      // CTAs a (direction, row group): ceil(H / kUnits); the last may be partly empty
  int groups;      // row groups a direction
  int group_rows;  // rows a group (the last may hold fewer)
};

// n floats rounded up to whole 16-byte words
__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) & ~(size_t)3; }

// floats of dynamic shared memory a CTA uses; ops/rnn.py::lstm_smem_floats mirrors it
__host__ __device__ inline size_t smem_floats(int H, int group_rows) {
  return (size_t)H * kCols + kPass * pad4(H) + kParts * kPass * kCols + pad4((size_t)group_rows * kUnits) +
         pad4(group_rows);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void publish(word* p, float v, unsigned tag) {
  const word w = ((word)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ word peek(const word* p) {
  word w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// xs[r * ldx + k] = the value of src[(b0 + r) * H + k] once it carries
// `tag`, for r < nb, k < H.  Each thread spins on its own words, kIlp
// loads in flight, re-reading only those not arrived; after ~4 s of
// spinning it traps.
__device__ __forceinline__ void gather(float* xs, int ldx, const word* src, int H, int b0, int nb, unsigned tag) {
  constexpr int kIlp = 8;
  const int n = nb * H;
  for (int i0 = threadIdx.x; i0 < n; i0 += kIlp * kThreads) {
    const word* at[kIlp];
    int dst[kIlp];
    unsigned pending = 0;
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int i = i0 + u * kThreads, r = nb == 1 ? 0 : i / H, k = i - r * H;
      at[u] = src;
      dst[u] = 0;
      if (i < n) {
        at[u] = src + (size_t)(b0 + r) * H + k;
        dst[u] = r * ldx + k;
        pending |= 1u << u;
      }
    }
    word w[kIlp];
    unsigned long long t0 = 0;
    for (unsigned spins = 0; pending; ++spins) {
      if ((spins & 1023) == 1023) {  // a word that never comes fails the launch instead of holding the card
        unsigned long long now;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
        if (t0 == 0) t0 = now;
        else if (now - t0 > 4000000000ull) __trap();
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        if (pending >> u & 1) w[u] = peek(at[u]);
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        if ((pending >> u & 1) && (unsigned)(w[u] >> 32) == tag) {
          xs[dst[u]] = __uint_as_float((unsigned)w[u]);
          pending &= ~(1u << u);
        }
    }
  }
  __syncthreads();
}

// red[(q * kPass + r) * kCols + c] = sum over k in slice q of xs[r * ldx + k]
// * W[k * kCols + c], for r < NB and every column c: thread (q, p) sums
// columns 2p and 2p + 1, k ascending (in steps of 4 where the slice has
// them, then one at a time).
template <int NB>
__device__ __forceinline__ void matvec(const float* xs, int ldx, const float* W, int H, float* red) {
  const int p = threadIdx.x % kPairs, q = threadIdx.x / kPairs;
  const int span = ((H + kParts - 1) / kParts + 3) & ~3;
  const int k_lo = min(H, q * span), k_hi = min(H, k_lo + span);
  const int k_vec = k_lo + ((k_hi - k_lo) & ~3);
  float2 acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = make_float2(0.f, 0.f);
#pragma unroll 2
  for (int k = k_lo; k < k_vec; k += 4) {
    float2 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const float2*>(W + (size_t)(k + i) * kCols + 2 * p);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float4 x = *reinterpret_cast<const float4*>(xs + b * ldx + k);
      acc[b].x = fmaf(x.w, w[3].x, fmaf(x.z, w[2].x, fmaf(x.y, w[1].x, fmaf(x.x, w[0].x, acc[b].x))));
      acc[b].y = fmaf(x.w, w[3].y, fmaf(x.z, w[2].y, fmaf(x.y, w[1].y, fmaf(x.x, w[0].y, acc[b].y))));
    }
  }
  for (int k = k_vec; k < k_hi; ++k) {
    const float2 w = *reinterpret_cast<const float2*>(W + (size_t)k * kCols + 2 * p);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float x = xs[b * ldx + k];
      acc[b].x = fmaf(x, w.x, acc[b].x);
      acc[b].y = fmaf(x, w.y, acc[b].y);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) *reinterpret_cast<float2*>(red + (q * kPass + b) * kCols + 2 * p) = acc[b];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) bilstm_grid(
    const float* __restrict__ xp_f,        // [B, T, 4H] forward input projections, bias added
    const float* __restrict__ xp_b,        // [B, T, 4H] backward
    const float* __restrict__ wh_f,        // [H, 4H]
    const float* __restrict__ wh_b,        // [H, 4H]
    const long long* __restrict__ lengths, // [B]
    float* __restrict__ out,               // [B, T, 2H]: forward | backward
    word* exchange,                        // [2 directions][2 parities][B][H], zeroed
    Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int B = d.B, T = d.T, H = d.H, H4 = 4 * H, ldx = (int)pad4(H);
  const int per_dir = d.groups * d.slices;
  const int dir = blockIdx.x / per_dir, grp = blockIdx.x % per_dir / d.slices, slice = blockIdx.x % d.slices;
  const int j0 = slice * kUnits, row0 = grp * d.group_rows, nr = min(d.group_rows, B - row0);
  const int tid = threadIdx.x;
  const float* xp = dir ? xp_b : xp_f;
  const float* wh = dir ? wh_b : wh_f;
  word* xch = exchange + (size_t)dir * 2 * B * H;

  // shared memory: the gate columns [H][kCols], the staged rows, the
  // partial sums of each slice, the cell states and each row's first reset
  float* W = sm;                                         // [H][kCols], column c = gate * kUnits + unit
  float* xs = W + (size_t)H * kCols;                     // [kPass][ldx]
  float* red = xs + kPass * ldx;                         // [kParts][kPass][kCols]
  float* Cs = red + kParts * kPass * kCols;              // [group_rows][kUnits]
  int* first_reset = reinterpret_cast<int*>(Cs + pad4((size_t)d.group_rows * kUnits));  // [group_rows]

  for (int i = tid; i < H * kCols; i += kThreads) {
    const int k = i / kCols, c = i % kCols, j = j0 + c % kUnits;
    W[i] = j < H ? wh[(size_t)k * H4 + c / kUnits * H + j] : 0.f;
  }
  // the backward direction resets at t >= length - 1; the forward never
  for (int r = tid; r < nr; r += kThreads) {
    const long long last = lengths[row0 + r] - 1;
    first_reset[r] = !dir || last >= T ? T : last < 0 ? -1 : (int)last;
  }
  __syncthreads();

  // this thread's (row, unit) of a pass: its gate inputs and cell update
  const int r_own = tid / kUnits, u_own = tid % kUnits, j_own = j0 + u_own;
  for (int s = 0; s < T; ++s) {
    const int t = dir ? T - 1 - s : s;
    const word* prev = xch + (size_t)((s + 1) & 1) * B * H;  // step s - 1's h, tag s
    word* cur = xch + (size_t)(s & 1) * B * H;
    for (int p0 = 0; p0 < nr; p0 += kPass) {
      const int nb = min(kPass, nr - p0), b0 = row0 + p0;
      const bool mine = tid < nb * kUnits && j_own < H;
      float xg[4];
      const float* x_at = xp + ((size_t)(b0 + r_own) * T + t) * H4 + j_own;
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[g] = mine ? x_at[g * H] : 0.f;  // loads while h arrives
      // every row's h is waited for, reset or not, which keeps the group in step
      if (s > 0) {
        gather(xs, ldx, prev, H, b0, nb, s);
        if (nb == 1)
          matvec<1>(xs, ldx, W, H, red);
        else
          matvec<kPass>(xs, ldx, W, H, red);
      }
      if (mine) {
        // a zero state (the first step, or a reset) adds no product: gates = xp
        const bool zero = s == 0 || t >= first_reset[p0 + r_own];
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float* at = red + r_own * kCols + g * kUnits + u_own;
          float sum = 0.f;
          if (!zero) {
            sum = at[0];
#pragma unroll
            for (int q = 1; q < kParts; ++q) sum += at[q * kPass * kCols];
          }
          pre[g] = xg[g] + sum;
        }
        float* cs = Cs + (p0 + r_own) * kUnits + u_own;
        const float c_prev = zero ? 0.f : *cs;
        const float cn = sigmoid(pre[2] + 1.f) * c_prev + sigmoid(pre[0]) * tanhf(pre[1]);
        const float h = sigmoid(pre[3]) * tanhf(cn);
        *cs = cn;
        out[((size_t)(b0 + r_own) * T + t) * 2 * H + dir * H + j_own] = h;
        publish(cur + (size_t)(b0 + r_own) * H + j_own, h, s + 1);
      }
    }
  }
}

// The plan's shapes as the kernel takes them: slices of kUnits covering H,
// two directions of `groups` row groups, and the shared memory the plan claims.
bool valid_plan(int H, int G, int slices, int groups, int group_rows, int smem_bytes) {
  return H >= 1 && H <= kMaxH && slices == (H + kUnits - 1) / kUnits && groups >= 1 && group_rows >= 1 &&
         group_rows <= kRows && G == 2 * groups * slices &&
         (size_t)smem_bytes == sizeof(float) * smem_floats(H, group_rows);
}

}  // namespace

// Opt the kernel in to the largest dynamic shared memory of the current
// device and check that G CTAs of smem_bytes can be co-resident.  Call it
// once per device and plan, outside any stream capture, before
// viettts_bilstm launches that plan.
extern "C" int viettts_bilstm_prepare(int H, int G, int slices, int groups, int group_rows, int smem_bytes) {
  if (!valid_plan(H, G, slices, groups, group_rows, smem_bytes)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem_bytes > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute((const void*)bilstm_grid, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)bilstm_grid, kThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  // the CTAs of a group spin on each other's words: all must be resident; refuse, never shrink
  if (per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

// One cooperative launch of a prepared plan on `stream` for B rows (every
// row group non-empty); under stream capture it becomes a cooperative
// kernel node.  exchange holds 2 x 2 x B x H words, zeroed.
extern "C" int viettts_bilstm(const void* xp_f, const void* xp_b, const void* wh_f, const void* wh_b,
                              const void* lengths, void* out, void* exchange, int B, int T, int H, int G,
                              int slices, int groups, int group_rows, int smem_bytes, void* stream) {
  if (B < 1 || B > kRows || T < 1 || !valid_plan(H, G, slices, groups, group_rows, smem_bytes) ||
      groups * group_rows < B || (groups - 1) * group_rows >= B)
    return (int)cudaErrorInvalidValue;
  Dims d{B, T, H, slices, groups, group_rows};
  void* args[] = {&xp_f, &xp_b, &wh_f, &wh_b, &lengths, &out, &exchange, &d};
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
  const cudaError_t err = cudaLaunchKernelExC(&config, (const void*)bilstm_grid, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
