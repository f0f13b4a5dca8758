// K10 / K11: the narrowed gather transport's saturating cast and its
// per-part amax, hand-written for Hopper (sm_90a).
//
// K10 replaces: pipegcn_tpu/ops/bucket_spmm.py  transport_cast and
// amax_transport_cast (the cast half; K11 is the amax half). For the P
// stacked parts of x [P, rows, F] (f32, or bf16 bits):
//
//   v = x[p, r, c]                  (widened to f32)
//   v = v / deg[p, r]               (when deg is given: the backward's
//                                    g / in_deg, a true division)
//   v = v * s[p]                    (when amax is given)
//   y[p, r, c] = cast(v)            e4m3fn / e5m2: round to nearest even,
//                                   saturating at +-448 / +-57344 (equal
//                                   to clip-then-cast; NaN stays NaN,
//                                   +-inf saturates); bf16: round to
//                                   nearest even, no clamp
//
// with s[p] = 2^k, k = floor(log2((m / 2) / amax[p])) in f32, clamped to
// [-126, 127], formed exactly from its exponent bits; s = 1 where amax is
// zero or not finite (a NaN input stays NaN). inv_scale[p] = 1 / s[p].
// The JAX reference forms s with exp2, which XLA-CPU rounds off a power
// of two at most integer arguments; the port's s is the exact power the
// reference's comment promises ("exact to re-divide").
//
// K11 replaces the amax half of amax_transport_cast, per part (the JAX
// step runs it inside vmap / shard_map over the parts): amax[p] =
// max |v| over the part's slab, v as above without the scale. Max is
// order-free, so the result does not depend on the reduction order: the
// bits of |v| are compared as unsigned ints (non-negative floats order as
// their bits, NaN above +inf, so a NaN propagates as jnp.max's does).
// The entry point zeroes amax first (cudaMemsetAsync).
//
// What bounds both on the H100: bytes. Each element is read once (4 B)
// and written once (1 B fp8, 2 B bf16); the arithmetic is a few ops per
// element. K10: a block per run of rows (grid-strided), threads over the
// columns of a row, so loads and stores are coalesced and the row's deg is
// one broadcast load; no integer division per element. K11 reads only:
// its part's slab as one flat run of 16-byte vectors (4 f32 or 8 bf16;
// 8, 4 or 2 bytes where the row bytes or the pointer allow no more), four
// vectors in flight a thread, one wave of blocks (as many as the
// multiprocessors hold at once) spread over the parts, a block-level max in shared memory and one
// atomicMax a block (was: a block per row run, 4,096 a part, and an
// atomicMax a warp on the part's one word). A vector never straddles a
// row (its width divides the row bytes), so the deg form loads one deg a
// vector and keeps the per-element true division.

#include "transport.cuh"

namespace {

constexpr int kThreads = 256;

template <int OUT>
__global__ void __launch_bounds__(kThreads)
cast_kernel(const void* __restrict__ x, int x_bf16, int rows, int F,
            const float* __restrict__ deg,
            const unsigned int* __restrict__ amax, float m,
            void* __restrict__ y, float* __restrict__ inv_scale) {
  const int part = blockIdx.y;
  float s = 1.0f;
  if (amax != nullptr) {
    s = pow2_scale(amax[part], m);
    if (blockIdx.x == 0 && threadIdx.x == 0) inv_scale[part] = 1.0f / s;
  }
  const size_t base = static_cast<size_t>(part) * rows * F;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const float d =
        deg != nullptr ? deg[static_cast<size_t>(part) * rows + r] : 1.0f;
    const size_t row0 = base + static_cast<size_t>(r) * F;
    for (int c = threadIdx.x; c < F; c += blockDim.x) {
      float v = load(x, row0 + c, x_bf16);
      if (deg != nullptr) v = v / d;
      if (amax != nullptr) v = v * s;
      if constexpr (OUT == kOutBF16)
        static_cast<unsigned short*>(y)[row0 + c] = to_bf16(v);
      else
        static_cast<unsigned char*>(y)[row0 + c] = to_fp8<OUT>(v);
    }
  }
}

// K11: a thread's max |v| bits over the vectors v0, v0 + stride, ... of
// one part's slab (VT the vector type; its elements f32, or bf16 bits
// widened exactly when XB; deg: one divisor a row of F elements)
template <typename VT, bool XB>
__device__ __forceinline__ unsigned vec_max(VT w, const float* deg, long long
                                            v, int per_row, unsigned best) {
  constexpr int kWords = sizeof(VT) >= 4 ? sizeof(VT) / 4 : 1;
  unsigned u[kWords];
  if constexpr (sizeof(VT) == 16) {
    u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
  } else if constexpr (sizeof(VT) == 8) {
    u[0] = w.x; u[1] = w.y;
  } else {
    u[0] = static_cast<unsigned>(w);
  }
  const float d = deg != nullptr ? __ldg(deg + v / per_row) : 1.0f;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (XB) {
      // two bf16 a word (one when the vector is a lone 2-byte value)
      const float lo = __uint_as_float(u[i] << 16);
      best = max(best, __float_as_uint(deg != nullptr ? lo / d : lo) &
                           0x7fffffffu);
      if constexpr (sizeof(VT) >= 4) {
        const float hi = __uint_as_float(u[i] & 0xffff0000u);
        best = max(best, __float_as_uint(deg != nullptr ? hi / d : hi) &
                             0x7fffffffu);
      }
    } else {
      const float x = __uint_as_float(u[i]);
      best = max(best,
                 __float_as_uint(deg != nullptr ? x / d : x) & 0x7fffffffu);
    }
  }
  return best;
}

constexpr int kAhead = 4;  // K11's vectors in flight a thread

template <typename VT, bool XB>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const void* __restrict__ x, long long n_vec, int per_row,
            const float* __restrict__ deg, long long rows,
            unsigned int* __restrict__ amax) {
  const int part = blockIdx.y;
  const VT* xp = static_cast<const VT*>(x) + part * n_vec;
  const float* dp = deg != nullptr ? deg + part * rows : nullptr;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned best = 0u;
  for (; v + (kAhead - 1) * stride < n_vec; v += kAhead * stride) {
    VT w[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) w[i] = __ldg(xp + v + i * stride);
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      best = vec_max<VT, XB>(w[i], dp, v + i * stride, per_row, best);
  }
  for (; v < n_vec; v += stride)
    best = vec_max<VT, XB>(__ldg(xp + v), dp, v, per_row, best);
  __shared__ unsigned warp_max[kThreads / 32];
  best = __reduce_max_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) best = max(best, warp_max[i]);
    if (best != 0u) atomicMax(amax + part, best);
  }
}

int blocks_for(int rows) {
  return rows < 4096 ? (rows > 0 ? rows : 1) : 4096;
}

}  // namespace

// K10. x [P, rows, F] f32 (bf16 bits when x_bf16); deg [P, rows] f32 or
// null; amax [P] uint32 (f32 bits, from K11) or null; out_type 0 bf16,
// 1 e4m3fn, 2 e5m2; m the fp8 finite max (ignored for bf16); y [P, rows,
// F] of out_type; inv_scale [P] f32 (written when amax is given). All
// contiguous, on the device. Returns cudaGetLastError().
extern "C" int pgt_transport_cast(const void* x, int x_bf16, int P, int rows,
                                  int F, const void* deg, const void* amax,
                                  int out_type, float m, void* y,
                                  void* inv_scale, void* stream) {
  if (P == 0 || rows == 0 || F == 0) {
    if (amax == nullptr || P == 0) return 0;
  }
  if (amax != nullptr && inv_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(rows), P);
  const float* dg = static_cast<const float*>(deg);
  const unsigned int* am = static_cast<const unsigned int*>(amax);
  float* sc = static_cast<float*>(inv_scale);
  switch (out_type) {
    case kOutBF16:
      cast_kernel<kOutBF16><<<grid, kThreads, 0, st>>>(x, x_bf16, rows, F,
                                                       dg, am, m, y, sc);
      break;
    case kOutE4M3:
      cast_kernel<kOutE4M3><<<grid, kThreads, 0, st>>>(x, x_bf16, rows, F,
                                                       dg, am, m, y, sc);
      break;
    case kOutE5M2:
      cast_kernel<kOutE5M2><<<grid, kThreads, 0, st>>>(x, x_bf16, rows, F,
                                                       dg, am, m, y, sc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K11. x [P, rows, F] f32 (bf16 bits when x_bf16); deg [P, rows] f32 or
// null; amax [P] uint32 receives the bits of max |x / deg| per part (0
// for an empty part). All contiguous, on the device. Returns the first
// CUDA error (the memset's, the launch's).
extern "C" int pgt_part_amax(const void* x, int x_bf16, int P, int rows,
                             int F, const void* deg, void* amax,
                             void* stream) {
  if (P == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t z =
      cudaMemsetAsync(amax, 0, static_cast<size_t>(P) * sizeof(unsigned), st);
  if (z != cudaSuccess || rows == 0 || F == 0) return static_cast<int>(z);
  // the widest vector dividing the row bytes and the pointer's alignment
  const long long row_b = static_cast<long long>(F) * (x_bf16 ? 2 : 4);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  int vb = 16;
  while (vb > (x_bf16 ? 2 : 4) && (row_b % vb != 0 || addr % vb != 0))
    vb /= 2;
  const long long n_vec = row_b / vb * rows;  // a part's vectors
  const int per_row = static_cast<int>(row_b / vb);
  static int sms = 0;
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) !=
          cudaSuccess)
    sms = 132;
  const float* dg = static_cast<const float*>(deg);
  unsigned int* am = static_cast<unsigned int*>(amax);
  // one wave: as many blocks as the multiprocessors hold at once, spread
  // over the parts (a second, partial wave would leave most of the card
  // idle at its end), never more than a part's vectors need
#define PGT_AMAX(VT, XB)                                                   \
  {                                                                        \
    int per_sm = 0;                                                        \
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
            &per_sm, amax_kernel<VT, XB>, kThreads, 0) != cudaSuccess ||   \
        per_sm < 1)                                                        \
      per_sm = 1;                                                          \
    long long per_part = (static_cast<long long>(per_sm) * sms + P - 1) / P; \
    const long long need = (n_vec + kThreads - 1) / kThreads;              \
    if (per_part > need) per_part = need;                                  \
    const dim3 grid(static_cast<unsigned>(per_part), P);                   \
    amax_kernel<VT, XB><<<grid, kThreads, 0, st>>>(x, n_vec, per_row, dg,  \
                                                   rows, am);              \
  }
  if (x_bf16) {
    switch (vb) {
      case 16: PGT_AMAX(uint4, true); break;
      case 8: PGT_AMAX(uint2, true); break;
      case 4: PGT_AMAX(unsigned, true); break;
      default: PGT_AMAX(unsigned short, true); break;
    }
  } else {
    switch (vb) {
      case 16: PGT_AMAX(uint4, false); break;
      case 8: PGT_AMAX(uint2, false); break;
      default: PGT_AMAX(unsigned, false); break;
    }
  }
#undef PGT_AMAX
  return static_cast<int>(cudaGetLastError());
}
