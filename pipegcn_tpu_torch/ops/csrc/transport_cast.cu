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
// their bits, NaN above +inf, so a NaN propagates as jnp.max's does),
// reduced per warp with __reduce_max_sync and merged with atomicMax on the
// part's word: deterministic. The wrapper zeroes amax first.
//
// What bounds both on the H100: bytes. Each element is read once (4 B)
// and written once (1 B fp8, 2 B bf16); the arithmetic is a few ops per
// element. Design: a block per run of rows (grid-strided), threads over
// the columns of a row, so loads and stores are coalesced and the row's
// deg is one broadcast load; no integer division per element.

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

__global__ void __launch_bounds__(kThreads)
amax_kernel(const void* __restrict__ x, int x_bf16, int rows, int F,
            const float* __restrict__ deg, unsigned int* __restrict__ amax) {
  const int part = blockIdx.y;
  const size_t base = static_cast<size_t>(part) * rows * F;
  unsigned int best = 0u;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const float d =
        deg != nullptr ? deg[static_cast<size_t>(part) * rows + r] : 1.0f;
    const size_t row0 = base + static_cast<size_t>(r) * F;
    for (int c = threadIdx.x; c < F; c += blockDim.x) {
      float v = load(x, row0 + c, x_bf16);
      if (deg != nullptr) v = v / d;
      best = max(best, __float_as_uint(v) & 0x7fffffffu);
    }
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0 && best != 0u) atomicMax(amax + part, best);
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
// null; amax [P] uint32, zeroed by the caller, receives the bits of
// max |x / deg| per part. All contiguous, on the device. Returns
// cudaGetLastError().
extern "C" int pgt_part_amax(const void* x, int x_bf16, int P, int rows,
                             int F, const void* deg, void* amax,
                             void* stream) {
  if (P == 0 || rows == 0 || F == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(rows), P);
  amax_kernel<<<grid, kThreads, 0, st>>>(
      x, x_bf16, rows, F, static_cast<const float*>(deg),
      static_cast<unsigned int*>(amax));
  return static_cast<int>(cudaGetLastError());
}
