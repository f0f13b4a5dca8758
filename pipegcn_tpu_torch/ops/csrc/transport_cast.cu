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
// element. Both walk each part's slab as one flat run of vectors: 16
// bytes of x (4 f32 or 8 bf16) where the arguments allow it, narrower
// otherwise, one width a launch. K10 (was: a block per run of rows, a
// thread a column, one 4-byte load and one 1-byte store a row in flight):
// a block a chunk of kCastThreads x kCastAhead consecutive vectors (8 KB
// of x at 16-byte vectors), a thread kCastAhead of them, kCastThreads
// apart, both loaded before the first is converted; it stores each
// vector's payload as one word (VEC bytes of fp8, 2 VEC of bf16). A block
// a chunk ran 2-6 % faster than one wave of blocks striding over the
// chunks, 2 vectors a thread up to 1 % faster than 4 or 8 (PERF.md's K10
// design table). The vector's width comes from the
// wrapper (bucket_spmm.k10_vec): without deg the part's element count
// and both pointers are aligned to it; with deg it divides F, so a vector
// never straddles a row and loads one deg, and each element keeps its
// true division. Every element is computed as the plain version computes
// it, so any split that writes each element once is bit-exact.
// K11 reads only: its part's slab as one flat run of 16-byte vectors (4
// f32 or 8 bf16; 8, 4 or 2 bytes where the row bytes or the pointer allow
// no more), four vectors in flight a thread, one wave of blocks spread
// over the parts, a block-level max in shared memory and one atomicMax a
// block (was: a block per row run, 4,096 a part, and an atomicMax a warp
// on the part's one word). A vector never straddles a row (its width
// divides the row bytes), so the deg form loads one deg a vector and
// keeps the per-element true division.

#include "transport.cuh"

namespace {

constexpr int kThreads = 256;  // K11's

// K10's geometry: threads a block, vectors in flight a thread
constexpr int kCastThreads = 256;
constexpr int kCastAhead = 2;

// K10 over chunk blockIdx.x of part blockIdx.y's n_vec vectors of NB
// bytes of x (VEC = NB / XS elements; with DEG, per_row vectors a row of F
// elements and one deg a row)
template <int OUT, bool XB, int NB, bool DEG>
__global__ void __launch_bounds__(kCastThreads)
cast_kernel(const void* __restrict__ x, long long n_vec, int per_row,
            const float* __restrict__ deg, long long rows,
            const unsigned int* __restrict__ amax, float m,
            void* __restrict__ y, float* __restrict__ inv_scale) {
  constexpr int XS = XB ? 2 : 4, VEC = NB / XS;
  constexpr int YB = VEC * (OUT == kOutBF16 ? 2 : 1);  // payload bytes
  constexpr int XW = (NB + 3) / 4, YW = (YB + 3) / 4;
  constexpr long long kChunk = static_cast<long long>(kCastThreads) *
                               kCastAhead;
  const int part = blockIdx.y;
  const bool scaled = amax != nullptr;
  float s = 1.0f;
  if (scaled) {
    s = pow2_scale(amax[part], m);
    if (blockIdx.x == 0 && threadIdx.x == 0) inv_scale[part] = 1.0f / s;
  }
  const char* xp = static_cast<const char*>(x) + part * n_vec * NB;
  char* yp = static_cast<char*>(y) + part * n_vec * YB;
  const float* dp = DEG ? deg + part * rows : nullptr;
  // the row of a vector by a 32-bit division where it fits (a 64-bit
  // division is a long instruction sequence)
  const bool narrow = n_vec <= 0xffffffffLL;
  const long long c = blockIdx.x * kChunk + threadIdx.x;
  unsigned int w[kCastAhead][XW];
  float d[kCastAhead];
#pragma unroll
  for (int i = 0; i < kCastAhead; ++i) {
    const long long v = c + i * kCastThreads;
    if (v < n_vec) {
      load_words<NB>(xp + v * NB, w[i]);
      if constexpr (DEG)
        d[i] = __ldg(dp + (narrow ? static_cast<long long>(
                                        static_cast<unsigned>(v) /
                                        static_cast<unsigned>(per_row))
                                  : v / per_row));
    }
  }
#pragma unroll
  for (int i = 0; i < kCastAhead; ++i) {
    const long long v = c + i * kCastThreads;
    if (v >= n_vec) break;
    unsigned int q[YW];
#pragma unroll
    for (int k = 0; k < YW; ++k) q[k] = 0u;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      // element k widened to f32 (bf16: its bits in the word's half)
      float e = XB ? __uint_as_float(((w[i][k / 2] >> (16 * (k & 1))) &
                                      0xffffu) << 16)
                   : __uint_as_float(w[i][k]);
      if constexpr (DEG) e = e / d[i];
      if (scaled) e = e * s;
      if constexpr (OUT == kOutBF16)
        q[k / 2] |= static_cast<unsigned int>(to_bf16(e)) << (16 * (k & 1));
      else
        q[k / 4] |= static_cast<unsigned int>(to_fp8<OUT>(e))
                    << (8 * (k & 3));
    }
    store_words<YB>(yp + v * YB, q);
  }
}

template <int OUT, bool XB, int NB, bool DEG>
int cast_launch(int P, const void* x, long long n_vec, int per_row,
                const float* deg, long long rows, const unsigned int* amax,
                float m, void* y, float* inv_scale, cudaStream_t st) {
  // a block a chunk (one block for an empty part: inv_scale is written)
  const long long chunk = static_cast<long long>(kCastThreads) * kCastAhead;
  const dim3 grid(static_cast<unsigned>(n_vec > 0 ? (n_vec + chunk - 1) /
                                                        chunk
                                                  : 1),
                  P);
  cast_kernel<OUT, XB, NB, DEG><<<grid, kCastThreads, 0, st>>>(
      x, n_vec, per_row, deg, rows, amax, m, y, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

// K10's instance for a vector of nb bytes of x
template <int OUT, bool XB, bool DEG>
int cast_vec(int nb, int P, const void* x, long long n_vec, int per_row,
             const float* deg, long long rows, const unsigned int* amax,
             float m, void* y, float* inv_scale, cudaStream_t st) {
#define PGT_CAST(NB)                                                        \
  return cast_launch<OUT, XB, NB, DEG>(P, x, n_vec, per_row, deg, rows,     \
                                       amax, m, y, inv_scale, st)
  switch (nb) {
    case 16: PGT_CAST(16);
    case 8: PGT_CAST(8);
    case 4: PGT_CAST(4);
    case 2:
      if constexpr (XB) PGT_CAST(2);
      break;
  }
#undef PGT_CAST
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int OUT>
int cast_out(int x_bf16, bool with_deg, int nb, int P, const void* x,
             long long n_vec, int per_row, const float* deg, long long rows,
             const unsigned int* amax, float m, void* y, float* inv_scale,
             cudaStream_t st) {
#define PGT_CAST(XB, DEG)                                                   \
  return cast_vec<OUT, XB, DEG>(nb, P, x, n_vec, per_row, deg, rows, amax, \
                                m, y, inv_scale, st)
  if (x_bf16) {
    if (with_deg) PGT_CAST(true, true);
    PGT_CAST(true, false);
  }
  if (with_deg) PGT_CAST(false, true);
  PGT_CAST(false, false);
#undef PGT_CAST
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

}  // namespace

// K10. x [P, rows, F] f32 (bf16 bits when x_bf16); deg [P, rows] f32 or
// null; amax [P] uint32 (f32 bits, from K11) or null; out_type 0 bf16,
// 1 e4m3fn, 2 e5m2; m the fp8 finite max (ignored for bf16); y [P, rows,
// F] of out_type; inv_scale [P] f32 (written when amax is given). All
// contiguous, on the device. vec the elements a vector (1, 2, 4, or 8 for
// bf16 x; at most 16 bytes of x), dividing F where deg is given and rows
// x F otherwise, x and y aligned to it. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a vector the arguments do not allow.
extern "C" int pgt_transport_cast(const void* x, int x_bf16, int P, int rows,
                                  int F, const void* deg, const void* amax,
                                  int out_type, float m, void* y,
                                  void* inv_scale, int vec, void* stream) {
  if (P == 0 || rows == 0 || F == 0) {
    if (amax == nullptr || P == 0) return 0;
  }
  const int xs = x_bf16 ? 2 : 4, ys = out_type == kOutBF16 ? 2 : 1;
  const long long run = deg != nullptr ? F : static_cast<long long>(rows) * F;
  auto al = [](const void* p, long long n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if ((amax != nullptr && inv_scale == nullptr) || vec < 1 ||
      (vec & (vec - 1)) != 0 || vec * xs > 16 || run % vec != 0 ||
      !al(x, vec * xs) || !al(y, vec * ys))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_vec = static_cast<long long>(rows) * F / vec;
  const int per_row = F / vec;  // used only with deg (vec divides F)
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dg = static_cast<const float*>(deg);
  const unsigned int* am = static_cast<const unsigned int*>(amax);
  float* sc = static_cast<float*>(inv_scale);
  const bool wd = deg != nullptr;
  const int nb = vec * xs;
  switch (out_type) {
    case kOutBF16:
      return cast_out<kOutBF16>(x_bf16, wd, nb, P, x, n_vec, per_row, dg,
                                rows, am, m, y, sc, st);
    case kOutE4M3:
      return cast_out<kOutE4M3>(x_bf16, wd, nb, P, x, n_vec, per_row, dg,
                                rows, am, m, y, sc, st);
    case kOutE5M2:
      return cast_out<kOutE5M2>(x_bf16, wd, nb, P, x, n_vec, per_row, dg,
                                rows, am, m, y, sc, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const float* dg = static_cast<const float*>(deg);
  unsigned int* am = static_cast<unsigned int*>(amax);
  // one wave spread over the parts
#define PGT_AMAX(VT, XB)                                                   \
  {                                                                        \
    const dim3 grid(one_wave(occupancy(amax_kernel<VT, XB>, kThreads), P,  \
                             (n_vec + kThreads - 1) / kThreads),           \
                    P);                                                    \
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
