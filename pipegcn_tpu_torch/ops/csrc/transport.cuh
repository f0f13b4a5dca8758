// The narrow transport's element conversions, shared by K10 / K11
// (transport_cast.cu) and K14 / K15 (halo_wire.cu): the row loads (f32,
// or bf16 bits widened exactly), the exact power-of-two amax scale and the
// casts, each bit-exact against its plain PyTorch version (a NaN equal to
// any NaN); the vector loads and stores as 32-bit words; the SM count.

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the narrow types, as the wrappers number them
enum OutType { kOutBF16 = 0, kOutE4M3 = 1, kOutE5M2 = 2 };

__device__ __forceinline__ float load(const void* x, size_t i, int x_bf16) {
  if (x_bf16)
    return __uint_as_float(
        static_cast<unsigned int>(
            static_cast<const unsigned short*>(x)[i]) << 16);
  return static_cast<const float*>(x)[i];
}

// the exact power-of-two transport scale of an amax (given as its f32
// bits): 2^k, k = floor(log2((m / 2) / amax)) in f32, clamped to [-126,
// 127], formed from its exponent bits; 1 where the amax is zero or not
// finite (a NaN input stays NaN, never a NaN scale)
__device__ __forceinline__ float pow2_scale(unsigned int amax_bits,
                                            float m) {
  const float a = __uint_as_float(amax_bits);
  if (!(isfinite(a) && a > 0.0f)) return 1.0f;
  float k = floorf(log2f((m * 0.5f) / a));
  k = fminf(fmaxf(k, -126.0f), 127.0f);
  return __int_as_float((static_cast<int>(k) + 127) << 23);
}

// f32 -> bf16 bits, round to nearest even (the formula torch's CPU cast
// uses; NaN -> 0x7fc0 with the sign)
__device__ __forceinline__ unsigned short to_bf16(float v) {
  const unsigned int u = __float_as_uint(v);
  if (isnan(v)) return static_cast<unsigned short>((u >> 16) | 0x7fc0u);
  return static_cast<unsigned short>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// f32 -> e4m3fn / e5m2, round to nearest even, saturating at the finite
// max (JAX's clip-then-cast; NaN stays NaN, +-inf saturates)
template <int OUT>
__device__ __forceinline__ unsigned char to_fp8(float v) {
  const unsigned int u = __float_as_uint(v);
  // f32 subnormals are far below both formats' least subnormal: they
  // round to a signed zero, whatever the converter does with them
  if ((u & 0x7f800000u) == 0u) return static_cast<unsigned char>(u >> 24) &
                                      0x80u;
  return static_cast<unsigned char>(__nv_cvt_float_to_fp8(
      v, __NV_SATFINITE, OUT == kOutE4M3 ? __NV_E4M3 : __NV_E5M2));
}

// e4m3fn / e5m2 -> f32, exactly (both formats are subsets of half)
template <int OUT>
__device__ __forceinline__ float from_fp8(unsigned char q) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(q),
      OUT == kOutE4M3 ? __NV_E4M3 : __NV_E5M2);
  return __half2float(__half(h));
}

// NB bytes (1, 2, 4, 8 or 16) at p, as 32-bit words (the low bytes first)
template <int NB>
__device__ __forceinline__ void load_words(const void* p, unsigned int* w) {
  if constexpr (NB == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (NB == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (NB == 4) {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  } else if constexpr (NB == 2) {
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(static_cast<const unsigned char*>(p));
  }
}

template <int NB>
__device__ __forceinline__ void store_words(void* p, const unsigned int* w) {
  if constexpr (NB == 16) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (NB == 8) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (NB == 4) {
    *static_cast<unsigned int*>(p) = w[0];
  } else if constexpr (NB == 2) {
    *static_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
  } else {
    *static_cast<unsigned char*>(p) = static_cast<unsigned char>(w[0]);
  }
}

// the card's multiprocessors, read once (132 if the query fails)
inline int sm_count() {
  static const int sms = [] {
    int n = 0;
    return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, 0) ==
                       cudaSuccess && n > 0
               ? n
               : 132;
  }();
  return sms;
}

// blocks of `threads` threads of `kernel` one multiprocessor holds at
// once (a launch template keeps it in a static: read once an instance)
template <typename K>
int occupancy(K kernel, int threads) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  return per_sm;
}

// blocks a part (or slot) for a launch of one wave: as many blocks as the
// multiprocessors hold at once (`per_sm` each), spread over `parts`, never
// more than the `need` that cover a part, at least one (a second, partial
// wave would leave most of the card idle at its end)
inline unsigned one_wave(int per_sm, int parts, long long need) {
  long long n = (static_cast<long long>(per_sm) * sm_count() + parts - 1) /
                parts;
  if (n > need) n = need;
  return static_cast<unsigned>(n > 0 ? n : 1);
}

}  // namespace
