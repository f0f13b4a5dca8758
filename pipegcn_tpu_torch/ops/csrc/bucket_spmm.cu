// K9: degree-bucketed ELL gather-sum (mean aggregation over bucket
// tables), hand-written for Hopper (sm_90a).
//
// K9 replaces: pipegcn_tpu/ops/bucket_spmm.py  bucket_aggregate (inside
// make_bucket_spmm_fn / make_device_bucket_spmm_fn, forward and backward):
// per bucket b, gather fbuf_pad[idx_b] as [n_b, w_b, F], sum over w_b in
// f32, concatenate the buckets and a zero row, and restore the output
// order by one gather through inv_perm; the caller divides by in_deg and
// multiplies by the transport's inverse scale. On one card the P parts
// are stacked, and every bucket of every part is one launch:
//
//   j = clip(inv[p, i], 0, total_rows)        (total_rows: zero sentinel)
//   out[p, i, :] = (sum_{k < w_b} x[p, idx_b[p, j - row0_b, k], :])
//                  / in_deg[p, i] * inv_scale[p]
//
// where b is the bucket holding table row j. Index n_src (and anything
// above it) is the zero-row sentinel and adds nothing; a negative index
// reads row 0 (jnp.take(mode="clip") on the sentinel-padded buffer). The
// division is skipped when in_deg is null (the backward divides before
// the transport cast), the multiply when inv_scale is null.
//
// The tables arrive flattened: idx [P, sum_b cap_b * w_b] int32, the
// buckets' [cap_b, w_b] tables row-major one after the other, and meta
// [3, nb + 1] int64 = (row offsets, element offsets, widths) per bucket,
// shared by the parts (the stacked tables share caps and widths).
//
// x is f32, bf16, fp8 e4m3fn or fp8 e5m2 (the narrowed gather transport);
// fp8 and bf16 are widened exactly to f32 (fp8 -> half -> float by
// __nv_cvt_fp8x2_to_halfraw2: both fp8 formats are subsets of half), and
// the sum, the division and the output are f32.
//
// What bounds it on the H100: the gather. Every table entry reads one
// source row (F bytes at fp8, 4F at f32): at the training shape (~20.7M
// edges a part, F = 256) that is ~5.3 GB of row reads a launch at fp8,
// from L2/HBM, while the least traffic (each input once) is a few hundred
// MB and the adds E*F f32 ops (~0.16 ms at the card's 67 TFLOP/s). A
// random-row-gather kernel: its time is set by the row loads in flight.
//
// Design: K1's, over bucket rows instead of CSR rows. One warp per output
// row (and per 32*VEC*NV-column tile): it reads inv once, finds the
// bucket by a binary search over the row offsets (staged in shared
// memory: the ladder has < 128 rungs), loads the row's w_b indices 32 at
// a time with one coalesced load and broadcasts them with __shfl_sync,
// skipping sentinels; lanes spread over the columns with the widest
// vector the width and alignment allow (8 fp8 values = 8 bytes, the
// whole 256-byte fp8 row across the warp at F = 256). Each row's sum runs
// in table order in registers: no atomics, no shared-memory reduction,
// deterministic results. Cap-padding table rows are never visited (no
// inv entry points at them). A row sent to the sentinel writes zeros.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBuckets = 128;

enum XType { kF32 = 0, kBF16 = 1, kE4M3 = 2, kE5M2 = 3 };

__device__ __forceinline__ float bf16_lo(unsigned int u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int u) {
  return __uint_as_float(u & 0xffff0000u);
}

// two fp8 values (low byte first) -> two floats, exactly
template <int XT>
__device__ __forceinline__ void fp8x2(unsigned int pair, float* o) {
  constexpr __nv_fp8_interpretation_t kind = XT == kE4M3 ? __NV_E4M3
                                                         : __NV_E5M2;
  const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), kind);
  const float2 f = __half22float2(__half2(r));
  o[0] = f.x;
  o[1] = f.y;
}

// load VEC consecutive elements of type XT starting at element c of row p
template <int XT, int VEC>
__device__ __forceinline__ void load_vec(const void* row, int c, float* o) {
  if constexpr (XT == kF32) {
    const float* p = static_cast<const float*>(row) + c;
    if constexpr (VEC == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    } else if constexpr (VEC == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p));
      o[0] = v.x; o[1] = v.y;
    } else {
      o[0] = __ldg(p);
    }
  } else if constexpr (XT == kBF16) {
    const unsigned short* p = static_cast<const unsigned short*>(row) + c;
    if constexpr (VEC == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      o[0] = bf16_lo(v.x); o[1] = bf16_hi(v.x);
      o[2] = bf16_lo(v.y); o[3] = bf16_hi(v.y);
      o[4] = bf16_lo(v.z); o[5] = bf16_hi(v.z);
      o[6] = bf16_lo(v.w); o[7] = bf16_hi(v.w);
    } else if constexpr (VEC == 2) {
      const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
      o[0] = bf16_lo(u); o[1] = bf16_hi(u);
    } else {
      o[0] = __uint_as_float(static_cast<unsigned int>(__ldg(p)) << 16);
    }
  } else {
    const unsigned char* p = static_cast<const unsigned char*>(row) + c;
    if constexpr (VEC == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      fp8x2<XT>(v.x, o); fp8x2<XT>(v.x >> 16, o + 2);
      fp8x2<XT>(v.y, o + 4); fp8x2<XT>(v.y >> 16, o + 6);
    } else if constexpr (VEC == 4) {
      const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
      fp8x2<XT>(u, o); fp8x2<XT>(u >> 16, o + 2);
    } else if constexpr (VEC == 2) {
      const unsigned int u =
          __ldg(reinterpret_cast<const unsigned short*>(p));
      fp8x2<XT>(u, o);
    } else {
      float t[2];
      fp8x2<XT>(static_cast<unsigned int>(__ldg(p)), t);
      o[0] = t[0];
    }
  }
}

// out row chunks of VEC floats; F % VEC == 0 and a 16-byte aligned output
// base make chunk c (4*VEC)-byte aligned
template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int XT>
__host__ __device__ constexpr int elem_bytes() {
  return XT == kF32 ? 4 : XT == kBF16 ? 2 : 1;
}

template <int XT, int VEC, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bucket_kernel(const void* __restrict__ x, int n_src, int F,
              const int* __restrict__ idx, long long idx_part_stride,
              const long long* __restrict__ meta, int nb,
              const int* __restrict__ inv, int n_out,
              const float* __restrict__ deg,
              const float* __restrict__ inv_scale, float* __restrict__ out) {
  __shared__ long long s_row[kMaxBuckets + 1];
  __shared__ long long s_elem[kMaxBuckets + 1];
  __shared__ int s_w[kMaxBuckets + 1];
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) {
    s_row[i] = meta[i];
    s_elem[i] = meta[(nb + 1) + i];
    s_w[i] = static_cast<int>(meta[2 * (nb + 1) + i]);
  }
  __syncthreads();

  const int part = blockIdx.z;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_out) return;  // whole warp leaves together

  const char* xp = static_cast<const char*>(x) +
                   static_cast<size_t>(part) * n_src * F * elem_bytes<XT>();
  idx += static_cast<size_t>(part) * idx_part_stride;
  const size_t orow = static_cast<size_t>(part) * n_out + row;
  long long j = inv[orow];
  j = j < 0 ? 0 : j;

  const int col0 = blockIdx.y * (32 * VEC * NV);
  float acc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[v][k] = 0.0f;

  if (j < s_row[nb]) {
    // the bucket b with s_row[b] <= j < s_row[b + 1]
    int lo = 0, hi = nb - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_row[mid] <= j) lo = mid; else hi = mid - 1;
    }
    const int w = s_w[lo];
    const int* ip = idx + s_elem[lo] + (j - s_row[lo]) * w;
    for (int base = 0; base < w; base += 32) {
      const int n = min(32, w - base);
      const int mine = lane < n ? __ldg(ip + base + lane) : n_src;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        int s = __shfl_sync(0xffffffffu, mine, t);
        if (s >= n_src) continue;  // the zero sentinel (uniform branch)
        s = max(s, 0);
        const char* rowp =
            xp + static_cast<size_t>(s) * F * elem_bytes<XT>();
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c = col0 + (v * 32 + lane) * VEC;
          if (c < F) {
            float y[VEC];
            load_vec<XT, VEC>(rowp, c, y);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[v][k] += y[k];
          }
        }
      }
    }
  }

  const float d = deg != nullptr ? deg[orow] : 1.0f;
  const float sc = inv_scale != nullptr ? inv_scale[part] : 1.0f;
  float* op = out + orow * F;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = col0 + (v * 32 + lane) * VEC;
    if (c < F) {
      float y[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        y[k] = acc[v][k];
        if (deg != nullptr) y[k] = y[k] / d;
        if (inv_scale != nullptr) y[k] = y[k] * sc;
      }
      store<VEC>(op + c, y);
    }
  }
}

template <int XT, int VEC>
int launch(const void* x, int n_src, int F, const int* idx,
           long long idx_stride, const long long* meta, int nb,
           const int* inv, int n_out, const float* deg,
           const float* inv_scale, float* out, int P, cudaStream_t stream) {
  const int per = 32 * VEC;
  const int need = (F + per - 1) / per;
  const int nv = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  const int tile = per * nv;
  const dim3 grid((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (F + tile - 1) / tile, P);
  const dim3 block(kWarpsPerBlock * 32);
#define PGT_LAUNCH(NV_)                                                  \
  bucket_kernel<XT, VEC, NV_><<<grid, block, 0, stream>>>(               \
      x, n_src, F, idx, idx_stride, meta, nb, inv, n_out, deg, inv_scale, \
      out)
  switch (nv) {
    case 1: PGT_LAUNCH(1); break;
    case 2: PGT_LAUNCH(2); break;
    case 4: PGT_LAUNCH(4); break;
    default: PGT_LAUNCH(8); break;
  }
#undef PGT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int XT>
int dispatch(const void* x, int n_src, int F, const int* idx,
             long long idx_stride, const long long* meta, int nb,
             const int* inv, int n_out, const float* deg,
             const float* inv_scale, float* out, int P, cudaStream_t st) {
#define PGT_K9(VEC)                                                      \
  return launch<XT, VEC>(x, n_src, F, idx, idx_stride, meta, nb, inv,    \
                         n_out, deg, inv_scale, out, P, st)
  if constexpr (XT == kF32) {
    if (F % 4 == 0 && aligned(x, 16)) PGT_K9(4);
    if (F % 2 == 0 && aligned(x, 8)) PGT_K9(2);
    PGT_K9(1);
  } else if constexpr (XT == kBF16) {
    if (F % 8 == 0 && aligned(x, 16)) PGT_K9(8);
    if (F % 2 == 0 && aligned(x, 4)) PGT_K9(2);
    PGT_K9(1);
  } else {
    if (F % 8 == 0 && aligned(x, 8)) PGT_K9(8);
    if (F % 4 == 0 && aligned(x, 4)) PGT_K9(4);
    if (F % 2 == 0 && aligned(x, 2)) PGT_K9(2);
    PGT_K9(1);
  }
#undef PGT_K9
}

}  // namespace

// x [P, n_src, F] of type x_type (0 f32, 1 bf16, 2 e4m3fn, 3 e5m2); idx
// [P, *] int32 with part stride idx_stride; meta [3, nb + 1] int64 (row
// offsets, element offsets, widths); inv [P, n_out] int32; deg [P, n_out]
// f32 or null; inv_scale [P] f32 or null; out [P, n_out, F] f32 (16-byte
// aligned). All contiguous, on the device. Returns cudaGetLastError().
extern "C" int pgt_bucket_spmm(const void* x, int x_type, int P, int n_src,
                               int F, const void* idx, long long idx_stride,
                               const void* meta, int nb, const void* inv,
                               int n_out, const void* deg,
                               const void* inv_scale, void* out,
                               void* stream) {
  if (P == 0 || n_out == 0 || F == 0) return 0;
  if (n_src <= 0 || nb < 0 || nb > kMaxBuckets || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const long long* mt = static_cast<const long long*>(meta);
  const int* iv = static_cast<const int*>(inv);
  const float* dg = static_cast<const float*>(deg);
  const float* sc = static_cast<const float*>(inv_scale);
  float* o = static_cast<float*>(out);
  switch (x_type) {
    case kF32:
      return dispatch<kF32>(x, n_src, F, ix, idx_stride, mt, nb, iv, n_out,
                            dg, sc, o, P, st);
    case kBF16:
      return dispatch<kBF16>(x, n_src, F, ix, idx_stride, mt, nb, iv, n_out,
                             dg, sc, o, P, st);
    case kE4M3:
      return dispatch<kE4M3>(x, n_src, F, ix, idx_stride, mt, nb, iv, n_out,
                             dg, sc, o, P, st);
    case kE5M2:
      return dispatch<kE5M2>(x, n_src, F, ix, idx_stride, mt, nb, iv, n_out,
                             dg, sc, o, P, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
