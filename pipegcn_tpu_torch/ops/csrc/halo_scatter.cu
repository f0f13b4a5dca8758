// K4: boundary-gradient scatter onto the send rows, hand-written for Hopper
// (sm_90a).
//
// Replaces: pipegcn_tpu/parallel/halo.py  make_stale_concat (its backward)
// and the take -> where transpose of halo_exchange: the halo cotangents
// that came back to their owner (K5, or last epoch's stale bgrad) are
// added onto the inner rows they were gathered from,
//
//   d_h[r, i] = g[r, i] + sum_{slots k of row i} bgrad[r, k],   i < n_max,
//
// where slot k = (d-1)*B + b of part r lists row send_idx[r, d-1, b] with
// send_mask on. send_idx is unique within a distance but repeats a row
// across distances when P > 2, so one row can take several slots.
//
// The host inverts the send lists into a CSR (send_ptr [P, n_max + 1],
// send_slot [P, nnz], slots ascending within a row; pad slots, mask off,
// never enter it). So instead of atomics, one warp owns each inner row:
// it loads g's row, adds the row's slots in ascending order, and writes
// the row once. No atomics and a fixed order: deterministic, and at P = 2
// (at most one slot per row) bit-exact against the plain version.
//
// In bf16 (bf16 compute: g, bgrad and d_h bf16), every add is done in f32
// and rounded to bf16 (round to nearest even) before the next, in slot
// order: JAX's bf16 g.at[idx].add(inj) rounds after every update, so at
// P = 2 (one add a row) the result is bit-exact against it, and at P > 2
// it is the same sequence of roundings in the host-built slot order.
//
// What bounds it on the H100: bytes. Each inner row of g is read once and
// written once, each used bgrad row read once; the adds are a few per
// element. Lanes spread over the columns with 16-byte loads (4 f32 or 8
// bf16) where the width and the pointers allow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// VEC consecutive elements of type T as floats, and back (bf16 rounded to
// nearest even)
template <typename T, int VEC>
struct Vec;
template <int VEC>
struct Vec<float, VEC> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    if constexpr (VEC == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    } else if constexpr (VEC == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p));
      o[0] = v.x; o[1] = v.y;
    } else {
      o[0] = __ldg(p);
    }
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      p[0] = v[0];
    }
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <int VEC>
struct Vec<__nv_bfloat16, VEC> {
  // VEC = 8 (16 bytes), 2 (4 bytes) or 1
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    if constexpr (VEC == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = __uint_as_float(w[i] << 16);
        o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else if constexpr (VEC == 2) {
      const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
      o[0] = __uint_as_float(w << 16);
      o[1] = __uint_as_float(w & 0xffff0000u);
    } else {
      o[0] = __bfloat162float(p[0]);
    }
  }
  static __device__ __forceinline__ unsigned bits(float x) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    if constexpr (VEC == 8) {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = bits(v[2 * i]) | bits(v[2 * i + 1]) << 16;
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<unsigned*>(p) = bits(v[0]) | bits(v[1]) << 16;
    } else {
      p[0] = __float2bfloat16_rn(v[0]);
    }
  }
  // the f32 sum rounded to bf16 and widened back (exact)
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
halo_scatter_kernel(const T* __restrict__ g, long long g_part_stride,
                    const T* __restrict__ bgrad,
                    long long bgrad_part_stride,
                    const int* __restrict__ send_ptr,
                    const int* __restrict__ send_slot,
                    long long slot_part_stride, T* __restrict__ out,
                    int n_max, int H, int F) {
  using V = Vec<T, VEC>;
  const int part = blockIdx.y;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_max) return;

  const int* ptr = send_ptr + static_cast<size_t>(part) * (n_max + 1);
  const int beg = ptr[row], end = ptr[row + 1];
  const int* slot = send_slot + part * slot_part_stride;
  const T* grow = g + part * g_part_stride + static_cast<size_t>(row) * F;
  const T* bg = bgrad + part * bgrad_part_stride;
  T* orow = out + (static_cast<size_t>(part) * n_max + row) * F;

  for (int c = lane * VEC; c < F; c += 32 * VEC) {
    float acc[VEC];
    V::load(grow + c, acc);
    for (int k = beg; k < end; ++k) {
      const int s = min(max(__ldg(slot + k), 0), H - 1);
      float y[VEC];
      V::load(bg + static_cast<size_t>(s) * F + c, y);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = V::round(acc[j] + y[j]);
    }
    V::store(orow + c, acc);
  }
}

template <typename T, int VEC>
int launch(const void* g, long long g_part_stride, const void* bgrad,
           long long bgrad_part_stride, const int* send_ptr,
           const int* send_slot, long long slot_part_stride, void* out,
           int P, int n_max, int H, int F, cudaStream_t stream) {
  const dim3 grid((n_max + kWarpsPerBlock - 1) / kWarpsPerBlock, P);
  halo_scatter_kernel<T, VEC><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(g), g_part_stride, static_cast<const T*>(bgrad),
      bgrad_part_stride, send_ptr, send_slot, slot_part_stride,
      static_cast<T*>(out), n_max, H, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: P parts of n_max rows of F elements (part stride g_part_stride
// elements, rows contiguous); bgrad: P parts of H rows of F (part stride
// bgrad_part_stride elements); send_ptr [P, n_max + 1] int32; send_slot
// [P, *] int32 with part stride slot_part_stride; out [P, n_max, F]
// contiguous. g, bgrad and out f32, or bf16 when bf16 != 0. Strides in
// elements. Returns cudaGetLastError().
extern "C" int pgt_halo_scatter(const void* g, long long g_part_stride,
                                const void* bgrad,
                                long long bgrad_part_stride,
                                const void* send_ptr, const void* send_slot,
                                long long slot_part_stride, void* out,
                                int bf16, int P, int n_max, int H, int F,
                                void* stream) {
  if (P == 0 || n_max == 0 || F == 0) return 0;
  const int* pp = static_cast<const int*>(send_ptr);
  const int* sp = static_cast<const int*>(send_slot);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(g) |
                      reinterpret_cast<uintptr_t>(bgrad) |
                      reinterpret_cast<uintptr_t>(out);
  const long long strides = g_part_stride | bgrad_part_stride;
#define PGT_LAUNCH(T, VEC)                                                \
  return launch<T, VEC>(g, g_part_stride, bgrad, bgrad_part_stride, pp,   \
                        sp, slot_part_stride, out, P, n_max, H, F, st)
  if (bf16) {
    if (F % 8 == 0 && strides % 8 == 0 && a % 16 == 0)
      PGT_LAUNCH(__nv_bfloat16, 8);
    if (F % 2 == 0 && strides % 2 == 0 && a % 4 == 0)
      PGT_LAUNCH(__nv_bfloat16, 2);
    PGT_LAUNCH(__nv_bfloat16, 1);
  }
  if (F % 4 == 0 && strides % 4 == 0 && a % 16 == 0) PGT_LAUNCH(float, 4);
  if (F % 2 == 0 && strides % 2 == 0 && a % 8 == 0) PGT_LAUNCH(float, 2);
  PGT_LAUNCH(float, 1);
#undef PGT_LAUNCH
}
