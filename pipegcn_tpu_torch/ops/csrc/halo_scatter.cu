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
// What bounds it on the H100: bytes. Each inner row of g is read once and
// written once, each used bgrad row read once; the adds are a few per
// element. Lanes spread over the columns with 16-byte loads where the
// width and the pointers allow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x; o[1] = v.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    o[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
halo_scatter_kernel(const float* __restrict__ g, long long g_part_stride,
                    const float* __restrict__ bgrad,
                    long long bgrad_part_stride,
                    const int* __restrict__ send_ptr,
                    const int* __restrict__ send_slot,
                    long long slot_part_stride, float* __restrict__ out,
                    int n_max, int H, int F) {
  const int part = blockIdx.y;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_max) return;

  const int* ptr = send_ptr + static_cast<size_t>(part) * (n_max + 1);
  const int beg = ptr[row], end = ptr[row + 1];
  const int* slot = send_slot + part * slot_part_stride;
  const float* grow = g + part * g_part_stride + static_cast<size_t>(row) * F;
  const float* bg = bgrad + part * bgrad_part_stride;
  float* orow = out + (static_cast<size_t>(part) * n_max + row) * F;

  for (int c = lane * VEC; c < F; c += 32 * VEC) {
    float acc[VEC];
    Vec<VEC>::load(grow + c, acc);
    for (int k = beg; k < end; ++k) {
      const int s = min(max(__ldg(slot + k), 0), H - 1);
      float y[VEC];
      Vec<VEC>::load(bg + static_cast<size_t>(s) * F + c, y);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += y[j];
    }
    Vec<VEC>::store(orow + c, acc);
  }
}

template <int VEC>
int launch(const float* g, long long g_part_stride, const float* bgrad,
           long long bgrad_part_stride, const int* send_ptr,
           const int* send_slot, long long slot_part_stride, float* out,
           int P, int n_max, int H, int F, cudaStream_t stream) {
  const dim3 grid((n_max + kWarpsPerBlock - 1) / kWarpsPerBlock, P);
  halo_scatter_kernel<VEC><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      g, g_part_stride, bgrad, bgrad_part_stride, send_ptr, send_slot,
      slot_part_stride, out, n_max, H, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: P parts of n_max rows of F f32 (part stride g_part_stride elements,
// rows contiguous); bgrad: P parts of H rows of F f32 (part stride
// bgrad_part_stride elements); send_ptr [P, n_max + 1] int32; send_slot
// [P, *] int32 with part stride slot_part_stride; out [P, n_max, F] f32
// contiguous. Strides in elements. Returns cudaGetLastError().
extern "C" int pgt_halo_scatter(const void* g, long long g_part_stride,
                                const void* bgrad,
                                long long bgrad_part_stride,
                                const void* send_ptr, const void* send_slot,
                                long long slot_part_stride, void* out, int P,
                                int n_max, int H, int F, void* stream) {
  if (P == 0 || n_max == 0 || F == 0) return 0;
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(bgrad);
  float* op = static_cast<float*>(out);
  const int* pp = static_cast<const int*>(send_ptr);
  const int* sp = static_cast<const int*>(send_slot);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(gp) |
                      reinterpret_cast<uintptr_t>(bp) |
                      reinterpret_cast<uintptr_t>(op);
  const long long strides = g_part_stride | bgrad_part_stride;
#define PGT_LAUNCH(VEC)                                                  \
  return launch<VEC>(gp, g_part_stride, bp, bgrad_part_stride, pp, sp,   \
                     slot_part_stride, op, P, n_max, H, F, st)
  if (F % 4 == 0 && strides % 4 == 0 && a % 16 == 0) PGT_LAUNCH(4);
  if (F % 2 == 0 && strides % 2 == 0 && a % 8 == 0) PGT_LAUNCH(2);
  PGT_LAUNCH(1);
#undef PGT_LAUNCH
}
