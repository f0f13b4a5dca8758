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
// 21 GB at f32, from L1/L2/HBM, while the least traffic (each input
// once) is a few hundred MB and the adds E*F f32 ops (~0.16 ms at the
// card's 67 TFLOP/s). At fp8 the instructions count: the e4m3 instance
// issues about 3.5 a gathered element (half an F2FP e4m3x2 -> f16x2, an
// HADD2.F32 f16 -> f32, the FADD, a shift, and its share of the
// shuffle, predicates, address and load of an entry), some 1.2 G warp
// instructions a launch at the bucket cell, about two thirds of the
// card's issue rate over the kernel's time. f32 rows need fewer an
// element and move four times the bytes (PERF.md's K9 findings).
//
// Design: K3's (csrc/spmm_mean.cu gather_t_kernel), over bucket rows in
// table order. A pre-pass (order_kernel) lists each part's outputs in the
// order of their table rows: perm[t] the output whose inv points at table
// row t, then the outputs sent to the zero row (and any that share a row
// another output claimed: a corrupt inv). A CTA of kThreads threads owns
// kSlots * kRows consecutive entries of that list, so its rows lie in one
// bucket and walk the same width, and on the cluster layout (the rows of
// a bucket in ascending output order) they gather from one band of
// sources. A lane group of kGroup lanes owns kRows rows (slot, slot +
// kSlots, ...), each lane one vector of VEC elements of a column slice
// (16 bytes where the width and alignment allow it: a 256-byte slice, the
// whole row at fp8 and F = 256; bf16 rows take two slices, f32 rows four,
// gathered in place as the grid's y dimension). Each row reads its
// output's inv, finds the bucket by a binary search over the row offsets
// (read through the read-only path: the ladder has < 128 rungs), and
// walks its w_b table entries in table order a chunk of kGroup at a time,
// one index a lane with the next chunk prefetched, shuffled within the
// group; a step issues the loads of kDepth entries of each of its rows
// before it adds them (the bytes in flight a thread, not the rows, set
// the rate: at fp8 each row costs 16 accumulators a lane). The kernel
// takes no shared memory and its carve-out preference is 0, so the SM's
// whole array serves as L1 for the rows a CTA's outputs share. Each
// output element sums its row's widened values in table order from +0.0
// in registers: no atomics in the sums, deterministic, bit-identical to
// the plain version. A sentinel entry (>= n_src) adds nothing wherever it
// sits (skipping it is exact: the sum never becomes -0.0). Cap-padding
// table rows are never visited (no inv entry points at them); a row sent
// to the zero row writes zeros (then / in_deg, * inv_scale).

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 128;
// lanes a row: kGroup vectors of at most 16 bytes, a 256-byte slice
constexpr int kGroup = 16;

enum XType { kF32 = 0, kBF16 = 1, kE4M3 = 2, kE5M2 = 3 };

template <int XT>
__host__ __device__ constexpr int elem_bytes() {
  return XT == kF32 ? 4 : XT == kBF16 ? 2 : 1;
}

// K9's geometry by row type (PERF.md's K9 design table): threads a CTA,
// rows a lane group steps together, and entries of each row whose loads
// a step issues before it adds them
template <int XT>
struct Geometry {
  static constexpr bool kNarrow = XT == kE4M3 || XT == kE5M2;
  static constexpr int kThreads = 1024;
  static constexpr int kRows = kNarrow ? 1 : XT == kBF16 ? 1 : 3;
  static constexpr int kDepth = kNarrow ? 4 : XT == kBF16 ? 8 : 2;
};

// two fp8 values (low byte first) -> two floats, exactly
template <int XT>
__device__ __forceinline__ float2 fp8x2(unsigned int pair) {
  constexpr __nv_fp8_interpretation_t kind = XT == kE4M3 ? __NV_E4M3
                                                         : __NV_E5M2;
  const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), kind);
  return __half22float2(__half2(r));
}

// VB bytes (1, 2, 4, 8 or 16) at p, as 32-bit words (the low bytes first)
template <int VB>
__device__ __forceinline__ void load_raw(const char* p, unsigned int* w) {
  if constexpr (VB == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (VB == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VB == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
}

// acc[k] += the k-th of VEC elements of type XT held in w, widened
// exactly to f32
template <int XT, int VEC>
__device__ __forceinline__ void add_raw(const unsigned int* w, float* acc) {
  if constexpr (XT == kF32) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += __uint_as_float(w[k]);
  } else if constexpr (XT == kBF16) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc[k] += __uint_as_float(k & 1 ? w[k / 2] & 0xffff0000u
                                      : w[k / 2] << 16);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 2) {
      const float2 f = fp8x2<XT>(w[k / 4] >> (8 * (k % 4)));
      acc[k] += f.x;
      if (k + 1 < VEC) acc[k + 1] += f.y;
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

// The pre-pass: the outputs in table order. Output o of part p claims
// table row t = clip(inv[p, o], 0, total) in perm [P, rows] (-1 on entry;
// rows the tables' row count as the host staged it); an output whose t is
// the zero row, or whose row another output claimed first (only a corrupt
// inv repeats a row), goes to the list over [P, n_out], its length in
// n_over [P] (0 on entry). Which of two outputs sharing a row claims it
// varies from run to run; both get the same sum.
__global__ void __launch_bounds__(256)
order_kernel(const int* __restrict__ inv, int n_out,
             const long long* __restrict__ meta, int nb, int rows,
             int* __restrict__ perm, int* __restrict__ over,
             int* __restrict__ n_over) {
  const int part = blockIdx.y;
  const long long total = __ldg(meta + nb);
  const int* iv = inv + static_cast<size_t>(part) * n_out;
  for (int o = blockIdx.x * 256 + threadIdx.x; o < n_out;
       o += gridDim.x * 256) {
    long long t = __ldg(iv + o);
    t = t < 0 ? 0 : t;
    if (t < total && t < rows &&
        atomicCAS(perm + static_cast<size_t>(part) * rows + t, -1, o) == -1)
      continue;
    over[static_cast<size_t>(part) * n_out + atomicAdd(n_over + part, 1)] = o;
  }
}

// A CTA: kSlots * kRows consecutive walk rows of one part (blockIdx.z) and
// one column slice (blockIdx.y) of kGroup * VEC columns; lane gl of a
// group the VEC columns from the slice's start + gl * VEC. Walk row r is
// the output perm[r] (table row r; -1: a cap-padding row, skipped) for r
// < rows, then the outputs of the list over. Each output o walks its own
// table row clip(inv[o], 0, total), whichever walk row holds it.
template <int XT, int VEC>
__global__ void __launch_bounds__(Geometry<XT>::kThreads, 1)
bucket_kernel(const void* __restrict__ x, int n_src, int F,
              const int* __restrict__ idx, long long idx_part_stride,
              const long long* __restrict__ meta, int nb,
              const int* __restrict__ inv, int n_out, int rows,
              const int* __restrict__ perm, const int* __restrict__ over,
              const int* __restrict__ n_over,
              const float* __restrict__ deg,
              const float* __restrict__ inv_scale, float* __restrict__ out) {
  constexpr int G = kGroup, RPG = Geometry<XT>::kRows;
  constexpr int D = Geometry<XT>::kDepth;
  static_assert(G % D == 0, "a step's entries lie in one chunk");
  constexpr int kSlots = Geometry<XT>::kThreads / G;
  constexpr int EB = elem_bytes<XT>();
  constexpr int VB = VEC * EB, NW = (VB + 3) / 4;
  constexpr unsigned kFull = 0xffffffffu;
  const int part = blockIdx.z;
  const int slot = threadIdx.x / G, gl = threadIdx.x % G;
  const int col = blockIdx.y * (G * VEC) + gl * VEC;
  const bool mine = col < F;
  const char* xp = static_cast<const char*>(x) +
                   (static_cast<size_t>(part) * n_src * F + col) * EB;
  const int* ip = idx + static_cast<size_t>(part) * idx_part_stride;
  const long long total = __ldg(meta + nb);
  const int walk = rows + __ldg(n_over + part);
  const int row0 = blockIdx.x * (kSlots * RPG);
  if (row0 >= walk) return;  // past the list: the whole CTA leaves

  // row j: its remaining entries rp[j][0 .. rem[j]), lane gl holding the
  // index of entry gl in ci and of entry G + gl in ni (the sentinel past
  // the row's end)
  const int* rp[RPG];
  int o[RPG], rem[RPG], ci[RPG], ni[RPG];
  float acc[RPG][VEC];
  auto idx_at = [&](int j, int off) {
    return off + gl < rem[j] ? __ldcs(rp[j] + off + gl) : n_src;
  };
  bool any = false;
#pragma unroll
  for (int j = 0; j < RPG; ++j) {
    const int r = row0 + slot + kSlots * j;
    o[j] = r < rows ? __ldg(perm + static_cast<size_t>(part) * rows + r)
           : r < walk ? __ldg(over + static_cast<size_t>(part) * n_out +
                              (r - rows))
                      : -1;
    rp[j] = ip;
    rem[j] = 0;
    if (o[j] >= 0) {
      long long t = __ldg(inv + static_cast<size_t>(part) * n_out + o[j]);
      t = t < 0 ? 0 : t;
      if (t < total) {
        // the bucket b with meta[b] <= t < meta[b + 1]
        int lo = 0, hi = nb - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (__ldg(meta + mid) <= t) lo = mid; else hi = mid - 1;
        }
        const long long w = __ldg(meta + 2 * (nb + 1) + lo);
        rp[j] = ip + __ldg(meta + (nb + 1) + lo) + (t - __ldg(meta + lo)) * w;
        rem[j] = static_cast<int>(w);
      }
    }
    ci[j] = idx_at(j, 0);
    ni[j] = idx_at(j, G);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[j][k] = 0.0f;
    any |= rem[j] > 0;
  }
  // the warp walks its longest row's chunks (the shuffles need every lane)
  while (__any_sync(kFull, any)) {
    int n[RPG];
    int most = 0;
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
      n[j] = max(0, min(G, rem[j]));
      most = max(most, n[j]);
    }
    const int cmax = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(most)));
    // a step: D entries of each row, every load issued before the adds
    for (int q = 0; q < cmax; q += D) {
      unsigned int raw[RPG][D][NW];
      bool use[RPG][D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
#pragma unroll
        for (int j = 0; j < RPG; ++j) {
          const int s = __shfl_sync(kFull, ci[j], q + k, G);
          use[j][k] = q + k < n[j] && s < n_src && mine;
          if (use[j][k])
            load_raw<VB>(xp + static_cast<size_t>(max(s, 0)) * F * EB,
                         raw[j][k]);
        }
      }
#pragma unroll
      for (int j = 0; j < RPG; ++j)
#pragma unroll
        for (int k = 0; k < D; ++k)
          if (use[j][k]) add_raw<XT, VEC>(raw[j][k], acc[j]);
    }
    any = false;
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
      rp[j] += G;
      rem[j] -= G;
      ci[j] = ni[j];
      ni[j] = idx_at(j, G);
      any |= rem[j] > 0;
    }
  }
  if (!mine) return;
  const float sc = inv_scale != nullptr ? inv_scale[part] : 1.0f;
#pragma unroll
  for (int j = 0; j < RPG; ++j) {
    if (o[j] < 0) continue;
    const size_t orow = static_cast<size_t>(part) * n_out + o[j];
    const float d = deg != nullptr ? deg[orow] : 1.0f;
    float y[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      y[k] = acc[j][k];
      if (deg != nullptr) y[k] = y[k] / d;
      if (inv_scale != nullptr) y[k] = y[k] * sc;
    }
    store<VEC>(out + orow * F + col, y);
  }
}

// the tables and their outputs as the entry point takes them
struct Args {
  const int* idx;
  long long idx_stride;
  const long long* meta;
  int nb;
  const int* inv;
  int n_out, rows;
  int *perm, *over, *n_over;
  const float *deg, *inv_scale;
  float* out;
  int P;
};

template <int XT, int VEC>
int launch(const void* x, int n_src, int F, const Args& a,
           cudaStream_t stream) {
  // set once an instance: no shared memory, the whole array serves as L1
  static const cudaError_t carve = cudaFuncSetAttribute(
      bucket_kernel<XT, VEC>, cudaFuncAttributePreferredSharedMemoryCarveout,
      0);
  if (carve != cudaSuccess) return static_cast<int>(carve);
  constexpr int kRowsPerBlock =
      Geometry<XT>::kThreads / kGroup * Geometry<XT>::kRows;
  const int width = kGroup * VEC;
  const long long walk = static_cast<long long>(a.rows) + a.n_out;
  const dim3 grid(static_cast<unsigned>((walk + kRowsPerBlock - 1) /
                                        kRowsPerBlock),
                  (F + width - 1) / width, a.P);
  bucket_kernel<XT, VEC><<<grid, Geometry<XT>::kThreads, 0, stream>>>(
      x, n_src, F, a.idx, a.idx_stride, a.meta, a.nb, a.inv, a.n_out, a.rows,
      a.perm, a.over, a.n_over, a.deg, a.inv_scale, a.out);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the widest vector (16 bytes at most) that F and x's alignment allow
template <int XT>
int dispatch(const void* x, int n_src, int F, const Args& a,
             cudaStream_t st) {
#define PGT_K9(VEC)                                                      \
  if (F % (VEC) == 0 && aligned(x, (VEC) * elem_bytes<XT>()))            \
    return launch<XT, VEC>(x, n_src, F, a, st)
  constexpr int kMax = 16 / elem_bytes<XT>();
  if constexpr (kMax >= 16) PGT_K9(16);
  if constexpr (kMax >= 8) PGT_K9(8);
  PGT_K9(4);
  PGT_K9(2);
  return launch<XT, 1>(x, n_src, F, a, st);
#undef PGT_K9
}

}  // namespace

// x [P, n_src, F] of type x_type (0 f32, 1 bf16, 2 e4m3fn, 3 e5m2); idx
// [P, *] int32 with part stride idx_stride; meta [3, nb + 1] int64 (row
// offsets, element offsets, widths); inv [P, n_out] int32; rows the
// tables' row count (meta's last row offset, as staged); scratch int32
// [P (rows + n_out) + P] (the pre-pass's lists); deg [P, n_out] f32 or
// null; inv_scale [P] f32 or null; out [P, n_out, F] f32 (16-byte
// aligned). All contiguous, on the device. Returns cudaGetLastError().
extern "C" int pgt_bucket_spmm(const void* x, int x_type, int P, int n_src,
                               int F, const void* idx, long long idx_stride,
                               const void* meta, int nb, const void* inv,
                               int n_out, int rows, void* scratch,
                               const void* deg, const void* inv_scale,
                               void* out, void* stream) {
  if (P == 0 || n_out == 0 || F == 0) return 0;
  if (n_src <= 0 || nb < 0 || nb > kMaxBuckets || rows < 0 ||
      x_type < kF32 || x_type > kE5M2 || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* perm = static_cast<int*>(scratch);
  int* over = perm + static_cast<size_t>(P) * rows;
  int* n_over = over + static_cast<size_t>(P) * n_out;
  const Args a{static_cast<const int*>(idx), idx_stride,
               static_cast<const long long*>(meta), nb,
               static_cast<const int*>(inv), n_out, rows, perm, over, n_over,
               static_cast<const float*>(deg),
               static_cast<const float*>(inv_scale),
               static_cast<float*>(out), P};
  cudaError_t e = cudaMemsetAsync(
      perm, 0xff, sizeof(int) * static_cast<size_t>(P) * rows, st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(n_over, 0, sizeof(int) * static_cast<size_t>(P), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = n_out / 256 + 1 < 1024 ? n_out / 256 + 1 : 1024;
  order_kernel<<<dim3(blocks, P), 256, 0, st>>>(
      a.inv, n_out, a.meta, nb, rows, perm, over, n_over);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (x_type) {
    case kF32: return dispatch<kF32>(x, n_src, F, a, st);
    case kBF16: return dispatch<kBF16>(x, n_src, F, a, st);
    case kE4M3: return dispatch<kE4M3>(x, n_src, F, a, st);
    case kE5M2: return dispatch<kE5M2>(x, n_src, F, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
