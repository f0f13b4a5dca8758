// K1 / K3: CSR mean SpMM forward and transpose, hand-written for Hopper
// (sm_90a).
//
// K1 replaces: pipegcn_tpu/ops/spmm.py  _segment_sum_once / spmm_sum /
// spmm_mean (forward): gather fbuf[edge_src], segment-sum into the sorted
// edge_dst (sentinel row dropped), accumulate in f32, divide by the
// full-graph in-degree.
//
//   out[p, i, :] = (sum_{e in [indptr[p,i], indptr[p,i+1])}
//                   fbuf[p, src[p,e], :]) / in_deg[p, i]
//
// K3 replaces: pipegcn_tpu/ops/spmm.py  _spmm_mean_lowp_bwd (and the f32
// autodiff of spmm_sum / spmm_mean): the transpose aggregation of
// g / in_deg with edge roles swapped, accumulated in f32. It reads a
// host-built source-keyed CSR (indptr_t, dst_t) over the real edges:
//
//   d_fbuf[p, s, :] = sum_{e in [indptr_t[p,s], indptr_t[p,s+1])}
//                     g[p, dst_t[p,e], :] * (1 / in_deg[p, dst_t[p,e]])
//
// The product is rounded before the add (__fmul_rn, no FMA contraction,
// in the prescale), so each term equals the plain version's
// g * reciprocal(in_deg).
//
// fbuf is f32 or bf16 (raw bf16 bits); g is f32; accumulation and output
// are f32. The forward CSR row pointer is built on the host from the
// dst-sorted edge list, so pad edges (dst == n_out, src == 0) lie past
// indptr[n_out] and are never read; the transpose CSR drops them.
//
// What bounds both on the H100: the gather. Every edge reads one full
// row (F*4 bytes at f32), so at the training shapes (~21M edges/part,
// F = 256) each launch streams ~21 GB of rows per part from L1/L2/HBM,
// while the least traffic (each input read once) is a few hundred MB and
// the adds are E*F f32 ops. They are random-row-gather kernels: the time
// is set by how many independent row loads are in flight and by where
// they are served, not by arithmetic.
//
// K1's whole-row design: one warp per output row (and per
// 32*VEC*NV-column tile), lanes spread over the columns with vector loads
// of VEC elements (16 B where the width and alignment allow it). The warp
// loads 32 edge indices at a time with one coalesced load and broadcasts
// them with __shfl_sync; the edge loop is unrolled so several rows are in
// flight per lane. Each row's sum runs in edge order in registers: no
// atomics, no shared memory, deterministic results. Rows of any degree
// (0 to thousands) run the same loop. Out-of-range gather indices are
// clamped (the JAX package's jnp.take(mode="clip")), in K3 too.
//
// K1's column slices. Gathering whole rows, the working set is the whole
// table (238.6 MB a part at the serving shape, F = 256 f32, both parts at
// once) against a 50 MB L2, so on a layout without reuse (random parts)
// every gathered row comes from HBM. The caller (ops/spmm.py
// k1_slice_width) may split the F columns into slices of W columns so
// that one (part, slice) table, n_src * W * element bytes, fits in L2;
// the grid runs output rows fastest, then slices, then parts, so the
// resident blocks share one slice of one part and each gathered line is
// fetched from HBM about once and then served from L2. In
// slice_sum_kernel a group of G lanes (a warp, or a part of it: 32 / G
// rows a warp) owns one output row's W = G * V columns of one slice, each
// lane V fixed columns; it walks the row's edges in CSR order, loading
// the next G indices ahead, and adds each gathered value into its own
// f32 sum. So every output element sums the same values in the same
// order as the whole-row kernel, and the result is bit-identical to it
// (S = 1). The indices are re-read once a slice, with streaming loads.
//
// K3's design. On the cluster layout a group of a few hundred consecutive
// sources gathers most of its edges from a band of a few thousand
// consecutive g rows (the block cell's dense tiles hold 80 % of the
// edges), so each g row a CTA needs is needed by many of its rows. A
// prescale pass writes g * (1 / in_deg) once, rounded as the plain
// version rounds it, into column slices of 64 f32 (gp [P, S, n_out, 64],
// slice-major: a slice row is one 256-byte run). gather_t_kernel then
// gives a CTA of 1,024 threads 192 consecutive sources and one slice:
// groups of 16 lanes, each group 3 rows stepped together a chunk of 16
// edge indices at a time (the next chunk prefetched), each lane 4 columns
// of every edge's 256-byte slice row. The kernel takes no shared memory,
// so the SM's 256 KB array serves as L1, and the band's slice rows, once
// fetched from L2, are read again from L1 by the CTA's other rows: each
// line comes from L2 about once a CTA. Each output element still sums its
// row's terms in CSR order from 0, so K3 equals K1's whole-row kernel over
// gp bit for bit. Staging the band's windows in shared
// memory instead (the first design of this kernel) was slower: every
// window boundary cost the rows a step of their walk, and the shared
// memory it took came out of L1 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// bf16 is carried as its raw 16 bits: f32 = bits << 16 (exact)
__device__ __forceinline__ float bf16_lo(unsigned int u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int u) {
  return __uint_as_float(u & 0xffff0000u);
}

template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Loader<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x; o[1] = v.y;
  }
};
template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    o[0] = __ldg(p);
  }
};
template <>
struct Loader<unsigned short, 8> {
  static __device__ __forceinline__ void load(const unsigned short* p,
                                              float* o) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    o[0] = bf16_lo(v.x); o[1] = bf16_hi(v.x);
    o[2] = bf16_lo(v.y); o[3] = bf16_hi(v.y);
    o[4] = bf16_lo(v.z); o[5] = bf16_hi(v.z);
    o[6] = bf16_lo(v.w); o[7] = bf16_hi(v.w);
  }
};
template <>
struct Loader<unsigned short, 4> {
  static __device__ __forceinline__ void load(const unsigned short* p,
                                              float* o) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = bf16_lo(v.x); o[1] = bf16_hi(v.x);
    o[2] = bf16_lo(v.y); o[3] = bf16_hi(v.y);
  }
};
template <>
struct Loader<unsigned short, 2> {
  static __device__ __forceinline__ void load(const unsigned short* p,
                                              float* o) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
    o[0] = bf16_lo(u); o[1] = bf16_hi(u);
  }
};
template <>
struct Loader<unsigned short, 1> {
  static __device__ __forceinline__ void load(const unsigned short* p,
                                              float* o) {
    o[0] = __uint_as_float(static_cast<unsigned int>(__ldg(p)) << 16);
  }
};

// out row chunks of VEC floats; the wrapper guarantees F % VEC == 0 and a
// 16-byte aligned output base, so chunk c is (4*VEC)-byte aligned
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

// K1's whole-row kernel: each output row divided by its own degree at
// the end (deg [P, n_rows]).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_sum_kernel(const T* __restrict__ x, const void* __restrict__ indptr,
                  int indptr_64, const int* __restrict__ idx,
                  long long idx_part_stride, const float* __restrict__ deg,
                  float* __restrict__ out, int n_in, int n_rows, int F) {
  const int part = blockIdx.z;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warp leaves together

  x += static_cast<size_t>(part) * n_in * F;
  idx += static_cast<size_t>(part) * idx_part_stride;
  deg += static_cast<size_t>(part) * n_rows;
  const size_t rp = static_cast<size_t>(part) * (n_rows + 1) + row;
  long long beg, end;
  if (indptr_64) {
    const long long* ip = static_cast<const long long*>(indptr);
    beg = ip[rp];
    end = ip[rp + 1];
  } else {
    const int* ip = static_cast<const int*>(indptr);
    beg = ip[rp];
    end = ip[rp + 1];
  }

  const int col0 = blockIdx.y * (32 * VEC * NV);
  float acc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[v][k] = 0.0f;

  for (long long base = beg; base < end; base += 32) {
    const int n = static_cast<int>(min(32LL, end - base));
    int mine = lane < n ? __ldg(idx + base + lane) : 0;
    mine = min(max(mine, 0), n_in - 1);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int s = __shfl_sync(0xffffffffu, mine, j);
      const T* rowp = x + static_cast<size_t>(s) * F;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = col0 + (v * 32 + lane) * VEC;
        if (c < F) {
          float y[VEC];
          Loader<T, VEC>::load(rowp + c, y);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[v][k] += y[k];
        }
      }
    }
  }

  const size_t orow = static_cast<size_t>(part) * n_rows + row;
  float* op = out + orow * F;
  const float d = deg[row];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = col0 + (v * 32 + lane) * VEC;
    if (c < F) {
      float y[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) y[k] = acc[v][k] / d;
      store<VEC>(op + c, y);
    }
  }
}

template <typename T, int VEC>
int launch_vec(const T* x, const void* indptr, int indptr_64,
               const int* idx, long long idx_part_stride, const float* deg,
               float* out, int P, int n_in, int n_rows, int F,
               cudaStream_t stream) {
  const int per = 32 * VEC;
  const int need = (F + per - 1) / per;
  const int nv = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  const int tile = per * nv;
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (F + tile - 1) / tile, P);
  const dim3 block(kWarpsPerBlock * 32);
#define PGT_LAUNCH(NV_)                                                  \
  gather_sum_kernel<T, VEC, NV_><<<grid, block, 0, stream>>>(            \
      x, indptr, indptr_64, idx, idx_part_stride, deg, out, n_in,        \
      n_rows, F)
  switch (nv) {
    case 1: PGT_LAUNCH(1); break;
    case 2: PGT_LAUNCH(2); break;
    case 4: PGT_LAUNCH(4); break;
    default: PGT_LAUNCH(8); break;
  }
#undef PGT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// K1 over one column slice: blockIdx.y is the slice (W = G * V columns
// from blockIdx.y * W; the last may be cut by F), blockIdx.z the part.
// A group of G lanes owns one output row; lane gl of it the V columns
// from slice start + gl * V (the wrapper guarantees F % V == 0 and the
// alignment of V-element loads).
template <typename T, int V, int G>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
slice_sum_kernel(const T* __restrict__ x, const void* __restrict__ indptr,
                 int indptr_64, const int* __restrict__ idx,
                 long long idx_part_stride, const float* __restrict__ deg,
                 float* __restrict__ out, int n_in, int n_rows, int F) {
  constexpr int kRows = 32 / G;  // output rows a warp
  constexpr unsigned kFull = 0xffffffffu;
  const int part = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G, gl = lane % G;
  const int row0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kRows;
  if (row0 >= n_rows) return;  // whole warp leaves together
  const int row = row0 + grp;
  const bool live = row < n_rows;
  const int col = blockIdx.y * (G * V) + gl * V;
  const bool mine_cols = live && col < F;

  x += static_cast<size_t>(part) * n_in * F + col;
  idx += static_cast<size_t>(part) * idx_part_stride;
  long long beg = 0, end = 0;
  if (live) {
    const size_t rp = static_cast<size_t>(part) * (n_rows + 1) + row;
    if (indptr_64) {
      const long long* ip = static_cast<const long long*>(indptr);
      beg = ip[rp];
      end = ip[rp + 1];
    } else {
      const int* ip = static_cast<const int*>(indptr);
      beg = ip[rp];
      end = ip[rp + 1];
    }
  }
  const long long n = end - beg;
  // the warp's longest row: every group walks that many chunks, so the
  // shuffles see the whole warp
  long long n_max = n;
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
    n_max = max(n_max, __shfl_xor_sync(kFull, n_max, off));

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  int next = gl < n ? __ldcs(idx + beg + gl) : 0;
  for (long long b = 0; b < n_max; b += G) {
    const int mine = min(max(next, 0), n_in - 1);
    const int cnt = static_cast<int>(max(0LL, min(static_cast<long long>(G),
                                                  n - b)));
    const int c_max = static_cast<int>(min(static_cast<long long>(G),
                                           n_max - b));
    next = b + G + gl < n ? __ldcs(idx + beg + b + G + gl) : 0;
#pragma unroll 8
    for (int j = 0; j < c_max; ++j) {
      const int s = __shfl_sync(kFull, mine, j, G);
      if (j < cnt && mine_cols) {
        float y[V];
        Loader<T, V>::load(x + static_cast<size_t>(s) * F, y);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += y[k];
      }
    }
  }
  if (!mine_cols) return;
  const float d = deg[static_cast<size_t>(part) * n_rows + row];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] /= d;
  store<V>(out + (static_cast<size_t>(part) * n_rows + row) * F + col, acc);
}

template <typename T, int V>
int launch_slices(const T* x, const void* indptr, int indptr_64,
                  const int* idx, long long idx_part_stride, const float* deg,
                  float* out, int P, int n_in, int n_rows, int F, int width,
                  cudaStream_t stream) {
  const int G = width / V;
  const int rows_per_block = kWarpsPerBlock * (32 / G);
  const dim3 grid((n_rows + rows_per_block - 1) / rows_per_block,
                  (F + width - 1) / width, P);
  const dim3 block(kWarpsPerBlock * 32);
#define PGT_SLICE(G_)                                                    \
  slice_sum_kernel<T, V, G_><<<grid, block, 0, stream>>>(               \
      x, indptr, indptr_64, idx, idx_part_stride, deg, out, n_in,        \
      n_rows, F)
  switch (G) {
    case 8: PGT_SLICE(8); break;
    case 16: PGT_SLICE(16); break;
    default: PGT_SLICE(32); break;
  }
#undef PGT_SLICE
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// fbuf [P, n_src, F] (f32, or bf16 bits when fbuf_bf16), indptr
// [P, n_out + 1] (int32, or int64 when indptr_64), src [P, *] int32 with
// part stride src_part_stride, in_deg [P, n_out] f32, out [P, n_out, F]
// f32 (16-byte aligned). All contiguous. width: the columns of a slice;
// width <= 0 or >= F runs the whole-row kernel (one slice), otherwise
// slice_sum_kernel with vec-element loads (width / vec lanes a row: 8,
// 16 or 32; F % vec == 0 and fbuf aligned to vec elements; vec 1, 2 or
// 4 for f32 rows, 1, 2, 4 or 8 for bf16). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a slice shape it does not take.
extern "C" int pgt_spmm_mean(const void* fbuf, int fbuf_bf16,
                             const void* indptr, int indptr_64,
                             const void* src, long long src_part_stride,
                             const void* in_deg, void* out, int P,
                             int n_src, int n_out, int F, int width, int vec,
                             void* stream) {
  if (P == 0 || n_out == 0 || F == 0) return 0;
  if (n_src <= 0 || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(src);
  const float* dg = static_cast<const float*>(in_deg);
  float* o = static_cast<float*>(out);
  if (width > 0 && width < F) {
    const int esize = fbuf_bf16 ? 2 : 4;
    const int G = vec > 0 ? width / vec : 0;
    if (vec <= 0 || width % vec != 0 || (G != 8 && G != 16 && G != 32) ||
        F % vec != 0 || !aligned(fbuf, vec * esize) ||
        vec > (fbuf_bf16 ? 8 : 4) || (vec & (vec - 1)) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
#define PGT_K1S(T, V)                                                    \
  return launch_slices<T, V>(static_cast<const T*>(fbuf), indptr,        \
                             indptr_64, s, src_part_stride, dg, o, P,    \
                             n_src, n_out, F, width, st)
    if (fbuf_bf16) {
      switch (vec) {
        case 1: PGT_K1S(unsigned short, 1);
        case 2: PGT_K1S(unsigned short, 2);
        case 4: PGT_K1S(unsigned short, 4);
        default: PGT_K1S(unsigned short, 8);
      }
    }
    switch (vec) {
      case 1: PGT_K1S(float, 1);
      case 2: PGT_K1S(float, 2);
      default: PGT_K1S(float, 4);
    }
#undef PGT_K1S
  }
#define PGT_K1(T, VEC)                                                   \
  return launch_vec<T, VEC>(f, indptr, indptr_64, s, src_part_stride,   \
                            dg, o, P, n_src, n_out, F, st)
  if (fbuf_bf16) {
    const unsigned short* f = static_cast<const unsigned short*>(fbuf);
    if (F % 8 == 0 && aligned(f, 16)) PGT_K1(unsigned short, 8);
    if (F % 2 == 0 && aligned(f, 4)) PGT_K1(unsigned short, 2);
    PGT_K1(unsigned short, 1);
  }
  const float* f = static_cast<const float*>(fbuf);
  if (F % 4 == 0 && aligned(f, 16)) PGT_K1(float, 4);
  if (F % 2 == 0 && aligned(f, 8)) PGT_K1(float, 2);
  PGT_K1(float, 1);
#undef PGT_K1
}


// ---------------------------------------------------------------------------
// K3: the transpose over column slices, its reuse served from L1

namespace {

// K3's geometry: slices of kK3Width f32 (the Python side allocates gp at
// this width, ops/spmm.py K3_SLICE), CTAs of kK3Threads threads in lane
// groups of kK3Group, each group kK3RowsPerGroup rows: kK3Rows consecutive
// sources a CTA (the fastest measured on an H100 at the training cell,
// PERF.md).
constexpr int kK3Width = 64;
constexpr int kK3Threads = 1024;
constexpr int kK3RowsPerGroup = 3;
constexpr int kK3Group = kK3Width / 4;
constexpr int kK3Slots = kK3Threads / kK3Group;
constexpr int kK3Rows = kK3Slots * kK3RowsPerGroup;

// The prescale: gp [P, S, n_out, kK3Width] = g [P, n_out, F] * (1 /
// in_deg), the product rounded (the plain version's terms), in column
// slices, the columns past F zero. A thread writes 4 consecutive floats.
__global__ void __launch_bounds__(256)
prescale_kernel(const float* __restrict__ g, const float* __restrict__ deg,
                float* __restrict__ gp, int P, int n_out, int F, int S,
                int vec4) {
  constexpr int Q = kK3Width / 4;
  const long long total = static_cast<long long>(P) * S * n_out * Q;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int q = static_cast<int>(i % Q);
    long long t = i / Q;
    const int r = static_cast<int>(t % n_out);
    t /= n_out;
    const int s = static_cast<int>(t % S);
    const long long grow = (t / S) * n_out + r;
    const float rc = 1.0f / __ldg(deg + grow);
    const int c = s * kK3Width + 4 * q;
    const float* gr = g + grow * F;
    float v[4];
    if (vec4 && c < F) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(gr + c));
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = c + k < F ? __ldg(gr + c + k) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = c + k < F ? __fmul_rn(v[k], rc) : 0.f;
    reinterpret_cast<float4*>(gp)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// A CTA owns kK3Rows consecutive output rows (sources) of one part and
// one column slice of gp: lane groups of kK3Group lanes, each group
// kK3RowsPerGroup rows (rows slot, slot + kK3Slots, ...), each lane 4
// columns. Every row walks its edges in CSR order, a chunk of kK3Group
// indices at a time (one a lane, the next chunk prefetched), and adds the
// gathered 16 bytes of each edge's gp row to its f32 sum; a group steps
// its rows together, so their loads are in flight at once. The CTA's rows
// gather mostly from the same few hundred gp rows (the cluster layout),
// and with no shared memory the SM's 256 KB array is L1: those lines are
// fetched from L2 about once a CTA and then hit L1.
__global__ void __launch_bounds__(kK3Threads, 1)
gather_t_kernel(const float* __restrict__ gp, const void* __restrict__ indptr,
                int indptr_64, const int* __restrict__ dst,
                long long dst_part_stride, float* __restrict__ out,
                int n_out, int n_src, int F, int S) {
  constexpr int G = kK3Group, RPG = kK3RowsPerGroup;
  constexpr unsigned kFull = 0xffffffffu;
  const int part = blockIdx.z, slice = blockIdx.y, grp = blockIdx.x;
  const int slot = threadIdx.x / G, gl = threadIdx.x % G;
  const float4* gs4 = reinterpret_cast<const float4*>(
      gp + (static_cast<size_t>(part) * S + slice) * n_out * kK3Width) + gl;
  const int row0 = grp * kK3Rows;
  const size_t rp = static_cast<size_t>(part) * (n_src + 1);
  auto ip = [&](int r) -> long long {
    return indptr_64 ? static_cast<const long long*>(indptr)[rp + r]
                     : static_cast<const int*>(indptr)[rp + r];
  };
  const long long base = ip(row0);  // the CTA's first edge
  const int* dl = dst + static_cast<size_t>(part) * dst_part_stride + base;
  // row j: its edges c .. e (offsets from base), lane gl holding edge c +
  // gl's clipped dst in ci and edge c + G + gl's in ni
  int c[RPG], e[RPG], ci[RPG], ni[RPG];
  float4 acc[RPG];
  auto idx_at = [&](int j, int off) {
    return off + gl < e[j] ? min(max(__ldcs(dl + off + gl), 0), n_out - 1)
                           : 0;
  };
  bool any = false;
#pragma unroll
  for (int j = 0; j < RPG; ++j) {
    const int row = row0 + slot + kK3Slots * j;
    c[j] = e[j] = 0;
    if (row < n_src) {
      c[j] = static_cast<int>(ip(row) - base);
      e[j] = static_cast<int>(ip(row + 1) - base);
    }
    ci[j] = idx_at(j, c[j]);
    ni[j] = idx_at(j, c[j] + G);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    any |= c[j] < e[j];
  }
  // the warp walks its longest row's chunks (the shuffles need every lane)
  while (__any_sync(kFull, any)) {
    int n[RPG];
    int most = 0;
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
      n[j] = max(0, min(G, e[j] - c[j]));
      most = max(most, n[j]);
    }
    const int cmax = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(most)));
#pragma unroll 4
    for (int q = 0; q < cmax; ++q) {
      float4 v[RPG];
#pragma unroll
      for (int j = 0; j < RPG; ++j) {
        const int sd = __shfl_sync(kFull, ci[j], q, G);
        if (q < n[j]) v[j] = __ldg(gs4 + static_cast<size_t>(sd) * G);
      }
#pragma unroll
      for (int j = 0; j < RPG; ++j) {
        if (q < n[j]) {
          acc[j].x += v[j].x; acc[j].y += v[j].y;
          acc[j].z += v[j].z; acc[j].w += v[j].w;
        }
      }
    }
    any = false;
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
      c[j] += G;
      ci[j] = ni[j];
      ni[j] = idx_at(j, c[j] + G);
      any |= c[j] < e[j];
    }
  }
  const int col = slice * kK3Width + 4 * gl;
  if (col >= F) return;
  const bool f4 = F % 4 == 0;
#pragma unroll
  for (int j = 0; j < RPG; ++j) {
    const int row = row0 + slot + kK3Slots * j;
    if (row >= n_src) continue;
    float* op = out + (static_cast<size_t>(part) * n_src + row) * F + col;
    if (f4) {
      *reinterpret_cast<float4*>(op) = acc[j];
    } else {
      const float v[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (col + t < F) op[t] = v[t];
    }
  }
}

}  // namespace

// K3. g [P, n_out, F] f32, indptr_t [P, n_src + 1] (int32, or int64 when
// indptr_64), dst_t [P, *] int32 with part stride dst_part_stride,
// in_deg [P, n_out] f32, gp the prescale's buffer [P, ceil(F / 64), n_out,
// 64] f32, out [P, n_src, F] f32 (both 16-byte aligned). All contiguous.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a misaligned
// buffer.
extern "C" int pgt_spmm_mean_t(const void* g, const void* indptr_t,
                               int indptr_64, const void* dst_t,
                               long long dst_part_stride,
                               const void* in_deg, void* gp, void* out,
                               int P, int n_out, int n_src, int F,
                               void* stream) {
  if (P == 0 || n_src == 0 || F == 0) return 0;
  if (n_out <= 0 || !aligned(out, 16) || !aligned(gp, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // set once: the SM count (the prescale's grid, a few blocks an SM) and
  // the gather's carve-out (no shared memory: the whole array serves as L1)
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static const cudaError_t carve = cudaFuncSetAttribute(
      gather_t_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (carve != cudaSuccess) return static_cast<int>(carve);
  const float* x = static_cast<const float*>(g);
  float* gpf = static_cast<float*>(gp);
  const int S = (F + kK3Width - 1) / kK3Width;
  const long long work =
      static_cast<long long>(P) * S * n_out * (kK3Width / 4);
  const int blocks = static_cast<int>(
      work / 256 + 1 < sms * 16LL ? work / 256 + 1 : sms * 16LL);
  prescale_kernel<<<blocks, 256, 0, st>>>(
      x, static_cast<const float*>(in_deg), gpf, P, n_out, F, S,
      F % 4 == 0 && aligned(x, 16));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_src + kK3Rows - 1) / kK3Rows, S, P);
  gather_t_kernel<<<grid, kK3Threads, 0, st>>>(
      gpf, indptr_t, indptr_64, static_cast<const int*>(dst_t),
      dst_part_stride, static_cast<float*>(out), n_out, n_src, F, S);
  return static_cast<int>(cudaGetLastError());
}
