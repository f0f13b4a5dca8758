// K2 / K5 / K18: masked halo gather (emulated ring exchange), the
// reverse-ring block return and the serving engine's dirty-row exchange,
// hand-written for Hopper (sm_90a).
//
// K2 replaces: pipegcn_tpu/parallel/halo.py  exchange_blocks / halo_exchange:
// for each ring distance d = 1..P-1, part r receives h[s][send_idx[s][d-1]]
// from s = (r-d) mod P, zeroed where send_mask[s][d-1] is off, and stacks
// the received blocks behind its inner rows in distance order. On one card
// the P parts live stacked as [P, n_max, F], so the ppermute becomes a row
// copy between parts.
//
// One launch writes, for every part r, the rows [row_begin, n_max + H) of
//   concat(h[r], block_1, ..., block_{P-1}),   H = (P-1) * B
// into out[r] (row row_begin lands at out row 0): row_begin = 0 is
// halo_exchange with the concat fused in; row_begin = n_max is
// exchange_blocks (the halo block alone).
//
// What bounds it on the H100: bytes. It does no arithmetic; each output
// row is one source row read and written once (the least traffic is
// exactly what it moves, plus the index and mask bytes), so HBM bandwidth
// is the limit.
//
// Design: one warp per output row; the warp resolves (sender, distance,
// slot) from the row number, reads send_idx/send_mask once, clamps the
// index (jnp.take(mode="clip")), and copies the row with the widest
// vector (16/8/4/2/1 bytes) that the row size, part strides and pointers
// allow. Masked-off rows are written as zero bytes. The copy is
// byte-for-byte, so the result is bit-exact against the plain version.
//
// K5 replaces: pipegcn_tpu/parallel/halo.py  return_blocks: the halo
// cotangent of receiver r, [(P-1)*B, F] in distance order, goes back along
// the reverse ring, so on the stacked layout
//   out[r, (d-1)B : dB] = in[(r+d) mod P, (d-1)B : dB],   d = 1..P-1.
// The input may be a strided view (the halo rows of a [P, n_max + H, F]
// cotangent): each part's block is contiguous. Bound: bytes, each block
// read and written once, nothing else. Design: no rows at all. Each of
// the P (P-1) (receiver, distance) blocks is one contiguous run of
// B * row_bytes bytes, cut into 16 KB chunks, a block a chunk, each
// thread keeping four vectors in flight (loads, then stores). The vector
// is 16 bytes wherever the source and destination addresses of a run
// agree modulo 16 (the cell's case), else the widest width they agree
// modulo; a chunk's head and tail up to the vector boundaries are copied
// byte by byte, so an odd row size or part stride narrows nothing else.
// Byte copies: bit-exact for any row type. A grid of one wave walking
// the chunks grid-stride, as K11 reads, timed slower than a block a chunk
// at every chunk size and depth tried: the card schedules the short
// blocks of a pure copy better than a loop of them.

// K18 replaces: pipegcn_tpu/serve/freshness.py  dirty_exchange_blocks: the
// serving engine's incremental layer-0 halo refresh. For receiver r,
// distance d = 1..P-1 and slot b, with s = (r-d) mod P, e = (s, d-1, b) and
// i = clip(send_idx[e], 0, n_max-1):
//   if send_mask[e] and dirty[s, i]:  halo[r, (d-1)B + b] = h[s, i]
// and the slot is left as it is otherwise. That is JAX's take(clip) ->
// & send_mask -> where -> ppermute -> where(bits, fresh, halo) collapsed
// onto one card, in place on the resident halo (JAX donates it).
// Bound: bytes — the send lists' index and mask bytes and the dirty bits
// of each slot's owner row, plus each dirty slot's row read and written
// once. Design: one scan of the send lists in their own order (sender,
// distance, slot), a block a chunk of 32 kDirtyWarps slots. Lane l of the
// grid's warp g takes slot g + l G (G the grid's warps), so a warp's slots
// may lie in any distance and sender: each lane works out its own. A lane
// loads its slot's mask byte and index together and, only where the mask
// is on, clips the index and reads the owner row's dirty bit (one byte of
// the u8 bitmap [P, n_max], shipped once per refresh). A ballot gives the
// warp's live slots; the warp copies them one row at a time, the row's
// source and destination shuffled from the lane that scanned it, lanes
// over the row's vectors, up to kDirtyAhead vectors a lane loaded (past
// L1) before the stores. The vector is K2's widest that the row size,
// part strides and pointers allow.
// Invariants: a masked-off slot never reads its index's dirty bit, and the
// index is clipped before any read; clean slots are never written, so
// their bytes (NaN payloads included) survive; dirty ones are byte
// copies, bit-exact for any row type; no two slots share a destination,
// so the split is free. PERF.md's K18 design table has the measured
// alternatives. PGT_PLANT_K18_KEEP_LAST_SLOT (never set by the build)
// plants a fault for chip_smoke.py: the last slot of the send lists is
// live whatever its mask.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename V>
__device__ __forceinline__ V zero_vec();
template <> __device__ __forceinline__ uint4 zero_vec<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <> __device__ __forceinline__ uint2 zero_vec<uint2>() {
  return make_uint2(0u, 0u);
}
template <> __device__ __forceinline__ unsigned int zero_vec<unsigned int>() {
  return 0u;
}
template <>
__device__ __forceinline__ unsigned short zero_vec<unsigned short>() {
  return 0;
}
template <>
__device__ __forceinline__ unsigned char zero_vec<unsigned char>() {
  return 0;
}

template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
halo_gather_kernel(const char* __restrict__ h, long long h_part_stride,
                   char* __restrict__ out, long long out_part_stride,
                   const int* __restrict__ send_idx,
                   const unsigned char* __restrict__ send_mask, int P,
                   int n_max, int B, int row_begin, int n_rows,
                   int row_bytes) {
  const int part = blockIdx.y;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;

  const int g = row_begin + r;  // row of concat(h[part], halo[part])
  const V* from = nullptr;
  if (g < n_max) {
    from = reinterpret_cast<const V*>(h + part * h_part_stride +
                                      static_cast<size_t>(g) * row_bytes);
  } else {
    const int k = g - n_max;
    const int d = k / B;  // ring distance d + 1
    const int b = k - d * B;
    const int sender = (part - d - 1 + P) % P;
    const size_t e = (static_cast<size_t>(sender) * (P - 1) + d) * B + b;
    if (send_mask[e]) {
      const int idx = min(max(send_idx[e], 0), n_max - 1);
      from = reinterpret_cast<const V*>(h + sender * h_part_stride +
                                        static_cast<size_t>(idx) * row_bytes);
    }
  }
  V* to = reinterpret_cast<V*>(out + part * out_part_stride +
                               static_cast<size_t>(r) * row_bytes);
  const int nv = row_bytes / static_cast<int>(sizeof(V));
  if (from != nullptr) {
    for (int i = lane; i < nv; i += 32) to[i] = __ldg(from + i);
  } else {
    const V z = zero_vec<V>();
    for (int i = lane; i < nv; i += 32) to[i] = z;
  }
}

template <typename V>
int launch(const void* h, long long h_part_stride, void* out,
           long long out_part_stride, const int* send_idx,
           const unsigned char* send_mask, int P, int n_max, int B,
           int row_begin, int n_rows, int row_bytes, cudaStream_t stream) {
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock, P);
  halo_gather_kernel<V><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const char*>(h), h_part_stride, static_cast<char*>(out),
      out_part_stride, send_idx, send_mask, P, n_max, B, row_begin, n_rows,
      row_bytes);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kReturnThreads = 256;
constexpr int kReturnChunk = 16384;  // bytes of a run a block copies
constexpr int kReturnInFlight = 4;   // vectors a thread loads, then stores

// one chunk of n bytes from s to t with vectors V where both are
// V-aligned; the bytes before the first aligned one and after the last
// whole vector one at a time
template <typename V>
__device__ __forceinline__ void copy_chunk(const char* __restrict__ s,
                                           char* __restrict__ t, int n) {
  constexpr int W = static_cast<int>(sizeof(V));
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(t) % W);
  const int head = min(n, (W - mis) % W);
  const int nv = (n - head) / W;
  const int tail = head + nv * W;
  const int tid = threadIdx.x;
  if (tid < head) t[tid] = s[tid];
  if (tid < n - tail) t[tail + tid] = s[tail + tid];
  const V* sv = reinterpret_cast<const V*>(s + head);
  V* tv = reinterpret_cast<V*>(t + head);
  for (int i0 = tid; i0 < nv; i0 += kReturnInFlight * kReturnThreads) {
    V v[kReturnInFlight];
#pragma unroll
    for (int j = 0; j < kReturnInFlight; ++j) {
      const int i = i0 + j * kReturnThreads;
      if (i < nv) v[j] = __ldg(sv + i);
    }
#pragma unroll
    for (int j = 0; j < kReturnInFlight; ++j) {
      const int i = i0 + j * kReturnThreads;
      if (i < nv) tv[i] = v[j];
    }
  }
}

__global__ void __launch_bounds__(kReturnThreads)
halo_return_kernel(const char* __restrict__ in, long long in_part_stride,
                   char* __restrict__ out, long long out_part_stride, int P,
                   long long run_bytes, long long chunks_per_run,
                   long long n_chunks) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const long long run = c / chunks_per_run;  // (receiver, distance)
    const long long o0 = (c - run * chunks_per_run) * kReturnChunk;
    const int n = static_cast<int>(
        min(static_cast<long long>(kReturnChunk), run_bytes - o0));
    const int r = static_cast<int>(run / (P - 1));
    const int d = static_cast<int>(run - static_cast<long long>(r) * (P - 1));
    const int sender = (r + d + 1) % P;  // ring distance d + 1
    const long long off = d * run_bytes + o0;
    const char* s = in + sender * in_part_stride + off;
    char* t = out + r * out_part_stride + off;
    // the widest vector both addresses are aligned to at once
    const unsigned rel = static_cast<unsigned>(
        (reinterpret_cast<uintptr_t>(s) - reinterpret_cast<uintptr_t>(t)) &
        15u);
    if (rel == 0)
      copy_chunk<uint4>(s, t, n);
    else if (rel % 8 == 0)
      copy_chunk<uint2>(s, t, n);
    else if (rel % 4 == 0)
      copy_chunk<unsigned int>(s, t, n);
    else if (rel % 2 == 0)
      copy_chunk<unsigned short>(s, t, n);
    else
      copy_chunk<unsigned char>(s, t, n);
  }
}

// K18's geometry: warps a block (a block a chunk of 32 kDirtyWarps
// slots), vectors of a live row a lane loads before it stores them
constexpr int kDirtyWarps = 4;
constexpr int kDirtyAhead = 16;

template <typename V>
__global__ void __launch_bounds__(kDirtyWarps * 32)
dirty_exchange_kernel(const char* __restrict__ h, long long h_part_stride,
                      char* __restrict__ halo, long long halo_part_stride,
                      const int* __restrict__ send_idx,
                      const unsigned char* __restrict__ send_mask,
                      const unsigned char* __restrict__ dirty, int P,
                      int n_max, int B, int row_bytes, long long n_slots) {
  constexpr int U = kDirtyAhead;
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long per_sender = static_cast<long long>(P - 1) * B;
  const int nv = row_bytes / static_cast<int>(sizeof(V));
  // lane l of the grid's warp g scans slot g + l G (send-list order): the
  // block's warps read neighbouring mask bytes and indices, and the warps
  // copy neighbouring rows at each step
  const long long G = static_cast<long long>(gridDim.x) * kDirtyWarps;
  const long long e = static_cast<long long>(blockIdx.x) * kDirtyWarps +
                      (threadIdx.x >> 5) + G * lane;
  // the byte offsets of a live slot's row in h and of its slot in the
  // halo (-1: not live); the dirty bit read only where the mask is on
  long long src = -1, dst = 0;
  if (e < n_slots) {
    const unsigned char on = __ldg(send_mask + e);
    const int ix = __ldg(send_idx + e);
#ifdef PGT_PLANT_K18_KEEP_LAST_SLOT
    if (on || e == n_slots - 1) {
#else
    if (on) {
#endif
      const int s = static_cast<int>(e / per_sender);
      const int i = min(max(ix, 0), n_max - 1);  // jnp.take(mode="clip")
      if (dirty[static_cast<size_t>(s) * n_max + i]) {
        const long long k = e - s * per_sender;  // the receiver's slot
        const int d = static_cast<int>(k / B);   // ring distance d + 1
        const int r = (s + d + 1) % P;
        src = s * h_part_stride + static_cast<long long>(i) * row_bytes;
        dst = r * halo_part_stride + k * row_bytes;
      }
    }
  }
  unsigned live = __ballot_sync(kFull, src >= 0);
  while (live != 0u) {
    // the next live row, lanes over its vectors, U a lane in flight,
    // cached in L2 only (a row is read once)
    const int l = __ffs(live) - 1;
    live &= live - 1u;
    const V* from = reinterpret_cast<const V*>(h + __shfl_sync(kFull, src, l));
    V* to = reinterpret_cast<V*>(halo + __shfl_sync(kFull, dst, l));
    for (int v0 = lane; v0 < nv; v0 += 32 * U) {
      V x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + 32 * u < nv) x[u] = __ldcg(from + v0 + 32 * u);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + 32 * u < nv) to[v0 + 32 * u] = x[u];
    }
  }
}

template <typename V>
int launch_dirty(const void* h, long long h_part_stride, void* halo,
                 long long halo_part_stride, const int* send_idx,
                 const unsigned char* send_mask, const unsigned char* dirty,
                 int P, int n_max, int B, int row_bytes,
                 cudaStream_t stream) {
  // a block a chunk of 32 kDirtyWarps slots
  constexpr long long kChunk = kDirtyWarps * 32LL;
  const long long n_slots = static_cast<long long>(P) * (P - 1) * B;
  const unsigned grid = static_cast<unsigned>((n_slots + kChunk - 1) /
                                              kChunk);
  dirty_exchange_kernel<V><<<grid, kDirtyWarps * 32, 0, stream>>>(
      static_cast<const char*>(h), h_part_stride, static_cast<char*>(halo),
      halo_part_stride, send_idx, send_mask, dirty, P, n_max, B, row_bytes,
      n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: P parts of n_max rows of row_bytes each, part stride h_part_stride
// bytes, rows contiguous; out: P parts of n_rows rows, part stride
// out_part_stride bytes; send_idx [P, P-1, B] int32; send_mask [P, P-1, B]
// bool (one byte each). Strides in bytes. Returns cudaGetLastError().
extern "C" int pgt_halo_gather(const void* h, long long h_part_stride,
                               void* out, long long out_part_stride,
                               const void* send_idx, const void* send_mask,
                               int P, int n_max, int B, int row_begin,
                               int n_rows, int row_bytes, void* stream) {
  if (P == 0 || n_rows == 0 || row_bytes == 0) return 0;
  if (n_max <= 0 || (row_begin + n_rows > n_max && B <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t a = reinterpret_cast<uintptr_t>(h) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(h_part_stride) |
                      static_cast<uintptr_t>(out_part_stride) |
                      static_cast<uintptr_t>(row_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* si = static_cast<const int*>(send_idx);
  const unsigned char* sm = static_cast<const unsigned char*>(send_mask);
#define PGT_LAUNCH(V)                                                    \
  return launch<V>(h, h_part_stride, out, out_part_stride, si, sm, P,    \
                   n_max, B, row_begin, n_rows, row_bytes, st)
  if (a % 16 == 0) PGT_LAUNCH(uint4);
  if (a % 8 == 0) PGT_LAUNCH(uint2);
  if (a % 4 == 0) PGT_LAUNCH(unsigned int);
  if (a % 2 == 0) PGT_LAUNCH(unsigned short);
  PGT_LAUNCH(unsigned char);
#undef PGT_LAUNCH
}

// K5. in: P parts of n_rows = (P-1)*B rows of row_bytes each, part stride
// in_part_stride bytes, rows contiguous within a part; out: the same
// layout with part stride out_part_stride. Strides in bytes. Returns
// cudaGetLastError().
extern "C" int pgt_halo_return(const void* in, long long in_part_stride,
                               void* out, long long out_part_stride, int P,
                               int B, int n_rows, int row_bytes,
                               void* stream) {
  if (P <= 1 || n_rows == 0 || row_bytes == 0) return 0;
  if (B <= 0 || n_rows != (P - 1) * B)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long run = static_cast<long long>(B) * row_bytes;
  const long long per_run = (run + kReturnChunk - 1) / kReturnChunk;
  const long long n_chunks = per_run * P * (P - 1);
  // a block a chunk (the grid-stride loop covers grids past the limit)
  const long long blocks = n_chunks < 0x7fffffffll ? n_chunks : 0x7fffffffll;
  halo_return_kernel<<<static_cast<unsigned>(blocks), kReturnThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(in), in_part_stride, static_cast<char*>(out),
      out_part_stride, P, run, per_run, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// K18. h: P parts of n_max rows of row_bytes each (the send view), part
// stride h_part_stride bytes; halo: P parts of (P-1)*B rows, part stride
// halo_part_stride bytes, updated in place; send_idx [P, P-1, B] int32;
// send_mask [P, P-1, B] and dirty [P, n_max] one byte each. Strides in
// bytes. Returns cudaGetLastError().
extern "C" int pgt_dirty_exchange(const void* h, long long h_part_stride,
                                  void* halo, long long halo_part_stride,
                                  const void* send_idx, const void* send_mask,
                                  const void* dirty, int P, int n_max, int B,
                                  int row_bytes, void* stream) {
  if (P <= 1 || B == 0 || row_bytes == 0) return 0;
  if (n_max <= 0 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t a = reinterpret_cast<uintptr_t>(h) |
                      reinterpret_cast<uintptr_t>(halo) |
                      static_cast<uintptr_t>(h_part_stride) |
                      static_cast<uintptr_t>(halo_part_stride) |
                      static_cast<uintptr_t>(row_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* si = static_cast<const int*>(send_idx);
  const unsigned char* sm = static_cast<const unsigned char*>(send_mask);
  const unsigned char* db = static_cast<const unsigned char*>(dirty);
#define PGT_LAUNCH(V)                                                     \
  return launch_dirty<V>(h, h_part_stride, halo, halo_part_stride, si, sm, \
                         db, P, n_max, B, row_bytes, st)
  if (a % 16 == 0) PGT_LAUNCH(uint4);
  if (a % 8 == 0) PGT_LAUNCH(uint2);
  if (a % 4 == 0) PGT_LAUNCH(unsigned int);
  if (a % 2 == 0) PGT_LAUNCH(unsigned short);
  PGT_LAUNCH(unsigned char);
#undef PGT_LAUNCH
}
