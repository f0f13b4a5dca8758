// K19: the integrity plane's bit digests, hand-written for Hopper (sm_90a).
//
// It replaces: pipegcn_tpu/resilience/integrity.py  device_digest (applied
// per leaf by digest_tree and per leading index by shard_digests, a vmap),
// and pipegcn_tpu/parallel/halo.py  wire_sum (the checksum lane of
// _permute_compressed(guard=True)). No kernel of the port computes an
// integer reduction, and PyTorch has no uint32 arithmetic on CUDA.
//
// Every element of a tensor is read as its raw bits, zero-extended to u32
// (1- and 2-byte dtypes per element; 8-byte dtypes as two u32 halves, low
// half first, so they enter as twice the count of 4-byte words). Over the
// n words u_i of one range the digest is
//
//   s1 = sum u_i,   s2 = sum u_i * (2i + 1)       (mod 2^32)
//
// the weight 2i + 1 formed in u32 (it wraps for i >= 2^31, as JAX's uint32
// arange does). Integer wraparound addition commutes and associates, so
// the result is BIT-IDENTICAL ON EVERY RUN WHATEVER THE ORDER the threads
// and the atomics add in, and equals the numpy host_digest of the same
// bytes. One flipped bit moves s1 by +-2^k != 0 (mod 2^32): detection of
// the one-flip fault model is certain.
//
// Two forms, one launch each:
//   ranges  [R, 2]: (s1, s2) of each of R ranges of n words, range
//           y = part * n_inner + j at part * outer_bytes + j * inner_bytes
//           (a flat tensor is R = 1; shard_digests' per-part form n_inner
//           = 1, the index i restarting at 0 in each part as under vmap;
//           the halo's (part, distance) blocks n_inner = P - 1);
//   rows    [P, P-1]: s1 over the rows h[s][clip(idx[s, d-1, b])] with
//           mask[s, d-1, b] on (and, given, dirty[s][row] on) — the
//           sender side of the wire lane, taken where the payload is
//           formed, since on one card K2 and K18 never materialize it.
//
// What bounds it on the H100: bytes. Each input byte is read once; a few
// integer ops a word. Design: a grid-stride loop over 16-byte vectors of
// the range (its unaligned head and tail word by word), each vector
// widened to its 16 / W words; the two u32 sums reduced by warp shuffles
// and added to the output with one atomicAdd per warp and sum (the
// wrapper zeroes the output). The rows form: one wave of blocks spread
// over the P (P - 1) (sender, distance) blocks, kRowsWarps warps a block
// striding over the block's slots, a warp 32 consecutive slots at a time.
// Lane i loads slot i's mask byte and index together, clips the index and,
// where the mask is on and bits are given, reads the owner row's dirty
// bit; a ballot gives the live rows, which the warp sums kRowsRows at a
// time, each row's offset shuffled from the lane that scanned it, lanes
// over the row's vectors, every load of those rows issued before the
// adds. The vector is the widest (16, 8, 4, 2 or 1 bytes, never narrower
// than a word) that the row size, the part stride and the pointer allow,
// one a launch, so no row has a head or a tail. The per-warp shuffle
// reduction and an atomicAdd a warp close it. PERF.md's K19 rows-form
// entries have the measured alternatives. PGT_PLANT_K19_ROW_TWICE (never
// set by the build) plants a fault for chip_smoke.py: a group of rows
// that is not full takes its first row again, which is summed twice.

#include <stdint.h>

#include "transport.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;  // 8 CTAs of 256 threads on 132 SMs

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int W>
__device__ __forceinline__ unsigned load_word(const unsigned char* p) {
  if constexpr (W == 1) return *p;
  if constexpr (W == 2) return *reinterpret_cast<const unsigned short*>(p);
  return *reinterpret_cast<const unsigned int*>(p);
}

// the k-th W-byte word of a 32-bit lane of a vector, zero-extended
template <int W>
__device__ __forceinline__ unsigned part_of(unsigned v, int k) {
  if constexpr (W == 1) return (v >> (8 * k)) & 0xffu;
  if constexpr (W == 2) return (v >> (16 * k)) & 0xffffu;
  return v;
}

template <int W>
__global__ void ranges_kernel(const unsigned char* __restrict__ base,
                              long long outer_bytes, long long inner_bytes,
                              int n_inner, long long n,
                              unsigned* __restrict__ out) {
  constexpr int E = 16 / W;  // words a vector
  const int y = blockIdx.y;
  const unsigned char* x = base + (y / n_inner) * outer_bytes +
                           static_cast<long long>(y % n_inner) * inner_bytes;
  long long head = static_cast<long long>(
                       (16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / W;
  if (head > n) head = n;
  const long long nvec = (n - head) / E;
  const long long tail = head + nvec * E;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned s1 = 0, s2 = 0;
  for (long long i = t0; i < head; i += stride) {
    const unsigned u = load_word<W>(x + i * W);
    s1 += u;
    s2 += u * (2u * static_cast<unsigned>(i) + 1u);
  }
  for (long long i = tail + t0; i < n; i += stride) {
    const unsigned u = load_word<W>(x + i * W);
    s1 += u;
    s2 += u * (2u * static_cast<unsigned>(i) + 1u);
  }
  const uint4* v = reinterpret_cast<const uint4*>(x + head * W);
  for (long long k = t0; k < nvec; k += stride) {
    const uint4 q = __ldg(v + k);
    const unsigned lanes[4] = {q.x, q.y, q.z, q.w};
    // weight of word j: 2 (i0 + j) + 1, in u32
    unsigned w = 2u * static_cast<unsigned>(head + k * E) + 1u;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
#pragma unroll
      for (int c = 0; c < 4 / W; ++c) {
        const unsigned u = part_of<W>(lanes[l], c);
        s1 += u;
        s2 += u * w;
        w += 2u;
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(out + 2 * y, s1);
    atomicAdd(out + 2 * y + 1, s2);
  }
}

// the rows form's geometry: warps a block, live rows a warp sums at a time
constexpr int kRowsWarps = 8;
constexpr int kRowsRows = 8;

// the sum of the W-byte words of NB bytes held as 32-bit words (NB < 4:
// the low bytes of w[0], the rest zero)
template <int W, int NB>
__device__ __forceinline__ unsigned words_sum(const unsigned* w) {
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < (NB + 3) / 4; ++k)
#pragma unroll
    for (int c = 0; c < 4 / W; ++c) s += part_of<W>(w[k], c);
  return s;
}

// W the word, NB the bytes of a vector (NB >= W; row_bytes, part_bytes and
// h aligned to NB)
template <int W, int NB>
__global__ void __launch_bounds__(kRowsWarps * 32)
rows_kernel(const unsigned char* __restrict__ h, long long part_bytes,
            int n_rows, int row_bytes, int B, int Pm1,
            const int* __restrict__ idx,
            const unsigned char* __restrict__ mask,
            const unsigned char* __restrict__ dirty,
            unsigned* __restrict__ out) {
  constexpr int R = kRowsRows, XW = (NB + 3) / 4;
  constexpr unsigned kFull = 0xffffffffu;
  const int slot = blockIdx.y;  // s * (P - 1) + d - 1
  const int s = slot / Pm1;
  const int lane = threadIdx.x & 31;
  const int nv = row_bytes / NB;
  const unsigned char* hs = h + s * part_bytes;
  const long long k0 = static_cast<long long>(slot) * B;
  unsigned s1 = 0;
  for (int b0 = (blockIdx.x * kRowsWarps + (threadIdx.x >> 5)) * 32; b0 < B;
       b0 += gridDim.x * kRowsWarps * 32) {
    // lane's slot b0 + lane: its row's byte offset in the part, or -1
    const int b = b0 + lane;
    long long row = -1;
    if (b < B) {
      const unsigned char on = __ldg(mask + k0 + b);
      int i = __ldg(idx + k0 + b);
      i = i < 0 ? 0 : (i >= n_rows ? n_rows - 1 : i);  // take(mode="clip")
      if (on && (dirty == nullptr ||
                 dirty[static_cast<long long>(s) * n_rows + i]))
        row = static_cast<long long>(i) * row_bytes;
    }
    unsigned live = __ballot_sync(kFull, row >= 0);
    while (live != 0u) {
      // the next R live rows of the 32 slots (-1: none)
      long long r[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        r[q] = -1;
        if (live != 0u) {
          const int l = __ffs(live) - 1;
          live &= live - 1u;
          r[q] = __shfl_sync(kFull, row, l);
        }
#ifdef PGT_PLANT_K19_ROW_TWICE
        if (q == R - 1 && r[q] < 0) r[q] = r[0];
#endif
      }
      for (int v = lane; v < nv; v += 32) {
        unsigned w[R][XW];
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (r[q] >= 0)
            load_words<NB>(hs + r[q] + static_cast<long long>(v) * NB, w[q]);
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (r[q] >= 0) s1 += words_sum<W, NB>(w[q]);
      }
    }
  }
  s1 = warp_sum(s1);
  if (lane == 0) atomicAdd(out + slot, s1);
}

template <int W, int NB>
void rows_launch(const unsigned char* h, long long part_bytes, int P,
                 int n_rows, int row_bytes, int B, const int* idx,
                 const unsigned char* mask, const unsigned char* dirty,
                 unsigned* out, cudaStream_t st) {
  static const int per_sm = occupancy(rows_kernel<W, NB>, kRowsWarps * 32);
  const int slots = P * (P - 1);
  constexpr int kChunk = kRowsWarps * 32;
  const dim3 grid(one_wave(per_sm, slots, (B + kChunk - 1) / kChunk),
                  slots);
  rows_kernel<W, NB><<<grid, kRowsWarps * 32, 0, st>>>(
      h, part_bytes, n_rows, row_bytes, B, P - 1, idx, mask, dirty, out);
}

// the rows form with the widest vector of NB >= W bytes that the
// pointer, the part stride and the row size allow
template <int W>
void rows_dispatch(const unsigned char* h, long long part_bytes, int P,
                   int n_rows, int row_bytes, int B, const int* idx,
                   const unsigned char* mask, const unsigned char* dirty,
                   unsigned* out, cudaStream_t st) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(h) |
                      static_cast<uintptr_t>(part_bytes) |
                      static_cast<uintptr_t>(row_bytes);
#define PGT_ROWS(NB)                                                       \
  return rows_launch<W, NB>(h, part_bytes, P, n_rows, row_bytes, B, idx,   \
                            mask, dirty, out, st)
  if (a % 16 == 0) PGT_ROWS(16);
  if (a % 8 == 0) PGT_ROWS(8);
  if constexpr (W < 4) {
    if (a % 4 == 0) PGT_ROWS(4);
  }
  if constexpr (W < 2) {
    if (a % 2 == 0) PGT_ROWS(2);
  }
  PGT_ROWS(W);  // the entry holds h and the strides to words
#undef PGT_ROWS
}

int blocks_for(long long work, int per_block) {
  long long b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// ranges form. x: the first range's bytes; R = n_outer * n_inner ranges
// of n words of W bytes (W in 1, 2, 4), range y at (y / n_inner) *
// outer_bytes + (y % n_inner) * inner_bytes, each W-byte aligned.
// out [R, 2] u32, zeroed. On the device. Returns cudaGetLastError().
extern "C" int pgt_digest_ranges(const void* x, long long outer_bytes,
                                 long long inner_bytes, int n_outer,
                                 int n_inner, long long n, int W, void* out,
                                 void* stream) {
  if (n_outer == 0 || n_inner == 0 || n == 0) return 0;
  if (n_outer < 0 || n_inner < 0 || n < 0 ||
      static_cast<long long>(n_outer) * n_inner > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(n / (16 / W), kThreads), n_outer * n_inner);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* b = static_cast<const unsigned char*>(x);
  unsigned* o = static_cast<unsigned*>(out);
  switch (W) {
    case 1:
      ranges_kernel<1><<<grid, kThreads, 0, st>>>(b, outer_bytes, inner_bytes,
                                                   n_inner, n, o);
      break;
    case 2:
      ranges_kernel<2><<<grid, kThreads, 0, st>>>(b, outer_bytes, inner_bytes,
                                                   n_inner, n, o);
      break;
    case 4:
      ranges_kernel<4><<<grid, kThreads, 0, st>>>(b, outer_bytes, inner_bytes,
                                                   n_inner, n, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows form. h [P, n_rows, row_bytes / W words] (each part's rows
// contiguous, parts part_bytes apart, W-byte aligned); idx [P, P-1, B]
// int32, mask [P, P-1, B] bool (one byte), dirty [P, n_rows] bool or null;
// out [P, P-1] u32, zeroed. On the device. Returns cudaGetLastError().
extern "C" int pgt_digest_rows(const void* h, long long part_bytes, int P,
                               int n_rows, int row_bytes, int W, int B,
                               const void* idx, const void* mask,
                               const void* dirty, void* out, void* stream) {
  if (P < 2 || B == 0 || row_bytes == 0) return 0;
  if (n_rows <= 0 || (W != 1 && W != 2 && W != 4) || row_bytes % W != 0 ||
      part_bytes % W != 0 || reinterpret_cast<uintptr_t>(h) % W != 0 ||
      static_cast<long long>(P) * (P - 1) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* hb = static_cast<const unsigned char*>(h);
  const int* ix = static_cast<const int*>(idx);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  const unsigned char* dt = static_cast<const unsigned char*>(dirty);
  unsigned* o = static_cast<unsigned*>(out);
  switch (W) {
    case 1:
      rows_dispatch<1>(hb, part_bytes, P, n_rows, row_bytes, B, ix, mk, dt,
                       o, st);
      break;
    case 2:
      rows_dispatch<2>(hb, part_bytes, P, n_rows, row_bytes, B, ix, mk, dt,
                       o, st);
      break;
    case 4:
      rows_dispatch<4>(hb, part_bytes, P, n_rows, row_bytes, B, ix, mk, dt,
                       o, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
