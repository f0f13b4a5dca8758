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
// wrapper zeroes the output). The rows form runs a warp per row, lanes
// over the row's 16-byte vectors (or words, where the row is not 16-byte
// aligned), the same reduction per (sender, distance).

#include <cuda_runtime.h>
#include <stdint.h>

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

template <int W>
__global__ void rows_kernel(const unsigned char* __restrict__ h,
                            long long part_bytes, int n_rows, int row_bytes,
                            int B, int Pm1, const int* __restrict__ idx,
                            const unsigned char* __restrict__ mask,
                            const unsigned char* __restrict__ dirty,
                            unsigned* __restrict__ out) {
  const int slot = blockIdx.y;  // s * (P - 1) + d - 1
  const int s = slot / Pm1;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32;
  const int n_words = row_bytes / W;
  unsigned s1 = 0;
  for (int b = blockIdx.x * warps + threadIdx.x / 32; b < B;
       b += gridDim.x * warps) {
    const long long k = static_cast<long long>(slot) * B + b;
    if (!mask[k]) continue;
    int i = idx[k];
    i = i < 0 ? 0 : (i >= n_rows ? n_rows - 1 : i);  // jnp.take(mode="clip")
    if (dirty != nullptr &&
        !dirty[static_cast<long long>(s) * n_rows + i])
      continue;
    const unsigned char* row = h + s * part_bytes +
                               static_cast<long long>(i) * row_bytes;
    if ((row_bytes & 15) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      const uint4* v = reinterpret_cast<const uint4*>(row);
      for (int c = lane; c < row_bytes / 16; c += 32) {
        const uint4 q = __ldg(v + c);
        const unsigned lanes[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int l = 0; l < 4; ++l)
#pragma unroll
          for (int j = 0; j < 4 / W; ++j) s1 += part_of<W>(lanes[l], j);
      }
    } else {
      for (int c = lane; c < n_words; c += 32)
        s1 += load_word<W>(row + static_cast<long long>(c) * W);
    }
  }
  s1 = warp_sum(s1);
  if (lane == 0) atomicAdd(out + slot, s1);
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
  if (n_rows <= 0 || row_bytes % W != 0 ||
      static_cast<long long>(P) * (P - 1) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(B, kThreads / 32), P * (P - 1));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* hb = static_cast<const unsigned char*>(h);
  const int* ix = static_cast<const int*>(idx);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  const unsigned char* dt = static_cast<const unsigned char*>(dirty);
  unsigned* o = static_cast<unsigned*>(out);
  switch (W) {
    case 1:
      rows_kernel<1><<<grid, kThreads, 0, st>>>(hb, part_bytes, n_rows,
                                                row_bytes, B, P - 1, ix, mk,
                                                dt, o);
      break;
    case 2:
      rows_kernel<2><<<grid, kThreads, 0, st>>>(hb, part_bytes, n_rows,
                                                row_bytes, B, P - 1, ix, mk,
                                                dt, o);
      break;
    case 4:
      rows_kernel<4><<<grid, kThreads, 0, st>>>(hb, part_bytes, n_rows,
                                                row_bytes, B, P - 1, ix, mk,
                                                dt, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
