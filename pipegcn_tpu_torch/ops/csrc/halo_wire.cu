// K14 / K15: the compressed halo wire (--halo-dtype), hand-written for
// Hopper (sm_90a).
//
// They replace: pipegcn_tpu/parallel/halo.py  _permute_compressed (with
// the amax_transport_cast of pipegcn_tpu/ops/bucket_spmm.py it calls),
// inside exchange_blocks and return_blocks, for every (part, ring
// distance) at once. On one card the P parts are stacked, so the ring's
// ppermute is a copy between parts: receiver r's distance-d block comes
// from sender s = (r - d) mod P on the exchange, (r + d) mod P on the
// return. Sender s's block at distance d is
//
//   exchange:  blk[b, :] = mask[s, d-1, b] ? x[s, clip(idx[s, d-1, b]), :]
//                                          : 0          (K2's row mapping)
//   return:    blk[b, :] = x[s, (d-1) B + b, :]        (K5's block slice)
//
// of x [P, rows, F] (f32, or bf16 bits at bf16 compute; each part's rows
// contiguous, parts part_stride elements apart).
//
// K14: amax[s, d-1] = max |blk| over [B, F] in f32 (masked rows count as
// 0), as the bits of the f32 value. Max is order-free: the bits of |v|
// are compared as unsigned ints (non-negative floats order as their bits,
// NaN above +inf, so a NaN propagates as jnp.max's does), as a running max
// in registers, reduced per warp with __reduce_max_sync, per block in
// shared memory, and merged with one atomicMax a block on its slot's word
// (zeroed by the entry point): deterministic. Why not K11: K11 reduces a
// whole part's contiguous rows; this amax is over one distance block's
// gathered send rows, and K2 + K11 per block would add a full write and
// read of every block.

// K15: for every receiver slot (r, d), from sender s's block:
//
//   fp8 (e4m3 features / e5m2 boundary gradients):
//     sc = 2^k, k = floor(log2((m / 2) / amax[s, d-1])) in f32, clamped to
//          [-126, 127], formed exactly from its exponent bits; sc = 1
//          where the amax is zero or not finite (a NaN stays a NaN, never
//          a NaN scale) — K10's pow2_scale;
//     y = satfinite_rne(v * sc)           (v widened to f32 first)
//     wire[r, d-1, b, c] = y              (the narrow payload)
//     inv[r, d-1] = 1 / sc                (the SENDER's inverse scale)
//     out[r, (d-1) B + b, c] = cast(f32(y) * inv)   (compute dtype)
//   bf16: y = rne_bf16(v) (the bits as they are for bf16 rows), no
//         scale; out = cast(f32(y)).
//
// The rounding is K10's: f32 subnormals go to a signed zero first, then
// __nv_cvt_float_to_fp8(SATFINITE) rounds to nearest even and saturates
// (JAX's clip-then-cast); bf16 by torch's round-to-nearest-even formula.
// The decode multiplies by an exact power of two and rounds once to the
// compute dtype, as the plain version does: bit-exact against it (a NaN
// equal to any NaN: the kernel and torch write different NaN patterns).
// The wire buffer is kept, although one card needs none: it is the
// payload a multi-card run ships, and its bytes are the ones
// est_halo_bytes_per_epoch counts.
//
// What bounds both on the H100: bytes. K14 reads every sent element once
// (and an index a row); K15 reads it once more and writes the payload
// (1 B fp8, 2 B bf16) and the decoded row (4 B f32, 2 B bf16); a few ops
// an element. Both take vectors of VEC elements: 16 bytes of x where F,
// the part stride and the pointers allow it (8 bf16 or 4 f32), the
// widest width they all agree on otherwise, one width a launch, chosen by
// the wrapper (halo.k14_vec, halo.k15_vec), so no row needs a head or a
// tail. K15's design: a warp owns kWireRows rows of one slot block, a
// block kWireWarps warps, a block a chunk of consecutive rows (gridDim.x
// chunks, gridDim.y the slots). Lanes j < kWireRows read row j's send
// index and mask once and shuffle its source offset to the warp; each
// lane then takes one vector of each of the rows at a time, issues the
// rows' loads before their converts, and writes the payload as one
// VEC-element word (8 or 4 bytes of fp8) and the decoded values as one
// store. K14 (was: a block of 256 threads per run of rows, a thread a
// column, 2-byte loads, an atomicMax a warp): the exchange reads K15's
// rows (a warp kWireRows rows at a time, each row's index and mask read
// once, a masked row never read, the rows' loads issued before their
// maxes) in one wave of blocks spread over the P (P - 1) slot blocks, the
// warps grid-strided over the rows; the return's block ((d-1) B .. d B of
// the sender's part) is one contiguous slab, a block a chunk of kThreads
// x kAmaxAhead vectors (8 KB at 16-byte vectors), every load of the
// chunk issued before the maxes (the exchange's rows in a block a chunk
// ran 3 % slower; the return in one wave tied, and 2 vectors a thread ran
// 3 % faster than 4: PERF.md's K14 design table).

#include "transport.cuh"

namespace {

constexpr int kThreads = 256;

// sender s's row b of its distance-d block (d1 = d - 1): the element
// offset of its first value in x, or -1 for a masked row (zeros)
__device__ __forceinline__ long long src_row(
    int s, int d1, int b, int Pm1, long long part_stride, int n_rows, int F,
    int B, const int* send_idx, const unsigned char* send_mask) {
  const long long base = static_cast<long long>(s) * part_stride;
  if (send_idx == nullptr)
    return base + static_cast<long long>(d1 * B + b) * F;
  const size_t k = (static_cast<size_t>(s) * Pm1 + d1) * B + b;
  if (!send_mask[k]) return -1;
  int i = send_idx[k];
  i = i < 0 ? 0 : (i >= n_rows ? n_rows - 1 : i);  // jnp.take(mode="clip")
  return base + static_cast<long long>(i) * F;
}

// K15's geometry (and K14's exchange): warps a block, rows a warp
// stepped together
constexpr int kWireWarps = 8;
constexpr int kWireRows = 4;
// K14's return: vectors in flight a thread
constexpr int kAmaxAhead = 2;

// the running max of |v|'s bits over the VEC elements of NB bytes of x
// held as words (bf16 bits when XB)
template <bool XB, int NB>
__device__ __forceinline__ unsigned int words_max(const unsigned int* w,
                                                  unsigned int best) {
#pragma unroll
  for (int k = 0; k < (NB + 3) / 4; ++k) {
    if constexpr (XB) {
      // |v| of a widened bf16 is its bits shifted up, sign cleared
      best = max(best, (w[k] << 16) & 0x7fff0000u);
      if constexpr (NB >= 4) best = max(best, w[k] & 0x7fff0000u);
    } else {
      best = max(best, w[k] & 0x7fffffffu);
    }
  }
  return best;
}

// the block's max merged into its slot's word: a warp max, the warps'
// maxima in shared memory, one atomicMax a block (none for a zero max)
__device__ __forceinline__ void block_max(unsigned int best,
                                          unsigned int* word) {
  __shared__ unsigned int warp_max[kThreads / 32];
  best = __reduce_max_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) best = max(best, warp_max[i]);
    if (best != 0u) atomicMax(word, best);
  }
}

// K14 on the exchange: slot block blockIdx.y = s (P - 1) + d - 1, its rows
// kWireRows a warp at a time (the warps grid-strided over them), each
// lane a vector of NB bytes of each row at a time
template <bool XB, int NB>
__global__ void __launch_bounds__(kThreads)
exchange_amax_kernel(const void* __restrict__ x, long long part_stride,
                     int P, int n_rows, int F, int B,
                     const int* __restrict__ send_idx,
                     const unsigned char* __restrict__ send_mask,
                     unsigned int* __restrict__ amax) {
  static_assert(kThreads == kWireWarps * 32, "a block of kWireWarps warps");
  constexpr int XS = XB ? 2 : 4, VEC = NB / XS, XW = (NB + 3) / 4;
  constexpr int R = kWireRows;
  const int Pm1 = P - 1;
  const int s = blockIdx.y / Pm1, d1 = blockIdx.y % Pm1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = F / VEC;
  const char* xc = static_cast<const char*>(x);
  unsigned int best = 0u;
  for (int b0 = (blockIdx.x * kWireWarps + warp) * R; b0 < B;
       b0 += gridDim.x * kWireWarps * R) {
    // lane j < R: row b0 + j's first element in x (-1: a masked row or
    // one past the block, never read)
    long long mine = -1;
    if (lane < R && b0 + lane < B)
      mine = src_row(s, d1, b0 + lane, Pm1, part_stride, n_rows, F, B,
                     send_idx, send_mask);
    long long row[R];
#pragma unroll
    for (int j = 0; j < R; ++j) row[j] = __shfl_sync(0xffffffffu, mine, j);
    for (int v = lane; v < nvec; v += 32) {
      unsigned int raw[R][XW];
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (row[j] >= 0)
          load_words<NB>(xc + (row[j] + static_cast<long long>(v) * VEC) *
                                  XS, raw[j]);
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (row[j] >= 0) best = words_max<XB, NB>(raw[j], best);
    }
  }
  block_max(best, amax + blockIdx.y);
}

// K14 on the return: chunk blockIdx.x of slot block blockIdx.y's B x F
// elements, one contiguous slab of n_vec vectors of NB bytes
template <bool XB, int NB>
__global__ void __launch_bounds__(kThreads)
return_amax_kernel(const void* __restrict__ x, long long part_stride, int P,
                   long long n_vec, unsigned int* __restrict__ amax) {
  constexpr int XS = XB ? 2 : 4, XW = (NB + 3) / 4;
  constexpr long long kChunk = static_cast<long long>(kThreads) * kAmaxAhead;
  const int Pm1 = P - 1;
  const int s = blockIdx.y / Pm1, d1 = blockIdx.y % Pm1;
  const char* xp = static_cast<const char*>(x) + s * part_stride * XS +
                   d1 * n_vec * NB;
  const long long c = blockIdx.x * kChunk + threadIdx.x;
  unsigned int w[kAmaxAhead][XW];
#pragma unroll
  for (int i = 0; i < kAmaxAhead; ++i)
    if (c + i * kThreads < n_vec)
      load_words<NB>(xp + (c + i * kThreads) * NB, w[i]);
  unsigned int best = 0u;
#pragma unroll
  for (int i = 0; i < kAmaxAhead; ++i)
    if (c + i * kThreads < n_vec) best = words_max<XB, NB>(w[i], best);
  block_max(best, amax + blockIdx.y);
}

template <bool XB, int NB>
int amax_launch(const void* x, long long part_stride, int P, int n_rows,
                int F, int B, const int* si, const unsigned char* sm,
                unsigned int* am, cudaStream_t st) {
  const int slots = P * (P - 1);
  if (si != nullptr) {
    static const int per_sm =
        occupancy(exchange_amax_kernel<XB, NB>, kThreads);
    constexpr int kChunk = kWireWarps * kWireRows;
    const dim3 grid(one_wave(per_sm, slots, (B + kChunk - 1) / kChunk),
                    slots);
    exchange_amax_kernel<XB, NB><<<grid, kThreads, 0, st>>>(
        x, part_stride, P, n_rows, F, B, si, sm, am);
  } else {
    // a block a chunk of each slot block (no loop, no occupancy query)
    const long long n_vec =
        static_cast<long long>(B) * F / (NB / (XB ? 2 : 4));
    const long long chunk = static_cast<long long>(kThreads) * kAmaxAhead;
    const dim3 grid(static_cast<unsigned>((n_vec + chunk - 1) / chunk),
                    slots);
    return_amax_kernel<XB, NB><<<grid, kThreads, 0, st>>>(x, part_stride, P,
                                                          n_vec, am);
  }
  return static_cast<int>(cudaGetLastError());
}

// W the wire type, XB x (and out) in bf16 bits (else f32), VEC elements a
// vector: F, the part stride and x, wire and out are VEC-element aligned
template <int W, int XB, int VEC>
__global__ void __launch_bounds__(kWireWarps * 32)
wire_kernel(const void* __restrict__ x, long long part_stride, int P,
            int n_rows, int F, int B, const int* __restrict__ send_idx,
            const unsigned char* __restrict__ send_mask,
            const unsigned int* __restrict__ amax, float m,
            void* __restrict__ wire, float* __restrict__ inv,
            void* __restrict__ out) {
  constexpr int XS = XB ? 2 : 4, WS = W == kOutBF16 ? 2 : 1;
  constexpr int XV = VEC * XS, WV = VEC * WS;
  constexpr int XW = (XV + 3) / 4, WW = (WV + 3) / 4;
  constexpr int R = kWireRows;
  constexpr unsigned kFull = 0xffffffffu;
  const int Pm1 = P - 1;
  const int r = blockIdx.y / Pm1, d1 = blockIdx.y % Pm1;
  const int d = d1 + 1;
  const bool exchange = send_idx != nullptr;
  const int s = exchange ? (r - d + P) % P : (r + d) % P;
  float sc = 1.0f, is = 1.0f;
  if constexpr (W != kOutBF16) {
    sc = pow2_scale(amax[s * Pm1 + d1], m);
    is = 1.0f / sc;
    if (blockIdx.x == 0 && threadIdx.x == 0) inv[blockIdx.y] = is;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = F / VEC;
  const char* xc = static_cast<const char*>(x);
  char* wc = static_cast<char*>(wire);
  char* oc = static_cast<char*>(out);
  for (int b0 = (blockIdx.x * kWireWarps + warp) * R; b0 < B;
       b0 += gridDim.x * kWireWarps * R) {
    // lane j < R: row b0 + j's first element in x (-1: a masked row,
    // zeros; -2: past the block)
    long long mine = -2;
    if (lane < R && b0 + lane < B)
      mine = src_row(s, d1, b0 + lane, Pm1, part_stride, n_rows, F, B,
                     send_idx, send_mask);
    long long row[R];
#pragma unroll
    for (int j = 0; j < R; ++j) row[j] = __shfl_sync(kFull, mine, j);
    const size_t w0 = (static_cast<size_t>(blockIdx.y) * B + b0) * F;
    const size_t o0 = ((static_cast<size_t>(r) * Pm1 + d1) * B + b0) * F;
    for (int v = lane; v < nvec; v += 32) {
      unsigned int raw[R][XW];
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int k = 0; k < XW; ++k) raw[j][k] = 0u;
        if (row[j] >= 0)
          load_words<XV>(xc + (row[j] + static_cast<long long>(v) * VEC) *
                                  XS, raw[j]);
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (row[j] == -2) continue;
        unsigned int wv[WW], ov[XW];
#pragma unroll
        for (int k = 0; k < WW; ++k) wv[k] = 0u;
#pragma unroll
        for (int k = 0; k < XW; ++k) ov[k] = 0u;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          // element k as f32 (bf16 rows: its bits in b16)
          unsigned int b16 = 0u;
          float xv;
          if constexpr (XB) {
            b16 = (raw[j][k / 2] >> (16 * (k & 1))) & 0xffffu;
            xv = __uint_as_float(b16 << 16);
          } else {
            xv = __uint_as_float(raw[j][k]);
          }
          if constexpr (W == kOutBF16) {
            // bf16 rows: the payload is their bits (a masked row's 0)
            const unsigned int q = XB ? b16 : to_bf16(xv);
            wv[k / 2] |= q << (16 * (k & 1));
            if constexpr (XB)
              ov[k / 2] |= q << (16 * (k & 1));
            else
              ov[k] = q << 16;
          } else {
            const unsigned int q = to_fp8<W>(xv * sc);
            wv[k / 4] |= q << (8 * (k & 3));
            const float y = from_fp8<W>(static_cast<unsigned char>(q)) * is;
            if constexpr (XB)
              ov[k / 2] |= static_cast<unsigned int>(to_bf16(y))
                           << (16 * (k & 1));
            else
              ov[k] = __float_as_uint(y);
          }
        }
        const size_t e = static_cast<size_t>(j) * F +
                         static_cast<size_t>(v) * VEC;
        store_words<WV>(wc + (w0 + e) * WS, wv);
        store_words<XV>(oc + (o0 + e) * XS, ov);
      }
    }
  }
}

// K15's blocks along a slot block: a block a chunk of kWireWarps *
// kWireRows rows
int wire_blocks(int B) {
  constexpr int kChunk = kWireWarps * kWireRows;
  return (B + kChunk - 1) / kChunk;
}

template <int W, int XB>
int wire_launch(int vec, dim3 grid, cudaStream_t st, const void* x,
                long long part_stride, int P, int n_rows, int F, int B,
                const int* si, const unsigned char* sm,
                const unsigned int* am, float m, void* wire, float* iv,
                void* out) {
#define PGT_K15(VEC)                                                     \
  wire_kernel<W, XB, VEC><<<grid, kWireWarps * 32, 0, st>>>(             \
      x, part_stride, P, n_rows, F, B, si, sm, am, m, wire, iv, out);    \
  break
  switch (vec) {
    case 1: PGT_K15(1);
    case 2: PGT_K15(2);
    case 4: PGT_K15(4);
    default:
      if constexpr (XB) {
        PGT_K15(8);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
  }
#undef PGT_K15
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K14. x: P parts of n_rows rows of F (f32, or bf16 bits when x_bf16),
// part_stride elements apart, each part's rows contiguous; B rows a
// block; send_idx [P, P-1, B] int32 and send_mask [P, P-1, B] bytes (the
// exchange), or both null (the return: x's blocks (d-1) B .. d B); amax
// [P, P-1] uint32 receives the f32 bits of each sender block's max
// |value| (zeroed here first); vec the elements a vector (1, 2, 4, or 8
// for bf16 rows; at most 16 bytes of x), dividing F and the part stride,
// x aligned to it. On the device. Returns the first CUDA error (the
// memset's, the launch's), or cudaErrorInvalidValue for a vector the
// arguments do not allow.
extern "C" int pgt_halo_amax(const void* x, int x_bf16, long long part_stride,
                             int P, int n_rows, int F, int B,
                             const void* send_idx, const void* send_mask,
                             void* amax, int vec, void* stream) {
  if (P < 2) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t z = cudaMemsetAsync(
      amax, 0, static_cast<size_t>(P) * (P - 1) * sizeof(unsigned int), st);
  if (z != cudaSuccess || B == 0 || F == 0) return static_cast<int>(z);
  const int nb = vec * (x_bf16 ? 2 : 4);
  if ((send_idx == nullptr) != (send_mask == nullptr) || vec < 1 ||
      (vec & (vec - 1)) != 0 || nb > 16 || F % vec != 0 ||
      part_stride % vec != 0 || reinterpret_cast<uintptr_t>(x) % nb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* si = static_cast<const int*>(send_idx);
  const unsigned char* sm = static_cast<const unsigned char*>(send_mask);
  unsigned int* am = static_cast<unsigned int*>(amax);
#define PGT_K14(XB, NB) \
  return amax_launch<XB, NB>(x, part_stride, P, n_rows, F, B, si, sm, am, st)
  if (x_bf16) {
    switch (nb) {
      case 16: PGT_K14(true, 16);
      case 8: PGT_K14(true, 8);
      case 4: PGT_K14(true, 4);
      default: PGT_K14(true, 2);
    }
  }
  switch (nb) {
    case 16: PGT_K14(false, 16);
    case 8: PGT_K14(false, 8);
    default: PGT_K14(false, 4);
  }
#undef PGT_K14
}

// K15. x, part_stride, P, n_rows, F, B, send_idx, send_mask as K14's;
// amax [P, P-1] uint32 (K14's output; null for the bf16 wire); wire_type
// 0 bf16, 1 e4m3fn, 2 e5m2; m the fp8 finite max (ignored for bf16); wire
// [P, P-1, B, F] of wire_type (receiver order); inv [P, P-1] f32 (the
// sender's inverse scale at each receiver slot; written for fp8); out
// [P, (P-1) B, F] f32 (bf16 bits when x_bf16), contiguous; vec the
// elements a vector (1, 2, 4, or 8 for bf16 rows; at most 16 bytes of
// x), dividing F and the part stride, x, wire and out aligned to it. On
// the device. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// vector the arguments do not allow.
extern "C" int pgt_halo_wire(const void* x, int x_bf16, long long part_stride,
                             int P, int n_rows, int F, int B,
                             const void* send_idx, const void* send_mask,
                             const void* amax, int wire_type, float m,
                             void* wire, void* inv, void* out, int vec,
                             void* stream) {
  if (P < 2 || B == 0 || F == 0) return 0;
  const int xs = x_bf16 ? 2 : 4, ws = wire_type == kOutBF16 ? 2 : 1;
  auto al = [](const void* p, long long n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if ((send_idx == nullptr) != (send_mask == nullptr) ||
      (wire_type != kOutBF16 && (amax == nullptr || inv == nullptr)) ||
      vec < 1 || (vec & (vec - 1)) != 0 || vec * xs > 16 || F % vec != 0 ||
      part_stride % vec != 0 || !al(x, vec * xs) || !al(out, vec * xs) ||
      !al(wire, vec * ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(wire_blocks(B), P * (P - 1));
  const int* si = static_cast<const int*>(send_idx);
  const unsigned char* sm = static_cast<const unsigned char*>(send_mask);
  const unsigned int* am = static_cast<const unsigned int*>(amax);
  float* iv = static_cast<float*>(inv);
#define PGT_WIRE(W)                                                      \
  return x_bf16 ? wire_launch<W, 1>(vec, grid, st, x, part_stride, P,    \
                                    n_rows, F, B, si, sm, am, m, wire,   \
                                    iv, out)                             \
                : wire_launch<W, 0>(vec, grid, st, x, part_stride, P,    \
                                    n_rows, F, B, si, sm, am, m, wire,   \
                                    iv, out)
  switch (wire_type) {
    case kOutBF16: PGT_WIRE(kOutBF16);
    case kOutE4M3: PGT_WIRE(kOutE4M3);
    case kOutE5M2: PGT_WIRE(kOutE5M2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PGT_WIRE
}
