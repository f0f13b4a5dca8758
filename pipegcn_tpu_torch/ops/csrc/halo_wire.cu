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
// NaN above +inf, so a NaN propagates as jnp.max's does), reduced per warp
// with __reduce_max_sync and merged with atomicMax on the block's word
// (zeroed by the wrapper): deterministic. Why not K11: K11 reduces a
// whole part's contiguous rows; this amax is over one distance block's
// gathered send rows, and K2 + K11 per block would add a full write and
// read of every block.
//
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
// an element. Design, as K10 / K11: a block of 256 threads per run of
// rows of one (slot) block (grid-strided over the rows), threads over the
// columns, so loads and stores are coalesced and the row's index and mask
// are one broadcast load each; every (part, distance) in one launch
// (gridDim.y = P (P - 1)).

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

__global__ void __launch_bounds__(kThreads)
amax_kernel(const void* __restrict__ x, int x_bf16, long long part_stride,
            int P, int n_rows, int F, int B, const int* __restrict__ send_idx,
            const unsigned char* __restrict__ send_mask,
            unsigned int* __restrict__ amax) {
  const int Pm1 = P - 1;
  const int s = blockIdx.y / Pm1, d1 = blockIdx.y % Pm1;
  unsigned int best = 0u;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const long long row = src_row(s, d1, b, Pm1, part_stride, n_rows, F,
                                  B, send_idx, send_mask);
    if (row < 0) continue;  // a masked row: |0| never raises the max
    const size_t r0 = static_cast<size_t>(row);
    for (int c = threadIdx.x; c < F; c += blockDim.x)
      best = max(best, __float_as_uint(load(x, r0 + c, x_bf16)) &
                           0x7fffffffu);
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0 && best != 0u) atomicMax(amax + blockIdx.y, best);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
wire_kernel(const void* __restrict__ x, int x_bf16, long long part_stride,
            int P, int n_rows, int F, int B, const int* __restrict__ send_idx,
            const unsigned char* __restrict__ send_mask,
            const unsigned int* __restrict__ amax, float m,
            void* __restrict__ wire, float* __restrict__ inv,
            void* __restrict__ out) {
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
  const size_t slot0 = static_cast<size_t>(blockIdx.y) * B;   // wire rows
  const size_t out0 =
      static_cast<size_t>(r) * Pm1 * B + static_cast<size_t>(d1) * B;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const long long row = src_row(s, d1, b, Pm1, part_stride, n_rows, F,
                                  B, send_idx, send_mask);
    const size_t r0 = static_cast<size_t>(row < 0 ? 0 : row);
    const size_t w0 = (slot0 + b) * F;
    const size_t o0 = (out0 + b) * F;
    for (int c = threadIdx.x; c < F; c += blockDim.x) {
      if constexpr (W == kOutBF16) {
        unsigned short q;
        if (row < 0)
          q = 0;
        else if (x_bf16)  // bf16 rows: the payload is their bits
          q = static_cast<const unsigned short*>(x)[r0 + c];
        else
          q = to_bf16(static_cast<const float*>(x)[r0 + c]);
        static_cast<unsigned short*>(wire)[w0 + c] = q;
        if (x_bf16)
          static_cast<unsigned short*>(out)[o0 + c] = q;
        else
          static_cast<float*>(out)[o0 + c] =
              __uint_as_float(static_cast<unsigned int>(q) << 16);
      } else {
        const float v = row < 0 ? 0.0f : load(x, r0 + c, x_bf16);
        const unsigned char q = to_fp8<W>(v * sc);
        static_cast<unsigned char*>(wire)[w0 + c] = q;
        const float y = from_fp8<W>(q) * is;
        if (x_bf16)
          static_cast<unsigned short*>(out)[o0 + c] = to_bf16(y);
        else
          static_cast<float*>(out)[o0 + c] = y;
      }
    }
  }
}

int blocks_for(int rows) {
  return rows < 2048 ? (rows > 0 ? rows : 1) : 2048;
}

}  // namespace

// K14. x: P parts of n_rows rows of F (f32, or bf16 bits when x_bf16),
// part_stride elements apart, each part's rows contiguous; B rows a
// block; send_idx [P, P-1, B] int32 and send_mask [P, P-1, B] bytes (the
// exchange), or both null (the return: x's blocks (d-1) B .. d B); amax
// [P, P-1] uint32, zeroed by the caller, receives the f32 bits of each
// sender block's max |value|. On the device. Returns cudaGetLastError().
extern "C" int pgt_halo_amax(const void* x, int x_bf16, long long part_stride,
                             int P, int n_rows, int F, int B,
                             const void* send_idx, const void* send_mask,
                             void* amax, void* stream) {
  if (P < 2 || B == 0 || F == 0) return 0;
  if ((send_idx == nullptr) != (send_mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(B), P * (P - 1));
  amax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, part_stride, P, n_rows, F, B,
      static_cast<const int*>(send_idx),
      static_cast<const unsigned char*>(send_mask),
      static_cast<unsigned int*>(amax));
  return static_cast<int>(cudaGetLastError());
}

// K15. x, part_stride, P, n_rows, F, B, send_idx, send_mask as K14's;
// amax [P, P-1] uint32 (K14's output; null for the bf16 wire); wire_type
// 0 bf16, 1 e4m3fn, 2 e5m2; m the fp8 finite max (ignored for bf16); wire
// [P, P-1, B, F] of wire_type (receiver order); inv [P, P-1] f32 (the
// sender's inverse scale at each receiver slot; written for fp8); out
// [P, (P-1) B, F] f32 (bf16 bits when x_bf16), contiguous. On the device.
// Returns cudaGetLastError().
extern "C" int pgt_halo_wire(const void* x, int x_bf16, long long part_stride,
                             int P, int n_rows, int F, int B,
                             const void* send_idx, const void* send_mask,
                             const void* amax, int wire_type, float m,
                             void* wire, void* inv, void* out,
                             void* stream) {
  if (P < 2 || B == 0 || F == 0) return 0;
  if ((send_idx == nullptr) != (send_mask == nullptr) ||
      (wire_type != kOutBF16 && (amax == nullptr || inv == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(B), P * (P - 1));
  const int* si = static_cast<const int*>(send_idx);
  const unsigned char* sm = static_cast<const unsigned char*>(send_mask);
  const unsigned int* am = static_cast<const unsigned int*>(amax);
  float* iv = static_cast<float*>(inv);
  switch (wire_type) {
    case kOutBF16:
      wire_kernel<kOutBF16><<<grid, kThreads, 0, st>>>(
          x, x_bf16, part_stride, P, n_rows, F, B, si, sm, am, m, wire, iv,
          out);
      break;
    case kOutE4M3:
      wire_kernel<kOutE4M3><<<grid, kThreads, 0, st>>>(
          x, x_bf16, part_stride, P, n_rows, F, B, si, sm, am, m, wire, iv,
          out);
      break;
    case kOutE5M2:
      wire_kernel<kOutE5M2><<<grid, kThreads, 0, st>>>(
          x, x_bf16, part_stride, P, n_rows, F, B, si, sm, am, m, wire, iv,
          out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
