// K16, K12, K17 and K13 on Hopper: the forward and transposed tile
// products over union-gather groups and over per-tile pair lists,
// redesigned around TMA and wgmma (sm_90a).
//
// K16 replaces: pipegcn_tpu/ops/block_spmm.py  _dense_apply_grouped and
// _group_union (--block-group > 1), forward, "rduts,rusf->rdtf": G
// consecutive output tiles of T rows share one union of input tiles, and
// for every part p and output tile i of the group
//
//   out[p, i*T + t, :] = sum over the group's union slots k whose A block
//                        for tile i is not the pad:  A[blk_k] @ X[tile_k]
//
// with the input rows past n_in read as zeros (JAX's zero-padded tiles).
//
// K12 replaces: pipegcn_tpu/ops/block_spmm.py  _dense_apply and
// make_block_spmm_fn's forward (--block-group 1): the same function over
// per-tile pair lists, which are union lists at G = 1 whose every slot
// holds its tile's one block (the pads were dropped at staging). The
// same kernel body runs them with the group's bookkeeping (the pad skip,
// the per-tile block lookup) compiled out (GROUPED = false).
// K17 replaces: pipegcn_tpu/ops/block_spmm.py  _dense_apply_grouped's
// transpose, "rduts,rutf->rdsf" (the backward of --block-group > 1): the
// same function with A^T, over the backward's union lists (groups of
// source tiles, slots of destination tiles),
//
//   out[p, i*T + s, :] = sum over the group's union slots k whose A block
//                        for tile i is not the pad:  A[blk_k]^T @ G[tile_k]
//
// The same kernel body runs it (TRANSPOSE = true): the stages, the
// products and the promotion are K16's; only the A fragment differs (its
// m index a stored column, its k index a stored row).
// K13 replaces: _dense_apply's transpose and make_block_spmm_fn's
// backward (--block-group 1): K17's function over the backward's pair
// lists, run as K12 runs the forward's (their union view, GROUPED =
// false, TRANSPOSE = true). Over 1-bit A the producer warps stage each
// chunk's A^T words in the ring (stage_at); over int8 and bf16 A each
// consumer thread reads A^T's entries from the stored block (load_at,
// frag_t). No transposed copy of A exists.
// The tables, the A encodings (1-bit, int8, bf16; f32 A keeps the scalar
// path of block_spmm.cu in all four) and the exactness argument are
// block_spmm.cu's:
// A holds small integers, exact in bf16, and each f32 input is split
// exactly into three bf16 terms, so every product a * term is exact in
// f32 and the tensor cores' sum of one pair is the only rounding inside a
// pair; each pair starts a fresh accumulator and is then added to the
// output's f32 sum with an IEEE add (the per-pair promotion), in list
// order: no atomics, a rerun is bit-identical.
//
// What bounds it on the H100: the tile products, 2 * T*T*F flops a pair
// (times three terms on f32 rows), on the bf16 tensor cores; and the
// bytes the tensor cores read, each input tile chunk once a pair and CTA.
// What the template of block_spmm.cu lost time on, and what this design
// does about it:
//
//  - The split into three terms ran once a (pair, column slice): here a
//    pre-pass (split_kernel) writes the three bf16 planes once, [3, P,
//    n_in, Fp] with Fp = F rounded up to 64 and the pad zeroed, so TMA can
//    address any F. Its time counts in K16's. bf16 rows are already the
//    one term: they are read as they are, unless their row stride or
//    pointer is not 16-byte aligned, where the pre-pass copies them into
//    one padded plane (a choice by shape).
//  - The staging was synchronous (two __syncthreads a 32-deep step, no
//    double buffering). Here one producer thread walks the CTA's slots,
//    skips each one whose A block for the CTA's tile is the pad, and keeps
//    a ring of stages in flight: a stage is one 64-deep chunk of the
//    slot's input tile, 128 columns wide, every term, loaded by TMA (boxes
//    of 64 rows x 64 columns, 128-byte swizzle; rows past n_in and columns
//    past F are TMA's zero fill) and guarded by full / empty mbarriers.
//  - A was unpacked into shared memory by every column-slice CTA and
//    read back with ldmatrix. Here each consumer thread unpacks its own
//    wgmma A fragment straight from the stored block (__ldg; a 1 bit
//    becomes bf16 0x3F80), and the CTA covers 128 columns, so an A block
//    is read F / 128 times (twice at F = 256), not F / 32.
//  - mma.sync from ldmatrix fragments. Here wgmma m64n64k16 with A from
//    registers and B the swizzled stage read MN-major (the transpose bit):
//    two consumer warpgroups, 64 output rows each, two n64 products a
//    k-step (the stage's two 64-column boxes) and term (lo, mid, hi).
//
// A CTA owns 128 rows of one output tile (T <= 128: the whole tile; T =
// 160 .. 256: two CTAs a tile) and 128 columns. Rows of a warpgroup past
// T unpack as zeros and are masked at the store; a warpgroup whose rows
// all lie past T issues no products (it still releases every stage). A
// chunk past T (T % 64 == 32) runs its first two k-steps only. A tile
// with no block at any slot writes zeros.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;    // output rows a CTA covers
constexpr int kCols = 128;    // output columns a CTA covers
constexpr int kChunk = 64;    // contraction rows a ring stage holds
constexpr int kBox = 64;      // columns a TMA box holds (128 B of bf16)
constexpr int kBoxBytes = kChunk * kBox * 2;  // 8 KB
constexpr int kThreads = 384;  // a producer warpgroup, two consumers
constexpr int kConsumerWarps = 8;

enum Enc { kBits = 0, kI8 = 1, kBF16 = 2 };

template <int ENC>
__host__ __device__ constexpr int row_bytes(int T) {
  return ENC == kBits ? T / 8 : ENC == kI8 ? T : 2 * T;
}

// the ring: 4 stages of three terms (48 KB each) on f32 rows, 8 of one
// term in the bf16 mode; with AT (K17 over 1-bit A) each stage also holds
// the chunk's A^T words, 2 a row of the CTA's 128 output rows (1 KB)
template <int TERMS, bool AT>
struct Ring {
  static constexpr int kStages = TERMS == 3 ? 4 : 8;
  static constexpr int kTmaBytes = TERMS * 2 * kBoxBytes;
  static constexpr int kAtBytes = AT ? kRows * 2 * 4 : 0;
  static constexpr int kStageBytes = kTmaBytes + kAtBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024 +
                               2 * kStages * 8;  // + alignment, barriers
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// one box of the 3-d tensor map (column, row, plane) into shared memory,
// completing on ``bar``
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* m,
                                         int c, int r, int plane,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c), "r"(r), "r"(plane),
      "r"(bar)
      : "memory");
}

// the wgmma descriptor of a 128-byte-swizzled operand at ``addr``
// (1024-byte aligned atoms of 8 rows x 128 bytes): the stride between
// 8-row groups (SBO) 1,024 bytes; with N = 64 one atom spans the columns,
// so the leading offset (LBO) is never stepped and is set alike
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32, the warpgroup's fragment) = a (64 x 16 bf16, registers)
// . b (16 x 64 bf16, shared memory, MN-major) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma64(float* d, const unsigned* a,
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// two A bits (bit 0: the lower column) as a bf16 pair of 0 / 1
__device__ __forceinline__ unsigned bits2(unsigned b) {
  return ((b & 1u) * 0x3F80u) | (((b >> 1) & 1u) * 0x3F800000u);
}

// two int8 A values (a 16-bit word, the lower column first) as a bf16
// pair, exactly
__device__ __forceinline__ unsigned i8x2(unsigned w) {
  const float lo = static_cast<float>(static_cast<signed char>(w & 0xffu));
  const float hi =
      static_cast<float>(static_cast<signed char>((w >> 8) & 0xffu));
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The raw A words of one chunk (contraction columns s0 .. s0 + 63) for a
// thread's two fragment rows (row, row + 8; rows past T read nothing and
// unpack as zeros): bits 2 words a row; int8 a 16-bit word per (k-step,
// column pair); bf16 a 32-bit word per (k-step, column pair).
template <int ENC>
struct AChunk {
  static constexpr int kWords = ENC == kBits ? 2 : 8;
  unsigned w[2][kWords];
};

template <int ENC>
__device__ __forceinline__ void load_a(const unsigned char* blk, int T,
                                       int row, int s0, int t4, int nks,
                                       AChunk<ENC>& c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
#pragma unroll
    for (int i = 0; i < AChunk<ENC>::kWords; ++i) c.w[h][i] = 0u;
    if (r >= T) continue;
    const unsigned char* p = blk + static_cast<size_t>(r) * row_bytes<ENC>(T);
    if constexpr (ENC == kBits) {
      const unsigned* q = reinterpret_cast<const unsigned*>(p) + s0 / 32;
      c.w[h][0] = __ldg(q);
      if (nks > 2) c.w[h][1] = __ldg(q + 1);
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= nks) continue;
        const int col = s0 + 16 * ks + 2 * t4;
        if constexpr (ENC == kI8) {
          const unsigned short* q =
              reinterpret_cast<const unsigned short*>(p + col);
          c.w[h][2 * ks] = __ldg(q);
          c.w[h][2 * ks + 1] = __ldg(q + 4);
        } else {
          const unsigned* q = reinterpret_cast<const unsigned*>(p) + col / 2;
          c.w[h][2 * ks] = __ldg(q);
          c.w[h][2 * ks + 1] = __ldg(q + 4);
        }
      }
    }
  }
}

// the wgmma A fragment of k-step ks of a chunk: a[0] (row, columns 2 t4,
// +1), a[1] (row + 8, the same), a[2] (row, 2 t4 + 8, +9), a[3] (row + 8)
template <int ENC>
__device__ __forceinline__ void frag(const AChunk<ENC>& c, int ks, int t4,
                                     unsigned* a) {
  if constexpr (ENC == kBits) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned w = c.w[h][ks >> 1] >> (16 * (ks & 1));
      a[h] = bits2(w >> (2 * t4));
      a[2 + h] = bits2(w >> (2 * t4 + 8));
    }
  } else if constexpr (ENC == kI8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h] = i8x2(c.w[h][2 * ks]);
      a[2 + h] = i8x2(c.w[h][2 * ks + 1]);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h] = c.w[h][2 * ks];
      a[2 + h] = c.w[h][2 * ks + 1];
    }
  }
}

// K17's A^T fragment. Its m index is a stored column s (the output row)
// and its k index a stored row t (the contraction): a thread's fragment
// of k-step ks (s = frow and frow + 8; t = t0, t0 + 1, t0 + 8, t0 + 9
// with t0 = 16 ks + 2 t4 in the chunk) takes from each of four stored
// rows the entries of columns frow and frow + 8.
//
// 1-bit A (the cells' encoding): the producer warpgroup, which otherwise
// only issues TMA, transposes each chunk's bits once for the CTA. Each of
// its 4 warps loads two 32 x 32 bit tiles of the chunk (32 stored rows a
// lane, one 32-column word each) and transposes them with five xor
// shuffles (transpose32), so that lane l holds stored column l's 32 bits
// down those rows: the A^T row's word. Written into the stage beside the
// TMA boxes (2 words a row of the CTA's 128 rows, zeros past T) before
// the warp arrives on the stage's full barrier, they are the forward's
// register words (load_a's) for A^T, read with one 8-byte shared load a
// fragment row, and frag unpacks them as it does K16's.
//
// int8 and bf16 A: the consumer thread reads its entries straight from
// the stored block (load_at, frag_t), one element a (row, column); these
// encodings only carry multigraphs' multiplicities.

// a 32 x 32 bit matrix, row l in lane l (bit j: column j), transposed:
// lane l ends with column l (bit j: row j). Each step swaps the
// off-diagonal s x s blocks of every 2s x 2s block
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  constexpr unsigned kMask[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                                 0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const unsigned m = kMask[i];
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? (x & ~m) | ((y & ~m) >> s) : (x & m) | ((y & m) << s);
  }
  return x;
}

// The producer warp pw's share of a chunk's A^T words: tiles 2 pw and
// 2 pw + 1 of the chunk's 2 x 4 tiles of 32 stored rows (t) x 32 stored
// columns (s) among the CTA's rows r0 .. r0 + 127, written to ``at``
// (words [128 rows][2]: the row's bits of contraction rows s0 .. s0 + 31
// and s0 + 32 .. s0 + 63)
__device__ __forceinline__ void stage_at(const unsigned char* blk, int T,
                                         int r0, int s0, int pw, int lane,
                                         unsigned at) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int th = pw >> 1, sw = 2 * (pw & 1) + i;
    const int t = s0 + 32 * th + lane, cw = r0 / 32 + sw;
    unsigned x = 0u;
    if (t < T && cw < T / 32)
      x = __ldg(reinterpret_cast<const unsigned*>(
                    blk + static_cast<size_t>(t) * (T / 8)) + cw);
    x = transpose32(x, lane);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                     at + ((32 * sw + lane) * 2 + th) * 4),
                 "r"(x)
                 : "memory");
  }
}

// the int8 / bf16 A^T words of one chunk: w[4 ks .. 4 ks + 3] in
// fragment order, the (t0, t0 + 1) pair of column frow, of frow + 8,
// then the (t0 + 8, t0 + 9) pairs
template <int ENC>
struct ATChunk {
  static constexpr int kWords = 16;
  unsigned w[kWords];
};

template <int ENC>
__device__ __forceinline__ void load_at(const unsigned char* blk, int T,
                                        int s16, int g, int s0, int t4,
                                        int nks, ATChunk<ENC>& c) {
  static_assert(ENC != kBits, "1-bit A^T is staged by the producer");
#pragma unroll
  for (int i = 0; i < ATChunk<ENC>::kWords; ++i) c.w[i] = 0u;
  if (s16 >= T) return;  // the warp's columns past T: zeros (uniform)
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks >= nks) continue;
    const int t0 = s0 + 16 * ks + 2 * t4;
    const int rows[4] = {t0, t0 + 1, t0 + 8, t0 + 9};
    unsigned v[4][2];  // rows[q], columns frow and frow + 8
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t e = static_cast<size_t>(rows[q]) * T + s16 + g;
      if constexpr (ENC == kI8) {
        v[q][0] = __ldg(blk + e);
        v[q][1] = __ldg(blk + e + 8);
      } else {
        const unsigned short* p = reinterpret_cast<const unsigned short*>(blk);
        v[q][0] = __ldg(p + e);
        v[q][1] = __ldg(p + e + 8);
      }
    }
    constexpr int kShift = ENC == kI8 ? 8 : 16;
#pragma unroll
    for (int h = 0; h < 2; ++h)  // rows (t0, t0 + 1), (t0 + 8, t0 + 9)
#pragma unroll
      for (int col = 0; col < 2; ++col)
        c.w[4 * ks + 2 * h + col] =
            v[2 * h][col] | (v[2 * h + 1][col] << kShift);
  }
}

// the wgmma A fragment of k-step ks of an int8 / bf16 chunk of A^T, in
// frag's order
template <int ENC>
__device__ __forceinline__ void frag_t(const ATChunk<ENC>& c, int ks,
                                       unsigned* a) {
  const unsigned* w = c.w + 4 * ks;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = ENC == kI8 ? i8x2(w[i]) : w[i];
}

// a consumer thread's A words of one chunk: load_a's (K16, K12; and K17's
// staged 1-bit A^T, read from shared memory), or load_at's
template <int ENC, bool TRANSPOSE>
struct AWords {
  using type = AChunk<ENC>;
};
template <>
struct AWords<kI8, true> {
  using type = ATChunk<kI8>;
};
template <>
struct AWords<kBF16, true> {
  using type = ATChunk<kBF16>;
};

// TRANSPOSE: K17, the products of A^T (the output rows are A's stored
// columns); else K16 / K12
template <int ENC, int TERMS, bool GROUPED, bool TRANSPOSE>
__global__ void __launch_bounds__(kThreads, 1)
tma_kernel(const __grid_constant__ CUtensorMap xmap, int P, int n_in, int F,
           const unsigned char* __restrict__ a, long long b_max, int T,
           const int* __restrict__ ptr, const int* __restrict__ blk,
           const int* __restrict__ til, long long slot_stride, int n_keys,
           int G, int n_row_ctas, int n_out, int f_even,
           float* __restrict__ out) {
  // K17 over 1-bit A: the producer warps stage A^T's words
  constexpr bool kStageAt = TRANSPOSE && ENC == kBits;
  using R = Ring<TERMS, kStageAt>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled stages need 1,024-byte alignment
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  const unsigned full0 = base + R::kStages * R::kStageBytes;
  const unsigned empty0 = full0 + 8 * R::kStages;

  const int part = blockIdx.z;
  const int c0 = blockIdx.y * kCols;
  const int tile = blockIdx.x / n_row_ctas;  // the output tile, in the part
  const int r0 = (blockIdx.x % n_row_ctas) * kRows;  // its first row here
  // the tile's group and its place there (G = 1 without GROUPED)
  const int key = GROUPED ? tile / G : tile, d = GROUPED ? tile % G : 0;
  if (static_cast<long long>(tile) * T + r0 >= n_out) return;  // uniform

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      // the TMA thread's arrival (and the bytes), and with kStageAt each
      // producer warp's once its A^T words are written
      mbar_init(full0 + 8 * s, kStageAt ? 5 : 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int* pp = ptr + static_cast<size_t>(part) * (n_keys + 1);
  const int* bp = blk + static_cast<size_t>(part) * slot_stride * G;
  const int* tp = til + static_cast<size_t>(part) * slot_stride;
  const int k0 = __ldg(pp + key), k1 = __ldg(pp + key + 1);
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const size_t bstride = static_cast<size_t>(T) * row_bytes<ENC>(T);
  const unsigned char* ap = a + static_cast<size_t>(part) * b_max * bstride;

  if (tid < 128) {
    // the producer warpgroup: one thread issues every load (with
    // kStageAt every warp also stages its share of A^T's words)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (kStageAt || tid == 0) {
      if (tid == 0)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&xmap))
                     : "memory");
      int s = 0;
      unsigned ph = 0;
      for (int k = k0; k < k1; ++k) {
        const int* e = GROUPED ? bp + static_cast<size_t>(k) * G + d
                               : bp + k;  // the slot's block for this tile
        if constexpr (GROUPED) {
          if (__ldg(e) == b_max) continue;
        }
        const int in0 = __ldg(tp + k) * T;
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(empty0 + 8 * s, ph ^ 1u);
          const unsigned dst = base + s * R::kStageBytes;
          if (tid == 0) {
            mbar_expect_tx(full0 + 8 * s, R::kTmaBytes);
#pragma unroll
            for (int h = 0; h < TERMS; ++h)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                tma_load(dst + (2 * h + j) * kBoxBytes, &xmap,
                         c0 + j * kBox, in0 + c * kChunk, h * P + part,
                         full0 + 8 * s);
          }
          if constexpr (kStageAt) {
            stage_at(ap + static_cast<size_t>(__ldg(e)) * bstride, T, r0,
                     c * kChunk, tid >> 5, tid & 31, dst + R::kTmaBytes);
            __syncwarp();
            if ((tid & 31) == 0) mbar_arrive(full0 + 8 * s);
          }
          if (++s == R::kStages) {
            s = 0;
            ph ^= 1u;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = tid - 128;
    const int cw = ct >> 7;          // consumer warpgroup: rows cw * 64 ..
    const int warp = (ct >> 5) & 3;  // its warp: 16 rows
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int wrow = r0 + cw * 64;  // the warpgroup's first tile row
    const bool live = wrow < T;     // uniform in the warpgroup
    const int frow = wrow + warp * 16 + g;  // fragment rows frow, frow + 8
    const int s16 = frow - g;  // the warp's first fragment row

    float acc[64], pr[64];  // [0, 32): columns 0 .. 63; [32, 64): 64 .. 127
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) pr[i] = 0.0f;
    // the CTA's steps, (slot, chunk) in list order over the slots with a
    // block for this tile; K16 / K12's 1-bit A words of the next step are
    // loaded while this one waits and multiplies (int8 / bf16 A, 16 words
    // a step, are loaded at their own step; K17's 1-bit A^T words are read
    // from the stage once it is full)
    constexpr bool kAhead = ENC == kBits && !TRANSPOSE;
    // the slot's entry for this tile (a pair list's slot k: its block)
    auto entry = [&](int k) {
      return GROUPED ? bp + static_cast<size_t>(k) * G + d : bp + k;
    };
    auto used_from = [&](int k) {
      if constexpr (GROUPED) {
        while (k < k1 && __ldg(entry(k)) == b_max) ++k;
      }
      return k;
    };
    auto block_of = [&](int k) {
      return ap + static_cast<size_t>(__ldg(entry(k))) * bstride;
    };
    auto depth = [&](int c) { return min(4, (T - c * kChunk) / 16); };
    using Words = typename AWords<ENC, TRANSPOSE>::type;
    // the A words of chunk c of a block, from the stored block (with
    // kStageAt they are read from the stage once it is full)
    auto load_words = [&](const unsigned char* b, int c, int nks,
                          Words& w) {
      if constexpr (TRANSPOSE && !kStageAt)
        load_at<ENC>(b, T, s16, g, c * kChunk, t4, nks, w);
      else if constexpr (!TRANSPOSE)
        load_a<ENC>(b, T, frow, c * kChunk, t4, nks, w);
    };
    int k = used_from(k0), c = 0;
    const unsigned char* ab = k < k1 ? block_of(k) : nullptr;
    Words aw;
    if (kAhead && live && k < k1) load_words(ab, 0, depth(0), aw);
    int s = 0;
    unsigned ph = 0;
    while (k < k1) {
      int kn = k, cn = c + 1;
      const unsigned char* abn = ab;
      if (cn == n_chunks) {
        kn = used_from(k + 1);
        cn = 0;
        abn = kn < k1 ? block_of(kn) : nullptr;
      }
      const int nks = depth(c);
      Words an;
      if (live) {
        if (!kAhead)
          load_words(ab, c, nks, aw);
        else if (kn < k1)
          load_words(abn, cn, depth(cn), an);
      }
      mbar_wait(full0 + 8 * s, ph);
      if (live) {
        const unsigned st = base + s * R::kStageBytes;
        if constexpr (kStageAt) {
          // the stage's A^T words of rows frow and frow + 8
          const unsigned char* at =
              smem_raw + (st - raw) + R::kTmaBytes;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint2 v = *reinterpret_cast<const uint2*>(
                at + (frow + 8 * h - r0) * 8);
            aw.w[h][0] = v.x;
            aw.w[h][1] = v.y;
          }
        }
        // every A register is written before the fence: a write after
        // it would make ptxas wait before each product
        unsigned af[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if constexpr (TRANSPOSE && !kStageAt)
            frag_t<ENC>(aw, ks, af[ks]);
          else
            frag<ENC>(aw, ks, t4, af[ks]);
        }
        fence_acc(pr);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nks) continue;
#pragma unroll
          for (int h = TERMS - 1; h >= 0; --h) {  // lo, mid, hi
            const int sc = (c > 0 || ks > 0 || h != TERMS - 1) ? 1 : 0;
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wgmma64(pr + 32 * j, af[ks],
                      desc_sw128(st + (2 * h + j) * kBoxBytes +
                                 ks * 16 * 128),
                      sc);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        fence_acc(pr);
        if (cn == 0) {  // the slot's last chunk: promote the pair
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += pr[i];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (++s == R::kStages) {
        s = 0;
        ph ^= 1u;
      }
      k = kn;
      c = cn;
      ab = abn;
      if constexpr (kAhead) aw = an;
    }

    float* op0 = out + static_cast<size_t>(part) * n_out * F;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = frow + 8 * rr;
      const long long row = static_cast<long long>(tile) * T + t;
      if (!live || t >= T || row >= n_out) continue;
      float* op = op0 + static_cast<size_t>(row) * F;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = c0 + 64 * j + 8 * q + 2 * t4;
          const float v0 = acc[32 * j + 4 * q + 2 * rr];
          const float v1 = acc[32 * j + 4 * q + 2 * rr + 1];
          if (f_even) {
            if (col < F)
              *reinterpret_cast<float2*>(op + col) = make_float2(v0, v1);
          } else {
            if (col < F) op[col] = v0;
            if (col + 1 < F) op[col + 1] = v1;
          }
        }
    }
  }
}

// The pre-pass: x [P, n_in, F] (f32, or bf16 bits when XB) -> planes
// [TERMS, P, n_in, Fp] bf16, columns F .. Fp zeroed. f32: hi, mid, lo
// with hi + mid + lo == x (see split3); bf16: a padded copy. A thread
// takes 4 consecutive columns of one row (Fp % 64 == 0: never a row's
// end).
__device__ __forceinline__ void split3(float x, unsigned short* t) {
  // truncation (never overflows near the largest finite), each term
  // carrying x's sign (so -0 splits into three -0)
  const unsigned u = __float_as_uint(x);
  const unsigned sign = u & 0x80000000u;
  const unsigned hi = u & 0xffff0000u;
  const float r = x - __uint_as_float(hi);  // exact
  const unsigned mid = __float_as_uint(r) & 0xffff0000u;
  const float lo = r - __uint_as_float(mid);  // exact
  t[0] = static_cast<unsigned short>(hi >> 16);
  t[1] = static_cast<unsigned short>((mid | sign) >> 16);
  t[2] = static_cast<unsigned short>((__float_as_uint(lo) | sign) >> 16);
}

template <bool XB>
__global__ void __launch_bounds__(256)
split_kernel(const void* __restrict__ x, long long rows, int F, int Fp,
             int vec4, unsigned short* __restrict__ out) {
  const long long plane = rows * Fp;
  const int q4 = Fp / 4;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < rows * q4;
       i += static_cast<long long>(gridDim.x) * 256) {
    const long long r = i / q4;
    const int c = static_cast<int>(i - r * q4) * 4;
    if constexpr (XB) {
      const unsigned short* xr =
          static_cast<const unsigned short*>(x) + r * F;
      unsigned short v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = c + j < F ? __ldg(xr + c + j) : 0;
      *reinterpret_cast<uint2*>(out + r * Fp + c) =
          make_uint2(v[0] | static_cast<unsigned>(v[1]) << 16,
                     v[2] | static_cast<unsigned>(v[3]) << 16);
    } else {
      const float* xr = static_cast<const float*>(x) + r * F;
      float v[4];
      if (vec4 && c < F) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(xr + c));
        v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = c + j < F ? __ldg(xr + c + j) : 0.f;
      }
      unsigned short t[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j) split3(v[j], t[j]);
#pragma unroll
      for (int h = 0; h < 3; ++h)
        *reinterpret_cast<uint2*>(out + h * plane + r * Fp + c) =
            make_uint2(t[0][h] | static_cast<unsigned>(t[1][h]) << 16,
                       t[2][h] | static_cast<unsigned>(t[3][h]) << 16);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded (no link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(
                              dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// the planes [planes, n_in, cols] bf16 with row pitch ``pitch`` elements,
// boxes of 64 rows x 64 columns, 128-byte swizzle, zero fill past the ends
int encode(CUtensorMap* m, const void* p, int cols, long long pitch,
           int n_in, int planes) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectInitFailed);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(n_in),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(pitch) * 2,
      static_cast<cuuint64_t>(pitch) * 2 * static_cast<cuuint64_t>(n_in)};
  const cuuint32_t box[3] = {kBox, kChunk, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult rc = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(p), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int ENC, int TERMS, bool GROUPED, bool TRANSPOSE>
int launch_main(const CUtensorMap& m, int P, int n_in, int F, int cols,
                const unsigned char* a, long long b_max, int T,
                const int* ptr, const int* blk, const int* til,
                long long slot_stride, int n_keys, int G, int n_out,
                float* out, cudaStream_t st) {
  using R = Ring<TERMS, TRANSPOSE && ENC == kBits>;
  auto kern = tma_kernel<ENC, TERMS, GROUPED, TRANSPOSE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_row_ctas = (T + kRows - 1) / kRows;
  const long long nx = static_cast<long long>(n_keys) * G * n_row_ctas;
  const dim3 grid(static_cast<unsigned>(nx), (cols + kCols - 1) / kCols, P);
  kern<<<grid, kThreads, R::kSmem, st>>>(m, P, n_in, F, a, b_max, T, ptr,
                                         blk, til, slot_stride, n_keys, G,
                                         n_row_ctas, n_out, F % 2 == 0, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The pre-pass alone. x [P, n_in, F] f32 (bf16 bits when x_bf16); out
// [3 (1 when x_bf16), P, n_in, Fp] bf16 bits, Fp % 64 == 0, Fp >= F. All
// contiguous, on the device. Returns cudaGetLastError().
extern "C" int pgt_tile_split(const void* x, int x_bf16, int P, int n_in,
                              int F, int Fp, void* out, void* stream) {
  const long long rows = static_cast<long long>(P) * n_in;
  if (rows == 0 || Fp == 0) return 0;
  if (Fp % 64 != 0 || Fp < F) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long work = rows * (Fp / 4);
  const int blocks = static_cast<int>(
      work / 256 + 1 < 132 * 16 ? work / 256 + 1 : 132 * 16);
  const int vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  unsigned short* o = static_cast<unsigned short*>(out);
  if (x_bf16)
    split_kernel<true><<<blocks, 256, 0, st>>>(x, rows, F, Fp, vec4, o);
  else
    split_kernel<false><<<blocks, 256, 0, st>>>(x, rows, F, Fp, vec4, o);
  return static_cast<int>(cudaGetLastError());
}

// K16 (G 2 .. 64), K12 (G = 1) and, with transpose, K17 (A^T over the
// backward's union lists, G 2 .. 64) and K13 (G = 1: the backward's pair
// lists). x [P, n_in, F] f32, or bf16 when
// x_bf16; planes: the pre-pass's buffer [3 (1 when x_bf16), P, n_in, Fp]
// bf16 (Fp = F rounded up to 64), or null for bf16 rows read as they are
// (F % 8 == 0 and x 16-byte aligned); a [P, b_max, T, row_bytes] (enc 0
// bits, 1 int8, 2 bf16); ptr [P, n_groups + 1], til [P, slot_stride], blk
// [P, slot_stride, G] int32 (block_spmm.cu's union-gather lists; at G = 1
// the pair lists, n_groups the output tiles, no slot the pad); out [P,
// n_out, F] f32. T a multiple of 32 up to 256. All contiguous, on the
// device; the host validated every index. Returns the first CUDA error
// (the pre-pass's, the tensor map's, the launch's).
extern "C" int pgt_block_grouped_tma(
    const void* x, int x_bf16, int P, int n_in, int F, void* planes,
    const void* a, int enc, long long b_max, int T, int G, const void* ptr,
    const void* blk, const void* til, long long slot_stride, int n_groups,
    int n_out, int transpose, void* out, void* stream) {
  if (P == 0 || n_out == 0 || F == 0) return 0;
  if (T < 32 || T > 256 || T % 32 != 0 || n_groups <= 0 || G < 1 ||
      G > 64 || P > 65535 || n_in < 0 || enc < kBits || enc > kBF16 ||
      static_cast<long long>(n_groups) * G * ((T + kRows - 1) / kRows) >
          0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_in == 0)  // no input rows: every product is zero
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(P) * n_out * F * sizeof(float), st));
  const int terms = x_bf16 ? 1 : 3;
  const int Fp = (F + 63) / 64 * 64;
  const void* src = x;
  int cols = F;
  long long pitch = F;
  if (planes != nullptr) {
    const int rc = pgt_tile_split(x, x_bf16, P, n_in, F, Fp, planes, stream);
    if (rc != 0) return rc;
    src = planes;
    cols = Fp;
    pitch = Fp;
  } else if (!x_bf16 || F % 8 != 0 ||
             reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap m;
  const int rc = encode(&m, src, cols, pitch, n_in, terms * P);
  if (rc != 0) return rc;
  const unsigned char* ab = static_cast<const unsigned char*>(a);
  const int* pt = static_cast<const int*>(ptr);
  const int* bk = static_cast<const int*>(blk);
  const int* tl = static_cast<const int*>(til);
  float* o = static_cast<float*>(out);
  // G = 1 (K12, K13: a pair list's union view) compiles the group's
  // bookkeeping out; G > 1 (K16, K17) keeps it
#define PGT_RUN(ENC, TERMS, GR, TR)                                       \
  launch_main<ENC, TERMS, GR, TR>(m, P, n_in, F, cols, ab, b_max, T, pt, \
                                  bk, tl, slot_stride, n_groups, G, n_out, \
                                  o, st)
#define PGT_MAIN(ENC, TERMS)                                           \
  (transpose ? (G > 1 ? PGT_RUN(ENC, TERMS, true, true)                \
                      : PGT_RUN(ENC, TERMS, false, true))              \
   : G > 1   ? PGT_RUN(ENC, TERMS, true, false)                        \
             : PGT_RUN(ENC, TERMS, false, false))
  if (terms == 3) {
    switch (enc) {
      case kBits: return PGT_MAIN(kBits, 3);
      case kI8: return PGT_MAIN(kI8, 3);
      default: return PGT_MAIN(kBF16, 3);
    }
  }
  switch (enc) {
    case kBits: return PGT_MAIN(kBits, 1);
    case kI8: return PGT_MAIN(kI8, 1);
    default: return PGT_MAIN(kBF16, 1);
  }
#undef PGT_MAIN
#undef PGT_RUN
}
