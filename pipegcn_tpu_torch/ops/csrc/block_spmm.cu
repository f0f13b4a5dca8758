// K12 / K13 and K16 / K17 over f32 A: the dense-tile products of the
// block-dense SpMM, written by hand for Hopper (sm_90a): K12 the forward,
// K13 the transpose (the backward), over per-tile pair lists; K16 / K17
// the same over union-gather groups. Over 1-bit, int8 and bf16 A all four
// run in block_tma.cu (TMA stages and wgmma: K12 / K13 over a pair list's
// union view); here f32 A (multiplicities above 256, not exact in bf16)
// takes the scalar path of all four (block_kernel).
//
// K12 / K13 replace: pipegcn_tpu/ops/block_spmm.py  _dense_apply (with
// _unpack_bits), inside make_block_spmm_fn / make_device_block_spmm_fn,
// at group = 1 (the per-tile pair lists). K16 / K17 replace
// _dense_apply_grouped (--block-group > 1): G consecutive output tiles
// share one union of input tiles, "rduts,rusf->rdtf" forward and
// "rduts,rutf->rdsf" transposed. For every part p and output tile i
// of T rows:
//
//   K12:  out[p, i*T + t, :] = sum_k  A[blk_k] @ X[p, tile_k*T : +T, :]
//   K13:  out[p, i*T + s, :] = sum_k  A[blk_k]^T @ G[p, tile_k*T : +T, :]
//
// where (blk_k, tile_k) is output tile i's pair list (host-built, in the
// JAX class order: ops/block_spmm.py stage_block_tables), A a [T, T] dense
// block of edge multiplicities and the input rows past n_in read as zeros
// (JAX's zero-padded tiles). K13 reads the same A blocks as K12, with the
// roles of its rows and columns swapped in the staging: no transposed
// copy exists. A is stored bit-packed (1 bit an entry, little-endian
// within each byte: np.packbits(bitorder="little")), int8, bf16 or f32;
// X and G are f32, or bf16 at bf16 compute (the bf16 mode); out is f32.
// An output tile with no pairs is written as zeros.
//
// The union-gather groups (K16 / K17). Output tiles j G .. j G + G - 1
// form group j; its list holds union slots, each one input tile u and, for
// every tile d of the group, the A block that multiplies it there, or the
// pad (b_max: tile d does not touch u). Group 1 is K12 / K13's pair list
// (one slot a pair, never a pad), so one kernel runs both layouts: a CTA
// owns 256 consecutive rows of its group's G T output rows (G T / 256
// CTAs a group: at T = 256 one tile each; at G T <= 256 the whole group)
// and a column slice, walks the group's slots once, stages each slot's
// input tile once for all of its rows and applies it against the A block
// of each of its tiles. A warp's 32 rows lie in one tile (T % 32 == 0): a
// warp whose tile has the pad at a slot skips its products, and a slot
// none of the CTA's tiles uses is skipped whole. JAX multiplies the zero
// block at a pad; skipping it changes nothing but a non-finite input's
// NaN. The accumulator stays one 256-row tile a CTA.
//
// What bounds it on the H100: the tile products. The function needs one
// add per dense edge and column (~7.5e9 adds a call at the training shape,
// ~0.11 ms at the card's 67 TFLOP/s f32) and moves ~0.55 GB over the
// dense edges (input, output and an int32 index an edge: ~0.16 ms at
// 3.35 TB/s); the stored A blocks add their own bytes, and the tile
// products do T*T*F multiply-adds per pair whatever the tile's density.
//
// Exactness, which block_tma.cu's tensor-core products rest on: A holds
// small integers (0/1, or multiplicities) and JAX multiplies in f32, so a
// bf16 product of a rounded input would be wrong by ~2^-9. Each f32 input
// is split exactly into three bf16 terms, hi = bf16(x), mid = bf16(x -
// hi), lo = bf16(x - hi - mid) (x = hi + mid + lo: 24 significant bits in
// three 8-bit terms); A up to 256 is exact in bf16, so every product a *
// term is exact in f32. The tensor cores add with truncation and no guard
// bits, which grows with the running sum's magnitude, so each pair's
// products go into a fresh accumulator that is then added to the output's
// f32 sum with an IEEE add ("promotion"): kernel and plain version differ
// by a few ulps of each pair's partial sum and by summation order. In the
// bf16 mode an input value is already one bf16 term: one product instead
// of three. No atomics; a rerun is bit-identical.
//
// f32 A takes the scalar path here: a register-tiled SGEMM over the same
// lists, 8 x 8 outputs a thread over 64 columns, fmaf on the CUDA cores
// (one rounding an add with 0/1 A). The ragged last row tile, the input
// rows past n_in and the columns past F are masked (staged as 0). Inputs
// are finite (an infinite input's split is NaN).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;    // output rows a CTA covers (the largest tile)
constexpr int kCols = 64;     // output columns a CTA covers (scalar path)
constexpr int kK = 32;        // contraction rows staged per step
constexpr int kThreads = 256;

// the entry points' A encoding this file runs (0 bits, 1 int8 and 2 bf16
// run in block_tma.cu)
constexpr int kF32 = 3;

// A[row, c0 : c0 + 32] of one f32 block (c0 % 32 == 0)
__device__ __forceinline__ void load_a32(const unsigned char* blk, int T,
                                         int row, int c0, float* v) {
  const float4* q = reinterpret_cast<const float4*>(
      blk + (static_cast<size_t>(row) * T + c0) * 4);
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    const float4 u = __ldg(q + h);
    v[4 * h] = u.x; v[4 * h + 1] = u.y; v[4 * h + 2] = u.z;
    v[4 * h + 3] = u.w;
  }
}

// 8 consecutive f32 of one input row from column c (masked at F; VEC
// divides F and the row stride, so a vector never straddles F)
template <int VEC>
__device__ __forceinline__ void load_x8(const float* row, int c, int F,
                                        float* v) {
#pragma unroll
  for (int j = 0; j < 8; j += VEC) {
    const int cc = c + j;
    if constexpr (VEC == 4) {
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cc < F) u = __ldg(reinterpret_cast<const float4*>(row + cc));
      v[j] = u.x; v[j + 1] = u.y; v[j + 2] = u.z; v[j + 3] = u.w;
    } else if constexpr (VEC == 2) {
      float2 u = make_float2(0.f, 0.f);
      if (cc < F) u = __ldg(reinterpret_cast<const float2*>(row + cc));
      v[j] = u.x; v[j + 1] = u.y;
    } else {
      v[j] = cc < F ? __ldg(row + cc) : 0.f;
    }
  }
}

// 8 consecutive bf16 of one input row from column c as floats (masked at
// F; scalar loads)
__device__ __forceinline__ void load_xb8(const unsigned short* row, int c,
                                         int F, float* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = c + j < F
               ? __uint_as_float(static_cast<unsigned>(__ldg(row + c + j))
                                 << 16)
               : 0.f;
}

// Where a CTA's rows lie in its group, worked out once a CTA (the integer
// divisions by the runtime T stay out of the slot loop): the tiles its
// 256 rows r0 .. touch (d_lo .. d_hi) and the tile of the group row f a
// thread stages (t_d, -1 past the group's G T rows) with its row (K12) or
// first column (K13) in A (t_m).
struct GroupRows {
  int d_lo, d_hi, t_d, t_m;
};

__device__ __forceinline__ GroupRows group_rows(int r0, int f, int G,
                                                int T) {
  const int GT = G * T;
  GroupRows g;
  g.d_lo = r0 / T;
  g.d_hi = min(G, (r0 + kRows + T - 1) / T);
  g.t_d = f < GT ? f / T : -1;
  g.t_m = f - (g.t_d < 0 ? 0 : g.t_d) * T;
  return g;
}

// whether any tile of the CTA's rows has an A block at one slot (bk: the
// slot's G block ids; pad = b_max)
__device__ __forceinline__ bool slot_used(const int* bk, const GroupRows& g,
                                          long long b_max) {
  for (int d = g.d_lo; d < g.d_hi; ++d)
    if (__ldg(bk + d) != b_max) return true;
  return false;
}

// the A block of tile d of the group at one slot, or null (the pad, or
// d < 0: rows past the group's)
__device__ __forceinline__ const unsigned char* slot_block(
    const unsigned char* ap, const int* bk, int d, int T, long long b_max) {
  if (d < 0) return nullptr;
  const int b = __ldg(bk + d);
  if (b == b_max) return nullptr;
  return ap + static_cast<size_t>(b) * T * 4 * T;
}

template <bool TRANSPOSE, int VEC, bool XB>
__global__ void __launch_bounds__(kThreads, 2)
block_kernel(const void* __restrict__ x, int n_in, int F,
             const unsigned char* __restrict__ a, long long b_max, int T,
             const int* __restrict__ ptr, const int* __restrict__ blk,
             const int* __restrict__ til, long long pair_stride,
             int n_keys, int G, int n_row_ctas, int n_out,
             float* __restrict__ out) {
  // contraction-major staging: As[kk][m] = A value for output row m and
  // contraction row kk of this step; Xs[kk][c] the input's
  __shared__ __align__(16) float As[kK][kRows];
  __shared__ __align__(16) float Xs[kK][kCols];

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // 0..31: output rows ty*4 + i, 128 + ty*4 + i
  const int tx = tid & 7;   // 0..7: output columns tx*4 + j, 32 + tx*4 + j
  const int c0 = blockIdx.x * kCols;
  const int key = blockIdx.y / n_row_ctas;  // the output tile group
  const int r0 = (blockIdx.y % n_row_ctas) * kRows;  // its rows r0 ..
  const int GT = G * T;
  const int part = blockIdx.z;

  const float* xp =
      static_cast<const float*>(x) + static_cast<size_t>(part) * n_in * F;
  const unsigned short* xbp = static_cast<const unsigned short*>(x) +
                              static_cast<size_t>(part) * n_in * F;
  const unsigned char* ap =
      a + static_cast<size_t>(part) * b_max * T * 4 * T;
  const int* pp = ptr + static_cast<size_t>(part) * (n_keys + 1);
  const int* bp = blk + static_cast<size_t>(part) * pair_stride * G;
  const int* tp = til + static_cast<size_t>(part) * pair_stride;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int k0 = pp[key], k1 = pp[key + 1];
  // staging roles of this thread: the input's row kk = tid / 8 and its
  // columns (tid % 8) * 8 ..; K13's A row kk = tid / 8 and columns
  // (tid % 8) * 32 .. (the CTA's rows r0 + q ..); K12's A row tid (the
  // CTA's row r0 + tid, all contraction columns)
  const int xr = tid >> 3, xc = (tid & 7) * 8;
  const int q = (tid & 7) * 32;
  const GroupRows gr =
      group_rows(r0, TRANSPOSE ? r0 + q : r0 + tid, G, T);
  const int fm = gr.t_m;  // the staged row (K12) or first column (K13)
  for (int k = k0; k < k1; ++k) {
    const int* bk = bp + static_cast<size_t>(k) * G;
    if (!slot_used(bk, gr, b_max)) continue;  // uniform in the CTA
    // this thread's staged A block (null: zeros, which add nothing)
    const unsigned char* ab = slot_block(ap, bk, gr.t_d, T, b_max);
    const long long in0 = static_cast<long long>(__ldg(tp + k)) * T;
    for (int s0 = 0; s0 < T; s0 += kK) {
      __syncthreads();  // the previous step's reads are done
      float v[32];
      if constexpr (!TRANSPOSE) {
        // A row fm, contraction columns s0 .. s0 + 31
        if (ab != nullptr) {
          load_a32(ab, T, fm, s0, v);
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j) v[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) As[j][tid] = v[j];
      } else {
        // A row s0 + kk (a contraction row), output columns fm .. fm + 31
        if (ab != nullptr) {
          load_a32(ab, T, s0 + xr, fm, v);
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j) v[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 32; j += 4)
          *reinterpret_cast<float4*>(&As[xr][q + j]) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
      {
        const long long r = in0 + s0 + xr;
        float u[8];
        if (r < n_in) {
          if constexpr (XB)
            load_xb8(xbp + static_cast<size_t>(r) * F, c0 + xc, F, u);
          else
            load_x8<VEC>(xp + static_cast<size_t>(r) * F, c0 + xc, F, u);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) u[j] = 0.0f;
        }
        *reinterpret_cast<float4*>(&Xs[xr][xc]) =
            make_float4(u[0], u[1], u[2], u[3]);
        *reinterpret_cast<float4*>(&Xs[xr][xc + 4]) =
            make_float4(u[4], u[5], u[6], u[7]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][128 + ty * 4]);
        const float4 x0 = *reinterpret_cast<const float4*>(&Xs[kk][tx * 4]);
        const float4 x1 =
            *reinterpret_cast<const float4*>(&Xs[kk][32 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i < 4 ? 0 : 128) + ty * 4 + (i & 3);
    const long long row = static_cast<long long>(key) * GT + r0 + m;
    if (r0 + m >= GT || row >= n_out) continue;
    float* op = out + (static_cast<size_t>(part) * n_out + row) * F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + h * 32 + tx * 4;
      if constexpr (VEC == 4) {
        if (c < F)
          *reinterpret_cast<float4*>(op + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < F) op[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

// the vector width of the row loads and stores: 4 or 2 where F and the
// pointers allow, else 1
int vec_width(const void* x, const float* out, int F) {
  const bool a16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool a8 = reinterpret_cast<uintptr_t>(x) % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 8 == 0;
  return F % 4 == 0 && a16 ? 4 : F % 2 == 0 && a8 ? 2 : 1;
}

#define PGT_ARGS                                                         \
  x, n_in, F, a, b_max, T, ptr, blk, til, pair_stride, n_keys, G,          \
      n_row_ctas, n_out, out

// f32 A (not exact in bf16), any group, either direction: the scalar
// CUDA-core path
template <bool TR>
int launch_scalar(const void* x, bool xb, int P, int n_in, int F,
                  const unsigned char* a, long long b_max, int T,
                  const int* ptr, const int* blk, const int* til,
                  long long pair_stride, int n_keys, int G, int n_out,
                  float* out, cudaStream_t st) {
  const int n_row_ctas = (G * T + kRows - 1) / kRows;
  const dim3 grid((F + kCols - 1) / kCols, n_keys * n_row_ctas, P);
  const int vec = vec_width(x, out, F);
  if (xb)
    block_kernel<TR, 1, true><<<grid, kThreads, 0, st>>>(PGT_ARGS);
  else if (vec == 4)
    block_kernel<TR, 4, false><<<grid, kThreads, 0, st>>>(PGT_ARGS);
  else if (vec == 2)
    block_kernel<TR, 2, false><<<grid, kThreads, 0, st>>>(PGT_ARGS);
  else
    block_kernel<TR, 1, false><<<grid, kThreads, 0, st>>>(PGT_ARGS);
  return static_cast<int>(cudaGetLastError());
}
#undef PGT_ARGS

int launch(const void* x, int P, int n_in, int F, const void* a, int enc,
           long long b_max, int T, const void* ptr, const void* blk,
           const void* til, long long pair_stride, int n_keys, int G,
           int n_out, int transpose, int x_bf16, void* out, void* stream) {
  if (P == 0 || n_out == 0 || F == 0) return 0;
  if (T < 32 || T > kRows || T % 32 != 0 || n_keys <= 0 || G < 1 ||
      G > 64 || static_cast<long long>(n_keys) * ((G * T + kRows - 1) /
                                                 kRows) > 65535 ||
      P > 65535 || n_in < 0 || enc != kF32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool xb = x_bf16 != 0;
  const unsigned char* ab = static_cast<const unsigned char*>(a);
  const int* pt = static_cast<const int*>(ptr);
  const int* bk = static_cast<const int*>(blk);
  const int* tl = static_cast<const int*>(til);
  float* o = static_cast<float*>(out);
  return transpose
             ? launch_scalar<true>(x, xb, P, n_in, F, ab, b_max, T, pt, bk,
                                   tl, pair_stride, n_keys, G, n_out, o, st)
             : launch_scalar<false>(x, xb, P, n_in, F, ab, b_max, T, pt, bk,
                                    tl, pair_stride, n_keys, G, n_out, o,
                                    st);
}

}  // namespace

// K12 / K13 over f32 A (block_tma.cu takes the other encodings). x [P,
// n_in, F] f32, or bf16 when x_bf16; a [P, b_max, T, T] f32 (enc 3);
// ptr [P, n_out_tiles + 1] int32, blk / til [P, pair_stride] int32 (pair
// k of part p: A block blk and input tile til; output tile i's pairs at
// ptr[p, i] .. ptr[p, i + 1]); out [P, n_out, F] f32. transpose 0 = K12,
// 1 = K13. T a multiple of 32 up to 256.
// All contiguous, on the device; the host validated every index. Returns
// cudaGetLastError().
extern "C" int pgt_block_dense(const void* x, int P, int n_in, int F,
                               const void* a, int enc, long long b_max,
                               int T, const void* ptr, const void* blk,
                               const void* til, long long pair_stride,
                               int n_out_tiles, int n_out, int transpose,
                               int x_bf16, void* out, void* stream) {
  return launch(x, P, n_in, F, a, enc, b_max, T, ptr, blk, til, pair_stride,
                n_out_tiles, 1, n_out, transpose, x_bf16, out, stream);
}

// K16 / K17. As K12 / K13 over union-gather groups of G output tiles
// (only over f32 A: block_tma.cu takes the others):
// ptr [P, n_groups + 1] int32 (group j's union slots at ptr[p, j] ..
// ptr[p, j + 1]), til [P, slot_stride] int32 (each slot's input tile),
// blk [P, slot_stride, G] int32 (each slot's A block for each tile of the
// group; b_max: none). transpose 0 = K16, 1 = K17. Returns
// cudaGetLastError().
extern "C" int pgt_block_grouped(const void* x, int P, int n_in, int F,
                                 const void* a, int enc, long long b_max,
                                 int T, int G, const void* ptr,
                                 const void* blk, const void* til,
                                 long long slot_stride, int n_groups,
                                 int n_out, int transpose, int x_bf16,
                                 void* out, void* stream) {
  return launch(x, P, n_in, F, a, enc, b_max, T, ptr, blk, til, slot_stride,
                n_groups, G, n_out, transpose, x_bf16, out, stream);
}
