// K6 / K8: GAT edge-softmax attention aggregation, forward and the
// source-keyed pass of its backward, hand-written for Hopper (sm_90a).
//
// Replaces: pipegcn_tpu/ops/gat_bucket.py  make_device_gat_fn (fwd_pass,
// gat_bwd pass A and pass B, _gather_weighted, _gather_contract,
// _gather_weighted_contract) and the aggregation of
// pipegcn_tpu/models/sage.py  _gat_layer (raw-edge segment max / sum /
// weighted sum, autodiff backward). The two compute one function; their
// bucket tables exist to avoid TPU scatters, and a CSR pass has none.
//
// Per destination row d and head h, over the in-edges e = (src, d) of
// the destination CSR (indptr, src), with leaky(x) = x > 0 ? x : slope*x:
//
//   K6  l_e = leaky(el[src,h] + er[d,h]);  m = max_e l_e  (0 if no edge)
//       s = sum_e exp(l_e - m)  (1 if no edge)
//       out[d,h,:] = sum_e exp(l_e - m) * z[src,h,:] / s
//       and, in its NEG mode (training), over the edges on the negative
//       leaky branch (el + er <= 0) alone, with alpha = exp(l - m) / s:
//       n_neg[d,h,:] = sum_neg alpha_e * z[src,h,:],  w_neg[d,h] = sum_neg
//       alpha_e
//   K8  (pass B, src-keyed, over the transpose CSR (indptr_t, dst_t)),
//       per source row r, with beta = alpha * leaky'(l), leaky' = 1 if
//       x > 0 else slope:
//       d_z[r,h,:] = sum_e alpha_e * g[dst,h,:]
//       d_el[r,h]  = sum_e beta_e * (g[dst,h,:] . z[r,h,:] - rho[dst,h])
//
// Pass A of the backward (d_er) needs no kernel of its own: for a row
// with edges sum(alpha) = 1 and g . out = rho, so
//   d_er = sum_e beta_e (g . z[src_e] - rho) = (1 - slope) (rho w_neg -
//   g . n_neg),
// an elementwise expression over K6's NEG outputs (ops/gat.py), and 0 for
// an empty row (n_neg = w_neg = 0). That saves a second wide gather of
// z[src] per layer.
//
// K8 contracts the gathered wide rows after the edge loop instead of per
// edge: sum_e beta_e (x_e . y) = (sum_e beta_e x_e) . y, since y (the
// row's own z) does not depend on the edge. So every pass is a weighted
// row gather-sum plus one dot product per head at the end, and no
// per-edge warp reduction runs.
//
// z [P, R, H*dh] (every source row of the part, halo included), el
// [P, R, H], er [P, n, H], out/n_neg [P, n, H*dh] f32, g [P, n, H*dh],
// m/s/w_neg/rho [P, n, H] f32; K8 reads er, m, s, rho stacked as [P, n,
// 4, H] (one narrow row per edge).
//
// Row types. The wide rows (z in K6 and K8, g in K8) come in the types of
// make_device_gat_fn's gather transport and of bf16 compute, one mode a
// library (this header is compiled once per mode, PGT_GAT_MODE):
//   mode 0: z f32, g f32       (f32 compute; the bf16 logits layer)
//   mode 1: z bf16, g bf16     (bf16 compute; --rem-dtype bfloat16)
//   mode 2: z e4m3, g e5m2     (--rem-dtype float8, after K10's casts)
// Each value is widened to f32 exactly (bf16 by a shift, fp8 through half
// by __nv_cvt_fp8x2_to_halfraw2: both fp8 formats are subsets of half),
// and every sum, logit and statistic stays f32. K8's row-local z[r] is the
// same narrow z the forward gathered (gat_bucket.py:466-471), so d_el
// differentiates the quantized forward.
//
// What bounds them on the H100: the wide gather, as in K1/K3. Every edge
// reads one full row of H*dh floats (1 KB at the hidden layers) from L2
// or HBM; the least traffic (each input read once) is a few hundred MB,
// and the least arithmetic is one FMA (2 flops) per edge per element.
// K6's NEG mode and K8 keep one accumulator per leaky branch (pos and
// neg: K6's out is their sum, n_neg the negative one, on f32 rows only
// where no chunk straddles two heads; K8's d_z their sum, its beta sum
// pos + slope * neg), so each lane does one FMA an element and edge.
// They are random-row-gather kernels, whose time on this card went to
// the per-edge work (the weights, the selects and the shared-memory reads
// of chunks that may straddle two heads, the dependent index and el
// loads at each chunk's start) more than to the row bytes (PERF.md).

// Design (simple and right first): one warp per row. The warp loads 32
// edge indices with one coalesced load; each lane computes the attention
// weights of its own edge for every head (a narrow el / stats row gather,
// expf) and writes them to the warp's slice of shared memory; then the
// warp walks the 32 edges in order, broadcasting each index with
// __shfl_sync, and every lane gathers its columns of that edge's wide row
// in chunks of 4 elements (16, 8 or 4 bytes by the row type) when F % 4
// == 0, dh >= 4 and the pointers allow, else one element, and adds each
// element's head weight times the value. A chunk may straddle two heads
// (dh = 41 at the logits layer: F = 164, rows of 164 bytes at e4m3, only
// 4-byte aligned), so each chunk carries its first head and the element
// at which the next begins; K6 and K8 compile that out where dh is a
// multiple of their chunk (one weight a chunk), read narrow rows in
// chunks of 8 there and rows of 4 heads' statistics as 16-byte loads
// (see "K6" and "K8" below). K6 takes the row max in a
// first, narrow pass over el (two-pass softmax, as the plain version),
// then the normaliser and the weighted sum in one wide pass, and divides
// once at the end. Sums run in registers in edge order, warp reductions
// are fixed xor butterflies: no atomics, deterministic results. Rows of
// any degree run the same loop. Gather indices are clamped into range
// (the JAX package's jnp.take(mode="clip")).

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef PGT_GAT_MODE
#error "define PGT_GAT_MODE (0 f32, 1 bf16, 2 fp8) before including"
#endif

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

enum XType { kF32 = 0, kBF16 = 1, kE4M3 = 2, kE5M2 = 3 };
// this library's row types (the header comment's modes)
constexpr int kZT = PGT_GAT_MODE == 0 ? kF32 : PGT_GAT_MODE == 1 ? kBF16
                                                                  : kE4M3;
constexpr int kGT = PGT_GAT_MODE == 0 ? kF32 : PGT_GAT_MODE == 1 ? kBF16
                                                                  : kE5M2;

template <int XT>
__host__ __device__ constexpr int elem_bytes() {
  return XT == kF32 ? 4 : XT == kBF16 ? 2 : 1;
}

// two fp8 values (low byte first) -> two floats, exactly
template <int XT>
__device__ __forceinline__ void fp8x2(unsigned int pair, float* o) {
  constexpr __nv_fp8_interpretation_t kind = XT == kE4M3 ? __NV_E4M3
                                                         : __NV_E5M2;
  const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), kind);
  const float2 f = __half22float2(__half2(r));
  o[0] = f.x;
  o[1] = f.y;
}

// VEC (8, 4 or 1; 8 for bf16 and fp8 only) consecutive elements of type
// XT from element i of p, as floats
template <int XT, int VEC>
__device__ __forceinline__ void load(const void* p, size_t i, float* o) {
  if constexpr (XT == kF32) {
    const float* q = static_cast<const float*>(p) + i;
    if constexpr (VEC == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(q));
      o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    } else {
      o[0] = __ldg(q);
    }
  } else if constexpr (XT == kBF16) {
    const unsigned short* q = static_cast<const unsigned short*>(p) + i;
    if constexpr (VEC == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
      const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        o[2 * t] = __uint_as_float(u[t] << 16);
        o[2 * t + 1] = __uint_as_float(u[t] & 0xffff0000u);
      }
    } else if constexpr (VEC == 4) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(q));
      o[0] = __uint_as_float(v.x << 16);
      o[1] = __uint_as_float(v.x & 0xffff0000u);
      o[2] = __uint_as_float(v.y << 16);
      o[3] = __uint_as_float(v.y & 0xffff0000u);
    } else {
      o[0] = __uint_as_float(static_cast<unsigned>(__ldg(q)) << 16);
    }
  } else {
    const unsigned char* q = static_cast<const unsigned char*>(p) + i;
    if constexpr (VEC == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(q));
      fp8x2<XT>(v.x, o);
      fp8x2<XT>(v.x >> 16, o + 2);
      fp8x2<XT>(v.y, o + 4);
      fp8x2<XT>(v.y >> 16, o + 6);
    } else if constexpr (VEC == 4) {
      const unsigned u = __ldg(reinterpret_cast<const unsigned*>(q));
      fp8x2<XT>(u, o);
      fp8x2<XT>(u >> 16, o + 2);
    } else {
      float t[2];
      fp8x2<XT>(static_cast<unsigned>(__ldg(q)), t);
      o[0] = t[0];
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.0f ? x : slope * x;
}

__device__ __forceinline__ long long row_ptr(const void* indptr, int is64,
                                             size_t i) {
  return is64 ? static_cast<const long long*>(indptr)[i]
              : static_cast<const int*>(indptr)[i];
}

__device__ __forceinline__ int clip(int i, int n) {
  return min(max(i, 0), n - 1);
}

// xor butterflies: every lane ends with the same value (a + b == b + a
// bit for bit), in a fixed order
template <int HM>
__device__ __forceinline__ void warp_max(float* v) {
#pragma unroll
  for (int h = 0; h < HM; ++h)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[h] = fmaxf(v[h], __shfl_xor_sync(kFull, v[h], off));
}

template <int HM>
__device__ __forceinline__ void warp_sum(float* v) {
#pragma unroll
  for (int h = 0; h < HM; ++h)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[h] += __shfl_xor_sync(kFull, v[h], off);
}

// the columns of one lane: chunk v starts at column (v*32 + lane)*VEC;
// its elements before split[v] lie in head head[v], the rest in head1[v]
// (the launcher picks VEC <= dh, so a chunk spans at most two heads)
template <int VEC, int NV, int HM>
struct Cols {
  int col[NV], head[NV], head1[NV], split[NV];
  bool ok[NV];
  __device__ __forceinline__ Cols(int lane, int F, int dh) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      col[v] = (v * 32 + lane) * VEC;
      ok[v] = col[v] < F;
      head[v] = ok[v] ? col[v] / dh : 0;
      split[v] = min(VEC, (head[v] + 1) * dh - col[v]);
      head1[v] = min(head[v] + 1, HM - 1);
    }
  }
  // the values of a per-head array at chunk v's two heads
  __device__ __forceinline__ void at(int v, const float* a, float& a0,
                                     float& a1) const {
    a0 = a1 = 0.0f;
#pragma unroll
    for (int h = 0; h < HM; ++h) {
      if (h == head[v]) a0 = a[h];
      if (h == head1[v]) a1 = a[h];
    }
  }
};

// per head h, the sum over the lane's elements in head h of y . acc, y the
// row yrow (type XT)
template <int XT, int VEC, int NV, int HM>
__device__ __forceinline__ void head_dots(const Cols<VEC, NV, HM>& c,
                                          const void* yrow,
                                          const float (&acc)[NV][VEC],
                                          float* dot) {
#pragma unroll
  for (int h = 0; h < HM; ++h) dot[h] = 0.0f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!c.ok[v]) continue;
    float y[VEC];
    load<XT, VEC>(yrow, c.col[v], y);
    float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (k < c.split[v]) t0 += y[k] * acc[v][k];
      else t1 += y[k] * acc[v][k];
    }
#pragma unroll
    for (int h = 0; h < HM; ++h) {
      if (h == c.head[v]) dot[h] += t0;
      if (h == c.head1[v] && c.split[v] < VEC) dot[h] += t1;
    }
  }
}

// ---------------------------------------------------------------------------
// K6
//
// The forward's design (PERF.md, PR 12, times each part of it):
//   - NEG mode: one accumulator per leaky branch. Each edge adds weight *
//     row into pos or neg by its branch (the weight's sign in shared
//     memory carries it), so a lane does one FMA an element and edge; out
//     = (pos + neg) / s, n_neg = neg / s. On f32 rows only where dh % 4 ==
//     0: at other dh (41) the chunks straddle two heads, the branch test
//     is per element and cost more than it saved there (not on bf16 or
//     e4m3 rows), so those rows keep a sum over all edges and one over
//     the negative ones. The choice follows dh and the row type, never
//     the load width: aligned or not, a row's sums are the same bits.
//   - fmaf for weight * value + sum.
//   - where dh % VEC == 0 (dh = 64) no chunk straddles two heads: one
//     weight a chunk, no per-element selects (a template flag). dh = 41
//     keeps the straddling path.
//   - el and er rows (H = 4) as one 16-byte load.
//   - narrow rows (bf16, e4m3) in chunks of 8 elements (16 or 8 bytes a
//     load) where dh % 8 == 0 and the rows allow.
// The row max stays a separate narrow pass, so m is the max of the same
// computed logits as before, and each weight is exp(logit - m) as in the
// plain version.

// the HM floats of row r of an [*, H] f32 array (0 past H): one 16-byte
// load where H = 4 and the array allows it (vec_rows), else H loads
template <int HM>
__device__ __forceinline__ void narrow_row(const float* p, size_t r, int H,
                                           bool vec_rows, float* o) {
  if constexpr (HM == 4) {
    if (vec_rows) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + r);
      o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
      return;
    }
  }
#pragma unroll
  for (int h = 0; h < HM; ++h) o[h] = h < H ? __ldg(p + r * H + h) : 0.0f;
}

// one 32-edge chunk of a row: this lane's edge (clipped source index and
// el row), or index 0 and zeros past the row's end. Fetched apart from
// the weights that use it: computing the weights inline at the load ran
// the f32 NEG mode 13 % slower on an H100 (PERF.md, PR 12)
template <int HM>
struct Edge {
  int i;
  float e[HM];
  __device__ __forceinline__ void fetch(const int* src, const float* el,
                                        long long base, long long end,
                                        int lane, int R, int H,
                                        bool vec_rows) {
    i = 0;
    if (lane < end - base) {
      i = clip(__ldg(src + base + lane), R);
      narrow_row<HM>(el, i, H, vec_rows, e);
    } else {
#pragma unroll
      for (int h = 0; h < HM; ++h) e[h] = 0.0f;
    }
  }
};

template <int VEC>
__device__ __forceinline__ void store_out(float* p, const float* v) {
  if constexpr (VEC == 8) {
    store<4>(p, v);
    store<4>(p + 4, v + 4);
  } else {
    store<VEC>(p, v);
  }
}

// STRADDLE: a chunk of VEC elements may span two heads (dh % VEC != 0);
// SPLIT: the NEG mode sums each leaky branch apart
template <int VEC, int NV, int HM, bool NEG, bool STRADDLE, bool SPLIT>
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_kernel(const void* __restrict__ z, const float* __restrict__ el,
               const float* __restrict__ er, const void* __restrict__ indptr,
               int indptr_64, const int* __restrict__ src,
               long long src_stride, float* __restrict__ out,
               float* __restrict__ m_out, float* __restrict__ s_out,
               float* __restrict__ nneg_out, float* __restrict__ wneg_out,
               int R, int n, int H, int dh, float slope, int vec_rows) {
  constexpr bool kSplit = NEG && SPLIT;
  __shared__ float wsh[kWarps][32][HM];
  // NEG without the split: the weight again where the edge is on the
  // negative branch, else 0
  __shared__ float nsh[NEG && !kSplit ? kWarps : 1][32][HM];
  const int part = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;  // whole warp leaves together
  const int F = H * dh;
  const size_t zbase = static_cast<size_t>(part) * R * F;
  el += static_cast<size_t>(part) * R * H;
  src += static_cast<size_t>(part) * src_stride;
  const size_t orow = static_cast<size_t>(part) * n + row;
  const size_t rp = static_cast<size_t>(part) * (n + 1) + row;
  const long long beg = row_ptr(indptr, indptr_64, rp);
  const long long end = row_ptr(indptr, indptr_64, rp + 1);

  float er_r[HM], mx[HM], ssum[HM], nsum[HM];
  narrow_row<HM>(er, orow, H, vec_rows, er_r);
#pragma unroll
  for (int h = 0; h < HM; ++h) {
    mx[h] = -INFINITY;
    ssum[h] = nsum[h] = 0.0f;
  }
  // narrow pass: the row max of every head (each lane its edges beg +
  // lane + 32k in order, then a butterfly: the same max as before); not
  // unrolled: four edges' el loads in flight a lane ran slower (PERF.md)
#pragma unroll 1
  for (long long e = beg + lane; e < end; e += 32) {
    float ev[HM];
    narrow_row<HM>(el, clip(__ldg(src + e), R), H, vec_rows, ev);
#pragma unroll
    for (int h = 0; h < HM; ++h)
      if (h < H) mx[h] = fmaxf(mx[h], leaky(ev[h] + er_r[h], slope));
  }
  warp_max<HM>(mx);
  if (end == beg) {
#pragma unroll
    for (int h = 0; h < HM; ++h) mx[h] = 0.0f;
  }

  // wide pass: normaliser and weighted row sums
  const Cols<VEC, NV, HM> c(lane, F, dh);
  // kSplit: acc the positive branch, accn the negative one; otherwise
  // acc every edge and accn (NEG) the negative ones
  float acc[NV][VEC], accn[NEG ? NV : 1][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      acc[v][k] = 0.0f;
      if constexpr (NEG) accn[v][k] = 0.0f;
    }
  float(*w)[HM] = wsh[warp];
  float(*wn)[HM] = nsh[NEG && !kSplit ? warp : 0];
  Edge<HM> cur;
  for (long long base = beg; base < end; base += 32) {
    const int cnt = static_cast<int>(min(32LL, end - base));
    cur.fetch(src, el, base, end, lane, R, H, vec_rows);
    if (lane < cnt) {
#pragma unroll
      for (int h = 0; h < HM; ++h) {
        if (h < H) {
          const float lp = cur.e[h] + er_r[h];
          const float wt = expf(leaky(lp, slope) - mx[h]);
          ssum[h] += wt;
          if constexpr (NEG) {
            const float wnt = lp > 0.0f ? 0.0f : wt;
            nsum[h] += wnt;
            if constexpr (kSplit) {
              w[lane][h] = lp > 0.0f ? wt : -wt;  // the sign: the branch
            } else {
              w[lane][h] = wt;
              wn[lane][h] = wnt;
            }
          } else {
            w[lane][h] = wt;
          }
        }
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int s = __shfl_sync(kFull, cur.i, j);
      const size_t rowz = zbase + static_cast<size_t>(s) * F;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!c.ok[v]) continue;
        float y[VEC];
        load<kZT, VEC>(z, rowz + c.col[v], y);
        if constexpr (!STRADDLE) {
          const float wv = w[j][c.head[v]];
          if constexpr (kSplit) {
            const bool ng = __float_as_uint(wv) >> 31;
            const float wa = fabsf(wv);
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              if (ng) accn[v][k] = fmaf(wa, y[k], accn[v][k]);
              else acc[v][k] = fmaf(wa, y[k], acc[v][k]);
            }
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[v][k] = fmaf(wv, y[k], acc[v][k]);
            if constexpr (NEG) {
              const float wnv = wn[j][c.head[v]];
#pragma unroll
              for (int k = 0; k < VEC; ++k)
                accn[v][k] = fmaf(wnv, y[k], accn[v][k]);
            }
          }
        } else {
          const float w0 = w[j][c.head[v]], w1 = w[j][c.head1[v]];
          if constexpr (kSplit) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float wv = k < c.split[v] ? w0 : w1;
              const float wa = fabsf(wv);
              if (__float_as_uint(wv) >> 31)
                accn[v][k] = fmaf(wa, y[k], accn[v][k]);
              else
                acc[v][k] = fmaf(wa, y[k], acc[v][k]);
            }
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[v][k] = fmaf(k < c.split[v] ? w0 : w1, y[k], acc[v][k]);
            if constexpr (NEG) {
              const float n0 = wn[j][c.head[v]], n1 = wn[j][c.head1[v]];
#pragma unroll
              for (int k = 0; k < VEC; ++k)
                accn[v][k] = fmaf(k < c.split[v] ? n0 : n1, y[k],
                                  accn[v][k]);
            }
          }
        }
      }
    }
    __syncwarp();
  }
  warp_sum<HM>(ssum);
  if constexpr (NEG) warp_sum<HM>(nsum);
  if (end == beg) {
#pragma unroll
    for (int h = 0; h < HM; ++h) ssum[h] = 1.0f;
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HM; ++h) {
      if (h < H) {
        m_out[orow * H + h] = mx[h];
        s_out[orow * H + h] = ssum[h];
        if constexpr (NEG) wneg_out[orow * H + h] = nsum[h] / ssum[h];
      }
    }
  }
  float* op = out + orow * F;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (c.ok[v]) {
      float s0, s1;
      c.at(v, ssum, s0, s1);
      float y[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float t = kSplit ? acc[v][k] + accn[v][k] : acc[v][k];
        y[k] = t / (!STRADDLE || k < c.split[v] ? s0 : s1);
      }
      store_out<VEC>(op + c.col[v], y);
      if constexpr (NEG) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          y[k] = accn[v][k] / (!STRADDLE || k < c.split[v] ? s0 : s1);
        store_out<VEC>(nneg_out + orow * F + c.col[v], y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K8 (pass B, src-keyed over the transpose CSR): d_z, d_el
//
// The design takes K6's across (PERF.md times each part of it):
//   - one accumulator per leaky branch. beta = alpha on the positive
//     branch and slope * alpha on the negative one, so each edge adds
//     alpha * g[dst] into pos or neg by its branch (the weight's sign in
//     shared memory carries it), one FMA an element and edge, and at the
//     end d_z = pos + neg and sum_e beta_e g[dst_e] = fma(slope, neg,
//     pos). At every dh and row type: where chunks straddle two heads (dh
//     = 41) the branch test is per element, and two FMA accumulators
//     (alpha * g and beta * g) ran 42 % slower there on f32 rows. Aligned
//     or not, a row's d_z is the same bits (one form, every load width).
//   - where dh % VEC == 0 no chunk straddles two heads: one weight a
//     chunk, no per-element selects (a template flag).
//   - the stats row (er, m, s, rho of 4 heads) as four 16-byte loads, the
//     row's own el as one, fetched apart from the weights that use them.
//   - narrow g rows (bf16, e5m2) in chunks of 8 elements where dh % 8 ==
//     0 and the rows allow; the row's own z (bf16, e4m3) in the dot
//     products at the same width.
//   - one chunk a lane where it covers the row (no registers for a
//     second), and the cells' instances held to 64 registers: 4 blocks
//     resident (gat_bwd_src_kernel_4).

// one 32-edge chunk of a row: this lane's edge (clipped destination
// index and its stats row: er, m, s, rho), or index 0 past the row's end.
// Fetched apart from the weights that use it (as K6's Edge)
template <int HM>
struct DstStats {
  int i;
  float er[HM], m[HM], s[HM], rho[HM];
  __device__ __forceinline__ void fetch(const int* dst_t, const float* stats,
                                        long long base, long long end,
                                        int lane, int n, int H,
                                        bool vec_rows) {
    i = 0;
    if (lane < end - base) {
      i = clip(__ldg(dst_t + base + lane), n);
      const size_t r = static_cast<size_t>(i) * 4;
      narrow_row<HM>(stats, r, H, vec_rows, er);
      narrow_row<HM>(stats, r + 1, H, vec_rows, m);
      narrow_row<HM>(stats, r + 2, H, vec_rows, s);
      narrow_row<HM>(stats, r + 3, H, vec_rows, rho);
    }
  }
};

// STRADDLE: a chunk of VEC elements may span two heads (dh % VEC != 0)
template <int VEC, int NV, int HM, bool STRADDLE>
__device__ __forceinline__ void gat_bwd_src(
    const void* __restrict__ z, const float* __restrict__ el,
    const float* __restrict__ stats, const void* __restrict__ g,
    const void* __restrict__ indptr_t, int indptr_64,
    const int* __restrict__ dst_t, long long dst_stride,
    float* __restrict__ d_z, float* __restrict__ d_el, int R, int n, int H,
    int dh, float slope, int vec_rows) {
  // alpha, signed by its branch (negative: the negative branch)
  __shared__ float wsh[kWarps][32][HM];
  const int part = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= R) return;
  const int F = H * dh;
  stats += static_cast<size_t>(part) * n * 4 * H;
  const size_t gbase = static_cast<size_t>(part) * n * F;
  dst_t += static_cast<size_t>(part) * dst_stride;
  const size_t orow = static_cast<size_t>(part) * R + row;
  const size_t rp = static_cast<size_t>(part) * (R + 1) + row;
  const long long beg = row_ptr(indptr_t, indptr_64, rp);
  const long long end = row_ptr(indptr_t, indptr_64, rp + 1);

  float el_r[HM], brho[HM];
  narrow_row<HM>(el, orow, H, vec_rows, el_r);
#pragma unroll
  for (int h = 0; h < HM; ++h) brho[h] = 0.0f;
  const Cols<VEC, NV, HM> c(lane, F, dh);
  float pos[NV][VEC], neg[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < VEC; ++k) pos[v][k] = neg[v][k] = 0.0f;
  float(*w)[HM] = wsh[warp];
  DstStats<HM> cur;
  for (long long base = beg; base < end; base += 32) {
    const int cnt = static_cast<int>(min(32LL, end - base));
    cur.fetch(dst_t, stats, base, end, lane, n, H, vec_rows);
    if (lane < cnt) {
#pragma unroll
      for (int h = 0; h < HM; ++h) {
        if (h < H) {
          const float lp = el_r[h] + cur.er[h];
          const float a = expf(leaky(lp, slope) - cur.m[h]) / cur.s[h];
          const float b = lp > 0.0f ? a : a * slope;
          brho[h] = fmaf(b, cur.rho[h], brho[h]);
          w[lane][h] = lp > 0.0f ? a : -a;  // the sign: the branch
        }
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int dj = __shfl_sync(kFull, cur.i, j);
      const size_t rowg = gbase + static_cast<size_t>(dj) * F;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!c.ok[v]) continue;
        float y[VEC];
        load<kGT, VEC>(g, rowg + c.col[v], y);
        if constexpr (!STRADDLE) {
          const float wv = w[j][c.head[v]];
          const bool ng = __float_as_uint(wv) >> 31;
          const float wa = fabsf(wv);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            if (ng) neg[v][k] = fmaf(wa, y[k], neg[v][k]);
            else pos[v][k] = fmaf(wa, y[k], pos[v][k]);
          }
        } else {
          const float w0 = w[j][c.head[v]], w1 = w[j][c.head1[v]];
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float wv = k < c.split[v] ? w0 : w1;
            const float wa = fabsf(wv);
            if (__float_as_uint(wv) >> 31)
              neg[v][k] = fmaf(wa, y[k], neg[v][k]);
            else
              pos[v][k] = fmaf(wa, y[k], pos[v][k]);
          }
        }
      }
    }
    __syncwarp();
  }
  // d_z = pos + neg into pos, the beta-weighted sum into neg
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float p = pos[v][k], q = neg[v][k];
      pos[v][k] = p + q;
      neg[v][k] = fmaf(slope, q, p);
    }
  float* dzp = d_z + orow * F;
#pragma unroll
  for (int v = 0; v < NV; ++v)
    if (c.ok[v]) store_out<VEC>(dzp + c.col[v], pos[v]);
  // d_el = z[r] . (sum_e beta_e g[dst_e]) - sum_e beta_e rho[dst_e]
  float dot[HM];
  head_dots<kZT, VEC, NV, HM>(
      c, static_cast<const unsigned char*>(z) + orow * F * elem_bytes<kZT>(),
      neg, dot);
  warp_sum<HM>(dot);
  warp_sum<HM>(brho);
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HM; ++h)
      if (h < H) d_el[orow * H + h] = dot[h] - brho[h];
  }
}

#define PGT_K8_PARAMS                                                        \
  const void *__restrict__ z, const float *__restrict__ el,                  \
      const float *__restrict__ stats, const void *__restrict__ g,           \
      const void *__restrict__ indptr_t, int indptr_64,                      \
      const int *__restrict__ dst_t, long long dst_stride,                   \
      float *__restrict__ d_z, float *__restrict__ d_el, int R, int n, int H, \
      int dh, float slope, int vec_rows
#define PGT_K8_ARGS                                                        \
  z, el, stats, g, indptr_t, indptr_64, dst_t, dst_stride, d_z, d_el, R, n, \
      H, dh, slope, vec_rows

template <int VEC, int NV, int HM, bool STRADDLE>
__global__ void __launch_bounds__(kWarps * 32)
gat_bwd_src_kernel(PGT_K8_PARAMS) {
  gat_bwd_src<VEC, NV, HM, STRADDLE>(PGT_K8_ARGS);
}

// The cells' instances, 8 elements a lane over 4 heads (F = 256: e5m2 /
// bf16 g rows in one chunk of 8, f32 in two of 4; dh = 41 in two chunks
// of 4 that straddle heads), kept to 64 registers so that 4 blocks stay
// resident: a gather bound by its latency, K8 ran 1.7x faster on e5m2
// rows at dh = 64 than at the 96 registers (2 blocks) the compiler chose
// (PERF.md). On f32 rows at dh = 41 the cap's spills cost more
// than the fourth block gained: that instance keeps its own 80 (3 blocks).
template <int VEC, int NV, int HM, bool STRADDLE>
__global__ void __launch_bounds__(kWarps * 32, 4)
gat_bwd_src_kernel_4(PGT_K8_PARAMS) {
  gat_bwd_src<VEC, NV, HM, STRADDLE>(PGT_K8_ARGS);
}
#undef PGT_K8_PARAMS
#undef PGT_K8_ARGS

// ---------------------------------------------------------------------------
// launch: VEC from F, dh and the alignment, NV from the row width, HM from
// the head count

struct Shape {
  int P, rows, H, dh, vec, nv, hm;
};

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// K6's shape: VEC 8 (narrow rows where dh % 8 == 0, H <= 4 and the rows
// allow), else 4 (F % 4 == 0, dh >= 4 and the rows allow), else 1; NV
// chunks a lane; straddle: a chunk may span two heads (VEC 4 with dh % 4
// != 0). False when the kernel cannot take the shape (the wrapper checks
// first)
bool pick_fwd(Shape& sh, bool& straddle, const void* z, bool out_aligned) {
  const int F = sh.H * sh.dh;
  constexpr int eb = elem_bytes<kZT>();
  if (sh.H < 1 || sh.H > 16 || sh.dh < 1) return false;
  if (kZT != kF32 && sh.H <= 4 && sh.dh % 8 == 0 && aligned(z, 8 * eb) &&
      out_aligned)
    sh.vec = 8;
  else
    sh.vec = (F % 4 == 0 && sh.dh >= 4 && aligned(z, 4 * eb) && out_aligned)
                 ? 4 : 1;
  const int need = (F + 32 * sh.vec - 1) / (32 * sh.vec);
  if (need > (sh.vec == 8 ? 8 : 16)) return false;
  sh.nv = need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8 : 16;
  sh.hm = sh.H <= 4 ? 4 : 16;
  straddle = sh.vec == 4 && sh.dh % 4 != 0;
  return true;
}

template <int VEC, bool ST, bool SP, bool NEG, typename... A>
void launch_fwd(const Shape& sh, cudaStream_t st, A... args) {
  const dim3 grid((sh.rows + kWarps - 1) / kWarps, sh.P);
  const dim3 block(kWarps * 32);
#define PGT_K6(NV_, HM_) \
  gat_fwd_kernel<VEC, NV_, HM_, NEG, ST, SP><<<grid, block, 0, st>>>(args...)
  if constexpr (VEC == 8) {  // H <= 4, F <= 2048 (pick_fwd)
    switch (sh.nv) {
      case 2: PGT_K6(2, 4); break;
      case 4: PGT_K6(4, 4); break;
      default: PGT_K6(8, 4); break;
    }
  } else if (sh.hm == 4) {
    switch (sh.nv) {
      case 2: PGT_K6(2, 4); break;
      case 4: PGT_K6(4, 4); break;
      case 8: PGT_K6(8, 4); break;
      default: PGT_K6(16, 4); break;
    }
  } else {
    switch (sh.nv) {
      case 2: PGT_K6(2, 16); break;
      case 4: PGT_K6(4, 16); break;
      case 8: PGT_K6(8, 16); break;
      default: PGT_K6(16, 16); break;
    }
  }
#undef PGT_K6
}

// the split on narrow rows, and on f32 rows where dh % 4 == 0
template <bool NEG, typename... A>
int dispatch_fwd(const Shape& sh, bool straddle, cudaStream_t st,
                 A... args) {
  constexpr bool kNarrow = kZT != kF32;
  if (sh.vec == 8) {  // narrow rows, dh % 8 == 0
    if constexpr (kNarrow) launch_fwd<8, false, NEG, NEG>(sh, st, args...);
  } else if (sh.vec == 4 && !straddle) {  // dh % 4 == 0
    launch_fwd<4, false, NEG, NEG>(sh, st, args...);
  } else if (sh.vec == 4) {  // dh % 4 != 0
    launch_fwd<4, true, kNarrow && NEG, NEG>(sh, st, args...);
  } else if (kNarrow || sh.dh % 4 == 0) {
    launch_fwd<1, false, NEG, NEG>(sh, st, args...);
  } else {
    launch_fwd<1, false, false, NEG>(sh, st, args...);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8's shape: as pick_fwd, with every wide row (z, g, d_z) allowing the
// width, and 8-element chunks where g is narrow
bool pick_bwd(Shape& sh, bool& straddle, const void* z, const void* g,
              bool dz_aligned) {
  const int F = sh.H * sh.dh;
  constexpr int ez = elem_bytes<kZT>(), eg = elem_bytes<kGT>();
  if (sh.H < 1 || sh.H > 16 || sh.dh < 1) return false;
  if (kGT != kF32 && sh.H <= 4 && sh.dh % 8 == 0 && aligned(z, 8 * ez) &&
      aligned(g, 8 * eg) && dz_aligned)
    sh.vec = 8;
  else
    sh.vec = (F % 4 == 0 && sh.dh >= 4 && aligned(z, 4 * ez) &&
              aligned(g, 4 * eg) && dz_aligned)
                 ? 4 : 1;
  const int need = (F + 32 * sh.vec - 1) / (32 * sh.vec);
  if (need > (sh.vec == 8 ? 8 : 16)) return false;
  // one chunk a lane where it covers the row: no registers for a second
  sh.nv = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8 : 16;
  sh.hm = sh.H <= 4 ? 4 : 16;
  straddle = sh.vec == 4 && sh.dh % 4 != 0;
  return true;
}

template <int VEC, bool ST, typename... A>
void launch_bwd(const Shape& sh, cudaStream_t st, A... args) {
  const dim3 grid((sh.rows + kWarps - 1) / kWarps, sh.P);
  const dim3 block(kWarps * 32);
#define PGT_K8(NV_, HM_)                                                \
  if constexpr (VEC * NV_ == 8 && HM_ == 4 && (!ST || kGT != kF32))    \
    gat_bwd_src_kernel_4<VEC, NV_, HM_, ST>                             \
        <<<grid, block, 0, st>>>(args...);                              \
  else                                                                  \
    gat_bwd_src_kernel<VEC, NV_, HM_, ST><<<grid, block, 0, st>>>(args...)
  if constexpr (VEC == 8) {  // H <= 4, F <= 2048 (pick_bwd)
    switch (sh.nv) {
      case 1: PGT_K8(1, 4); break;
      case 2: PGT_K8(2, 4); break;
      case 4: PGT_K8(4, 4); break;
      default: PGT_K8(8, 4); break;
    }
  } else if (sh.hm == 4) {
    switch (sh.nv) {
      case 1: PGT_K8(1, 4); break;
      case 2: PGT_K8(2, 4); break;
      case 4: PGT_K8(4, 4); break;
      case 8: PGT_K8(8, 4); break;
      default: PGT_K8(16, 4); break;
    }
  } else {
    switch (sh.nv) {
      case 1: PGT_K8(1, 16); break;
      case 2: PGT_K8(2, 16); break;
      case 4: PGT_K8(4, 16); break;
      case 8: PGT_K8(8, 16); break;
      default: PGT_K8(16, 16); break;
    }
  }
#undef PGT_K8
}

template <typename... A>
int dispatch_bwd(const Shape& sh, bool straddle, cudaStream_t st,
                 A... args) {
  if (sh.vec == 8) {  // narrow g rows, dh % 8 == 0
    if constexpr (kGT != kF32) launch_bwd<8, false>(sh, st, args...);
  } else if (sh.vec == 4 && straddle) {  // dh % 4 != 0
    launch_bwd<4, true>(sh, st, args...);
  } else if (sh.vec == 4) {
    launch_bwd<4, false>(sh, st, args...);
  } else {
    launch_bwd<1, false>(sh, st, args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PGT_CAT2(a, b) a##b
#define PGT_CAT(a, b) PGT_CAT2(a, b)
#define PGT_SUFFIX PGT_CAT(_m, PGT_GAT_MODE)

// K6, entry pgt_gat_fwd_m<mode>. z [P, R, H*dh] of this mode's z type;
// el [P, R, H], er [P, n, H] f32; indptr [P, n + 1] (int32, or int64 when
// indptr_64); src [P, *] int32 with part stride src_stride; out [P, n,
// H*dh], m, s [P, n, H] f32; n_neg [P, n, H*dh] and w_neg [P, n, H] f32,
// or both null (then the NEG mode is not run). All contiguous. Returns
// cudaGetLastError().
extern "C" int PGT_CAT(pgt_gat_fwd, PGT_SUFFIX)(
    const void* z, const void* el, const void* er, const void* indptr,
    int indptr_64, const void* src, long long src_stride, void* out, void* m,
    void* s, void* n_neg, void* w_neg, int P, int R, int n, int H, int dh,
    float slope, void* stream) {
  if (P == 0 || n == 0) return 0;
  Shape sh{P, n, H, dh, 0, 0, 0};
  const bool neg = n_neg != nullptr;
  bool straddle = false;
  if (R <= 0 || neg != (w_neg != nullptr) ||
      !pick_fwd(sh, straddle, z,
                aligned(out, 16) && (!neg || aligned(n_neg, 16))))
    return static_cast<int>(cudaErrorInvalidValue);
  // el / er rows as 16-byte loads
  const int vec_rows = H == 4 && aligned(el, 16) && aligned(er, 16);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto elf = static_cast<const float*>(el);
  const auto erf = static_cast<const float*>(er);
  const auto srci = static_cast<const int*>(src);
  const auto outf = static_cast<float*>(out);
  const auto mf = static_cast<float*>(m);
  const auto sf = static_cast<float*>(s);
  const auto nf = static_cast<float*>(n_neg);
  const auto wf = static_cast<float*>(w_neg);
  if (neg)
    return dispatch_fwd<true>(sh, straddle, st, z, elf, erf, indptr,
                              indptr_64, srci, src_stride, outf, mf, sf, nf,
                              wf, R, n, H, dh, slope, vec_rows);
  return dispatch_fwd<false>(sh, straddle, st, z, elf, erf, indptr,
                             indptr_64, srci, src_stride, outf, mf, sf, nf,
                             wf, R, n, H, dh, slope, vec_rows);
}

// K8, entry pgt_gat_bwd_src_m<mode>. z [P, R, H*dh] of this mode's z type
// (the forward's), el [P, R, H] f32; stats [P, n, 4, H] f32 = (er, m, s,
// rho); g [P, n, H*dh] of this mode's g type; indptr_t [P, R + 1] (int32,
// or int64 when indptr_64); dst_t [P, *] int32 with part stride
// dst_stride; d_z [P, R, H*dh], d_el [P, R, H] f32. All contiguous.
// Returns cudaGetLastError().
extern "C" int PGT_CAT(pgt_gat_bwd_src, PGT_SUFFIX)(
    const void* z, const void* el, const void* stats, const void* g,
    const void* indptr_t, int indptr_64, const void* dst_t,
    long long dst_stride, void* d_z, void* d_el, int P, int R, int n, int H,
    int dh, float slope, void* stream) {
  if (P == 0 || R == 0) return 0;
  Shape sh{P, R, H, dh, 0, 0, 0};
  bool straddle = false;
  if (n <= 0 || !pick_bwd(sh, straddle, z, g, aligned(d_z, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the stats rows and el rows as 16-byte loads
  const int vec_rows = H == 4 && aligned(stats, 16) && aligned(el, 16);
  return dispatch_bwd(
      sh, straddle, static_cast<cudaStream_t>(stream), z,
      static_cast<const float*>(el), static_cast<const float*>(stats), g,
      indptr_t, indptr_64, static_cast<const int*>(dst_t), dst_stride,
      static_cast<float*>(d_z), static_cast<float*>(d_el), R, n, H, dh,
      slope, vec_rows);
}
