"""GAT edge-softmax attention aggregation, forward and backward — port of
``pipegcn_tpu/ops/gat_bucket.py`` (``make_device_gat_fn``: ``fwd_pass``
and the custom VJP ``gat_bwd``, its pass A and pass B) and of the
aggregation inside ``pipegcn_tpu/models/sage.py:_gat_layer`` (the
raw-edge segment max / sum / weighted sum and its autodiff backward).

For every destination row d and head h, over the in-edges e = (src, d)
of the destination CSR ``(indptr, src)``:

    l_e   = leaky(el[src, h] + er[d, h])
    m     = max_e l_e                    (0 for a row without edges)
    s     = sum_e exp(l_e - m)           (1 for a row without edges)
    out_d = sum_e exp(l_e - m) * z[src, h, :] / s

z ``[P, R, H, dh]`` holds every source row of the part (inner rows
then halo rows), el ``[P, R, H]`` and er ``[P, n, H]`` f32; out ``[P, n,
H, dh]`` f32. z is f32 or bf16 (the compute dtype; f32 on the bf16 logits
layer), or, behind ``make_device_gat_fn``'s gather transport
(``rem_dtype``), the e4m3 / bf16 cast of it that K10 makes
(``ops/bucket_spmm.transport_cast``): the forward, pass A and pass B's
row-local ``z[r]`` all read that one quantized z (``gat_bucket.py:408``,
``:466-471``), which the forward saves for the backward. The cotangent
rows pass B gathers are e5m2 / bf16 casts of g under the transport, else
g in z's dtype (``gat_bucket.py:459``). Every logit, statistic and sum
stays f32; ``d_z`` is cast to z's dtype once.

The two JAX formulations compute this one function and differ only
in summation order and in the empty-row clamp (``max(s, 1e-16)`` in
``_gat_layer``, the ``s = 1`` sentinel in ``gat_bucket``): their bucket
tables exist to avoid TPU scatters, and a CSR pass has none, so one set
of kernels serves both.

The backward follows ``gat_bwd`` (``gat_bucket.py:401-505``), with
``alpha = exp(l - m) / s``, ``rho[d, h] = sum_k g[d, h, k] * out[d, h, k]``
and ``leaky'(x) = 1 if x > 0 else slope``:

  - pass A (dst-keyed):
    ``d_er[d] = sum_e alpha * (g[d] . z[src] - rho[d]) * leaky'(l)``. For
    a row with edges ``sum_e alpha = 1`` and ``g[d] . out[d] = rho[d]``,
    so this is ``(1 - slope) * (rho * w_neg - g . n_neg)`` with ``n_neg =
    sum alpha * z[src]`` and ``w_neg = sum alpha`` over the row's edges on
    the negative leaky branch, which the forward returns in its ``neg``
    mode: :func:`gat_d_er`, elementwise, no second pass over the edges
    (0 for an empty row, whose n_neg and w_neg are 0);
  - pass B (src-keyed, the transpose CSR ``(indptr_t, dst_t)`` that
    ``parallel/staging.stage`` builds): ``d_z[r] = sum_e alpha * g[dst]``
    and ``d_el[r] = sum_e alpha * (g[dst] . z[r] - rho[dst]) * leaky'(l)``.

Treating m as a constant is exact: the normalised output does not depend
on it.

Kernels (``csrc/gat_attn.cuh``, one library a row-type mode: f32 z and g
``gat_attn.cu``, bf16 ``gat_attn_bf16.cu``, e4m3 z and e5m2 g
``gat_attn_fp8.cu``): K6 ``gat_fwd`` (also returns m and s, and in its
``neg`` mode n_neg and w_neg, summing each leaky branch apart, on f32
rows only where no 4-element chunk straddles two heads: out is the two
branches' sums added, n_neg the negative one) and K8 ``gat_bwd_src``
(pass B), launched
for CUDA tensors and counted in ``<wrapper>.launches``. CPU
tensors take the plain versions, which walk the edges in chunks of
``PLAIN_CHUNK`` with ``index_add_`` and never hold an ``[E, H, dh]``
tensor; anything else raises. :class:`GatAttention` ties them together
as an autograd function.

The plain versions take an optional :class:`LeakyBranch`: the el/er of
another run, from which they take the leaky branch of every edge instead
of from their own logits (counting where the two disagree), so a caller
holding two runs against each other compares them on one set of branches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from . import _build
from .bucket_spmm import _transport, transport_dtypes

# edges per step of the plain versions: bounds their [chunk, H, dh]
# gathered message tensors
PLAIN_CHUNK = 1 << 20
# the widest row the kernels take, by the vector width they load it with
# (32 lanes x 16 chunks of 1 or 4 elements), and the most heads
MAX_F_SCALAR, MAX_F_VEC4, MAX_HEADS = 512, 2048, 16

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# the row-type modes: (z dtype, g dtype) -> (mode, library)
_MODES = {
    (torch.float32, torch.float32): (0, "gat_attn"),
    (torch.bfloat16, torch.bfloat16): (1, "gat_attn_bf16"),
    (torch.float8_e4m3fn, torch.float8_e5m2): (2, "gat_attn_fp8"),
}
_G_OF = {z: g for z, g in _MODES}  # z dtype -> its mode's g dtype
LIBRARIES = tuple(lib for _, lib in _MODES.values())


def _signatures(mode: int):
    return {
        f"pgt_gat_fwd_m{mode}": [_P, _P, _P, _P, _I, _P, _LL, _P, _P, _P,
                                 _P, _P, _I, _I, _I, _I, _I, _F, _P],
        f"pgt_gat_bwd_src_m{mode}": [_P, _P, _P, _P, _P, _I, _P, _LL, _P,
                                     _P, _I, _I, _I, _I, _I, _F, _P],
    }

Transpose = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class LeakyBranch:
    """The leaky branch of another run: the el ``[P, R, H]`` and er
    ``[P, n, H]`` that run fed the attention. ``flips`` counts the
    edge-heads whose branch differs from the one this run's own logits
    would take, out of ``elements``."""

    el: torch.Tensor
    er: torch.Tensor
    flips: int = 0
    elements: int = 0


def _leaky(x, pos, slope):
    return torch.where(pos, x, slope * x)


def _dleaky(pos, slope):
    return torch.where(pos, 1.0, slope)


def _check(name, z, el, er, indptr, idx, n_rows):
    """z [P, R, H, dh] f32, bf16 or e4m3, el [P, R, H] f32, er [P, n, H]
    f32, a CSR ``indptr [P, n_rows + 1]`` (int32/int64) with ``idx [P,
    E]`` int32, all on one device."""
    if z.dim() != 4 or el.dim() != 3 or er.dim() != 3:
        raise ValueError(f"{name}: z must be [P, R, H, dh], el [P, R, H], "
                         f"er [P, n, H]; got {tuple(z.shape)}, "
                         f"{tuple(el.shape)}, {tuple(er.shape)}")
    P, R, H, _ = z.shape
    if el.shape != (P, R, H) or er.shape[0] != P or er.shape[2] != H:
        raise ValueError(f"{name}: shape mismatch: z {tuple(z.shape)}, el "
                         f"{tuple(el.shape)}, er {tuple(er.shape)}")
    if indptr.dim() != 2 or indptr.shape != (P, n_rows + 1) \
            or idx.dim() != 2 or idx.shape[0] != P:
        raise ValueError(f"{name}: CSR shape mismatch: indptr "
                         f"{tuple(indptr.shape)}, idx {tuple(idx.shape)} "
                         f"for P={P}, {n_rows} rows")
    if z.dtype not in _G_OF or el.dtype != torch.float32 \
            or er.dtype != torch.float32:
        raise TypeError(f"{name}: z must be float32, bfloat16 or "
                        f"float8_e4m3fn (got {z.dtype}), el and er float32")
    if indptr.dtype not in (torch.int32, torch.int64) \
            or idx.dtype != torch.int32:
        raise TypeError(f"{name}: indptr must be int32/int64, the index "
                        "list int32")
    devs = {t.device for t in (z, el, er, indptr, idx)}
    if len(devs) != 1:
        raise ValueError(f"{name}: arguments on different devices: {devs}")


def _edges(indptr_p, idx_p, n_idx):
    """(row of every edge, its clipped index), both int64, of one part."""
    n_rows = indptr_p.shape[0] - 1
    n_e = int(indptr_p[-1])
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=idx_p.device), indptr_p.diff().long())
    return rows, idx_p[:n_e].long().clamp_(0, n_idx - 1)


def _pos(lp, branch, p, src_e, dst_e, count):
    """The leaky branch (x > 0) of each edge-head: from this run's logits
    ``lp``, or from ``branch``'s el/er (flips counted when ``count``)."""
    own = lp > 0
    if branch is None:
        return own
    ref = (branch.el[p].index_select(0, src_e)
           + branch.er[p].index_select(0, dst_e)) > 0
    if count:
        branch.flips += int((ref != own).sum())
        branch.elements += ref.numel()
    return ref


# ---------------------------------------------------------------------------
# K6: the forward


def gat_fwd_plain(z: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                  indptr: torch.Tensor, src: torch.Tensor,
                  slope: float = 0.2,
                  branch: Optional[LeakyBranch] = None,
                  chunk: int = PLAIN_CHUNK, neg: bool = False):
    """Plain PyTorch version of K6: ``(out [P, n, H, dh], m [P, n, H],
    s [P, n, H])``, the row max by ``scatter_reduce_`` then the
    normaliser and the weighted sum by ``index_add_``, in chunks of edges,
    over z's rows widened to f32 (``.float()``); with ``neg`` also ``n_neg
    [P, n, H, dh]`` and ``w_neg [P, n, H]``, the same sums over the edges
    on the negative leaky branch alone. Runs on any device."""
    n = er.shape[1]
    _check("gat_fwd", z, el, er, indptr, src, n)
    P, R, H, dh = z.shape
    dev = z.device
    out = torch.zeros((P, n, H, dh), dtype=torch.float32, device=dev)
    m = torch.full((P, n, H), float("-inf"), device=dev)
    s = torch.zeros((P, n, H), device=dev)
    if neg:
        n_neg, w_neg = torch.zeros_like(out), torch.zeros_like(s)
    for p in range(P):
        rows, cols = _edges(indptr[p], src[p], R)

        def logits(e0, e1, count):
            r, c = rows[e0:e1], cols[e0:e1]
            lp = el[p].index_select(0, c) + er[p].index_select(0, r)
            pos = _pos(lp, branch, p, c, r, count)
            return r, c, _leaky(lp, pos, slope), pos

        for e0 in range(0, rows.numel(), chunk):
            r, _, lg, _ = logits(e0, e0 + chunk, True)
            m[p].scatter_reduce_(0, r[:, None].expand(-1, H), lg, "amax")
        m[p] = torch.where(torch.isfinite(m[p]), m[p], 0.0)
        for e0 in range(0, rows.numel(), chunk):
            r, c, lg, pos = logits(e0, e0 + chunk, False)
            w = torch.exp(lg - m[p].index_select(0, r))
            zc = z[p].index_select(0, c).float()
            s[p].index_add_(0, r, w)
            out[p].index_add_(0, r, zc * w[..., None])
            if neg:
                wn = torch.where(pos, 0.0, w)
                w_neg[p].index_add_(0, r, wn)
                n_neg[p].index_add_(0, r, zc * wn[..., None])
        s[p] = torch.where(indptr[p].diff()[:, None] == 0, 1.0, s[p])
    out /= s[..., None]
    if not neg:
        return out, m, s
    n_neg /= s[..., None]
    return out, m, s, n_neg, w_neg / s


def _kernel_shape(name, H, dh, *n_rows):
    """Raise where the kernels cannot take the shape."""
    F = H * dh
    if H > MAX_HEADS:
        raise ValueError(f"{name}: the kernel takes at most {MAX_HEADS} "
                         f"heads, got {H}")
    limit = MAX_F_VEC4 if F % 4 == 0 and dh >= 4 else MAX_F_SCALAR
    if F > limit:
        raise ValueError(f"{name}: rows of {F} floats (dh={dh}) exceed the "
                         f"kernel's {limit}")
    if max(n_rows) >= 2 ** 31:
        raise ValueError(f"{name}: too many rows for the kernel")


def _cuda_ready(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return torch.cuda.current_stream(dev).cuda_stream


def gat_fwd(z: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
            indptr: torch.Tensor, src: torch.Tensor, slope: float = 0.2,
            neg: bool = False):
    """K6 on CUDA tensors (counted in ``gat_fwd.launches``, and by the
    library of z's row type in ``gat_fwd.by_mode``), the plain version on
    CPU tensors: ``(out, m, s)``, with
    ``neg`` also ``(n_neg, w_neg)`` (the kernel's NEG mode)."""
    if z.device.type == "cpu":
        return gat_fwd_plain(z, el, er, indptr, src, slope, neg=neg)
    n = er.shape[1]
    _check("gat_fwd", z, el, er, indptr, src, n)
    stream = _cuda_ready("gat_fwd", z, el, er, indptr, src)
    P, R, H, dh = z.shape
    _kernel_shape("gat_fwd", H, dh, R, n)
    out = torch.empty((P, n, H, dh), dtype=torch.float32, device=z.device)
    m = torch.empty((P, n, H), dtype=torch.float32, device=z.device)
    s = torch.empty_like(m)
    extra = (torch.empty_like(out), torch.empty_like(m)) if neg else ()
    mode, name = _MODES[(z.dtype, _G_OF[z.dtype])]
    lib = _build.load(name, _signatures(mode))
    rc = getattr(lib, f"pgt_gat_fwd_m{mode}")(
        z.data_ptr(), el.data_ptr(), er.data_ptr(), indptr.data_ptr(),
        int(indptr.dtype == torch.int64), src.data_ptr(), src.shape[1],
        out.data_ptr(), m.data_ptr(), s.data_ptr(),
        *([t.data_ptr() for t in extra] if neg else [None, None]),
        P, R, n, H, dh, float(slope), stream)
    _build.check(rc, "gat_fwd")
    gat_fwd.launches += 1
    gat_fwd.by_mode[name] += 1
    return (out, m, s) + extra


def gat_d_er(g: torch.Tensor, rho: torch.Tensor, n_neg: torch.Tensor,
             w_neg: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """Pass A of the backward, ``d_er [P, n, H]``, from the forward's
    ``neg`` outputs: ``(1 - slope) * (rho * w_neg - g . n_neg)`` (equal to
    ``sum_e alpha * (g . z[src] - rho) * leaky'(l)`` since the row's
    alphas sum to 1; see the module docstring)."""
    return (1.0 - slope) * (rho * w_neg - (g * n_neg).sum(-1))


# ---------------------------------------------------------------------------
# K8: pass B of the backward (src-keyed, over the transpose CSR): d_z, d_el


def gat_bwd_src_plain(z, el, er, m, s, g, rho, indptr_t, dst_t,
                      slope: float = 0.2,
                      branch: Optional[LeakyBranch] = None,
                      chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of K8: ``(d_z [P, R, H, dh], d_el [P, R, H])``
    f32 with ``d_z[r] = sum_e alpha * g[dst]`` and ``d_el[r] = sum_e alpha
    * (g[dst] . z[r] - rho[dst]) * leaky'(l)`` over each source's
    out-edges of the transpose CSR, in chunks of edges (``gat_bwd`` pass
    B), z and g widened to f32 as gathered. Any device."""
    P, R, H, dh = z.shape
    n = er.shape[1]
    _check("gat_bwd_src", z, el, er, indptr_t, dst_t, R)
    d_z = torch.zeros((P, R, H, dh), dtype=torch.float32, device=z.device)
    d_el = torch.zeros((P, R, H), dtype=torch.float32, device=z.device)
    for p in range(P):
        rows, cols = _edges(indptr_t[p], dst_t[p], n)
        for e0 in range(0, rows.numel(), chunk):
            r, c = rows[e0:e0 + chunk], cols[e0:e0 + chunk]
            lp = el[p].index_select(0, r) + er[p].index_select(0, c)
            pos = _pos(lp, branch, p, r, c, False)
            alpha = torch.exp(_leaky(lp, pos, slope)
                              - m[p].index_select(0, c)) \
                / s[p].index_select(0, c)
            gd = g[p].index_select(0, c).float()
            d_z[p].index_add_(0, r, gd * alpha[..., None])
            cc = (gd * z[p].index_select(0, r).float()).sum(-1)
            d_el[p].index_add_(0, r, alpha * (cc - rho[p].index_select(0, c))
                               * _dleaky(pos, slope))
    return d_z, d_el


def gat_bwd_src(z, el, er, m, s, g, rho, indptr_t, dst_t,
                slope: float = 0.2):
    """K8 on CUDA tensors (counted in ``gat_bwd_src.launches``, and in
    ``gat_bwd_src.by_mode`` by the library of the (z, g) row types:
    f32/f32, bf16/bf16 or e4m3/e5m2), the plain
    version on CPU tensors. The kernel reads the four per-destination
    stats as one stacked ``[P, n, 4, H]`` f32 array (one narrow row per
    edge)."""
    if z.device.type == "cpu":
        return gat_bwd_src_plain(z, el, er, m, s, g, rho, indptr_t, dst_t,
                                 slope)
    P, R, H, dh = z.shape
    n = er.shape[1]
    _check("gat_bwd_src", z, el, er, indptr_t, dst_t, R)
    if m.shape != er.shape or s.shape != er.shape or rho.shape != er.shape \
            or g.shape != (P, n, H, dh):
        raise ValueError("gat_bwd_src: m, s, rho must be [P, n, H] and g "
                         "[P, n, H, dh]")
    if (z.dtype, g.dtype) not in _MODES:
        raise TypeError(f"gat_bwd_src: no kernel for z {z.dtype} with g "
                        f"{g.dtype} (f32/f32, bf16/bf16, e4m3/e5m2)")
    stats = torch.stack([er, m, s, rho], dim=2)
    stream = _cuda_ready("gat_bwd_src", z, el, stats, g, indptr_t, dst_t)
    _kernel_shape("gat_bwd_src", H, dh, R, n)
    d_z = torch.empty((P, R, H, dh), dtype=torch.float32, device=z.device)
    d_el = torch.empty((P, R, H), dtype=torch.float32, device=z.device)
    mode, name = _MODES[(z.dtype, g.dtype)]
    lib = _build.load(name, _signatures(mode))
    rc = getattr(lib, f"pgt_gat_bwd_src_m{mode}")(
        z.data_ptr(), el.data_ptr(), stats.data_ptr(), g.data_ptr(),
        indptr_t.data_ptr(), int(indptr_t.dtype == torch.int64),
        dst_t.data_ptr(), dst_t.shape[1], d_z.data_ptr(), d_el.data_ptr(),
        P, R, n, H, dh, float(slope), stream)
    _build.check(rc, "gat_bwd_src")
    gat_bwd_src.launches += 1
    gat_bwd_src.by_mode[name] += 1
    return d_z, d_el


gat_fwd.launches = 0
gat_bwd_src.launches = 0
# launches by row-type mode (library name), beside the total
gat_fwd.by_mode = dict.fromkeys(LIBRARIES, 0)
gat_bwd_src.by_mode = dict.fromkeys(LIBRARIES, 0)


# ---------------------------------------------------------------------------
# the autograd function


class GatAttention(torch.autograd.Function):
    """``out = attention(z, el, er)`` ``[P, n, H, dh]`` f32 with K6 forward
    (in its ``neg`` mode when er's gradient will be needed) and K8 plus
    :func:`gat_d_er` backward (``make_device_gat_fn``). ``rem_dtype``
    casts z (K10: e4m3 or bf16) before the forward and the cotangent
    (e5m2 or bf16) before K8; ``share`` is the ``TransportShare`` those
    casts record into or replay from. ``plain`` picks the plain versions
    on any device (with ``branch``, on another run's leaky branches);
    otherwise CUDA tensors run the kernels and CPU tensors the plain
    versions."""

    @staticmethod
    def forward(ctx, z, el, er, indptr, src, indptr_t, dst_t, slope, plain,
                branch, neg, rem_dtype, share):
        fwd_dt, bwd_dt = transport_dtypes(rem_dtype)
        P, R, H, dh = z.shape
        zq = z
        if fwd_dt is not None:  # the one quantized z every pass reads
            zq = _transport(z.reshape(P, R, H * dh).contiguous(), fwd_dt,
                            False, None, plain, share)[0].view(P, R, H, dh)
        if plain:
            res = gat_fwd_plain(zq, el, er, indptr, src, slope, branch,
                                neg=neg)
        else:
            res = gat_fwd(zq, el, er, indptr, src, slope, neg=neg)
        out, m, s = res[:3]
        n_neg, w_neg = res[3:] if neg else (None, None)
        ctx.slope, ctx.plain, ctx.branch = slope, plain, branch
        ctx.bwd_dt, ctx.share, ctx.z_dtype = bwd_dt, share, z.dtype
        ctx.save_for_backward(zq, el, er, out, m, s, n_neg, w_neg, indptr_t,
                              dst_t)
        return out

    @staticmethod
    def backward(ctx, g):
        zq, el, er, out, m, s, n_neg, w_neg, indptr_t, dst_t = \
            ctx.saved_tensors
        if indptr_t is None:
            raise ValueError("gat attention: the backward needs the "
                             "transpose CSR (transpose=(indptr_t, dst_t), "
                             "ops.spmm.csr_transpose)")
        g = g.float().contiguous()
        rho = (g * out).sum(-1)
        slope = ctx.slope
        d_er = None if n_neg is None else gat_d_er(g, rho, n_neg, w_neg,
                                                   slope)
        # pass B gathers the cotangent narrowed: cast to e5m2 / bf16, or to
        # z's dtype without a transport
        if ctx.bwd_dt is not None:
            P, n, H, dh = g.shape
            g_t = _transport(g.view(P, n, H * dh), ctx.bwd_dt, False, None,
                             ctx.plain, ctx.share)[0].view(P, n, H, dh)
        else:
            g_t = g.to(ctx.z_dtype)
        if ctx.plain:
            d_z, d_el = gat_bwd_src_plain(zq, el, er, m, s, g_t, rho,
                                          indptr_t, dst_t, slope, ctx.branch)
        else:
            d_z, d_el = gat_bwd_src(zq, el, er, m, s, g_t, rho, indptr_t,
                                    dst_t, slope)
        return (d_z.to(ctx.z_dtype), d_el, d_er) + (None,) * 10


def _apply(z, el, er, indptr, src, transpose, slope, plain, branch,
           rem_dtype, share):
    it, dt = transpose if transpose is not None else (None, None)
    # n_neg / w_neg only where a backward will ask for d_er
    neg = torch.is_grad_enabled() and er.requires_grad
    return GatAttention.apply(z, el, er, indptr, src, it, dt, slope, plain,
                              branch, neg, rem_dtype, share)


def gat_attention(z: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                  indptr: torch.Tensor, src: torch.Tensor,
                  transpose: Optional[Transpose] = None,
                  slope: float = 0.2, rem_dtype: Optional[str] = None,
                  share=None) -> torch.Tensor:
    """The attention aggregation ``[P, n, H, dh]`` f32: K6 on CUDA tensors,
    the plain version on CPU tensors. Differentiable with respect to z, el
    and er: the backward runs K8 (CPU: its plain version) and
    :func:`gat_d_er` and needs ``transpose = (indptr_t, dst_t)``.
    ``rem_dtype`` (None | 'bfloat16' | 'float8') narrows the gather
    transport as ``make_device_gat_fn`` does, ``share`` a
    ``TransportShare`` of its casts."""
    return _apply(z, el, er, indptr, src, transpose, slope, False, None,
                  rem_dtype, share)


def gat_attention_plain(z: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                        indptr: torch.Tensor, src: torch.Tensor,
                        transpose: Optional[Transpose] = None,
                        slope: float = 0.2,
                        branch: Optional[LeakyBranch] = None,
                        rem_dtype: Optional[str] = None,
                        share=None) -> torch.Tensor:
    """:func:`gat_attention` through the plain versions on any device
    (with ``branch``, on another run's leaky branches)."""
    return _apply(z, el, er, indptr, src, transpose, slope, True, branch,
                  rem_dtype, share)
