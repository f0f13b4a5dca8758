"""Mean SpMM, forward and transpose — port of ``pipegcn_tpu/ops/spmm.py``
(``spmm_mean``, ``spmm_sum``, ``_segment_sum_once`` and the custom VJP
``_spmm_mean_lowp_fwd`` / ``_spmm_mean_lowp_bwd``).

The JAX package aggregates with gather + ``segment_sum`` over the padded,
dst-sorted edge list of ``ShardedGraph``. The port keeps that padding
contract (``pipegcn_tpu/ops/spmm.py:11-16``: pad edges carry dst = n_out
and src = row 0) but hands the kernels CSRs instead:

  - forward: the destination CSR ``indptr`` built on the host from the
    sorted ``edge_dst`` (:func:`csr_indptr`); pad edges, which sort to the
    tail, lie past ``indptr[n_out]`` and are never read;
  - backward: the source-keyed CSR ``(indptr_t, dst_t)`` over the real
    edges (:func:`csr_transpose`), so the transpose is a row-parallel
    gather as well — no atomics, a deterministic result.

:class:`SpmmMean` ties the two together as an autograd function; its
backward takes the f32 cotangent, accumulates in f32 and casts ``d_fbuf``
to ``fbuf``'s dtype once (the ``_spmm_mean_lowp_bwd`` contract), and
returns ``d_in_deg = -sum_f(out * g) / in_deg`` when ``in_deg`` needs it.

:func:`spmm_mean` launches kernel K1 forward and K3 backward
(``csrc/spmm_mean.cu``) for CUDA tensors and runs the plain versions for
CPU tensors; anything else raises. K1 gathers in column slices where the
table of one part outgrows the card's L2 (:func:`k1_slice_width`: the
slice rule, a function of the table's bytes against the L2 the card
reports; :func:`k1_plan` adds the load width); K3 prescales ``g`` by
``1 / in_deg`` once and gathers it in 64-column slices
(:data:`K3_SLICE`) for a CTA of consecutive sources.
:func:`spmm_mean_plain` is the same function through the plain versions
on any device (the card-side comparison). All take one part
(``fbuf [n_src, F]``) or P stacked parts (``fbuf [P, n_src, F]`` with
``indptr [P, n_out+1]``, ``src [P, E]``, ``in_deg [P, n_out]``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

# edges per step of the plain versions: bounds their [chunk, F] gathered
# message tensor (the same role as the JAX package's spmm_chunk)
PLAIN_CHUNK = 1 << 21

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pgt_spmm_mean": [_P, _I, _P, _I, _P, _LL, _P, _P, _I, _I, _I, _I, _I,
                      _I, _P],
    "pgt_spmm_mean_t": [_P, _P, _I, _P, _LL, _P, _P, _P, _I, _I, _I, _I,
                        _P],
}

Transpose = Tuple[torch.Tensor, torch.Tensor]

# K1's slice rule (measured on an H100, PERF.md): a part's table, and
# where it is larger each (part, slice) table, n_src rows of a slice's
# bytes, may take this share of the L2 the card reports. 0.6 admits the
# serving table's 128-byte slices (29.8 MB of the H100's 52.4 MB), which
# ran faster than 64-byte ones (14.9 MB). Sliced, the serving table
# (4.6x the L2, random parts) ran 2.0x faster than whole rows and the
# f32 training one (2.8x, the cluster layout) 5 % faster; the bf16
# training one (1.4x) ran within the spread of two timings of one kernel.
K1_L2_SHARE = 0.6
# the slice widths K1 takes, in bytes of a row, widest first: a group of
# lanes reads a slice's bytes of one row an edge (128 B: one cache line)
K1_SLICE_BYTES = (128, 64, 32)
# the widest load a lane makes: 16-byte loads (4 f32, 8 bf16 elements,
# 8 lanes a 128-byte slice) ran fastest
K1_LOAD_BYTES = 16
# K3's column slice (f32 columns; csrc/spmm_mean.cu kK3Width): the width
# of the prescaled cotangent's slices, which K3's CTAs gather
K3_SLICE = 64


def _index_dtype(counts: np.ndarray):
    return np.int32 if counts.max(initial=0) < 2 ** 31 else np.int64


def csr_indptr(edge_dst: np.ndarray, n_out: int) -> np.ndarray:
    """Destination CSR row pointer ``[..., n_out + 1]`` of a dst-sorted,
    sentinel-padded edge list ``[..., E]`` (one part or P stacked parts).

    ``indptr[i]`` is the first edge of row i and ``indptr[n_out]`` the
    number of real edges: pad edges (dst == n_out) are the tail. int32
    unless an edge count passes 2**31 - 1, then int64. Raises when the
    list is unsorted or holds a dst outside [0, n_out]."""
    dst = np.asarray(edge_dst)
    flat = dst.reshape(-1, dst.shape[-1])
    out = np.zeros((flat.shape[0], n_out + 1), np.int64)
    for p, d in enumerate(flat):
        if d.size and (d.min() < 0 or d.max() > n_out):
            raise ValueError(f"edge_dst of part {p} outside [0, {n_out}]")
        if d.size > 1 and np.any(d[1:] < d[:-1]):
            raise ValueError(f"edge_dst of part {p} is not sorted "
                             "ascending (CSR order)")
        np.cumsum(np.bincount(d, minlength=n_out + 1)[:n_out],
                  out=out[p, 1:])
    return out.astype(_index_dtype(out[:, -1])).reshape(
        dst.shape[:-1] + (n_out + 1,))


def csr_transpose(edge_src: np.ndarray, edge_dst: np.ndarray, n_out: int,
                  n_src: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source-keyed CSR of a dst-sorted, sentinel-padded edge list
    ``[..., E]``: ``indptr_t [..., n_src + 1]`` and ``dst_t [..., E]``
    (int32), where row s lists the dst of every real edge whose source
    is s. Pad edges (dst == n_out) are dropped; the tail of ``dst_t`` past
    ``indptr_t[n_src]`` is zero. Within a row the edges keep their
    dst-sorted order (a stable sort by source), so the result is
    deterministic. Sources are clipped to [0, n_src - 1], as the forward
    gather clips them. No ``np.unique`` (which hashes on NumPy >= 2.3);
    the sort is the native radix sort where the library is built."""
    from ..native import stable_argsort

    src = np.asarray(edge_src)
    dst = np.asarray(edge_dst)
    indptr = csr_indptr(dst, n_out).reshape(-1, n_out + 1)
    fs, fd = src.reshape(-1, src.shape[-1]), dst.reshape(-1, dst.shape[-1])
    ptr = np.zeros((fs.shape[0], n_src + 1), np.int64)
    dst_t = np.zeros(fs.shape, np.int32)
    for p in range(fs.shape[0]):
        n_e = int(indptr[p, -1])
        s = np.clip(fs[p, :n_e], 0, n_src - 1)
        order = stable_argsort(s)
        dst_t[p, :n_e] = fd[p, :n_e][order]
        np.cumsum(np.bincount(s, minlength=n_src), out=ptr[p, 1:])
    return (ptr.astype(_index_dtype(ptr[:, -1])).reshape(
                src.shape[:-1] + (n_src + 1,)),
            dst_t.reshape(src.shape))


def k1_slice_width(n_src: int, F: int, elem_bytes: int,
                   l2_bytes: int) -> Tuple[int, int]:
    """K1's column slices for one part's table of ``n_src`` rows of F
    elements of ``elem_bytes``: ``(W, S)``, W columns a slice and S =
    ceil(F / W) slices (the last may be narrower). S = 1 (W = F) where
    the whole table fits ``K1_L2_SHARE`` of ``l2_bytes``; otherwise the
    widest of ``K1_SLICE_BYTES`` whose slice table fits it (the narrowest
    where none does). Pure: the CPU tests hold it."""
    budget = K1_L2_SHARE * l2_bytes
    if n_src * F * elem_bytes <= budget:
        return F, 1
    fits = [b for b in K1_SLICE_BYTES if n_src * b <= budget]
    W = max(1, (fits[0] if fits else K1_SLICE_BYTES[-1]) // elem_bytes)
    if W >= F:
        return F, 1
    return W, -(-F // W)


def k1_plan(n_src: int, F: int, elem_bytes: int, l2_bytes: int,
            ptr: int) -> Tuple[int, int]:
    """``(width, vec)`` for ``pgt_spmm_mean``: the slice width of
    :func:`k1_slice_width` and the elements a lane loads at once: the
    widest load up to ``K1_LOAD_BYTES`` that F and the table's address
    ``ptr`` allow, with width / vec lanes a row (8, 16 or 32; past 32 the
    slice narrows). width = F: the whole-row kernel."""
    W, S = k1_slice_width(n_src, F, elem_bytes, l2_bytes)
    if S == 1:
        return F, 0
    vec = K1_LOAD_BYTES // elem_bytes
    while vec > 1 and (F % vec or W % vec or ptr % (vec * elem_bytes)):
        vec //= 2
    W = min(W, 32 * vec)
    while W // vec < 8:  # groups of 8, 16 or 32 lanes
        vec //= 2
    return W, vec


_L2_BYTES = {}


def _l2_bytes(device: torch.device) -> int:
    """The L2 size the card reports (cudaDevAttrL2CacheSize)."""
    i = device.index if device.index is not None \
        else torch.cuda.current_device()
    if i not in _L2_BYTES:
        _L2_BYTES[i] = torch.cuda.get_device_properties(i).L2_cache_size
    return _L2_BYTES[i]


def _stacked(x, indptr, idx, deg):
    """View single-part arguments as P = 1 stacks."""
    if x.dim() == 2:
        return x[None], indptr[None], idx[None], deg[None], True
    return x, indptr, idx, deg, False


def _check(fbuf, indptr, src, in_deg):
    if fbuf.dim() not in (2, 3):
        raise ValueError(f"fbuf must be [n_src, F] or [P, n_src, F], got "
                         f"{tuple(fbuf.shape)}")
    f, ip, s, dg, _ = _stacked(fbuf, indptr, src, in_deg)
    P, n_out = f.shape[0], ip.shape[-1] - 1
    if ip.dim() != 2 or ip.shape[0] != P or s.dim() != 2 \
            or s.shape[0] != P or dg.shape != (P, n_out):
        raise ValueError(
            f"shape mismatch: fbuf {tuple(fbuf.shape)}, indptr "
            f"{tuple(indptr.shape)}, src {tuple(src.shape)}, in_deg "
            f"{tuple(in_deg.shape)}")
    if fbuf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fbuf must be float32 or bfloat16, got {fbuf.dtype}")
    if indptr.dtype not in (torch.int32, torch.int64) \
            or src.dtype != torch.int32 or in_deg.dtype != torch.float32:
        raise TypeError("indptr must be int32/int64, src int32, in_deg "
                        "float32")
    devs = {t.device for t in (fbuf, indptr, src, in_deg)}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: {devs}")


def _check_t(g, indptr_t, dst_t, in_deg):
    if g.dim() not in (2, 3) or g.dtype != torch.float32:
        raise ValueError(f"g must be f32 [n_out, F] or [P, n_out, F], got "
                         f"{g.dtype} {tuple(g.shape)}")
    x, ip, d, dg, _ = _stacked(g, indptr_t, dst_t, in_deg)
    P, n_out = x.shape[0], x.shape[1]
    if ip.dim() != 2 or ip.shape[0] != P or d.dim() != 2 \
            or d.shape[0] != P or dg.shape != (P, n_out):
        raise ValueError(
            f"shape mismatch: g {tuple(g.shape)}, indptr_t "
            f"{tuple(indptr_t.shape)}, dst_t {tuple(dst_t.shape)}, in_deg "
            f"{tuple(in_deg.shape)}")
    if indptr_t.dtype not in (torch.int32, torch.int64) \
            or dst_t.dtype != torch.int32 or in_deg.dtype != torch.float32:
        raise TypeError("indptr_t must be int32/int64, dst_t int32, in_deg "
                        "float32")
    devs = {t.device for t in (g, indptr_t, dst_t, in_deg)}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: {devs}")


def _gather_sum_plain(x, indptr, idx, n_rows, scale=None,
                      chunk=PLAIN_CHUNK):
    """``out[p, i] = sum_{e in row i} x[p, idx[p, e]] (* scale[p, idx])``
    in f32 by chunked ``index_select`` + ``index_add_``; stacked only."""
    P = x.shape[0]
    out = torch.zeros((P, n_rows, x.shape[-1]), dtype=torch.float32,
                      device=x.device)
    rows = torch.arange(n_rows, device=x.device)
    for p in range(P):
        n_e = int(indptr[p, -1])
        dst = torch.repeat_interleave(rows, indptr[p].diff().long())
        idx_p = idx[p, :n_e].long().clamp_(0, x.shape[1] - 1)
        for e0 in range(0, n_e, chunk):
            e1 = min(e0 + chunk, n_e)
            msg = x[p].index_select(0, idx_p[e0:e1]).float()
            if scale is not None:
                msg = msg * scale[p].index_select(0, idx_p[e0:e1])[:, None]
            out[p].index_add_(0, dst[e0:e1], msg)
    return out


def _spmm_mean_fwd_plain(fbuf, indptr, src, in_deg):
    """Plain PyTorch version of K1: gather ``fbuf[src]`` in chunks of
    edges, cast to f32, ``index_add_`` into the destination rows, divide
    by ``in_deg``. Runs on any device."""
    _check(fbuf, indptr, src, in_deg)
    f, ip, s, dg, single = _stacked(fbuf, indptr, src, in_deg)
    out = _gather_sum_plain(f, ip, s, ip.shape[-1] - 1)
    out /= dg[..., None]
    return out[0] if single else out


def k1_launch(fbuf, indptr, src, in_deg, plan=None):
    """Launch K1 on CUDA tensors with ``plan = (width, vec)`` (default
    :func:`k1_plan` from the card's L2; ``(F, 0)`` is the whole-row
    kernel, one slice), uncounted: :func:`spmm_mean` counts its own
    calls."""
    _check(fbuf, indptr, src, in_deg)
    if fbuf.device.type != "cuda":
        raise ValueError(f"spmm_mean: unsupported device {fbuf.device}")
    f, ip, s, dg, single = _stacked(fbuf, indptr, src, in_deg)
    if not all(t.is_contiguous() for t in (f, ip, s, dg)):
        raise ValueError("spmm_mean: the kernel takes contiguous tensors")
    P, n_src, F = f.shape
    n_out = ip.shape[-1] - 1
    if P * n_src * F >= 2 ** 62 or n_src >= 2 ** 31 or F >= 2 ** 31:
        raise ValueError("spmm_mean: fbuf too large for the kernel")
    if plan is None:
        plan = k1_plan(n_src, F, f.element_size(), _l2_bytes(f.device),
                       f.data_ptr())
    out = torch.empty((P, n_out, F), dtype=torch.float32, device=f.device)
    lib = _build.load("spmm_mean", _SIGNATURES)
    rc = lib.pgt_spmm_mean(
        f.data_ptr(), int(f.dtype == torch.bfloat16), ip.data_ptr(),
        int(ip.dtype == torch.int64), s.data_ptr(), s.shape[1],
        dg.data_ptr(), out.data_ptr(), P, n_src, n_out, F, *plan,
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(rc, "spmm_mean")
    return out[0] if single else out


def _spmm_mean_fwd(fbuf, indptr, src, in_deg):
    """K1 on CUDA tensors (counted in ``spmm_mean.launches``), the plain
    version on CPU tensors."""
    if fbuf.device.type == "cpu":
        return _spmm_mean_fwd_plain(fbuf, indptr, src, in_deg)
    out = k1_launch(fbuf, indptr, src, in_deg)
    spmm_mean.launches += 1
    return out


def spmm_mean_t_plain(g: torch.Tensor, indptr_t: torch.Tensor,
                      dst_t: torch.Tensor, in_deg: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of K3: ``d_fbuf[s] = sum_{e: src=s}
    g[dst_e] * (1 / in_deg[dst_e])`` in f32, by chunked ``index_select``
    + ``index_add_`` over the source-keyed CSR. Runs on any device."""
    _check_t(g, indptr_t, dst_t, in_deg)
    x, ip, d, dg, single = _stacked(g, indptr_t, dst_t, in_deg)
    out = _gather_sum_plain(x, ip, d, ip.shape[-1] - 1,
                            scale=torch.reciprocal(dg))
    return out[0] if single else out


def spmm_mean_t(g: torch.Tensor, indptr_t: torch.Tensor,
                dst_t: torch.Tensor, in_deg: torch.Tensor) -> torch.Tensor:
    """Transpose mean aggregation ``[P, n_out, F] f32 -> [P, n_src, F]
    f32``: kernel K3 on CUDA tensors (counted in
    ``spmm_mean_t.launches``: the prescale of ``g`` by ``1 / in_deg`` into
    column slices, then the sliced gather), :func:`spmm_mean_t_plain` on
    CPU."""
    if g.device.type == "cpu":
        return spmm_mean_t_plain(g, indptr_t, dst_t, in_deg)
    _check_t(g, indptr_t, dst_t, in_deg)
    if g.device.type != "cuda":
        raise ValueError(f"spmm_mean_t: unsupported device {g.device}")
    x, ip, d, dg, single = _stacked(g, indptr_t, dst_t, in_deg)
    if not all(t.is_contiguous() for t in (x, ip, d, dg)):
        raise ValueError("spmm_mean_t: the kernel takes contiguous tensors")
    P, n_out, F = x.shape
    n_src = ip.shape[-1] - 1
    if P * max(n_out, n_src) * F >= 2 ** 62 or n_out >= 2 ** 31:
        raise ValueError("spmm_mean_t: g too large for the kernel")
    gp = torch.empty((P, -(-F // K3_SLICE), n_out, K3_SLICE),
                     dtype=torch.float32, device=x.device)
    out = torch.empty((P, n_src, F), dtype=torch.float32, device=x.device)
    lib = _build.load("spmm_mean", _SIGNATURES)
    rc = lib.pgt_spmm_mean_t(
        x.data_ptr(), ip.data_ptr(), int(ip.dtype == torch.int64),
        d.data_ptr(), d.shape[1], dg.data_ptr(), gp.data_ptr(),
        out.data_ptr(), P, n_out, n_src, F,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "spmm_mean_t")
    spmm_mean_t.launches += 1
    return out[0] if single else out


class SpmmMean(torch.autograd.Function):
    """``out = spmm(fbuf) / in_deg`` (f32) with the transpose as its
    backward. ``plain`` picks the plain versions on any device; otherwise
    CUDA tensors run K1/K3 and CPU tensors the plain versions."""

    @staticmethod
    def forward(ctx, fbuf, indptr, src, in_deg, indptr_t, dst_t, plain):
        fwd = _spmm_mean_fwd_plain if plain else _spmm_mean_fwd
        out = fwd(fbuf, indptr, src, in_deg)
        ctx.plain, ctx.fbuf_dtype = plain, fbuf.dtype
        ctx.has_t = indptr_t is not None
        ctx.save_for_backward(indptr_t, dst_t, in_deg,
                              out if in_deg.requires_grad else None)
        return out

    @staticmethod
    def backward(ctx, g):
        indptr_t, dst_t, in_deg, out = ctx.saved_tensors
        gf = g.float()
        d_fbuf = d_in_deg = None
        if ctx.needs_input_grad[0]:
            if not ctx.has_t:
                raise ValueError("spmm_mean: the backward needs the "
                                 "transpose CSR (transpose=(indptr_t, "
                                 "dst_t), ops.spmm.csr_transpose)")
            bwd = spmm_mean_t_plain if ctx.plain else spmm_mean_t
            d_fbuf = bwd(gf.contiguous(), indptr_t, dst_t, in_deg).to(
                ctx.fbuf_dtype)
        if ctx.needs_input_grad[3]:
            d_in_deg = -(out * gf).sum(-1) / in_deg
        return d_fbuf, None, None, d_in_deg, None, None, None


def _apply(fbuf, indptr, src, in_deg, transpose, plain):
    it, dt = transpose if transpose is not None else (None, None)
    return SpmmMean.apply(fbuf, indptr, src, in_deg, it, dt, plain)


def spmm_mean(fbuf: torch.Tensor, indptr: torch.Tensor, src: torch.Tensor,
              in_deg: torch.Tensor, transpose: Optional[Transpose] = None
              ) -> torch.Tensor:
    """Mean aggregation, f32 out: kernel K1 on CUDA tensors (counted in
    ``spmm_mean.launches``), the plain version on CPU tensors.
    Differentiable: the backward runs K3 (CPU: its plain version) over
    ``transpose = (indptr_t, dst_t)`` from :func:`csr_transpose`, which a
    gradient with respect to ``fbuf`` needs."""
    return _apply(fbuf, indptr, src, in_deg, transpose, False)


def spmm_mean_plain(fbuf: torch.Tensor, indptr: torch.Tensor,
                    src: torch.Tensor, in_deg: torch.Tensor,
                    transpose: Optional[Transpose] = None) -> torch.Tensor:
    """:func:`spmm_mean` through the plain versions on any device."""
    return _apply(fbuf, indptr, src, in_deg, transpose, True)


spmm_mean.launches = 0
spmm_mean_t.launches = 0
