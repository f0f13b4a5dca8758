"""Mean SpMM forward — port of ``pipegcn_tpu/ops/spmm.py`` (``spmm_mean``,
``spmm_sum``, ``_segment_sum_once``; forward only, the transpose and the
bf16 custom VJP come with training).

The JAX package aggregates with gather + ``segment_sum`` over the padded,
dst-sorted edge list of ``ShardedGraph``. The port keeps that padding
contract (``pipegcn_tpu/ops/spmm.py:11-16``: pad edges carry dst = n_out
and src = row 0) but hands the kernel a destination CSR instead: the host
builds ``indptr`` from the sorted ``edge_dst`` (:func:`csr_indptr`), and pad
edges, which sort to the tail, lie past ``indptr[n_out]`` and are never
read.

:func:`spmm_mean` launches kernel K1 (``csrc/spmm_mean.cu``) for CUDA
tensors and runs :func:`spmm_mean_plain` for CPU tensors; anything else
raises. Both take one part (``fbuf [n_src, F]``) or P stacked parts
(``fbuf [P, n_src, F]`` with ``indptr [P, n_out+1]``, ``src [P, E]``,
``in_deg [P, n_out]``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# edges per step of the plain version: bounds its [chunk, F] gathered
# message tensor (the same role as the JAX package's spmm_chunk)
PLAIN_CHUNK = 1 << 21

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pgt_spmm_mean": [_P, _I, _P, _I, _P, _LL, _P, _P, _I, _I, _I, _I, _P],
}


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
    dtype = np.int32 if out[:, -1].max(initial=0) < 2 ** 31 else np.int64
    return out.astype(dtype).reshape(dst.shape[:-1] + (n_out + 1,))


def _stacked(fbuf, indptr, src, in_deg):
    """View single-part arguments as P = 1 stacks."""
    if fbuf.dim() == 2:
        return fbuf[None], indptr[None], src[None], in_deg[None], True
    return fbuf, indptr, src, in_deg, False


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


def spmm_mean_plain(fbuf: torch.Tensor, indptr: torch.Tensor,
                    src: torch.Tensor, in_deg: torch.Tensor,
                    chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of K1: gather ``fbuf[src]`` in chunks of
    edges, cast to f32, ``index_add_`` into the destination rows, divide
    by ``in_deg``. Runs on any device."""
    _check(fbuf, indptr, src, in_deg)
    f, ip, s, dg, single = _stacked(fbuf, indptr, src, in_deg)
    P, n_out = f.shape[0], ip.shape[-1] - 1
    out = torch.zeros((P, n_out, f.shape[-1]), dtype=torch.float32,
                      device=f.device)
    rows = torch.arange(n_out, device=f.device)
    for p in range(P):
        n_e = int(ip[p, -1])
        dst = torch.repeat_interleave(rows, ip[p].diff().long())
        src_p = s[p, :n_e].long().clamp_(0, f.shape[1] - 1)
        for e0 in range(0, n_e, chunk):
            e1 = min(e0 + chunk, n_e)
            out[p].index_add_(0, dst[e0:e1],
                              f[p].index_select(0, src_p[e0:e1]).float())
    out /= dg[..., None]
    return out[0] if single else out


def spmm_mean(fbuf: torch.Tensor, indptr: torch.Tensor, src: torch.Tensor,
              in_deg: torch.Tensor) -> torch.Tensor:
    """Mean aggregation, f32 out: kernel K1 on CUDA tensors (counted in
    ``spmm_mean.launches``), :func:`spmm_mean_plain` on CPU tensors."""
    if fbuf.device.type == "cpu":
        return spmm_mean_plain(fbuf, indptr, src, in_deg)
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
    out = torch.empty((P, n_out, F), dtype=torch.float32, device=f.device)
    lib = _build.load("spmm_mean", _SIGNATURES)
    rc = lib.pgt_spmm_mean(
        f.data_ptr(), int(f.dtype == torch.bfloat16), ip.data_ptr(),
        int(ip.dtype == torch.int64), s.data_ptr(), s.shape[1],
        dg.data_ptr(), out.data_ptr(), P, n_src, n_out, F,
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(rc, "spmm_mean")
    spmm_mean.launches += 1
    return out[0] if single else out


spmm_mean.launches = 0
