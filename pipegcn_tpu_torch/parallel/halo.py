"""Halo exchange and its gradients on the stacked one-card layout — port of
``pipegcn_tpu/parallel/halo.py`` (``exchange_blocks``, ``halo_exchange``,
``return_blocks``, ``make_stale_concat``).

The JAX package runs one shard per device inside ``shard_map`` and ships
each ring distance with ``lax.ppermute``. On one card the P parts live
stacked as ``h [P, n_max, F]``, so the ring becomes a row copy between
parts with the same numbering (``pipegcn_tpu/parallel/halo.py:13-16``):
receiver r's distance-d block holds ``h[s][send_idx[s][d-1]]``, zeroed
where ``send_mask[s][d-1]`` is off, with ``s = (r-d) mod P``; blocks follow
the inner rows in distance order. ``send_idx`` is read in clip mode, as
``jnp.take(mode="clip")``.

Three kernels, each with its plain version beside it; the wrappers launch
the kernel for CUDA tensors and run the plain version for CPU tensors:

  - :func:`halo_gather` — K2 (``ops/csrc/halo_gather.cu``), the exchange;
  - :func:`return_blocks` — K5 (the same file), the reverse ring that
    routes halo cotangents back to their owners;
  - :func:`scatter_bgrad` — K4 (``ops/csrc/halo_scatter.cu``), the add of
    returned boundary gradients onto the send rows, over the inverse send
    CSR the host builds with :func:`send_csr`; in f32, or in bf16 (bf16
    compute) with every add done in f32 and rounded to bf16, in slot
    order, as JAX's bf16 ``.at[].add`` rounds after each update.

K2 and K5 copy bytes, so they take rows of any dtype.

:class:`HaloExchange` (vanilla mode, differentiable ``halo_exchange``) and
:class:`StaleConcat` (pipelined mode, ``make_stale_concat``) are the
autograd functions built from them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import _build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pgt_halo_gather": [_P, _LL, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    "pgt_halo_return": [_P, _LL, _P, _LL, _I, _I, _I, _I, _P],
}
_SCATTER_SIGNATURES = {
    "pgt_halo_scatter": [_P, _LL, _P, _LL, _P, _P, _LL, _P, _I, _I, _I, _I,
                         _I, _P],
}


def _check(h, send_idx, send_mask):
    if h.dim() != 3:
        raise ValueError(f"h must be [P, n_max, F], got {tuple(h.shape)}")
    P = h.shape[0]
    if send_idx.dim() != 3 or send_idx.shape[:2] != (P, P - 1) \
            or send_mask.shape != send_idx.shape:
        raise ValueError(
            f"send_idx/send_mask must be [P, P-1, B] for P={P}, got "
            f"{tuple(send_idx.shape)} / {tuple(send_mask.shape)}")
    if send_idx.dtype != torch.int32 or send_mask.dtype != torch.bool:
        raise TypeError("send_idx must be int32 and send_mask bool")
    if P > 1 and h.shape[1] == 0:
        raise ValueError("h has no rows to gather from")
    devs = {t.device for t in (h, send_idx, send_mask)}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: {devs}")


def halo_gather_plain(h: torch.Tensor, send_idx: torch.Tensor,
                      send_mask: torch.Tensor,
                      with_inner: bool) -> torch.Tensor:
    """Plain PyTorch version of K2: for each receiver and distance, a
    clipped ``index_select`` of the sender's rows and a masked ``where``,
    concatenated behind the inner rows when ``with_inner``."""
    _check(h, send_idx, send_mask)
    P, n_max = h.shape[0], h.shape[1]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    parts = []
    for r in range(P):
        blocks = [h[r]] if with_inner else []
        for d in range(1, P):
            s = (r - d) % P
            idx = send_idx[s, d - 1].long().clamp(0, n_max - 1)
            blk = h[s].index_select(0, idx)
            blocks.append(torch.where(send_mask[s, d - 1][:, None], blk,
                                      zero))
        if blocks:
            parts.append(torch.cat(blocks, dim=0))
        else:
            parts.append(h.new_zeros((0, h.shape[2])))
    return torch.stack(parts)


def halo_gather(h: torch.Tensor, send_idx: torch.Tensor,
                send_mask: torch.Tensor, with_inner: bool) -> torch.Tensor:
    """``[P, n_max, F] -> [P, H, F]`` halo blocks, or with ``with_inner``
    the fused concat ``[P, n_max + H, F]``, ``H = (P-1) * B``. Kernel K2
    on CUDA tensors (one launch for all parts, counted in
    ``halo_gather.launches``), :func:`halo_gather_plain` on CPU."""
    if h.device.type == "cpu":
        return halo_gather_plain(h, send_idx, send_mask, with_inner)
    _check(h, send_idx, send_mask)
    if h.device.type != "cuda":
        raise ValueError(f"halo_gather: unsupported device {h.device}")
    if not all(t.is_contiguous() for t in (h, send_idx, send_mask)):
        raise ValueError("halo_gather: the kernel takes contiguous tensors")
    P, n_max, F = h.shape
    B = send_idx.shape[2]
    row_begin = 0 if with_inner else n_max
    n_rows = n_max + (P - 1) * B - row_begin
    out = torch.empty((P, n_rows, F), dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    row_bytes = F * h.element_size()
    lib = _build.load("halo_gather", _SIGNATURES)
    rc = lib.pgt_halo_gather(
        h.data_ptr(), n_max * row_bytes, out.data_ptr(), n_rows * row_bytes,
        send_idx.data_ptr(), send_mask.data_ptr(), P, n_max, B, row_begin,
        n_rows, row_bytes, torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(rc, "halo_gather")
    halo_gather.launches += 1
    return out


halo_gather.launches = 0


def send_csr(send_idx: np.ndarray, send_mask: np.ndarray,
             n_max: int) -> Tuple[np.ndarray, np.ndarray]:
    """Invert the send lists ``[P, P-1, B]`` into a CSR over each part's
    inner rows: ``send_ptr [P, n_max + 1]`` and ``send_slot [P, nnz]``
    (int32; the tail past ``send_ptr[p, n_max]`` is zero), where row i of
    part p lists the slots ``k = (d-1)*B + b`` with ``send_mask`` on and
    ``send_idx`` (clipped to [0, n_max - 1], as the gather clips it) equal
    to i, in ascending slot order. Pad slots (mask off) never enter."""
    idx = np.asarray(send_idx)
    mask = np.asarray(send_mask, dtype=bool)
    P = idx.shape[0]
    flat_idx = np.clip(idx.reshape(P, -1), 0, max(n_max - 1, 0))
    flat_mask = mask.reshape(P, -1)
    nnz = flat_mask.sum(axis=1)
    ptr = np.zeros((P, n_max + 1), np.int32)
    slot = np.zeros((P, int(nnz.max(initial=0))), np.int32)
    for p in range(P):
        slots = np.flatnonzero(flat_mask[p])
        rows = flat_idx[p, slots]
        slot[p, :slots.size] = slots[np.argsort(rows, kind="stable")]
        np.cumsum(np.bincount(rows, minlength=n_max), out=ptr[p, 1:])
    return ptr, slot


def _check_return(g, b_max):
    if g.dim() != 3:
        raise ValueError(f"halo cotangent must be [P, H, F], got "
                         f"{tuple(g.shape)}")
    if g.shape[1] != (g.shape[0] - 1) * b_max:
        raise ValueError(f"halo cotangent has {g.shape[1]} rows, expected "
                         f"(P-1)*B = {(g.shape[0] - 1) * b_max}")


def return_blocks_plain(g: torch.Tensor, b_max: int) -> torch.Tensor:
    """Plain PyTorch version of K5: for each receiver r and distance d,
    slice block d-1 of part (r+d) mod P and concatenate."""
    _check_return(g, b_max)
    P = g.shape[0]
    if P == 1:
        return g.clone()
    return torch.stack([
        torch.cat([g[(r + d) % P, (d - 1) * b_max:d * b_max]
                   for d in range(1, P)]) for r in range(P)])


def return_blocks(g: torch.Tensor, b_max: int) -> torch.Tensor:
    """``[P, H, F] -> [P, H, F]``: route each part's halo cotangent back
    along the reverse ring, ``out[r, (d-1)B:dB] = g[(r+d) mod P,
    (d-1)B:dB]`` (``pipegcn_tpu/parallel/halo.py`` ``return_blocks`` for
    all shards at once). Kernel K5 on CUDA tensors (one launch, counted in
    ``return_blocks.launches``; ``g`` may be a view whose parts are each
    contiguous), :func:`return_blocks_plain` on CPU."""
    if g.device.type == "cpu":
        return return_blocks_plain(g, b_max)
    _check_return(g, b_max)
    if g.device.type != "cuda":
        raise ValueError(f"return_blocks: unsupported device {g.device}")
    P, H, F = g.shape
    if H and (g.stride(2) != 1 or g.stride(1) != F):
        raise ValueError("return_blocks: the kernel takes parts with "
                         "contiguous rows")
    out = torch.empty((P, H, F), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    es = g.element_size()
    lib = _build.load("halo_gather", _SIGNATURES)
    rc = lib.pgt_halo_return(
        g.data_ptr(), g.stride(0) * es, out.data_ptr(), H * F * es, P,
        b_max, H, F * es, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "halo_return")
    return_blocks.launches += 1
    return out


return_blocks.launches = 0


def _check_scatter(g, bgrad, send_ptr, send_slot):
    if g.dim() != 3 or bgrad.dim() != 3 or g.shape[0] != bgrad.shape[0] \
            or g.shape[2] != bgrad.shape[2]:
        raise ValueError(f"g must be [P, n_max, F] and bgrad [P, H, F], got "
                         f"{tuple(g.shape)} / {tuple(bgrad.shape)}")
    P, n_max = g.shape[0], g.shape[1]
    if send_ptr.shape != (P, n_max + 1) or send_slot.dim() != 2 \
            or send_slot.shape[0] != P:
        raise ValueError(f"send_ptr must be [P, n_max+1] and send_slot "
                         f"[P, nnz], got {tuple(send_ptr.shape)} / "
                         f"{tuple(send_slot.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16) \
            or bgrad.dtype != g.dtype:
        raise TypeError("scatter_bgrad takes float32 or bfloat16 g and "
                        "bgrad of one dtype")
    if send_ptr.dtype != torch.int32 or send_slot.dtype != torch.int32:
        raise TypeError("send_ptr and send_slot must be int32")
    devs = {t.device for t in (g, bgrad, send_ptr, send_slot)}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: {devs}")


def scatter_bgrad_plain(g: torch.Tensor, bgrad: torch.Tensor,
                        send_ptr: torch.Tensor, send_slot: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of K4: a copy of ``g`` plus, per part, the
    masked slots' bgrad rows added onto the rows they were sent from (the
    CSR holds only masked slots): f32 by one ``index_add_``; bf16 one
    slot of each row at a time, in slot order, each add in f32 and
    rounded to bf16."""
    _check_scatter(g, bgrad, send_ptr, send_slot)
    P, n_max = g.shape[0], g.shape[1]
    out = g.clone(memory_format=torch.contiguous_format)
    rows = torch.arange(n_max, device=g.device)
    for p in range(P):
        nnz = int(send_ptr[p, -1])
        if not nnz:
            continue
        counts = send_ptr[p].diff().long()
        dst = torch.repeat_interleave(rows, counts)
        src = bgrad[p].index_select(0, send_slot[p, :nnz].long())
        if g.dtype == torch.float32:
            out[p].index_add_(0, dst, src)
            continue
        # the slot's rank within its row: rows are distinct within a rank
        rank = torch.arange(nnz, device=g.device) - torch.repeat_interleave(
            send_ptr[p, :-1].long(), counts)
        for r in range(int(counts.max())):
            sel = rank == r
            d = dst[sel]
            out[p, d] = (out[p, d].float() + src[sel].float()).to(g.dtype)
    return out


def scatter_bgrad(g: torch.Tensor, bgrad: torch.Tensor,
                  send_ptr: torch.Tensor, send_slot: torch.Tensor
                  ) -> torch.Tensor:
    """``d_h [P, n_max, F] = g + scatter_add(send rows, bgrad)`` in g's
    dtype (f32 or bf16): kernel K4 on CUDA tensors (one launch, counted in
    ``scatter_bgrad.launches`` and by dtype in ``scatter_bgrad.by_mode``;
    ``g`` and ``bgrad`` may be views whose parts are each contiguous), :func:`scatter_bgrad_plain` on CPU."""
    if g.device.type == "cpu":
        return scatter_bgrad_plain(g, bgrad, send_ptr, send_slot)
    _check_scatter(g, bgrad, send_ptr, send_slot)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_bgrad: unsupported device {g.device}")
    P, n_max, F = g.shape
    H = bgrad.shape[1]
    for t, rows in ((g, n_max), (bgrad, H)):
        if rows and (t.stride(2) != 1 or t.stride(1) != F):
            raise ValueError("scatter_bgrad: the kernel takes parts with "
                             "contiguous rows")
    if not (send_ptr.is_contiguous() and send_slot.is_contiguous()):
        raise ValueError("scatter_bgrad: send_ptr/send_slot must be "
                         "contiguous")
    out = torch.empty((P, n_max, F), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    lib = _build.load("halo_scatter", _SCATTER_SIGNATURES)
    rc = lib.pgt_halo_scatter(
        g.data_ptr(), g.stride(0), bgrad.data_ptr(), bgrad.stride(0),
        send_ptr.data_ptr(), send_slot.data_ptr(), send_slot.shape[1],
        out.data_ptr(), int(g.dtype == torch.bfloat16), P, n_max, H, F,
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "halo_scatter")
    scatter_bgrad.launches += 1
    scatter_bgrad.by_mode[str(g.dtype).split(".")[-1]] += 1
    return out


scatter_bgrad.launches = 0
scatter_bgrad.by_mode = {"float32": 0, "bfloat16": 0}  # by row dtype

def exchange_blocks(h: torch.Tensor, send_idx: torch.Tensor,
                    send_mask: torch.Tensor) -> torch.Tensor:
    """``[P, n_max, F] -> [P, (P-1)*B, F]``: every part's received halo
    block in distance order (``pipegcn_tpu/parallel/halo.py``
    ``exchange_blocks`` for all shards at once). Not differentiable: the
    pipelined step ships detached rows."""
    return halo_gather(h, send_idx, send_mask, with_inner=False)


class HaloOps:
    """The three halo functions an autograd function below runs: the
    kernel wrappers (:data:`KERNELS`, plain versions on CPU tensors) or
    the plain versions on any device (:data:`PLAIN`, the card-side
    comparison)."""

    def __init__(self, gather, ret, scatter):
        self.gather, self.ret, self.scatter = gather, ret, scatter


KERNELS = HaloOps(halo_gather, return_blocks, scatter_bgrad)
PLAIN = HaloOps(halo_gather_plain, return_blocks_plain, scatter_bgrad_plain)


class HaloExchange(torch.autograd.Function):
    """Vanilla-mode ``halo_exchange``: forward K2 with the inner rows;
    backward K5 on the halo rows' cotangent (back to the owners), then K4
    onto the send rows with the inner rows' cotangent — the transpose XLA
    derives for take -> where -> ppermute -> concat."""

    @staticmethod
    def forward(ctx, h, send_idx, send_mask, send_ptr, send_slot, ops):
        ctx.ops, ctx.n_max, ctx.b_max = ops, h.shape[1], send_idx.shape[2]
        ctx.save_for_backward(send_ptr, send_slot)
        return ops.gather(h, send_idx, send_mask, True)

    @staticmethod
    def backward(ctx, g):
        send_ptr, send_slot = ctx.saved_tensors
        n = ctx.n_max
        bg = ctx.ops.ret(g[:, n:], ctx.b_max)
        d_h = ctx.ops.scatter(g[:, :n], bg, send_ptr, send_slot)
        return d_h, None, None, None, None, None


def halo_exchange(h: torch.Tensor, send_idx: torch.Tensor,
                  send_mask: torch.Tensor,
                  inverse: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  ops: HaloOps = KERNELS) -> torch.Tensor:
    """``[P, n_max, F] -> [P, n_max + (P-1)*B, F]``: inner rows followed by
    halo rows (``pipegcn_tpu/parallel/halo.py`` ``halo_exchange``). One
    part has no halo and gets ``h`` back, as in the JAX package.
    Differentiable when ``inverse = (send_ptr, send_slot)`` (from
    :func:`send_csr`) is given, through :class:`HaloExchange`."""
    if h.shape[0] == 1:
        return h
    if inverse is None:
        return ops.gather(h, send_idx, send_mask, True)
    return HaloExchange.apply(h, send_idx, send_mask, *inverse, ops)


class StaleConcat(torch.autograd.Function):
    """Pipelined mode's staleness-1 concat (``make_stale_concat``).

    Forward ``cat(h, stale_halo)``. Backward: ``d_h`` is K4 of the inner
    rows' cotangent with LAST epoch's ``stale_bgrad`` injected at the send
    rows; this epoch's halo cotangent goes to ``probe`` (a zero leaf the
    caller differentiates, as the JAX step does) for the caller to return
    to the owners. The stale buffers themselves get no gradient."""

    @staticmethod
    def forward(ctx, h, stale_halo, stale_bgrad, probe, send_ptr, send_slot,
                ops):
        ctx.ops, ctx.n_max = ops, h.shape[1]
        ctx.save_for_backward(stale_bgrad, send_ptr, send_slot)
        return torch.cat([h, stale_halo], dim=1)

    @staticmethod
    def backward(ctx, g):
        stale_bgrad, send_ptr, send_slot = ctx.saved_tensors
        n = ctx.n_max
        d_h = ctx.ops.scatter(g[:, :n], stale_bgrad, send_ptr, send_slot)
        return d_h, None, None, g[:, n:], None, None, None


def make_stale_concat(send_ptr: torch.Tensor, send_slot: torch.Tensor,
                      ops: HaloOps = KERNELS):
    """``f(h, stale_halo, stale_bgrad, probe) -> [P, n_max + H, F]`` with
    :class:`StaleConcat`'s backward, over the inverse send CSR."""

    def stale_concat(h, stale_halo, stale_bgrad, probe):
        return StaleConcat.apply(h, stale_halo, stale_bgrad, probe,
                                 send_ptr, send_slot, ops)

    return stale_concat
