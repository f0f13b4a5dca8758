"""Halo exchange on the stacked one-card layout — port of
``pipegcn_tpu/parallel/halo.py`` (``exchange_blocks``, ``halo_exchange``;
the backward ``return_blocks`` and ``make_stale_concat`` come with
training).

The JAX package runs one shard per device inside ``shard_map`` and ships
each ring distance with ``lax.ppermute``. On one card the P parts live
stacked as ``h [P, n_max, F]``, so the ring becomes a row copy between
parts with the same numbering (``pipegcn_tpu/parallel/halo.py:13-16``):
receiver r's distance-d block holds ``h[s][send_idx[s][d-1]]``, zeroed
where ``send_mask[s][d-1]`` is off, with ``s = (r-d) mod P``; blocks follow
the inner rows in distance order. ``send_idx`` is read in clip mode, as
``jnp.take(mode="clip")``.

:func:`halo_gather` launches kernel K2 (``ops/csrc/halo_gather.cu``) for
CUDA tensors and runs :func:`halo_gather_plain` for CPU tensors; anything
else raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import _build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pgt_halo_gather": [_P, _LL, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
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


def exchange_blocks(h: torch.Tensor, send_idx: torch.Tensor,
                    send_mask: torch.Tensor) -> torch.Tensor:
    """``[P, n_max, F] -> [P, (P-1)*B, F]``: every part's received halo
    block in distance order (``pipegcn_tpu/parallel/halo.py``
    ``exchange_blocks`` for all shards at once)."""
    return halo_gather(h, send_idx, send_mask, with_inner=False)


def halo_exchange(h: torch.Tensor, send_idx: torch.Tensor,
                  send_mask: torch.Tensor) -> torch.Tensor:
    """``[P, n_max, F] -> [P, n_max + (P-1)*B, F]``: inner rows followed by
    halo rows (``pipegcn_tpu/parallel/halo.py`` ``halo_exchange``). One
    part has no halo and gets ``h`` back, as in the JAX package."""
    if h.shape[0] == 1:
        return h
    return halo_gather(h, send_idx, send_mask, with_inner=True)
