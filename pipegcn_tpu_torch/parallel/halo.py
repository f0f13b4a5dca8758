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

The compressed wire (``--halo-dtype``, pipelined mode only; JAX
``_permute_compressed``, ``halo_transport_dtypes``): each distance block
travels in a narrow dtype, bf16 by a plain cast, fp8 as e4m3 features /
e5m2 boundary gradients scaled by one power of two a (sender, distance)
block from the block's amax; the receiver decodes with the SENDER's
inverse scale into the compute dtype. Two more kernels, each with its
plain version:

  - :func:`halo_amax` — K14 (``ops/csrc/halo_wire.cu``), the amax of every
    sender's block at every distance, in one launch;
  - :func:`halo_wire` — K15 (the same file), the gather (or the return
    path's block slice), scale, saturating cast, the write of the narrow
    payload into the wire buffer ``[P, P-1, B, F]`` at the receiver's slot
    (the bytes the ring would carry), and the decode into the receiver's
    halo rows, in one launch.

:func:`exchange_blocks` and :func:`return_blocks` take the wire dtype;
the carries stay in the compute dtype ("wire-only").

The wire-integrity lane (``guard=True``, pipelined training under
``--integrity-check-every``; JAX ``_permute_compressed(guard=True)``):
:func:`exchange_blocks`, :func:`return_blocks` and the wire return ``(out,
bad)``, ``bad`` a 0-d int64 count of (receiver, distance) blocks whose
received bits do not sum to the sender's sum (``ops/digest.py``, K19). On
the K2 / K5 paths the sender's sum is taken from the rows it sends
(:func:`~pipegcn_tpu_torch.ops.digest.row_sums`, or its return blocks),
the receiver's from the block it got. On the compressed wire the sums
cover the narrow payload and the inverse scales (JAX's ``bad_inv``) in the
wire buffer: on one card K15 writes them straight into the receiver's
slot, which is the ring copy, so both sums read that buffer (ROADMAP §C).
``guard=False`` runs exactly the unguarded launches.

:class:`HaloExchange` (vanilla mode, differentiable ``halo_exchange``) and
:class:`StaleConcat` (pipelined mode, ``make_stale_concat``) are the
autograd functions built from them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops import digest as _digest
from ..ops.bucket_spmm import (_OUT_TYPES, F8_MAX, TransportShare,
                               pow2_scale, quantize, transport_dtypes)

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {
    "pgt_halo_gather": [_P, _LL, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    "pgt_halo_return": [_P, _LL, _P, _LL, _I, _I, _I, _I, _P],
    # K18, the serving engine's dirty-row exchange (serve/freshness.py)
    "pgt_dirty_exchange": [_P, _LL, _P, _LL, _P, _P, _P, _I, _I, _I, _I,
                           _P],
}
_WIRE_SIGNATURES = {
    "pgt_halo_amax": [_P, _I, _LL, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "pgt_halo_wire": [_P, _I, _LL, _I, _I, _I, _I, _P, _P, _P, _I, _F, _P,
                      _P, _P, _I, _P],
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


def return_blocks_plain(g: torch.Tensor, b_max: int,
                        transport_dt: Optional[torch.dtype] = None,
                        share: Optional[TransportShare] = None,
                        guard: bool = False):
    """Plain PyTorch version of K5: for each receiver r and distance d,
    slice block d-1 of part (r+d) mod P and concatenate. With
    ``transport_dt`` the plain wire (:func:`halo_wire_plain`) instead;
    ``guard`` as :func:`return_blocks`."""
    if transport_dt is not None:
        return _wire(g, None, None, b_max, transport_dt, PLAIN, share,
                     guard)
    if guard:
        return _guarded_return(g, b_max, PLAIN)
    _check_return(g, b_max)
    P = g.shape[0]
    if P == 1:
        return g.clone()
    return torch.stack([
        torch.cat([g[(r + d) % P, (d - 1) * b_max:d * b_max]
                   for d in range(1, P)]) for r in range(P)])


def return_blocks(g: torch.Tensor, b_max: int,
                  transport_dt: Optional[torch.dtype] = None,
                  share: Optional[TransportShare] = None,
                  guard: bool = False):
    """``[P, H, F] -> [P, H, F]``: route each part's halo cotangent back
    along the reverse ring, ``out[r, (d-1)B:dB] = g[(r+d) mod P,
    (d-1)B:dB]`` (``pipegcn_tpu/parallel/halo.py`` ``return_blocks`` for
    all shards at once). Kernel K5 on CUDA tensors (one launch, counted in
    ``return_blocks.launches``; ``g`` may be a view whose parts are each
    contiguous), :func:`return_blocks_plain` on CPU. With
    ``transport_dt`` (the boundary-gradient wire dtype) the blocks cross
    the compressed wire instead: K14 and K15 (:func:`halo_wire`), values
    taken from or recorded into ``share``. With ``guard`` it returns
    ``(out, bad)``, the wire-integrity lane's mismatching blocks."""
    if transport_dt is not None:
        return _wire(g, None, None, b_max, transport_dt, KERNELS, share,
                     guard)
    if guard:
        return _guarded_return(g, b_max, KERNELS)
    dev = g.device
    if dev.type == "cpu":
        return return_blocks_plain(g, b_max)
    if dev.type != "cuda":
        raise ValueError(f"return_blocks: unsupported device {dev}")
    # only the checks that guard the kernel's reads: the shape (its block
    # offsets) and each part's rows contiguous
    _check_return(g, b_max)
    P, H, F = g.shape
    if H and (g.stride(2) != 1 or g.stride(1) != F):
        raise ValueError("return_blocks: the kernel takes parts with "
                         "contiguous rows")
    out = torch.empty((P, H, F), dtype=g.dtype, device=dev)
    if out.numel() == 0:
        return out
    es = g.element_size()
    fn = _return_fn()
    rc = fn(g.data_ptr(), g.stride(0) * es, out.data_ptr(), H * F * es, P,
            b_max, H, F * es, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "halo_return")
    return_blocks.launches += 1
    return out


return_blocks.launches = 0


@functools.lru_cache(maxsize=None)
def _return_fn():
    """K5's entry point, looked up once (``_build.load`` takes a lock and
    a dict lookup a call)."""
    return _build.load("halo_gather", _SIGNATURES).pgt_halo_return


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

# ---------------------------------------------------------------------------
# K14, K15: the compressed halo wire


def halo_transport_dtypes(halo_dtype: Optional[str]
                          ) -> Tuple[Optional[torch.dtype],
                                     Optional[torch.dtype]]:
    """(feature, boundary-gradient) wire dtypes of a ``--halo-dtype``: the
    gather transport's mapping (e4m3 / e5m2 under float8, bf16 both ways
    under bfloat16), None both for none (the compute dtype)."""
    return transport_dtypes(halo_dtype)


def _check_wire(x, send_idx, send_mask, b_max):
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32/bf16 [P, rows, F], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if send_idx is None:
        _check_return(x, b_max)
        return
    _check(x, send_idx, send_mask)
    if send_idx.shape[2] != b_max:
        raise ValueError(f"send lists hold {send_idx.shape[2]} rows a "
                         f"block, expected B = {b_max}")


def _senders(P: int, exchange: bool) -> torch.Tensor:
    """``[P, P-1]``: the part whose distance-d block receiver r takes, (r -
    d) mod P on the exchange, (r + d) mod P on the return."""
    r = torch.arange(P)[:, None]
    d = torch.arange(1, P)[None, :]
    return (r - d) % P if exchange else (r + d) % P


def _sender_blocks(x, send_idx, send_mask, b_max) -> torch.Tensor:
    """``[P, P-1, B, F]``: sender s's block at distance d in slot [s, d-1]
    — its send rows gathered (clipped) and masked on the exchange
    (``send_idx`` given), ``x[s, (d-1)B:dB]`` on the return."""
    P, n, F = x.shape
    if send_idx is None:
        return x.reshape(P, P - 1, b_max, F)
    idx = send_idx.long().clamp(0, max(n - 1, 0))
    blk = x[torch.arange(P, device=x.device)[:, None, None], idx]
    return torch.where(send_mask[..., None], blk, x.new_zeros(()))


def halo_amax_plain(x: torch.Tensor, send_idx: Optional[torch.Tensor],
                    send_mask: Optional[torch.Tensor], b_max: int
                    ) -> torch.Tensor:
    """Plain PyTorch version of K14: ``max |block|`` in f32 of every
    sender's block at every distance, ``[P, P-1]`` (masked rows count as
    0; a NaN propagates; 0 for an empty block). ``send_idx`` None: the
    return path's blocks of ``x [P, H, F]``."""
    _check_wire(x, send_idx, send_mask, b_max)
    blk = _sender_blocks(x, send_idx, send_mask, b_max).float()
    if blk.shape[2] * blk.shape[3] == 0:
        return x.new_zeros(blk.shape[:2], dtype=torch.float32)
    return blk.abs().amax(dim=(2, 3))


def halo_amax(x: torch.Tensor, send_idx: Optional[torch.Tensor],
              send_mask: Optional[torch.Tensor], b_max: int
              ) -> torch.Tensor:
    """K14 on CUDA tensors (one launch for every part and distance,
    counted in ``halo_amax.launches`` and by path in
    ``halo_amax.by_mode``), :func:`halo_amax_plain` on CPU tensors;
    anything else raises."""
    if x.device.type == "cpu":
        return halo_amax_plain(x, send_idx, send_mask, b_max)
    _check_wire(x, send_idx, send_mask, b_max)
    if x.device.type != "cuda":
        raise ValueError(f"halo_amax: unsupported device {x.device}")
    P, n, F = x.shape
    amax = torch.empty((P, max(P - 1, 0)), dtype=torch.int32,
                       device=x.device)  # zeroed by the entry point
    if amax.numel() == 0:
        return amax.view(torch.float32)
    lib = _build.load("halo_wire", _WIRE_SIGNATURES)
    rc = lib.pgt_halo_amax(*_wire_args(x, send_idx, send_mask, b_max),
                           amax.data_ptr(), k14_vec(x),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "halo_amax")
    halo_amax.launches += 1
    halo_amax.by_mode["exchange" if send_idx is not None else "return"] += 1
    return amax.view(torch.float32)


halo_amax.launches = 0
halo_amax.by_mode = {"exchange": 0, "return": 0}


def _wire_args(x, send_idx, send_mask, b_max):
    """The leading arguments K14 and K15 share: the rows, their type,
    part stride (elements), P, rows a part, F, B, the send lists or
    nulls."""
    P, n, F = x.shape
    if n and (x.stride(2) != 1 or x.stride(1) != F):
        raise ValueError("halo wire: the kernels take parts with "
                         "contiguous rows")
    if send_idx is not None and not (send_idx.is_contiguous()
                                     and send_mask.is_contiguous()):
        raise ValueError("halo wire: send lists must be contiguous")
    if n >= 2 ** 31 or F >= 2 ** 31 or b_max >= 2 ** 31:
        raise ValueError("halo wire: x too large for the kernels")
    return (x.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(0), P,
            n, F, b_max, None if send_idx is None else send_idx.data_ptr(),
            None if send_mask is None else send_mask.data_ptr())


def k14_vec(x: torch.Tensor) -> int:
    """K14's vector: the most elements (at most 16 bytes of ``x``) that F,
    ``x``'s part stride and its pointer are aligned to, so that every row
    (and every return block) starts on a vector."""
    F = x.shape[2]
    vec = 16 // x.element_size()
    while vec > 1 and (F % vec or x.stride(0) % vec
                       or x.data_ptr() % (vec * x.element_size())):
        vec //= 2
    return vec


def k15_vec(x: torch.Tensor, wire: torch.Tensor, out: torch.Tensor) -> int:
    """K15's vector: the most elements (at most 16 bytes of ``x``) that F,
    ``x``'s part stride and the ``x``, ``wire`` and ``out`` pointers are all
    aligned to, so that every row of each starts on a vector."""
    F = x.shape[2]
    vec = 16 // x.element_size()
    while vec > 1 and (F % vec or x.stride(0) % vec or any(
            t.data_ptr() % (vec * t.element_size()) for t in (x, wire, out))):
        vec //= 2
    return vec


def _decode(wire: torch.Tensor, inv: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    """The receiver's decode: ``(wire.f32 * inv).astype(dtype)`` (JAX
    ``_permute_compressed``), a plain cast where the wire carries no
    scale (bf16)."""
    v = wire.float()
    if inv is not None:
        v = v * inv[..., None, None]
    return v.to(dtype)


def _check_dt(dt, amax, P):
    if dt not in _OUT_TYPES:
        raise ValueError(f"unknown halo wire dtype {dt}")
    if (amax is None) == (dt in F8_MAX):
        raise ValueError("an fp8 wire takes the blocks' amax [P, P-1]; a "
                         "bf16 wire none")
    if amax is not None and (amax.shape != (P, P - 1)
                             or amax.dtype != torch.float32):
        raise ValueError(f"amax must be f32 [{P}, {P - 1}]")


def halo_wire_plain(x: torch.Tensor, send_idx: Optional[torch.Tensor],
                    send_mask: Optional[torch.Tensor], b_max: int,
                    dt: torch.dtype, amax: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """Plain PyTorch version of K15, JAX ``_permute_compressed`` for every
    (part, distance): each sender's block (:func:`halo_amax_plain`'s)
    scaled by ``pow2_scale`` of its ``amax`` (fp8; ``amax`` None for a
    bf16 wire), saturated and cast to ``dt``; the payload written to the
    receiver's slot of the wire ``[P, P-1, B, F]``, the sender's inverse
    scale beside it (``inv [P, P-1]``, None for bf16), and decoded into
    the receiver's halo ``[P, (P-1)*B, F]`` in x's dtype. Returns ``(halo,
    wire, inv)``."""
    _check_wire(x, send_idx, send_mask, b_max)
    P, F = x.shape[0], x.shape[2]
    _check_dt(dt, amax, P)
    blk = _sender_blocks(x, send_idx, send_mask, b_max)
    flat = blk.reshape(-1, b_max, F)
    scale = None if amax is None else pow2_scale(amax.reshape(-1),
                                                 F8_MAX[dt])
    y = quantize(flat, dt, None, scale).view(P, P - 1, b_max, F)
    snd = _senders(P, send_idx is not None).to(x.device)
    col = torch.arange(P - 1, device=x.device)[None, :]
    wire = y[snd, col]
    inv = None if scale is None else (1.0 / scale).view(P, P - 1)[snd, col]
    return (_decode(wire, inv, x.dtype).reshape(P, (P - 1) * b_max, F),
            wire, inv)


def halo_wire(x: torch.Tensor, send_idx: Optional[torch.Tensor],
              send_mask: Optional[torch.Tensor], b_max: int,
              dt: torch.dtype, amax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor,
                         Optional[torch.Tensor]]:
    """K15 on CUDA tensors (one launch for every part and distance,
    counted in ``halo_wire.launches`` and by wire dtype in
    ``halo_wire.by_mode``), :func:`halo_wire_plain` on CPU tensors;
    anything else raises."""
    if x.device.type == "cpu":
        return halo_wire_plain(x, send_idx, send_mask, b_max, dt, amax)
    _check_wire(x, send_idx, send_mask, b_max)
    if x.device.type != "cuda":
        raise ValueError(f"halo_wire: unsupported device {x.device}")
    P, F = x.shape[0], x.shape[2]
    _check_dt(dt, amax, P)
    if amax is not None and not amax.is_contiguous():
        raise ValueError("halo_wire: amax must be contiguous")
    out = torch.empty((P, (P - 1) * b_max, F), dtype=x.dtype,
                      device=x.device)
    wire = torch.empty((P, P - 1, b_max, F), dtype=dt, device=x.device)
    inv = None if amax is None else torch.empty(
        (P, P - 1), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        if inv is not None:
            inv.fill_(1.0)
        return out, wire, inv
    lib = _build.load("halo_wire", _WIRE_SIGNATURES)
    rc = lib.pgt_halo_wire(
        *_wire_args(x, send_idx, send_mask, b_max),
        None if amax is None else amax.data_ptr(), _OUT_TYPES[dt],
        F8_MAX.get(dt, 0.0), wire.data_ptr(),
        None if inv is None else inv.data_ptr(), out.data_ptr(),
        k15_vec(x, wire, out),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "halo_wire")
    halo_wire.launches += 1
    halo_wire.by_mode[str(dt).split(".")[-1]] += 1
    return out, wire, inv


halo_wire.launches = 0
halo_wire.by_mode = {"float8_e4m3fn": 0, "float8_e5m2": 0, "bfloat16": 0}


def _wire(x, send_idx, send_mask, b_max, dt, ops, share, guard=False):
    """The compressed wire of one exchange (``send_idx`` given) or return:
    the halo ``[P, (P-1)*B, F]`` in x's dtype. ``ops`` picks the kernels
    (K14, K15) or the plain versions. ``share`` (a ``TransportShare``)
    records the payload and inverse scales in sender order, ``[P*(P-1),
    B, F]`` and ``[P*(P-1)]``, or replaces this run's with another run's,
    the flips of its own cast counted. ``guard`` returns ``(halo, bad)``
    (:func:`_wire_bad`)."""
    P, F = x.shape[0], x.shape[2]
    if P == 1:
        out = x.new_zeros((1, 0, F))
        return (out, _no_bad(x)) if guard else out
    exchange = send_idx is not None
    col = torch.arange(P - 1, device=x.device)[None, :]
    if share is not None and share.source is not None:
        _check_wire(x, send_idx, send_mask, b_max)
        flat = _sender_blocks(x, send_idx, send_mask, b_max).reshape(
            -1, b_max, F)
        y, inv = share.take(flat, dt)
        snd = _senders(P, exchange).to(x.device)
        wire = y.view(P, P - 1, b_max, F)[snd, col]
        inv = None if inv is None else inv.view(P, P - 1)[snd, col]
        out = _decode(wire, inv, x.dtype).reshape(P, (P - 1) * b_max, F)
        return (out, _no_bad(x)) if guard else out
    amax = (ops.amax(x, send_idx, send_mask, b_max) if dt in F8_MAX
            else None)
    out, wire, inv = ops.wire(x, send_idx, send_mask, b_max, dt, amax)
    if share is not None:
        rcv = _senders(P, not exchange).to(x.device)  # sender -> receiver
        share.recorded.append((
            wire[rcv, col].reshape(-1, b_max, F),
            None if inv is None else inv[rcv, col].reshape(-1)))
    if not guard:
        return out
    return out, _wire_bad(out, wire, inv, amax, dt, exchange, ops)


def _nan_canonical(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every NaN as torch writes one: K15 and the plain decode
    may write different NaN bits for the same NaN value."""
    return torch.where(t.isnan(), t.new_full((), float("nan")), t)


def _wire_bad(out, wire, inv, amax, dt, exchange, ops) -> torch.Tensor:
    """The compressed wire's integrity lane on one card: the count of
    receiver slots ``[r, d-1]`` whose decoded block (what the receiver
    consumes) does not sum to an independent decode of the payload and
    scale K15 wrote there, or whose scale is not its sender's (JAX's
    ``bad_inv`` lane: ``1 / pow2_scale`` of K14's amax, in sender order).
    K15 encodes, copies and decodes in one launch, so no copy of the
    payload exists before the ring copy to sum; a corruption of the halo,
    the payload or the scale after K15 shows, one inside K15 that writes
    the same wrong value to both does not."""
    P = out.shape[0]
    ref = _decode(wire, inv, out.dtype).reshape(out.shape)
    bad = (_block_sums(_nan_canonical(out), P, ops)
           != _block_sums(_nan_canonical(ref), P, ops))
    if inv is not None:
        col = torch.arange(P - 1, device=out.device)[None, :]
        want = (1.0 / pow2_scale(amax.reshape(-1), F8_MAX[dt])).view(
            P, P - 1)[_senders(P, exchange).to(out.device), col]
        bad |= inv.view(torch.int32) != want.view(torch.int32)
    return bad.sum()


def exchange_blocks(h: torch.Tensor, send_idx: torch.Tensor,
                    send_mask: torch.Tensor,
                    transport_dt: Optional[torch.dtype] = None,
                    ops: Optional["HaloOps"] = None,
                    share: Optional[TransportShare] = None,
                    guard: bool = False):
    """``[P, n_max, F] -> [P, (P-1)*B, F]``: every part's received halo
    block in distance order (``pipegcn_tpu/parallel/halo.py``
    ``exchange_blocks`` for all shards at once): K2, or with
    ``transport_dt`` (the feature wire dtype) the compressed wire (K14,
    K15), values taken from or recorded into ``share``. ``ops`` picks the
    kernel wrappers (the default) or the plain versions. Not
    differentiable: the pipelined step ships detached rows. With
    ``guard`` it returns ``(halo, bad)``: the sender's sums of its send
    rows (K19's rows form) against the receiver's of each block it got
    (the ranges form), ``bad`` the count that differ."""
    ops = KERNELS if ops is None else ops
    if transport_dt is not None:
        return _wire(h, send_idx, send_mask, send_idx.shape[2],
                     transport_dt, ops, share, guard)
    if not guard:
        return ops.gather(h, send_idx, send_mask, False)
    P = h.shape[0]
    if P == 1:
        return ops.gather(h, send_idx, send_mask, False), _no_bad(h)
    snd = ops.rows(h, send_idx, send_mask)
    out = ops.gather(h, send_idx, send_mask, False)
    return out, _bad(_block_sums(out, P, ops), snd, exchange=True)


def wire_sum(x: torch.Tensor) -> torch.Tensor:
    """0-d int32 (u32 bits): the wraparound sum of a tensor's bits, the
    wire-integrity checksum (JAX ``wire_sum``; s1 of K19's digest)."""
    return _digest.digest(x.contiguous())[0]


def _no_bad(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=x.device)


def _block_sums(x: torch.Tensor, P: int, ops: "HaloOps") -> torch.Tensor:
    """``[P, P-1]`` s1 of each part's distance blocks of ``x [P, (P-1)*B,
    F]`` (each part's rows contiguous)."""
    return ops.digests(x, P - 1)[:, 0].view(P, P - 1)


def _bad(rcv: torch.Tensor, snd: torch.Tensor, exchange: bool
         ) -> torch.Tensor:
    """Count of receiver slots ``[r, d-1]`` whose sum differs from its
    sender's (``snd`` in sender order): (r - d) mod P on the exchange,
    (r + d) mod P on the return."""
    P = rcv.shape[0]
    col = torch.arange(P - 1, device=rcv.device)[None, :]
    return (rcv != snd[_senders(P, exchange).to(rcv.device), col]).sum()


def _guarded_return(g: torch.Tensor, b_max: int, ops: "HaloOps"):
    """The return with the wire-integrity lane: the senders' sums of their
    distance blocks of ``g``, the copy (K5 or its plain version), the
    receivers' sums of what they got."""
    _check_return(g, b_max)
    P = g.shape[0]
    if P == 1:
        return ops.ret(g, b_max), _no_bad(g)
    snd = _block_sums(g, P, ops)
    out = ops.ret(g, b_max)
    return out, _bad(_block_sums(out, P, ops), snd, exchange=False)


class HaloOps:
    """The halo functions a caller runs: the kernel wrappers
    (:data:`KERNELS`, plain versions on CPU tensors) or the plain versions
    on any device (:data:`PLAIN`, the card-side comparison) — K2's
    gather, K5's return, K4's scatter, the wire's K14 / K15 and the
    wire-integrity lane's K19 sums (``digests``: the ranges form,
    ``rows``: the rows form)."""

    def __init__(self, gather, ret, scatter, amax, wire, digests, rows):
        self.gather, self.ret, self.scatter = gather, ret, scatter
        self.amax, self.wire = amax, wire
        self.digests, self.rows = digests, rows


KERNELS = HaloOps(halo_gather, return_blocks, scatter_bgrad, halo_amax,
                  halo_wire, _digest.part_digests, _digest.row_sums)
PLAIN = HaloOps(halo_gather_plain, return_blocks_plain, scatter_bgrad_plain,
                halo_amax_plain, halo_wire_plain, _digest.part_digests_plain,
                _digest.row_sums_plain)


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
