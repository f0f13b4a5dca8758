"""Incremental halo freshness — port of ``pipegcn_tpu/serve/freshness.py``
(``FreshnessTracker``, ``dirty_exchange_blocks``).

Feature updates patch the engine's feature copy in place; a per-part
dirty-row bitmap on the host records which rows changed, and the
incremental exchange replays the send-list exchange for ONLY the dirty
rows, merging the fresh rows into the resident layer-0 halo and leaving
clean slots byte for byte untouched. The result equals a full
re-exchange bit for bit (``tests/test_torch_freshness.py``).

On one card the P parts are stacked, so the JAX program's take(clip) ->
``& send_mask`` -> where -> ``ppermute`` -> ``where(bits, fresh, halo)``
becomes one predicated row copy into the halo, in place (JAX donates the
halo buffer):

  - :func:`dirty_exchange` — K18 (``ops/csrc/halo_gather.cu``, beside K2
    and K5, with their ring indexing) on CUDA tensors, counted in
    ``dirty_exchange.launches``; :func:`dirty_exchange_plain` on CPU
    tensors.

Rows travel uncompressed, as in JAX: exactness against the full exchange
is the contract, and the dirty volume is small.

``dirty_exchange(..., guard=True)`` (the serving wire guard, JAX
``dirty_exchange_blocks(guard=True)``) sums each (sender, distance)
block's row payload and its dirty-bit lane (as u8) on the sender's side
(K19's rows form over the rows and bits it ships), copies the bit lane with
K18 into a zeroed ``[P, (P-1)*B]`` u8 buffer and merges the rows with K18
in place, then sums what each receiver got: its received bits, and the
halo rows at the slots those bits name. It returns ``(halo, bad)``, ``bad``
the count of mismatching lanes. K18 merges in place, so a caller that sees
``bad > 0`` must rebuild the halo (the engine does, by a full exchange).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _build
from ..ops import digest as _digest
from ..parallel.halo import _SIGNATURES, _bad
from ..parallel.halo import _check as _check_send

_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


class FreshnessTracker:
    """Host-side dirty-row bitmap, one bool per (part, local row). Marked
    by ``ServingEngine.apply_updates``, shipped to the device once per
    ``refresh_boundary`` (the bits :func:`dirty_exchange` reads) and
    cleared there."""

    def __init__(self, num_parts: int, n_max: int):
        self.dirty = np.zeros((num_parts, n_max), bool)

    def mark(self, parts: np.ndarray, rows: np.ndarray) -> None:
        self.dirty[np.asarray(parts), np.asarray(rows)] = True

    @property
    def any(self) -> bool:
        return bool(self.dirty.any())

    def counts(self) -> np.ndarray:
        """Dirty rows per part (observability)."""
        return self.dirty.sum(axis=1)

    def clear(self) -> None:
        self.dirty[:] = False


def _check(h, halo, dirty, send_idx, send_mask):
    _check_send(h, send_idx, send_mask)
    P, n_max, F = h.shape
    B = send_idx.shape[2]
    if tuple(halo.shape) != (P, (P - 1) * B, F):
        raise ValueError(f"halo must be [P, (P-1)*B, F] = "
                         f"{(P, (P - 1) * B, F)}, got {tuple(halo.shape)}")
    if halo.dtype != h.dtype:
        raise TypeError(f"halo ({halo.dtype}) and rows ({h.dtype}) must "
                        "share a dtype")
    if tuple(dirty.shape) != (P, n_max) \
            or dirty.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"dirty must be bool or uint8 [P, n_max] = "
                         f"{(P, n_max)}, got {dirty.dtype} "
                         f"{tuple(dirty.shape)}")
    devs = {t.device for t in (h, halo, dirty, send_idx)}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: {devs}")


def dirty_exchange_plain(h: torch.Tensor, halo: torch.Tensor,
                         dirty: torch.Tensor, send_idx: torch.Tensor,
                         send_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K18: for each receiver and distance, the
    clipped ``index_select`` of the sender's rows and of its dirty bits,
    the bits masked by ``send_mask``, and a ``where`` into the halo block
    on the rows' integer bit patterns (so NaN payloads are copied, never
    rounded). Updates ``halo`` in place and returns it."""
    _check(h, halo, dirty, send_idx, send_mask)
    P, n_max = h.shape[:2]
    B = send_idx.shape[2]
    bits_t = _INT_OF_SIZE[h.element_size()]
    hb, ob = h.view(bits_t), halo.view(bits_t)
    live = dirty.bool()
    for r in range(P):
        for d in range(1, P):
            s = (r - d) % P
            idx = send_idx[s, d - 1].long().clamp(0, n_max - 1)
            bit = live[s].index_select(0, idx) & send_mask[s, d - 1]
            blk = ob[r, (d - 1) * B:d * B]
            blk.copy_(torch.where(bit[:, None], hb[s].index_select(0, idx),
                                  blk))
    return halo


def slot_index(P: int, B: int, device: torch.device) -> torch.Tensor:
    """``[P, P-1, B]`` int32: each receiver's own halo slots, ``(d-1)*B +
    b`` — the row list of K19's rows form over a halo."""
    k = torch.arange((P - 1) * B, dtype=torch.int32, device=device)
    return k.view(1, P - 1, B).expand(P, P - 1, B).contiguous()


def _guarded(h, halo, dirty, send_idx, send_mask):
    """:func:`dirty_exchange` with the wire guard: ``(halo, bad)``."""
    _check(h, halo, dirty, send_idx, send_mask)
    P, B = h.shape[0], send_idx.shape[2]
    bad = torch.zeros((), dtype=torch.int64, device=h.device)
    if P < 2 or B == 0:
        return halo, bad
    bits = dirty.to(torch.uint8)
    # the sender's sums: the rows it ships and their dirty bits
    snd_rows = _digest.row_sums(h, send_idx, send_mask, dirty)
    snd_bits = _digest.row_sums(bits, send_idx, send_mask)
    # the copies: the bit lane into zeros, the rows into the halo
    rbits = torch.zeros((P, (P - 1) * B), dtype=torch.uint8,
                        device=h.device)
    dirty_exchange(bits[..., None], rbits[..., None], dirty, send_idx,
                   send_mask)
    dirty_exchange(h, halo, dirty, send_idx, send_mask)
    # the receiver's sums: its bits, and its rows at the slots they name
    rcv_bits = _digest.part_digests(rbits, P - 1)[:, 0].view(P, P - 1)
    rcv_rows = _digest.row_sums(halo, slot_index(P, B, h.device),
                                rbits.view(P, P - 1, B).bool())
    return halo, (_bad(rcv_rows, snd_rows, exchange=True)
                  + _bad(rcv_bits, snd_bits, exchange=True))


def dirty_exchange(h: torch.Tensor, halo: torch.Tensor, dirty: torch.Tensor,
                   send_idx: torch.Tensor, send_mask: torch.Tensor,
                   guard: bool = False):
    """Merge the dirty send rows of ``h [P, n_max, F]`` (the send view)
    into the resident ``halo [P, (P-1)*B, F]`` in place, ``dirty
    [P, n_max]`` bool or uint8 on ``h``'s device; returns ``halo``, or
    with ``guard`` ``(halo, bad)`` (the module docstring). Kernel K18 on
    CUDA tensors (one launch for every part and distance),
    :func:`dirty_exchange_plain` on CPU tensors."""
    if guard:
        return _guarded(h, halo, dirty, send_idx, send_mask)
    if h.device.type == "cpu":
        return dirty_exchange_plain(h, halo, dirty, send_idx, send_mask)
    _check(h, halo, dirty, send_idx, send_mask)
    if h.device.type != "cuda":
        raise ValueError(f"dirty_exchange: unsupported device {h.device}")
    if not all(t.is_contiguous()
               for t in (h, halo, dirty, send_idx, send_mask)):
        raise ValueError("dirty_exchange: the kernel takes contiguous "
                         "tensors")
    P, n_max, F = h.shape
    B = send_idx.shape[2]
    if P < 2 or B == 0 or F == 0:
        return halo
    row_bytes = F * h.element_size()
    lib = _build.load("halo_gather", _SIGNATURES)
    rc = lib.pgt_dirty_exchange(
        h.data_ptr(), n_max * row_bytes, halo.data_ptr(),
        (P - 1) * B * row_bytes, send_idx.data_ptr(), send_mask.data_ptr(),
        dirty.data_ptr(), P, n_max, B, row_bytes,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(rc, "dirty_exchange")
    dirty_exchange.launches += 1
    return halo


dirty_exchange.launches = 0
