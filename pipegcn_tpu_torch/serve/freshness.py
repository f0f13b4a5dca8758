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
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _build
from ..parallel.halo import _SIGNATURES
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


def dirty_exchange(h: torch.Tensor, halo: torch.Tensor, dirty: torch.Tensor,
                   send_idx: torch.Tensor,
                   send_mask: torch.Tensor) -> torch.Tensor:
    """Merge the dirty send rows of ``h [P, n_max, F]`` (the send view)
    into the resident ``halo [P, (P-1)*B, F]`` in place, ``dirty
    [P, n_max]`` bool or uint8 on ``h``'s device; returns ``halo``.
    Kernel K18 on CUDA tensors (one launch for every part and distance),
    :func:`dirty_exchange_plain` on CPU tensors."""
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
