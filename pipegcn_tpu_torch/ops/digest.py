"""Bit digests of device state — K19 (``ops/csrc/digest.cu``) and its plain
versions; port of the digests of ``pipegcn_tpu/resilience/integrity.py``
(``host_digest``, ``device_digest``, ``shard_digests``, ``flip_bit``).

A digest of a range of words ``u_i`` (every element's raw bits zero-extended
to u32; 8-byte dtypes as two u32 halves) is ``[s1, s2] = [sum u_i,
sum u_i * (2i + 1)]`` mod 2^32 (``s1`` is ``parallel/halo.py``'s
``wire_sum``): order-free, so the kernel's atomics give
the same bits on every run, equal to the numpy :func:`host_digest`. Digests
travel as int32 tensors holding the u32 bits (PyTorch has no uint32
arithmetic on CUDA); :func:`as_u32` reads them back on the host.

Three forms, each a wrapper that launches K19 on CUDA tensors, runs its
plain version on CPU tensors and raises for any other device:

  - :func:`digest` — ``[2]`` of one tensor (``device_digest``);
  - :func:`part_digests` — ``[R, 2]`` over the leading index, or over
    ``blocks`` equal blocks of each part (``shard_digests``; the weight
    index restarts at 0 in each range, as under JAX's ``vmap``);
  - :func:`row_sums` — ``[P, P-1]`` s1 over the send rows
    ``h[s][clip(send_idx[s, d-1])]`` where ``send_mask`` (and, given,
    the owner row's ``dirty`` bit) is on: the sender side of the halo
    wire lane, taken where the payload is formed.

The plain versions cannot use uint32 arithmetic: they compute in int64,
masked to 32 bits per chunk, and split each word into 16-bit halves before
the weight multiply (a u32 times a u32 overflows int64).

The numpy helpers (:func:`host_digest`, :func:`flip_bit`) are the host
references of the tests and of ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pgt_digest_ranges": [_P, _LL, _LL, _I, _I, _LL, _I, _P, _P],
    "pgt_digest_rows": [_P, _LL, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
}
_M32 = 0xFFFFFFFF
# words of one plain-version chunk: int64 partial sums of masked 32-bit
# terms stay below 2^63
_CHUNK = 1 << 22
# the same-width integer view of each element size
_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int32}

# ---------------------------------------------------------------------------
# host references (numpy)


def _as_u32(a: np.ndarray) -> np.ndarray:
    """Host bit view of any array as a flat uint32 vector (sub-word dtypes
    zero-extended per element, 8-byte dtypes as their two u32 halves)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        a = a.astype(np.uint8)
    size = a.dtype.itemsize
    if size == 1:
        return a.reshape(-1).view(np.uint8).astype(np.uint32)
    if size == 2:
        return a.reshape(-1).view(np.uint16).astype(np.uint32)
    return a.reshape(-1).view(np.uint32)


def host_digest(a: np.ndarray) -> np.ndarray:
    """``[2]`` uint32 ``[sum u, sum u * (2i + 1)]`` (wraparound) of an
    array's bits: the numpy reference every K19 form equals."""
    u = _as_u32(np.asarray(a))
    with np.errstate(over="ignore"):
        n = u.shape[0]
        w = (np.arange(n, dtype=np.uint32) << np.uint32(1)) | np.uint32(1)
        s1 = np.add.reduce(u, dtype=np.uint32) if n else np.uint32(0)
        s2 = (np.add.reduce(u * w, dtype=np.uint32) if n
              else np.uint32(0))
    return np.asarray([s1, s2], np.uint32)


def _as_u32_inplace(flat: np.ndarray) -> np.ndarray:
    size = flat.dtype.itemsize
    if flat.dtype == np.bool_ or size == 1:
        return flat.view(np.uint8)
    if size == 2:
        return flat.view(np.uint16)
    return flat.view(np.uint32)


def flip_bit(a: np.ndarray, *, bit: int = 0, index: int = 0) -> np.ndarray:
    """A copy of ``a`` with one bit flipped in the word at flat position
    ``index`` (the chaos lane's SDC model); ``bit`` counts from the word's
    LSB, out-of-range values wrap."""
    a = np.array(a, copy=True)
    flat = a.reshape(-1)
    if flat.size == 0:
        return a
    index = int(index) % flat.size
    view = _as_u32_inplace(flat)
    width = 8 * min(a.dtype.itemsize, 4)
    view[index % view.size] ^= np.uint32(1) << np.uint32(bit % width)
    return a


def flip_bit_(t: torch.Tensor, *, bit: int = 0, index: int = 0
              ) -> torch.Tensor:
    """:func:`flip_bit` in place on a contiguous tensor of any device: the
    same word and bit (a bf16 or 8-byte element through its integer
    view)."""
    if t.numel() == 0:
        return t
    if not t.is_contiguous():
        raise ValueError("flip_bit_ takes a contiguous tensor")
    size = t.element_size()
    flat = t.view(-1)
    if t.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    flat = flat.view(_INT_OF_SIZE[size])
    index = int(index) % t.numel()
    index = index % flat.numel()
    width = 8 * min(size, 4)
    b = bit % width
    word = int(flat[index]) & ((1 << width) - 1)
    word ^= 1 << b
    if word >= 1 << (width - 1) and flat.dtype != torch.uint8:
        word -= 1 << width  # back to the signed view's value
    flat[index] = word
    return t


def as_u32(d: torch.Tensor) -> np.ndarray:
    """Digests (int32 tensors of u32 bits) as uint32 numpy on the host."""
    return d.detach().cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# the word view


def _words(x: torch.Tensor) -> tuple:
    """``(W, words an element)``: the word width K19 reads (1, 2 or 4
    bytes) and how many words an element holds (2 for 8-byte dtypes)."""
    size = x.element_size()
    if size not in (1, 2, 4, 8):
        raise TypeError(f"digest: unsupported element size {size}")
    return (4, 2) if size == 8 else (size, 1)


def _u64_words(x: torch.Tensor) -> torch.Tensor:
    """The plain versions' word view: the flat zero-extended u32 words of a
    tensor (any device), as int64."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    size = x.element_size()
    v = x.reshape(-1).view(_INT_OF_SIZE[size]).to(torch.int64)
    if size == 2:
        v = v & 0xFFFF
    elif size >= 4:
        v = v & _M32
    return v


def _plain_range(u: torch.Tensor) -> tuple:
    """``(s1, s2)`` of one range of int64 words in [0, 2^32), chunk by
    chunk: each term masked to 32 bits before a sum, and ``u * w`` from
    u's 16-bit halves (``u_lo * w + ((u_hi * w) mod 2^32) << 16``)."""
    s1 = s2 = 0
    for lo in range(0, u.numel(), _CHUNK):
        c = u[lo:lo + _CHUNK]
        w = (2 * torch.arange(lo, lo + c.numel(), device=c.device,
                              dtype=torch.int64) + 1) & _M32
        t = (((c & 0xFFFF) * w) + ((((c >> 16) * w) & _M32) << 16)) & _M32
        s1 = (s1 + int(c.sum())) & _M32
        s2 = (s2 + int(t.sum())) & _M32
    return s1, s2


def _i32(vals) -> torch.Tensor:
    """u32 values as the int32 bit pattern."""
    return torch.from_numpy(np.asarray(vals, np.uint32).view(np.int32))


def _device(x: torch.Tensor, name: str) -> bool:
    """True for CUDA (launch the kernel), False for the CPU (the plain
    version); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


# ---------------------------------------------------------------------------
# K19, ranges form: digest / part_digests


def _check_parts(x: torch.Tensor, blocks: int) -> None:
    if x.dim() == 0:
        raise ValueError("part_digests takes a tensor with a leading part "
                         "dimension")
    n = x[0].numel() if x.shape[0] else 0
    if blocks < 1 or n % blocks:
        raise ValueError(f"part_digests: {n} elements a part do not split "
                         f"into {blocks} blocks")


def part_digests_plain(x: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K19's ranges form: ``[P * blocks, 2]``
    int32 (u32 bits), the digest of each of the ``blocks`` equal blocks of
    each part ``x[p]``, the weight index restarting at 0 in each."""
    _check_parts(x, blocks)
    R = x.shape[0] * blocks
    if R == 0 or x.numel() == 0:
        return torch.zeros((R, 2), dtype=torch.int32, device=x.device)
    u = _u64_words(x).view(R, -1)
    return _i32([_plain_range(u[r]) for r in range(R)]).view(R, 2).to(
        x.device)


def part_digests(x: torch.Tensor, blocks: int = 1,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[P * blocks, 2]`` digests over the leading index of ``x`` (each
    part, or each of its ``blocks`` equal blocks: a halo's distance
    blocks), JAX ``shard_digests``. K19 on CUDA tensors (one launch,
    counted in ``part_digests.launches``; each part contiguous, parts any
    stride apart), :func:`part_digests_plain` on CPU tensors. ``out`` (a
    zeroed int32 ``[P * blocks, 2]`` slice) takes the result in place, so
    a caller digesting many tensors reads them back at once."""
    if not _device(x, "part_digests"):
        d = part_digests_plain(x, blocks)
        if out is None:
            return d
        out.copy_(d)
        return out
    _check_parts(x, blocks)
    P = x.shape[0]
    W, per = _words(x)
    n_part = x[0].numel() if P else 0
    if n_part and not x[0].is_contiguous():
        raise ValueError("part_digests: the kernel takes parts whose "
                         "elements are contiguous")
    if x.data_ptr() % W:
        raise ValueError("part_digests: the data is not word-aligned")
    if out is None:
        out = torch.zeros((P * blocks, 2), dtype=torch.int32,
                          device=x.device)
    if P * n_part == 0:
        return out
    es = x.element_size()
    lib = _build.load("digest", _SIGNATURES)
    rc = lib.pgt_digest_ranges(
        x.data_ptr(), x.stride(0) * es, n_part // blocks * es, P, blocks,
        n_part // blocks * per, W, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "digest_ranges")
    part_digests.launches += 1
    return out


part_digests.launches = 0


def digest_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`digest`."""
    return part_digests_plain(x.reshape(1, -1))[0]


def digest(x: torch.Tensor, out: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """``[2]`` digest of one tensor (JAX ``device_digest``): K19's ranges
    form with one range (counted in ``digest.launches``) on CUDA tensors,
    :func:`digest_plain` on CPU tensors. The tensor must be contiguous
    (any offset); ``out`` as in :func:`part_digests`."""
    if not _device(x, "digest"):
        d = digest_plain(x)
        if out is None:
            return d
        out.copy_(d)
        return out
    if not x.is_contiguous():
        raise ValueError("digest: the kernel takes a contiguous tensor")
    if out is None:
        out = torch.zeros(2, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    W, per = _words(x)
    if x.data_ptr() % W:
        raise ValueError("digest: the data is not word-aligned")
    lib = _build.load("digest", _SIGNATURES)
    rc = lib.pgt_digest_ranges(
        x.data_ptr(), 0, 0, 1, 1, x.numel() * per, W, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "digest_ranges")
    digest.launches += 1
    return out


digest.launches = 0


# ---------------------------------------------------------------------------
# K19, rows form: row_sums


def _check_rows(h, send_idx, send_mask, dirty):
    if h.dim() < 2:
        raise ValueError(f"h must be [P, rows, ...], got {tuple(h.shape)}")
    P = h.shape[0]
    if send_idx.dim() != 3 or send_idx.shape[:2] != (P, P - 1) \
            or send_mask.shape != send_idx.shape:
        raise ValueError(f"send_idx/send_mask must be [P, P-1, B] for P={P}, "
                         f"got {tuple(send_idx.shape)} / "
                         f"{tuple(send_mask.shape)}")
    if send_idx.dtype != torch.int32 or send_mask.dtype != torch.bool:
        raise TypeError("send_idx must be int32 and send_mask bool")
    if dirty is not None and (tuple(dirty.shape) != tuple(h.shape[:2]) or
                              dirty.dtype not in (torch.bool, torch.uint8)):
        raise ValueError(f"dirty must be bool or uint8 {tuple(h.shape[:2])}")
    if P > 1 and send_idx.shape[2] and h.shape[1] == 0:
        raise ValueError("h has no rows to gather from")
    devs = {t.device for t in (h, send_idx, send_mask, dirty)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: {devs}")


def row_sums_plain(h: torch.Tensor, send_idx: torch.Tensor,
                   send_mask: torch.Tensor,
                   dirty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K19's rows form: for each sender s and
    distance d, the clipped ``index_select`` of s's rows, their words
    summed where ``send_mask`` (and ``dirty`` of the row) is on;
    ``[P, P-1]`` int32 (u32 bits)."""
    _check_rows(h, send_idx, send_mask, dirty)
    P, n = h.shape[0], h.shape[1]
    sums = np.zeros((P, max(P - 1, 0)), np.uint32)
    for s in range(P):
        u = _u64_words(h[s]).view(n, -1) if n else None
        for d in range(1, P):
            if not send_idx.shape[2]:
                continue
            idx = send_idx[s, d - 1].long().clamp(0, n - 1)
            on = send_mask[s, d - 1]
            if dirty is not None:
                on = on & dirty[s].bool().index_select(0, idx)
            rows = u.index_select(0, idx)[on]
            sums[s, d - 1] = int(rows.sum()) & _M32 if rows.numel() else 0
    return _i32(sums).view(P, max(P - 1, 0)).to(h.device)


def row_sums(h: torch.Tensor, send_idx: torch.Tensor,
             send_mask: torch.Tensor,
             dirty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[P, P-1]`` s1 of each (sender, distance) block of send rows of
    ``h [P, rows, ...]`` (each part's rows contiguous): K19's rows form on
    CUDA tensors (one launch, counted in ``row_sums.launches``),
    :func:`row_sums_plain` on CPU tensors."""
    if not _device(h, "row_sums"):
        return row_sums_plain(h, send_idx, send_mask, dirty)
    _check_rows(h, send_idx, send_mask, dirty)
    P, n = h.shape[0], h.shape[1]
    B = send_idx.shape[2]
    out = torch.zeros((P, max(P - 1, 0)), dtype=torch.int32,
                      device=h.device)
    if P < 2 or B == 0 or h[0, 0].numel() == 0:
        return out
    if not h[0].is_contiguous() or not all(
            t.is_contiguous() for t in (send_idx, send_mask, dirty)
            if t is not None):
        raise ValueError("row_sums: the kernel takes contiguous rows, send "
                         "lists and bits")
    W, per = _words(h)
    if h.data_ptr() % W:
        raise ValueError("row_sums: the data is not word-aligned")
    es = h.element_size()
    row_bytes = h[0, 0].numel() * es
    if n >= 2 ** 31 or row_bytes >= 2 ** 31:
        raise ValueError("row_sums: h too large for the kernel")
    lib = _build.load("digest", _SIGNATURES)
    rc = lib.pgt_digest_rows(
        h.data_ptr(), h.stride(0) * es, P, n, row_bytes, W, B,
        send_idx.data_ptr(), send_mask.data_ptr(),
        None if dirty is None else dirty.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(rc, "digest_rows")
    row_sums.launches += 1
    return out


row_sums.launches = 0
