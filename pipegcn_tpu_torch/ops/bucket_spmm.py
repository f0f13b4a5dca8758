"""Degree-bucketed ELL mean aggregation with a narrowed gather transport —
port of ``pipegcn_tpu/ops/bucket_spmm.py``.

Host half (numpy, copied from the JAX module): the ~x1.5 width ladder
(``_ladder_rungs``, ``_bucket_widths``, ``ladder_prefix``), the per-part
tables (``build_tables_for_edges``, ``BucketPlan``), their stacked form
(``build_sharded_bucket_tables``: keys ``bkt_fwd_NN`` ``[P, cap_b, w_b]``,
``bkt_fwd_inv`` ``[P, n_max]``, ``bkt_bwd_NN``, ``bkt_bwd_inv``
``[P, n_max + H]``) and ``validate_bucket_tables``. The tables are array
for array the JAX build's (``tests/test_torch_bucket.py``). The JAX
module's slab-run plans and ``plan_cache`` streaming arguments are TPU
row-gather and streaming (ROADMAP A9) mechanisms and are not carried.

Device half:
  - the transport (``transport_dtypes``, ``transport_cast``,
    ``amax_transport_cast`` in JAX): activations travel as e4m3fn,
    cotangents as e5m2 (saturating at +-448 / +-57344), or bf16 both
    ways; kernel K10 casts (``csrc/transport_cast.cu``), K11 takes the
    per-part amax behind ``rem_amax``, whose power-of-two scale the port
    forms exactly (see ``pow2_scale``);
  - kernel K9 (``csrc/bucket_spmm.cu``, :func:`bucket_gather`): every
    bucket of every part in one launch, the inv_perm gather, the division
    by in_deg and the inverse scale fused;
  - :class:`BucketSpmm`, the autograd function of ``make_bucket_spmm_fn``
    / ``make_device_bucket_spmm_fn`` in the JAX order: forward = cast
    fbuf (all R rows), K9 over the forward tables, / in_deg, * inv_scale;
    backward = ``g / in_deg`` (a division, before the cast), cast to e5m2
    (or fbuf's dtype without a transport), K9 over the transpose tables,
    * inv_scale, in fbuf's dtype.

CUDA tensors launch the kernels (each wrapper counts its launches in
``<wrapper>.launches``), CPU tensors run the plain versions, anything
else raises. ``*_plain`` are the plain versions on any device.
:class:`TransportShare` lets a run record its transported values or take
another run's (counting where its own cast differs): the card's step
check and the CPU tests hold two runs against each other on one set of
transported values, as ``ops.gat.LeakyBranch`` does for GAT's branches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from . import _build

# ---------------------------------------------------------------------------
# host half: the tables (numpy)


def _ladder_rungs():
    """The bucket-width progression: ~x1.5 steps [1, 2, 3, 4, 6, 9, 13,
    ...] (padding at most 1.5x the real entries)."""
    w = 1
    while True:
        yield w
        w = max(w + 1, (w * 3) // 2)


def _bucket_widths(max_deg: int, min_width: int = 0) -> List[int]:
    """Ladder rungs up to (and including) the first >= max_deg; rungs
    narrower than ``min_width`` are dropped, merging their rows into the
    first surviving rung (``--bucket-merge``)."""
    widths = []
    for w in _ladder_rungs():
        if w < min_width:
            continue
        widths.append(w)
        if w >= max_deg:
            return widths


def ladder_prefix(n: int) -> List[int]:
    """The first n rungs."""
    return list(itertools.islice(_ladder_rungs(), n))


def build_tables_for_edges(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_out: int,
    n_src_rows: int,
    widths: Sequence[int],
) -> Tuple[List[np.ndarray], np.ndarray, List[int]]:
    """Bucket tables for one part's edge list (any order; pad edges have
    dst == n_out and are dropped): ``(idx_mats, inv_perm, counts)`` with
    ``idx_mats[b]`` ``[n_b, widths[b]]`` int32 into the source rows (pad
    = n_src_rows, the zero sentinel; a row's sources in the edge list's
    order, by a stable sort on dst), ``inv_perm`` ``[n_out]`` int32 into
    the concatenated bucket output (zero-degree rows point at its final
    zero row) and ``counts[b]`` real rows in bucket b."""
    real = edge_dst < n_out
    src = edge_src[real].astype(np.int64)
    dst = edge_dst[real].astype(np.int64)
    order = native.stable_argsort(dst)
    src, dst = src[order], dst[order]
    row_ptr = np.searchsorted(dst, np.arange(n_out + 1))
    deg = (row_ptr[1:] - row_ptr[:-1]).astype(np.int64)

    widths_arr = np.asarray(widths, dtype=np.int64)
    # bucket id = first width >= deg (deg 0 handled separately)
    bid = np.searchsorted(widths_arr, np.maximum(deg, 1))
    bid = np.minimum(bid, len(widths) - 1)

    idx_mats: List[np.ndarray] = []
    counts: List[int] = []
    inv_perm = np.full(n_out, -1, dtype=np.int64)
    offset = 0
    for b, w in enumerate(widths):
        rows = np.nonzero((bid == b) & (deg > 0))[0]
        n_b = rows.shape[0]
        mat = np.full((n_b, w), n_src_rows, dtype=np.int32)
        if n_b:
            starts = row_ptr[rows]
            lens = deg[rows]
            j = np.arange(w)[None, :]
            mask = j < lens[:, None]
            flat_src_pos = (starts[:, None] + j)[mask]
            r_i, c_i = np.nonzero(mask)
            mat[r_i, c_i] = src[flat_src_pos].astype(np.int32)
            inv_perm[rows] = offset + np.arange(n_b)
        idx_mats.append(mat)
        counts.append(n_b)
        offset += n_b
    inv_perm[inv_perm < 0] = offset
    return idx_mats, inv_perm.astype(np.int32), counts


class BucketPlan:
    """One part's forward (src -> dst over the R = n_max + H source rows)
    and transpose (dst -> src) bucket tables, numpy."""

    def __init__(self, edge_src: np.ndarray, edge_dst: np.ndarray,
                 n_out: int, n_src_rows: int,
                 fwd_widths: Optional[Sequence[int]] = None,
                 bwd_widths: Optional[Sequence[int]] = None):
        real = edge_dst < n_out
        deg_in = np.bincount(edge_dst[real], minlength=n_out)
        deg_out = np.bincount(edge_src[real], minlength=n_src_rows)
        self.fwd_widths = list(
            fwd_widths if fwd_widths is not None
            else _bucket_widths(int(deg_in.max(initial=1))))
        self.bwd_widths = list(
            bwd_widths if bwd_widths is not None
            else _bucket_widths(int(deg_out.max(initial=1))))
        self.n_out = n_out
        self.n_src_rows = n_src_rows
        self.fwd_mats, self.fwd_inv, self.fwd_counts = \
            build_tables_for_edges(edge_src, edge_dst, n_out, n_src_rows,
                                   self.fwd_widths)
        self.bwd_mats, self.bwd_inv, self.bwd_counts = \
            build_tables_for_edges(edge_dst[real], edge_src[real],
                                   n_src_rows, n_out, self.bwd_widths)


def build_sharded_bucket_tables(sg, min_width: int = 0
                                ) -> Dict[str, np.ndarray]:
    """The stacked tables of a ``ShardedGraph`` (leading part axis),
    padded to shared bucket widths and per-bucket row caps:
    ``{'bkt_fwd_<b>': [P, cap_b, w_b], 'bkt_fwd_inv': [P, n_max],
    'bkt_bwd_<b>': ..., 'bkt_bwd_inv': [P, n_max + H]}``. ``min_width`` is
    ``--bucket-merge``. Validated before it returns."""
    P = sg.num_parts
    n_src_rows = sg.n_max + sg.halo_size
    max_in, max_out = 1, 1
    for r in range(P):
        real = sg.edge_dst[r] < sg.n_max
        if real.any():
            di = np.bincount(sg.edge_dst[r][real], minlength=sg.n_max)
            do = np.bincount(sg.edge_src[r][real], minlength=n_src_rows)
            max_in = max(max_in, int(di.max(initial=1)))
            max_out = max(max_out, int(do.max(initial=1)))
    fw = _bucket_widths(max_in, min_width)
    bw = _bucket_widths(max_out, min_width)
    plans = [BucketPlan(sg.edge_src[r], sg.edge_dst[r], sg.n_max,
                        n_src_rows, fwd_widths=fw, bwd_widths=bw)
             for r in range(P)]
    fwd_caps = [max(p.fwd_counts[b] for p in plans) for b in range(len(fw))]
    bwd_caps = [max(p.bwd_counts[b] for p in plans) for b in range(len(bw))]

    def pad_to_cap(mat: np.ndarray, cap: int, sentinel: int) -> np.ndarray:
        # all-sentinel rows up to the shared cap; no inv entry points there
        if mat.shape[0] == cap:
            return mat
        return np.pad(mat, ((0, cap - mat.shape[0]), (0, 0)),
                      constant_values=sentinel)

    def reoffset_inv(inv: np.ndarray, counts: Sequence[int],
                     caps: Sequence[int]) -> np.ndarray:
        # per-part bucket offsets (cumsum of counts) -> the shared cap
        # layout; anything else -> the zero row after the last bucket
        inv = inv.astype(np.int64)
        out = np.full_like(inv, sum(caps))
        off_old = off_new = 0
        for n_b, cap in zip(counts, caps):
            in_b = (inv >= off_old) & (inv < off_old + n_b)
            out[in_b] = inv[in_b] - off_old + off_new
            off_old += n_b
            off_new += cap
        return out.astype(np.int32)

    tables: Dict[str, np.ndarray] = {
        "bkt_fwd_inv": np.stack([
            reoffset_inv(p.fwd_inv, p.fwd_counts, fwd_caps) for p in plans]),
        "bkt_bwd_inv": np.stack([
            reoffset_inv(p.bwd_inv, p.bwd_counts, bwd_caps) for p in plans]),
    }
    # zero-padded bucket numbers keep lexicographic key order = width order
    for b in range(len(fw)):
        if fwd_caps[b]:
            tables[f"bkt_fwd_{b:02d}"] = np.stack(
                [pad_to_cap(p.fwd_mats[b], fwd_caps[b], n_src_rows)
                 for p in plans])
    for b in range(len(bw)):
        if bwd_caps[b]:
            tables[f"bkt_bwd_{b:02d}"] = np.stack(
                [pad_to_cap(p.bwd_mats[b], bwd_caps[b], sg.n_max)
                 for p in plans])
    validate_bucket_tables(tables, sg.n_max, n_src_rows)
    return tables


def _table_keys(tables, stem: str) -> List[str]:
    return sorted(k for k in tables
                  if k.startswith(f"{stem}_") and not k.endswith("inv"))


def validate_bucket_tables(tables: Dict[str, np.ndarray], n_max: int,
                           n_src_rows: int) -> None:
    """Bounds check of stacked bucket tables: every index in [0, bound],
    bound being the consuming gather's zero-sentinel row (a table) or the
    zero row after the last bucket (an inv). Raises ``ValueError`` naming
    the table otherwise: the kernels clip indices on the strength of this
    check, so a corrupt table fails here, not as a wrong row."""
    fwd_rows = sum(int(tables[k].shape[-2])
                   for k in _table_keys(tables, "bkt_fwd"))
    bwd_rows = sum(int(tables[k].shape[-2])
                   for k in _table_keys(tables, "bkt_bwd"))
    for k, t in tables.items():
        if k == "bkt_fwd_inv":
            hi = fwd_rows
        elif k == "bkt_bwd_inv":
            hi = bwd_rows
        elif k.startswith("bkt_fwd_"):
            hi = n_src_rows
        elif k.startswith("bkt_bwd_"):
            hi = n_max
        else:
            continue
        a = np.asarray(t)
        lo_v = int(a.min(initial=0))
        hi_v = int(a.max(initial=0))
        if lo_v < 0 or hi_v > hi:
            raise ValueError(
                f"bucket table {k!r} holds out-of-bounds indices "
                f"[{lo_v}, {hi_v}] (valid range [0, {hi}]): corrupt "
                f"table cache or a table-build bug — rebuild the "
                f"partition artifact's cached tables")


# ---------------------------------------------------------------------------
# device half: the staged tables


@dataclasses.dataclass
class BucketSide:
    """One direction's stacked tables on the device, flattened for K9:
    ``idx [P, sum_b cap_b * w_b]`` int32 (the ``[cap_b, w_b]`` tables
    row-major, bucket after bucket), ``inv [P, n_out]`` int32 and ``meta
    [3, nb + 1]`` int64 (row offsets, element offsets, widths). ``n_src``
    is the gathered input's row count, its index the zero sentinel.
    ``rows`` is the tables' row count (``meta``'s last row offset) as the
    host staged it, which K9 sizes its table-order lists by; None reads it
    from ``meta`` on each launch."""

    idx: torch.Tensor
    inv: torch.Tensor
    meta: torch.Tensor
    n_src: int
    widths: Tuple[int, ...]
    rows: Optional[int] = None

    @property
    def n_out(self) -> int:
        return int(self.inv.shape[1])

    @property
    def nb(self) -> int:
        return len(self.widths)


@dataclasses.dataclass
class BucketTables:
    """Forward (src -> dst, n_src = n_max + H) and transpose (dst -> src,
    n_src = n_max) tables of the P parts."""

    fwd: BucketSide
    bwd: BucketSide


def flatten_side(tables: Dict[str, np.ndarray], stem: str, n_src: int,
                 device: torch.device) -> BucketSide:
    """Stage one direction (``stem`` 'bkt_fwd' / 'bkt_bwd') of
    :func:`build_sharded_bucket_tables` on ``device``."""
    keys = _table_keys(tables, stem)
    inv = np.asarray(tables[f"{stem}_inv"])
    P = inv.shape[0]
    mats = [np.asarray(tables[k]) for k in keys]
    caps = tuple(int(m.shape[1]) for m in mats)
    widths = tuple(int(m.shape[2]) for m in mats)
    sizes = [c * w for c, w in zip(caps, widths)]
    idx = np.zeros((P, max(sum(sizes), 1)), np.int32)
    off = 0
    for m, n in zip(mats, sizes):
        idx[:, off:off + n] = m.reshape(P, n)
        off += n
    meta = np.zeros((3, len(mats) + 1), np.int64)
    meta[0, 1:] = np.cumsum(caps)
    meta[1, 1:] = np.cumsum(sizes)
    meta[2, :-1] = widths
    put = torch.from_numpy
    # copy=True: on the CPU a staged table never shares memory with the
    # host tables (a restage from them must not see a staged table's flip)
    return BucketSide(idx=put(idx).to(device),
                      inv=put(np.ascontiguousarray(inv, np.int32)).to(
                          device, copy=True),
                      meta=put(meta).to(device), n_src=n_src, widths=widths,
                      rows=int(meta[0, -1]))


def stage_bucket_tables(tables: Dict[str, np.ndarray], n_max: int,
                        n_src: int, device: torch.device) -> BucketTables:
    """Both directions of :func:`build_sharded_bucket_tables` on
    ``device`` (``n_src = n_max + H``)."""
    return BucketTables(fwd=flatten_side(tables, "bkt_fwd", n_src, device),
                        bwd=flatten_side(tables, "bkt_bwd", n_max, device))


# ---------------------------------------------------------------------------
# K9: the bucket gather-sum

# elements of the plain version's gathered [P, rows, F] message column
PLAIN_ELEMS = 1 << 24

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_K9_SIGNATURES = {
    "pgt_bucket_spmm": [_P, _I, _I, _I, _I, _P, _LL, _P, _I, _P, _I, _I, _P,
                        _P, _P, _P, _P],
}
_CAST_SIGNATURES = {
    "pgt_transport_cast": [_P, _I, _I, _I, _I, _P, _P, _I, _F, _P, _P, _I,
                           _P],
    "pgt_part_amax": [_P, _I, _I, _I, _I, _P, _P, _P],
}
F8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
            torch.float8_e5m2: 3}
_OUT_TYPES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1,
              torch.float8_e5m2: 2}


def _check_gather(x, side, in_deg, inv_scale):
    if x.dim() != 3:
        raise ValueError(f"x must be [P, n_src, F], got {tuple(x.shape)}")
    P = x.shape[0]
    if x.dtype not in _X_TYPES:
        raise TypeError(f"x must be f32, bf16, e4m3fn or e5m2, got "
                        f"{x.dtype}")
    if x.shape[1] != side.n_src or side.idx.shape[0] != P \
            or side.inv.shape[0] != P:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, tables for "
                         f"{side.idx.shape[0]} parts of {side.n_src} rows")
    if in_deg is not None and (in_deg.shape != (P, side.n_out)
                               or in_deg.dtype != torch.float32):
        raise ValueError(f"in_deg must be f32 [{P}, {side.n_out}]")
    if inv_scale is not None and (inv_scale.shape != (P,)
                                  or inv_scale.dtype != torch.float32):
        raise ValueError(f"inv_scale must be f32 [{P}]")
    devs = {t.device for t in (x, side.idx, side.inv, side.meta, in_deg,
                               inv_scale) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: {devs}")


def bucket_gather_plain(x: torch.Tensor, side: BucketSide,
                        in_deg: Optional[torch.Tensor] = None,
                        inv_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of K9, the JAX formulation chunked per
    bucket: ``x_pad[idx_b]`` summed over the table width in f32 per
    bucket, concatenated with a zero row, gathered by ``inv`` (clipped),
    ``/ in_deg``, ``* inv_scale``. ``[P, n_out, F]`` f32. Runs on any
    device. Each row is summed in table order, one column of the table
    at a time, as K9 sums it, so the two agree bit for bit (JAX's
    ``.sum(axis=1)`` order is XLA's): a launch gathers one table column
    for every row of a bucket (chunked at ``PLAIN_ELEMS``), so the
    launches number about the ladder's total width, not rows x width."""
    _check_gather(x, side, in_deg, inv_scale)
    P, R, F = x.shape
    meta = side.meta.cpu()
    total = int(meta[0, -1])
    dev = x.device
    # the parts side by side: part p's rows at p * (R + 1), each followed
    # by its zero sentinel row; widened to f32 once (exact for every
    # input type), so each column's gather reads f32 rows
    xf = x.float()
    x_pad = torch.cat([xf, xf.new_zeros((P, 1, F))], 1).reshape(-1, F)
    base = torch.arange(P, device=dev)[:, None] * (R + 1)
    res = torch.zeros((P, total + 1, F), dtype=torch.float32, device=dev)
    step = max(1, PLAIN_ELEMS // max(1, P * F))
    for b in range(side.nb):
        r0, e0, w = (int(meta[0, b]), int(meta[1, b]), int(meta[2, b]))
        cap = int(meta[0, b + 1]) - r0
        tab = (side.idx[:, e0:e0 + cap * w].long().clamp(0, R)
               + base).view(P, cap, w)
        for i in range(0, cap, step):
            n = min(step, cap - i)
            acc = res[:, r0 + i:r0 + i + n]
            for k in range(w):
                acc += x_pad.index_select(
                    0, tab[:, i:i + n, k].reshape(-1)).view(P, n, F)
    out = torch.gather(res, 1, side.inv.long().clamp(0, total)[..., None]
                       .expand(P, side.n_out, F))
    if in_deg is not None:
        out = out / in_deg[..., None]
    if inv_scale is not None:
        out = out * inv_scale[:, None, None]
    return out


def bucket_gather(x: torch.Tensor, side: BucketSide,
                  in_deg: Optional[torch.Tensor] = None,
                  inv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9 on CUDA tensors (counted in ``bucket_gather.launches``),
    :func:`bucket_gather_plain` on CPU tensors; anything else raises."""
    if x.device.type == "cpu":
        return bucket_gather_plain(x, side, in_deg, inv_scale)
    _check_gather(x, side, in_deg, inv_scale)
    if x.device.type != "cuda":
        raise ValueError(f"bucket_gather: unsupported device {x.device}")
    ts = (x, side.idx, side.inv, side.meta, in_deg, inv_scale)
    if not all(t.is_contiguous() for t in ts if t is not None):
        raise ValueError("bucket_gather: the kernel takes contiguous "
                         "tensors")
    P, R, F = x.shape
    if P * R * F >= 2 ** 62 or R >= 2 ** 31 - 1 or F >= 2 ** 31 \
            or side.idx.shape[1] >= 2 ** 62:
        raise ValueError("bucket_gather: x too large for the kernel")
    if side.nb > 128:
        raise ValueError(f"bucket_gather: {side.nb} buckets (the kernel "
                         "takes at most 128)")
    rows = side.rows if side.rows is not None else int(side.meta[0, -1])
    if rows + side.n_out >= 2 ** 31:
        raise ValueError("bucket_gather: tables too large for the kernel")
    out = torch.empty((P, side.n_out, F), dtype=torch.float32,
                      device=x.device)
    # the kernel's table-order lists: perm [P, rows], over [P, n_out],
    # n_over [P]
    scratch = torch.empty(P * (rows + side.n_out + 1), dtype=torch.int32,
                          device=x.device)
    lib = _build.load("bucket_spmm", _K9_SIGNATURES)
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = lib.pgt_bucket_spmm(
        x.data_ptr(), _X_TYPES[x.dtype], P, R, F, side.idx.data_ptr(),
        side.idx.shape[1], side.meta.data_ptr(), side.nb,
        side.inv.data_ptr(), side.n_out, rows, scratch.data_ptr(),
        ptr(in_deg), ptr(inv_scale), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "bucket_spmm")
    bucket_gather.launches += 1
    return out


# ---------------------------------------------------------------------------
# K10, K11: the transport


def transport_dtypes(rem_dtype: Optional[str]):
    """(forward, backward) transport dtypes of a ``rem_dtype``: float8 =
    e4m3fn activations (range +-448) and e5m2 cotangents (exponent bits
    for gradients), bfloat16 both ways, None = no cast."""
    if rem_dtype in (None, "", "none"):
        return None, None
    if rem_dtype == "float8":
        return torch.float8_e4m3fn, torch.float8_e5m2
    if rem_dtype == "bfloat16":
        return torch.bfloat16, torch.bfloat16
    raise ValueError(f"unknown transport dtype: {rem_dtype!r}")


def pow2_scale(amax: torch.Tensor, m: float) -> torch.Tensor:
    """The amax transport scale per part: ``2**k``, ``k = floor(log2((m /
    2) / amax))`` in f32 (JAX's expression), clamped to [-126, 127] and
    formed exactly from its exponent bits, where JAX's ``exp2`` can round
    off a power of two; 1 where amax is zero or not finite."""
    ok = torch.isfinite(amax) & (amax > 0)
    q = torch.full_like(amax, m / 2.0) / torch.where(ok, amax, 1.0)
    k = torch.floor(torch.log2(q)).clamp(-126.0, 127.0)
    s = ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(ok, s, torch.ones_like(s))


def _check_cast(x, deg):
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32/bf16 [P, rows, F], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if deg is not None and (deg.shape != x.shape[:2]
                            or deg.dtype != torch.float32
                            or deg.device != x.device):
        raise ValueError(f"deg must be f32 {tuple(x.shape[:2])} on "
                         f"{x.device}")


def part_amax_plain(x: torch.Tensor, deg: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Plain PyTorch version of K11: ``max |x (/ deg)|`` per part, f32
    ``[P]`` (0 for an empty part; NaN propagates)."""
    _check_cast(x, deg)
    xf = x.float()
    if deg is not None:
        xf = xf / deg[..., None]
    if xf[0].numel() == 0:
        return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    return xf.abs().amax(dim=(1, 2))


def part_amax(x: torch.Tensor, deg: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """K11 on CUDA tensors (counted in ``part_amax.launches``), the plain
    version on CPU tensors; anything else raises."""
    if x.device.type == "cpu":
        return part_amax_plain(x, deg)
    _check_cast(x, deg)
    if x.device.type != "cuda":
        raise ValueError(f"part_amax: unsupported device {x.device}")
    if not x.is_contiguous() or (deg is not None
                                 and not deg.is_contiguous()):
        raise ValueError("part_amax: the kernel takes contiguous tensors")
    P, rows, F = x.shape
    if rows >= 2 ** 31 or F >= 2 ** 31:
        raise ValueError("part_amax: x too large for the kernel")
    bits = torch.empty(P, dtype=torch.int32, device=x.device)  # zeroed there
    lib = _build.load("transport_cast", _CAST_SIGNATURES)
    rc = lib.pgt_part_amax(
        x.data_ptr(), int(x.dtype == torch.bfloat16), P, rows, F,
        None if deg is None else deg.data_ptr(), bits.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "part_amax")
    part_amax.launches += 1
    return bits.view(torch.float32)


def quantize(x, dt, deg=None, scale=None):
    """The plain cast of ``x [n, rows, F]`` (/ deg) (* scale ``[n]``) to
    dt: fp8 clamps to its finite max first (JAX's clip-then-cast), bf16
    rounds. The gather transport casts one block a part, the halo wire
    (``parallel/halo.py``) one a (part, ring distance)."""
    xf = x.float()
    if deg is not None:
        xf = xf / deg[..., None]
    if scale is not None:
        xf = xf * scale[:, None, None]
    m = F8_MAX.get(dt)
    if m is not None:
        xf = torch.clamp(xf, -m, m)
    return xf.to(dt)


def transport_cast_plain(x: torch.Tensor, dt: torch.dtype,
                         deg: Optional[torch.Tensor] = None,
                         amax: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K10: ``(y, inv_scale)`` with ``y`` the
    saturating cast of ``x (/ deg)`` to ``dt`` and, given the per-part
    ``amax`` (fp8 only), scaled by :func:`pow2_scale` first, ``inv_scale
    [P]`` its inverse (else None)."""
    _check_cast(x, deg)
    if dt not in _OUT_TYPES:
        raise ValueError(f"unknown transport dtype {dt}")
    if amax is None or dt not in F8_MAX:
        return quantize(x, dt, deg, None), None
    s = pow2_scale(amax, F8_MAX[dt])
    return quantize(x, dt, deg, s), 1.0 / s


def k10_vec(x: torch.Tensor, y: torch.Tensor,
            deg: Optional[torch.Tensor] = None) -> int:
    """K10's vector: the most elements (at most 16 bytes of ``x``) that the
    ``x`` and ``y`` pointers are aligned to and that divide F where ``deg``
    is given (a vector never straddles a row: one deg a vector), a part's
    ``rows * F`` elements otherwise (every part starts on a vector)."""
    P, rows, F = x.shape
    run = F if deg is not None else rows * F
    vec = 16 // x.element_size()
    while vec > 1 and (run % vec or any(
            t.data_ptr() % (vec * t.element_size()) for t in (x, y))):
        vec //= 2
    return vec


def transport_cast(x: torch.Tensor, dt: torch.dtype,
                   deg: Optional[torch.Tensor] = None,
                   amax: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K10 on CUDA tensors (counted in ``transport_cast.launches``), the
    plain version on CPU tensors; anything else raises. The scale is
    formed on the device from ``amax`` (K11's output): no host round
    trip."""
    if x.device.type == "cpu":
        return transport_cast_plain(x, dt, deg, amax)
    _check_cast(x, deg)
    if x.device.type != "cuda":
        raise ValueError(f"transport_cast: unsupported device {x.device}")
    if dt not in _OUT_TYPES:
        raise ValueError(f"unknown transport dtype {dt}")
    if not x.is_contiguous() or (deg is not None
                                 and not deg.is_contiguous()):
        raise ValueError("transport_cast: the kernel takes contiguous "
                         "tensors")
    P, rows, F = x.shape
    if rows >= 2 ** 31 or F >= 2 ** 31:
        raise ValueError("transport_cast: x too large for the kernel")
    use_amax = amax is not None and dt in F8_MAX
    if use_amax and (amax.shape != (P,) or amax.dtype != torch.float32
                     or amax.device != x.device):
        raise ValueError(f"amax must be f32 [{P}] on {x.device}")
    y = torch.empty(x.shape, dtype=dt, device=x.device)
    inv = torch.empty(P, dtype=torch.float32, device=x.device) \
        if use_amax else None
    lib = _build.load("transport_cast", _CAST_SIGNATURES)
    rc = lib.pgt_transport_cast(
        x.data_ptr(), int(x.dtype == torch.bfloat16), P, rows, F,
        None if deg is None else deg.data_ptr(),
        amax.data_ptr() if use_amax else None, _OUT_TYPES[dt],
        F8_MAX.get(dt, 0.0), y.data_ptr(),
        None if inv is None else inv.data_ptr(), k10_vec(x, y, deg),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "transport_cast")
    transport_cast.launches += 1
    return y, inv


bucket_gather.launches = 0
transport_cast.launches = 0
part_amax.launches = 0


# ---------------------------------------------------------------------------
# the differentiable aggregation


@dataclasses.dataclass
class TransportShare:
    """Transported values shared between two runs: those of the gather
    transport and of the halo wire (``parallel/halo.py``), in call order.
    Without a ``source`` it records each cast's ``(y, inv_scale)`` in
    ``recorded``. With one, every cast takes ``source(x, dt, deg) -> (y,
    inv_scale)`` (another run's values) instead of its own, and counts in
    ``flips`` the elements where its own cast of x, at that run's scale,
    would differ (NaN equal to NaN), out of ``elements``."""

    source: Optional[Callable] = None
    recorded: List[tuple] = dataclasses.field(default_factory=list)
    flips: int = 0
    elements: int = 0

    @staticmethod
    def replaying(recorded: Sequence[tuple]) -> "TransportShare":
        """A share that takes ``recorded``'s values in order."""
        it = iter(recorded)
        return TransportShare(source=lambda x, dt, deg: next(it))

    def take(self, x: torch.Tensor, dt: torch.dtype,
             deg: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The source's ``(y, inv_scale)`` for the cast of ``x [n, rows,
        F]`` (/ deg), with the flips of this run's own cast counted."""
        y, inv = self.source(x, dt, deg)
        own = quantize(x, dt, deg, None if inv is None else 1.0 / inv)
        self.flips += _count_differing(own, y)
        self.elements += own.numel()
        return y, inv


def _count_differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of two same-typed tensors whose values differ, a NaN
    equal to any NaN."""
    af, bf = a.float(), b.float()
    same = (af == bf) | (torch.isnan(af) & torch.isnan(bf))
    return int((~same).sum())


def _transport(x, dt, amax, deg, plain, share):
    """The transport cast of one aggregation input: ``(y, inv_scale)``."""
    if dt is None:
        return x, None
    if share is not None and share.source is not None:
        return share.take(x, dt, deg)
    cast = transport_cast_plain if plain else transport_cast
    a = None
    if amax and dt in F8_MAX:
        a = (part_amax_plain if plain else part_amax)(x, deg)
    y, inv = cast(x, dt, deg, a)
    if share is not None:
        share.recorded.append((y, inv))
    return y, inv


class BucketSpmm(torch.autograd.Function):
    """``out = bucket_mean(cast(fbuf)) * inv_scale`` (f32 ``[P, n_max,
    F]``) over ``tables.fwd``, with the transpose aggregation over
    ``tables.bwd`` as its backward (``make_bucket_spmm_fn``). ``plain``
    picks the plain versions on any device; otherwise CUDA tensors run
    K9-K11 and CPU tensors the plain versions."""

    @staticmethod
    def forward(ctx, fbuf, tables, in_deg, rem_dtype, rem_amax, plain,
                share):
        fwd_dt, bwd_dt = transport_dtypes(rem_dtype)
        y, inv = _transport(fbuf, fwd_dt, rem_amax, None, plain, share)
        gather = bucket_gather_plain if plain else bucket_gather
        out = gather(y, tables.fwd, in_deg, inv)
        ctx.tables, ctx.bwd_dt, ctx.amax = tables, bwd_dt, rem_amax
        ctx.plain, ctx.share, ctx.fbuf_dtype = plain, share, fbuf.dtype
        ctx.save_for_backward(in_deg)
        return out

    @staticmethod
    def backward(ctx, g):
        (in_deg,) = ctx.saved_tensors
        gf = g.float().contiguous()
        if ctx.bwd_dt is not None:
            gd, inv = _transport(gf, ctx.bwd_dt, ctx.amax, in_deg,
                                 ctx.plain, ctx.share)
        else:
            gd, inv = (gf / in_deg[..., None]).to(ctx.fbuf_dtype), None
        gather = bucket_gather_plain if ctx.plain else bucket_gather
        d_fbuf = gather(gd, ctx.tables.bwd, None, inv)
        return d_fbuf.to(ctx.fbuf_dtype), None, None, None, None, None, None


def bucket_spmm(fbuf: torch.Tensor, tables: BucketTables,
                in_deg: torch.Tensor, rem_dtype: Optional[str] = None,
                rem_amax: bool = False, plain: bool = False,
                share: Optional[TransportShare] = None) -> torch.Tensor:
    """Mean aggregation of the stacked ``fbuf [P, n_max + H, F]`` through
    the bucket tables, ``[P, n_max, F]`` f32, differentiable in fbuf.
    ``rem_dtype`` narrows the gather transport (None | 'bfloat16' |
    'float8'), ``rem_amax`` scales fp8 casts by the per-part amax."""
    return BucketSpmm.apply(fbuf, tables, in_deg, rem_dtype, rem_amax,
                            plain, share)
