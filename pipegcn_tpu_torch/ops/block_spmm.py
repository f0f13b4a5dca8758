"""Hybrid block-dense mean aggregation — port of
``pipegcn_tpu/ops/block_spmm.py``, with per-tile pair lists (``group =
1``) or the union-gather layout (``--block-group > 1``).

Dense (destination-tile, source-tile) blocks of a part's adjacency, the
ones holding at least ``nnz_threshold`` edges (by default the read-cost
break-even ``T*S // n_feat``), are multiplied as dense ``[T, S]`` matrices
of edge multiplicities; the remaining edges go through the bucket tables
of ``ops/bucket_spmm.py`` (K9, with its gather transport). The sum of the
two is divided by ``in_deg`` once.

Host half (numpy): ``DENSE_A_BYTE_BUDGET``, ``budget_block_cap``,
``_max_group_count``, ``_group_by_key``, ``_group_union``,
``_part_block_stats``, ``estimate_block_coverage``, ``BlockPlan`` and
``build_sharded_block_tables`` (the A-encoding fixpoint, the byte-budget
cap, the unified ladders and the reoffset ``inv``\\ s). The stacked tables
are array for array the JAX build's (``tests/test_torch_block.py``), with
these differences of representation:
  - a bf16 ``blk_a`` is held as its raw ``uint16`` bits (the port does
    not depend on ``ml_dtypes``);
  - ``BlockPlan`` never materializes ``a_blocks`` as f32 ``[B, T, S]``
    (256 KB a block): it keeps the block-sorted edges and writes the
    stored encoding directly (``a_stored``), the same bytes as JAX's
    ``pack_a_blocks(a_blocks)`` (1 bit an entry, little-endian within
    each byte: the layout K12/K13 unpack) / ``a_blocks.astype(dtype)``;
  - the build sorts each part's edges once and rebuilds only the
    tables (never the selection) for the unified ladders;
  - ``np.unique`` over large arrays is an explicit sort.
Not ported: the remainder's slab-run plans (a TPU row-gather mechanism).

Device half:
  - :func:`stage_block_tables` flattens each direction's width classes
    into per-output-tile pair lists (K9's ``flatten_side`` for the dense
    path): forward keyed by destination tile, backward by source tile,
    each tile's ``(A block, input tile)`` pairs in the JAX class order,
    the pad pairs (block ``B_max``, the zero tile) dropped;
  - with ``group > 1`` it flattens each direction's U-width classes into
    per-group lists instead: each group of ``group`` consecutive output
    tiles walks its union of input tiles, each union slot naming the A
    block of every tile of the group that multiplies it (``b_max`` where
    none does), pad slots and cap-padding rows dropped;
  - kernels K12 (:func:`block_dense`, the forward tile products) and K13
    (:func:`block_dense_t`, the transpose over the same A blocks), and
    over the union groups K16 (:func:`block_dense_grouped`) and K17
    (:func:`block_dense_grouped_t`), in ``csrc/block_tma.cu`` (TMA stages
    and ``wgmma`` after a pre-pass, :func:`tile_split`, that splits f32
    rows into their three bf16 terms once; K12 and K13 over a pair list's
    :func:`union_view`, K13 and K17 with A^T's fragments; f32 A keeps the
    scalar path of ``csrc/block_spmm.cu``; the entry each side takes is
    :func:`tile_entry`'s), over f32
    input rows or, at bf16 compute, bf16 rows (JAX multiplies in the input's dtype with f32 products:
    ``_dense_apply``'s ``compute_dtype``); :func:`block_dense_plain` is
    their plain version (unpack, ``bmm`` per chunk of pairs in f32 over
    the exactly widened rows, ``index_add_``), and of K16 / K17 over the
    groups' (tile, slot) entries with a block (JAX's ``_dense_apply_grouped``
    multiplies the zero block at the others: the sum is the same);
  - :class:`BlockSpmm`, the autograd function of ``make_block_spmm_fn``
    in the JAX order: forward ``(dense(fbuf) + K9(cast(fbuf)) *
    inv_scale) / in_deg`` (the dense path never takes the transport);
    backward ``dense^T(g / in_deg)`` (``g / in_deg`` rounded to fbuf's
    dtype first, JAX ``:686-687``) plus K9 over the transpose tables of
    ``cast(g / in_deg)`` (the division fused into K10) times inv_scale.

CUDA tensors launch the kernels (each wrapper counts its launches in
``<wrapper>.launches``), CPU tensors run the plain versions, anything
else raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from . import _build
from .bucket_spmm import (BucketSide, _bucket_widths, _transport,
                          bucket_gather, bucket_gather_plain,
                          build_tables_for_edges, flatten_side,
                          transport_dtypes)

# ---------------------------------------------------------------------------
# host half: the plans and the stacked tables (numpy)

# device-memory budget of one part's dense-A tensor (the JAX default)
DENSE_A_BYTE_BUDGET = 2 << 30


def budget_block_cap(byte_budget: int, tile: int, bits: int = 1) -> int:
    """Most dense A blocks that fit ``byte_budget`` at ``bits`` an entry."""
    return max(1, (int(byte_budget) * 8) // (tile * tile * bits))


def _pad_rows(mat: np.ndarray, rows: int, fill) -> np.ndarray:
    if mat.shape[0] == rows:
        return mat
    return np.pad(mat, ((0, rows - mat.shape[0]),) +
                  ((0, 0),) * (mat.ndim - 1), constant_values=fill)


def _max_group_count(keys: np.ndarray, n_groups: int) -> int:
    return max(int(np.bincount(keys, minlength=n_groups).max(initial=0)),
               1)


def _group_by_key(keys, vals_a, vals_b, n_groups, widths, pad_a, pad_b):
    """The (vals_a[i], vals_b[i]) pairs of each key in power-of-2-ish width
    classes by the key's pair count (the JAX function): ``(mats, inv,
    counts)`` with ``mats[w] = (a_mat, b_mat)`` ``[n_w, widths[w]]`` int32
    padded with pad_a / pad_b, ``inv [n_groups]`` int32 the row of each key
    in the class concatenation (keys with no pairs -> ``sum(counts)``) and
    ``counts[w]`` the real rows of class w."""
    order = np.argsort(keys, kind="stable")
    va, vb = vals_a[order], vals_b[order]
    cnt = np.bincount(keys, minlength=n_groups)
    max_cnt = int(cnt.max(initial=0))
    if max_cnt > widths[-1]:
        raise ValueError(
            f"width ladder {tuple(widths)} tops out below the max "
            f"per-key pair count {max_cnt}; pairs would be dropped")
    ptr = np.zeros(n_groups + 1, np.int64)
    np.cumsum(cnt, out=ptr[1:])
    widths_arr = np.asarray(widths, dtype=np.int64)
    wid = np.minimum(np.searchsorted(widths_arr, np.maximum(cnt, 1)),
                     len(widths) - 1)
    mats, counts = [], []
    inv = np.full(n_groups, -1, np.int64)
    offset = 0
    for w_i, w in enumerate(widths):
        rows = np.nonzero((wid == w_i) & (cnt > 0))[0]
        n_w = rows.shape[0]
        a_mat = np.full((n_w, w), pad_a, np.int32)
        b_mat = np.full((n_w, w), pad_b, np.int32)
        if n_w:
            j = np.arange(w)[None, :]
            mask = j < cnt[rows][:, None]
            pos = (ptr[rows][:, None] + j)[mask]
            r, c = np.nonzero(mask)
            a_mat[r, c] = va[pos]
            b_mat[r, c] = vb[pos]
            inv[rows] = offset + np.arange(n_w)
        mats.append((a_mat, b_mat))
        counts.append(n_w)
        offset += n_w
    inv[inv < 0] = offset
    return mats, inv.astype(np.int32), counts


def _group_union(keys: np.ndarray, others: np.ndarray, n_key_tiles: int,
                 n_other_tiles: int, group: int, n_blocks_pad: int,
                 widths: Optional[Sequence[int]] = None):
    """Union-gather grouping (the JAX function): ``group`` consecutive key
    tiles share one union of their blocks' other tiles. ``keys`` /
    ``others`` ``[B]``: each dense block's key tile and other tile (dst /
    src forward, src / dst for the transpose). Returns ``(classes, inv,
    counts, widths)``: ``classes[w] = (a_idx [R_w, group, widths[w]],
    t_mat [R_w, widths[w]])`` int32, the A block of each (tile of the
    group, union slot) (pad ``n_blocks_pad``) and each slot's other tile
    (pad ``n_other_tiles``); ``inv [n_key_tiles]`` int32 the position ``r
    * group + d`` of each key tile in the class concatenation (tiles whose
    group has no block: ``sum(R_w) * group``); ``counts[w]`` the rows of
    class w. Groups go into x1.5-ladder U-width classes; a given ladder
    that tops out below the widest union is extended."""
    B = int(keys.shape[0])
    n_groups_max = -(-n_key_tiles // group)
    if B == 0:
        widths = list(widths) if widths is not None else [1]
        classes = [(np.full((0, group, w), n_blocks_pad, np.int32),
                    np.full((0, w), n_other_tiles, np.int32))
                   for w in widths]
        inv = np.zeros(n_key_tiles, np.int32)
        return classes, inv, [0] * len(widths), widths
    gid = keys // group
    order = np.lexsort((others, gid))
    g_o, o_o = gid[order], others[order]
    blk_o = np.arange(B, dtype=np.int64)[order]
    d_o = (keys[order] % group).astype(np.int64)
    ug, gcnt = _run_lengths(g_o)
    grow = np.repeat(np.arange(ug.shape[0]), gcnt)  # block -> group row
    # a block starts a new union slot iff its (group, other) differs from
    # the previous block's (blocks sorted by (group, other))
    new_flag = np.ones(B, bool)
    new_flag[1:] = (g_o[1:] != g_o[:-1]) | (o_o[1:] != o_o[:-1])
    slot = np.cumsum(new_flag) - 1
    gstart = np.zeros(ug.shape[0], np.int64)
    gstart[1:] = np.cumsum(gcnt)[:-1]
    first = slot[gstart]
    u_idx = slot - first[grow]
    u_of_group = np.add.reduceat(new_flag, gstart).astype(np.int64)

    if widths is None:
        widths = _bucket_widths(int(u_of_group.max(initial=1)))
    widths = list(widths)
    max_u = int(u_of_group.max(initial=0))
    if max_u > widths[-1]:
        widths += [w for w in _bucket_widths(max_u) if w > widths[-1]]
    widths_arr = np.asarray(widths, dtype=np.int64)
    wid = np.minimum(np.searchsorted(widths_arr, np.maximum(u_of_group, 1)),
                     len(widths) - 1)

    classes, counts = [], []
    concat_row = np.full(n_groups_max, -1, np.int64)
    offset = 0
    for w_i, w in enumerate(widths):
        gsel = np.nonzero(wid == w_i)[0]
        n_w = int(gsel.shape[0])
        a_idx = np.full((n_w, group, w), n_blocks_pad, np.int32)
        t_mat = np.full((n_w, w), n_other_tiles, np.int32)
        if n_w:
            cls_row = np.full(ug.shape[0], -1, np.int64)
            cls_row[gsel] = np.arange(n_w)
            bsel = cls_row[grow] >= 0
            r = cls_row[grow[bsel]]
            a_idx[r, d_o[bsel], u_idx[bsel]] = blk_o[bsel]
            nf = bsel & new_flag
            t_mat[cls_row[grow[nf]], u_idx[nf]] = o_o[nf]
            concat_row[ug[gsel]] = offset + cls_row[gsel]
        classes.append((a_idx, t_mat))
        counts.append(n_w)
        offset += n_w
    key_tiles = np.arange(n_key_tiles, dtype=np.int64)
    gr = concat_row[key_tiles // group]
    inv = np.where(gr >= 0, gr * group + key_tiles % group,
                   offset * group)
    return classes, inv.astype(np.int32), counts, widths


def _run_lengths(sorted_keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(unique values, counts)`` of a sorted 1-D array (``np.unique``
    with ``return_counts``, by the sort's runs)."""
    n = sorted_keys.shape[0]
    if n == 0:
        return sorted_keys[:0], np.zeros(0, np.int64)
    starts = np.flatnonzero(np.concatenate(
        ([True], sorted_keys[1:] != sorted_keys[:-1])))
    return sorted_keys[starts], np.diff(np.append(starts, n))


def _part_block_stats(sg, r: int, tile: int, n_src_tiles: int, thr: int,
                      max_blocks: Optional[int] = None):
    """``(coverage, dense_block_count, dense_edges, real_edges)`` of part
    r's edges at this tile and threshold, keeping only the ``max_blocks``
    densest blocks when given (BlockPlan's budget cutoff)."""
    e = int(sg.edge_count[r])
    src = sg.edge_src[r][:e].astype(np.int64)
    dst = sg.edge_dst[r][:e].astype(np.int64)
    real = dst < sg.n_max
    src, dst = src[real], dst[real]
    _, counts = _run_lengths(np.sort((dst // tile) * n_src_tiles
                                     + (src // tile)))
    sel = counts >= thr
    if max_blocks is not None and int(sel.sum()) > max_blocks:
        kept = np.sort(counts[sel])[-max_blocks:]
        dense, n_dense = int(kept.sum()), int(kept.shape[0])
    else:
        dense, n_dense = int(counts[sel].sum()), int(sel.sum())
    tot = int(src.shape[0])
    return dense / max(tot, 1), n_dense, dense, tot


def estimate_block_coverage(sg, tile: int, n_feat_hint: int,
                            nnz_threshold: Optional[int] = None,
                            byte_budget: Optional[int] = DENSE_A_BYTE_BUDGET,
                            ) -> float:
    """Fraction of the real edges in blocks dense enough for the tile
    products (>= ``nnz_threshold``, by default the break-even), under the
    byte budget's block cap for the encoding the graph allows (1 bit when
    it is simple and ``tile % 8 == 0``, else int8)."""
    thr = nnz_threshold if nnz_threshold is not None else max(
        1, (tile * tile) // max(n_feat_hint, 1))
    n_src_rows = sg.n_max + sg.halo_size
    n_src_tiles = -(-n_src_rows // tile)
    cap = None
    if byte_budget is not None:
        bits = 1 if tile % 8 == 0 else 8
        if bits == 1:
            for r in range(sg.num_parts):
                e = int(sg.edge_count[r])
                key = np.sort(sg.edge_dst[r][:e].astype(np.int64)
                              * n_src_rows
                              + sg.edge_src[r][:e].astype(np.int64))
                if bool((key[1:] == key[:-1]).any()):
                    bits = 8  # duplicate edges: no bit-packing
                    break
        cap = budget_block_cap(byte_budget, tile, bits)
    dense = tot = 0
    for r in range(sg.num_parts):
        _, _, d, t = _part_block_stats(sg, r, tile, n_src_tiles, thr,
                                       max_blocks=cap)
        dense += d
        tot += t
    return dense / max(tot, 1)


class PartEdges:
    """One part's real edges (``dst < n_out``) in block order: the stable
    sort by block id ``(dst // T) * n_src_tiles + src // T`` (the JAX
    ``BlockPlan``'s order), with each block's id and edge count, and
    ``mult``, each edge's multiplicity of its (dst, src) pair (None when
    the part has no duplicate edge). Built once a part; every selection
    and table build reads it."""

    def __init__(self, edge_src: np.ndarray, edge_dst: np.ndarray,
                 n_out: int, n_src_rows: int, tile: int):
        real = edge_dst < n_out
        src = edge_src[real].astype(np.int64)
        dst = edge_dst[real].astype(np.int64)
        self.tile, self.n_out, self.n_src_rows = tile, n_out, n_src_rows
        self.n_dst_tiles = -(-n_out // tile)
        self.n_src_tiles = -(-n_src_rows // tile)
        bid = (dst // tile) * self.n_src_tiles + (src // tile)
        order = native.stable_argsort(bid)
        self.src, self.dst = src[order], dst[order]
        self.uniq, self.counts = _run_lengths(bid[order])
        key = self.dst * n_src_rows + self.src
        self.mult: Optional[np.ndarray] = None
        sk = np.sort(key)
        if bool((sk[1:] == sk[:-1]).any()):  # a multigraph
            order = np.argsort(key, kind="stable")
            _, cnt = _run_lengths(key[order])
            self.mult = np.empty_like(key)
            self.mult[order] = np.repeat(cnt, cnt)


class BlockPlan:
    """One part's hybrid plan (the JAX ``BlockPlan``, numpy): the dense
    blocks (``B``, ``dense_ids``; A in its stored encoding from
    :meth:`a_stored`), at ``group`` 1 the per-tile pair lists in width
    classes (``fwd_groups`` / ``fwd_ginv`` / ``fwd_gcounts`` per
    destination tile, ``bwd_*`` per source tile), at ``group > 1`` the
    union-gather classes (``fwd_u_classes`` / ``fwd_u_inv`` /
    ``fwd_u_counts``, ``bwd_u_*``; :func:`_group_union`), the ladders
    ``fwd_k_widths`` / ``bwd_k_widths`` of either, and the remainder's
    bucket tables both ways (``rem_fwd_*``, ``rem_bwd_*``). ``edges`` is
    the part's :class:`PartEdges`; without explicit ladders each is the
    part's own, as in JAX."""

    def __init__(self, edges: PartEdges, n_feat: int,
                 nnz_threshold: Optional[int] = None,
                 fwd_widths: Optional[Sequence[int]] = None,
                 bwd_widths: Optional[Sequence[int]] = None,
                 fwd_k_widths: Optional[Sequence[int]] = None,
                 bwd_k_widths: Optional[Sequence[int]] = None,
                 max_blocks: Optional[int] = None, group: int = 1):
        e = edges
        T = self.tile = e.tile
        self.group = max(1, int(group))
        self.n_out, self.n_src_rows = e.n_out, e.n_src_rows
        self.n_dst_tiles, self.n_src_tiles = e.n_dst_tiles, e.n_src_tiles
        if nnz_threshold is None:
            # a dense block reads T*S A entries and an S*F tile; each
            # replaced edge saves an F-wide gather
            nnz_threshold = max(1, (T * T) // max(n_feat, 1))
        self.nnz_threshold = nnz_threshold
        counts = e.counts
        dense_sel = counts >= nnz_threshold
        if max_blocks is not None and int(dense_sel.sum()) > max_blocks:
            # the byte budget keeps the densest blocks; ties at the cutoff
            # drop the first ones in block order (the JAX rule)
            cutoff = np.sort(counts[dense_sel])[-max_blocks]
            dense_sel &= counts >= cutoff
            if int(dense_sel.sum()) > max_blocks:
                over = int(dense_sel.sum()) - max_blocks
                tie_idx = np.nonzero(dense_sel & (counts == cutoff))[0]
                dense_sel[tie_idx[:over]] = False
        self.dense_ids = e.uniq[dense_sel]
        B = self.B = int(self.dense_ids.shape[0])
        self._in_dense = np.repeat(dense_sel, counts)
        self._edges = e
        self._k_of_edge = np.repeat(np.arange(B, dtype=np.int64),
                                    counts[dense_sel])
        self.dense_edges = int(self._k_of_edge.shape[0])
        self.a_max = (0 if B == 0 else 1 if e.mult is None
                      else int(e.mult[self._in_dense].max()))
        bd = (self.dense_ids // e.n_src_tiles).astype(np.int64)
        bs = (self.dense_ids % e.n_src_tiles).astype(np.int64)
        blk_idx = np.arange(B, dtype=np.int64)
        if self.group > 1:
            # union-gather: `group` consecutive key tiles share one union
            # of other tiles (_group_union)
            (self.fwd_u_classes, self.fwd_u_inv, self.fwd_u_counts,
             self.fwd_k_widths) = _group_union(
                bd, bs, e.n_dst_tiles, e.n_src_tiles, self.group, B,
                widths=fwd_k_widths)
            (self.bwd_u_classes, self.bwd_u_inv, self.bwd_u_counts,
             self.bwd_k_widths) = _group_union(
                bs, bd, e.n_src_tiles, e.n_dst_tiles, self.group, B,
                widths=bwd_k_widths)
        else:
            self.fwd_k_widths = list(
                fwd_k_widths if fwd_k_widths is not None
                else _bucket_widths(_max_group_count(bd, e.n_dst_tiles)))
            self.bwd_k_widths = list(
                bwd_k_widths if bwd_k_widths is not None
                else _bucket_widths(_max_group_count(bs, e.n_src_tiles)))
            self.fwd_groups, self.fwd_ginv, self.fwd_gcounts = \
                _group_by_key(bd, blk_idx, bs, e.n_dst_tiles,
                              self.fwd_k_widths, pad_a=B,
                              pad_b=e.n_src_tiles)
            self.bwd_groups, self.bwd_ginv, self.bwd_gcounts = \
                _group_by_key(bs, blk_idx, bd, e.n_src_tiles,
                              self.bwd_k_widths, pad_a=B,
                              pad_b=e.n_dst_tiles)

        # the sparse remainder, in block order (the JAX order), through
        # the bucket tables both ways
        r_src = e.src[~self._in_dense]
        r_dst = e.dst[~self._in_dense]
        self.rem_count = int(r_src.shape[0])
        max_in = int(np.bincount(r_dst, minlength=e.n_out).max(initial=1))
        max_out = int(np.bincount(r_src, minlength=e.n_src_rows).max(
            initial=1))
        self.rem_fwd_widths = list(
            fwd_widths if fwd_widths is not None
            else _bucket_widths(max(max_in, 1)))
        self.rem_bwd_widths = list(
            bwd_widths if bwd_widths is not None
            else _bucket_widths(max(max_out, 1)))
        self.rem_fwd_mats, self.rem_fwd_inv, self.rem_fwd_counts = \
            build_tables_for_edges(r_src, r_dst, e.n_out, e.n_src_rows,
                                   self.rem_fwd_widths)
        self.rem_bwd_mats, self.rem_bwd_inv, self.rem_bwd_counts = \
            build_tables_for_edges(r_dst, r_src, e.n_src_rows, e.n_out,
                                   self.rem_bwd_widths)

    def a_stored(self, bits: int, rows: int) -> np.ndarray:
        """The A blocks padded with zero blocks to ``rows`` in the stored
        encoding of ``bits`` an entry: 1 -> uint8 ``[rows, T, T//8]``
        (JAX's ``pack_a_blocks`` of the f32 blocks), 8 -> int8, 16 -> the raw
        uint16 bits of bf16, 32 -> f32 ``[rows, T, T]``. Written from the
        block-sorted edges in chunks of blocks, never as f32 ``[B, T,
        T]``."""
        T, B, e = self.tile, self.B, self._edges
        k = self._k_of_edge
        dst_d = e.dst[self._in_dense] % T
        src_d = e.src[self._in_dense] % T
        if bits == 1:
            if self.a_max > 1 or T % 8:
                raise ValueError("bit-packing needs 0/1 A and tile % 8 == 0")
            per = T * T // 8
            out = np.zeros(rows * per, np.uint8)
            # a byte's bits come from distinct edges (multiplicity 1):
            # their sum is their OR
            flat = k * per + dst_d * (T // 8) + src_d // 8
            val = (1 << (src_d % 8)).astype(np.float64)
        else:
            per = T * T
            dt = {8: np.int8, 16: np.float32, 32: np.float32}[bits]
            out = np.zeros(rows * per, dt)
            flat = k * per + dst_d * T + src_d
            val = None
        chunk = max(1, (1 << 25) // per)  # blocks a chunk: ~256 MB transient
        bounds = np.searchsorted(k, np.arange(0, B + chunk, chunk))
        for ci in range(len(bounds) - 1):
            lo, hi = bounds[ci], bounds[ci + 1]
            if lo == hi:
                continue
            k0 = ci * chunk
            n = min(chunk, B - k0) * per
            cnt = np.bincount(flat[lo:hi] - k0 * per,
                              weights=None if val is None else val[lo:hi],
                              minlength=n)
            out[k0 * per:k0 * per + n] = cnt.astype(out.dtype)
        shape = (rows, T, T // 8 if bits == 1 else T)
        out = out.reshape(shape)
        if bits == 16:  # counts <= 256 are exact in bf16: its top 16 bits
            out = (out.view(np.uint32) >> 16).astype(np.uint16)
        return out


def _required_bits(a_max: float, tile: int) -> int:
    """The narrowest exact A encoding for counts up to ``a_max``."""
    if a_max <= 1 and tile % 8 == 0:
        return 1
    if a_max <= 127:
        return 8
    if a_max <= 256:
        return 16
    return 32


def _reoffset_inv(inv, counts, caps):
    # per-part class offsets (cumsum of counts) -> the shared cap layout;
    # anything else -> the sentinel after the last class
    inv = inv.astype(np.int64)
    out = np.full_like(inv, sum(caps))
    off_old = off_new = 0
    for n_b, cap in zip(counts, caps):
        sel = (inv >= off_old) & (inv < off_old + n_b)
        out[sel] = inv[sel] - off_old + off_new
        off_old += n_b
        off_new += cap
    return out.astype(np.int32)


def build_sharded_block_tables(sg, tile: int = 256, n_feat_hint: int = 256,
                               byte_budget: int = DENSE_A_BYTE_BUDGET,
                               nnz_threshold: Optional[int] = None,
                               group: int = 1,
                               stats: Optional[dict] = None,
                               ) -> Tuple[Dict[str, np.ndarray], int]:
    """The stacked per-part hybrid plans of a ``ShardedGraph`` (leading
    part axis), padded to shared shapes: ``(tables, tile)`` with the JAX
    keys ``blk_a_bits`` ``[P, B_max, T, T//8]`` uint8 (or ``blk_a`` ``[P,
    B_max, T, T]`` int8 / bf16 as uint16 bits / f32), ``blk_fwd_gNNb`` /
    ``blk_fwd_gNNt`` ``[P, cap, w]``, ``blk_fwd_ginv`` ``[P,
    n_dst_tiles]``, the ``blk_bwd_*`` transpose (at ``group > 1`` in their
    place ``blk_fwdu_gNNa`` ``[P, cap, group, w]`` / ``blk_fwdu_gNNt``
    ``[P, cap, w]``, ``blk_fwdu_inv`` ``[P, n_dst_tiles]`` and the
    ``blk_bwdu_*`` transpose), ``blkrem_fwd_NN`` / ``blkrem_fwd_inv`` and
    ``blkrem_bwd_*``. The A encoding is the
    narrowest exact one, found by the JAX fixpoint (the byte budget's
    block cap depends on the bits an entry, and the counts the kept
    blocks hold decide the bits). ``stats``, when given, receives per-part
    lists ``blocks``, ``dense_edges``, ``edges`` and ``a_bytes``, the
    shipped ``bits`` an entry and the block ``cap``."""
    P = sg.num_parts
    n_src_rows = sg.n_max + sg.halo_size
    edges = [PartEdges(sg.edge_src[r], sg.edge_dst[r], sg.n_max,
                       n_src_rows, tile) for r in range(P)]

    def plans_for(cap, ladders=None):
        kw = dict(zip(("fwd_widths", "bwd_widths", "fwd_k_widths",
                       "bwd_k_widths"), ladders or (None,) * 4))
        return [BlockPlan(e, n_feat_hint, nnz_threshold=nnz_threshold,
                          max_blocks=cap, group=group, **kw) for e in edges]

    bits = 1
    while True:
        cap = budget_block_cap(byte_budget, tile, bits)
        plans = plans_for(cap)
        emit_bits = _required_bits(max(p.a_max for p in plans), tile)
        if emit_bits <= bits:
            break
        bits = emit_bits
    # the unified ladders (the longest part's); the selection is the
    # same at the same cap, so only the tables are built again
    ladders = tuple(
        max((getattr(p, name) for p in plans), key=len)
        for name in ("rem_fwd_widths", "rem_bwd_widths", "fwd_k_widths",
                     "bwd_k_widths"))
    if any(getattr(p, name) != lad for p in plans
           for name, lad in zip(("rem_fwd_widths", "rem_bwd_widths",
                                 "fwd_k_widths", "bwd_k_widths"), ladders)):
        plans = plans_for(cap, ladders)
    fw, bw, fk, bk = ladders

    B_max = max(p.B for p in plans)
    fwd_caps = [max(p.rem_fwd_counts[b] for p in plans)
                for b in range(len(fw))]
    bwd_caps = [max(p.rem_bwd_counts[b] for p in plans)
                for b in range(len(bw))]
    def dense_counts(p, direction):
        if group > 1:
            return p.fwd_u_counts if direction == "fwd" else p.bwd_u_counts
        return p.fwd_gcounts if direction == "fwd" else p.bwd_gcounts

    fk_caps = [max(dense_counts(p, "fwd")[w] for p in plans)
               for w in range(len(fk))]
    bk_caps = [max(dense_counts(p, "bwd")[w] for p in plans)
               for w in range(len(bk))]

    tables: Dict[str, List[np.ndarray]] = {}
    for p in plans:
        B = p.B
        arrs = {
            ("blk_a_bits" if emit_bits == 1 else "blk_a"):
                p.a_stored(emit_bits, B_max),
            "blkrem_fwd_inv": _reoffset_inv(p.rem_fwd_inv, p.rem_fwd_counts,
                                            fwd_caps),
            "blkrem_bwd_inv": _reoffset_inv(p.rem_bwd_inv, p.rem_bwd_counts,
                                            bwd_caps),
        }
        if group > 1:
            # inv holds r * group + d: the row part moves to the shared
            # caps (the sentinel sum(counts) * group -> sum(caps) * group)
            for direction, inv, counts, caps in (
                    ("fwd", p.fwd_u_inv, p.fwd_u_counts, fk_caps),
                    ("bwd", p.bwd_u_inv, p.bwd_u_counts, bk_caps)):
                arrs[f"blk_{direction}u_inv"] = (
                    _reoffset_inv(inv // group, counts, caps)
                    .astype(np.int64) * group + inv % group).astype(np.int32)
            for direction, classes, caps in (
                    ("fwd", p.fwd_u_classes, fk_caps),
                    ("bwd", p.bwd_u_classes, bk_caps)):
                for w_i, (a_idx, t_mat) in enumerate(classes):
                    if not caps[w_i]:
                        continue
                    a_idx = np.where(a_idx == B, B_max, a_idx)
                    arrs[f"blk_{direction}u_g{w_i:02d}a"] = _pad_rows(
                        a_idx, caps[w_i], B_max).astype(np.int32)
                    arrs[f"blk_{direction}u_g{w_i:02d}t"] = _pad_rows(
                        t_mat, caps[w_i],
                        p.n_src_tiles if direction == "fwd"
                        else p.n_dst_tiles).astype(np.int32)
        else:
            arrs["blk_fwd_ginv"] = _reoffset_inv(p.fwd_ginv, p.fwd_gcounts,
                                                 fk_caps)
            arrs["blk_bwd_ginv"] = _reoffset_inv(p.bwd_ginv, p.bwd_gcounts,
                                                 bk_caps)
            for direction, groups, caps in (("fwd", p.fwd_groups, fk_caps),
                                            ("bwd", p.bwd_groups, bk_caps)):
                for w_i, (a_mat, b_mat) in enumerate(groups):
                    if not caps[w_i]:
                        continue
                    # this part's pad block B -> the shared zero block
                    a_mat = np.where(a_mat == B, B_max, a_mat)
                    arrs[f"blk_{direction}_g{w_i:02d}b"] = _pad_rows(
                        a_mat, caps[w_i], B_max).astype(np.int32)
                    arrs[f"blk_{direction}_g{w_i:02d}t"] = _pad_rows(
                        b_mat, caps[w_i],
                        p.n_src_tiles if direction == "fwd"
                        else p.n_dst_tiles).astype(np.int32)
        for b in range(len(fw)):
            if fwd_caps[b]:
                arrs[f"blkrem_fwd_{b:02d}"] = _pad_rows(
                    p.rem_fwd_mats[b], fwd_caps[b], n_src_rows)
        for b in range(len(bw)):
            if bwd_caps[b]:
                arrs[f"blkrem_bwd_{b:02d}"] = _pad_rows(
                    p.rem_bwd_mats[b], bwd_caps[b], sg.n_max)
        for k, v in arrs.items():
            tables.setdefault(k, []).append(v)
    if stats is not None:
        a_key = "blk_a_bits" if emit_bits == 1 else "blk_a"
        stats.update(
            blocks=[p.B for p in plans],
            dense_edges=[p.dense_edges for p in plans],
            edges=[p.dense_edges + p.rem_count for p in plans],
            a_bytes=[int(a.nbytes) for a in tables[a_key]], bits=emit_bits,
            cap=cap, group=group)
    return {k: np.stack(v) for k, v in tables.items()}, tile


# ---------------------------------------------------------------------------
# device half: the staged tables


@dataclasses.dataclass
class BlockSide:
    """One direction's dense pair lists, flattened for K12/K13: output
    tile i of part p takes the pairs ``ptr[p, i] .. ptr[p, i + 1]`` of
    ``blk`` (A block) and ``tile`` (input tile), ``[P, n_pairs]`` int32
    (``ptr`` ``[P, n_out_tiles + 1]`` int32). ``n_out`` / ``n_in`` are the
    output and input row counts; ``transpose`` marks the backward (A^T)."""

    ptr: torch.Tensor
    blk: torch.Tensor
    tile: torch.Tensor
    n_out: int
    n_in: int
    transpose: bool

    @property
    def n_out_tiles(self) -> int:
        return int(self.ptr.shape[1]) - 1


@dataclasses.dataclass
class GroupSide:
    """One direction's union-gather lists (``group > 1``), flattened for
    K16/K17: the group of output tiles ``j*group .. j*group + group - 1``
    of part p walks the union slots ``ptr[p, j] .. ptr[p, j + 1]``; slot k
    holds its input tile ``tile[p, k]`` and, for each tile d of the
    group, the A block that multiplies it there, ``blk[p, k, d]``
    (``b_max``: none). ``ptr`` ``[P, n_groups + 1]``, ``tile`` ``[P,
    n_slots]``, ``blk`` ``[P, n_slots, group]``, int32. ``n_out`` /
    ``n_in`` are the output and input row counts, ``n_out_tiles`` the
    output tiles; ``transpose`` marks the backward (A^T)."""

    ptr: torch.Tensor
    tile: torch.Tensor
    blk: torch.Tensor
    group: int
    n_out: int
    n_in: int
    n_out_tiles: int
    transpose: bool

    @property
    def n_groups(self) -> int:
        return int(self.ptr.shape[1]) - 1


def union_view(side: BlockSide) -> GroupSide:
    """A pair list as the union list of group 1 (K12's and K13's view on
    csrc/block_tma.cu): each output tile is its own group, each pair a
    union slot whose one block is the pair's, ``blk`` ``[P, n_pairs,
    1]``. Views of the same tensors, no copy; no slot holds the pad (the
    pads were dropped at staging)."""
    return GroupSide(ptr=side.ptr, tile=side.tile, blk=side.blk[..., None],
                     group=1, n_out=side.n_out, n_in=side.n_in,
                     n_out_tiles=side.n_out_tiles, transpose=side.transpose)


@dataclasses.dataclass
class BlockTables:
    """The staged block tables of P parts: ``a`` the A blocks ``[P, B_max,
    T, T//8]`` uint8 when ``packed`` (1 bit an entry), else ``[P, B_max, T,
    T]`` int8 / bfloat16 / float32; the dense lists ``fwd`` (keyed by
    destination tile) and ``bwd`` (by source tile), per-tile pairs
    (:class:`BlockSide`) or, at ``group > 1``, union groups
    (:class:`GroupSide`); the remainder's bucket tables ``rem_fwd`` /
    ``rem_bwd`` (K9's)."""

    a: torch.Tensor
    packed: bool
    tile: int
    fwd: "BlockSide | GroupSide"
    bwd: "BlockSide | GroupSide"
    rem_fwd: BucketSide
    rem_bwd: BucketSide

    @property
    def b_max(self) -> int:
        return int(self.a.shape[1])

    @property
    def group(self) -> int:
        return self.fwd.group if isinstance(self.fwd, GroupSide) else 1


def _class_keys(tables, direction: str) -> List[str]:
    return sorted(k[:-1] for k in tables
                  if k.startswith(f"blk_{direction}_g") and k.endswith("b"))


def _flatten_pairs(tables, direction: str, b_max: int, n_in_tiles: int):
    """``(ptr, blk, tile)`` numpy of one direction: each output tile's
    pairs in class order (the row its ``ginv`` points at, left to right),
    pad pairs dropped, the row's tail past a part's last pair the pad
    block ``b_max`` and tile 0. Raises on an index out of range."""
    ginv = np.asarray(tables[f"blk_{direction}_ginv"]).astype(np.int64)
    P, n_tiles = ginv.shape
    keys = _class_keys(tables, direction)
    mats = [(np.asarray(tables[k + "b"]), np.asarray(tables[k + "t"]))
            for k in keys]
    caps = [int(b.shape[1]) for b, _ in mats]
    total = sum(caps)
    per_part = []
    for p in range(P):
        if int(ginv[p].min(initial=0)) < 0 or \
                int(ginv[p].max(initial=0)) > total:
            raise ValueError(f"block table blk_{direction}_ginv holds rows "
                             f"out of [0, {total}]")
        tile_of_row = np.full(total + 1, -1, np.int64)
        tile_of_row[ginv[p]] = np.arange(n_tiles)
        tile_of_row[total] = -1  # the sentinel: tiles with no pairs
        tl, col, bk, tk = [], [], [], []
        off = 0
        for (b, t), cap in zip(mats, caps):
            r, c = np.nonzero(b[p] != b_max)
            owner = tile_of_row[off + r]
            keep = owner >= 0  # cap-padding rows are never read
            tl.append(owner[keep])
            col.append(c[keep])
            bk.append(b[p][r[keep], c[keep]])
            tk.append(t[p][r[keep], c[keep]])
            off += cap
        tl, col, bk, tk = (np.concatenate(x) if x else np.zeros(0, np.int64)
                           for x in (tl, col, bk, tk))
        order = np.lexsort((col, tl))
        bk, tk, tl = bk[order], tk[order], tl[order]
        if bk.size and (int(bk.min()) < 0 or int(bk.max()) >= b_max
                        or int(tk.min()) < 0
                        or int(tk.max()) >= n_in_tiles):
            raise ValueError(f"block table blk_{direction}_g* holds a block "
                             f"or tile index out of range")
        ptr = np.zeros(n_tiles + 1, np.int64)
        np.cumsum(np.bincount(tl, minlength=n_tiles), out=ptr[1:])
        per_part.append((ptr, bk, tk))
    width = max(1, max(x[1].shape[0] for x in per_part))
    ptr = np.stack([x[0] for x in per_part]).astype(np.int32)
    # past a part's last pair: the pad block and tile 0, as the union
    # lists pad (so a pair list is its own union list at group 1)
    blk = np.full((P, width), b_max, np.int32)
    til = np.zeros((P, width), np.int32)
    for p, (_, bk, tk) in enumerate(per_part):
        blk[p, :bk.shape[0]] = bk
        til[p, :tk.shape[0]] = tk
    return ptr, blk, til


def _flatten_unions(tables, direction: str, b_max: int, n_in_tiles: int):
    """``(ptr, tile, blk, group)`` numpy of one direction's union-gather
    classes: each group of output tiles' union slots in class order (the
    row its tiles' ``inv`` points at, slot by slot), slots with no block
    or the zero tile and cap-padding rows dropped. Raises on an index out
    of range or an ``inv`` that does not map a group's tiles to one row."""
    inv = np.asarray(tables[f"blk_{direction}u_inv"]).astype(np.int64)
    P, n_tiles = inv.shape
    keys = sorted(k[:-1] for k in tables
                  if k.startswith(f"blk_{direction}u_g") and k.endswith("a"))
    mats = [(np.asarray(tables[k + "a"]), np.asarray(tables[k + "t"]))
            for k in keys]
    if not mats:
        raise ValueError(f"block tables hold blk_{direction}u_inv but no "
                         f"blk_{direction}u_g* class")
    group = int(mats[0][0].shape[2])
    caps = [int(a.shape[1]) for a, _ in mats]
    total = sum(caps)
    sentinel = total * group
    n_groups = -(-n_tiles // group)
    tid = np.arange(n_tiles)
    per_part = []
    for p in range(P):
        iv = inv[p]
        if int(iv.min(initial=0)) < 0 or int(iv.max(initial=0)) > sentinel:
            raise ValueError(f"block table blk_{direction}u_inv holds "
                             f"positions out of [0, {sentinel}]")
        real = iv != sentinel
        row = np.where(real, iv // group, -1)
        starts = np.arange(0, n_tiles, group)
        if (real & (iv % group != tid % group)).any() or (
                np.minimum.reduceat(row, starts)
                != np.maximum.reduceat(row, starts)).any():
            raise ValueError(f"block table blk_{direction}u_inv does not map "
                             f"each group's tiles to one row")
        grow = row[starts]  # each group's class row, -1: no block
        used = grow[grow >= 0]
        if np.unique(used).shape[0] != used.shape[0]:
            raise ValueError(f"block table blk_{direction}u_inv maps two "
                             f"groups to one row")
        gl, ul, tl, bl = [], [], [], []
        off = 0
        for (a, t), cap in zip(mats, caps):
            gsel = np.nonzero((grow >= off) & (grow < off + cap))[0]
            lr = grow[gsel] - off
            ab = a[p][lr].transpose(0, 2, 1)  # [n, w, group]
            tt = t[p][lr]                     # [n, w]
            keep = (tt != n_in_tiles) & (ab != b_max).any(axis=2)
            r, c = np.nonzero(keep)
            gl.append(gsel[r])
            ul.append(c)
            tl.append(tt[r, c])
            bl.append(ab[r, c])
            off += cap
        g, u, til = (np.concatenate(x) for x in (gl, ul, tl))
        blk = np.concatenate(bl).reshape(-1, group)
        order = np.lexsort((u, g))
        g, til, blk = g[order], til[order], blk[order]
        if til.size and (int(til.min()) < 0 or int(til.max()) >= n_in_tiles
                         or int(blk.min()) < 0 or int(blk.max()) > b_max):
            raise ValueError(f"block table blk_{direction}u_g* holds a block "
                             f"or tile index out of range")
        ptr = np.zeros(n_groups + 1, np.int64)
        np.cumsum(np.bincount(g, minlength=n_groups), out=ptr[1:])
        per_part.append((ptr, til, blk))
    width = max(1, max(x[1].shape[0] for x in per_part))
    ptr = np.stack([x[0] for x in per_part]).astype(np.int32)
    til = np.zeros((P, width), np.int32)
    blk = np.full((P, width, group), b_max, np.int32)
    for p, (_, tk, bk) in enumerate(per_part):
        til[p, :tk.shape[0]] = tk
        blk[p, :bk.shape[0]] = bk
    return ptr, til, blk, group


def stage_block_tables(tables: Dict[str, np.ndarray], tile: int, n_max: int,
                       n_src: int, device: torch.device) -> BlockTables:
    """Both directions of :func:`build_sharded_block_tables` on ``device``
    (``n_src = n_max + H``): the A blocks as stored, the dense pair lists
    (or the union groups) and the remainder's bucket tables
    (``flatten_side``)."""
    packed = "blk_a_bits" in tables
    a = np.asarray(tables["blk_a_bits" if packed else "blk_a"])
    b_max = int(a.shape[1])
    if a.dtype == np.uint16:  # bf16 bits
        a_t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        a_t = torch.from_numpy(np.ascontiguousarray(a))
    n_dst_tiles, n_src_tiles = -(-n_max // tile), -(-n_src // tile)
    sides = {}
    put = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    for direction, n_out, n_in, n_in_tiles in (
            ("fwd", n_max, n_src, n_src_tiles),
            ("bwd", n_src, n_max, n_dst_tiles)):
        if "blk_fwdu_inv" in tables:
            ptr, til, blk, group = _flatten_unions(tables, direction, b_max,
                                                   n_in_tiles)
            sides[direction] = GroupSide(
                ptr=put(ptr), tile=put(til), blk=put(blk), group=group,
                n_out=n_out, n_in=n_in, n_out_tiles=-(-n_out // tile),
                transpose=direction == "bwd")
            continue
        ptr, blk, til = _flatten_pairs(tables, direction, b_max, n_in_tiles)
        sides[direction] = BlockSide(ptr=put(ptr), blk=put(blk),
                                     tile=put(til), n_out=n_out, n_in=n_in,
                                     transpose=direction == "bwd")
    # copy=True: on the CPU the staged A never shares memory with the host
    # tables (a restage from them must not see a staged table's flip)
    return BlockTables(
        a=a_t.to(device, copy=True), packed=packed, tile=tile,
        fwd=sides["fwd"], bwd=sides["bwd"],
        rem_fwd=flatten_side(tables, "blkrem_fwd", n_src, device),
        rem_bwd=flatten_side(tables, "blkrem_bwd", n_max, device))


# ---------------------------------------------------------------------------
# K12, K13: the tile products

# elements of the plain version's per-chunk transients (unpacked A, the
# gathered input tiles, the products)
PLAIN_ELEMS = 1 << 25

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pgt_block_dense": [_P, _I, _I, _I, _P, _I, _LL, _I, _P, _P, _P, _LL, _I,
                        _I, _I, _I, _P, _P],
    "pgt_block_grouped": [_P, _I, _I, _I, _P, _I, _LL, _I, _I, _P, _P, _P,
                          _LL, _I, _I, _I, _I, _P, _P],
}
# the kernel's A encodings
_ENC = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 3}
# K16's, K17's and K12's source (csrc/block_tma.cu): the pre-pass and the
# TMA / wgmma kernel (every A encoding but f32, which keeps block_spmm.cu's
# scalar path)
_TMA_SIGNATURES = {
    "pgt_tile_split": [_P, _I, _I, _I, _I, _I, _P, _P],
    "pgt_block_grouped_tma": [_P, _I, _I, _I, _I, _P, _P, _I, _LL, _I, _I,
                              _P, _P, _P, _LL, _I, _I, _I, _P, _P],
}


def _check_dense(x: torch.Tensor, tables: BlockTables, side):
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32 or bf16 [P, n_in, F], got "
                         f"{x.dtype} {tuple(x.shape)}")
    P = x.shape[0]
    if x.shape[1] != side.n_in or side.ptr.shape[0] != P \
            or tables.a.shape[0] != P:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, tables for "
                         f"{side.ptr.shape[0]} parts of {side.n_in} rows")
    if tables.packed != (tables.a.dtype == torch.uint8) \
            or tables.a.dtype not in (torch.uint8, *_ENC):
        raise ValueError(f"unknown A encoding {tables.a.dtype}")
    devs = {t.device for t in (x, tables.a, side.ptr, side.blk, side.tile)}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: {devs}")


def _unpack(blocks: torch.Tensor, packed: bool) -> torch.Tensor:
    """Gathered A blocks ``[n, T, T//8]`` uint8 (little-endian bits) or
    ``[n, T, T]`` -> f32 ``[n, T, T]`` (``_unpack_bits`` / the cast)."""
    if not packed:
        return blocks.float()
    shifts = torch.arange(8, dtype=torch.uint8, device=blocks.device)
    bits = (blocks[..., None] >> shifts) & 1
    return bits.reshape(blocks.shape[:-1] + (-1,)).float()


def _products(side, b_max: int, p: int, device: torch.device):
    """``(owner, block, tile)``: part p's tile products in list order,
    each one's output tile, A block and input tile (int64 on ``device``):
    a pair list's pairs, or each union slot's (tile of the group, block)
    entries that hold a block, in slot order."""
    if isinstance(side, GroupSide):
        ptr = side.ptr[p].long()
        n = int(ptr[-1])
        group_of = torch.repeat_interleave(
            torch.arange(side.n_groups, device=ptr.device), ptr.diff())
        blk = side.blk[p, :n].long()
        k, d = (blk != b_max).nonzero(as_tuple=True)
        owner = group_of[k] * side.group + d
        return (owner.to(device), blk[k, d].to(device),
                side.tile[p, :n].long()[k].to(device))
    ptr = side.ptr[p].long()
    n = int(ptr[-1])
    owner = torch.repeat_interleave(
        torch.arange(side.n_out_tiles, device=ptr.device), ptr.diff())
    return (owner.to(device), side.blk[p, :n].long().to(device),
            side.tile[p, :n].long().to(device))


def block_dense_plain(x: torch.Tensor, tables: BlockTables,
                      side) -> torch.Tensor:
    """Plain PyTorch version of K12 (``side.transpose`` False) and K13, and
    over a :class:`GroupSide` of K16 / K17: for every output tile the sum
    over its products of ``A @ tile`` (``A^T @ tile`` transposed), the
    input zero-padded to whole tiles; unpacked and multiplied by ``bmm`` a
    chunk of products at a time, summed into the output tiles with
    ``index_add_``; bf16 rows widened to f32 exactly. ``[P, n_out, F]``
    f32, on any device."""
    _check_dense(x, tables, side)
    P, R, F = x.shape
    T = tables.tile
    n_in_tiles = -(-R // T)
    n_tiles = side.n_out_tiles
    if isinstance(side, GroupSide):
        n_tiles = side.n_groups * side.group  # the last group's tail too
    xt = torch.zeros((P, n_in_tiles * T, F), dtype=torch.float32,
                     device=x.device)
    xt[:, :R] = x
    xt = xt.view(P, n_in_tiles, T, F)
    out = torch.zeros((P, n_tiles, T, F), dtype=torch.float32,
                      device=x.device)
    step = max(1, PLAIN_ELEMS // (T * T + 2 * T * F))
    for p in range(P):
        owner, blk, til = _products(side, tables.b_max, p, x.device)
        for i in range(0, owner.shape[0], step):
            j = min(owner.shape[0], i + step)
            a = _unpack(tables.a[p].index_select(0, blk[i:j]),
                        tables.packed)
            if side.transpose:
                a = a.transpose(1, 2)
            tiles = xt[p].index_select(0, til[i:j])
            out[p].index_add_(0, owner[i:j], torch.bmm(a, tiles))
    return out.reshape(P, n_tiles * T, F)[:, :side.n_out]


def split_width(F: int) -> int:
    """The padded row width of K16's pre-split planes: F rounded up to 64
    (a TMA box of 64 bf16 columns, 128 bytes)."""
    return -(-F // 64) * 64


def tile_split_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K16's pre-pass: ``x`` ``[P, n_in, F]`` f32 ->
    ``[3, P, n_in, Fp]`` bf16 planes hi, mid, lo (``Fp =
    split_width(F)``, the pad columns zero): hi = x truncated to bf16,
    mid = (x - hi) truncated, lo = x - hi - mid truncated, each carrying
    x's sign bit (so -0 splits into three -0). Truncation never
    overflows near the largest finite. ``hi + mid + lo == x`` bit for bit
    wherever |x| >= 2**-110 or x is zero (24 significant bits in three
    8-bit terms, each exact in bf16); below that the terms hold x
    truncated toward zero to a multiple of 2**-133, bf16's least
    subnormal, which no sum of bf16 values can undercut. bf16 ``x``: one
    plane, the rows copied and padded. Inputs are finite (an infinite
    input's split is NaN)."""
    P, R, F = x.shape
    Fp = split_width(F)
    if x.dtype == torch.bfloat16:
        out = torch.zeros((1, P, R, Fp), dtype=torch.bfloat16,
                          device=x.device)
        out[0, :, :, :F] = x
        return out
    if x.dtype != torch.float32:
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    mask = torch.tensor(-65536, dtype=torch.int32)  # 0xffff0000
    u = x.contiguous().view(torch.int32)
    sign = u & torch.tensor(-2 ** 31, dtype=torch.int32)
    hi = u & mask
    r = x - hi.view(torch.float32)
    mid = r.view(torch.int32) & mask
    lo = r - mid.view(torch.float32)
    out = torch.zeros((3, P, R, Fp), dtype=torch.int16, device=x.device)
    for h, t in enumerate((hi, mid | sign, lo.view(torch.int32) | sign)):
        out[h, :, :, :F] = (t >> 16).to(torch.int16)
    return out.view(torch.bfloat16)


def tile_split(x: torch.Tensor) -> torch.Tensor:
    """K16's pre-pass alone (``tile_split_plain``'s function) on a CUDA
    tensor, the plain version on a CPU tensor; anything else raises. K16
    runs it inside its own launch; this entry serves the checks."""
    if x.device.type == "cpu":
        return tile_split_plain(x)
    if x.device.type != "cuda" or x.dim() != 3 or x.dtype not in (
            torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"tile_split: takes a contiguous f32 / bf16 [P, "
                         f"n_in, F] CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    P, R, F = x.shape
    xb = x.dtype == torch.bfloat16
    out = torch.empty((1 if xb else 3, P, R, split_width(F)),
                      dtype=torch.bfloat16, device=x.device)
    lib = _build.load("block_tma", _TMA_SIGNATURES)
    rc = lib.pgt_tile_split(x.data_ptr(), int(xb), P, R, F,
                            split_width(F), out.data_ptr(),
                            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "tile_split")
    return out


def tile_entry(grouped: bool, transpose: bool, a_dtype: torch.dtype) -> str:
    """The C entry that runs one side's tile products on the card: with
    1-bit (uint8), int8 or bf16 A, csrc/block_tma.cu's TMA / wgmma kernel
    for K16 and K17 over union groups and K12 and K13 over pair lists
    (their union view at group 1); f32 A (not exact in bf16) on
    csrc/block_spmm.cu, over union groups or pair lists, either
    direction."""
    if a_dtype != torch.float32:
        return "pgt_block_grouped_tma"
    return "pgt_block_grouped" if grouped else "pgt_block_dense"


def _launch_tma(x: torch.Tensor, tables: BlockTables, side: GroupSide,
                out: torch.Tensor, stream: int) -> int:
    """K16, K17 (``side.transpose``: A^T), K12 and K13 (on a pair list's
    union view) through csrc/block_tma.cu: the pre-split planes (f32 rows; bf16
    rows whose row stride or pointer is not 16-byte aligned) then the TMA
    / wgmma products."""
    P, R, F = x.shape
    xb = x.dtype == torch.bfloat16
    planes = None
    if not xb or F % 8 or x.data_ptr() % 16:
        planes = torch.empty((1 if xb else 3, P, R, split_width(F)),
                             dtype=torch.bfloat16, device=x.device)
    lib = _build.load("block_tma", _TMA_SIGNATURES)
    return lib.pgt_block_grouped_tma(
        x.data_ptr(), int(xb), P, R, F,
        None if planes is None else planes.data_ptr(), tables.a.data_ptr(),
        0 if tables.packed else _ENC[tables.a.dtype], tables.b_max,
        tables.tile, side.group, side.ptr.data_ptr(), side.blk.data_ptr(),
        side.tile.data_ptr(), side.tile.shape[1], side.n_groups, side.n_out,
        int(side.transpose), out.data_ptr(), stream)


def _launch(x: torch.Tensor, tables: BlockTables,
            side: BlockSide) -> torch.Tensor:
    _check_dense(x, tables, side)
    if x.device.type != "cuda":
        raise ValueError(f"block_dense: unsupported device {x.device}")
    ts = (x, tables.a, side.ptr, side.blk, side.tile)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("block_dense: the kernel takes contiguous tensors")
    T = tables.tile
    if T % 32 or not 32 <= T <= 256:
        raise ValueError(f"block_dense: the kernel takes tiles of 32 to 256 "
                         f"rows in steps of 32, not {T}")
    P, R, F = x.shape
    if side.ptr.dtype != torch.int32 or side.blk.dtype != torch.int32 \
            or side.tile.dtype != torch.int32:
        raise ValueError("block_dense: the pair lists must be int32")
    grouped = isinstance(side, GroupSide)
    G = side.group if grouped else 1
    n_keys = side.n_groups if grouped else side.n_out_tiles
    if R >= 2 ** 31 or F >= 2 ** 31 or side.n_out >= 2 ** 31 \
            or n_keys * (-(-G * T // 256)) > 65535 or P > 65535:
        raise ValueError("block_dense: x too large for the kernel")
    out = torch.empty((P, side.n_out, F), dtype=torch.float32,
                      device=x.device)
    enc = 0 if tables.packed else _ENC[tables.a.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xb = int(x.dtype == torch.bfloat16)
    entry = tile_entry(grouped, side.transpose, tables.a.dtype)
    if entry == "pgt_block_grouped_tma":
        rc = _launch_tma(x, tables, side if grouped else union_view(side),
                         out, stream)
        _build.check(rc, "block_tma")
        return out
    lib = _build.load("block_spmm", _SIGNATURES)
    if grouped:
        rc = lib.pgt_block_grouped(
            x.data_ptr(), P, R, F, tables.a.data_ptr(), enc, tables.b_max,
            T, G, side.ptr.data_ptr(), side.blk.data_ptr(),
            side.tile.data_ptr(), side.tile.shape[1], n_keys, side.n_out,
            int(side.transpose), xb, out.data_ptr(), stream)
    else:
        rc = lib.pgt_block_dense(
            x.data_ptr(), P, R, F, tables.a.data_ptr(), enc, tables.b_max,
            T, side.ptr.data_ptr(), side.blk.data_ptr(),
            side.tile.data_ptr(), side.blk.shape[1], n_keys, side.n_out,
            int(side.transpose), xb, out.data_ptr(), stream)
    _build.check(rc, "block_spmm")
    return out


def block_dense(x: torch.Tensor, tables: BlockTables) -> torch.Tensor:
    """K12, the forward tile products over ``tables.fwd``, on CUDA tensors
    (counted in ``block_dense.launches``, and by row dtype in
    ``block_dense.by_mode``); the plain version on CPU
    tensors; anything else raises."""
    if x.device.type == "cpu":
        return block_dense_plain(x, tables, tables.fwd)
    out = _launch(x, tables, tables.fwd)
    block_dense.launches += 1
    block_dense.by_mode[str(x.dtype).split(".")[-1]] += 1
    return out


def block_dense_t(g: torch.Tensor, tables: BlockTables) -> torch.Tensor:
    """K13, the transpose tile products over ``tables.bwd`` (the same A
    blocks, A^T), on CUDA tensors (counted in ``block_dense_t.launches``
    and ``block_dense_t.by_mode``);
    the plain version on CPU tensors; anything else raises."""
    if g.device.type == "cpu":
        return block_dense_plain(g, tables, tables.bwd)
    out = _launch(g, tables, tables.bwd)
    block_dense_t.launches += 1
    block_dense_t.by_mode[str(g.dtype).split(".")[-1]] += 1
    return out


def _grouped_side(tables: BlockTables, side):
    if not isinstance(side, GroupSide):
        raise ValueError("K16 / K17 take union-gather tables (block group "
                         "> 1); K12 / K13 take the pair lists")
    return side


def block_dense_grouped(x: torch.Tensor, tables: BlockTables
                        ) -> torch.Tensor:
    """K16, the forward tile products over the union groups of
    ``tables.fwd`` (``--block-group > 1``), on CUDA tensors (counted in
    ``block_dense_grouped.launches`` and by row dtype in ``.by_mode``);
    the plain version on CPU tensors; anything else raises."""
    side = _grouped_side(tables, tables.fwd)
    if x.device.type == "cpu":
        return block_dense_plain(x, tables, side)
    out = _launch(x, tables, side)
    block_dense_grouped.launches += 1
    block_dense_grouped.by_mode[str(x.dtype).split(".")[-1]] += 1
    return out


def block_dense_grouped_t(g: torch.Tensor, tables: BlockTables
                          ) -> torch.Tensor:
    """K17, the transpose over the union groups of ``tables.bwd`` (the same
    A blocks, A^T), on CUDA tensors (counted in
    ``block_dense_grouped_t.launches`` and ``.by_mode``); the plain
    version on CPU tensors; anything else raises."""
    side = _grouped_side(tables, tables.bwd)
    if g.device.type == "cpu":
        return block_dense_plain(g, tables, side)
    out = _launch(g, tables, side)
    block_dense_grouped_t.launches += 1
    block_dense_grouped_t.by_mode[str(g.dtype).split(".")[-1]] += 1
    return out


block_dense.launches = 0
block_dense_t.launches = 0
block_dense_grouped.launches = 0
block_dense_grouped_t.launches = 0
# launches by input-row dtype (f32 mode, bf16 mode), beside the total
block_dense.by_mode = {"float32": 0, "bfloat16": 0}
block_dense_t.by_mode = {"float32": 0, "bfloat16": 0}
block_dense_grouped.by_mode = {"float32": 0, "bfloat16": 0}
block_dense_grouped_t.by_mode = {"float32": 0, "bfloat16": 0}


def _dense(x: torch.Tensor, tables: BlockTables, transpose: bool,
           plain: bool) -> torch.Tensor:
    """The dense tiles' products of one direction: the plain version, or
    K12 / K13 (pair lists) or K16 / K17 (union groups)."""
    side = tables.bwd if transpose else tables.fwd
    if plain:
        return block_dense_plain(x, tables, side)
    if isinstance(side, GroupSide):
        fn = block_dense_grouped_t if transpose else block_dense_grouped
    else:
        fn = block_dense_t if transpose else block_dense
    return fn(x, tables)


# ---------------------------------------------------------------------------
# the differentiable aggregation


class BlockSpmm(torch.autograd.Function):
    """``out = (dense(fbuf) + bucket(cast(fbuf)) * inv_scale) / in_deg``
    (f32 ``[P, n_max, F]``) with its transpose as the backward
    (``make_block_spmm_fn``). ``plain`` picks the plain versions on any
    device; otherwise CUDA tensors run K12, K13, K9-K11 and CPU tensors
    the plain versions. ``share`` is the remainder's ``TransportShare``."""

    @staticmethod
    def forward(ctx, fbuf, tables, in_deg, rem_dtype, rem_amax, plain,
                share):
        fwd_dt, bwd_dt = transport_dtypes(rem_dtype)
        x = fbuf.contiguous()  # f32, or bf16 rows: K12's bf16 mode
        dense = _dense(x, tables, False, plain)
        # the remainder's transport only: the dense path reads the rows
        # in their own dtype
        y, inv = _transport(x, fwd_dt, rem_amax, None, plain, share)
        gather = bucket_gather_plain if plain else bucket_gather
        rem = gather(y, tables.rem_fwd, None, inv)
        ctx.tables, ctx.bwd_dt, ctx.amax = tables, bwd_dt, rem_amax
        ctx.plain, ctx.share, ctx.fbuf_dtype = plain, share, fbuf.dtype
        ctx.save_for_backward(in_deg)
        return (dense + rem) / in_deg[..., None]

    @staticmethod
    def backward(ctx, g):
        (in_deg,) = ctx.saved_tensors
        t = ctx.tables
        gf = g.float().contiguous()
        gd = (gf / in_deg[..., None]).to(ctx.fbuf_dtype)
        dense = _dense(gd, t, True, ctx.plain)
        # the remainder's cast comes straight from the f32 cotangent, with
        # the division fused into it (bucket_spmm's single rounding)
        if ctx.bwd_dt is not None:
            rem_in, inv = _transport(gf, ctx.bwd_dt, ctx.amax, in_deg,
                                     ctx.plain, ctx.share)
        else:
            rem_in, inv = gd, None
        gather = bucket_gather_plain if ctx.plain else bucket_gather
        rem = gather(rem_in, t.rem_bwd, None, inv)
        return ((dense + rem).to(ctx.fbuf_dtype), None, None, None, None,
                None, None)


def block_spmm(fbuf: torch.Tensor, tables: BlockTables,
               in_deg: torch.Tensor, rem_dtype: Optional[str] = None,
               rem_amax: bool = False, plain: bool = False,
               share=None) -> torch.Tensor:
    """Mean aggregation of the stacked ``fbuf [P, n_max + H, F]`` through
    the block tables, ``[P, n_max, F]`` f32, differentiable in fbuf.
    ``rem_dtype`` narrows the remainder's gather transport (None |
    'bfloat16' | 'float8'), ``rem_amax`` scales its fp8 casts by the
    per-part amax."""
    return BlockSpmm.apply(fbuf, tables, in_deg, rem_dtype, rem_amax,
                           plain, share)
