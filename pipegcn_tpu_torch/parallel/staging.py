"""Put a ``ShardedGraph`` on the device — port of the data staging of
``pipegcn_tpu/parallel/trainer.py``: ``Trainer._put_data`` (the ``[P, ...]``
device arrays) and ``Trainer._precompute_pp`` (the use_pp concat). Holds
no optimizer state.

Differences from the JAX staging:
  - the destination CSR ``indptr [P, n_max+1]`` is built on the host from
    the sorted ``edge_dst`` and staged in its place (kernel K1 reads the
    CSR; pad edges past ``indptr[n_max]`` are never read);
  - training (``stage(..., training=True)``) also stages the two host-built
    inverses the backward kernels read: the source-keyed transpose CSR of
    the edges (K3) and the inverse send CSR (K4); ``edge_dst`` itself is
    never staged;
  - with ``bucket_merge`` (``--spmm-impl bucket``) staging puts the
    stacked bucket tables (``ops.bucket_spmm``, flattened for K9) on the
    device, for training in place of the transpose CSR, which the bucket
    step does not read (as the JAX trainer drops its raw edges,
    ``trainer.py:208-237``), and for serving, whose refresh aggregates
    through them as the JAX engine does (``serve/engine.py:220-231``);
    the destination CSR stays for the CSR paths that share ``forward``;
  - with ``block`` (``--spmm-impl block``) it stages the block tables
    (``ops.block_spmm``: the A blocks, the dense pair lists, or at
    ``--block-group > 1`` the per-group unions, and the remainder's bucket
    tables) likewise; :func:`table_spmm` is the aggregation over either,
    the trainer's and the serving engine's;
  - the host-built tables go into a dict the caller may keep (the
    trainer's, for the integrity plane's rebuild, as the JAX trainer's
    ``_cached_tables`` keeps them beside a saved artifact), and every
    staged tensor is a copy, on the CPU too, so an in-place change of a
    staged tensor reaches neither the artifact nor those tables;
  - ``Trainer._pad_cols`` (the TPU 128-lane ``lane_pad``) has no
    counterpart: it only aligned feature slabs to TPU tiles and is
    numerically inert, so features are staged at their own width.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.block_spmm import (BlockTables, block_spmm,
                              build_sharded_block_tables, stage_block_tables)
from ..ops.bucket_spmm import (BucketTables, bucket_spmm,
                               build_sharded_bucket_tables,
                               stage_bucket_tables)
from ..ops.spmm import csr_indptr, csr_transpose, spmm_mean
from ..partition.halo import ShardedGraph
from .halo import halo_exchange, send_csr


@dataclasses.dataclass
class StagedGraph:
    """The device-side ``[P, ...]`` arrays of one ``ShardedGraph``."""

    num_parts: int
    n_max: int
    b_max: int
    feat: torch.Tensor       # [P, n_max, F] f32 raw features
    in_deg: torch.Tensor     # [P, n_max] f32 full-graph in-degrees
    indptr: torch.Tensor     # [P, n_max + 1] int32 (int64 past 2**31 edges)
    edge_src: torch.Tensor   # [P, e_max] int32 local source rows
    send_idx: torch.Tensor   # [P, P-1, B] int32
    send_mask: torch.Tensor  # [P, P-1, B] bool
    # training only (stage(..., training=True)); None when serving
    n_train_global: int = 0
    label: Optional[torch.Tensor] = None       # [P, n_max] int64
    train_mask: Optional[torch.Tensor] = None  # [P, n_max] bool
    row_mask: Optional[torch.Tensor] = None    # [P, n_max] f32 real rows
    indptr_t: Optional[torch.Tensor] = None    # [P, n_max + H + 1] int32
    dst_t: Optional[torch.Tensor] = None       # [P, e_max] int32
    send_ptr: Optional[torch.Tensor] = None    # [P, n_max + 1] int32
    send_slot: Optional[torch.Tensor] = None   # [P, nnz] int32
    # the aggregation's tables (training and serving), when staged
    bucket: Optional[BucketTables] = None      # --spmm-impl bucket
    bucket_build_s: float = 0.0                # host seconds, its tables
    block: Optional[BlockTables] = None        # --spmm-impl block
    block_build_s: float = 0.0                 # host seconds, its tables
    block_stats: Optional[dict] = None         # blocks, edges, A bytes

    @property
    def halo_size(self) -> int:
        return (self.num_parts - 1) * self.b_max

    @property
    def transpose(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(indptr_t, dst_t)``: the source-keyed CSR K3 reads."""
        return self.indptr_t, self.dst_t

    @property
    def inverse(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(send_ptr, send_slot)``: the inverse send CSR K4 reads."""
        return self.send_ptr, self.send_slot

    @property
    def device(self) -> torch.device:
        return self.feat.device


def _put(x: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    # writable + contiguous host copy only where needed (memmapped
    # artifacts are read-only), then one host-to-device copy
    # (copy=True: a CPU tensor of its own, as a device copy is)
    host = np.require(np.asarray(x, dtype=dtype), requirements=["C", "W"])
    return torch.from_numpy(host).to(device, copy=True)


def stage(sg: ShardedGraph, device: torch.device,
          training: bool = False,
          bucket_merge: Optional[int] = None,
          block: Optional[Tuple[int, int, Optional[int], int]] = None,
          tables: Optional[dict] = None) -> StagedGraph:
    """Copy the arrays the serving path reads to ``device``; given
    ``bucket_merge`` (the ladder's ``min_width``) also the bucket tables,
    or, given ``block`` ``(tile, n_feat_hint, nnz_threshold, group)``, the
    block tables (:func:`aggregation_tables` gives both from a config);
    with ``training`` also the labels, masks and the host-built inverses
    the training step reads (``Trainer._put_data``): the inverse send CSR
    and, without bucket or block tables, the transpose CSR. ``tables``, a
    dict the caller keeps, holds the host-built tables (the transpose CSR,
    the bucket or block tables) by kind: read when it has them, filled
    when not, so the caller's next staging of the same artifact (the
    trainer's rebuild, a serving engine beside a trainer) copies them
    again instead of building them."""
    extra = {}
    cache = {} if tables is None else tables
    if training and sg.multilabel:
        raise NotImplementedError(
            "multilabel training (BCE) waits for ROADMAP A5")
    n_src = sg.n_max + sg.halo_size
    if block is not None:
        t0 = time.perf_counter()
        tile, hint, nnz, group = block
        if ("block", block) not in cache:
            bstats: dict = {}
            cache[("block", block)] = (build_sharded_block_tables(
                sg, tile=tile, n_feat_hint=hint, nnz_threshold=nnz,
                group=group, stats=bstats)[0], bstats)
        btab, bstats = cache[("block", block)]
        extra["block"] = stage_block_tables(btab, tile, sg.n_max, n_src,
                                            device)
        extra["block_build_s"] = time.perf_counter() - t0
        extra["block_stats"] = bstats
    elif bucket_merge is not None:
        t0 = time.perf_counter()
        if ("bucket", bucket_merge) not in cache:
            cache[("bucket", bucket_merge)] = build_sharded_bucket_tables(
                sg, min_width=bucket_merge)
        extra["bucket"] = stage_bucket_tables(
            cache[("bucket", bucket_merge)], sg.n_max, n_src, device)
        extra["bucket_build_s"] = time.perf_counter() - t0
    if training:
        indptr_t = dst_t = None
        if block is None and bucket_merge is None:
            if "transpose" not in cache:
                cache["transpose"] = csr_transpose(sg.edge_src, sg.edge_dst,
                                                   sg.n_max, n_src)
            indptr_t, dst_t = (torch.from_numpy(a).to(device, copy=True)
                               for a in cache["transpose"])
        send_ptr, send_slot = send_csr(sg.send_idx, sg.send_mask, sg.n_max)
        row_mask = (np.arange(sg.n_max)[None, :]
                    < np.asarray(sg.inner_count)[:, None])
        extra.update(
            n_train_global=int(sg.n_train_global),
            label=_put(sg.label, np.int64, device),
            train_mask=_put(sg.train_mask, np.bool_, device),
            row_mask=_put(row_mask, np.float32, device),
            indptr_t=indptr_t,
            dst_t=dst_t,
            send_ptr=torch.from_numpy(send_ptr).to(device),
            send_slot=torch.from_numpy(send_slot).to(device))
    return StagedGraph(
        num_parts=sg.num_parts,
        n_max=sg.n_max,
        b_max=sg.b_max,
        feat=_put(sg.feat, np.float32, device),
        in_deg=_put(sg.in_deg, np.float32, device),
        indptr=torch.from_numpy(csr_indptr(sg.edge_dst, sg.n_max)).to(device),
        edge_src=_put(sg.edge_src, np.int32, device),
        send_idx=_put(sg.send_idx, np.int32, device),
        send_mask=_put(sg.send_mask, np.bool_, device),
        **extra,
    )


def aggregation_tables(cfg) -> dict:
    """The :func:`stage` keywords of ``cfg``'s (a ``ModelConfig``)
    aggregation: ``bucket_merge`` under ``spmm_impl="bucket"``, ``block``
    under ``"block"`` (the width hint: the widest graph layer's input, JAX
    ``_use_block``; every layer of the port is a graph layer), none
    otherwise and for GAT (its attention aggregates by CSR on every
    impl)."""
    if cfg.model == "gat":
        return {}
    if cfg.spmm_impl == "bucket":
        return {"bucket_merge": cfg.bucket_merge}
    if cfg.spmm_impl == "block":
        return {"block": (cfg.block_tile, max(cfg.layer_sizes[:cfg.n_layers]),
                          cfg.block_nnz, cfg.block_group)}
    return {}


def table_spmm(data: StagedGraph, cfg, transport: bool = False,
               plain: bool = False, share=None
               ) -> Optional[Callable[..., torch.Tensor]]:
    """The partitioned aggregation ``(fbuf, indptr, src, in_deg) -> mean``
    through ``data``'s bucket or block tables, as ``cfg`` picks them (JAX
    ``make_device_spmm_closure``): the block tables (K12, or K16 at
    ``block_group > 1``, plus K9 on the remainder) or the bucket tables
    (K9), with the gather transport (``cfg.rem_dtype``, ``cfg.rem_amax``,
    values shared through ``share``) unless ``transport`` is False;
    ``plain`` runs the plain versions. None where ``cfg`` aggregates by
    CSR (xla, GAT). Raises when ``data`` lacks the tables ``cfg`` names."""
    kw = aggregation_tables(cfg)
    if not kw:
        return None
    tabs = data.block if "block" in kw else data.bucket
    if tabs is None:
        raise ValueError(
            f"spmm_impl={cfg.spmm_impl!r} aggregates through the "
            f"{cfg.spmm_impl} tables, which this staged graph lacks: "
            "stage(..., **aggregation_tables(cfg))")
    if "block" in kw and (tabs.tile, tabs.group) != (cfg.block_tile,
                                                     cfg.block_group):
        raise ValueError(
            f"the staged block tables have tile {tabs.tile} and group "
            f"{tabs.group}; the config asks for {cfg.block_tile} and "
            f"{cfg.block_group}")
    agg = block_spmm if "block" in kw else bucket_spmm
    rem_dtype = cfg.rem_dtype if transport else None
    rem_amax = cfg.rem_amax and transport
    share = share if transport else None

    def spmm_fn(fbuf, indptr, src, in_deg):
        return agg(fbuf, tabs, in_deg, rem_dtype, rem_amax, plain, share)
    return spmm_fn


def precompute_pp(
        data: StagedGraph,
        exchange: Callable[..., torch.Tensor] = halo_exchange,
        spmm_fn: Callable[..., torch.Tensor] = spmm_mean) -> torch.Tensor:
    """One halo exchange + mean aggregation of the raw features, returned
    as ``concat([feat, mean_neigh], -1)`` ``[P, n_max, 2F]`` so layer 0
    needs no communication (``Trainer._precompute_pp``). ``exchange`` and
    ``spmm_fn`` default to the kernel wrappers (K2, K1); a caller holding
    the kernels against their plain versions passes the plain ones. Runs
    without autograd: the concat is a constant of training."""
    with torch.no_grad():
        fbuf = exchange(data.feat, data.send_idx, data.send_mask)
        ah = spmm_fn(fbuf, data.indptr, data.edge_src, data.in_deg)
        return torch.cat([data.feat, ah.to(data.feat.dtype)], dim=-1)
