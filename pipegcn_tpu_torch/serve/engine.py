"""Sharded inference engine — port of ``pipegcn_tpu/serve/engine.py``
(``ServingEngine``: ``refresh``, ``query``, ``warmup``, ``load_params``,
the layer-0 halo cache, the owner-gather query and the freshness path:
``apply_updates``, ``refresh_boundary``, ``full_boundary_exchange``,
``staleness_age``, ``fully_fresh``).

The JAX engine runs one shard per device under ``shard_map``; here the P
parts are stacked on one card (``parallel/staging.py``), the ring
exchange is kernel K2 and the dirty-row exchange kernel K18. The refresh
and the use_pp precompute aggregate as the JAX engine does, through the
trainer's aggregation with the gather transport off
(``make_device_spmm_closure(transport=False)``, ``staging.table_spmm``):
K1 over the CSR under ``spmm_impl="xla"``, K9 over the bucket tables
under ``"bucket"``, K12 (K16 at ``block_group > 1``) over the dense tiles
plus K9 over the remainder under ``"block"``. The staged graph carries
the tables: :meth:`ServingEngine.build` stages them from the artifact,
or the caller hands in a trainer's staged data. State owned by the
engine:

  _feat   [P, n_max, F]     the model input: the use_pp concat
                            ``[feat, mean_neigh]``, else a private copy
                            of the raw features that updates patch in
                            place (the staged graph stays intact)
  _halo0  [P, (P-1)*B, F]   layer-0 halo cache in the SEND VIEW — compute
                            dtype, GCN degree pre-scale applied — exactly
                            the rows forward() would exchange at layer 0
                            (use_pp off only; under use_pp layer 0 never
                            exchanges)
  _logits [P, n_max, C]     f32 logits of every owned node

Staleness ledger (as JAX's): ``staleness_age`` counts applied update
batches whose effects the served logits do not yet reflect.
apply_updates bumps it; refresh() collapses it to the halo lag;
refresh_boundary() zeroes the halo lag. age == 0 <=> fully fresh <=> a
cache hit. Under use_pp updates are refused, as in JAX. Topology deltas
(JAX ``apply_graph_deltas``) wait for ROADMAP A9.

With ``integrity_check_every > 0`` (JAX reads the trainer's
``tcfg.integrity_check_every``; its serve CLI never sets it, nor does the
port's) the dirty-row exchange carries the wire guard
(``dirty_exchange(guard=True)``): a mismatch discards the merge, rebuilds
the halo by a full exchange and counts ``wire_bad_total``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..models.sage import ModelConfig, Params, forward
from ..ops.spmm import spmm_mean
from ..parallel.halo import exchange_blocks, halo_exchange
from ..parallel.staging import (StagedGraph, aggregation_tables,
                                precompute_pp, stage, table_spmm)
from ..partition.halo import ShardedGraph
from .batcher import MicroBatcher, ServingStats, bucket_ladder
from .cache import Layer0Cache
from .freshness import FreshnessTracker, dirty_exchange


class ServingEngine:
    """Persistent stacked-parts inference over one staged artifact."""

    def __init__(self, sg: ShardedGraph, data: StagedGraph,
                 cfg: ModelConfig, params: Params, *, max_batch: int = 64,
                 ladder_min: int = 8, integrity_check_every: int = 0):
        if cfg.spmm_impl == "auto":
            raise NotImplementedError(
                "serving spmm_impl='auto' (the measured tuner) waits for "
                "ROADMAP A6; pass xla, bucket or block")
        if cfg.model not in ("graphsage", "gcn"):
            raise NotImplementedError(
                f"serving {cfg.model} waits for ROADMAP A5 (the engine "
                "runs the graphsage and gcn forwards)")
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"serving at dtype {cfg.dtype!r} (bf16 compute) waits for "
                "ROADMAP A5 (the engine serves float32)")
        self.cfg = cfg
        self.data = data
        # the refresh's aggregation: the tables of cfg.spmm_impl with the
        # transport off (raises when data lacks them), else K1
        self._spmm = table_spmm(data, cfg) or spmm_mean
        self.device = data.device
        self.P = data.num_parts
        self.n_max = data.n_max
        self.n_class = int(cfg.layer_sizes[-1])
        self.n_feat_raw = int(sg.n_feat)
        self.ladder = bucket_ladder(ladder_min, max_batch)
        self.params_version = 0
        self.param_generation = -1
        self.param_staleness = 0
        self._params = params
        self._logits: Optional[torch.Tensor] = None

        # ---------------- host-side routing ---------------------------
        # global nid -> (partition, local row); -1 rows are padding
        nid = np.asarray(sg.global_nid)
        self.num_global_nodes = int((nid >= 0).sum())
        self._q_part = np.full(self.num_global_nodes, -1, np.int64)
        self._q_local = np.zeros(self.num_global_nodes, np.int64)
        for p in range(self.P):
            own = np.nonzero(nid[p] >= 0)[0]
            self._q_part[nid[p, own]] = p
            self._q_local[nid[p, own]] = own

        self.freshness = FreshnessTracker(self.P, self.n_max)
        self.cache = Layer0Cache(sg.send_idx, sg.send_mask)
        self.wire_guard = int(integrity_check_every) > 0
        self.wire_bad_total = 0
        # JAX's count of applied topology deltas (apply_graph_deltas, ROADMAP
        # A9): 0 while only features change, the epoch of a serving
        # integrity record, as JAX reports it for feature-only serving
        self.topo_generation = 0
        self._feat_lag = 0   # update batches not yet in _logits
        self._halo_lag = 0   # update batches whose boundary rows are not
        #                      yet in _halo0

        # ---------------- device state --------------------------------
        if cfg.use_pp:
            self._feat = precompute_pp(data, spmm_fn=self._spmm)
            self._halo0 = None
        else:
            # private copy: updates patch it in place, and the staged
            # graph's features must stay intact for any other user
            self._feat = data.feat.clone()
            # the layer-0 halo cache starts fully fresh
            self._halo0 = self.full_boundary_exchange()

    @classmethod
    def build(cls, sg: ShardedGraph, cfg: ModelConfig, params: Params,
              device: torch.device, tables: Optional[dict] = None,
              **kw) -> "ServingEngine":
        """Stage ``sg`` on ``device`` with the tables ``cfg``'s aggregation
        reads (the bucket or block tables; no training arrays) and build
        the engine over it. ``tables`` caches the host-built tables as
        ``staging.stage`` does; ``kw`` goes to the constructor."""
        return cls(sg, stage(sg, device, tables=tables,
                             **aggregation_tables(cfg)), cfg, params, **kw)

    # ---------------- params / warmup ---------------------------------

    def load_params(self, params: Params,
                    generation: Optional[int] = None) -> None:
        """Swap serving weights; logits are stale until the next
        refresh(). `generation` records the checkpoint epoch the params
        came from."""
        self._params = params
        self.params_version += 1
        self._logits = None
        if generation is not None:
            self.param_generation = int(generation)

    def warmup(self) -> float:
        """Run one refresh and one query per ladder bucket so the first
        live query pays no first-use cost (kernel build and load, cuBLAS
        handles). Returns seconds."""
        t0 = time.monotonic()
        if self._logits is None:
            self.refresh()
        for b in self.ladder:
            self._gather(np.full(b, -1, np.int64), np.zeros(b, np.int64))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic() - t0

    # ---------------- freshness path ----------------------------------

    def _send_view(self) -> torch.Tensor:
        """Exactly forward()'s layer-0 transform of the features before
        its exchange: the cast to the compute dtype, then (GCN) the f32
        ``1/sqrt(in_deg)`` pre-scale cast back, in forward's op order, so
        the cached halo equals a live exchange bit for bit."""
        h = self._feat.to(self.cfg.compute_dtype)
        if self.cfg.model == "gcn":
            d_sqrt = torch.sqrt(self.data.in_deg)[..., None]
            h = (h.float() / d_sqrt).to(self.cfg.compute_dtype)
        return h

    @property
    def staleness_age(self) -> int:
        return self._feat_lag

    @property
    def fully_fresh(self) -> bool:
        return self._feat_lag == 0

    def apply_updates(self, node_ids, values) -> int:
        """Patch owned-node features in place, mark the dirty-row bitmap
        and invalidate the layer-0 cache slots off the send lists.
        Returns the number of halo slots invalidated. A batch that repeats
        an id keeps its last row, resolved on the host (a scatter with
        repeated indices picks any writer on CUDA)."""
        if self.cfg.use_pp:
            raise ValueError(
                "feature updates are unsupported under use_pp: the "
                "precompute folds raw features into a precomputed "
                "aggregate; serve with use_pp off (or rebuild the "
                "engine) to ingest updates")
        ids = np.atleast_1d(np.asarray(node_ids, np.int64))
        vals = np.atleast_2d(np.asarray(values, np.float32))
        if vals.shape != (ids.size, self.n_feat_raw):
            raise ValueError(
                f"values must be [{ids.size}, {self.n_feat_raw}], "
                f"got {vals.shape}")
        if ids.size and (ids.min() < 0
                         or ids.max() >= self.num_global_nodes):
            raise ValueError("node id out of range")
        parts = self._q_part[ids]
        local = self._q_local[ids]
        # the last occurrence of each id wins
        _, first_of_reversed = np.unique(ids[::-1], return_index=True)
        last = ids.size - 1 - first_of_reversed
        if last.size:
            dev = self.device
            self._feat[torch.from_numpy(parts[last]).to(dev),
                       torch.from_numpy(local[last]).to(dev)] = \
                torch.from_numpy(vals[last]).to(dev, self._feat.dtype)
        self.freshness.mark(parts, local)
        touched = self.cache.invalidate_rows(parts, local)
        self._feat_lag += 1
        if touched:
            self._halo_lag += 1
        return touched

    def refresh_boundary(self, ml=None) -> int:
        """Replay the send-list exchange for the dirty rows only (K18),
        merging their fresh send-view rows into the resident halo cache in
        place: bit-identical to a full re-exchange. The dirty bitmap goes
        to the device once. Returns the stale slots refreshed; 0, and no
        launch, when no row is dirty. With the wire guard a checksum
        mismatch discards the merge and rebuilds the halo from a full
        exchange, recording an ``integrity`` event on ``ml`` (an
        ``obs.MetricsLogger``) when given."""
        if not self.freshness.any:
            return 0
        n = self.cache.n_stale
        d = self.data
        dirty = torch.from_numpy(self.freshness.dirty).to(self.device)
        if self.wire_guard:
            _, bad = dirty_exchange(self._send_view(), self._halo0, dirty,
                                    d.send_idx, d.send_mask, guard=True)
            wb = int(bad)
            if wb:
                self.wire_bad_total += wb
                # the merged halo is suspect: rebuild it from scratch
                self._halo0 = self.full_boundary_exchange()
                if ml is not None:
                    ml.integrity(epoch=self.topo_generation, check="wire",
                                 outcome="mismatch", target="halo",
                                 cadence=0, overhead_s=0.0, blocks=wb,
                                 detail="serving dirty-row exchange; halo "
                                        "rebuilt via full exchange")
        else:
            dirty_exchange(self._send_view(), self._halo0, dirty,
                           d.send_idx, d.send_mask)
        self.freshness.clear()
        self.cache.mark_fresh()
        self._halo_lag = 0
        return n

    def full_boundary_exchange(self) -> torch.Tensor:
        """The whole halo block from scratch (K2 over the send view): the
        reference the incremental path is held to."""
        d = self.data
        return exchange_blocks(self._send_view(), d.send_idx, d.send_mask)

    # ---------------- refresh -----------------------------------------

    def _comm_update(self, i: int, h: torch.Tensor) -> torch.Tensor:
        # the first exchanged layer consumes the resident halo cache;
        # deeper layers exchange live. Under use_pp layer 0 never
        # exchanges, so every call is live.
        if not self.cfg.use_pp and i == 0:
            return torch.cat([h, self._halo0.to(h.dtype)], dim=1)
        return halo_exchange(h, self.data.send_idx, self.data.send_mask)

    def refresh(self) -> None:
        """Recompute the full logits of every part from the current
        features and halo cache. Served staleness collapses to the halo
        lag."""
        d = self.data
        with torch.inference_mode():
            self._logits = forward(self._params, self.cfg, self._feat,
                                   d.indptr, d.edge_src, d.in_deg,
                                   comm_update=self._comm_update,
                                   spmm_fn=self._spmm)
        self._feat_lag = self._halo_lag

    @property
    def params(self) -> Params:
        return self._params

    @property
    def logits(self) -> Optional[torch.Tensor]:
        """``[P, n_max, C]`` logits of the last refresh (None before)."""
        return self._logits

    # ---------------- query path --------------------------------------

    def _gather(self, qp: np.ndarray, ql: np.ndarray) -> np.ndarray:
        # owner gather: row ql of part qp; padding entries (qp == -1)
        # read zeros, like the JAX query program's masked psum
        qp_t = torch.from_numpy(qp).to(self.device)
        ql_t = torch.from_numpy(ql).to(self.device)
        rows = self._logits[qp_t.clamp(min=0), ql_t]
        rows = torch.where((qp_t >= 0)[:, None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        return rows.cpu().numpy()

    def query(self, node_ids, stats: Optional[ServingStats] = None
              ) -> np.ndarray:
        """Logits for global node ids, [n, n_class] f32."""
        ids = np.atleast_1d(np.asarray(node_ids, np.int64))
        if ids.size and (ids.min() < 0
                         or ids.max() >= self.num_global_nodes):
            raise ValueError("node id out of range")
        if self._logits is None:
            self.refresh()
        out = self._gather(self._q_part[ids], self._q_local[ids])
        hit = self.fully_fresh
        self.cache.record_queries(ids.size, hit)
        if stats is not None:
            stats.note_serve(ids.size, hit, self.staleness_age)
            stats.note_params(self.param_generation, self.param_staleness)
        return out

    def make_batcher(self, stats: Optional[ServingStats] = None,
                     max_delay_ms: float = 5.0,
                     clock=time.monotonic,
                     observer=None) -> MicroBatcher:
        """A batcher over ``query``; each flushed batch goes to
        ``observer`` (default: ``stats.note_batch``)."""
        if observer is None and stats is not None:
            observer = stats.note_batch
        return MicroBatcher(
            run=lambda ids: self.query(ids, stats=stats),
            max_batch=self.ladder[-1], max_delay_ms=max_delay_ms,
            ladder_min=self.ladder[0], clock=clock, observer=observer)
