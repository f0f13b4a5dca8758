"""Sharded inference engine — port of ``pipegcn_tpu/serve/engine.py``
(``ServingEngine``: ``refresh``, ``query``, ``warmup``, ``load_params``,
the layer-0 halo cache and the owner-gather query).

The JAX engine runs one shard per device under ``shard_map``; here the P
parts are stacked on one card (``parallel/staging.py``) and the ring
exchange is kernel K2. State owned by the engine:

  _feat   [P, n_max, F]     the model input: the use_pp concat
                            ``[feat, mean_neigh]``, else the raw features
  _halo0  [P, (P-1)*B, F]   layer-0 halo cache (use_pp off only; under
                            use_pp layer 0 never exchanges)
  _logits [P, n_max, C]     f32 logits of every owned node

Feature updates (``apply_updates``) and topology deltas wait for a later
slice (the dirty-row exchange, kernel B11); under use_pp the JAX engine
refuses them too.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..models.sage import ModelConfig, Params, forward
from ..parallel.halo import exchange_blocks, halo_exchange
from ..parallel.staging import StagedGraph, precompute_pp
from ..partition.halo import ShardedGraph
from .batcher import MicroBatcher, ServingStats, bucket_ladder


class ServingEngine:
    """Persistent stacked-parts inference over one staged artifact."""

    def __init__(self, sg: ShardedGraph, data: StagedGraph,
                 cfg: ModelConfig, params: Params, *, max_batch: int = 64,
                 ladder_min: int = 8):
        if cfg.model != "graphsage":
            raise NotImplementedError(
                f"serving {cfg.model} waits for ROADMAP A5 (the engine "
                "runs the graphsage forward)")
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"serving at dtype {cfg.dtype!r} (bf16 compute) waits for "
                "ROADMAP A5 (the engine serves float32)")
        self.cfg = cfg
        self.data = data
        self.device = data.device
        self.P = data.num_parts
        self.n_max = data.n_max
        self.n_class = int(cfg.layer_sizes[-1])
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

        # ---------------- device state --------------------------------
        if cfg.use_pp:
            self._feat = precompute_pp(data)
            self._halo0 = None
        else:
            self._feat = data.feat
            # the layer-0 halo cache starts fully fresh
            self._halo0 = exchange_blocks(self._feat, data.send_idx,
                                          data.send_mask)

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

    # ---------------- refresh -----------------------------------------

    def _comm_update(self, i: int, h: torch.Tensor) -> torch.Tensor:
        # the first exchanged layer consumes the resident halo cache;
        # deeper layers exchange live. Under use_pp layer 0 never
        # exchanges, so every call is live.
        if not self.cfg.use_pp and i == 0:
            return torch.cat([h, self._halo0.to(h.dtype)], dim=1)
        return halo_exchange(h, self.data.send_idx, self.data.send_mask)

    def refresh(self) -> None:
        """Recompute the full logits of every part."""
        d = self.data
        with torch.inference_mode():
            self._logits = forward(self._params, self.cfg, self._feat,
                                   d.indptr, d.edge_src, d.in_deg,
                                   comm_update=self._comm_update)

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
        if stats is not None:
            # no update path yet: every served logit is fully fresh
            stats.note_serve(ids.size, True, 0)
            stats.note_params(self.param_generation, self.param_staleness)
        return out

    def apply_updates(self, node_ids, values) -> int:
        raise NotImplementedError(
            "feature updates (the dirty-row halo exchange) wait for a "
            "later slice of the port")

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
