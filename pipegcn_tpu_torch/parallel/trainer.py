"""Full-graph training over P parts stacked on one card — port of
``pipegcn_tpu/parallel/trainer.py`` (``TrainConfig``, ``Trainer``: the
vanilla and pipelined step of ``_build_step``, ``train_epoch``,
``evaluate``, ``host_state`` and a reduced ``fit``).

The semantics are those of the JAX ``TrainConfig.emulate_parts=True``
(``trainer.py:144-153``, its vmap step at ``:1327-1357``): the P parts run
as one program on one device. Where the JAX step keeps P stacked copies
of the parameters that its psum'd update keeps identical, the port keeps
one parameter set; differentiating the sum of the parts' CE losses with
respect to it is the psum of the per-part gradients (``:1226-1233``).

One epoch (``train_epoch``):
  1. forward over the stacked parts; every graph layer's ``comm_update``
     is the differentiable exchange (vanilla: K2 forward, K5 + K4
     backward) or the staleness-1 concat of last epoch's halo rows
     (pipelined: its backward injects last epoch's boundary gradients
     with K4 and hands this epoch's halo cotangent to a zero ``probe``);
  2. CE-sum over all parts; 3. backward (``torch.autograd.grad`` over the
  params and the probes); 4. gradients / ``n_train_global``; 5. Adam.
  Then, pipelined, per exchanged layer: the new halo is K2 of the
  detached layer input (shipped during the forward), the new boundary
  gradient K5 of this epoch's probe cotangent, and the ``feat_corr`` /
  ``grad_corr`` EMAs (``:1271-1310``).

With ``spmm_impl="block"`` (graphsage, gcn; JAX ``_use_block``,
``trainer.py:452-468``) the trainer builds the block tables at the widest
graph layer's input as the width hint and aggregates through
``ops.block_spmm.BlockSpmm`` (K12 forward, K13 backward over the dense
tiles; K9 with the ``rem_dtype`` transport over the remainder), the
use_pp precompute through the same tables with the transport off, and
the full-graph eval on K1, as on the bucket path.

With ``spmm_impl="bucket"`` (graphsage, gcn; JAX ``_setup_spmm`` /
``_use_bucket``, ``trainer.py:365-450``) every graph layer aggregates
through the bucket tables (``ops.bucket_spmm.BucketSpmm``: K9, with the
``rem_dtype`` transport cast K10 and the ``rem_amax`` amax K11); the
use_pp precompute goes through the same tables with the transport off
(``transport=False``, ``trainer.py:918-1008``), and the full-graph eval
stays on K1 over the eval graph's CSR (the JAX ``_eval_run`` aggregates
raw edges with ``spmm_mean``).

GAT aggregates through its attention kernels on every impl; under
``bucket`` or ``auto`` (the JAX trainer's attention-bucket path,
``make_device_gat_fn``) its z rows travel in ``rem_dtype`` (e4m3 / bf16)
into K6 and K8, its cotangent rows in e5m2 / bf16 into K8 (the casts are
K10), and the eval runs without the transport, as in JAX.

With ``dtype="bfloat16"`` (``ModelConfig.compute_dtype``) the features are
cast to bf16 after the f32 use_pp precompute, the halo and boundary-
gradient carries are bf16 and the feat/grad-correction EMAs f32, cast at
use (JAX ``_init_comm``, ``trainer.py:225-231``, ``:1138-1148``). The
epoch and the eval run their bf16 matrix products with cuBLAS's reduced-
precision reduction off (and TF32 off), so that a bf16 product is the f32
sum rounded once, as XLA computes it.

With ``halo_dtype`` (``--halo-dtype``; pipelined only, as JAX
``trainer.py:1065-1069``) each layer's halo exchange and boundary-gradient
return cross the compressed wire (``parallel/halo.py``: K14 the block
amaxes, K15 the encode, ring copy and decode; e4m3 features and e5m2
boundary gradients under float8, bf16 both ways under bfloat16); the
carries stay in the compute dtype. ``est_halo_bytes_per_epoch`` counts the
wire's bytes as the JAX trainer does.

With ``integrity_check_every`` N > 0 (``--integrity-check-every``; JAX
``trainer.py:137-143``) ``fit`` drives the integrity plane
(``resilience/integrity.py``: K19 digests of the static data, params and
carry, and Freivalds through the step's own aggregation at F = 1) at every
boundary and deeply every N epochs, recovers by target class (tables
rebuilt from the host artifact, the carry flushed, params rolled back),
injects ``--fault-plan bitflip@E:<class>`` flips first, and the pipelined
epoch's exchanges and returns carry the wire checksum lane
(``parallel/halo.py`` ``guard=True``), their mismatching blocks summed in
``wire_bad`` and harvested after the step.

Dropout masks come from a ``torch.Generator`` seeded from (seed, epoch),
so ``train_epoch(e)`` is reproducible; the bits differ from JAX's
(``jax.random`` folds the epoch and the rank into a key), so runs held
against the JAX trainer use dropout 0.

Not ported (``NotImplementedError`` naming the ROADMAP item): fused epochs
and epoch blocks, the comm prefetch, loss scaling,
the numerics tripwire, other RNG
implementations and mask reuse, streaming, checkpoints and sharded eval.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph.csr import Graph
from ..models.sage import ModelConfig, Params, forward, init_params
from ..ops.bucket_spmm import TransportShare
from ..ops.gat import gat_attention, gat_attention_plain
from ..ops.spmm import spmm_mean, spmm_mean_plain
from ..ops.digest import flip_bit_
from ..partition.halo import ShardedGraph
from ..resilience.integrity import IntegrityPlane, is_table, static_tensors
from ..train.losses import cross_entropy_sum
from ..train.metrics import calc_acc
from ..train.optim import adam_init, adam_update
from ..tree import tree_leaves, tree_map, tree_numpy
from .halo import (KERNELS, PLAIN, exchange_blocks, halo_exchange,
                   halo_transport_dtypes, make_stale_concat)
from .staging import aggregation_tables, precompute_pp, stage, table_spmm


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``pipegcn_tpu.parallel.trainer.TrainConfig`` the port
    runs; the rest keep the JAX names and defaults only to be refused."""

    lr: float = 1e-2
    weight_decay: float = 0.0
    n_epochs: int = 100
    enable_pipeline: bool = False
    feat_corr: bool = False
    grad_corr: bool = False
    corr_momentum: float = 0.95
    log_every: int = 10
    seed: int = 0
    eval: bool = True
    fused_epochs: int = 1
    epoch_block: int = 0
    halo_dtype: str = "none"
    comm_prefetch: bool = False
    loss_scale: str = "off"
    integrity_check_every: int = 0
    numerics_tripwire: bool = False
    rng_impl: str = "threefry"
    dropout_reuse: int = 0

    def __post_init__(self):
        refused = [
            (self.fused_epochs > 1 or self.epoch_block > 1,
             "fused epochs / epoch blocks (ROADMAP A6, CUDA graphs)"),
            (self.comm_prefetch, "the layer-0 comm prefetch (ROADMAP A6)"),
            (self.loss_scale != "off", "loss scaling (ROADMAP A9)"),
            (self.numerics_tripwire, "the numerics tripwire (ROADMAP A9)"),
            (self.rng_impl != "threefry" or self.dropout_reuse > 1,
             "other dropout RNGs and mask reuse (ROADMAP A6)"),
        ]
        for bad, what in refused:
            if bad:
                raise NotImplementedError(f"{what} is not ported yet")
        if self.halo_dtype not in ("none", "bfloat16", "float8"):
            raise ValueError(f"unknown halo_dtype: {self.halo_dtype!r} "
                             "(none | bfloat16 | float8)")


@contextlib.contextmanager
def exact_matmuls():
    """cuBLAS products as XLA computes them: no TF32 for f32, and no
    reduced-precision reduction inside bf16 GEMMs (PyTorch allows it by
    default), so a bf16 product is ``round_bf16`` of its f32 sum. Sets
    the two process-wide flags for the duration and restores them."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def epoch_generator(seed: int, epoch: int,
                    device: torch.device) -> torch.Generator:
    """The dropout generator of one epoch: seeded from (seed, epoch)
    through a SeedSequence, so epochs draw independent masks and a rerun
    of an epoch draws the same ones."""
    s = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


class Trainer:
    """Owns the staged graph, the parameters, Adam and the comm carry of
    one training run on one device (``device``: CUDA runs the kernels,
    the CPU their plain versions). ``params`` (the port's layout, e.g.
    ``params_from_jax`` of a JAX trainer's) start the run; otherwise it
    draws its own init from ``tcfg.seed``. Setting ``plain`` runs every
    kernel's plain version on any device from then on (and sets ``attn``,
    GAT's attention op ``(z, el, er, indptr, src, transpose, slope) ->
    out``, to the kernels' or the plain versions'), and ``act`` (relu) is
    the training forward's nonlinearity between layers — the card-side
    comparison of a training step sets all three, and with a gather
    transport or a halo wire ``share``, the ``TransportShare`` its casts
    and wire payloads record into or replay from (None: neither).
    ``eval_cache`` holds the device CSRs of the full-graph eval, by
    graph; trainers on one device may share it."""

    def __init__(self, sg: ShardedGraph, cfg: ModelConfig,
                 tcfg: TrainConfig, device: torch.device,
                 params: Optional[Params] = None):
        if tcfg.halo_dtype != "none" and not tcfg.enable_pipeline:
            # JAX trainer.py:1065-1069: the vanilla exchange is
            # differentiated, and a lossy wire there would bias gradients
            raise ValueError(
                "halo_dtype compression requires enable_pipeline: the "
                "vanilla exchange is differentiated and must stay exact")
        self.sg, self.cfg, self.tcfg = sg, cfg, tcfg
        self.device = device
        self.P = sg.num_parts
        self.plain = False
        self.act = torch.relu
        self.share: Optional[TransportShare] = None
        self.bucket = cfg.spmm_impl == "bucket" and cfg.model != "gat"
        self.block = cfg.spmm_impl == "block" and cfg.model != "gat"
        # the host-built tables, kept for the integrity plane's rebuild
        # only (JAX _cached_tables); None: built, staged and dropped
        self._host_tables = {} if tcfg.integrity_check_every > 0 else None
        self._stage_static()
        self.n_train = float(self.data.n_train_global)
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(
                tcfg.seed), device)
        self.params = tree_map(
            lambda t: t.detach().to(device, torch.float32).clone()
            .requires_grad_(True), params)
        self._leaves = tree_leaves(self.params)
        self.opt = adam_init(self.params)
        self.glayers = list(range(1 if cfg.use_pp else 0, cfg.n_layers))
        self.comm = self._init_comm()
        self._grad_norm: Optional[torch.Tensor] = None  # 0-d, on device
        self.last_grads: List[torch.Tensor] = []  # reduced, leaf order
        self.eval_cache: Dict[int, Dict[str, Any]] = {}
        self.eval_setup_s = 0.0  # host seconds building eval-graph CSRs
        # the last epoch's summed wire-lane mismatches (0-d, on device;
        # None when the lane is off)
        self.wire_bad: Optional[torch.Tensor] = None
        self.last_epoch = 0

    def _stage_static(self) -> None:
        """Stage the graph (``data``: the arrays, the inverses and the
        bucket or block tables) and the step's features (``feat``: the
        use_pp concat, in the compute dtype) from the host artifact."""
        cfg = self.cfg
        self.data = stage(self.sg, self.device, training=True,
                          tables=self._host_tables,
                          **aggregation_tables(cfg))
        if cfg.use_pp:
            self.feat = precompute_pp(
                self.data,
                exchange=lambda h, i, m: halo_exchange(
                    h, i, m, ops=self._halo_ops),
                spmm_fn=self._step_spmm(transport=False))
        else:
            self.feat = self.data.feat
        # stored in the compute dtype after the f32 precompute (JAX
        # trainer.py:225-231)
        self.feat = self.feat.to(cfg.compute_dtype)

    @property
    def gat_transport(self) -> Optional[str]:
        """GAT's gather transport: ``rem_dtype`` on its attention-bucket
        path (``bucket``, ``auto``) only, as in JAX."""
        cfg = self.cfg
        if cfg.model == "gat" and cfg.spmm_impl in ("bucket", "auto"):
            return cfg.rem_dtype
        return None

    @property
    def plain(self) -> bool:
        return self._halo_ops is PLAIN

    @plain.setter
    def plain(self, value: bool) -> None:
        self._halo_ops = PLAIN if value else KERNELS
        self._spmm = spmm_mean_plain if value else spmm_mean
        self.attn = gat_attention_plain if value else gat_attention

    def _step_spmm(self, transport: bool):
        """The partitioned aggregation ``(fbuf, indptr, src, in_deg) ->
        mean``: the block or bucket tables (with the gather transport
        unless ``transport`` is False; ``staging.table_spmm``) or the
        part's CSRs."""
        d = self.data
        fn = table_spmm(d, self.cfg, transport, self.plain, self.share)
        if fn is not None:
            return fn

        def spmm_fn(fbuf, indptr, src, in_deg):
            return self._spmm(fbuf, indptr, src, in_deg, d.transpose)
        return spmm_fn

    def est_halo_bytes_per_epoch(self, compressed: bool = True) -> int:
        """Halo wire bytes an epoch (JAX ``est_halo_bytes_per_epoch``):
        every exchanged graph layer ships each part's halo block forward
        and its boundary gradients back, ``2 P H F_i`` elements, at the
        compute dtype's size or, with ``compressed`` (the default), the
        ``--halo-dtype`` wire's (1 byte under float8, at most 2 under
        bfloat16)."""
        if self.P == 1:
            return 0
        item = 4 if self.cfg.compute_dtype == torch.float32 else 2
        if compressed:
            if self.tcfg.halo_dtype == "float8":
                item = 1
            elif self.tcfg.halo_dtype == "bfloat16":
                item = min(item, 2)
        start = 1 if self.cfg.use_pp else 0
        return int(sum(2 * self.P * self.sg.halo_size
                       * self.cfg.layer_sizes[i] * item
                       for i in range(start, self.cfg.n_layers)))

    @property
    def grad_norm(self) -> Optional[float]:
        """Global L2 norm of the last epoch's reduced gradients."""
        return None if self._grad_norm is None else float(self._grad_norm)

    # ---------------- comm carry --------------------------------------

    def _init_comm(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{'halo', 'bgrad'[, 'favg', 'bavg']}[str(i)]``, each
        ``[P, H, F_i]`` zeros, for the graph layers that exchange (layer 0
        is skipped under use_pp) — the JAX ``_init_comm`` layout. halo and
        bgrad in the compute dtype, the EMAs in f32 (so that the small
        (1 - momentum) updates do not vanish in bf16)."""
        tc = self.tcfg
        if not tc.enable_pipeline:
            return {}
        groups = ["halo", "bgrad"] + (["favg"] if tc.feat_corr else []) \
            + (["bavg"] if tc.grad_corr else [])
        H = self.data.halo_size
        cdt = self.cfg.compute_dtype
        return {grp: {str(i): torch.zeros(
                    (self.P, H, self.cfg.layer_sizes[i]),
                    dtype=cdt if grp in ("halo", "bgrad") else torch.float32,
                    device=self.device)
                    for i in self.glayers} for grp in groups}

    def reset_comm(self) -> None:
        """Zero the pipelined carry: the next epoch consumes zero halos as
        epoch 0 does (JAX ``reset_comm``; the integrity plane's flush)."""
        self.comm = self._init_comm()

    # ---------------- the step ----------------------------------------

    def train_epoch(self, epoch: int) -> float:
        """One epoch; returns ``sum of the parts' CE / n_train`` (the JAX
        step's ``psum(loss) / n_train``) and keeps ``grad_norm``."""
        with exact_matmuls():
            return self._train_epoch(epoch)

    def _train_epoch(self, epoch: int) -> float:
        d, cfg, tc = self.data, self.cfg, self.tcfg
        cdt = cfg.compute_dtype
        ops = self._halo_ops
        pipeline = tc.enable_pipeline
        # the wire checksum lane: pipelined only, as JAX trainer.py:1087
        guard = pipeline and tc.integrity_check_every > 0
        wire_bad: List[torch.Tensor] = []
        feat_dt = halo_transport_dtypes(tc.halo_dtype)[0]
        probes: Dict[str, torch.Tensor] = {}
        fresh: Dict[str, torch.Tensor] = {}
        if pipeline:
            stale_concat = make_stale_concat(*d.inverse, ops=ops)
            H = d.halo_size
            probes = {str(i): torch.zeros(
                (self.P, H, cfg.layer_sizes[i]), dtype=cdt,
                device=self.device, requires_grad=True)
                for i in self.glayers}

            def comm_update(i: int, h: torch.Tensor) -> torch.Tensor:
                k = str(i)
                # the f32 EMAs enter in the compute dtype
                stale_halo = self.comm["favg"][k].to(cdt) if tc.feat_corr \
                    else self.comm["halo"][k]
                stale_bgrad = self.comm["bavg"][k].to(cdt) \
                    if tc.grad_corr else self.comm["bgrad"][k]
                fbuf = stale_concat(h, stale_halo, stale_bgrad, probes[k])
                # this epoch's exchange, consumed next epoch, across the
                # feature wire under halo_dtype
                fresh[k] = exchange_blocks(h.detach(), d.send_idx,
                                           d.send_mask, feat_dt, ops=ops,
                                           share=self.share, guard=guard)
                if guard:
                    fresh[k], bad = fresh[k]
                    wire_bad.append(bad)
                return fbuf
        else:
            def comm_update(i: int, h: torch.Tensor) -> torch.Tensor:
                return halo_exchange(h, d.send_idx, d.send_mask, d.inverse,
                                     ops=ops)

        spmm_fn = self._step_spmm(transport=True)

        def attn_fn(z, el, er):
            return self.attn(z, el, er, d.indptr, d.edge_src, d.transpose,
                             cfg.leaky_slope, rem_dtype=self.gat_transport,
                             share=self.share)

        gen = epoch_generator(tc.seed, epoch, self.device) \
            if cfg.dropout > 0 else None
        logits = forward(self.params, cfg, self.feat, d.indptr, d.edge_src,
                         d.in_deg, comm_update=comm_update, spmm_fn=spmm_fn,
                         attn_fn=attn_fn, training=True, generator=gen,
                         act=self.act)
        loss = cross_entropy_sum(logits, d.label, d.train_mask)
        keys = sorted(probes)
        grads = torch.autograd.grad(
            loss, self._leaves + [probes[k] for k in keys])
        n = len(self._leaves)
        with torch.no_grad():
            pgrads = [g / self.n_train for g in grads[:n]]
            self.last_grads = pgrads
            # stays on the device: read through ``grad_norm`` on demand,
            # so Adam and the carry update queue with no host round trip
            self._grad_norm = torch.sqrt(sum(
                (g.float() ** 2).sum() for g in pgrads))
            adam_update(pgrads, self.opt, self.params, lr=tc.lr,
                        weight_decay=tc.weight_decay)
            if pipeline:
                self._update_comm(fresh, dict(zip(keys, grads[n:])),
                                  wire_bad if guard else None)
            self.wire_bad = sum(wire_bad, torch.zeros(
                (), dtype=torch.int64, device=self.device)) if guard else None
            return float(loss / self.n_train)

    def _update_comm(self, fresh: Dict[str, torch.Tensor],
                     probe_grads: Dict[str, torch.Tensor],
                     wire_bad: Optional[List[torch.Tensor]] = None) -> None:
        tc, b_max = self.tcfg, self.data.b_max
        m = tc.corr_momentum
        comm = self.comm
        bgrad_dt = halo_transport_dtypes(tc.halo_dtype)[1]
        for k in fresh:
            # this epoch's halo cotangents to their owners, across the
            # boundary-gradient wire under halo_dtype (with the checksum
            # lane when ``wire_bad`` collects it)
            bg = self._halo_ops.ret(probe_grads[k], b_max, bgrad_dt,
                                    self.share, guard=wire_bad is not None)
            if wire_bad is not None:
                bg, bad = bg
                wire_bad.append(bad)
            comm["halo"][k] = fresh[k]
            comm["bgrad"][k] = bg
            if tc.feat_corr:
                comm["favg"][k] = m * comm["favg"][k] + (1 - m) * fresh[k]
            if tc.grad_corr:
                comm["bavg"][k] = m * comm["bavg"][k] + (1 - m) * bg

    # ---------------- evaluation --------------------------------------

    def _full_eval_cache(self, g: Graph) -> Dict[str, Any]:
        key = id(g)
        if key not in self.eval_cache:
            t0 = time.perf_counter()
            n = g.num_nodes
            dev = self.device
            # dst-sorted CSR of the eval graph: a stable sort (the
            # permutation of the JAX trainer's native stable_argsort), on
            # the device, where a 100M-edge sort takes a fraction of the
            # host's seconds
            dst, order = torch.sort(torch.from_numpy(
                np.ascontiguousarray(g.dst)).to(dev), stable=True)
            if dst.numel() and (int(dst[0]) < 0 or int(dst[-1]) >= n):
                raise ValueError(f"eval graph dst outside [0, {n})")
            indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
            torch.cumsum(torch.bincount(dst, minlength=n), 0,
                         out=indptr[1:])
            if dst.numel() < 2 ** 31:
                indptr = indptr.to(torch.int32)
            src = torch.from_numpy(np.ascontiguousarray(g.src)).to(dev)
            self.eval_cache[key] = {
                "graph": g,  # strong ref: keeps id(g) valid while cached
                "feat": torch.from_numpy(np.ascontiguousarray(
                    g.ndata["feat"], np.float32))[None].to(dev),
                "indptr": indptr[None],
                "src": src[order].to(torch.int32)[None],
                "in_deg": torch.from_numpy(np.maximum(
                    g.in_degrees(), 1).astype(np.float32))[None].to(dev),
            }
            self.eval_setup_s += time.perf_counter() - t0
        return self.eval_cache[key]

    def eval_logits(self, g: Graph, params: Optional[Params] = None
                    ) -> torch.Tensor:
        """Full-graph logits ``[N, n_class]`` of ``g`` on this device (the
        JAX emulated trainer's eval: P = 1, no halo, ``in_deg = max(deg,
        1)`` of ``g``, use_pp layer 0 as ``cat(feat, mean(feat)) @ W``;
        GAT attends over ``g``'s own edges)."""
        c = self._full_eval_cache(g)

        def attn_fn(z, el, er):
            return self.attn(z, el, er, c["indptr"], c["src"], None,
                             self.cfg.leaky_slope)

        with torch.no_grad(), exact_matmuls():
            out = forward(self.params if params is None else params,
                          self.cfg, c["feat"], c["indptr"], c["src"],
                          c["in_deg"], spmm_fn=self._spmm, attn_fn=attn_fn,
                          eval_pp_agg=self.cfg.use_pp)
        return out[0]

    def evaluate(self, g: Graph, mask_key: str,
                 params: Optional[Params] = None) -> float:
        """Accuracy (micro-F1 for multilabel) of the full-graph eval of
        ``g`` over the rows of ``g.ndata[mask_key]``."""
        logits = self.eval_logits(g, params).cpu().numpy()
        m = np.asarray(g.ndata[mask_key])
        return calc_acc(logits[m], np.asarray(g.ndata["label"])[m])

    # ---------------- state -------------------------------------------

    def host_state(self) -> Dict[str, Any]:
        """params, opt and comm as numpy in the JAX trainer's layout
        (``{'params', 'opt': {'mu', 'nu', 'step'}, 'norm': [], 'comm'}``),
        without the emulated trainer's stacked ``[P]`` parameter copies."""
        return {
            "params": tree_numpy(self.params),
            "opt": {"mu": tree_numpy(self.opt["mu"]),
                    "nu": tree_numpy(self.opt["nu"]),
                    "step": np.int32(self.opt["step"])},
            "norm": [],
            "comm": tree_numpy(self.comm),
        }

    def restore_state(self, host_state: Dict[str, Any]) -> None:
        """Put a :meth:`host_state` back (params and moments in place,
        the comm carry anew, each buffer in its dtype)."""
        with torch.no_grad():
            for dst, src in zip(
                    tree_leaves([self.params, self.opt["mu"],
                                 self.opt["nu"]]),
                    tree_leaves([host_state["params"],
                                 host_state["opt"]["mu"],
                                 host_state["opt"]["nu"]])):
                dst.copy_(torch.from_numpy(np.asarray(src)))
        self.opt["step"] = int(host_state["opt"]["step"])
        self.comm = {
            grp: {k: torch.from_numpy(np.array(a)).to(
                self.device, self.comm[grp][k].dtype)
                for k, a in bufs.items()}
            for grp, bufs in host_state["comm"].items()}

    # ---------------- integrity plane (resilience/integrity.py) -------

    def _rebuild_static_data(self, dirty=None) -> int:
        """Restage the static data (the graph's arrays, the bucket or block
        tables, the use_pp features) from the host artifact, its tables
        from ``_host_tables`` when the plane is armed and built again when
        not: the scrub's recovery (JAX ``_rebuild_static_data``, whose
        tables come from ``_cached_tables``). The port restages every
        part; the count
        returned is JAX's (the dirty parts under bucket, every part
        otherwise)."""
        self.data = None  # the old copy goes before the new one is staged
        self._stage_static()
        if self.bucket and dirty:
            return len(dirty)
        return self.P

    def _replace_static(self, name: str, t: torch.Tensor) -> None:
        """Put ``t`` in place of the static tensor ``name`` (a
        ``static_tensors`` key: ``feat`` or a dotted path into ``data``)."""
        if name == "feat":
            self.feat = t
            return
        *path, leaf = name.split(".")
        obj = self.data
        for p in path:
            obj = getattr(obj, p)
        setattr(obj, leaf, t)

    def _inject_bitflip(self, target: str, epoch: int, log_fn) -> bool:
        """The chaos lane's SDC injection (``bitflip@E:<target>``): flip one
        bit of the element of the named state class that the JAX trainer
        flips (``trainer.py:819-887``): bit 11 of element ``epoch`` of the
        first params leaf (JAX's flatten order) and bit 7 of the first key
        of the halo group or of the first other carry group, in place; bit
        3 of the first kernel table (``send_idx`` without tables) in a
        copy put in its place. The kernels are never altered."""
        if target == "params":
            flip_bit_(self._leaves[0].detach(), bit=11, index=epoch)
            return True
        if target in ("carry", "halo"):
            comm = self.comm or {}
            group = ("halo" if target == "halo" else
                     next((k for k in sorted(comm) if k != "halo"), None))
            sub = comm.get(group) if group else None
            if not sub:
                log_fn(f"bitflip:{target} at epoch {epoch} skipped: "
                       f"pipelined carry not enabled")
                return False
            flip_bit_(sub[sorted(sub)[0]], bit=7, index=epoch)
            return True
        if target == "tables":
            named = static_tensors(self)
            key = next((k for k in named if is_table(k)), "send_idx")
            # a flipped copy in its place, as JAX device_puts one: a CPU
            # tensor may share its memory with the host artifact
            self._replace_static(key, flip_bit_(named[key].clone(), bit=3,
                                                index=epoch))
            return True
        log_fn(f"bitflip:{target} at epoch {epoch} skipped: "
               f"unknown target class")
        return False

    def _recover(self, integ: IntegrityPlane, results, epoch: int,
                 last_good, log_fn, metrics) -> Optional[int]:
        """Recovery by the first mismatch's target class (JAX fit,
        ``trainer.py:2518-2610``); returns the epoch to roll back to for a
        params corruption, else None."""
        bad = [r for r in results if r.outcome == "mismatch"]
        target = bad[0].target
        dirty = sorted({int(s) for r in bad for s in r.dirty_shards})
        if metrics is not None:
            metrics.fault(kind="sdc", epoch=epoch, target=target,
                          source_rank=0, strikes=integ.total_detections(),
                          agreed=False)
        if target == "tables":
            n_reb = self._rebuild_static_data(dirty or None)
            integ.baseline(self)
            log_fn(f"integrity: rebuilt "
                   f"{'shards ' + str(dirty) if dirty else 'all shards'}"
                   f" from the host artifact at epoch {epoch}")
            if metrics is not None:
                metrics.recovery(kind="sdc", epoch=epoch, target=target,
                                 tables_rebuilt=n_reb, dirty_shards=dirty)
            return None
        if target in ("halo", "carry"):
            if self.tcfg.enable_pipeline:
                self.reset_comm()
            integ.drop_dynamic()
            log_fn(f"integrity: flushed pipelined carry at epoch {epoch} "
                   f"({target} corruption)")
            if metrics is not None:
                metrics.recovery(kind="sdc", epoch=epoch, target=target,
                                 flushed=True)
            return None
        rollback_to, good_state = last_good
        log_fn(f"integrity: params corruption at epoch {epoch}; rolling "
               f"back to epoch {rollback_to}")
        self.restore_state(good_state)
        self.last_epoch = rollback_to
        if self.tcfg.enable_pipeline:
            self.reset_comm()
        integ.drop_dynamic()
        if metrics is not None:
            metrics.recovery(kind="sdc", epoch=epoch, target=target,
                             rollback_epoch=rollback_to)
        return rollback_to

    def _harvest_wire(self, integ: IntegrityPlane, epoch: int, log_fn,
                      metrics) -> None:
        """The wire lane's count after a step (JAX ``trainer.py:2736-
        2770``): a mismatch counts a halo detection and flushes the
        carry."""
        wb_n = int(self.wire_bad)
        if not wb_n:
            return
        integ.detections["halo"] = integ.detections.get("halo", 0) + 1
        log_fn(f"integrity: halo wire checksum mismatch in {wb_n} distance "
               f"block(s) at epoch {epoch}; flushing carry")
        if metrics is not None:
            metrics.integrity(epoch=epoch, check="wire", outcome="mismatch",
                              target="halo", cadence=integ.check_every,
                              overhead_s=0.0, blocks=wb_n)
            metrics.fault(kind="sdc", epoch=epoch, target="halo",
                          check="wire", blocks=wb_n, agreed=False)
        if self.tcfg.enable_pipeline:
            self.reset_comm()
        integ.drop_dynamic()

    # ---------------- the epoch loop ----------------------------------

    def fit(self, eval_graphs: Optional[Dict[str, Tuple[Graph, str]]] = None,
            log_fn=print, *, inductive: bool = False,
            checkpoint_dir: Optional[str] = None, sharded_eval: bool = False,
            stream_plan=None, reference_logs: bool = False, metrics=None,
            fault_plan=None) -> Dict[str, Any]:
        """The epoch loop, reduced: a val evaluation every ``log_every``
        epochs (and at the end when the last epoch is off that grid),
        best-val params kept, test evaluated on them at the end. The
        reference train line prints every 10 epochs with
        ``reference_logs`` (the JAX CLI's cadence, that of the
        reference's ``train.py``), else every ``log_every`` epochs.
        Comm(s) and Reduce(s) print 0: on one card the exchange and the
        reduction are parts of the epoch, not separate collectives. Epoch
        times exclude the first 5 epochs, as the JAX ``fit`` does.

        Under ``integrity_check_every`` each boundary runs, in the JAX
        order: the ``fault_plan``'s bit flips (``resilience.FaultPlan``),
        the integrity checks (deep at the cadence), their ``integrity``
        records and the ``fault`` / ``recovery`` records on ``metrics``
        (an ``obs.MetricsLogger``), the recovery; after the step the wire
        lane's harvest, the rollback snapshot (every 25 epochs, JAX's
        ``SentinelConfig.snapshot_every``) and the dynamic digests. A
        params rollback re-runs epochs: ``losses`` lists every epoch
        run."""
        if checkpoint_dir or sharded_eval or stream_plan is not None:
            raise NotImplementedError(
                "checkpoints (ROADMAP A4), sharded eval (ROADMAP A4) and "
                "streaming (ROADMAP A9) are not ported yet")
        tc = self.tcfg
        do_eval = tc.eval and bool(eval_graphs) and "val" in eval_graphs
        best_val, best_params, best_epoch = 0.0, None, -1
        durs: List[float] = []
        losses: List[float] = []
        history = []

        def _eval(epoch: int, loss: float) -> None:
            nonlocal best_val, best_params, best_epoch
            acc = self.evaluate(*eval_graphs["val"])
            if inductive or "test" not in eval_graphs:
                log_fn(_eval_line(epoch, acc))
            else:
                log_fn(_eval_line(epoch, acc,
                                  self.evaluate(*eval_graphs["test"])))
            history.append((epoch + 1, loss, acc))
            if acc > best_val:
                best_val, best_epoch = acc, epoch + 1
                best_params = tree_map(lambda t: t.detach().clone(),
                                   self.params)

        integ, last_good = None, None
        if tc.integrity_check_every > 0:
            integ = IntegrityPlane(tc.integrity_check_every)
            integ.baseline(self)
            last_good = (0, self.host_state())
        epoch, loss = 0, float("nan")
        while epoch < tc.n_epochs:
            # ---- SDC chaos, then the detectors, before anything else
            # touches the state (JAX trainer.py:2171-2220) ----
            if fault_plan is not None:
                flip = fault_plan.due_str_arg("bitflip", epoch)
                if flip is not None and self._inject_bitflip(flip, epoch,
                                                             log_fn):
                    log_fn(f"fault-injected bitflip:{flip} at epoch {epoch}")
                    if metrics is not None:
                        metrics.fault(kind="injected", epoch=epoch,
                                      reason=f"bitflip:{flip}")
            if integ is not None:
                deep = integ.due(epoch)
                results = integ.run_checks(self, epoch, deep=deep)
                for res in results:
                    if res.outcome == "mismatch":
                        log_fn(f"integrity: {res.check} mismatch on "
                               f"{res.target} at epoch {epoch} "
                               f"({res.detail})")
                    # ok records only for the deep checks, as JAX
                    if metrics is not None and (
                            res.outcome == "mismatch" or deep):
                        metrics.integrity(
                            epoch=epoch, check=res.check,
                            outcome=res.outcome, target=res.target,
                            cadence=integ.check_every,
                            overhead_s=round(res.overhead_s, 6),
                            detail=res.detail,
                            dirty_shards=list(res.dirty_shards))
                if any(r.outcome == "mismatch" for r in results):
                    back = self._recover(integ, results, epoch, last_good,
                                         log_fn, metrics)
                    if back is not None:
                        epoch = back
                        continue
            t0 = time.perf_counter()
            loss = self.train_epoch(epoch)
            dur = time.perf_counter() - t0
            losses.append(loss)
            self.last_epoch = epoch + 1
            if epoch >= 5:
                durs.append(dur)
            if integ is not None:
                if self.wire_bad is not None:
                    self._harvest_wire(integ, epoch, log_fn, metrics)
                if epoch + 1 - last_good[0] >= 25:
                    last_good = (epoch + 1, self.host_state())
                integ.note_dynamic(self)
            line_every = 10 if reference_logs else tc.log_every
            if (epoch + 1) % line_every == 0:
                log_fn(_train_line(epoch, float(np.mean(durs or [dur])),
                                   loss))
            if (epoch + 1) % tc.log_every == 0 and do_eval:
                _eval(epoch, loss)
            epoch += 1
        epoch -= 1
        if do_eval and tc.n_epochs % tc.log_every != 0:
            _eval(epoch, loss)
        result = {
            "best_val": best_val, "best_epoch": best_epoch,
            "best_params": best_params, "losses": losses,
            "epoch_time": float(np.mean(durs)) if durs else None,
            "history": history,
        }
        if do_eval and "test" in eval_graphs and best_params is not None:
            result["test_acc"] = self.evaluate(*eval_graphs["test"],
                                               params=best_params)
        return result


def _train_line(epoch: int, time_s: float, loss: float) -> str:
    # the reference line (reference train.py:369-371, pinned in the JAX
    # package's obs/format.py); rank 0, no separate collectives
    return ("Process {:03d} | Epoch {:05d} | Time(s) {:.4f} | "
            "Comm(s) {:.4f} | Reduce(s) {:.4f} | Loss {:.4f}"
            .format(0, epoch, time_s, 0.0, 0.0, loss))


def _eval_line(epoch: int, val_acc: float,
               test_acc: Optional[float] = None) -> str:
    # reference evaluate_induc (train.py:33-39) / evaluate_trans (:54-60)
    if test_acc is None:
        return "Epoch {:05d} | Accuracy {:.2%}".format(epoch, val_acc)
    return ("Epoch {:05d} | Validation Accuracy {:.2%} | "
            "Test Accuracy {:.2%}".format(epoch, val_acc, test_acc))

