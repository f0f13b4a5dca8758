"""Online serving entry point: ``python -m pipegcn_tpu_torch.cli.serve``.

Port of ``pipegcn_tpu/cli/serve.py``: resolve (or, with ``--serve-build``,
build) the partition artifact, stage it on the device, build and warm the
ServingEngine, serve open-loop constant-rate traffic, and print the
summary as one final ``{"serve": true, ...}`` JSON line, as the JAX CLI
does. Its own parser covers the flags the ported slices use, with the
JAX CLI's names and defaults: among them the feature-update churn
(``--serve-update-every``, ``--serve-update-rows``, ``--update-fraction``;
use_pp off), ``--model gcn`` (``--use-pp`` is refused for it, as the
JAX CLI refuses it) and the aggregation (``--spmm-impl``,
``--block-tile``, ``--block-nnz``, ``--block-group``,
``--bucket-merge``): the engine stages the bucket or block tables and
its refresh aggregates through them with the gather transport off, as
the JAX engine does (``bucket``: K9; ``block``: K12, or K16 at
``--block-group > 1``, plus K9 on the remainder; ``xla``: K1).
``--local-reorder cluster`` (the default, as in JAX) renumbers each
part's nodes by locality clusters of the full graph (``--cluster-size``
nodes each) and names the artifact with the JAX CLI's ``-cs<size>``
suffix; ``--local-reorder none`` keeps the base
order. Any artifact of either package loads through ``--graph-name``.

Runs on CUDA; ``--device cpu`` runs the plain PyTorch path on the CPU.
Without a checkpoint (restore waits for a later slice) it serves freshly
initialized params drawn from ``--seed``, as the JAX CLI does without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import torch

from .layout import (add_aggregation_flags, add_layout_flags,
                     artifact_name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PipeGCN serving on PyTorch/CUDA")
    p.add_argument("--dataset", type=str, default="reddit")
    p.add_argument("--graph-name", "--graph_name", type=str, default="")
    p.add_argument("--data-root", "--data_root", type=str, default=None,
                   help="dataset root (default $PIPEGCN_DATA or ./dataset)")
    p.add_argument("--partition-dir", "--partition_dir", type=str,
                   default="partitions")
    p.add_argument("--n-partitions", "--n_partitions", type=int, default=2)
    p.add_argument("--partition-method", "--partition_method",
                   choices=["metis", "random"], default="metis")
    p.add_argument("--partition-obj", "--partition_obj",
                   choices=["vol", "cut"], default="vol")
    add_layout_flags(p)
    add_aggregation_flags(p)
    p.add_argument("--model", type=str, default="graphsage")
    p.add_argument("--n-layers", "--n_layers", type=int, default=2)
    p.add_argument("--n-hidden", "--n_hidden", type=int, default=16)
    p.add_argument("--norm", choices=["layer", "none"], default="layer")
    p.add_argument("--use-pp", "--use_pp", action="store_true")
    p.add_argument("--dtype", choices=["float32"], default="float32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fix-seed", "--fix_seed", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; no silent fallback")
    g = p.add_argument_group("serving")
    g.add_argument("--serve-duration", "--serve_duration", type=float,
                   default=10.0, help="seconds of open-loop load to serve")
    g.add_argument("--serve-qps", "--serve_qps", type=float, default=50.0,
                   help="target query arrival rate (open-loop Poisson)")
    g.add_argument("--serve-max-batch", "--serve_max_batch", type=int,
                   default=64, help="top of the padded batch ladder")
    g.add_argument("--serve-max-delay-ms", "--serve_max_delay_ms",
                   type=float, default=5.0,
                   help="max queueing delay before a partial batch flushes")
    g.add_argument("--serve-ladder-min", "--serve_ladder_min", type=int,
                   default=8, help="bottom of the padded batch ladder")
    g.add_argument("--serve-report-every", "--serve_report_every",
                   type=float, default=2.0,
                   help="seconds between serving stats windows")
    g.add_argument("--serve-refresh-every", "--serve_refresh_every",
                   type=float, default=0.5,
                   help="seconds between logits recomputes")
    g.add_argument("--serve-update-every", "--serve_update_every",
                   type=float, default=0.0,
                   help="seconds between synthetic feature-update churn "
                        "batches (0 disables)")
    g.add_argument("--serve-update-rows", "--serve_update_rows", type=int,
                   default=32, help="rows per synthetic update batch")
    g.add_argument("--serve-build", "--serve_build", action="store_true",
                   help="build the partition artifact when missing")
    g.add_argument("--update-fraction", "--update_fraction", type=float,
                   default=0.0,
                   help="fraction of arrivals that are feature updates "
                        "instead of queries (mixed workload). 0 = "
                        "query-only")
    return p


def build_artifact(args, log=print, g=None, steps=None):
    """Build the artifact in memory: ``load_data`` (skipped when the graph
    ``g`` is given), ``partition_graph``, under ``--local-reorder
    cluster`` ``locality_clusters`` of the same graph, and
    ``ShardedGraph.build``, logging the seconds of each step (and adding
    them to ``steps``, a dict, when given)."""
    from ..graph.datasets import load_data
    from ..partition.halo import ShardedGraph
    from ..partition.partitioner import locality_clusters, partition_graph

    t0 = time.monotonic()
    if g is None:
        g = load_data(args.dataset, args.data_root)
    t1 = time.monotonic()
    seed = args.seed if args.fix_seed else 0
    parts = partition_graph(g, args.n_partitions,
                            method=args.partition_method,
                            obj=args.partition_obj, seed=seed)
    t2 = time.monotonic()
    cluster = None
    if args.local_reorder == "cluster":
        cluster = locality_clusters(g, target_size=args.cluster_size,
                                    seed=seed)
    t3 = time.monotonic()
    sg = ShardedGraph.build(g, parts, n_parts=args.n_partitions,
                            cluster=cluster)
    t4 = time.monotonic()
    n_clusters = 0 if cluster is None else int(cluster.max()) + 1
    log(f"artifact built in {t4 - t0:.1f}s (load_data {t1 - t0:.1f}s, "
        f"partition_graph {t2 - t1:.1f}s, locality_clusters {t3 - t2:.1f}s "
        f"({n_clusters} clusters), ShardedGraph.build {t4 - t3:.1f}s; "
        f"{g.num_edges} edges; layout {artifact_name(args)})")
    if steps is not None:
        for k, v in (("load_data", t1 - t0), ("partition_graph", t2 - t1),
                     ("locality_clusters", t3 - t2),
                     ("ShardedGraph.build", t4 - t3)):
            steps[k] = steps.get(k, 0.0) + v
    return sg


def _load_partition(args, log=print):
    """The artifact at the JAX CLI's path ``<partition-dir>/<name>``
    (:func:`.layout.artifact_name`); with ``--serve-build`` a missing one
    is built and saved there."""
    from ..partition.halo import ShardedGraph

    part_path = os.path.join(args.partition_dir, artifact_name(args))
    if ShardedGraph.exists(part_path):
        sg = ShardedGraph.load(part_path)
        if sg.num_parts != args.n_partitions:
            raise ValueError(
                f"partition artifact at {part_path} has {sg.num_parts} "
                f"parts, requested {args.n_partitions}")
        return sg
    if not args.serve_build:
        raise FileNotFoundError(
            f"no partition artifact at {part_path}; pass --serve-build to "
            "build it")
    sg = build_artifact(args, log)
    t0 = time.monotonic()
    # v3 (uncompressed, memory-mapped on load): compressing a Reddit-size
    # artifact costs minutes; both packages load either format
    sg.save(part_path, mmap=True)
    log(f"serve: saved artifact {part_path} in "
        f"{time.monotonic() - t0:.1f}s")
    return sg


def build_serving_engine(args, log=print, sg=None):
    """Everything between parsed args and a warm ServingEngine: the
    artifact (``sg``, else resolved or built from ``args``), staging,
    params and warmup. Returns the engine."""
    from ..device import resolve_device
    from ..models.sage import ModelConfig, init_params
    from ..serve import ServingEngine

    if args.model not in ("graphsage", "gcn", "gat"):
        raise ValueError(f"unknown model: {args.model}")
    if args.model in ("gcn", "gat") and args.use_pp:
        raise ValueError("--use-pp is a GraphSAGE-only optimization")
    device = resolve_device(args.device)
    if sg is None:
        sg = _load_partition(args, log)
    layer_sizes = (sg.n_feat,) + (args.n_hidden,) * (args.n_layers - 1) \
        + (sg.n_class,)
    cfg = ModelConfig(layer_sizes=layer_sizes, model=args.model,
                      use_pp=args.use_pp,
                      norm=None if args.norm == "none" else args.norm,
                      dtype=args.dtype, spmm_impl=args.spmm_impl,
                      block_tile=args.block_tile,
                      block_nnz=args.block_nnz or None,
                      block_group=args.block_group,
                      bucket_merge=args.bucket_merge)
    gen = torch.Generator().manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    engine = ServingEngine.build(sg, cfg, params, device,
                                 max_batch=args.serve_max_batch,
                                 ladder_min=args.serve_ladder_min)
    warm_s = engine.warmup()
    log(f"serve: engine warm in {warm_s:.2f}s (ladder {engine.ladder}, "
        f"{engine.num_global_nodes} nodes, {engine.P} partitions, "
        f"{device})")
    return engine


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..serve import run_serving_loop

    engine = build_serving_engine(args)
    stop_flag = {"stop": False}

    def _on_signal(signum, frame):  # noqa: ARG001
        stop_flag["stop"] = True

    old = [signal.signal(s, _on_signal)
           for s in (signal.SIGTERM, signal.SIGINT)]
    try:
        summary = run_serving_loop(
            engine,
            duration_s=args.serve_duration,
            qps=args.serve_qps,
            max_delay_ms=args.serve_max_delay_ms,
            report_every_s=args.serve_report_every,
            refresh_every_s=args.serve_refresh_every,
            update_every_s=args.serve_update_every,
            update_rows=args.serve_update_rows,
            seed=args.seed,
            update_fraction=args.update_fraction,
            stop=lambda: stop_flag["stop"],
        )
    finally:
        for s, h in zip((signal.SIGTERM, signal.SIGINT), old):
            signal.signal(s, h)
    print(json.dumps({"serve": True, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
