"""The flags both CLIs share (the local-id layout and the aggregation),
and the artifact name they derive from the layout, with the JAX CLI's
names, aliases, choices and defaults (``pipegcn_tpu/cli/parser.py``,
``derive_graph_name``)."""

from __future__ import annotations

import argparse

from ..partition.partitioner import DEFAULT_CLUSTER_SIZE, cluster_suffix


def add_layout_flags(p: argparse.ArgumentParser) -> None:
    """``--local-reorder`` and ``--cluster-size``, with the JAX parser's
    names, choices and defaults (``cli/parser.py``)."""
    p.add_argument("--local-reorder", "--local_reorder",
                   choices=["none", "cluster"], default="cluster",
                   help="local-id order within each partition: 'cluster' "
                        "renumbers by locality clusters so the part's "
                        "adjacency forms dense tiles (feeds --spmm-impl "
                        "block); 'none' keeps global-id order")
    p.add_argument("--cluster-size", "--cluster_size", type=int,
                   default=DEFAULT_CLUSTER_SIZE,
                   help="locality-cluster target size for --local-reorder "
                        "cluster")


def add_aggregation_flags(p: argparse.ArgumentParser) -> None:
    """``--spmm-impl``, ``--block-tile``, ``--block-nnz``,
    ``--block-group`` and ``--bucket-merge``, with the JAX parser's names,
    aliases, choices and defaults (``cli/parser.py:115-141``)."""
    p.add_argument("--spmm-impl", "--spmm_impl",
                   choices=["xla", "bucket", "block", "auto"], default="xla",
                   help="aggregation: graphsage/gcn by CSR (xla: K1/K3), "
                        "through degree-bucketed tables (bucket: K9) or "
                        "through dense tiles plus a bucket remainder "
                        "(block: K12/K13 and K9); gat runs its attention "
                        "kernels for xla/bucket/auto; auto for "
                        "graphsage/gcn is ROADMAP A6")
    p.add_argument("--block-tile", "--block_tile", type=int, default=256,
                   help="dense-tile edge length of the block kernel")
    p.add_argument("--block-nnz", "--block_nnz", type=int, default=0,
                   help="minimum edges for a tile pair to go dense in the "
                        "block kernel (0 = read-cost break-even)")
    p.add_argument("--block-group", "--block_group", type=int, default=1,
                   help="union-gather group: that many consecutive dst "
                        "tiles share one gathered source-tile union in the "
                        "block kernel's dense path (K16/K17; 1 = per-tile "
                        "pair lists, K12/K13)")
    p.add_argument("--bucket-merge", "--bucket_merge", type=int, default=0,
                   help="merge bucket-ladder rungs below this width into "
                        "one bucket (0 = full ladder)")


def artifact_name(args) -> str:
    """The JAX CLI's artifact name (``derive_graph_name``):
    ``<dataset>-<P>-<method>-<obj>-<induc|trans>`` (or ``--graph-name``)
    plus ``-cs<cluster size>`` for the cluster layout."""
    mode = "induc" if getattr(args, "inductive", False) else "trans"
    name = getattr(args, "graph_name", "") or (
        f"{args.dataset}-{args.n_partitions}-{args.partition_method}-"
        f"{args.partition_obj}-{mode}")
    if args.local_reorder == "cluster":
        name += "-c" + cluster_suffix(args.cluster_size)
    return name
