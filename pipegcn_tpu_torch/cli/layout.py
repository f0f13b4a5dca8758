"""The local-id layout flags both CLIs share, and the artifact name they
derive from them, with the JAX CLI's names, choices and defaults
(``pipegcn_tpu/cli/parser.py``, ``derive_graph_name``)."""

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
