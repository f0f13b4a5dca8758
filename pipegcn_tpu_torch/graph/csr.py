"""Port copy of ``pipegcn_tpu/graph/csr.py`` (``Graph``, self-loop helpers,
``finalize``), kept here so the port imports nothing of the JAX package.
One addition: ``sorted_unique``, the sort-based dedupe the port's host
layer (the synthetic generator, ``ShardedGraph.build``) uses in place of
``np.unique``.

Host-side graph container.

Replaces the reference's DGL graph objects (C++ backed, reference
helper/utils.py:74-96, train.py:113-131) with plain numpy COO/CSR arrays.
All graph preprocessing (loading, self-loop normalization, partitioning,
halo indexing) happens on host in numpy; only static-shaped padded arrays
ever reach the device.

Edge (src, dst) means a message flows src -> dst: aggregation at `dst`
sums features of its in-neighbors `src` (the semantics of DGL
`update_all(copy_src, sum)` in reference module/layer.py:47-49).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class Graph:
    """A directed graph in COO form with per-node data.

    Attributes:
        num_nodes: node count N.
        src, dst: int32/int64 arrays of shape [E]; message direction src->dst.
        ndata: dict of per-node arrays, each with leading dimension N.
            Conventional keys: 'feat' [N, F] float32, 'label' [N] int or
            [N, C] float multi-label, 'train_mask'/'val_mask'/'test_mask'
            [N] bool, 'in_deg' [N] float32 (full-graph in-degrees,
            reference helper/utils.py:142).
    """

    num_nodes: int
    src: np.ndarray
    dst: np.ndarray
    ndata: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def validate(self) -> None:
        assert self.src.shape == self.dst.shape
        if self.num_edges:
            assert int(self.src.max()) < self.num_nodes
            assert int(self.dst.max()) < self.num_nodes
            assert int(self.src.min()) >= 0 and int(self.dst.min()) >= 0
        for k, v in self.ndata.items():
            assert v.shape[0] == self.num_nodes, (k, v.shape, self.num_nodes)

    # ---- degrees ----------------------------------------------------------

    def in_degrees(self) -> np.ndarray:
        """In-degree per node (number of messages each dst receives)."""
        return np.bincount(self.dst, minlength=self.num_nodes).astype(np.int64)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_nodes).astype(np.int64)

    # ---- CSR views --------------------------------------------------------

    def in_csr(self):
        """CSR over in-edges: (indptr [N+1], src_indices [E], edge_ids [E]).

        Row i of the CSR lists the source nodes of edges pointing *into*
        node i. `edge_ids` maps CSR positions back to COO positions.
        """
        order = np.argsort(self.dst, kind="stable")
        indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.dst, minlength=self.num_nodes), out=indptr[1:])
        return indptr, self.src[order], order

    def out_csr(self):
        """CSR over out-edges: (indptr [N+1], dst_indices [E], edge_ids [E])."""
        order = np.argsort(self.src, kind="stable")
        indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.src, minlength=self.num_nodes), out=indptr[1:])
        return indptr, self.dst[order], order

    # ---- transforms -------------------------------------------------------

    def node_subgraph(self, nodes: np.ndarray) -> "Graph":
        """Node-induced subgraph with relabeled node IDs.

        `nodes` is an int array of node IDs (order defines new labels) or a
        boolean mask of length N. ndata rows are sliced accordingly.
        Equivalent of DGL `node_subgraph` used at reference train.py:117 and
        helper/utils.py:226-230 (inductive split).
        """
        nodes = np.asarray(nodes)
        if nodes.dtype == np.bool_:
            nodes = np.nonzero(nodes)[0]
        new_id = np.full(self.num_nodes, -1, dtype=np.int64)
        new_id[nodes] = np.arange(nodes.shape[0], dtype=np.int64)
        keep = (new_id[self.src] >= 0) & (new_id[self.dst] >= 0)
        sub = Graph(
            num_nodes=int(nodes.shape[0]),
            src=new_id[self.src[keep]],
            dst=new_id[self.dst[keep]],
            ndata={k: v[nodes] for k, v in self.ndata.items()},
        )
        if "in_deg" in sub.ndata:
            # derived data: recompute for the induced graph rather than
            # keeping the full-graph degrees sliced above
            sub.ndata["in_deg"] = sub.in_degrees().astype(np.float32)
        return sub

    def copy(self) -> "Graph":
        return Graph(
            num_nodes=self.num_nodes,
            src=self.src.copy(),
            dst=self.dst.copy(),
            ndata={k: v.copy() for k, v in self.ndata.items()},
        )


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """``np.unique(x)`` for a 1-D integer array, always by sorting.
    NumPy 2.3 and later route ``np.unique`` through a hash set first,
    which is far slower than a sort at Reddit scale (57M distinct keys)."""
    x = np.sort(x)
    if x.size:
        x = x[np.concatenate(([True], x[1:] != x[:-1]))]
    return x


def remove_self_loops(g: Graph) -> Graph:
    keep = g.src != g.dst
    return Graph(g.num_nodes, g.src[keep], g.dst[keep], dict(g.ndata))


def add_self_loops(g: Graph) -> Graph:
    loop = np.arange(g.num_nodes, dtype=g.src.dtype)
    return Graph(
        g.num_nodes,
        np.concatenate([g.src, loop]),
        np.concatenate([g.dst, loop]),
        dict(g.ndata),
    )


def normalize_self_loops(g: Graph) -> Graph:
    """Ensure exactly one self-loop per node: remove all, then add one.

    Mirrors the reference's canonicalization applied to every dataset
    (helper/utils.py:94-95: `remove_self_loop` then `add_self_loop`).
    """
    return add_self_loops(remove_self_loops(g))


def finalize(g: Graph) -> Graph:
    """Canonicalize a freshly-loaded graph: one self-loop per node, validated,
    with full-graph in-degrees precomputed into ndata['in_deg'] (the degrees
    used for mean aggregation, reference helper/utils.py:142)."""
    g = normalize_self_loops(g)
    g.ndata["in_deg"] = g.in_degrees().astype(np.float32)
    g.validate()
    return g
