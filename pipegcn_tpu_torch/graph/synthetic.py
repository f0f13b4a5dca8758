"""Port copy of ``pipegcn_tpu/graph/synthetic.py`` (``synthetic_graph``,
``karate_club``); the same seed gives the same graph on both sides. One
change: the edge-key dedupe sorts explicitly (``csr.sorted_unique``) instead
of calling ``np.unique``/``np.union1d``; the result is the same array.

Synthetic graph generators.

The reference validates correctness only via convergence on real datasets
(SURVEY.md §4); this framework adds synthetic graphs so unit/integration
tests and benchmarks run hermetically (no dataset downloads). Graphs have
planted community structure so GNN training is meaningful: labels follow
communities, features are noisy class prototypes, and edges are mostly
intra-community — a stochastic-block-model flavor.
"""

from __future__ import annotations

import numpy as np

from .csr import Graph, finalize, sorted_unique


def synthetic_graph(
    num_nodes: int = 1000,
    avg_degree: int = 10,
    n_feat: int = 32,
    n_class: int = 7,
    multilabel: bool = False,
    homophily: float = 0.8,
    train_frac: float = 0.6,
    val_frac: float = 0.2,
    seed: int = 0,
    noise: float = 1.0,
    label_noise: float = 0.0,
) -> Graph:
    """SBM-style synthetic graph with class-correlated features.

    Returns a Graph with 'feat', 'label', 'train_mask', 'val_mask',
    'test_mask' populated, self-loops normalized, and edges symmetric
    (each generated undirected edge is stored in both directions, like the
    datasets the reference uses).
    """
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_class, size=num_nodes)

    n_edges = num_nodes * avg_degree // 2
    order = np.argsort(comm, kind="stable")
    sorted_comm = comm[order]
    starts = np.searchsorted(sorted_comm, np.arange(n_class))
    ends = np.searchsorted(sorted_comm, np.arange(n_class), side="right")

    def sample_pairs(k: int) -> np.ndarray:
        """k undirected candidate pairs as canonical lo*N+hi keys
        (self-pairs dropped). Endpoint A uniform; endpoint B
        intra-community w.p. `homophily` via a community-sorted
        lookup, else uniform."""
        a = rng.integers(0, num_nodes, size=k)
        intra = rng.random(k) < homophily
        ca = comm[a]
        span = np.maximum(ends[ca] - starts[ca], 1)
        b_intra = order[starts[ca]
                        + (rng.integers(0, 1 << 62, size=k) % span)]
        b = np.where(intra, b_intra, rng.integers(0, num_nodes, size=k))
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        return (lo * num_nodes + hi)[lo != hi]

    # The real datasets this generator stands in for (Reddit, ogbn-*)
    # are SIMPLE graphs; duplicate sampled pairs are dropped and topped
    # up so the graph is simple at exactly the requested edge count
    # (multiplicity-1 adjacency is also what lets the block-dense
    # kernel bit-pack its A tiles, ops/block_spmm.BlockPlan.a_stored).
    keys = sorted_unique(sample_pairs(n_edges))
    while keys.size < n_edges:
        extra = sample_pairs(2 * (n_edges - keys.size))
        merged = sorted_unique(np.concatenate([keys, extra]))
        if merged.size == keys.size:  # saturated (requested degree
            break                     # exceeds the simple-pair space)
        keys = merged
    if keys.size > n_edges:
        keys = rng.permutation(keys)[:n_edges]

    a = keys // num_nodes
    b = keys % num_nodes
    src = np.concatenate([a, b]).astype(np.int64)
    dst = np.concatenate([b, a]).astype(np.int64)

    # Class-prototype features + noise. `noise` scales the per-node
    # gaussian: at the default 1.0 a wide-feature task is nearly
    # linearly separable from raw features; convergence studies that
    # need a non-trivial learning curve (accuracy plateauing below
    # 100%, like the real datasets) raise it so aggregation over the
    # neighborhood is what recovers the signal.
    protos = rng.normal(0.0, 1.0, size=(n_class, n_feat)).astype(np.float32)
    feat = protos[comm] + rng.normal(
        0.0, noise, size=(num_nodes, n_feat)).astype(np.float32)

    if multilabel:
        # Each node gets its community label plus random extra labels.
        label = np.zeros((num_nodes, n_class), dtype=np.float32)
        label[np.arange(num_nodes), comm] = 1.0
        extra = rng.random((num_nodes, n_class)) < 0.1
        label = np.maximum(label, extra.astype(np.float32))
    else:
        label = comm.astype(np.int64)
        if label_noise > 0.0:
            # flip a fraction of labels (all splits) to a random OTHER
            # class: imposes an irreducible-error ceiling of ~1-p like
            # the real datasets (Reddit tops out at 97.1%, reference
            # README.md:98) — without it, high-degree aggregation
            # saturates SBM tasks at 100% and convergence comparisons
            # lose their resolution. Drawn from a DEDICATED generator
            # so the split permutation below is identical across
            # label_noise settings at a fixed seed (a clean-vs-noisy
            # comparison must not also change train/val/test masks).
            nrng = np.random.default_rng(seed ^ 0x5EED)
            flip = nrng.random(num_nodes) < label_noise
            shift = nrng.integers(1, n_class, size=num_nodes)
            label = np.where(flip, (label + shift) % n_class, label)

    perm = rng.permutation(num_nodes)
    n_train = int(train_frac * num_nodes)
    n_val = int(val_frac * num_nodes)
    train_mask = np.zeros(num_nodes, dtype=bool)
    val_mask = np.zeros(num_nodes, dtype=bool)
    test_mask = np.zeros(num_nodes, dtype=bool)
    train_mask[perm[:n_train]] = True
    val_mask[perm[n_train : n_train + n_val]] = True
    test_mask[perm[n_train + n_val :]] = True

    g = Graph(
        num_nodes=num_nodes,
        src=src,
        dst=dst,
        ndata={
            "feat": feat,
            "label": label,
            "train_mask": train_mask,
            "val_mask": val_mask,
            "test_mask": test_mask,
        },
    )
    return finalize(g)


_KARATE_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33),
]

_KARATE_LABELS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 1, 0, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    dtype=np.int64,
)


def karate_club(n_feat: int = 8, seed: int = 0) -> Graph:
    """Zachary's karate club (34 nodes) with random features — the smallest
    integration-test graph. Labels are the canonical 2-community split."""
    rng = np.random.default_rng(seed)
    e = np.array(_KARATE_EDGES, dtype=np.int64)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    n = 34
    feat = rng.normal(size=(n, n_feat)).astype(np.float32)
    feat[:, 0] = _KARATE_LABELS * 2.0 - 1.0  # make it learnable
    train_mask = np.zeros(n, dtype=bool)
    train_mask[rng.permutation(n)[:20]] = True
    val_mask = ~train_mask
    g = Graph(
        num_nodes=n,
        src=src,
        dst=dst,
        ndata={
            "feat": feat,
            "label": _KARATE_LABELS.copy(),
            "train_mask": train_mask,
            "val_mask": val_mask,
            "test_mask": val_mask.copy(),
        },
    )
    return finalize(g)
