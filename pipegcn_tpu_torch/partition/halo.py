"""Port of ``pipegcn_tpu/partition/halo.py`` (``ShardedGraph`` build /
save / load / exists), numpy only. Arrays and layout are unchanged, so a
port artifact and a JAX artifact of the same graph and partition are equal
array for array, and either package loads the other's artifact.

Not ported yet: ``build_chunked`` (papers100M-scale RAM-bounded build),
the ``reorder`` key and streaming ``slack`` of ``build``, and
trimmed-edge (``trim_edges``) artifacts. The locality ``cluster`` key is
ported.

Halo index pipeline: partitioned graph -> static-shaped device arrays.

This is the TPU-native replacement for the reference's entire per-rank
graph-construction stack — boundary discovery (helper/utils.py:154-188),
halo ordering + renumbering (train.py:84-131, 206-229), train-first
permutation (train.py:134-155), and recv-shape computation
(train.py:101-110) — done once on host in numpy, producing arrays whose
shapes are identical on every device so a single SPMD program can be
traced over them.

Layout per device r (P devices total):

  rows [0, N_max)           : inner (owned) nodes, train nodes first
                              (local ids of train nodes are [0, n_train_r)),
                              padded with zero rows up to N_max
  rows [N_max + (d-1)*B_max + k) for d in 1..P-1, k in [0, B_max):
                              halo slot k of ring distance d — after the
                              exchange step at distance d it holds entry k
                              of the send list of owner q = (r-d) mod P

The send list S[r][d-1] contains local indices of r's inner nodes needed
by the peer t = (r+d) mod P (nodes with an out-edge into t), sorted by
local id, padded to B_max. Keying halo blocks by ring *distance* instead
of owner rank (the reference sorts by owner rank, train.py:120-131) makes
the ppermute-based exchange's recv offsets identical across devices —
the property that lets one traced program serve all shards.

Local edges: every global edge (u, v) with part(v) == r appears exactly
once on device r as (src_local, dst_local); src_local is an inner id or a
halo slot. Edge arrays are padded to E_max with (src=0, dst=N_max); the
dst sentinel routes padded contributions into a dropped segment.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np

from ..graph.csr import Graph, sorted_unique


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m if m > 0 else x


# host-side edge-pass chunk: bounds O(E) int64 temporaries during
# checksums (6-7 per-edge int64 scratch arrays at a time -> ~0.9 GB per
# 16M-edge chunk instead of all-E at once)
_EDGE_CHUNK = 16 * 1024 * 1024


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative int64 fused keys: the native radix
    sort for large arrays (the permutation of numpy's stable sort, in
    seconds where numpy takes minutes at 100M edges), as the JAX
    package's build sorts."""
    from ..native import stable_argsort

    return stable_argsort(keys)


@dataclasses.dataclass
class ShardedGraph:
    """Stacked per-device arrays (leading axis = device / partition).

    All integer index arrays are int32; features float32.
    """

    num_parts: int
    n_max: int          # padded inner-node rows per device
    b_max: int          # padded send-list length (per peer distance)
    e_max: int          # padded edge count per device
    n_train_global: int
    n_feat: int
    n_class: int
    multilabel: bool

    inner_count: np.ndarray   # [P] real inner nodes per device
    train_count: np.ndarray   # [P] train nodes per device (local ids [0, t))
    edge_count: np.ndarray    # [P] real edges per device
    send_counts: np.ndarray   # [P, P-1] real send-list lengths

    edge_src: np.ndarray      # [P, E_max] int32 in [0, N_max + (P-1)*B_max)
    edge_dst: np.ndarray      # [P, E_max] int32 in [0, N_max]; N_max = pad
    send_idx: np.ndarray      # [P, P-1, B_max] int32 local inner ids
    send_mask: np.ndarray     # [P, P-1, B_max] bool

    feat: np.ndarray          # [P, N_max, F]
    label: np.ndarray         # [P, N_max] int64 or [P, N_max, C] float32
    train_mask: np.ndarray    # [P, N_max] bool (padding rows False)
    val_mask: np.ndarray      # [P, N_max] bool
    test_mask: np.ndarray     # [P, N_max] bool
    in_deg: np.ndarray        # [P, N_max] float32 (padding rows 1.0)
    global_nid: np.ndarray    # [P, N_max] int64 (padding rows -1)

    # wraparound-uint64 checksum of the source graph's global edge list
    # (identifies "is this sharded graph built from exactly graph g?" —
    # node-ID cover alone can't distinguish graphs sharing a node set);
    # -1 in artifacts saved before the field existed
    source_edge_checksum: int = -1

    # locality reorder layout of a JAX-built artifact: which node
    # renumbering its local ids follow. This port builds only the base
    # layout ("none", layout v1); a reordered artifact still loads and
    # serves (the renumbering is consistent across every array).
    # reorder_perm[p, l] is the local id node (p, l) would have under
    # reorder="none", reorder_inv its inverse; None when "none".
    reorder: str = "none"
    layout_version: int = 1
    reorder_perm: Optional[np.ndarray] = None
    reorder_inv: Optional[np.ndarray] = None

    # set by load(): the artifact directory. Not serialized.
    cache_dir: Optional[str] = None

    @property
    def halo_size(self) -> int:
        return (self.num_parts - 1) * self.b_max

    @staticmethod
    def edge_checksum(g: Graph) -> int:
        # splitmix64-mix each fused (src, dst) pair BEFORE the order-free
        # sum: a plain sum of src*N + dst is linear (N*Σsrc + Σdst) and
        # collides for any re-pairing of the same endpoints — exactly the
        # rewired-graph case the checksum must detect. Chunked so the
        # uint64 temporaries stay bounded at papers100M scale (the sum
        # is order-free, so chunking cannot change the result).
        total = 0
        nn = np.uint64(g.num_nodes)
        for i0 in range(0, g.num_edges, _EDGE_CHUNK):
            sl = slice(i0, min(i0 + _EDGE_CHUNK, g.num_edges))
            x = g.src[sl].astype(np.uint64) * nn \
                + g.dst[sl].astype(np.uint64)
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            x ^= x >> np.uint64(31)
            # explicit mod-2^64 accumulation (a np.uint64 scalar add
            # wraps identically but emits RuntimeWarning per chunk)
            total = (total + int(x.sum(dtype=np.uint64))) & ((1 << 64) - 1)
        return total

    # ------------------------------------------------------------------
    @staticmethod
    def _send_structures(pair_fused: np.ndarray, parts: np.ndarray,
                         local_id: np.ndarray, num_parts: int, n: int,
                         pad_to: int) -> Dict[str, np.ndarray]:
        """Send lists + halo-slot lookup from the sorted unique
        (node, dest part) fused-pair array.

        Returns send_counts/b_max/send_idx/send_mask plus the pair->slot
        lookup pieces (`fused_sorted` = pair_fused itself, `dist`,
        `rank_in_group`, `order` = inverse of the send-list sort) used
        to localize cross-edge sources."""
        p_node = pair_fused // num_parts
        p_dest = (pair_fused % num_parts).astype(np.int32)
        p_owner = parts[p_node]
        # sort by (owner, dest, local id) -> grouped send lists in order
        skey = _stable_argsort(
            (p_owner.astype(np.int64) * num_parts + p_dest) * n
            + local_id[p_node]
        )
        p_node, p_dest, p_owner = p_node[skey], p_dest[skey], p_owner[skey]

        # group starts for each (owner, dest) combination
        combo = p_owner.astype(np.int64) * num_parts + p_dest
        send_counts = np.bincount(
            combo, minlength=num_parts * num_parts
        ).reshape(num_parts, num_parts)
        assert np.all(np.diag(send_counts) == 0)
        b_max = _round_up(int(send_counts.max()), pad_to) \
            if num_parts > 1 else 0

        combo_starts = np.zeros(num_parts * num_parts + 1, dtype=np.int64)
        np.cumsum(send_counts.reshape(-1), out=combo_starts[1:])
        rank_in_group = np.arange(p_node.shape[0]) - combo_starts[combo]

        # send_idx[r, d-1, k] = local id of k-th node r sends to (r+d)%P
        # (empty index arrays make these assignments no-ops, so the exact
        # shape works for P == 1 and b_max == 0 too)
        send_idx = np.zeros((num_parts, num_parts - 1, b_max),
                            dtype=np.int32)
        send_mask = np.zeros_like(send_idx, dtype=bool)
        dist = (p_dest - p_owner) % num_parts  # ring distance in 1..P-1
        send_idx[p_owner, dist - 1, rank_in_group] = \
            local_id[p_node].astype(np.int32)
        send_mask[p_owner, dist - 1, rank_in_group] = True

        # pair -> slot lookup via a dict-free merge: pair_fused is
        # already sorted by (node, dest) and p_* are its skey-
        # permutation, so the sorted key array IS pair_fused and the
        # sort order is skey's inverse — no third large sort needed
        fused_sorted_order = np.empty_like(skey)
        fused_sorted_order[skey] = np.arange(skey.size)
        return {
            "send_counts": send_counts,
            "b_max": b_max,
            "send_idx": send_idx,
            "send_mask": send_mask,
            "fused_sorted": pair_fused,
            # rank/dist in pair_fused order (hoisted out of the per-
            # chunk edge localization)
            "rank_by_pair": rank_in_group[fused_sorted_order],
            "dist_by_pair": dist[fused_sorted_order],
        }

    @staticmethod
    def _localize_edges(src: np.ndarray, dst: np.ndarray,
                        parts: np.ndarray, local_id: np.ndarray,
                        ss: Dict[str, np.ndarray], num_parts: int,
                        n_max: int, b_max: int):
        """(src_local, dst_local) int64 for a slice of global edges: an
        inner source maps to its local id, a cross source to its halo
        slot n_max + (dist-1)*b_max + rank in the owner's send list."""
        fused_sorted = ss["fused_sorted"]
        dst_local = local_id[dst].astype(np.int64)
        src_inner = parts[src] == parts[dst]
        edge_fused = src.astype(np.int64) * num_parts + parts[dst]
        loc = np.searchsorted(fused_sorted, edge_fused)
        # (only valid where cross; guard indices)
        loc = np.clip(loc, 0, max(fused_sorted.size - 1, 0))
        if fused_sorted.size:
            halo_rank = ss["rank_by_pair"][loc]
            halo_dist = ss["dist_by_pair"][loc]
        else:
            halo_rank = np.zeros_like(edge_fused)
            halo_dist = np.ones_like(edge_fused)
        src_local = np.where(
            src_inner,
            local_id[src],
            n_max + (halo_dist - 1) * b_max + halo_rank,
        ).astype(np.int64)
        return src_local, dst_local

    # ------------------------------------------------------------------
    @staticmethod
    def _local_ids(n: int, train_mask: np.ndarray, parts: np.ndarray,
                   num_parts: int, cluster: Optional[np.ndarray] = None):
        """Local-id assignment: sort nodes by (part, ~is_train[, cluster],
        global id) into contiguous per-part train-first blocks. Returns
        (local_id, part_sizes)."""
        keys = [np.arange(n)]
        if cluster is not None:
            keys.append(cluster.astype(np.int64))
        keys += [~train_mask, parts]
        order = np.lexsort(tuple(keys))
        part_sizes = np.bincount(parts, minlength=num_parts)
        part_starts = np.zeros(num_parts + 1, dtype=np.int64)
        np.cumsum(part_sizes, out=part_starts[1:])
        local_id = np.empty(n, dtype=np.int64)
        local_id[order] = np.arange(n) - part_starts[parts[order]]
        return local_id, part_sizes

    @staticmethod
    def build(
        g: Graph,
        parts: np.ndarray,
        n_parts: Optional[int] = None,
        pad_to: int = 8,
        cluster: Optional[np.ndarray] = None,
    ) -> "ShardedGraph":
        """Build the sharded layout from a graph and a partition assignment.

        `g` must be finalized (self loops + in_deg). `parts` is [N] int.
        `n_parts` is the intended device count; defaults to parts.max()+1
        but must be passed explicitly when trailing partitions could be
        empty (an empty shard is valid, just wasteful).

        `cluster` ([N] int, optional; ``partitioner.locality_clusters``)
        adds a locality key to the local renumbering: within each part's
        train and non-train segments nodes sort by (cluster, global id),
        so a community's nodes get contiguous local ids and the part's
        adjacency concentrates into dense tiles (what ops/block_spmm.py
        multiplies). An ordering choice only: every layout invariant
        (train-first, CSR edges, send lists) holds for any order.
        """
        n = g.num_nodes
        parts = parts.astype(np.int32)
        num_parts = int(n_parts) if n_parts is not None else int(parts.max()) + 1
        if num_parts < int(parts.max()) + 1:
            raise ValueError(
                f"n_parts={num_parts} smaller than max partition id "
                f"{int(parts.max())}"
            )
        train_mask = g.ndata["train_mask"]

        # ---- local ids: train-first within each partition ------------
        local_id, part_sizes = ShardedGraph._local_ids(
            n, train_mask, parts, num_parts, cluster)

        inner_count = part_sizes.astype(np.int32)
        train_count = np.bincount(
            parts[train_mask], minlength=num_parts
        ).astype(np.int32)

        n_max = _round_up(int(part_sizes.max()), pad_to)

        # ---- send lists ----------------------------------------------
        # cross edges define which (owner node, dest part) pairs exist;
        # fusing (node, dest) into one key makes the unique a cheap 1-D
        # sort instead of numpy's slow axis-0 row unique
        cross = parts[g.src] != parts[g.dst]
        cs, cd = g.src[cross], g.dst[cross]
        pair_fused = sorted_unique(
            cs.astype(np.int64) * num_parts + parts[cd]
        )  # sorted by (node, dest part), same order as the row unique
        ss = ShardedGraph._send_structures(pair_fused, parts, local_id,
                                           num_parts, n, pad_to)
        send_counts, b_max = ss["send_counts"], ss["b_max"]
        send_idx, send_mask = ss["send_idx"], ss["send_mask"]

        # ---- per-device edges ----------------------------------------
        edge_owner = parts[g.dst]  # device that owns each edge
        e_sizes = np.bincount(edge_owner, minlength=num_parts)
        e_max = _round_up(int(e_sizes.max()), 128)

        src_local_all, dst_local_all = ShardedGraph._localize_edges(
            g.src, g.dst, parts, local_id, ss, num_parts, n_max, b_max)

        # scatter edges into per-device padded arrays, sorted by local dst
        # within each device (CSR order — lets kernels rely on contiguous
        # destination segments; padding dst = n_max sorts to the tail)
        # THE hot host sort (E entries), on one fused key
        e_order = _stable_argsort(
            edge_owner.astype(np.int64) * (n_max + 1) + dst_local_all
        )
        e_starts = np.zeros(num_parts + 1, dtype=np.int64)
        np.cumsum(e_sizes, out=e_starts[1:])
        edge_src = np.zeros((num_parts, e_max), dtype=np.int32)
        edge_dst = np.full((num_parts, e_max), n_max, dtype=np.int32)
        pos_in_dev = np.arange(g.num_edges) - e_starts[edge_owner[e_order]]
        edge_src[edge_owner[e_order], pos_in_dev] = src_local_all[e_order]
        edge_dst[edge_owner[e_order], pos_in_dev] = dst_local_all[e_order]

        return ShardedGraph._assemble(
            g, parts, local_id, num_parts, n_max, b_max, e_max,
            e_sizes, inner_count, train_count, send_counts,
            edge_src, edge_dst, send_idx, send_mask,
        )

    @staticmethod
    def _assemble(g, parts, local_id, num_parts, n_max, b_max, e_max,
                  e_sizes, inner_count, train_count, send_counts,
                  edge_src, edge_dst, send_idx, send_mask
                  ) -> "ShardedGraph":
        """Per-device node-data scatter + dataclass construction."""
        n = g.num_nodes
        train_mask = np.asarray(g.ndata["train_mask"])

        def scatter_nodes(x: np.ndarray, fill) -> np.ndarray:
            shape = (num_parts, n_max) + x.shape[1:]
            out = np.full(shape, fill, dtype=x.dtype)
            out[parts, local_id] = x
            return out

        feat = scatter_nodes(np.asarray(g.ndata["feat"], np.float32), 0.0)
        label_arr = np.asarray(g.ndata["label"])
        multilabel = label_arr.ndim == 2
        if multilabel:
            label = scatter_nodes(label_arr.astype(np.float32), 0.0)
            n_class = int(label_arr.shape[1])
        else:
            label = scatter_nodes(label_arr.astype(np.int64), 0)
            n_class = int(label_arr.max()) + 1
        tm = scatter_nodes(train_mask.astype(bool), False)
        vm = scatter_nodes(
            np.asarray(g.ndata.get("val_mask", np.zeros(n, bool)),
                       bool), False
        )
        sm = scatter_nodes(
            np.asarray(g.ndata.get("test_mask", np.zeros(n, bool)),
                       bool), False
        )
        # degrees of the graph being partitioned (reference utils.py:142);
        # finalize()/node_subgraph keep ndata['in_deg'] consistent with the
        # attached graph, so prefer it over an O(E) recompute
        deg = g.ndata.get("in_deg")
        if deg is None:
            deg = g.in_degrees()
        in_deg = scatter_nodes(np.asarray(deg, np.float32), 1.0)
        in_deg[in_deg == 0] = 1.0
        gnid = scatter_nodes(np.arange(n, dtype=np.int64), -1)

        return ShardedGraph(
            num_parts=num_parts,
            n_max=n_max,
            b_max=b_max,
            e_max=e_max,
            n_train_global=int(train_mask.sum()),
            n_feat=int(feat.shape[-1]),
            n_class=n_class,
            multilabel=multilabel,
            inner_count=inner_count,
            train_count=train_count,
            edge_count=e_sizes.astype(np.int32),
            send_counts=send_counts[
                np.arange(num_parts)[:, None],
                (np.arange(num_parts)[:, None] + np.arange(1, max(num_parts, 2)))
                % num_parts,
            ].astype(np.int32) if num_parts > 1 else np.zeros((1, 0), np.int32),
            edge_src=edge_src,
            edge_dst=edge_dst,
            send_idx=send_idx,
            send_mask=send_mask,
            feat=feat,
            label=label,
            train_mask=tm,
            val_mask=vm,
            test_mask=sm,
            in_deg=in_deg,
            global_nid=gnid,
            source_edge_checksum=ShardedGraph.edge_checksum(g),
        )

    # ------------------------------------------------------------------
    # Partition artifact on disk (reference: dgl partition JSON + per-part
    # files, helper/utils.py:132-144 / 99-129; enables --skip-partition).

    _ARRAYS = [
        "inner_count", "train_count", "edge_count", "send_counts",
        "edge_src", "edge_dst", "send_idx", "send_mask", "feat", "label",
        "train_mask", "val_mask", "test_mask", "in_deg", "global_nid",
    ]

    # format history: v1 edges grouped by device only; v2 adds the per-
    # device dst-sorted (CSR) edge order that spmm's sorted path relies
    # on; v3 stores the same arrays as individual uncompressed .npy
    # files so loaders can mmap them (papers100M-class artifacts exceed
    # RAM as one decompressed npz; a v3 reader touches only the ranks
    # it slices — the per-rank loading the reference gets from dgl's
    # per-part files, helper/utils.py:132-144)
    FORMAT_VERSION = 2
    MMAP_FORMAT_VERSION = 3

    # reorder-aware (layout v2) artifacts also carry the permutation
    # arrays; this port writes them back only when it loaded them
    _REORDER_ARRAYS = ["reorder_perm", "reorder_inv"]

    def save(self, path: str, mmap: bool = False) -> None:
        """Write the artifact: v2 (one compressed npz) or, with `mmap`,
        v3 (one uncompressed .npy per array, loaded memory-mapped)."""
        os.makedirs(path, exist_ok=True)
        manifest = {
            "format_version": (self.MMAP_FORMAT_VERSION if mmap
                               else self.FORMAT_VERSION),
            "num_parts": self.num_parts,
            "n_max": self.n_max,
            "b_max": self.b_max,
            "e_max": self.e_max,
            "n_train_global": self.n_train_global,
            "n_feat": self.n_feat,
            "n_class": self.n_class,
            "multilabel": self.multilabel,
            "source_edge_checksum": self.source_edge_checksum,
            "reorder": self.reorder,
            "layout_version": self.layout_version,
        }
        # the permutation arrays exist only on reordered layouts, so
        # they are saved conditionally
        extra = [k for k in self._REORDER_ARRAYS
                 if getattr(self, k) is not None]
        # arrays first, manifest last: exists() keys off the manifest, so
        # a reader polling a shared filesystem never observes a
        # half-written artifact
        if mmap:
            adir = os.path.join(path, "arrays")
            os.makedirs(adir, exist_ok=True)
            for k in self._ARRAYS + extra:
                np.save(os.path.join(adir, f"{k}.npy"), getattr(self, k))
        else:
            np.savez_compressed(
                os.path.join(path, "arrays.npz"),
                **{k: getattr(self, k) for k in self._ARRAYS + extra},
            )
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)

    @staticmethod
    def load(path: str) -> "ShardedGraph":
        """Load a v2 or v3 artifact (written by either package)."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        version = manifest.pop("format_version", 0)
        if version == ShardedGraph.MMAP_FORMAT_VERSION:
            if manifest.pop("trimmed_edges", False):
                raise ValueError(
                    f"partition artifact at {path} stores trimmed "
                    "per-rank edges; the serving path needs the padded "
                    "[P, e_max] stack — re-save it without trim_edges")
            adir = os.path.join(path, "arrays")
            arrays = {k: np.load(os.path.join(adir, f"{k}.npy"),
                                 mmap_mode="r")
                      for k in ShardedGraph._ARRAYS}
            for k in ShardedGraph._REORDER_ARRAYS:
                p = os.path.join(adir, f"{k}.npy")
                if os.path.exists(p):
                    arrays[k] = np.load(p, mmap_mode="r")
            return ShardedGraph(**manifest, cache_dir=path, **arrays)
        if version != ShardedGraph.FORMAT_VERSION:
            raise ValueError(
                f"partition artifact at {path} has format v{version}, "
                f"expected v{ShardedGraph.FORMAT_VERSION} (or mmap "
                f"v{ShardedGraph.MMAP_FORMAT_VERSION}); re-partition "
                f"(delete the directory)"
            )
        arrays = np.load(os.path.join(path, "arrays.npz"))
        keys = ShardedGraph._ARRAYS + [k for k in
                                       ShardedGraph._REORDER_ARRAYS
                                       if k in arrays.files]
        return ShardedGraph(**manifest, cache_dir=path,
                            **{k: arrays[k] for k in keys})

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(os.path.join(path, "manifest.json"))
