"""Port copy of ``pipegcn_tpu/graph/datasets.py`` (``load_data`` and its
loaders); the same dataset name gives the same graph on both sides.

Dataset loaders.

Re-implements the reference's `load_data` dispatch (helper/utils.py:74-96)
without DGL/OGB: each loader reads the dataset's standard on-disk raw format
directly with numpy/scipy. All loaders apply the reference's
canonicalization — self-loop normalization (helper/utils.py:94-95), class
count inferred from label rank (helper/utils.py:88-91), and full-graph
in-degree precompute (helper/utils.py:142).

Synthetic datasets (no download needed) are first-class here, unlike the
reference: 'karate', 'synthetic', 'synthetic-reddit' (Reddit-scale shape
stats), and parameterized 'synthetic:<nodes>:<deg>:<feat>:<classes>'.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .csr import Graph, finalize
from .synthetic import karate_club, synthetic_graph


def n_classes(g: Graph) -> int:
    """Infer class count: 1-D integer labels -> max+1 (single-label);
    2-D labels -> second dim (multi-label). Reference helper/utils.py:88-91."""
    label = g.ndata["label"]
    if label.ndim == 1:
        return int(label.max()) + 1
    return int(label.shape[1])


def is_multilabel(g: Graph) -> bool:
    return g.ndata["label"].ndim == 2


def load_reddit(root: str) -> Graph:
    """Reddit from the standard DGL raw archive layout:
    <root>/reddit/reddit_data.npz (feature/label/node_types) +
    <root>/reddit/reddit_graph.npz (scipy sparse adjacency)."""
    import scipy.sparse as sp

    d = os.path.join(root, "reddit")
    data = np.load(os.path.join(d, "reddit_data.npz"))
    adj = sp.load_npz(os.path.join(d, "reddit_graph.npz")).tocoo()
    types = data["node_types"]
    g = Graph(
        num_nodes=int(data["feature"].shape[0]),
        src=adj.row.astype(np.int64),
        dst=adj.col.astype(np.int64),
        ndata={
            "feat": data["feature"].astype(np.float32),
            "label": data["label"].astype(np.int64),
            "train_mask": types == 1,
            "val_mask": types == 2,
            "test_mask": types == 3,
        },
    )
    return finalize(g)


def _read_csv_gz(path: str, dtype):
    """Fast csv.gz reader: pandas C engine when available, else numpy."""
    try:
        import pandas as pd

        return pd.read_csv(path, header=None, dtype=dtype).to_numpy()
    except ImportError:
        return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)


# raw directed-edge count above which load_ogb switches to the
# RAM-bounded finalized-edge cache (papers100M territory; products'
# 124M directed edges stay on the simple path by a hair under the
# reference's own RAM expectations)
_OGB_MMAP_EDGES = 200_000_000

# chunk for one-time cache construction passes
_CACHE_CHUNK = 1 << 25


def _npz_member_shape(path: str, member: str):
    """Shape of one array inside an .npz WITHOUT decompressing it."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        with zf.open(member + ".npy") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
    return shape


def _build_finalized_edge_cache(cache: str, edges, num_nodes: int,
                                chunk: int = _CACHE_CHUNK) -> None:
    """One-time chunked symmetrize + self-loop-normalize of a raw
    directed [E, 2] edge array into int32/int64 memmaps.

    Writes src.npy / dst.npy (mirrored non-self edges then one self loop
    per node — the chunked equivalent of load_ogb's concat + finalize,
    reference helper/utils.py:94-95) plus in_deg.npy (f32 finalized
    in-degrees) and meta.json. Edge scratch stays O(chunk); `edges` may
    be a memmap (plain layout) or an in-RAM array (npz layout, where
    decompression already materialized it)."""
    os.makedirs(cache, exist_ok=True)
    E = int(edges.shape[0])
    dtype = np.int32 if num_nodes <= np.iinfo(np.int32).max else np.int64
    keep = 0
    in_deg = np.zeros(num_nodes, np.int64)
    for i0 in range(0, E, chunk):
        e = np.asarray(edges[i0:i0 + chunk])
        u, v = e[:, 0], e[:, 1]
        # validate once here, while the pages are hot — meta.json is
        # only written after every chunk passed, so load never re-checks
        if e.size and (int(e.max()) >= num_nodes or int(e.min()) < 0):
            raise ValueError(f"edge ids out of range in chunk at {i0}")
        ns = u != v
        keep += int(ns.sum())
        # symmetric graph: each non-self raw edge lands in both degrees
        in_deg += np.bincount(v[ns], minlength=num_nodes)
        in_deg += np.bincount(u[ns], minlength=num_nodes)
    e_final = 2 * keep + num_nodes
    src_mm = np.lib.format.open_memmap(
        os.path.join(cache, "src.npy.tmp"), mode="w+", dtype=dtype,
        shape=(e_final,))
    dst_mm = np.lib.format.open_memmap(
        os.path.join(cache, "dst.npy.tmp"), mode="w+", dtype=dtype,
        shape=(e_final,))
    pos = 0
    for flip in (False, True):
        for i0 in range(0, E, chunk):
            e = np.asarray(edges[i0:i0 + chunk])
            u, v = e[:, 0], e[:, 1]
            ns = u != v
            uu, vv = u[ns], v[ns]
            if flip:
                uu, vv = vv, uu
            src_mm[pos:pos + uu.size] = uu.astype(dtype)
            dst_mm[pos:pos + vv.size] = vv.astype(dtype)
            pos += uu.size
    loop = np.arange(num_nodes, dtype=dtype)
    src_mm[pos:] = loop
    dst_mm[pos:] = loop
    src_mm.flush()
    dst_mm.flush()
    del src_mm, dst_mm
    np.save(os.path.join(cache, "in_deg.npy"),
            (in_deg + 1).astype(np.float32))  # +1: the self loop
    # meta last + atomic renames: a crashed build never half-validates
    os.replace(os.path.join(cache, "src.npy.tmp"),
               os.path.join(cache, "src.npy"))
    os.replace(os.path.join(cache, "dst.npy.tmp"),
               os.path.join(cache, "dst.npy"))
    with open(os.path.join(cache, "meta.json"), "w") as f:
        json.dump({"num_nodes": num_nodes, "raw_edges": E,
                   "final_edges": e_final}, f)


def _edge_cache_ready(cache: str, num_nodes: int, raw_edges: int) -> bool:
    meta = os.path.join(cache, "meta.json")
    if not os.path.exists(meta):
        return False
    with open(meta) as f:
        m = json.load(f)
    return (m.get("num_nodes") == num_nodes
            and m.get("raw_edges") == raw_edges)


def load_ogb(name: str, root: str,
             mmap: Optional[bool] = None) -> Graph:
    """ogbn-products / ogbn-papers100M from OGB's extracted raw layouts.

    Handles both on-disk flavors: plain arrays (`raw/{edge,node-feat,
    node-label}.{npy,csv.gz}`, used by ogbn-products) and compressed-npz
    (`raw/data.npz` + `raw/node-label.npz`, used by ogbn-papers100M).
    papers100M labels are float with NaN for unlabeled nodes; they are
    converted to int64 with -1 for unlabeled. Masks are rebuilt from the
    split index files like reference helper/utils.py:17-30.

    `mmap` (default: auto at papers100M scale) switches to the
    RAM-bounded path the reference solves with a >=120 GB host
    (reference README.md:29-30, helper/utils.py:17-30): a one-time
    chunked pass writes a finalized-edge cache (mirrored, self-loop
    normalized, int32, plus in-degrees) under raw/finalized_cache/, and
    the returned Graph memmaps src/dst/feat — so repeat runs touch only
    the pages the partition build streams through. The npz flavor still
    materializes each compressed member once while building the cache
    (inherent to the format); the plain-npy flavor never does."""
    dirname = name.replace("-", "_")
    base = os.path.join(root, dirname)
    raw = os.path.join(base, "raw")

    num_nodes = None
    data_npz = os.path.join(raw, "data.npz")
    npz_layout = os.path.exists(data_npz)
    if npz_layout:
        n_raw_edges = int(np.prod(_npz_member_shape(
            data_npz, "edge_index"))) // 2
        num_nodes = int(_npz_member_shape(data_npz, "node_feat")[0])
    else:
        edge_npy = os.path.join(raw, "edge.npy")
        if os.path.exists(edge_npy):
            n_raw_edges = int(np.load(edge_npy, mmap_mode="r")
                              .reshape(-1, 2).shape[0])
        else:
            n_raw_edges = 0  # csv flavor: small datasets only
            if mmap:
                import warnings

                warnings.warn(f"{name}: csv.gz edge flavor cannot build "
                              "the finalized-edge cache; ignoring mmap")
                mmap = False
    if mmap is None:
        mmap = n_raw_edges >= _OGB_MMAP_EDGES

    def _load_any(stem: str, dtype, mmap_mode=None):
        npy = os.path.join(raw, stem + ".npy")
        if os.path.exists(npy):
            return np.load(npy, mmap_mode=mmap_mode)
        csv = os.path.join(raw, stem + ".csv.gz")
        if os.path.exists(csv):
            return _read_csv_gz(csv, dtype)
        raise FileNotFoundError(f"{name}: missing {stem} under {raw}")

    # ---- node label (N-sized: always in RAM) --------------------------
    if npz_layout:
        label_f = np.load(os.path.join(raw, "node-label.npz"))["node_label"]
        label_f = np.asarray(label_f, dtype=np.float64).reshape(-1)
    else:
        label_f = np.asarray(_load_any("node-label", np.float64),
                             np.float64).reshape(-1)
    label = np.where(np.isnan(label_f), -1, label_f).astype(np.int64)

    # ---- features -----------------------------------------------------
    feat_cache = os.path.join(raw, "finalized_cache", "feat.npy")
    feat_meta = feat_cache + ".meta.json"
    if mmap and npz_layout:
        # one-time extraction so repeat runs memmap instead of
        # decompressing the 50+ GB member; stamped with the source's
        # size+mtime so a re-downloaded data.npz invalidates the cache
        # (existence alone would silently serve stale features)
        st = os.stat(data_npz)
        stamp = {"size": st.st_size, "mtime": st.st_mtime}
        fresh = False
        if os.path.exists(feat_cache) and os.path.exists(feat_meta):
            with open(feat_meta) as f:
                fresh = json.load(f) == stamp
        if not fresh:
            os.makedirs(os.path.dirname(feat_cache), exist_ok=True)
            f32 = np.load(data_npz)["node_feat"].astype(np.float32)
            np.save(feat_cache + ".tmp.npy", f32)
            os.replace(feat_cache + ".tmp.npy", feat_cache)
            del f32
            with open(feat_meta, "w") as f:
                json.dump(stamp, f)
        feat = np.load(feat_cache, mmap_mode="r")
    elif mmap:
        feat = _load_any("node-feat", np.float32, mmap_mode="r")
    elif npz_layout:
        feat = np.load(data_npz)["node_feat"].astype(np.float32)
    else:
        feat = np.asarray(_load_any("node-feat", np.float32), np.float32)
    num_nodes = int(feat.shape[0])

    # ---- split masks --------------------------------------------------
    split_dir = None
    for cand in ("sales_ranking", "time"):
        p = os.path.join(base, "split", cand)
        if os.path.isdir(p):
            split_dir = p
            break
    if split_dir is None:
        raise FileNotFoundError(f"{name}: no split dir under {base}/split")

    masks = {}
    for part, key in (("train", "train_mask"), ("valid", "val_mask"),
                      ("test", "test_mask")):
        idx = _read_csv_gz(
            os.path.join(split_dir, part + ".csv.gz"), np.int64
        ).reshape(-1)
        m = np.zeros(num_nodes, dtype=bool)
        m[idx] = True
        masks[key] = m

    # ---- edges --------------------------------------------------------
    if mmap:
        cache = os.path.join(raw, "finalized_cache")
        if not _edge_cache_ready(cache, num_nodes, n_raw_edges):
            if npz_layout:
                edges = np.load(data_npz)["edge_index"] \
                    .reshape(2, -1).T  # transient (format forces it)
            else:
                edges = np.load(os.path.join(raw, "edge.npy"),
                                mmap_mode="r").reshape(-1, 2)
            _build_finalized_edge_cache(cache, edges, num_nodes)
            del edges
        src = np.load(os.path.join(cache, "src.npy"), mmap_mode="r")
        dst = np.load(os.path.join(cache, "dst.npy"), mmap_mode="r")
        in_deg = np.load(os.path.join(cache, "in_deg.npy"))
        g = Graph(num_nodes=num_nodes, src=src, dst=dst,
                  ndata={"feat": feat, "label": label, **masks})
        g.ndata["in_deg"] = in_deg
        # bounds were validated once when the cache was built (before
        # meta.json existed); re-streaming ~26 GB of memmap on every
        # warm load would defeat the cache
        return g

    if npz_layout:
        edges = np.load(data_npz)["edge_index"].reshape(2, -1).T \
            .astype(np.int64)
    else:
        edges = np.asarray(_load_any("edge", np.int64),
                           np.int64).reshape(-1, 2)
    # OGB edges are directed; the reference's DGL graphs for these
    # datasets are symmetric — mirror them.
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    g = Graph(
        num_nodes=num_nodes,
        src=src,
        dst=dst,
        ndata={"feat": feat, "label": label, **masks},
    )
    return finalize(g)


def load_yelp(root: str) -> Graph:
    """Yelp from the GraphSAINT raw layout (adj_full.npz, feats.npy,
    class_map.json, role.json), with feature standardization fit on train
    nodes only — reference helper/utils.py:33-71."""
    import scipy.sparse as sp

    d = os.path.join(root, "yelp")
    adj = sp.load_npz(os.path.join(d, "adj_full.npz")).tocoo()
    feats = np.load(os.path.join(d, "feats.npy")).astype(np.float32)
    n = feats.shape[0]
    with open(os.path.join(d, "class_map.json")) as f:
        class_map = json.load(f)
    with open(os.path.join(d, "role.json")) as f:
        role = json.load(f)

    label = np.zeros((n, len(next(iter(class_map.values())))), dtype=np.float32)
    for k, v in class_map.items():
        label[int(k)] = v

    train_mask = np.zeros(n, dtype=bool)
    val_mask = np.zeros(n, dtype=bool)
    test_mask = np.zeros(n, dtype=bool)
    train_mask[role["tr"]] = True
    val_mask[role["va"]] = True
    test_mask[role["te"]] = True
    assert not (train_mask & val_mask).any()
    assert not (train_mask & test_mask).any()
    assert not (val_mask & test_mask).any()
    assert (train_mask | val_mask | test_mask).all()

    # Standardize features with statistics from train nodes only
    # (reference helper/utils.py:66-69 via sklearn StandardScaler).
    mu = feats[train_mask].mean(axis=0)
    sd = feats[train_mask].std(axis=0)
    sd[sd == 0] = 1.0
    feats = (feats - mu) / sd

    g = Graph(
        num_nodes=n,
        src=adj.row.astype(np.int64),
        dst=adj.col.astype(np.int64),
        ndata={
            "feat": feats,
            "label": label,
            "train_mask": train_mask,
            "val_mask": val_mask,
            "test_mask": test_mask,
        },
    )
    return finalize(g)


def load_data(dataset: str, root: Optional[str] = None) -> Graph:
    """Dispatch mirroring reference helper/utils.py:74-96, plus synthetic
    datasets. `root` defaults to $PIPEGCN_DATA or ./dataset."""
    root = root or os.environ.get("PIPEGCN_DATA", "./dataset")
    name = dataset.lower()
    if name == "karate":
        return karate_club()
    if name == "synthetic":
        return synthetic_graph()
    if name == "synthetic-reddit":
        # Reddit-scale shape statistics: 232,965 nodes, ~114.6M directed
        # edges (avg in-degree ~492) in the reference's normalized graph,
        # 602 features, 41 classes. avg_degree counts undirected edges per
        # node before mirroring, so 492 here yields ~114.6M directed edges.
        return synthetic_graph(
            num_nodes=232_965, avg_degree=492, n_feat=602, n_class=41, seed=0
        )
    if name.startswith("synthetic:"):
        parts = name.split(":")[1:]
        nodes, deg, feat, cls = (int(x) for x in parts[:4])
        multilabel = len(parts) > 4 and parts[4] == "ml"
        return synthetic_graph(
            num_nodes=nodes, avg_degree=deg, n_feat=feat, n_class=cls,
            multilabel=multilabel,
        )
    if name == "reddit":
        return load_reddit(root)
    if name in ("ogbn-products", "ogbn-papers100m"):
        return load_ogb(name, root)
    if name == "yelp":
        return load_yelp(root)
    raise ValueError(f"unknown dataset: {dataset}")


def inductive_split(g: Graph) -> "tuple[Graph, Graph, Graph]":
    """(train_g, val_g, test_g) for inductive mode: train graph = subgraph of
    train nodes; val graph = subgraph of train+val; test graph = full graph.
    Reference helper/utils.py:226-230."""
    train_g = g.node_subgraph(g.ndata["train_mask"])
    val_g = g.node_subgraph(g.ndata["train_mask"] | g.ndata["val_mask"])
    return train_g, val_g, g
