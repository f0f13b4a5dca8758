"""The port's host layer (graph loaders, partitioner, ShardedGraph build /
save / load) against the JAX package's: the same dataset and partition
method give equal graphs, partitions and artifacts, array for array, and
an artifact saved by either package loads in the other unchanged."""

import dataclasses

import numpy as np
import pytest

import pipegcn_tpu.native
import pipegcn_tpu_torch.native
from pipegcn_tpu.graph import datasets as jax_datasets
from pipegcn_tpu.partition import ShardedGraph as JaxShardedGraph
from pipegcn_tpu.partition import partition_graph as jax_partition_graph
from pipegcn_tpu.partition import partitioner as jax_partitioner
from pipegcn_tpu_torch.graph import datasets as port_datasets
from pipegcn_tpu_torch.graph.synthetic import synthetic_graph
from pipegcn_tpu_torch.partition.halo import ShardedGraph
from pipegcn_tpu_torch.partition import partitioner as port_partitioner
from pipegcn_tpu_torch.partition.partitioner import (locality_clusters,
                                                     partition_graph)

pytestmark = pytest.mark.torch

DATASETS = ["karate", "synthetic", "synthetic:400:8:12:5",
            "synthetic:300:6:10:4:ml"]
FIELDS = [f.name for f in dataclasses.fields(ShardedGraph)
          if f.name != "cache_dir"]


@pytest.fixture
def numpy_partitioner(monkeypatch):
    """Both packages on their numpy metis path (native partitioner off);
    tests/test_torch_native.py holds the native path."""
    monkeypatch.setattr(pipegcn_tpu.native, "available", lambda: False)
    monkeypatch.setattr(pipegcn_tpu_torch.native, "available", lambda: False)


def _assert_graphs_equal(got, want):
    assert got.num_nodes == want.num_nodes
    for k in ("src", "dst"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert sorted(got.ndata) == sorted(want.ndata)
    for k, v in want.ndata.items():
        assert got.ndata[k].dtype == v.dtype, k
        assert np.array_equal(got.ndata[k], v), k


def _assert_artifacts_equal(got, want):
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), k
        else:
            assert a == b, k


@pytest.mark.parametrize("dataset", DATASETS)
def test_load_data_matches_jax(dataset):
    _assert_graphs_equal(port_datasets.load_data(dataset),
                         jax_datasets.load_data(dataset))


def test_synthetic_reddit_matches_jax(monkeypatch):
    """``synthetic-reddit`` (114.85M edges) is too large for a CPU test:
    both loaders must hand the generator the same arguments, and the
    generator is held at Reddit's degree and widths on fewer nodes."""
    calls = {}
    for name, mod in (("port", port_datasets), ("jax", jax_datasets)):
        monkeypatch.setattr(mod, "synthetic_graph",
                            lambda *a, _n=name, **kw: calls.setdefault(
                                _n, (a, kw)))
        mod.load_data("synthetic-reddit")
    assert calls["port"] == calls["jax"]
    assert calls["port"][1]["avg_degree"] == 492
    monkeypatch.undo()
    kw = dict(calls["port"][1], num_nodes=2_000)
    _assert_graphs_equal(synthetic_graph(**kw),
                         jax_datasets.synthetic_graph(**kw))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("method", ["random", "metis"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_partition_and_build_match_jax(dataset, method, P,
                                       numpy_partitioner):
    g_port = port_datasets.load_data(dataset)
    g_jax = jax_datasets.load_data(dataset)
    parts = partition_graph(g_port, P, method=method, seed=3)
    want_parts = jax_partition_graph(g_jax, P, method=method, seed=3)
    assert parts.dtype == want_parts.dtype
    assert np.array_equal(parts, want_parts)
    _assert_artifacts_equal(ShardedGraph.build(g_port, parts, n_parts=P),
                            JaxShardedGraph.build(g_jax, want_parts,
                                                  n_parts=P))


@pytest.mark.parametrize("dataset,size", [("karate", 8),
                                          ("synthetic:400:8:12:5", 64),
                                          ("synthetic:300:6:10:4:ml", 32),
                                          ("synthetic", 1024)])
def test_cluster_layout_matches_jax(dataset, size, numpy_partitioner):
    """locality_clusters (the numpy metis path, k = ceil(n / size)) and
    ShardedGraph.build(cluster=...) against the JAX package's, array for
    array; a graph at or below the size gets one cluster."""
    g_port = port_datasets.load_data(dataset)
    g_jax = jax_datasets.load_data(dataset)
    got = locality_clusters(g_port, target_size=size, seed=3)
    want = jax_partitioner.locality_clusters(g_jax, target_size=size, seed=3)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    k = -(-g_port.num_nodes // size)
    assert int(got.max()) + 1 == k and (k > 1 or not got.any())
    parts = partition_graph(g_port, 2, method="random", seed=1)
    built = ShardedGraph.build(g_port, parts, n_parts=2, cluster=got)
    _assert_artifacts_equal(built, JaxShardedGraph.build(
        g_jax, parts, n_parts=2, cluster=want))
    if k > 1:  # the key reorders: not the base layout
        base = ShardedGraph.build(g_port, parts, n_parts=2)
        assert not np.array_equal(built.edge_src, base.edge_src)
    assert port_partitioner.DEFAULT_CLUSTER_SIZE == \
        jax_partitioner.DEFAULT_CLUSTER_SIZE
    assert port_partitioner.cluster_suffix(size) == \
        jax_partitioner.cluster_suffix(size)


@pytest.mark.parametrize("mmap", [False, True], ids=["v2", "v3"])
def test_artifact_round_trips_between_packages(tmp_path, mmap):
    g = port_datasets.load_data("synthetic:400:8:12:5")
    parts = partition_graph(g, 4, method="random", seed=1)
    sg = ShardedGraph.build(g, parts, n_parts=4)
    jsg = JaxShardedGraph.build(jax_datasets.load_data(
        "synthetic:400:8:12:5"), parts, n_parts=4)
    sg.save(str(tmp_path / "port"), mmap=mmap)
    jsg.save(str(tmp_path / "jax"), mmap=mmap)
    assert ShardedGraph.exists(str(tmp_path / "jax"))
    _assert_artifacts_equal(JaxShardedGraph.load(str(tmp_path / "port")),
                            jsg)
    _assert_artifacts_equal(ShardedGraph.load(str(tmp_path / "jax")), sg)
    _assert_artifacts_equal(ShardedGraph.load(str(tmp_path / "port")), sg)
