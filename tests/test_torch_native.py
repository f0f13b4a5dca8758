"""The port's native host code (pipegcn_tpu_torch/native) against the JAX
package's (pipegcn_tpu/native): byte-identical C++ sources, and with the
native library on, the same metis partitions, locality clusters, radix
argsorts and ShardedGraph builds, array for array; with PIPEGCN_NATIVE=0
both packages take their numpy paths."""

import os
import subprocess
import sys

import numpy as np
import pytest

import pipegcn_tpu.native as jax_native
import pipegcn_tpu_torch.native as port_native
from pipegcn_tpu.graph import datasets as jax_datasets
from pipegcn_tpu.partition import ShardedGraph as JaxShardedGraph
from pipegcn_tpu.partition import partitioner as jax_partitioner
from pipegcn_tpu_torch.graph import datasets as port_datasets
from pipegcn_tpu_torch.partition import partitioner as port_partitioner
from pipegcn_tpu_torch.partition.halo import ShardedGraph
from test_torch_partition import _assert_artifacts_equal

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["synthetic:400:8:12:5", "synthetic:3000:12:8:6"]


@pytest.fixture(scope="module", autouse=True)
def native_on():
    """Both libraries built and loaded (g++ is on this machine): the
    tests below would otherwise compare the numpy paths."""
    assert jax_native.available() and port_native.available()


def _graphs(name):
    return port_datasets.load_data(name), jax_datasets.load_data(name)


@pytest.mark.parametrize("src", ["partitioner.cpp", "halo_builder.cpp"])
def test_sources_are_byte_identical(src):
    def read(pkg):
        with open(os.path.join(ROOT, pkg, "native", src), "rb") as f:
            return f.read()

    assert read("pipegcn_tpu_torch") == read("pipegcn_tpu")


@pytest.mark.parametrize("obj", ["vol", "cut"])
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_native_metis_matches_jax(name, P, obj):
    gp, gj = _graphs(name)
    got = port_partitioner.partition_graph(gp, P, method="metis", obj=obj,
                                           seed=5)
    want = jax_partitioner.partition_graph(gj, P, method="metis", obj=obj,
                                           seed=5)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sorted(np.unique(got)) == list(range(P))


@pytest.mark.parametrize("name,size", [(GRAPHS[0], 64), (GRAPHS[1], 128)])
def test_native_clusters_and_build_match_jax(name, size):
    """locality_clusters with no k cap (native) and the cluster-keyed
    build on native metis parts, against the JAX package's."""
    gp, gj = _graphs(name)
    got = port_partitioner.locality_clusters(gp, target_size=size, seed=2)
    want = jax_partitioner.locality_clusters(gj, target_size=size, seed=2)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert int(got.max()) + 1 == -(-gp.num_nodes // size)
    parts = port_partitioner.partition_graph(gp, 2, method="metis", seed=2)
    _assert_artifacts_equal(
        ShardedGraph.build(gp, parts, n_parts=2, cluster=got),
        JaxShardedGraph.build(gj, parts, n_parts=2, cluster=want))


def test_build_on_the_radix_sort_matches_jax():
    """A graph past 2**20 edges, where ShardedGraph.build's sorts take
    the native radix sort in both packages."""
    name = "synthetic:9000:130:4:3"
    gp, gj = _graphs(name)
    assert gp.num_edges >= 1 << 20
    parts = port_partitioner.partition_graph(gp, 2, method="random",
                                             seed=1)
    _assert_artifacts_equal(ShardedGraph.build(gp, parts, n_parts=2),
                            JaxShardedGraph.build(gj, parts, n_parts=2))


@pytest.mark.parametrize("n,hi", [(1000, 7), (1 << 20, 1 << 40),
                                  ((1 << 20) + 3, 50)])
def test_radix_argsort_is_numpys_stable_argsort(n, hi):
    keys = np.random.default_rng(n).integers(0, hi, n).astype(np.int64)
    want = np.argsort(keys, kind="stable")
    assert np.array_equal(port_native.radix_argsort(keys), want)
    assert np.array_equal(port_native.stable_argsort(keys), want)
    assert np.array_equal(jax_native.radix_argsort(keys), want)


def test_native_off_takes_the_numpy_path_in_both_packages():
    code = (
        "import numpy as np\n"
        "import pipegcn_tpu.native as jn, pipegcn_tpu_torch.native as pn\n"
        "from pipegcn_tpu.graph import datasets as jd\n"
        "from pipegcn_tpu.partition import partitioner as jp\n"
        "from pipegcn_tpu_torch.graph import datasets as pd\n"
        "from pipegcn_tpu_torch.partition import partitioner as pp\n"
        f"g = '{GRAPHS[1]}'\n"
        "a = pp.partition_graph(pd.load_data(g), 4, seed=5)\n"
        "b = jp.partition_graph(jd.load_data(g), 4, seed=5)\n"
        "c = pp.locality_clusters(pd.load_data(g), 128, seed=2)\n"
        "d = jp.locality_clusters(jd.load_data(g), 128, seed=2)\n"
        "print(jn.available(), pn.available(), np.array_equal(a, b),\n"
        "      np.array_equal(c, d))\n")
    env = dict(os.environ, PIPEGCN_NATIVE="0", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False", "True", "True"]


def test_native_and_numpy_paths_differ(monkeypatch):
    """The two metis paths give different (both valid) parts, so the
    comparisons above would see a path taken by one package only."""
    gp, _ = _graphs(GRAPHS[1])
    native = port_partitioner.partition_graph(gp, 4, seed=5)
    monkeypatch.setattr(port_native, "available", lambda: False)
    numpy_parts = port_partitioner.partition_graph(gp, 4, seed=5)
    assert not np.array_equal(native, numpy_parts)
