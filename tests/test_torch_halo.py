"""The port's stacked-parts halo exchange (plain path, CPU) against the JAX
exchange_blocks / halo_exchange under shard_map on the CPU mesh:
bit-exact, including masked-off slots and clipped indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.parallel.halo import exchange_blocks as jax_exchange
from pipegcn_tpu.parallel.halo import halo_exchange as jax_halo_exchange
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.parallel.halo import exchange_blocks, halo_exchange

pytestmark = pytest.mark.torch


def _jax_stacked(fn, P, h, idx, mask):
    """Run a per-shard JAX halo function on P CPU devices over stacked
    [P, ...] inputs; returns the stacked [P, ...] result as numpy."""
    mesh = Mesh(np.array(jax.devices()[:P]), ("parts",))
    spec = PartitionSpec("parts")

    def body(h, idx, mask):
        return fn(h[0], idx[0], mask[0], "parts", P)[None]

    run = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                                out_specs=spec))
    return np.asarray(run(jnp.asarray(h), jnp.asarray(idx),
                          jnp.asarray(mask)))


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


def _case(P, n_max, B, F, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((P, n_max, F)).astype(np.float32)
    h[0, 0, 0] = np.nan
    h[P - 1, 1, 0] = -0.0
    idx = rng.integers(-3, n_max + 3, (P, P - 1, B)).astype(np.int32)
    mask = rng.random((P, P - 1, B)) < 0.7
    return h, idx, mask


@pytest.mark.parametrize("P", [2, 4])
def test_exchange_blocks_bit_exact_random(P):
    """Random send lists with out-of-range (clipped) indices, masked-off
    slots, NaN and -0.0 payloads."""
    h, idx, mask = _case(P, n_max=20, B=7, F=5, seed=P)
    want = _jax_stacked(jax_exchange, P, h, idx, mask)
    got = exchange_blocks(torch.from_numpy(h), torch.from_numpy(idx),
                          torch.from_numpy(mask)).numpy()
    assert got.shape == (P, (P - 1) * 7, 5)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    full = halo_exchange(torch.from_numpy(h), torch.from_numpy(idx),
                         torch.from_numpy(mask)).numpy()
    want_full = _jax_stacked(jax_halo_exchange, P, h, idx, mask)
    np.testing.assert_array_equal(_bits(full), _bits(want_full))


def test_exchange_blocks_bit_exact_bf16():
    P = 4
    h, idx, mask = _case(P, n_max=16, B=5, F=6, seed=9)
    # one rounding to bf16 (the frameworks encode NaN differently), the
    # same bits handed to both
    hb = np.asarray(jnp.asarray(h, jnp.bfloat16))
    want = _jax_stacked(jax_halo_exchange, P, hb, idx, mask)
    got = halo_exchange(torch.from_numpy(hb.view(np.int16).copy())
                        .view(torch.bfloat16),
                        torch.from_numpy(idx), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("P", [2, 4])
def test_halo_exchange_on_sharded_graph(P):
    """The real send lists of a ShardedGraph: the halo rows land in the
    slots its edge_src numbering expects."""
    g = synthetic_graph(num_nodes=240, avg_degree=8, n_feat=6, n_class=3,
                        seed=5)
    sg = ShardedGraph.build(g, partition_graph(g, P, method="random"),
                            n_parts=P)
    want = _jax_stacked(jax_halo_exchange, P, sg.feat, sg.send_idx,
                        sg.send_mask)
    got = halo_exchange(torch.from_numpy(sg.feat),
                        torch.from_numpy(sg.send_idx),
                        torch.from_numpy(sg.send_mask)).numpy()
    assert got.shape == (P, sg.n_max + sg.halo_size, sg.n_feat)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # every halo row used by an edge holds its global owner's features
    nid = sg.global_nid
    for r in range(P):
        e = int(sg.edge_count[r])
        s = sg.edge_src[r, :e]
        halo = s >= sg.n_max
        k = s[halo] - sg.n_max
        d = k // sg.b_max + 1
        owner = (r - d) % P
        rows = sg.send_idx[owner, d - 1, k % sg.b_max]
        np.testing.assert_array_equal(got[r, s[halo]],
                                      g.ndata["feat"][nid[owner, rows]])


def test_single_part_has_no_halo():
    h = torch.randn(1, 5, 3)
    idx = torch.zeros((1, 0, 4), dtype=torch.int32)
    mask = torch.zeros((1, 0, 4), dtype=torch.bool)
    assert halo_exchange(h, idx, mask) is h
    assert exchange_blocks(h, idx, mask).shape == (1, 0, 3)
