"""The port's mean SpMM (plain path, CPU) against the JAX spmm_mean, on the
padded, dst-sorted per-part edge lists of a real ShardedGraph."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.ops.spmm import spmm_mean as jax_spmm_mean
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.ops.spmm import csr_indptr, spmm_mean

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module", params=[2, 4])
def sg(request):
    g = synthetic_graph(num_nodes=300, avg_degree=10, n_feat=8, n_class=4,
                        seed=11)
    parts = partition_graph(g, request.param, method="random", seed=0)
    return ShardedGraph.build(g, parts, n_parts=request.param)


def _fbuf(sg, F, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (sg.num_parts, sg.n_max + sg.halo_size, F)).astype(np.float32)


@pytest.mark.parametrize("chunk", [None, 64], ids=["unchunked", "chunk64"])
def test_f32_matches_jax(sg, chunk):
    F = 16
    fb = _fbuf(sg, F, seed=1)
    indptr = torch.from_numpy(csr_indptr(sg.edge_dst, sg.n_max))
    src = torch.from_numpy(sg.edge_src)
    deg = torch.from_numpy(sg.in_deg)
    stacked = spmm_mean(torch.from_numpy(fb), indptr, src, deg).numpy()
    for p in range(sg.num_parts):
        want = np.asarray(jax_spmm_mean(
            jnp.asarray(fb[p]), jnp.asarray(sg.edge_src[p]),
            jnp.asarray(sg.edge_dst[p]), jnp.asarray(sg.in_deg[p]),
            sg.n_max, chunk, True))
        got = spmm_mean(torch.from_numpy(fb[p]), indptr[p], src[p],
                        deg[p]).numpy()
        assert got.dtype == np.float32 and got.shape == (sg.n_max, F)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(stacked[p], got)


def test_bf16_fbuf_matches_jax(sg):
    """bf16 messages, f32 accumulation and output on both sides (the
    same numpy values rounded to bf16 by each framework)."""
    fb = _fbuf(sg, 12, seed=2)
    indptr = torch.from_numpy(csr_indptr(sg.edge_dst, sg.n_max))
    for p in range(sg.num_parts):
        want = np.asarray(jax_spmm_mean(
            jnp.asarray(fb[p], jnp.bfloat16), jnp.asarray(sg.edge_src[p]),
            jnp.asarray(sg.edge_dst[p]), jnp.asarray(sg.in_deg[p]),
            sg.n_max, None, True))
        got = spmm_mean(torch.from_numpy(fb[p]).bfloat16(), indptr[p],
                        torch.from_numpy(sg.edge_src[p]),
                        torch.from_numpy(sg.in_deg[p]))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-3)


def test_padding_contract_and_indptr(sg):
    """Pad edges (dst = n_out, src = row 0) end the dst-sorted list:
    indptr[n_out] is the real edge count, rows match a searchsorted CSR,
    and whatever a pad edge's src holds is never read."""
    indptr = csr_indptr(sg.edge_dst, sg.n_max)
    assert indptr.dtype == np.int32
    assert indptr.shape == (sg.num_parts, sg.n_max + 1)
    for p in range(sg.num_parts):
        e = int(sg.edge_count[p])
        assert indptr[p, -1] == e
        assert (sg.edge_dst[p, e:] == sg.n_max).all()
        assert (sg.edge_src[p, e:] == 0).all()
        np.testing.assert_array_equal(
            indptr[p], np.searchsorted(sg.edge_dst[p],
                                       np.arange(sg.n_max + 1)))
    fb = torch.from_numpy(_fbuf(sg, 4, seed=3))
    src = sg.edge_src.copy()
    for p in range(sg.num_parts):
        src[p, sg.edge_count[p]:] = sg.n_max + sg.halo_size - 1
    args = (torch.from_numpy(indptr), torch.from_numpy(sg.in_deg))
    a = spmm_mean(fb, args[0], torch.from_numpy(sg.edge_src), args[1])
    b = spmm_mean(fb, args[0], torch.from_numpy(src), args[1])
    assert torch.equal(a, b)
    # int64 row pointers give the same result
    c = spmm_mean(fb, args[0].long(), torch.from_numpy(sg.edge_src), args[1])
    assert torch.equal(a, c)


def test_indptr_rejects_bad_edge_lists():
    with pytest.raises(ValueError, match="not sorted"):
        csr_indptr(np.array([0, 2, 1, 3]), 3)
    with pytest.raises(ValueError, match="outside"):
        csr_indptr(np.array([0, 1, 5]), 3)
    ip = csr_indptr(np.array([0, 0, 2, 3, 3]), 3)
    np.testing.assert_array_equal(ip, [0, 2, 2, 3])


def test_empty_rows_and_degree_division():
    # row 1 has no edges (exact zero), row 2 one edge, in_deg from the
    # full graph (not the local count) divides
    fb = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    indptr = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    src = torch.tensor([0, 3, 1, 0, 0], dtype=torch.int32)
    deg = torch.tensor([4.0, 1.0, 2.0])
    out = spmm_mean(fb, indptr, src, deg)
    np.testing.assert_allclose(out.numpy(), [
        [(0 + 9) / 4, (1 + 10) / 4, (2 + 11) / 4], [0, 0, 0],
        [3 / 2, 4 / 2, 5 / 2]])
