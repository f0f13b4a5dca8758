"""The port's block-dense aggregation (plain path, CPU) against the JAX
``ops/block_spmm.py``: the stacked tables array for array in every A
encoding (1-bit, int8, bf16, f32) and under a byte budget that spills
blocks, the coverage estimate, ``BlockSpmm`` forward and backward against
``jax.vjp`` of ``make_device_block_spmm_fn`` per remainder transport (the
port's casts replaying JAX's transported values, flips counted), the
decomposition against the CSR mean, and the staged pair lists.

Tolerances: given the same inputs, the dense tile products and the
remainder's sums differ from JAX's only in f32 summation order: rtol
1e-5, atol 1e-6. The casts of identical inputs are bit-exact, so no
transport flip is allowed."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipegcn_tpu.ops.block_spmm as jblk
import pipegcn_tpu_torch.native as port_native
import pipegcn_tpu.ops.bucket_spmm as jbs
from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.ops import block_spmm as pblk
from pipegcn_tpu_torch.ops.bucket_spmm import TransportShare
from pipegcn_tpu_torch.ops.spmm import csr_indptr, csr_transpose, spmm_mean
from pipegcn_tpu_torch.partition.partitioner import locality_clusters
from test_torch_bucket import to_torch
from test_torch_train import one_torch_thread, port_graph, port_sharded

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

CPU = torch.device("cpu")
_SG = {}


def sharded(P, dup=0):
    """A community graph in the cluster layout (dense tiles at tile 16),
    plus ``dup`` extra copies of a few edges (a multigraph: one pair
    repeated ``dup`` times, a few others 3 times)."""
    key = (P, dup)
    if key not in _SG:
        g = synthetic_graph(num_nodes=700, avg_degree=24, n_feat=8,
                            n_class=4, seed=17)
        # the numpy clusters the cases below were laid out for (the native
        # partitioner's differ; tests/test_torch_native.py holds those)
        with mock.patch.object(port_native, "available", lambda: False):
            cluster = locality_clusters(port_graph(g), target_size=96,
                                        seed=0)
        if dup:
            rng = np.random.default_rng(2)
            pick = rng.integers(0, g.num_edges, 6)
            reps = np.concatenate([np.full(dup, pick[0]),
                                   np.repeat(pick[1:], 3)])
            g.src = np.concatenate([g.src, g.src[reps]]).astype(g.src.dtype)
            g.dst = np.concatenate([g.dst, g.dst[reps]]).astype(g.dst.dtype)
        parts = partition_graph(g, P, method="random", seed=0)
        _SG[key] = ShardedGraph.build(g, parts, n_parts=P, cluster=cluster)
    return _SG[key]


def assert_tables_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":  # the port holds bf16 bits
            w = w.view(np.uint16)
        assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)
        np.testing.assert_array_equal(got[k], w, err_msg=k)


# (P, duplicated pair count, tile, byte budget, n_feat_hint): the key of A
# the case pins
CASES = {
    "bits-P1": (1, 0, 16, jblk.DENSE_A_BYTE_BUDGET, 16, "blk_a_bits"),
    "bits-P2": (2, 0, 16, jblk.DENSE_A_BYTE_BUDGET, 16, "blk_a_bits"),
    "bits-P4": (4, 0, 16, jblk.DENSE_A_BYTE_BUDGET, 16, "blk_a_bits"),
    "int8": (2, 2, 16, jblk.DENSE_A_BYTE_BUDGET, 16, "blk_a"),
    "bf16": (2, 200, 16, jblk.DENSE_A_BYTE_BUDGET, 16, "blk_a"),
    "f32": (2, 300, 16, jblk.DENSE_A_BYTE_BUDGET, 16, "blk_a"),
    "int8-tile12": (2, 0, 12, jblk.DENSE_A_BYTE_BUDGET, 16, "blk_a"),
    # 6 blocks of 1-bit 16 x 16 (ties at the cutoff dropped in order)
    "budget": (2, 0, 16, 6 * 16 * 16 // 8, 16, "blk_a_bits"),
    # multigraphs under a budget: the fixpoint's cap shrinks with the bits
    # an entry; a cap that drops every multi-edge block ships 1-bit A
    "budget-bf16": (2, 200, 16, 40 * 16 * 16 // 8, 16, "blk_a"),
    "budget-narrower": (2, 2, 16, 40 * 16 * 16 // 8, 16, "blk_a_bits"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tables_equal_the_jax_build(case):
    P, dup, tile, budget, hint, a_key = CASES[case]
    sg = sharded(P, dup)
    want, wt = jblk.build_sharded_block_tables(
        sg, tile=tile, n_feat_hint=hint, byte_budget=budget)
    stats = {}
    got, gt = pblk.build_sharded_block_tables(
        port_sharded(sg), tile=tile, n_feat_hint=hint, byte_budget=budget,
        stats=stats)
    assert gt == wt == tile
    assert a_key in got
    assert_tables_equal(got, want)
    # the dense path holds a share of the edges, and the remainder too
    cov = sum(stats["dense_edges"]) / sum(stats["edges"])
    assert (0.0 if case.startswith("budget") else 0.05) < cov < 0.95, cov
    if case.startswith("budget"):
        # the cap of the fixpoint's last bits (8 where the shipped 1-bit
        # encoding is narrower than the cap assumed)
        bits = 8 if case == "budget-narrower" else stats["bits"]
        assert max(stats["blocks"]) == stats["cap"] == \
            jblk.budget_block_cap(budget, tile, bits)
    want_dt = {"bf16": "bfloat16", "f32": "float32", "int8": "int8",
               "int8-tile12": "int8", "budget-bf16": "bfloat16"}.get(case)
    if want_dt:
        assert np.asarray(want["blk_a"]).dtype.name == want_dt


def test_a_bits_are_the_packed_f32_blocks():
    """a_stored writes the bytes JAX's pack_a_blocks writes from the f32
    blocks the JAX BlockPlan materializes, and int8/f32 their cast."""
    sg = sharded(2)
    e = pblk.PartEdges(sg.edge_src[0], sg.edge_dst[0], sg.n_max,
                       sg.n_max + sg.halo_size, 16)
    plan = pblk.BlockPlan(e, 16)
    want = jblk.BlockPlan(sg.edge_src[0], sg.edge_dst[0], sg.n_max,
                          sg.n_max + sg.halo_size, 16, tile=16).a_blocks
    assert plan.B == want.shape[0] > 0
    np.testing.assert_array_equal(plan.a_stored(1, plan.B + 2)[:plan.B],
                                  jblk.pack_a_blocks(want))
    assert not plan.a_stored(1, plan.B + 2)[plan.B:].any()
    np.testing.assert_array_equal(plan.a_stored(32, plan.B), want)
    np.testing.assert_array_equal(plan.a_stored(8, plan.B),
                                  want.astype(np.int8))


@pytest.mark.parametrize("P", [1, 2])
def test_coverage_estimate_matches_jax(P):
    sg = sharded(P)
    for tile, hint, nnz in ((16, 16, None), (16, 64, None), (32, 16, 40)):
        assert pblk.estimate_block_coverage(
            port_sharded(sg), tile, hint, nnz) == \
            jblk.estimate_block_coverage(sg, tile, hint, nnz)
    small = 3 * 16 * 16 // 8
    assert pblk.estimate_block_coverage(port_sharded(sg), 16, 16,
                                        byte_budget=small) == \
        jblk.estimate_block_coverage(sg, 16, 16, byte_budget=small)


def _staged(sg, tile=16, hint=16):
    tables, _ = jblk.build_sharded_block_tables(sg, tile=tile,
                                                n_feat_hint=hint)
    np_tables = {k: (np.asarray(v).view(np.uint16)
                     if np.asarray(v).dtype.name == "bfloat16"
                     else np.asarray(v)) for k, v in tables.items()}
    return tables, pblk.stage_block_tables(
        np_tables, tile, sg.n_max, sg.n_max + sg.halo_size, CPU)


@pytest.mark.parametrize("rem,amax", [(None, False), ("bfloat16", False),
                                      ("float8", False), ("float8", True)],
                         ids=["none", "bf16", "fp8", "fp8-amax"])
@pytest.mark.parametrize("dup", [0, 200], ids=["bits", "bf16A"])
def test_block_spmm_matches_jax_vjp(rem, amax, dup):
    P, F = 2, 10
    sg = sharded(P, dup)
    n_src = sg.n_max + sg.halo_size
    tables, staged = _staged(sg)
    rng = np.random.default_rng(9)
    fb = rng.standard_normal((P, n_src, F)).astype(np.float32)
    g = rng.standard_normal((P, sg.n_max, F)).astype(np.float32)
    deg = sg.in_deg.astype(np.float32)
    want_out, want_grad, casts = [], [], []
    for p in range(P):
        fn = jblk.make_device_block_spmm_fn(
            {k: jnp.asarray(v[p]) for k, v in tables.items()},
            jnp.asarray(deg[p]), sg.n_max, n_src, 16,
            rem_dtype=rem, rem_amax=amax)
        want, vjp = jax.vjp(fn, jnp.asarray(fb[p]))
        (wg,) = vjp(jnp.asarray(g[p]))
        want_out.append(np.asarray(want))
        want_grad.append(np.asarray(wg))
    if rem is not None:
        # JAX's transported values of both parts, forward then backward
        fwd_dt, bwd_dt = jbs.transport_dtypes(rem)
        for x, dt in ((fb, fwd_dt), (g / deg[..., None], bwd_dt)):
            ys, invs = [], []
            for p in range(P):
                if amax:
                    y, inv = jbs.amax_transport_cast(jnp.asarray(x[p]), dt)
                    invs.append(float(inv))
                else:
                    y = jbs.transport_cast(jnp.asarray(x[p]), dt)
                ys.append(to_torch(np.asarray(y)))
            casts.append((torch.stack(ys),
                          torch.tensor(invs) if invs else None))
    share = TransportShare.replaying(casts) if rem is not None else None
    x = torch.from_numpy(fb).requires_grad_(True)
    out = pblk.block_spmm(x, staged, torch.from_numpy(deg), rem, amax,
                          share=share)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and out.shape == (P, sg.n_max, F)
    np.testing.assert_allclose(out.detach().numpy(), np.stack(want_out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.stack(want_grad),
                               rtol=1e-5, atol=1e-6)
    if rem is not None:
        assert share.elements == fb.size + g.size
        assert share.flips == 0
        # the transport changes the result: the test sees it on or off
        plain = pblk.block_spmm(x.detach(), staged, torch.from_numpy(deg))
        assert not torch.allclose(out.detach(), plain, rtol=1e-5, atol=0)


def test_block_path_is_the_csr_mean():
    """At transport none the dense tiles plus the remainder compute
    spmm_mean's function: forward and gradient within the f32 summation
    tolerance, on a graph whose tiles are partly dense."""
    P, F = 4, 7
    sg = port_sharded(sharded(P))
    n_src = sg.n_max + sg.halo_size
    tables, _ = pblk.build_sharded_block_tables(sg, tile=16, n_feat_hint=16)
    staged = pblk.stage_block_tables(tables, 16, sg.n_max, n_src, CPU)
    assert int(staged.fwd.ptr[:, -1].sum()) > 0
    rng = np.random.default_rng(4)
    fb = torch.from_numpy(
        rng.standard_normal((P, n_src, F)).astype(np.float32))
    g = torch.from_numpy(
        rng.standard_normal((P, sg.n_max, F)).astype(np.float32))
    deg = torch.from_numpy(sg.in_deg.astype(np.float32))
    indptr = torch.from_numpy(csr_indptr(sg.edge_dst, sg.n_max))
    src = torch.from_numpy(sg.edge_src)
    tr = tuple(torch.from_numpy(a) for a in csr_transpose(
        sg.edge_src, sg.edge_dst, sg.n_max, n_src))
    outs, grads = [], []
    for fn in (lambda x: pblk.block_spmm(x, staged, deg),
               lambda x: spmm_mean(x, indptr, src, deg, tr)):
        x = fb.clone().requires_grad_(True)
        out = fn(x)
        out.backward(g)
        outs.append(out.detach())
        grads.append(x.grad)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5, atol=1e-6)


def test_pair_lists_follow_the_class_order():
    """Each output tile's pairs are its class row's non-pad entries, left
    to right; tiles without a row have none; the transpose lists hold the
    same blocks keyed by source tile."""
    sg = sharded(2)
    tables, staged = _staged(sg)
    b_max = int(np.asarray(tables["blk_a_bits"]).shape[1])
    for direction, side in (("fwd", staged.fwd), ("bwd", staged.bwd)):
        keys = sorted(k[:-1] for k in tables
                      if k.startswith(f"blk_{direction}_g")
                      and k.endswith("b"))
        ginv = np.asarray(tables[f"blk_{direction}_ginv"])
        for p in range(2):
            flat = []
            for k in keys:
                b, t = np.asarray(tables[k + "b"])[p], \
                    np.asarray(tables[k + "t"])[p]
                flat += [(b[r], t[r]) for r in range(b.shape[0])]
            ptr = side.ptr[p].numpy()
            for i in range(ginv.shape[1]):
                got_b = side.blk[p, ptr[i]:ptr[i + 1]].numpy()
                got_t = side.tile[p, ptr[i]:ptr[i + 1]].numpy()
                if ginv[p, i] == len(flat):
                    assert got_b.size == 0
                    continue
                b, t = flat[ginv[p, i]]
                keep = b != b_max
                np.testing.assert_array_equal(got_b, b[keep])
                np.testing.assert_array_equal(got_t, t[keep])
    for p in range(2):
        assert sorted(staged.fwd.blk[p, :int(staged.fwd.ptr[p, -1])]
                      .tolist()) == sorted(
            staged.bwd.blk[p, :int(staged.bwd.ptr[p, -1])].tolist())


@pytest.mark.parametrize("stem,value", [("blk_fwd_g", 10 ** 6),
                                        ("blk_bwd_ginv", -1)])
def test_staging_refuses_a_corrupt_index(stem, value):
    """A tile index past the input's tiles, or a negative row in an inv:
    the kernels trust the staged lists, so staging checks them."""
    sg = port_sharded(sharded(2))
    tables, _ = pblk.build_sharded_block_tables(sg, tile=16, n_feat_hint=16)
    key = next(k for k in sorted(tables) if k.startswith(stem)
               and k[-1] in "tv")
    bad = dict(tables)
    bad[key] = tables[key].copy()
    if key.endswith("t"):
        b = tables[key[:-1] + "b"]
        bad[key][b != tables["blk_a_bits"].shape[1]] = value
    else:
        bad[key].flat[0] = value
    with pytest.raises(ValueError, match="out of"):
        pblk.stage_block_tables(bad, 16, sg.n_max,
                                sg.n_max + sg.halo_size, CPU)


def test_group_and_unknown_encodings_refuse():
    """The union-gather kernels (K16 / K17) refuse per-tile pair lists;
    every kernel refuses an A encoding it does not know."""
    sg = port_sharded(sharded(1))
    tables, _ = pblk.build_sharded_block_tables(sg, tile=16, n_feat_hint=16)
    staged = pblk.stage_block_tables(tables, 16, sg.n_max,
                                     sg.n_max + sg.halo_size, CPU)
    x = torch.zeros((1, sg.n_max + sg.halo_size, 3))
    with pytest.raises(ValueError, match="union-gather"):
        pblk.block_dense_grouped(x, staged)
    staged.a = staged.a.to(torch.int16)
    with pytest.raises(ValueError, match="encoding"):
        pblk.block_dense(x, staged)
