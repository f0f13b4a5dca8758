"""The port's GraphSAGE against the JAX package: parameter shapes and
bounds, the params_from_jax round trip, and the halo_eval forward under
shard_map against the port's stacked forward with the converted params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.models import sage as jsage
from pipegcn_tpu.parallel.halo import halo_exchange as jax_halo_exchange
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.models import (ModelConfig, forward, init_params,
                                      params_from_jax)
from pipegcn_tpu_torch.parallel.halo import halo_exchange
from pipegcn_tpu_torch.parallel.staging import precompute_pp, stage

pytestmark = pytest.mark.torch

CPU = torch.device("cpu")


def _cfgs(use_pp, sizes=(10, 16, 16, 5)):
    return (jsage.ModelConfig(layer_sizes=sizes, use_pp=use_pp,
                              norm="layer", dropout=0.0, sorted_edges=True),
            ModelConfig(layer_sizes=sizes, use_pp=use_pp, norm="layer"))


def _jax_params_np(jcfg, seed=0, perturb=True):
    """JAX init_params as numpy, with norms moved off their (1, 0) init
    so the conversion of scale/bias is exercised."""
    tree = jax.tree_util.tree_map(
        np.asarray, jsage.init_params(jax.random.PRNGKey(seed), jcfg))
    if perturb:
        rng = np.random.default_rng(seed)
        for n in tree["norms"]:
            n["scale"] = (1 + 0.3 * rng.standard_normal(n["scale"].shape)
                          ).astype(np.float32)
            n["bias"] = (0.2 * rng.standard_normal(n["bias"].shape)
                         ).astype(np.float32)
    return tree


@pytest.mark.parametrize("use_pp", [False, True], ids=["plain", "pp"])
def test_init_params_shapes_and_bounds_match_jax(use_pp):
    jcfg, cfg = _cfgs(use_pp)
    jt = _jax_params_np(jcfg, perturb=False)
    pt = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert len(pt["layers"]) == len(jt["layers"])
    assert len(pt["norms"]) == len(jt["norms"])
    for i, (pl, jl) in enumerate(zip(pt["layers"], jt["layers"])):
        assert sorted(pl) == sorted(jl)
        for k in jl:
            assert tuple(pl[k].shape) == jl[k].shape, (i, k)
            bound = max(float(np.abs(jl[k]).max()), 1e-9)
            fan_in = jl["w" if "w" in jl else "w1"].shape[0]
            assert float(pl[k].abs().max()) <= fan_in ** -0.5
            assert bound <= fan_in ** -0.5
    for pn, jn in zip(pt["norms"], jt["norms"]):
        for k in jn:
            np.testing.assert_array_equal(pn[k].numpy(), jn[k])


def test_params_from_jax_round_trip():
    jcfg, _ = _cfgs(True)
    tree = _jax_params_np(jcfg)
    pt = params_from_jax(tree, CPU)
    for pl, jl in zip(pt["layers"], tree["layers"]):
        for k in jl:
            assert pl[k].dtype == torch.float32
            np.testing.assert_array_equal(pl[k].numpy(), jl[k])
    for pn, jn in zip(pt["norms"], tree["norms"]):
        for k in jn:
            np.testing.assert_array_equal(pn[k].numpy(), jn[k])


def _jax_forward_stacked(params, jcfg, h, sg):
    P = sg.num_parts
    mesh = Mesh(np.array(jax.devices()[:P]), ("parts",))
    spec = PartitionSpec("parts")
    repl = PartitionSpec()

    def body(params, h, es, ed, deg, idx, mask):
        def comm(i, x):
            return jax_halo_exchange(x, idx[0], mask[0], "parts", P)

        out, _ = jsage.forward(params, jcfg, h[0], es[0], ed[0], deg[0],
                               sg.n_max, training=False, halo_eval=True,
                               comm_update=comm)
        return out[None]

    run = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(jax.tree_util.tree_map(lambda _: repl, params),)
        + (spec,) * 6, out_specs=spec))
    return np.asarray(run(params, jnp.asarray(h), sg.edge_src, sg.edge_dst,
                          sg.in_deg, sg.send_idx, sg.send_mask))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("use_pp", [False, True], ids=["plain", "pp"])
def test_halo_eval_forward_matches_jax(P, use_pp):
    g = synthetic_graph(num_nodes=320, avg_degree=10, n_feat=10, n_class=5,
                        seed=7)
    sg = ShardedGraph.build(g, partition_graph(g, P, method="random"),
                            n_parts=P)
    jcfg, cfg = _cfgs(use_pp)
    tree = _jax_params_np(jcfg, seed=P)
    data = stage(sg, CPU)
    h = precompute_pp(data) if use_pp else data.feat
    if use_pp:
        # the pp input itself: [feat, mean_neigh] from the JAX pieces
        fbuf = _jax_stacked_exchange(sg)
        ah = np.stack([np.asarray(jsage.spmm_mean(
            fbuf[p], sg.edge_src[p], sg.edge_dst[p], sg.in_deg[p],
            sg.n_max, None, True)) for p in range(P)])
        np.testing.assert_allclose(
            h.numpy(), np.concatenate([sg.feat, ah], -1), rtol=1e-5,
            atol=1e-6)
    want = _jax_forward_stacked(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, h.numpy(), sg)
    got = forward(params_from_jax(tree, CPU), cfg, h, data.indptr,
                  data.edge_src, data.in_deg,
                  comm_update=lambda i, x: halo_exchange(
                      x, data.send_idx, data.send_mask))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (P, sg.n_max, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_stacked_exchange(sg):
    P = sg.num_parts
    mesh = Mesh(np.array(jax.devices()[:P]), ("parts",))
    spec = PartitionSpec("parts")
    run = jax.jit(jax.shard_map(
        lambda h, i, m: jax_halo_exchange(h[0], i[0], m[0], "parts",
                                          P)[None],
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
    return np.asarray(run(sg.feat, sg.send_idx, sg.send_mask))


def test_unported_configs_refuse():
    for kw in ({"model": "gcn", "spmm_impl": "auto"},
               {"spmm_impl": "auto"},
               {"norm": "batch"}, {"dropout_bits": 8}, {"n_linear": 1}):
        with pytest.raises(NotImplementedError):
            ModelConfig(layer_sizes=(4, 8, 3), **kw)
