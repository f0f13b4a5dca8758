"""The port's Trainer (plain path, CPU) against the JAX Trainer with
emulate_parts=True, from the same converted params at dropout 0: per-epoch
losses over 10 epochs (rtol 1e-4), the comm carries after 3 epochs (rtol
1e-5), params and Adam moments after 10 (rtol 1e-4), for P in {1, 2, 4} x
{vanilla, pipelined, pipelined + feat/grad corrections}. This file runs
the use_pp configurations (test_torch_train_nopp.py the others) and the
full-graph eval, dropout and refusal tests.

The atol beside each rtol covers entries near zero, whose relative error
the summation order alone can make large."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.models.sage import ModelConfig as JaxModelConfig
from pipegcn_tpu.parallel.trainer import TrainConfig as JaxTrainConfig
from pipegcn_tpu.parallel.trainer import Trainer as JaxTrainer
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.graph.csr import Graph
from pipegcn_tpu_torch.models import ModelConfig, first_copy, params_from_jax
from pipegcn_tpu_torch.models.sage import _dropout, forward
from pipegcn_tpu_torch.parallel.trainer import (TrainConfig, Trainer,
                                                epoch_generator)
from pipegcn_tpu_torch.partition.halo import ShardedGraph as PortSharded
from pipegcn_tpu_torch.tree import tree_leaves

pytestmark = pytest.mark.torch

CPU = torch.device("cpu")
SIZES = (12, 16, 16, 5)
MODES = {
    "vanilla": dict(enable_pipeline=False),
    "pipelined": dict(enable_pipeline=True),
    "corr": dict(enable_pipeline=True, feat_corr=True, grad_corr=True),
}
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port: the suite runs several test
    processes on a few cores, where torch's OpenMP pools oversubscribe
    them (the port's test files ran ~4x longer with the default pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def graph():
    # label noise keeps accuracy off 100 %, so eval comparisons bite
    if "g" not in _CACHE:
        _CACHE["g"] = synthetic_graph(num_nodes=360, avg_degree=8,
                                      n_feat=12, n_class=5, seed=3,
                                      label_noise=0.3)
    return _CACHE["g"]


def sharded(P):
    if P not in _CACHE:
        g = graph()
        _CACHE[P] = ShardedGraph.build(
            g, partition_graph(g, P, method="random", seed=0), n_parts=P)
    return _CACHE[P]


def port_sharded(sg):
    """The port's ShardedGraph holding the JAX build's arrays (the two
    builds are equal array for array, tests/test_torch_partition.py)."""
    return PortSharded(**{f.name: getattr(sg, f.name)
                          for f in dataclasses.fields(PortSharded)})


def port_graph(g):
    return Graph(num_nodes=g.num_nodes, src=g.src, dst=g.dst, ndata=g.ndata)


def make_pair(P, mode, use_pp, **tc):
    sg = sharded(P)
    jcfg = JaxModelConfig(layer_sizes=SIZES, use_pp=use_pp, norm="layer",
                          dropout=0.0, train_size=sg.n_train_global)
    jt = JaxTrainer(sg, jcfg, JaxTrainConfig(seed=1, emulate_parts=True,
                                             **MODES[mode], **tc))
    params = first_copy(jax.device_get(jt.state["params"]))
    cfg = ModelConfig(layer_sizes=SIZES, use_pp=use_pp, norm="layer",
                      dropout=0.0, train_size=sg.n_train_global)
    pt = Trainer(port_sharded(sg), cfg, TrainConfig(seed=1, **MODES[mode],
                                                    **tc),
                 CPU, params=params_from_jax(params, CPU))
    return jt, pt


def check_against_jax(P, mode, use_pp):
    jt, pt = make_pair(P, mode, use_pp)
    jl = [jt.train_epoch(e) for e in range(3)]
    pl = [pt.train_epoch(e) for e in range(3)]
    js = jax.device_get(jt.state)
    ps = pt.host_state()
    assert sorted(ps["comm"]) == sorted(js["comm"])
    for grp in js["comm"]:
        assert sorted(ps["comm"][grp]) == sorted(js["comm"][grp])
        for k, want in js["comm"][grp].items():
            assert ps["comm"][grp][k].shape == want.shape
            np.testing.assert_allclose(ps["comm"][grp][k], want, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{grp}[{k}]")
    jl += [jt.train_epoch(e) for e in range(3, 10)]
    pl += [pt.train_epoch(e) for e in range(3, 10)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0]
    js = jax.device_get(jt.state)
    ps = pt.host_state()
    for name, want, got in (
            ("params", first_copy(js["params"]), ps["params"]),
            ("mu", first_copy(js["opt"]["mu"]), ps["opt"]["mu"]),
            ("nu", first_copy(js["opt"]["nu"]), ps["opt"]["nu"])):
        for w, gv in zip(tree_leaves(want), tree_leaves(got)):
            tol = 1e-4 * np.abs(w).max()
            np.testing.assert_allclose(gv, w, rtol=1e-4, atol=tol,
                                       err_msg=name)
    assert int(ps["opt"]["step"]) == int(np.asarray(js["opt"]["step"])[0])
    return jt, pt


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P", [1, 2, 4])
def test_trainer_matches_jax_emulated_use_pp(P, mode):
    check_against_jax(P, mode, use_pp=True)


@pytest.mark.parametrize("use_pp", [True, False], ids=["pp", "plain"])
def test_full_graph_eval_matches_jax(use_pp):
    """Trainer.evaluate on the full graph after 5 pipelined epochs: the
    same accuracy, logits within 1e-5 (the JAX emulated trainer's eval:
    one device, in_deg = max(deg, 1), use_pp layer 0 as cat(feat,
    mean(feat)) @ W)."""
    jt, pt = make_pair(2, "pipelined", use_pp)
    for e in range(5):
        jt.train_epoch(e)
        pt.train_epoch(e)
    g = graph()
    handle = jt.eval_dispatch(g, "val_mask")
    want = np.asarray(handle[2])
    got = pt.eval_logits(port_graph(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for key in ("val_mask", "test_mask"):
        acc = pt.evaluate(port_graph(g), key)
        assert acc == jt.evaluate(g, key)
        assert 0.2 < acc < 1.0


def test_dropout_mask_statistics_and_scale():
    """Keep rate within 4 sigma of 1 - p, kept values scaled by 1/(1-p),
    the rest exactly zero."""
    rate = 0.3
    h = torch.ones((4, 2000, 16))
    out = _dropout(torch.Generator().manual_seed(0), h, rate)
    n = out.numel()
    kept = out != 0
    frac = float(kept.float().mean())
    assert abs(frac - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n)
    assert torch.equal(out[kept], torch.full_like(out[kept],
                                                  1.0 / (1 - rate)))
    assert _dropout(None, h, 0.0) is h


def test_dropout_covers_halo_rows_and_is_seeded_per_epoch():
    """Training dropout applies to the whole aggregation buffer, halo rows
    included; the (seed, epoch) generator repeats its mask and changes it
    across epochs and seeds."""
    P, n, H, F, rate = 2, 50, 40, 8, 0.5
    cfg = ModelConfig(layer_sizes=(F, F, 3), dropout=rate)
    params = {"layers": [{"w1": torch.eye(F), "b1": torch.zeros(F),
                          "w2": torch.eye(F), "b2": torch.zeros(F)},
                         {"w1": torch.zeros((F, 3)), "b1": torch.zeros(3),
                          "w2": torch.zeros((F, 3)), "b2": torch.zeros(3)}],
              "norms": [{"scale": torch.ones(F), "bias": torch.zeros(F)}]}
    seen = []

    def spy(fbuf, *args):
        seen.append(fbuf)
        return fbuf[:, :n]

    def run(seed, epoch):
        seen.clear()
        forward(params, cfg, torch.ones((P, n, F)), None, None, None,
                comm_update=lambda i, h: torch.ones((P, n + H, F)),
                spmm_fn=spy, training=True,
                generator=epoch_generator(seed, epoch, CPU))
        return seen[0]

    fb = run(0, 3)
    halo_kept = float((fb[:, n:] != 0).float().mean())
    sigma = np.sqrt(rate * (1 - rate) / fb[:, n:].numel())
    assert abs(halo_kept - (1 - rate)) < 4 * sigma
    assert torch.equal(run(0, 3), fb)
    assert not torch.equal(run(0, 4), fb)
    assert not torch.equal(run(1, 3), fb)


def test_train_epoch_is_reproducible_with_dropout():
    sg = port_sharded(sharded(2))
    cfg = ModelConfig(layer_sizes=SIZES, use_pp=True, dropout=0.5)
    tc = TrainConfig(seed=2, enable_pipeline=True)
    a, b = Trainer(sg, cfg, tc, CPU), Trainer(sg, cfg, tc, CPU)
    la = [a.train_epoch(e) for e in range(3)]
    lb = [b.train_epoch(e) for e in range(3)]
    assert la == lb
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert a.grad_norm is not None and np.isfinite(a.grad_norm)


@pytest.mark.parametrize("field", [
    dict(fused_epochs=4), dict(epoch_block=8), dict(rng_impl="unsafe_rbg"),
    dict(comm_prefetch=True), dict(loss_scale="auto"),
    dict(loss_scale="4096"), dict(numerics_tripwire=True),
    dict(rng_impl="rbg"), dict(dropout_reuse=4)])
def test_unported_train_options_refuse(field):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(**field)


def test_unported_model_and_fit_options_refuse():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ModelConfig(layer_sizes=(4, 8, 3), dropout_bits=8)
    pt = Trainer(port_sharded(sharded(2)),
                 ModelConfig(layer_sizes=SIZES, dropout=0.0), TrainConfig(),
                 CPU)
    for kw in (dict(checkpoint_dir="ck"), dict(sharded_eval=True),
               dict(stream_plan=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pt.fit(None, **kw)
