"""The port's Trainer with spmm_impl="block" (plain path, CPU) against the
JAX Trainer(emulate_parts=True, spmm_impl="block", block_tile=32) from
the same converted params at dropout 0, on a community graph in the
cluster layout (dense 32 x 32 tiles at the break-even threshold of the
16-wide layers), with test_torch_train.py's checks and tolerances:
per-epoch losses over 10 epochs (rtol 1e-4), the comm carries after 3
epochs (rtol 1e-5), params and Adam moments after 10 (rtol 1e-4).
GraphSAGE with use_pp and GCN at P in {1, 2, 4} x {vanilla, pipelined,
pipelined + feat/grad corrections}, transport none; the remainder's
transports are held op by op in test_torch_block.py."""

import jax
import numpy as np
import pytest

from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.models.sage import ModelConfig as JaxModelConfig
from pipegcn_tpu.parallel.trainer import TrainConfig as JaxTrainConfig
from pipegcn_tpu.parallel.trainer import Trainer as JaxTrainer
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.models import ModelConfig, first_copy, params_from_jax
from pipegcn_tpu_torch.parallel.trainer import TrainConfig, Trainer
from pipegcn_tpu_torch.partition.partitioner import locality_clusters
from test_torch_train import (CPU, MODES, SIZES, one_torch_thread,
                              port_graph, port_sharded)
from test_torch_train_bucket import check_bucket_against_jax

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

_SG = {}


def sharded(P):
    """600 nodes, 5 communities, ~36 edges a node, in the cluster layout
    (locality clusters of 64 nodes), P random parts."""
    if P not in _SG:
        g = synthetic_graph(num_nodes=600, avg_degree=36, n_feat=12,
                            n_class=5, seed=3, label_noise=0.3)
        cluster = locality_clusters(port_graph(g), target_size=64)
        parts = partition_graph(g, P, method="random", seed=0)
        _SG[P] = ShardedGraph.build(g, parts, n_parts=P, cluster=cluster)
    return _SG[P]


def make_block_pair(P, mode, model="graphsage"):
    sg = sharded(P)
    kw = dict(layer_sizes=SIZES, model=model, use_pp=model == "graphsage",
              norm="layer", dropout=0.0, train_size=sg.n_train_global,
              spmm_impl="block", block_tile=32)
    jt = JaxTrainer(sg, JaxModelConfig(**kw),
                    JaxTrainConfig(seed=1, emulate_parts=True,
                                   **MODES[mode]))
    params = first_copy(jax.device_get(jt.state["params"]))
    pt = Trainer(port_sharded(sg), ModelConfig(**kw),
                 TrainConfig(seed=1, **MODES[mode]), CPU,
                 params=params_from_jax(params, CPU))
    return jt, pt


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P", [1, 2, 4])
def test_block_trainer_matches_jax(P, mode, model):
    jt, pt = make_block_pair(P, mode, model)
    d = pt.data
    assert pt.block and d.block is not None and d.bucket is None
    assert d.indptr_t is None  # the transpose CSR is not staged
    # both paths carry work: dense tiles and a remainder
    st = d.block_stats
    assert min(st["blocks"]) > 0
    assert 0.1 < sum(st["dense_edges"]) / sum(st["edges"]) < 0.95
    check_bucket_against_jax(jt, pt)


def test_block_with_a_threshold_and_the_plain_flag():
    """--block-nnz: an explicit threshold changes the split, not the
    function; the trainer's plain flag runs the same epochs."""
    sg = sharded(2)
    kw = dict(layer_sizes=SIZES, use_pp=True, dropout=0.0,
              train_size=sg.n_train_global)
    tc = TrainConfig(seed=1, enable_pipeline=True)
    runs = [Trainer(port_sharded(sg), ModelConfig(spmm_impl=impl, **extra,
                                                  **kw), tc, CPU)
            for impl, extra in (("xla", {}),
                                ("block", dict(block_tile=32)),
                                ("block", dict(block_tile=32,
                                               block_nnz=200)))]
    covs = [sum(t.data.block_stats["dense_edges"])
            for t in runs[1:]]
    assert covs[0] > covs[1] > 0
    losses = [[t.train_epoch(e) for e in range(3)] for t in runs]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses[2], losses[0], rtol=1e-5)
    runs[1].plain = True
    assert runs[1].train_epoch(3) == pytest.approx(runs[0].train_epoch(3),
                                                   rel=1e-5)
