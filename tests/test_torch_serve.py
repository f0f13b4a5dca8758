"""The whole serving slice: the JAX Trainer + ServingEngine on the CPU mesh
against the port's engine (plain path, CPU) with the converted params —
every node's logits through query — plus the port's serving loop and
its CLI."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.models import ModelConfig as JaxModelConfig
from pipegcn_tpu.parallel import TrainConfig, Trainer
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu.serve import ServingEngine as JaxServingEngine
from pipegcn_tpu_torch.models import ModelConfig, params_from_jax
from pipegcn_tpu_torch.parallel.staging import stage
from pipegcn_tpu_torch.serve import ServingEngine, run_serving_loop

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _perturbed(params, seed):
    """Host copy of the trainer's params with LayerNorm moved off its
    (1, 0) init, so scale and bias conversion matter."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for n in tree["norms"]:
        n["scale"] = (1 + 0.3 * rng.standard_normal(n["scale"].shape)
                      ).astype(np.float32)
        n["bias"] = (0.2 * rng.standard_normal(n["bias"].shape)
                     ).astype(np.float32)
    return tree


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("use_pp", [False, True], ids=["plain", "pp"])
def test_port_engine_matches_jax_engine(P, use_pp):
    g = synthetic_graph(num_nodes=300, avg_degree=8, n_feat=12, n_class=5,
                        seed=21)
    sg = ShardedGraph.build(g, partition_graph(g, P, method="random"),
                            n_parts=P)
    sizes = (sg.n_feat, 16, 16, sg.n_class)
    trainer = Trainer(sg, JaxModelConfig(
        layer_sizes=sizes, norm="layer", dropout=0.0, use_pp=use_pp,
        train_size=sg.n_train_global), TrainConfig(seed=3, n_epochs=0,
                                                   eval=False))
    jeng = JaxServingEngine(trainer, max_batch=64, ladder_min=8)
    tree = _perturbed(trainer.state["params"], seed=P)
    jeng.load_params(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                     trainer.state["norm"])

    cfg = ModelConfig(layer_sizes=sizes, use_pp=use_pp, norm="layer")
    eng = ServingEngine(sg, stage(sg, CPU), cfg, params_from_jax(tree, CPU),
                        max_batch=64, ladder_min=8)
    eng.warmup()
    assert eng.num_global_nodes == jeng.num_global_nodes == g.num_nodes

    ids = np.arange(g.num_nodes)
    want = jeng.query(ids)
    got = eng.query(ids)
    assert got.shape == (g.num_nodes, sg.n_class) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        eng.query([g.num_nodes])


def test_serving_loop_drains_and_conserves():
    g = synthetic_graph(num_nodes=200, avg_degree=6, n_feat=8, n_class=3,
                        seed=2)
    sg = ShardedGraph.build(g, partition_graph(g, 2, method="random"),
                            n_parts=2)
    cfg = ModelConfig(layer_sizes=(8, 16, 3), use_pp=True, norm="layer")
    from pipegcn_tpu_torch.models import init_params

    eng = ServingEngine(sg, stage(sg, CPU), cfg,
                        init_params(cfg, torch.Generator().manual_seed(0),
                                    CPU))
    t = [0.0]

    def clock():
        return t[0]

    def sleep(dt):
        t[0] += dt

    s = run_serving_loop(eng, duration_s=2.0, qps=100.0, seed=4,
                         refresh_every_s=0.5, report_every_s=1.0,
                         clock=clock, sleep=sleep)
    assert s["drained"] and s["conserved"] and not s["stopped_early"]
    assert s["n_queries"] == s["n_served"] == s["n_submitted"] == 200
    assert s["n_refresh"] >= 3 and s["cache_hit_rate"] == 1.0
    # serving at bf16 compute is still unported (ROADMAP A5)
    with pytest.raises(NotImplementedError):
        ServingEngine(sg, stage(sg, CPU),
                      dataclasses.replace(cfg, dtype="bfloat16"),
                      eng.params)


def test_cli_serves_on_cpu(tmp_path):
    cmd = [sys.executable, "-m", "pipegcn_tpu_torch.cli.serve",
           "--device", "cpu", "--dataset", "synthetic:300:8:12:5",
           "--n-partitions", "2", "--partition-method", "random",
           "--n-layers", "4", "--n-hidden", "16", "--use-pp",
           "--serve-build", "--partition-dir", str(tmp_path),
           "--serve-duration", "1", "--serve-qps", "60",
           "--serve-refresh-every", "0.3"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["serve"] is True
    for k in ("qps", "p50_ms", "p95_ms", "p99_ms", "batch_fill",
              "n_queries"):
        assert summary[k] is not None, k
    assert summary["n_queries"] > 0 and summary["drained"]
    # the artifact it built loads back, in either package; it carries the
    # JAX CLI's name for the default cluster layout (--local-reorder
    # cluster, --cluster-size 1024)
    art = tmp_path / "synthetic:300:8:12:5-2-random-vol-trans-cs1024"
    assert ShardedGraph.exists(str(art))
    assert ShardedGraph.load(str(art)).num_parts == 2
