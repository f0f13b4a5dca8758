"""The whole serving slice: the JAX Trainer + ServingEngine on the CPU mesh
against the port's engine (plain path, CPU) with the converted params —
every node's logits through query — on each aggregation (xla; the bucket
and block tables with the transport off, the refresh shown to run
through them), plus the port's serving loop and its CLI."""

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
from pipegcn_tpu.cli.serve import build_parser as jax_serve_parser
from pipegcn_tpu.serve import ServingEngine as JaxServingEngine
from pipegcn_tpu_torch.cli.serve import build_parser as port_serve_parser
from pipegcn_tpu_torch.models import ModelConfig, params_from_jax
from pipegcn_tpu_torch.ops import block_spmm as port_block
from pipegcn_tpu_torch.ops import bucket_spmm as port_bucket
from pipegcn_tpu_torch.ops import spmm as port_spmm
from pipegcn_tpu_torch.parallel.staging import stage
from pipegcn_tpu_torch.serve import ServingEngine, run_serving_loop
from test_torch_train import port_sharded
from test_torch_train_block import sharded as block_sharded

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


class _Spy:
    """Counts calls of the CPU plain versions the kernel wrappers fall
    back to on CPU tensors: K1's forward (_spmm_mean_fwd_plain), K9's
    (bucket_gather_plain) and the tile products' (block_dense_plain)."""

    TARGETS = {"K1": (port_spmm, "_spmm_mean_fwd_plain"),
               "K9": (port_bucket, "bucket_gather_plain"),
               "tiles": (port_block, "block_dense_plain")}

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.TARGETS, 0)
        for key, (mod, name) in self.TARGETS.items():
            monkeypatch.setattr(mod, name, self._wrap(key, getattr(mod,
                                                                   name)))

    def _wrap(self, key, fn):
        def counted(*a, **k):
            self.calls[key] += 1
            return fn(*a, **k)
        return counted

    def reset(self):
        self.calls = dict.fromkeys(self.TARGETS, 0)


@pytest.mark.parametrize("impl,group", [("bucket", 1), ("block", 1),
                                        ("block", 2), ("xla", 1)],
                         ids=["bucket", "block-g1", "block-g2", "xla"])
@pytest.mark.parametrize("use_pp", [False, True], ids=["plain", "pp"])
def test_port_engine_serves_through_the_trainers_aggregation(
        monkeypatch, impl, group, use_pp):
    """The JAX engine aggregates through its trainer's bucket or block
    tables with the transport off (serve/engine.py:220-231); the port's
    engine of the same spmm_impl matches it at 1e-5 and its refresh (and
    the use_pp precompute) runs the bucket or tile products' wrappers,
    never K1's. xla, which aggregates through K1 alone, shows that the
    spy sees K1."""
    P = 2
    sg = block_sharded(P)  # dense 32 x 32 tiles in the cluster layout
    sizes = (sg.n_feat, 16, 16, sg.n_class)
    agg = dict(spmm_impl=impl, rem_dtype="float8")
    if impl == "block":
        agg.update(block_tile=32, block_group=group)
    trainer = Trainer(sg, JaxModelConfig(
        layer_sizes=sizes, norm="layer", dropout=0.0, use_pp=use_pp,
        train_size=sg.n_train_global, **agg),
        TrainConfig(seed=3, n_epochs=0, eval=False))
    jeng = JaxServingEngine(trainer, max_batch=64, ladder_min=8)
    tree = _perturbed(trainer.state["params"], seed=7)
    jeng.load_params(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                     trainer.state["norm"])

    spy = _Spy(monkeypatch)
    psg = port_sharded(sg)
    cfg = ModelConfig(layer_sizes=sizes, use_pp=use_pp, norm="layer", **agg)
    eng = ServingEngine.build(psg, cfg, params_from_jax(tree, CPU), CPU,
                              max_batch=64, ladder_min=8)
    d = eng.data
    assert d.label is None and d.indptr_t is None  # no training arrays
    assert (d.block is not None) == (impl == "block")
    assert (d.bucket is not None) == (impl == "bucket")
    if impl == "block":
        assert d.block.group == group and d.block.tile == 32
        assert min(d.block_stats["blocks"]) > 0  # dense tiles to multiply
    # the calls of one aggregation through each impl
    one = {"xla": {"K1": 1, "K9": 0, "tiles": 0},
           "bucket": {"K1": 0, "K9": 1, "tiles": 0},
           "block": {"K1": 0, "K9": 1, "tiles": 1}}[impl]
    if use_pp:  # the precompute went through the same aggregation
        assert spy.calls == one
    spy.reset()
    eng.refresh()
    n_agg = cfg.n_layers - use_pp
    assert spy.calls == {k: v * n_agg for k, v in one.items()}

    ids = np.arange(eng.num_global_nodes)
    want = jeng.query(ids)
    got = eng.query(ids)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_engine_refuses_auto_and_missing_tables():
    """spmm_impl='auto' (the tuner) is refused naming ROADMAP A6, before
    the model check (GAT may name auto); an engine whose staged graph
    lacks the tables of its spmm_impl, or holds another tile, raises."""
    g = synthetic_graph(num_nodes=200, avg_degree=6, n_feat=8, n_class=3,
                        seed=2)
    sg = ShardedGraph.build(g, partition_graph(g, 2, method="random"),
                            n_parts=2)
    from pipegcn_tpu_torch.models import init_params

    cfg = ModelConfig(layer_sizes=(8, 16, 3), use_pp=True, norm="layer")
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    gat = ModelConfig(layer_sizes=(8, 16, 3), model="gat", n_heads=4,
                      spmm_impl="auto")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        ServingEngine(sg, stage(sg, CPU), gat, params)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        dataclasses.replace(cfg, spmm_impl="auto")
    data = stage(sg, CPU)
    for impl in ("bucket", "block"):
        with pytest.raises(ValueError, match=f"the {impl} tables"):
            ServingEngine(sg, data, dataclasses.replace(cfg, spmm_impl=impl),
                          params)
    blk = dataclasses.replace(cfg, spmm_impl="block", block_tile=32)
    staged = stage(sg, CPU, block=(64, 16, None, 1))
    with pytest.raises(ValueError, match="tile 64"):
        ServingEngine(sg, staged, blk, params)


AGG_FLAGS = ("spmm_impl", "block_tile", "block_nnz", "block_group",
             "bucket_merge")


def test_serve_cli_aggregation_flags_match_jax():
    """The five aggregation flags: JAX's defaults, aliases and choices."""
    def actions(parser):
        return {a.dest: a for a in parser._actions if a.dest in AGG_FLAGS}

    port, ref = actions(port_serve_parser()), actions(jax_serve_parser())
    assert set(port) == set(ref) == set(AGG_FLAGS)
    for k in AGG_FLAGS:
        assert port[k].default == ref[k].default, k
        assert port[k].option_strings == ref[k].option_strings, k
        assert port[k].choices == ref[k].choices, k
        assert port[k].type == ref[k].type, k
    p, r = (x.parse_args(["--spmm-impl", "block", "--block-tile", "32"])
            for x in (port_serve_parser(), jax_serve_parser()))
    assert [getattr(p, k) for k in AGG_FLAGS] == \
        [getattr(r, k) for k in AGG_FLAGS]


def test_cli_serves_block_on_cpu(tmp_path):
    """``--spmm-impl block --block-tile 32`` on a graph with dense 32 x 32
    tiles (clusters of 128 nodes): the engine stages the block tables and
    serves; ``--spmm-impl auto`` is refused naming ROADMAP A6."""
    base = [sys.executable, "-m", "pipegcn_tpu_torch.cli.serve",
            "--device", "cpu", "--dataset", "synthetic:2000:40:12:5",
            "--n-partitions", "2", "--partition-method", "random",
            "--cluster-size", "128", "--n-layers", "3", "--n-hidden", "16",
            "--use-pp", "--serve-build", "--partition-dir", str(tmp_path),
            "--serve-duration", "1", "--serve-qps", "40",
            "--serve-refresh-every", "0.5"]
    r = subprocess.run(base + ["--spmm-impl", "block", "--block-tile", "32"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["serve"] is True and summary["n_queries"] > 0
    assert summary["drained"]
    r = subprocess.run(base + ["--spmm-impl", "auto"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "ROADMAP A6" in r.stderr
