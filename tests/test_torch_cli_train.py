"""The training CLI (python -m pipegcn_tpu_torch.cli.main) end to end on
the CPU at a tiny size: the scripts/reddit.sh flags parse with the JAX
parser's defaults, the reference's lines come out, and without CUDA it
raises unless --device cpu is passed."""

import os
import shlex
import subprocess
import sys

import pytest
import torch

import pipegcn_tpu.native
import pipegcn_tpu_torch.native
from pipegcn_tpu.cli.parser import create_parser as jax_parser
from pipegcn_tpu_torch.cli import main as cli

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port: the suite runs several test
    processes on a few cores, where torch's OpenMP pools oversubscribe
    them (the port's test files ran ~4x longer with the default pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_partitioner(monkeypatch):
    """Both packages on their numpy metis path (native partitioner off);
    the native-on case is test_cli_builds_the_native_cluster_layout."""
    monkeypatch.setattr(pipegcn_tpu.native, "available", lambda: False)
    monkeypatch.setattr(pipegcn_tpu_torch.native, "available", lambda: False)


def reddit_sh_argv():
    """The flags scripts/reddit.sh passes to main.py."""
    text = open(os.path.join(ROOT, "scripts", "reddit.sh")).read()
    tokens = shlex.split(text.replace("\\\n", " "))
    return tokens[tokens.index("main.py") + 1:]


def test_parser_takes_every_reddit_sh_flag():
    argv = reddit_sh_argv()
    assert "--enable-pipeline" in argv and "--use-pp" in argv
    args = cli.build_parser().parse_args(argv)
    want = jax_parser().parse_args(argv)
    for k, v in vars(args).items():
        if k != "device":
            assert getattr(want, k) == v, k
    assert (args.dataset, args.n_layers, args.n_hidden, args.dropout,
            args.lr) == ("reddit", 4, 256, 0.5, 0.01)
    assert args.inductive and args.enable_pipeline and args.use_pp


def test_parser_defaults_equal_the_jax_parser():
    ours = vars(cli.build_parser().parse_args([]))
    theirs = vars(jax_parser().parse_args([]))
    assert ours.pop("device") is None
    for k, v in ours.items():
        assert theirs[k] == v, k


def _tiny_argv(extra=()):
    argv = reddit_sh_argv()
    for flag, value in (("--dataset", "synthetic:500:8:12:5"),
                        ("--n-hidden", "16"), ("--n-epochs", "20")):
        argv[argv.index(flag) + 1] = value
    return argv + ["--partition-method", "random", "--fix-seed",
                   *extra]


def test_cli_trains_on_the_cpu(capsys):
    res = cli.run(cli.build_parser().parse_args(
        _tiny_argv(["--device", "cpu"])))
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("partition sizes (inner nodes per device): ")
               for line in out)
    assert any(line.startswith("Process 000 | Epoch 00009 | Time(s) ")
               and " | Loss " in line for line in out)
    assert "Epoch 00019 | Accuracy " in "\n".join(out)
    assert out[-2] == "Validation accuracy {:.2%}".format(res["best_val"])
    assert out[-1] == "Test Result | Accuracy {:.2%}".format(
        res["test_acc"])
    assert res["losses"][-1] < res["losses"][0]
    assert 0.5 < res["test_acc"] <= 1.0


def test_module_entry_point_runs():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "pipegcn_tpu_torch.cli.main",
         *_tiny_argv(["--device", "cpu", "--n-epochs", "10",
                      "--no-eval"])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("Namespace(")
    assert lines[-1].startswith("Process 000 | Epoch 00009 | ")


def test_cli_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_tiny_argv())


@pytest.mark.parametrize("extra", [["--n-linear", "2"],
                                   ["--norm", "batch"],
                                   ["--spmm-impl", "auto"]])
def test_unported_cli_choices_refuse(extra):
    with pytest.raises(NotImplementedError):
        cli.run(cli.build_parser().parse_args(
            _tiny_argv(["--device", "cpu", *extra])))


def _model_argv(model, extra=()):
    """The tiny argv without --use-pp (gcn and gat refuse it)."""
    argv = _tiny_argv(["--device", "cpu", "--model", model, *extra])
    argv.remove("--use-pp")
    return argv


@pytest.mark.parametrize("model,extra", [("gat", ["--n-heads", "4"]),
                                         ("gcn", [])])
def test_cli_trains_gat_and_gcn_on_the_cpu(capsys, model, extra):
    res = cli.run(cli.build_parser().parse_args(_model_argv(model, extra)))
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("Process 000 | Epoch 00019 | Time(s) ")
               and " | Loss " in line for line in out)
    assert out[-2] == "Validation accuracy {:.2%}".format(res["best_val"])
    assert out[-1] == "Test Result | Accuracy {:.2%}".format(
        res["test_acc"])
    assert res["losses"][-1] < res["losses"][0]
    assert 0.3 < res["test_acc"] <= 1.0


def test_model_flags_parse_with_the_jax_defaults():
    argv = ["--model", "gat", "--n-heads", "8", "--spmm-impl", "bucket",
            "--rem-dtype", "none"]
    ours, theirs = (vars(cli.build_parser().parse_args(argv)),
                    vars(jax_parser().parse_args(argv)))
    for k in ("model", "n_heads", "spmm_impl", "rem_dtype"):
        assert ours[k] == theirs[k], k
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--model", "gin"])


@pytest.mark.parametrize("model,extra,err", [
    ("gat", ["--use-pp"], ValueError),
    ("gcn", ["--use-pp"], ValueError),
    ("gat", ["--spmm-impl", "block"], ValueError),
    ("gat", ["--norm", "batch"], "ROADMAP A5"),
    ("gcn", ["--n-linear", "1"], "ROADMAP A5"),
    ("graphsage", ["--spmm-impl", "auto"], "ROADMAP A6")])
def test_model_refusals(model, extra, err):
    """The JAX package's refusals (use_pp with gcn/gat, block with gat)
    raise its ValueError; what the port has not got yet (the dense tail,
    the tuner, SyncBN) raises NotImplementedError naming its ROADMAP item
    (``err``)."""
    exc = err if isinstance(err, type) else NotImplementedError
    with pytest.raises(exc) as info:
        cli.run(cli.build_parser().parse_args(_model_argv(model, extra)))
    if exc is NotImplementedError:
        assert err in str(info.value)


def test_bucket_flags_parse_with_the_jax_parser():
    argv = ["--spmm-impl", "bucket", "--rem-dtype", "float8", "--rem-amax",
            "--bucket-merge", "4", "--spmm-chunk", "4096"]
    ours, theirs = (vars(cli.build_parser().parse_args(argv)),
                    vars(jax_parser().parse_args(argv)))
    for k in ("spmm_impl", "rem_dtype", "rem_amax", "bucket_merge",
              "spmm_chunk"):
        assert ours[k] == theirs[k], k
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--rem-dtype", "int8"])


@pytest.mark.parametrize("model,extra", [
    ("graphsage", ["--rem-dtype", "float8"]),
    ("graphsage", ["--rem-dtype", "float8", "--rem-amax",
                   "--bucket-merge", "4"]),
    ("gcn", ["--rem-dtype", "bfloat16"])])
def test_cli_trains_the_bucket_path_on_the_cpu(capsys, model, extra):
    """--spmm-impl bucket with a transport through cli/main.py: the
    reference's lines, a falling loss; the trainer aggregates through
    the bucket tables."""
    argv = _tiny_argv(["--device", "cpu", "--model", model,
                       "--spmm-impl", "bucket", *extra])
    if model != "graphsage":
        argv.remove("--use-pp")
    args = cli.build_parser().parse_args(argv)
    res = cli.run(args)
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("Process 000 | Epoch 00019 | Time(s) ")
               for line in out)
    assert out[-1] == "Test Result | Accuracy {:.2%}".format(
        res["test_acc"])
    assert res["losses"][-1] < res["losses"][0]
    assert 0.3 < res["test_acc"] <= 1.0


def test_serving_engine_refuses_gcn_and_gat():
    from pipegcn_tpu.graph import synthetic_graph
    from pipegcn_tpu.partition import ShardedGraph, partition_graph
    from pipegcn_tpu_torch.models import ModelConfig, init_params
    from pipegcn_tpu_torch.parallel.staging import stage
    from pipegcn_tpu_torch.serve.engine import ServingEngine
    from test_torch_train import port_sharded

    g = synthetic_graph(num_nodes=60, avg_degree=4, n_feat=6, n_class=3,
                        seed=0)
    sg = port_sharded(ShardedGraph.build(
        g, partition_graph(g, 2, method="random"), n_parts=2))
    cpu = torch.device("cpu")
    # gcn serves since the freshness slice, at f32; gat and bf16 serving
    # are still unported
    for model, dtype in (("gcn", "bfloat16"), ("gat", "float32")):
        cfg = ModelConfig(layer_sizes=(6, 8, 3), model=model, dtype=dtype)
        params = init_params(cfg, torch.Generator().manual_seed(0), cpu)
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            ServingEngine(sg, stage(sg, cpu), cfg, params)


def test_block_and_layout_flags_parse_with_the_jax_parser():
    for argv in ([], ["--spmm-impl", "block", "--block-tile", "128",
                      "--block-nnz", "40", "--block-group", "2",
                      "--local-reorder", "none", "--cluster-size", "512"]):
        ours, theirs = (vars(cli.build_parser().parse_args(argv)),
                        vars(jax_parser().parse_args(argv)))
        for k in ("spmm_impl", "block_tile", "block_nnz", "block_group",
                  "local_reorder", "cluster_size"):
            assert ours[k] == theirs[k], (argv, k)
    assert vars(cli.build_parser().parse_args([]))["local_reorder"] == \
        "cluster"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--local-reorder", "degree"])


def test_cli_builds_the_jax_cluster_layout(numpy_partitioner):
    """The reddit.sh flags (--local-reorder cluster by default): the
    port's prepare builds the cluster-renumbered artifact of the train
    subgraph, array-equal to the JAX CLI's numpy-path build (partition,
    locality_clusters of the train subgraph, build with cluster=)."""
    from pipegcn_tpu.graph import datasets as jax_datasets
    from pipegcn_tpu.partition import ShardedGraph as JaxShardedGraph
    from pipegcn_tpu.partition import partition_graph as jax_partition
    from pipegcn_tpu.partition.partitioner import \
        locality_clusters as jax_clusters
    from test_torch_partition import _assert_artifacts_equal

    args = cli.build_parser().parse_args(_tiny_argv(
        ["--device", "cpu", "--cluster-size", "256"]))
    args.dataset = "synthetic:1500:10:12:5"
    assert args.local_reorder == "cluster"
    sg, _ = cli.prepare(args, log=lambda *a: None)
    train_g, _, _ = jax_datasets.inductive_split(
        jax_datasets.load_data(args.dataset))
    parts = jax_partition(train_g, 2, method="random", seed=args.seed)
    cluster = jax_clusters(train_g, target_size=256, seed=args.seed)
    assert int(cluster.max()) > 0
    _assert_artifacts_equal(sg, JaxShardedGraph.build(
        train_g, parts, n_parts=2, cluster=cluster))


@pytest.mark.parametrize("model,extra", [
    ("graphsage", ["--rem-dtype", "float8"]),
    ("graphsage", ["--rem-dtype", "none", "--block-nnz", "20"]),
    ("gcn", ["--rem-dtype", "bfloat16"])])
def test_cli_trains_the_block_path_on_the_cpu(capsys, model, extra):
    """--spmm-impl block through cli/main.py on the cluster layout: the
    reference's lines, a falling loss; the trainer aggregates through the
    dense tiles and the remainder's bucket tables."""
    argv = _tiny_argv(["--device", "cpu", "--model", model,
                       "--spmm-impl", "block", "--block-tile", "32",
                       "--cluster-size", "64", *extra])
    argv[argv.index("--dataset") + 1] = "synthetic:800:30:12:5"
    if model != "graphsage":
        argv.remove("--use-pp")
    args = cli.build_parser().parse_args(argv)
    res = cli.run(args)
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("Process 000 | Epoch 00019 | Time(s) ")
               for line in out)
    assert out[-1] == "Test Result | Accuracy {:.2%}".format(
        res["test_acc"])
    assert res["losses"][-1] < res["losses"][0]
    assert 0.3 < res["test_acc"] <= 1.0


@pytest.mark.parametrize("model,extra", [
    ("graphsage", ["--block-group", "4", "--rem-dtype", "float8",
                   "--halo-dtype", "float8"]),
    ("gcn", ["--block-group", "2", "--halo-dtype", "bfloat16"])])
def test_cli_trains_the_grouped_block_path_with_a_halo_wire(capsys, model,
                                                            extra):
    """The slice's flags through cli/main.py: --block-group > 1 (the
    union-gather tables; the GCN case was refused before it was ported)
    with the compressed halo wire prints the reference's lines, the loss
    falls, and the wire carries a quarter (float8) or half (bfloat16) of
    the f32 halo bytes."""
    argv = _tiny_argv(["--device", "cpu", "--model", model,
                       "--spmm-impl", "block", "--block-tile", "32",
                       "--cluster-size", "64", *extra])
    argv[argv.index("--dataset") + 1] = "synthetic:800:30:12:5"
    if model != "graphsage":
        argv.remove("--use-pp")
    args = cli.build_parser().parse_args(argv)
    seen = {}
    build = cli.build_trainer

    def keep(*a, **kw):
        seen["trainer"] = build(*a, **kw)
        return seen["trainer"]

    cli.build_trainer = keep
    try:
        res = cli.run(args)
    finally:
        cli.build_trainer = build
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("Process 000 | Epoch 00019 | Time(s) ")
               and " | Loss " in line for line in out)
    assert out[-2] == "Validation accuracy {:.2%}".format(res["best_val"])
    assert out[-1] == "Test Result | Accuracy {:.2%}".format(
        res["test_acc"])
    assert res["losses"][-1] < res["losses"][0]
    t = seen["trainer"]
    assert t.data.block.group == int(args.block_group)
    ratio = 4 if args.halo_dtype == "float8" else 2
    assert t.est_halo_bytes_per_epoch() * ratio == \
        t.est_halo_bytes_per_epoch(compressed=False)


def test_halo_dtype_without_pipeline_refuses():
    """The vanilla exchange is differentiated: --halo-dtype without
    --enable-pipeline raises the JAX trainer's ValueError."""
    argv = _tiny_argv(["--device", "cpu", "--halo-dtype", "float8"])
    argv.remove("--enable-pipeline")
    with pytest.raises(ValueError, match="enable_pipeline"):
        cli.run(cli.build_parser().parse_args(argv))


def test_wire_and_tail_flags_parse_with_the_jax_parser():
    for argv in (["--halo-dtype", "float8", "--block-group", "4"],
                 ["--halo_dtype", "bfloat16", "--n-linear", "2"]):
        ours, theirs = (vars(cli.build_parser().parse_args(argv)),
                        vars(jax_parser().parse_args(argv)))
        for k in ("halo_dtype", "block_group", "n_linear"):
            assert ours[k] == theirs[k], (argv, k)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--halo-dtype", "int8"])


def _line_epochs(out):
    """(kind, epoch) of the reference's train lines ("Process 000 | Epoch
    ...") and eval lines ("Epoch ... | ...") in printed order."""
    seen = []
    for line in out.splitlines():
        if line.startswith("Process 000 | Epoch "):
            seen.append(("train", int(line.split("|")[1].split()[1])))
        elif line.startswith("Epoch "):
            seen.append(("eval", int(line.split("|")[0].split()[1])))
    return seen


def test_cli_log_cadence_matches_the_jax_cli(capsys, tmp_path):
    """At --log-every 5 over 10 epochs the JAX CLI (fit with
    reference_logs) prints the train line at epoch 9 only and evaluates
    at epochs 4 and 9; the port's CLI prints the same lines. (The JAX
    CLI evaluates asynchronously and prints epoch 4's eval line when it
    harvests it, after epoch 9's train line; the port evaluates in line.
    The lines are compared, not their order.)"""
    from pipegcn_tpu.cli.main import run as jax_run

    argv = _tiny_argv(["--log-every", "5", "--n-epochs", "10"])
    cli.run(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    port = _line_epochs(capsys.readouterr().out)
    jax_run(jax_parser().parse_args(argv + [
        "--partition-dir", str(tmp_path / "parts"),
        "--model-dir", str(tmp_path / "model"),
        "--results-dir", str(tmp_path / "results")]))
    theirs = _line_epochs(capsys.readouterr().out)
    assert sorted(theirs) == [("eval", 4), ("eval", 9), ("train", 9)]
    assert sorted(port) == sorted(theirs)


def test_cli_builds_the_native_cluster_layout():
    """As test_cli_builds_the_jax_cluster_layout with both native
    partitioners on (the JAX CLI's default where g++ builds them): native
    metis parts of the train subgraph, native locality clusters, the
    cluster-keyed build, array-equal to the JAX package's."""
    from pipegcn_tpu.graph import datasets as jax_datasets
    from pipegcn_tpu.partition import ShardedGraph as JaxShardedGraph
    from pipegcn_tpu.partition import partition_graph as jax_partition
    from pipegcn_tpu.partition.partitioner import \
        locality_clusters as jax_clusters
    from test_torch_partition import _assert_artifacts_equal

    assert pipegcn_tpu.native.available()
    assert pipegcn_tpu_torch.native.available()
    argv = _tiny_argv(["--device", "cpu", "--cluster-size", "256"])
    argv[argv.index("--partition-method") + 1] = "metis"
    args = cli.build_parser().parse_args(argv)
    args.dataset = "synthetic:1500:10:12:5"
    sg, _ = cli.prepare(args, log=lambda *a: None)
    train_g, _, _ = jax_datasets.inductive_split(
        jax_datasets.load_data(args.dataset))
    parts = jax_partition(train_g, 2, method="metis", seed=args.seed)
    cluster = jax_clusters(train_g, target_size=256, seed=args.seed)
    _assert_artifacts_equal(sg, JaxShardedGraph.build(
        train_g, parts, n_parts=2, cluster=cluster))
