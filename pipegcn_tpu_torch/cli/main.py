"""Training entry point: ``python -m pipegcn_tpu_torch.cli.main``.

Port of ``pipegcn_tpu/cli/main.py`` (``prepare`` + ``run``) for the runs
``scripts/reddit.sh`` makes: load the graph, split it under
``--inductive`` (the train subgraph is partitioned; val and test are
evaluated on the train+val subgraph and the full graph), partition and
build the ``ShardedGraph`` in memory (each host step timed), train the P
parts stacked on one device, and print the reference's lines:

  Process 000 | Epoch 00009 | Time(s) ... | Comm(s) ... | Reduce(s) ... | Loss ...
  Epoch 00009 | Accuracy 95.00%                  (inductive)
  Validation accuracy ...
  Test Result | Accuracy ...

Its parser takes every flag of ``scripts/reddit.sh`` with the JAX
parser's names and defaults (``cli/parser.py``), and the model family's
(``--model {graphsage,gcn,gat}``, ``--n-heads``), the bucket and block
aggregations' (``--spmm-impl``, ``--rem-dtype``, ``--rem-amax``,
``--bucket-merge``, ``--spmm-chunk``, ``--block-tile``, ``--block-nnz``,
``--block-group``), the halo wire's (``--halo-dtype``), the integrity
plane's (``--integrity-check-every``, and ``--fault-plan`` for its
``bitflip@E[:rN]:<class>`` drills) and the local-id layout's
(``--local-reorder``, by
default ``cluster`` as in JAX: locality clusters of the train subgraph
under ``--inductive``, ``--cluster-size``), plus ``--device``. As in
the JAX CLI, the seed is drawn at random unless ``--fix-seed``. Runs on
CUDA; ``--device cpu`` runs the plain PyTorch path on the CPU; without
CUDA and without ``--device cpu`` it raises. Result files, saved models,
artifacts on disk and the rest of the JAX flag set are ROADMAP A3.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

from .layout import add_aggregation_flags, add_layout_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PipeGCN training on PyTorch/CUDA")
    p.add_argument("--dataset", type=str, default="reddit")
    p.add_argument("--data-root", "--data_root", type=str, default=None,
                   help="dataset root (default $PIPEGCN_DATA or ./dataset)")
    p.add_argument("--model", choices=["graphsage", "gcn", "gat"],
                   default="graphsage")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--n-epochs", "--n_epochs", type=int, default=200)
    p.add_argument("--n-partitions", "--n_partitions", type=int, default=2)
    p.add_argument("--n-hidden", "--n_hidden", type=int, default=16)
    p.add_argument("--n-layers", "--n_layers", type=int, default=2)
    p.add_argument("--n-linear", "--n_linear", type=int, default=0,
                   help="dense layers after the graph layers (the dense "
                        "tail waits for ROADMAP A5: > 0 is refused)")
    p.add_argument("--norm", choices=["layer", "batch", "none"],
                   default="layer")
    p.add_argument("--weight-decay", "--weight_decay", type=float,
                   default=0)
    p.add_argument("--partition-obj", "--partition_obj",
                   choices=["vol", "cut"], default="vol")
    p.add_argument("--partition-method", "--partition_method",
                   choices=["metis", "random"], default="metis")
    p.add_argument("--enable-pipeline", "--enable_pipeline",
                   action="store_true")
    p.add_argument("--feat-corr", "--feat_corr", action="store_true")
    p.add_argument("--grad-corr", "--grad_corr", action="store_true")
    p.add_argument("--corr-momentum", "--corr_momentum", type=float,
                   default=0.95)
    p.add_argument("--use-pp", "--use_pp", action="store_true")
    p.add_argument("--inductive", action="store_true")
    p.add_argument("--fix-seed", "--fix_seed", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", "--log_every", type=int, default=10)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--no-eval", action="store_false", dest="eval")
    p.set_defaults(eval=True)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--spmm-chunk", "--spmm_chunk", type=int, default=0,
                   help="edge-chunk size of the JAX SpMM (0 = unchunked); "
                        "accepted for the JAX parser's sake and ignored: "
                        "the kernels walk each row in registers and need "
                        "no chunks")
    add_aggregation_flags(p)
    add_layout_flags(p)
    p.add_argument("--n-heads", "--n_heads", type=int, default=4,
                   help="attention heads for --model gat")
    p.add_argument("--rem-dtype", "--rem_dtype",
                   choices=["none", "bfloat16", "float8"], default="none",
                   help="gather-transport dtype of --spmm-impl bucket: "
                        "float8 = e4m3 activations, e5m2 cotangents (K10), "
                        "f32 accumulation; a no-op under xla, as in JAX")
    p.add_argument("--rem-amax", "--rem_amax", action="store_true",
                   help="amax-clamped fp8 transport: scale each part's "
                        "gathered tensor by a power of two from its amax "
                        "(K11) before the cast (only with --rem-dtype "
                        "float8)")
    p.add_argument("--halo-dtype", "--halo_dtype",
                   choices=["none", "bfloat16", "float8"], default="none",
                   help="wire dtype of the halo exchange and boundary-"
                        "gradient return (pipelined mode only): bfloat16, "
                        "or float8 (e4m3 features / e5m2 bgrads, one "
                        "power-of-two scale a distance block: K14/K15); "
                        "decoded back to the compute dtype on receipt")
    p.add_argument("--integrity-check-every", "--integrity_check_every",
                   type=int, default=0,
                   help="epochs between SDC integrity checks "
                        "(resilience/integrity.py): K19 digest scrub of the "
                        "static device tensors and Freivalds verification "
                        "of the production SpMM at this cadence, params / "
                        "carry digest compares at every boundary, and the "
                        "halo wire-checksum lane in the pipelined step; 0 "
                        "disables (and runs the unguarded step)")
    p.add_argument("--fault-plan", "--fault_plan", type=str, default="",
                   help="deterministic chaos injection: comma-separated "
                        "kind@epoch[:rN] entries; the port runs "
                        "bitflip@E[:rN]:<params|carry|tables|halo> (one "
                        "bit flipped in that state class at the boundary "
                        "of E, once) and refuses the JAX package's other "
                        "kinds")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; no silent fallback")
    return p


def prepare(args, log=print, g=None, steps=None):
    """Load (unless ``g`` is given), split under ``--inductive`` and build
    the ``ShardedGraph`` in memory; returns ``(sg, eval_graphs)`` with
    ``eval_graphs`` ``{'val': (graph, 'val_mask'), 'test': (...)}``.
    Host-step seconds are logged and added to ``steps`` when given."""
    from ..graph.datasets import inductive_split, load_data
    from .serve import build_artifact

    steps = {} if steps is None else steps
    if g is None:
        t0 = time.monotonic()
        g = load_data(args.dataset, args.data_root)
        steps["load_data"] = time.monotonic() - t0
    if args.inductive:
        t0 = time.monotonic()
        train_g, val_g, test_g = inductive_split(g)
        steps["inductive_split"] = time.monotonic() - t0
        log(f"inductive_split in {steps['inductive_split']:.1f}s "
            f"({train_g.num_edges} train-graph edges)")
        eval_graphs = {"val": (val_g, "val_mask"),
                       "test": (test_g, "test_mask")}
    else:
        train_g = g
        eval_graphs = {"val": (g, "val_mask"), "test": (g, "test_mask")}
    sg = build_artifact(args, log, g=train_g, steps=steps)
    return sg, eval_graphs


def configs(args, sg):
    """``(ModelConfig, TrainConfig)`` of parsed ``args`` over ``sg``."""
    from ..models.sage import ModelConfig
    from ..parallel.trainer import TrainConfig

    layer_sizes = (sg.n_feat,) + (args.n_hidden,) * (args.n_layers - 1) \
        + (sg.n_class,)
    cfg = ModelConfig(layer_sizes=layer_sizes, model=args.model,
                      n_heads=args.n_heads, spmm_impl=args.spmm_impl,
                      rem_dtype=args.rem_dtype, rem_amax=args.rem_amax,
                      bucket_merge=args.bucket_merge,
                      block_tile=args.block_tile,
                      block_nnz=args.block_nnz or None,
                      block_group=args.block_group,
                      n_linear=args.n_linear, use_pp=args.use_pp,
                      norm=None if args.norm == "none" else args.norm,
                      dropout=args.dropout, train_size=sg.n_train_global,
                      dtype=args.dtype)
    tcfg = TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                       n_epochs=args.n_epochs,
                       enable_pipeline=args.enable_pipeline,
                       feat_corr=args.feat_corr, grad_corr=args.grad_corr,
                       corr_momentum=args.corr_momentum,
                       log_every=args.log_every, seed=args.seed,
                       eval=args.eval, halo_dtype=args.halo_dtype,
                       integrity_check_every=args.integrity_check_every)
    return cfg, tcfg


def build_trainer(args, sg, device, log=print, steps=None):
    """The ``Trainer`` for parsed ``args`` over ``sg`` on ``device``
    (staging, the transpose CSR or the bucket or block tables, the inverse
    send CSR, and the use_pp precompute, timed)."""
    from ..parallel.trainer import Trainer

    cfg, tcfg = configs(args, sg)
    t0 = time.monotonic()
    trainer = Trainer(sg, cfg, tcfg, device)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    secs = time.monotonic() - t0
    if steps is not None:
        steps["trainer_setup"] = secs
    d = trainer.data
    if trainer.block:
        st = d.block_stats
        cov = sum(st["dense_edges"]) / max(sum(st["edges"]), 1)
        tables = (f"block tables {d.block_build_s:.1f}s: {st['blocks']} "
                  f"dense blocks, {cov:.1%} of the edges, A "
                  f"{st['bits']}-bit {st['a_bytes']} bytes")
    elif trainer.bucket:
        tables = f"bucket tables {d.bucket_build_s:.1f}s"
    else:
        tables = "transpose CSR"
    log(f"trainer set up in {secs:.1f}s (staging, {tables}, send CSR"
        f"{', use_pp precompute' if args.use_pp else ''}; {device})")
    return trainer


def run(args, log=print) -> dict:
    """Full training run; returns ``Trainer.fit``'s result dict."""
    from ..device import resolve_device

    from ..resilience import FaultPlan

    device = resolve_device(args.device)
    fault_plan = FaultPlan.parse(args.fault_plan) if args.fault_plan \
        else None
    # seed semantics: random unless --fix-seed (reference main.py:11-14)
    if not args.fix_seed:
        args.seed = random.randint(0, 1 << 31)
    sg, eval_graphs = prepare(args, log)
    sizes = ", ".join(str(int(c)) for c in sg.inner_count)
    print(f"partition sizes (inner nodes per device): {sizes}")
    trainer = build_trainer(args, sg, device, log)
    # the train line every 10 epochs, evals every --log-every, as the
    # JAX CLI's fit(reference_logs=True) prints them
    res = trainer.fit(eval_graphs if args.eval else None,
                      inductive=args.inductive, reference_logs=True,
                      fault_plan=fault_plan)
    if args.eval and "test_acc" in res:
        print("Validation accuracy {:.2%}".format(res["best_val"]))
        print("Test Result | Accuracy {:.2%}".format(res["test_acc"]))
    return res


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
