#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``pipegcn_tpu_torch``).

    python3 chip_smoke.py            # one NVIDIA H100 (any CUDA card runs)

Drives the port's serving path end to end on one card, at the full width
of the repo's main model config (``scripts/reddit.sh``: GraphSAGE
602 -> 256 -> 256 -> 256 -> 41, use_pp, LayerNorm, f32) on the
``synthetic-reddit`` graph split into 2 random parts:

  1. prints the card's name and power limit (nvidia-smi) and versions;
  2. builds both hand-written kernels from ``pipegcn_tpu_torch/ops/csrc``
     (one nvcc per source, started together);
  3. serves: builds the artifact in memory (the CLI's ``build_artifact``:
     load, partition, build, each step timed; nothing is saved), builds
     and warms the ServingEngine through the CLI's
     ``build_serving_engine``, serves a few seconds of
     open-loop queries with ``run_serving_loop``, and checks that the
     logits are finite, that both kernels were launched on that run, and
     that the served logits match a recompute through the kernels' plain
     PyTorch versions on the card;
  4. holds each kernel against its plain version at the main path's
     shapes and on edge cases (K1 in f32 and bf16; K2 bit-exact);
  5. times each kernel (CUDA events, median), its plain version and one
     PyTorch library call computing the same function, beside the least
     time the card could take (``bound_ms``), and times the refresh;
  6. prints the ``kernels`` JSON line, a serving line, the nvidia-smi line,
     and last ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable, when the
package is missing (the script alone), or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s
# and f32 FLOP/s outside the tensor cores — the bound_ms denominators
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# kernel vs plain tolerances. K1: both sum the same f32 (or exactly
# widened bf16) values in f32, K1 per row in edge order, the plain version
# by index_add_, so they differ only by summation order. K2 is a byte
# copy: bit-exact. The served logits pass through 4 layers of such sums,
# matmuls and LayerNorm, whose rounding the normalization can amplify.
K1_ATOL, K1_RTOL = 1e-5, 1e-5
LOGITS_ATOL, LOGITS_RTOL = 1e-4, 1e-4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Failed(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card, one CUDA event pair
    per repetition after ``warmup`` untimed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_close(name, got, ref, atol, rtol) -> float:
    import torch

    require(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
            f"{tuple(ref.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = max_err(got, ref)
    ok = bool(((got.double() - ref.double()).abs()
               <= atol + rtol * ref.double().abs()).all())
    log(f"  {name}: max_abs_err={err:.3e} (tol {atol:g} + {rtol:g}*|ref|)"
        f" {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return err


def check_bits(name, got, ref) -> float:
    import torch

    require(got.shape == ref.shape and got.dtype == ref.dtype,
            f"{name}: shape/dtype mismatch")
    same = torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    log(f"  {name}: bit-exact {'ok' if same else 'FAIL'}")
    require(same, f"{name}: kernel is not bit-exact against its plain "
            "version")
    return 0.0


# ---------------------------------------------------------------------------
# phase 3: the serving path


def serve_phase(args, spmm, halo):
    import torch
    from pipegcn_tpu_torch.cli.serve import build_artifact, \
        build_parser, build_serving_engine
    from pipegcn_tpu_torch.models.sage import forward
    from pipegcn_tpu_torch.parallel.staging import precompute_pp
    from pipegcn_tpu_torch.serve import run_serving_loop

    cli = build_parser().parse_args([
        "--dataset", args.dataset, "--n-partitions", "2",
        "--partition-method", "random", "--model", "graphsage",
        "--n-layers", "4", "--n-hidden", "256", "--use-pp",
        "--norm", "layer", "--dtype", "float32", "--seed", "0"])
    t0 = time.monotonic()
    sg = build_artifact(cli, log=log)
    t_artifact = time.monotonic() - t0

    spmm.spmm_mean.launches = 0
    halo.halo_gather.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = build_serving_engine(cli, log=log, sg=sg)
    t_engine = time.monotonic() - t0
    del sg
    summary = run_serving_loop(engine, duration_s=args.serve_seconds,
                               qps=args.qps, refresh_every_s=1.0,
                               report_every_s=2.0, seed=0)
    torch.cuda.synchronize()
    launches = {"spmm_mean": spmm.spmm_mean.launches,
                "halo_gather": halo.halo_gather.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  engine (staging + pp + warmup) in {t_engine:.1f}s; "
        f"served {summary['n_queries']} queries, launches {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path was never launched: {launches}")
    require(summary["drained"] and summary["conserved"]
            and summary["n_queries"] > 0, f"serving loop: {summary}")

    logits = engine.logits
    P, n_max = engine.P, engine.n_max
    require(tuple(logits.shape) == (P, n_max, engine.n_class),
            f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")

    # the same forward through the plain versions, on the card
    d = engine.data

    def plain_exchange(h, idx, mask):
        return halo.halo_gather_plain(h, idx, mask, with_inner=True)

    with torch.inference_mode():
        pp_plain = precompute_pp(d, exchange=plain_exchange,
                                 spmm_fn=spmm.spmm_mean_plain)
        ref = forward(engine.params, engine.cfg, pp_plain, d.indptr,
                      d.edge_src, d.in_deg,
                      comm_update=lambda i, h: plain_exchange(
                          h, d.send_idx, d.send_mask),
                      spmm_fn=spmm.spmm_mean_plain)
    err_all = check_close("served logits (all rows) vs plain recompute",
                          logits, ref, LOGITS_ATOL, LOGITS_RTOL)
    ids = torch.randperm(engine.num_global_nodes,
                         generator=torch.Generator().manual_seed(1))[:4096]
    got = torch.from_numpy(engine.query(ids.numpy()))
    want = ref[torch.from_numpy(engine._q_part[ids.numpy()]).cuda(),
               torch.from_numpy(engine._q_local[ids.numpy()]).cuda()].cpu()
    check_close("queried logits (owner gather) vs plain recompute", got,
                want, LOGITS_ATOL, LOGITS_RTOL)

    refresh_ms = time_ms(engine.refresh, reps=5, warmup=1)
    return engine, summary, launches, {
        "refresh_ms": refresh_ms, "peak_mem_gib": peak_gib,
        "logits_max_abs_err": err_all, "artifact_build_s": t_artifact,
        "engine_build_s": t_engine}


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions


def k1_phase(engine, spmm, halo):
    import torch

    d = engine.data
    gen = torch.Generator(device="cuda").manual_seed(2)
    P, n_max, H = d.num_parts, d.n_max, d.halo_size
    errs = []
    # main-path shapes: layers 1-3 (F = 256) in f32 and bf16, and the pp
    # precompute (F = 602, the raw features)
    h = torch.randn((P, n_max, 256), generator=gen, device="cuda")
    fbuf = halo.halo_exchange(h, d.send_idx, d.send_mask)
    args = (d.indptr, d.edge_src, d.in_deg)
    for name, fb in (("K1 f32 F=256", fbuf),
                     ("K1 bf16 F=256", fbuf.bfloat16()),
                     ("K1 f32 F=602", halo.halo_exchange(
                         d.feat, d.send_idx, d.send_mask))):
        errs.append(check_close(name, spmm.spmm_mean(fb, *args),
                                spmm.spmm_mean_plain(fb, *args),
                                K1_ATOL, K1_RTOL))

    # edge cases: empty rows, a ~5000-degree row, pad edges at the
    # sentinel (junk src past indptr[n_out] must not be read), in_deg = 1
    # padding rows, odd widths, bf16 with odd width, int64 indptr
    import numpy as np

    rng = np.random.default_rng(3)
    n_out, n_src = 300, 700
    deg = rng.integers(0, 40, n_out)
    deg[::7] = 0
    deg[5] = 5000
    dst = np.repeat(np.arange(n_out), deg)
    e_max = dst.size + 37
    edge_dst = np.concatenate([dst, np.full(e_max - dst.size, n_out)])
    src_np = np.concatenate([rng.integers(0, n_src, dst.size),
                             np.zeros(e_max - dst.size, np.int64)])
    indptr = torch.from_numpy(spmm.csr_indptr(edge_dst, n_out)).cuda()
    src = torch.from_numpy(src_np.astype(np.int32)).cuda()
    in_deg = torch.from_numpy(np.maximum(deg, 1).astype(np.float32)).cuda()
    for F in (1, 3, 16, 602):
        for dt in (torch.float32, torch.bfloat16):
            fb = torch.randn((n_src, F), generator=gen, device="cuda").to(dt)
            got = spmm.spmm_mean(fb, indptr, src, in_deg)
            ref = spmm.spmm_mean_plain(fb, indptr, src, in_deg)
            errs.append(check_close(f"K1 edge cases {dt} F={F}", got, ref,
                                    K1_ATOL, K1_RTOL))
            empty = torch.from_numpy(deg == 0).cuda()
            require(bool((got[empty] == 0).all()),
                    "K1: empty rows must be exactly zero")
    junk = src.clone()
    junk[dst.size:] = 123  # pad edges past indptr[n_out]
    fb = torch.randn((n_src, 16), generator=gen, device="cuda")
    require(torch.equal(spmm.spmm_mean(fb, indptr, junk, in_deg),
                        spmm.spmm_mean(fb, indptr, src, in_deg)),
            "K1 read a pad edge past indptr[n_out]")
    errs.append(check_close("K1 int64 indptr", spmm.spmm_mean(
        fb, indptr.long(), src, in_deg), spmm.spmm_mean_plain(
        fb, indptr, src, in_deg), K1_ATOL, K1_RTOL))
    return max(errs)


def k2_phase(engine, halo):
    import torch

    d = engine.data
    gen = torch.Generator(device="cuda").manual_seed(4)
    P, n_max = d.num_parts, d.n_max
    for F in (256, 602):
        h = torch.randn((P, n_max, F), generator=gen, device="cuda")
        for inner in (True, False):
            check_bits(f"K2 F={F} with_inner={inner}",
                       halo.halo_gather(h, d.send_idx, d.send_mask, inner),
                       halo.halo_gather_plain(h, d.send_idx, d.send_mask,
                                              inner))
    # masked-off and clipped indices, P = 3 and 4, bf16 and odd row bytes,
    # non-finite values and -0.0 carried bit for bit
    for P, n_max, B, F, dt in ((3, 50, 20, 7, torch.float32),
                               (4, 33, 9, 3, torch.bfloat16),
                               (4, 64, 16, 256, torch.float32)):
        h = torch.randn((P, n_max, F), generator=gen, device="cuda").to(dt)
        h[0, 0, 0] = float("nan")
        h[1, 1, 0] = float("-inf")
        h[P - 1, 2, 0] = -0.0
        idx = torch.randint(-5, n_max + 5, (P, P - 1, B), generator=gen,
                            device="cuda", dtype=torch.int32)
        mask = torch.rand((P, P - 1, B), generator=gen, device="cuda") < 0.7
        for inner in (True, False):
            check_bits(f"K2 P={P} F={F} {dt} with_inner={inner} "
                       "(clip + mask)",
                       halo.halo_gather(h, idx, mask, inner),
                       halo.halo_gather_plain(h, idx, mask, inner))
    return 0.0


# ---------------------------------------------------------------------------
# phase 5: timings


def timings(engine, spmm, halo, launches, errs):
    import torch

    d = engine.data
    gen = torch.Generator(device="cuda").manual_seed(5)
    P, n_max, H = d.num_parts, d.n_max, d.halo_size
    F = 256
    h = torch.randn((P, n_max, F), generator=gen, device="cuda")
    fbuf = halo.halo_exchange(h, d.send_idx, d.send_mask)
    n_src = fbuf.shape[1]
    args = (d.indptr, d.edge_src, d.in_deg)
    edges = [int(d.indptr[p, -1]) for p in range(P)]
    n_edges = sum(edges)

    # --- K1 ------------------------------------------------------------
    k1_ms = time_ms(lambda: spmm.spmm_mean(fbuf, *args))
    k1_plain = time_ms(lambda: spmm.spmm_mean_plain(fbuf, *args), reps=5)
    # library yardstick: one cuSPARSE CSR SpMM over the block-diagonal
    # matrix of both parts, with values 1/in_deg[dst] (the mean)
    crow = torch.cat([d.indptr[0].long()] + [
        d.indptr[p, 1:].long() + sum(edges[:p]) for p in range(1, P)])
    col = torch.cat([d.edge_src[p, :edges[p]].long() + p * n_src
                     for p in range(P)])
    deg = torch.repeat_interleave(d.in_deg.reshape(-1),
                                  d.indptr.diff(dim=1).reshape(-1).long())
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(crow, col, 1.0 / deg,
                                    size=(P * n_max, P * n_src))
    dense = fbuf.reshape(P * n_src, F)
    k1_lib = time_ms(lambda: torch.sparse.mm(a, dense))
    del a, crow, col, deg
    k1_bytes = (fbuf.numel() * 4 + n_edges * 4 + d.indptr.numel()
                * d.indptr.element_size() + d.in_deg.numel() * 4
                + P * n_max * F * 4)
    k1_ops = n_edges * F + P * n_max * F
    k1_bound, k1_by = bound_ms(k1_bytes, k1_ops)

    # --- K2 ------------------------------------------------------------
    k2_ms = time_ms(lambda: halo.halo_exchange(h, d.send_idx, d.send_mask))
    k2_plain = time_ms(lambda: halo.halo_gather_plain(
        h, d.send_idx, d.send_mask, True), reps=5)
    # library yardstick: one index_select of every output row from the
    # flattened parts, then the mask
    r = torch.arange(P, device="cuda")
    inner_rows = (r[:, None] * n_max
                  + torch.arange(n_max, device="cuda")[None, :])
    sender = (r[:, None] - torch.arange(1, P, device="cuda")[None, :]) % P
    sidx = d.send_idx[sender, torch.arange(P - 1, device="cuda")[None, :]]
    smask = d.send_mask[sender, torch.arange(P - 1, device="cuda")[None, :]]
    halo_rows = sender[..., None] * n_max + sidx.long().clamp(0, n_max - 1)
    gidx = torch.cat([inner_rows, halo_rows.reshape(P, -1)], 1).reshape(-1)
    gmask = torch.cat([torch.ones_like(inner_rows, dtype=torch.bool),
                       smask.reshape(P, -1)], 1).reshape(-1, 1)
    flat = h.reshape(P * n_max, F)
    zero = torch.zeros((), device="cuda")
    k2_lib = time_ms(lambda: torch.where(
        gmask, flat.index_select(0, gidx), zero))
    k2_bytes = (h.numel() * 4 + d.send_idx.numel() * 4
                + d.send_mask.numel() + P * (n_max + H) * F * 4)
    k2_bound, k2_by = bound_ms(k2_bytes, 0)

    kernels = [
        {"name": "spmm_mean", "route": "cuda",
         "source": "pipegcn_tpu_torch/ops/csrc/spmm_mean.cu",
         "replaces": "pipegcn_tpu/ops/spmm.py:33",
         "launches": launches["spmm_mean"], "max_abs_err": errs["K1"],
         "ms": k1_ms, "kernel_ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
         "shape": f"P={P} n_src={n_src} n_out={n_max} F={F} "
                  f"edges={n_edges} f32"},
        {"name": "halo_gather", "route": "cuda",
         "source": "pipegcn_tpu_torch/ops/csrc/halo_gather.cu",
         "replaces": "pipegcn_tpu/parallel/halo.py:173",
         "launches": launches["halo_gather"], "max_abs_err": errs["K2"],
         "ms": k2_ms, "kernel_ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib,
         "shape": f"P={P} n_max={n_max} H={H} F={F} f32"},
    ]
    # the pp precompute shape (F = 602, once per engine) for the record
    fpp = halo.halo_exchange(d.feat, d.send_idx, d.send_mask)
    pp = {"k1_pp_ms": time_ms(lambda: spmm.spmm_mean(fpp, *args), reps=5),
          "k2_pp_ms": time_ms(lambda: halo.halo_exchange(
              d.feat, d.send_idx, d.send_mask), reps=5)}
    return kernels, pp


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="synthetic-reddit",
                    help="graph to serve (default: the full-width cell)")
    ap.add_argument("--serve-seconds", type=float, default=5.0)
    ap.add_argument("--qps", type=float, default=200.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing to measure")
        return 2
    sys.path.insert(0, ROOT)
    try:
        from pipegcn_tpu_torch.ops import _build, spmm
        from pipegcn_tpu_torch.parallel import halo
    except ImportError as exc:
        log(f"chip_smoke: the port package is missing beside this "
            f"script ({exc})")
        return 2
    # full f32 matmuls (no TF32), as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import numpy

    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, numpy {numpy.__version__}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    secs = _build.build(["spmm_mean", "halo_gather"])
    log(f"[2] kernels built in {time.monotonic() - t0:.1f}s: {secs}")

    log(f"[3] serving path: {args.dataset}, 2 parts, GraphSAGE 4x256 "
        "use_pp")
    engine, summary, launches, serve_stats = serve_phase(args, spmm, halo)

    log("[4] kernels vs plain versions")
    errs = {"K1": k1_phase(engine, spmm, halo), "K2": k2_phase(engine, halo)}

    log("[5] timings")
    kernels, pp = timings(engine, spmm, halo, launches, errs)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "serving": {"dataset": args.dataset, "refresh_ms":
                    serve_stats["refresh_ms"], "p50_ms": summary["p50_ms"],
                    "p99_ms": summary["p99_ms"], "qps": summary["qps"],
                    "n_queries": summary["n_queries"],
                    "peak_mem_gib": serve_stats["peak_mem_gib"],
                    "artifact_build_s": serve_stats["artifact_build_s"],
                    "engine_build_s": serve_stats["engine_build_s"],
                    "logits_max_abs_err": serve_stats["logits_max_abs_err"],
                    **pp}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as exc:
        log(f"chip_smoke: FAILED: {exc}")
        sys.exit(1)
