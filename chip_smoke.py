#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``pipegcn_tpu_torch``).

    python3 chip_smoke.py            # one NVIDIA H100 (any CUDA card runs)

Drives the port's serving path and its training paths end to end on
one card, at the full width of the repo's model configs on the
``synthetic-reddit`` graph (loaded once, shared by every cell):
GraphSAGE (``scripts/reddit.sh``: 602 -> 256 -> 256 -> 256 -> 41, use_pp,
LayerNorm, f32), GAT (the same command with ``--model gat --n-heads 4``
minus ``--use-pp``: ``scripts/gat_bench.py``'s widths), GCN, GraphSAGE on
the bucket tables and on the block tiles with the fp8 gather transport,
GraphSAGE at bf16 compute on all three aggregations,
``scripts/gat_bench.py``'s configuration (GAT at bf16 compute with the
fp8 gather transport), and this slice's cell, the JAX package's tuned
stack (union-gather block tiles and the fp8 halo wire at bf16):

  1. prints the card's name and power limit (nvidia-smi) and versions;
  2. builds the hand-written kernels from ``pipegcn_tpu_torch/ops/csrc``
     (one nvcc per source, started together, in the background while the
     host loads the graph and builds the serving artifact; the first
     launch waits for them): K1 mean SpMM and K3 its
     transpose (``spmm_mean.cu``), K2 halo gather, K5 reverse-ring
     return and K18 the dirty-row exchange (``halo_gather.cu``), K4 boundary-gradient scatter in f32 and
     bf16 (``halo_scatter.cu``), K6 GAT attention forward (in training
     also the sums that give its backward's pass A) and K8 the
     backward's src-keyed pass B (``gat_attn.cuh``, one library a row
     type: f32 ``gat_attn.cu``, bf16 ``gat_attn_bf16.cu``, e4m3 z / e5m2
     g ``gat_attn_fp8.cu``), K9 the bucket-ELL gather-sum
     (``bucket_spmm.cu``), K10 the transport cast and K11 the per-part
     amax (``transport_cast.cu``), K12 / K13 the dense-tile products with
     f32 or bf16 rows and K16 / K17 the union-gather forward and
     transpose and the pre-split (``block_tma.cu``; f32 A in
     ``block_spmm.cu``), K14 / K15 the compressed halo wire
     (``halo_wire.cu``), K19 the integrity digests (``digest.cu``); and
     the native host library
     (``pipegcn_tpu_torch/native``, g++), whose absence fails the run;
  3. serves, over 2 random parts of the full graph (cut: not metis, no
     locality clusters): builds the artifact in memory (the serve CLI's
     ``build_artifact``), builds and warms the ServingEngine through the
     CLI's ``build_serving_engine``, serves a few seconds of open-loop
     queries with ``run_serving_loop``, and checks that the logits are
     finite, that both kernels were launched on that run, and that the
     served logits match a recompute through the plain versions;
  4. holds K1 (f32 and bf16) and K2 (bit-exact) against their plain
     versions at the main path's shapes and on edge cases; K1 at its slice
     rule's plan (``ops/spmm.py k1_plan``) and at forced slice plans
     bit-identical to K1 at one slice (S = 1, the whole-row kernel), each
     rerun bit-identical (edge cases: F = 1 to 602, empty rows, the
     5,000-edge row, pad edges, out-of-range indices, int64 row pointers);
  5. times K1 and K2 (CUDA events, median), their plain versions and one
     PyTorch library call computing the same function, beside the least
     time the card could take (``bound_ms``), K1 also at S = 1 and at the
     pp precompute's F = 602 beside cuSPARSE, and times the refresh;
 5a. serving freshness, ``bench.py --serve``'s configuration on the same
     parts (use_pp off, 100 qps, refresh and 32-row feature churn every
     0.5 s) through the serve CLI's functions: 5 s without churn, 10 s
     with it, 5 s with ``--update-fraction 0.05`` on top, the counts set
     to 0 before the engine's build and read after (K1, K2 and K18, the
     dirty-row exchange in ``halo_gather.cu``, launched); the halo against
     a K2 full exchange bit for bit, the logits after ``refresh()``
     against a recompute through the plain versions; K18 bit-exact
     against its plain version at the cell's shapes (32, 256, 4,096 and
     all dirty rows) and on edge cases (P = 2, 3, 4, f32 and bf16 rows,
     odd row bytes, masked-off out-of-range indices, one owner on every
     distance, NaN payloads in clean slots); a K18 fed the wrong mask or
     bits must fail; K18's, K2's and the refresh's times, one churn
     batch's ``apply_updates`` and ``refresh_boundary`` (host and
     device); then GCN with 2 s of churn, its halo held likewise;
  6. trains the ``scripts/reddit.sh`` cell through the training CLI's
     functions (``cli/main.py``: ``--inductive --enable-pipeline
     --use-pp``, dropout 0.5, Adam lr 0.01, 2 metis parts of the train
     subgraph by the native partitioner, native locality clusters; cut:
     the epoch count), the counts set to 0 just before the trainer is
     built and read after the final val/test eval: a finite loss every
     epoch that falls, finite accuracies, every one of K1-K5 launched;
  7. runs one pipelined epoch through the kernels twice from the same
     state and dropout seed (bit-identical: no kernel uses atomics), and
     holds it against the same epoch through the plain versions on the
     kernel run's relu masks (flips counted);
  8. holds K1 at the cell's shape (f32 and bf16 rows) bit-identical to
     S = 1, at the rule's plan and at forced slice plans; holds K3, K4
     and K5 against their plain versions at the cell's shapes
     and on edge cases (K3 also bit-identical to K1's whole-row kernel
     over g / in_deg, at the cell (F = 256, 602) and on edge cases: F = 1
     to 602, empty rows, the 5,000-edge row, n_src not a multiple of a
     CTA's rows, int64 row pointers; K5: P = 2, 3 and 4, F = 3 to 602, f32 and bf16
     rows, strided views whose part stride is no multiple of 16 bytes, H
     = 0; one block from the wrong sender must fail); K4 in bf16
     (bit-exact at P = 2 and 4), K2 and K5 bit-exact on bf16 rows;
  9. times K3-K5 (K4 also in bf16; K3 beside K1's whole-row kernel over
     g / in_deg) and K1/K2 at the epoch's shapes (K5
     also 20 calls back to back, beside index_select and a copy_ of the
     same blocks, strided and contiguous: the card's copy floor), the
     epoch (median) with its
     split and the peak memory; then 3 vanilla epochs and a fourth held
     against the plain versions as in [7];
 10. trains the GAT cell the same way on the same parts (f32);
 11. holds one pipelined GAT epoch against the plain versions as in [7],
     the plain run also taking the kernel run's leaky branches;
 12. holds K6 and K8 against their plain versions in each row type (f32;
     bf16; e4m3 z with e5m2 g) at the cell's shapes (dh = 64 and the
     logits layer's 41) and on edge cases (empty rows, a 5,000-edge row,
     dh = 5 with H = 8, unaligned rows; f32 also H = 1, equal logits,
     int64 row pointers, junk past the CSRs' ends), each rerun
     bit-identical (K6's NEG mode: m and s bit-identical to its eval
     mode's, whose out is held to the plain version on its own); K8's
     worst error in GAT_SUM_C's unit reported; a planted fault (one edge
     of the 5,000-edge row dropped) must fail each check in each row
     type;
 13. times K6 (NEG and eval modes) and K8 in each row type at dh = 64
     and 41, the GAT epoch and its split;
 14. runs a few pipelined GCN epochs and holds one against the plain
     versions;
 15. trains the bucket cell (``--spmm-impl bucket --rem-dtype float8``),
     one epoch alone, and 2 epochs each of ``--rem-amax``,
     ``--rem-dtype bfloat16`` and ``none`` on the same trainer;
 16. holds one bucket epoch against the plain versions, the transported
     values shared (``TransportShare``);
 17. holds K9-K11 against their plain versions (K9 bit-exact in every
     dtype, at the cell and on edge cases: one CTA's rows spanning every
     bucket width, rows one entry past a lane group's chunk, sentinels
     in the middle of rows, negative indices, empty rows, F = 1 to 602;
     K10 / K11 bit-exact), three planted faults (K11's: one max over
     both parts);
 18. times K9-K11, the bucket epoch and its split;
 19. runs the bucket command at ``--dtype bfloat16`` on the same trainer
     and tables for a few epochs, then its step check; a few GCN epochs
     on the bucket path and their step check;
 20. trains the block cell (``--spmm-impl block --rem-dtype float8``),
     then 2 epochs of ``--rem-dtype none``;
 21. holds one block epoch against the plain versions;
 22. holds K12 / K13 against their plain version on f32 rows and in their
     bf16 mode, at the cell's shapes (K12 also at F = 1, Freivalds') and
     on edge cases; K12 on ``block_tma.cu`` over hand-made pair lists (T
     = 32, 96, 160, 224; 1-bit, int8 and bf16 A; F = 1, 64, 602 f32 rows,
     bf16 rows at F = 5, 64, 100; empty output tiles, which must be
     zeros); a flipped A bit must fail in both and at T = 96;
 23. times K12 / K13 on f32 rows and in the bf16 mode beside cuSPARSE
     (f32) and the tile floors, one call and 20 back to back; the block
     epoch and its split;
 23a. serving through the trainers' aggregation with the transport off:
     a ServingEngine on the block cell's staged parts and tables
     (``spmm_impl="block"``: K12 and K9) and one on the bucket cell's
     (``"bucket"``: K9), no new artifact or tables, and ``"xla"`` (K1)
     beside them; the counts set to 0 before each build and each refresh
     and read after: the table kernels grow, K1's does not; the logits
     against a recompute through the plain versions of the same
     aggregation; each refresh timed;
 24. runs the block command at ``--dtype bfloat16`` on the same trainer
     and tables (K12 / K13 in their bf16 mode), then its step check;
 25. a few GCN epochs on the block path and their step check;
 26. runs ``scripts/reddit.sh --dtype bfloat16`` (xla) for a few epochs
     and its step check;
 27. trains this slice's cell: ``scripts/gat_bench.py``'s configuration
     (``--model gat --n-heads 4 --n-layers 4 --n-hidden 256 --dtype
     bfloat16 --spmm-impl bucket --rem-dtype float8``, pipelined) through
     the CLI's functions, the counts set to 0 just before the build and
     read after the final eval (K6 / K8 on e4m3 / e5m2 rows, K10, K4 in
     bf16), then 2 epochs each of ``--rem-dtype bfloat16`` and ``none``;
 28. holds one of its epochs against the plain versions (relu masks,
     leaky branches and transported values shared; at bf16 each tensor
     within the repo's bf16 tolerance of its max, the bf16 carries'
     rounding steps counted), and times the epoch and its split;
 29. trains this slice's cell, the JAX package's tuned stack: the
     command plus ``--dtype bfloat16 --spmm-impl block --block-group 4
     --rem-dtype float8 --halo-dtype float8`` through the CLI's
     functions, the counts set to 0 just before the build and read after
     the final eval (K16 / K17 in their bf16 mode, K14 / K15 on the e4m3
     / e5m2 wire, K9, K10, K4 in bf16), then 2 epochs each of
     ``--halo-dtype bfloat16`` and ``none``;
 30. holds one of its epochs against the plain versions (relu masks,
     transported values and wire payloads shared), rerun bit-identical;
 31. holds K14 / K15 bit-exact against their plain versions: the cell's
     shapes, an emulated P = 4 set whose per-block scales differ across
     distances, every wire (e4m3, e5m2, bf16) on f32 and bf16 rows, edge
     cases (all-masked and zero-amax blocks, a NaN row, the bit-pattern
     sweep; the vector's: F = 1, 3, 41, 602, a strided return view whose
     part stride is no multiple of 16 bytes, B below a block's chunk,
     every row masked); the decode with the receiver's own scale must
     fail;
 32. holds K16 / K17 against their plain version (every A encoding,
     groups 2, 4 and 8, a tail group, an empty group, a one-tile union),
     each rerun bit-identical; a flipped A bit must fail; K16's pre-split
     bit-exact against its plain version (the cell's rows at F = 256 and
     602, the finite bit-pattern sweep, bf16 rows at F = 100); K16's TMA /
     wgmma path on hand-made groups (T = 32, 96, 224, 128, 256; groups 2,
     4, 8, 16; f32 rows at F = 602 and 130, bf16 rows at F = 5 and 100; a
     tail group, an empty group, slots unused by half a group or by all of
     it), and a flipped A bit at T = 96 must fail; K17's TMA / wgmma path
     on hand-made transposed groups (T = 32, 96, 128, 160, 224, 256;
     groups 1 to 16; 1-bit, int8 and bf16 A; f32 and bf16 rows), and
     K13's over hand-made pair lists (their union view at G = 1; T = 32
     to 256), where in each A encoding a changed A entry and A read
     untransposed must fail; each check names the C entry it ran;
 33. times K14-K17, reports the union dedupe beside K12's group-1 time,
     the wire cell's epoch and its split;
 34. trains this slice's cell, the integrity plane: the reddit.sh command
     plus ``--integrity-check-every 2`` through the CLI's functions on the
     same parts, the counts set to 0 just before the build and read after
     the final eval: every check ok and none skipped, K19 (all three
     forms) launched, Freivalds' device half K2 and K1 once each at F = 1;
     the epoch with no check, a boundary check and a deep check;
 35. the detection matrix on that trainer: one fit per target class with
     ``bitflip@3:<class>`` (8 epochs, eval off), each injected, detected by
     epoch 5, attributed and recovered; on the bucket trainer of [15] and
     the block trainer of [20] (each at bf16 since [19] / [24]) Freivalds
     ok through K9 and through K12 with K9 at F = 1, and a table flip
     scrubbed, attributed to its part, rebuilt and cleared;
 36. the wire guard: a guarded pipelined SAGE epoch bit-identical to the
     unguarded one (``wire_bad`` 0), the same on the wire cell's trainer
     of [29] under ``--halo-dtype float8`` and ``bfloat16``; corrupted
     K15 outputs on that trainer (the script wraps K15's wrapper: a bit of
     one decoded halo block, of one payload block, of one fp8 scale)
     counted, one block each; a corrupted copy (the script wraps K2's
     wrapper) counted and, through fit, the carry flushed; the freshness
     engine of [5a] with the guard on over
     32-row churn batches, its halo bit-identical to K2's full exchange,
     and a corrupted K18 copy rebuilt by the full exchange;
 37. holds K19 bit-exact against its plain version and the numpy
     host_digest (every dtype, 0 / 1 / 97 elements, an unaligned view,
     the use_pp features, the per-part and rows forms, a flipped bit), and
     times it over the static data, the features and the guard's rows
     beside its bound, its plain version and the library sum;
 38. prints the ``kernels`` JSON line (every kernel and each of its row
     types, times at the shapes whose launches are counted), a line for
     each cell, the nvidia-smi line, and last ``{"ok": true, "device":
     {...}}``. With ``--parent DIR`` (a parent commit unpacked with ``git
     archive``) it first times K5, K11, K12, K13, K15, K16 and K17 of DIR
     against this checkout's with
     ``pipegcn_tpu_torch/tools/time_tile_products.py`` and K1, K3 (random
     rows, and at the training cell's locality), K9 (the training cell's
     sizes: clustered tables in every row type, random tables at e4m3), K6
     and K8 (dh = 64 and 41) with ``tools/time_gather_kernels.py``, in
     turns
     (parent, this, this, parent; each tool its own process) and carries
     both in those kernels' ``parent_ab``.

Exits non-zero, printing no result, when CUDA is unavailable, when the
package is missing (the script alone), or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
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
# K3 sums the same f32 terms g * (1 / in_deg) as its plain version (the
# product rounded before the add in both), K3 per row in edge order, the
# plain version by index_add_ atomics: they differ only by summation
# order, as K1 does. K4 at P > 2 adds up to P-1 rows per element in
# another order than index_add_ (at P = 2 one add: bit-exact). A training
# step through the kernels against the plain versions: the order
# differences of 6 SpMMs pass through 4 layers, LayerNorm and softmax;
# gradients and carries are compared against their largest magnitude,
# on the kernel run's relu masks (step_phase); a pre-activation whose
# sign the two roundings disagree on is a flip, rare where the inputs
# are O(1) LayerNorm outputs and the roundings differ by ulps.
K3_ATOL, K3_RTOL = 1e-5, 1e-5
# K3 sums (not averages) up to thousands of terms per row, which can
# cancel: its checks add SUM_RTOL times the sum of the terms' magnitudes
# (about sqrt(n) * f32 eps for n terms in two random orders is far below)
SUM_RTOL = 1e-5
K4_ATOL, K4_RTOL = 1e-6, 1e-6
STEP_LOSS_RTOL = 1e-5
STEP_REL_TOL = 1e-4
RELU_FLIP_FRAC = 1e-4
# K6 and K8 against their plain versions: both compute every logit and
# weight the same way (the leaky logit, expf) and differ in summation
# order (the kernels per row in edge order, the plain versions by
# index_add_ atomics). Both kernels fuse each product into its add (an
# FMA: the term is not rounded on its own, a difference of at most half
# an ulp of the term, where the plain version rounds the product first).
# Both sum each leaky branch apart (but on f32 rows whose chunks straddle
# two heads, dh = 41) and combine the two sums at the end: K6's out =
# (pos + neg) / s; K8's d_z = pos + neg and its beta-weighted row sum
# fma(slope, neg, pos), where the plain version weights each term by
# beta = alpha or slope * alpha (the same terms regrouped). At dh = 41 on
# f32 rows K8 keeps an alpha sum and a beta sum, two FMAs an element. K8
# contracts the beta-weighted row sum with the row's own z after the edge
# loop instead of per edge (the same terms regrouped again). So the bound
# adds a multiple of the sum of the terms' magnitudes (the plain pass on
# |z|, |g| and -|rho| gives it), which covers all of it. The row max m is
# a max of identically computed values: bit-exact. The GAT step shares
# the kernel run's leaky branches with the plain run as it shares the relu
# masks: a logit within rounding of 0 switches leaky' between 1 and the
# slope, a jump no rounding tolerance bounds; such flips are counted.
GAT_ATOL, GAT_RTOL = 1e-5, 1e-5
LEAKY_FLIP_FRAC = 1e-4
# The sum term of a row of n terms is gamma_n = max(SUM_RTOL, GAT_SUM_C
# sqrt(n) u) times the sum of their magnitudes (u = 2**-24; n plus dh
# where a dot product adds terms). Two orders of n terms differ by about
# sqrt(n) u where the roundings are independent; on an H100 the worst
# seen was 4.75 sqrt(n) u, on the edge cases' 5,000-edge row, a third of
# whose terms come from one source (equal terms round alike); K8's worst
# with its per-branch sums (K8_WORST, reported each run) was 1.06. 16
# leaves a margin of 3.4 over 4.75, and stays under the shift of one
# dropped edge of that row (1/n of the sum, 47 sqrt(n) u):
# gat_fault_phase plants that fault and requires each check to fail.
GAT_SUM_C = 16.0
F32_U = 2.0 ** -24
# K9, K10 and K11 are bit-exact against their plain versions (a NaN equal
# to any NaN: the kernel and torch write different NaN patterns). K9 and
# its plain version sum each row in table order in f32: no tolerance on
# summation order is needed (a tolerance linear in the row's length would
# be: a sequential sum of 1,500 equal terms, as the edge cases' heavy
# rows hold, drifts ~n u / 2 of its magnitude from a pairwise one).
# The bucket step shares the kernel run's transported values with the
# plain run as it shares the relu masks; a cast input within rounding of
# a midpoint of the narrow format is a transport flip, counted.
TRANSPORT_FLIP_FRAC = 1e-4
# bf16 compute: where the plain versions sum in another order than the
# kernels (K1, K3, K6, K8 against index_add_; K9's plain version sums in
# the kernel's order), a bf16 value can round to the neighbouring bf16
# value, a step of up to 2**-7 of its magnitude, and LayerNorm scales a
# step by the row's 1/std; each moves every tensor downstream of it. So a
# bf16 epoch's gradients, params and carries are held within BF16_RTOL of
# each tensor's max, the repo's bf16 tolerance (ROADMAP: rtol 2e-2), in
# place of STEP_REL_TOL (seen, full size: carries 3.9e-3, gradients
# 1.7e-5 in the bf16 GAT cell; gradients 8.3e-6, params 4.4e-4 on the xla
# path); the loss keeps STEP_LOSS_RTOL. The carries' elements that differ
# by more than STEP_REL_TOL of the max (the rounding steps, 1.5e-3 of
# them seen) must stay below BF16_STEP_FRAC, and so must the transport
# flips, whose bf16 inputs move by those steps (1.4e-4 seen)
BF16_RTOL = 2e-2
BF16_STEP_FRAC = 1e-2


START = time.monotonic()


def log(msg: str) -> None:
    """To stderr; a phase heading (``[n] ...``) carries the seconds since
    the script started, so a run shows where its time went."""
    if msg[:1] == "[" and msg[1:2].isdigit():
        msg = f"{msg} (t = {time.monotonic() - START:.1f}s)"
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


def batched_ms(fn, calls: int = 20) -> float:
    """Milliseconds a call of ``fn`` with ``calls`` calls back to back
    between one event pair (median of ``time_ms``'s repetitions): the
    host runs ahead, so the card's time, without the host work that an
    event pair around a single call on an idle card also counts."""
    def run():
        for _ in range(calls):
            fn()

    return time_ms(run, reps=10, warmup=1) / calls


def bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_close(name, got, ref, atol, rtol, abs_sum=None,
                sum_rtol=SUM_RTOL) -> float:
    """|got - ref| <= atol + rtol * |ref| elementwise; with ``abs_sum``
    (the same sum taken over the terms' absolute values) the bound adds
    ``sum_rtol * abs_sum`` (SUM_RTOL, or a per-row tensor): two summation
    orders of n terms differ by a multiple of f32 eps times the sum of the
    terms' magnitudes, which |ref| does not bound where the terms
    cancel."""
    import torch

    require(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
            f"{tuple(ref.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = max_err(got, ref)
    bound = atol + rtol * ref.double().abs()
    if abs_sum is not None:
        bound = bound + sum_rtol * abs_sum.double()
    diff = (got.double() - ref.double()).abs()
    ok = bool((diff <= bound).all())
    worst = float((diff / bound).max()) if diff.numel() else 0.0
    extra = ""
    if abs_sum is not None:
        extra = (f" + {sum_rtol:g}*sum|terms|" if isinstance(sum_rtol, float)
                 else " + gamma_n*sum|terms|")
    log(f"  {name}: max_abs_err={err:.3e} (tol {atol:g} + {rtol:g}*|ref|"
        f"{extra}; worst err/tol {worst:.3f}) {'ok' if ok else 'FAIL'}")
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


def serve_phase(args, g, spmm, halo, kernels_built):
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
        "--norm", "layer", "--dtype", "float32", "--seed", "0",
        # a cut: locality clusters of the full graph cost a second
        # clustering; serving reads K1 over either layout
        "--local-reorder", "none"])
    t0 = time.monotonic()
    sg = build_artifact(cli, log=log, g=g)
    t_artifact = time.monotonic() - t0
    kernels_built()  # the first kernel launches in the engine's build

    spmm.spmm_mean.launches = 0
    halo.halo_gather.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = build_serving_engine(cli, log=log, sg=sg)
    t_engine = time.monotonic() - t0
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
    return sg, engine, summary, launches, {
        "refresh_ms": refresh_ms, "peak_mem_gib": peak_gib,
        "logits_max_abs_err": err_all, "artifact_build_s": t_artifact,
        "engine_build_s": t_engine}


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions


def k1_slices(name, spmm, fb, args, plans=()):
    """K1 at the slice rule's plan (``spmm.k1_plan``; the wrapper's
    launch) and at each of ``plans`` against K1 at S = 1 (the whole-row
    kernel, one slice: the summation order of the design before the
    slices), bit for bit, each rerun bit-identical. Returns the rule's
    plan."""
    import torch

    F = fb.shape[-1]
    rule = spmm.k1_plan(fb.shape[-2], F, fb.element_size(),
                        spmm._l2_bytes(fb.device), fb.data_ptr())
    whole = spmm.k1_launch(fb, *args, plan=(F, 0))
    for plan in (None, *plans):
        got = spmm.k1_launch(fb, *args, plan=plan)
        W, vec = rule if plan is None else plan
        label = (f"W={W} vec={vec} (S={-(-F // W)}"
                 f"{', the rule' if plan is None else ''})")
        require(torch.equal(got, whole), f"{name}: K1 at {label} is not "
                "bit-identical to K1 at S = 1")
        require(torch.equal(spmm.k1_launch(fb, *args, plan=plan), got),
                f"{name}: K1 at {label}: a rerun is not bit-identical")
        log(f"  {name}: K1 at {label} bit-identical to S = 1, rerun "
            "bit-identical ok")
    return rule


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
        k1_slices(name, spmm, fb, args)

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
    # the table is small here, so the rule keeps one slice: the sliced
    # kernel runs at forced plans (slices of 8 to 64 columns, loads of 1
    # to 8 elements, groups of 8 to 32 lanes, a last slice cut by F)
    sliced = {torch.float32: ((8, 1), (16, 2), (32, 1), (32, 4), (64, 2)),
              torch.bfloat16: ((8, 1), (16, 2), (32, 1), (64, 8),
                               (64, 2))}
    empty = torch.from_numpy(deg == 0).cuda()
    for F in (1, 3, 16, 41, 256, 602):
        for dt in (torch.float32, torch.bfloat16):
            fb = torch.randn((n_src, F), generator=gen, device="cuda").to(dt)
            got = spmm.spmm_mean(fb, indptr, src, in_deg)
            ref = spmm.spmm_mean_plain(fb, indptr, src, in_deg)
            errs.append(check_close(f"K1 edge cases {dt} F={F}", got, ref,
                                    K1_ATOL, K1_RTOL))
            require(bool((got[empty] == 0).all()),
                    "K1: empty rows must be exactly zero")
            plans = [p for p in sliced[dt] if p[0] < F and F % p[1] == 0]
            k1_slices(f"K1 edge cases {dt} F={F}", spmm, fb,
                      (indptr, src, in_deg), plans)
            for plan in plans:
                require(bool((spmm.k1_launch(fb, indptr, src, in_deg,
                                             plan=plan)[empty] == 0).all()),
                        f"K1 at {plan}: empty rows must be exactly zero")
    junk = src.clone()
    junk[dst.size:] = 123  # pad edges past indptr[n_out]
    fb = torch.randn((n_src, 16), generator=gen, device="cuda")
    for plan in (None, (8, 1)):
        require(torch.equal(
            spmm.k1_launch(fb, indptr, junk, in_deg, plan=plan),
            spmm.k1_launch(fb, indptr, src, in_deg, plan=plan)),
            f"K1 at {plan or 'the rule'} read a pad edge past indptr[n_out]")
    errs.append(check_close("K1 int64 indptr", spmm.spmm_mean(
        fb, indptr.long(), src, in_deg), spmm.spmm_mean_plain(
        fb, indptr, src, in_deg), K1_ATOL, K1_RTOL))
    k1_slices("K1 int64 indptr", spmm, fb, (indptr.long(), src, in_deg),
              ((8, 1),))
    # junk indices clamped into range: the same as their clamped values
    wild = src.clone()
    wild[:dst.size:5] = -7
    wild[1:dst.size:5] = n_src + 11
    clamped = wild.clamp(0, n_src - 1)
    for plan in (None, (8, 1)):
        require(torch.equal(
            spmm.k1_launch(fb, indptr, wild, in_deg, plan=plan),
            spmm.k1_launch(fb, indptr, clamped, in_deg, plan=plan)),
            f"K1 at {plan or 'the rule'}: out-of-range indices are not "
            "clamped")
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


def k1_timing(d, spmm, fbuf, edges, reps=20):
    """K1 over ``fbuf`` [P, n_src, F] f32 on staged data ``d``: ms at the
    slice rule's plan (the wrapper's launch) and at S = 1 (``whole_ms``:
    the whole-row kernel), plain ms, one library call's ms and the
    bound."""
    import torch

    P, n_src, F = fbuf.shape
    n_max, n_edges = d.n_max, sum(edges)
    args = (d.indptr, d.edge_src, d.in_deg)
    ms = time_ms(lambda: spmm.spmm_mean(fbuf, *args), reps=reps)
    whole = time_ms(lambda: spmm.k1_launch(fbuf, *args, plan=(F, 0)),
                    reps=reps)
    plain = time_ms(lambda: spmm.spmm_mean_plain(fbuf, *args), reps=3,
                    warmup=1)
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
    lib = time_ms(lambda: torch.sparse.mm(a, dense), reps=reps)
    del a, crow, col, deg
    n_bytes = (fbuf.numel() * 4 + n_edges * 4 + d.indptr.numel()
               * d.indptr.element_size() + d.in_deg.numel() * 4
               + P * n_max * F * 4)
    plan = spmm.k1_plan(n_src, F, 4, spmm._l2_bytes(fbuf.device),
                        fbuf.data_ptr())
    log(f"  K1 F={F}: {ms:.3f} ms at W={plan[0]} vec={plan[1]} "
        f"(S={-(-F // plan[0])}), {whole:.3f} at S = 1, cuSPARSE "
        f"{lib:.3f}")
    return dict(ms=ms, whole_ms=whole, plain_ms=plain, library_ms=lib,
                plan=list(plan), bound=bound_ms(n_bytes,
                                                 n_edges * F + P * n_max * F),
                shape=f"P={P} n_src={n_src} n_out={n_max} F={F} "
                      f"edges={n_edges} f32")


def k1_k2_timings(d, spmm, halo, with_inner, seed):
    """K1 (``k1_timing``) and K2 on staged data ``d`` (serving engine's or
    trainer's): ms, plain ms, one library call's ms and the bound, at F =
    256 f32. K2 with
    the inner rows (serving, vanilla exchange) or without (the pipelined
    epoch's fresh-halo blocks)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    P, n_max, H = d.num_parts, d.n_max, d.halo_size
    F = 256
    h = torch.randn((P, n_max, F), generator=gen, device="cuda")
    fbuf = halo.halo_exchange(h, d.send_idx, d.send_mask)
    edges = [int(d.indptr[p, -1]) for p in range(P)]

    # --- K1 ------------------------------------------------------------
    k1 = k1_timing(d, spmm, fbuf, edges)
    del fbuf

    # --- K2 ------------------------------------------------------------
    k2_ms = time_ms(lambda: halo.halo_gather(h, d.send_idx, d.send_mask,
                                             with_inner))
    k2_plain = time_ms(lambda: halo.halo_gather_plain(
        h, d.send_idx, d.send_mask, with_inner), reps=5)
    # library yardstick: one index_select of every output row from the
    # flattened parts, then the mask
    r = torch.arange(P, device="cuda")
    sender = (r[:, None] - torch.arange(1, P, device="cuda")[None, :]) % P
    sidx = d.send_idx[sender, torch.arange(P - 1, device="cuda")[None, :]]
    smask = d.send_mask[sender, torch.arange(P - 1, device="cuda")[None, :]]
    gidx = (sender[..., None] * n_max
            + sidx.long().clamp(0, n_max - 1)).reshape(P, -1)
    gmask = smask.reshape(P, -1)
    if with_inner:
        inner_rows = (r[:, None] * n_max
                      + torch.arange(n_max, device="cuda")[None, :])
        gidx = torch.cat([inner_rows, gidx], 1)
        gmask = torch.cat([torch.ones_like(inner_rows, dtype=torch.bool),
                           gmask], 1)
    gidx, gmask = gidx.reshape(-1), gmask.reshape(-1, 1)
    flat = h.reshape(P * n_max, F)
    zero = torch.zeros((), device="cuda")
    k2_lib = time_ms(lambda: torch.where(
        gmask, flat.index_select(0, gidx), zero))
    # reads: every inner row with them, else only the rows sent
    read_rows = P * n_max if with_inner else int(d.send_mask.sum())
    n_out = (n_max if with_inner else 0) + H
    k2_bytes = (read_rows * F * 4 + d.send_idx.numel() * 4
                + d.send_mask.numel() + P * n_out * F * 4)
    return {
        "K1": k1,
        "K2": dict(ms=k2_ms, plain_ms=k2_plain, library_ms=k2_lib,
                   bound=bound_ms(k2_bytes, 0),
                   shape=f"P={P} n_max={n_max} H={H} F={F} "
                         f"with_inner={with_inner} f32"),
    }


def timings(engine, spmm, halo):
    """K1 and K2 at the serving shape, and at the pp precompute's."""
    d = engine.data
    t = k1_k2_timings(d, spmm, halo, with_inner=True, seed=5)
    # the pp precompute's shape (F = 602: once per engine, and layer 0 of
    # every use_pp-off refresh), K1 beside cuSPARSE and its bound
    fpp = halo.halo_exchange(d.feat, d.send_idx, d.send_mask)
    edges = [int(d.indptr[p, -1]) for p in range(d.num_parts)]
    t["K1 F=602"] = k1_timing(d, spmm, fpp, edges, reps=7)
    pp = {"k1_pp_ms": t["K1 F=602"]["ms"],
          "k2_pp_ms": time_ms(lambda: halo.halo_exchange(
              d.feat, d.send_idx, d.send_mask), reps=5)}
    return t, pp


# ---------------------------------------------------------------------------
# phase 5a: serving freshness (bench.py --serve's configuration)

# bench.py --serve (_measure_serve): use_pp off, dropout 0, 100 qps for
# 10 s, refresh and 32-row feature churn every 0.5 s (bench.py:342-357,
# serve/loadgen.py:253); the mixed workload adds --update-fraction 0.05
FRESH_FLAGS = ["--n-partitions", "2", "--partition-method", "random",
               "--n-layers", "4", "--n-hidden", "256", "--norm", "layer",
               "--dtype", "float32", "--seed", "0", "--local-reorder",
               "none", "--serve-qps", "100", "--serve-duration", "10",
               "--serve-refresh-every", "0.5", "--serve-update-every", "0.5",
               "--serve-update-rows", "32"]


def fresh_serve(engine, cli, duration, update_every, fraction, seed):
    from pipegcn_tpu_torch.serve import run_serving_loop

    s = run_serving_loop(engine, duration_s=duration, qps=cli.serve_qps,
                         refresh_every_s=cli.serve_refresh_every,
                         report_every_s=2.0, update_every_s=update_every,
                         update_rows=cli.serve_update_rows,
                         update_fraction=fraction, seed=seed)
    require(s["drained"] and s["conserved"] and s["n_queries"] > 0,
            f"serving loop: {s}")
    log(f"  {duration:g} s, churn every {update_every:g} s, update fraction "
        f"{fraction:g}: {s['n_queries']} queries, {s['n_update_arrivals']} "
        f"update arrivals, p50 / p99 {s['p50_ms']:.3f} / {s['p99_ms']:.3f} "
        f"ms, hit rate {s['cache_hit_rate']}, staleness max "
        f"{s['staleness_age_max']}")
    return s


def live_slots(dirty, idx, mask):
    """Per halo slot: its owner row is dirty and the slot is on a send
    list — the slots K18 writes. ``[P, (P-1)*B]`` bool."""
    import torch

    P, n_max = dirty.shape
    B = idx.shape[2]
    out = torch.zeros((P, (P - 1) * B), dtype=torch.bool, device=idx.device)
    for r in range(P):
        for d in range(1, P):
            s = (r - d) % P
            i = idx[s, d - 1].long().clamp(0, n_max - 1)
            out[r, (d - 1) * B:d * B] = dirty[s].bool()[i] & mask[s, d - 1]
    return out


def k18_check(name, fresh, h, old, dirty, idx, mask, kernel_args=None):
    """K18 on a copy of ``old`` against its plain version on another, bit
    for bit; ``kernel_args`` (dirty, mask) hands the kernel other inputs
    than the plain version (a planted fault)."""
    kd, km = kernel_args or (dirty, mask)
    got = fresh.dirty_exchange(h, old.clone(), kd, idx, km)
    want = fresh.dirty_exchange_plain(h, old.clone(), dirty, idx, mask)
    return check_bits(name, got, want)


def dirty_rows(P, n_max, n, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    d = torch.zeros(P * n_max, dtype=torch.bool, device="cuda")
    if n >= P * n_max:
        d[:] = True
    else:
        d[torch.randperm(P * n_max, generator=g, device="cuda")[:n]] = True
    return d.view(P, n_max)


def k18_edge_phase(fresh, halo):
    """K18 against its plain version on hand-made send lists: P = 2 and 4,
    f32 and bf16 rows, F = 602 (8-byte rows) and F = 5 (odd bytes), with
    masked-off slots at out-of-range indices, one owner row on every
    distance, distinct NaN payloads in the old halo; dirty sets empty,
    all, off-list, random, the one owner."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(31)
    for P, n_max, B, F, dt in ((2, 300, 120, 602, torch.float32),
                               (4, 300, 90, 602, torch.float32),
                               (4, 65, 20, 5, torch.float32),
                               (4, 300, 90, 602, torch.bfloat16),
                               (3, 50, 17, 7, torch.bfloat16)):
        idx = torch.randint(0, n_max - 4, (P, P - 1, B), generator=gen,
                            device="cuda", dtype=torch.int32)
        mask = torch.rand((P, P - 1, B), generator=gen, device="cuda") < 0.75
        idx[:, :, -1] = n_max + 5
        idx[:, :, -2] = -7
        mask[:, :, -2:] = False
        idx[0, :, :2] = 3
        mask[0, :, :2] = True
        h = torch.randn((P, n_max, F), generator=gen, device="cuda").to(dt)
        ib = torch.int32 if dt == torch.float32 else torch.int16
        info = torch.iinfo(ib)
        old = torch.randint(info.min, info.max, (P, (P - 1) * B, F),
                            generator=gen, device="cuda",
                            dtype=torch.int64).to(ib)
        nan = 0x7FC00001 if dt == torch.float32 else 0x7FC1
        old.view(-1)[:64] = torch.arange(nan, nan + 64, device="cuda").to(ib)
        old = old.view(dt)
        on = torch.zeros((P, n_max), dtype=torch.bool, device="cuda")
        for p in range(P):
            on[p, idx[p][mask[p]].long()] = True
        owner = torch.zeros_like(on)
        owner[0, 3] = True
        for label, dirty in (("empty", torch.zeros_like(on)),
                             ("all", torch.ones_like(on)), ("off-list", ~on),
                             ("random", torch.rand((P, n_max), generator=gen,
                                                   device="cuda") < 0.3),
                             ("one owner", owner)):
            k18_check(f"K18 P={P} F={F} {dt} dirty {label}", fresh, h, old,
                      dirty, idx, mask)
        n_live = int(live_slots(owner, idx, mask).sum())
        require(n_live >= 2 * (P - 1), f"one owner: {n_live} live slots")
    # the fault checks: a kernel that ignores the mask writes the masked-off
    # slots of dirty owners; one that ignores the bits writes clean slots
    all_on = torch.ones_like(mask)
    all_dirty = torch.ones_like(on)
    must_fail("planted fault: K18 ignoring send_mask",
              lambda: k18_check("K18 mask ignored", fresh, h, old, all_dirty,
                                idx, mask, (all_dirty, all_on)))
    must_fail("planted fault: K18 writing clean slots",
              lambda: k18_check("K18 bits ignored", fresh, h, old,
                                torch.zeros_like(on), idx, mask,
                                (all_dirty, mask)))


def freshness_phase(args, sg, spmm, halo, fresh):
    """bench.py --serve's configuration through the serve CLI's
    functions on the serving phase's artifact: serve without churn (5 s),
    with the 32-row churn (10 s) and with the mixed workload on top (5 s),
    the counts set to 0 before the engine's build and read after the
    last run; the halo against a K2 full exchange bit for bit, the logits
    against a recompute through the plain versions; K18 against its plain
    version at the cell's shapes (32, 256, 4,096 and all dirty rows) and
    on edge cases, two planted faults; the timings; then GCN with 2 s of
    churn, its halo held likewise. Returns the stats and the GraphSAGE
    engine (kept for [36])."""
    import numpy as np
    import torch
    from pipegcn_tpu_torch.cli.serve import build_parser, \
        build_serving_engine
    from pipegcn_tpu_torch.models.sage import forward

    cnt = {"spmm_mean": spmm.spmm_mean, "halo_gather": halo.halo_gather,
           "dirty_exchange": fresh.dirty_exchange}
    cli = build_parser().parse_args(
        ["--dataset", args.dataset, "--model", "graphsage", *FRESH_FLAGS])
    reset_counts(cnt)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = build_serving_engine(cli, log=log, sg=sg)
    t_engine = time.monotonic() - t0
    quiet = fresh_serve(engine, cli, 5.0, 0.0, 0.0, seed=2)
    churn = fresh_serve(engine, cli, cli.serve_duration,
                        cli.serve_update_every, 0.0, seed=0)
    mixed = fresh_serve(engine, cli, 5.0, cli.serve_update_every, 0.05,
                        seed=1)
    torch.cuda.synchronize()
    launches = read_counts(cnt)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  engine in {t_engine:.1f}s; launches {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the freshness path was never launched: {launches}")
    require(mixed["n_update_arrivals"] > 0, "no update arrivals")
    require(mixed["cache_hit_rate"] < 1 and mixed["staleness_age_max"] >= 1,
            f"the mixed workload served no stale query: {mixed}")

    # the incremental halo against a full exchange; the logits after
    # refresh() against the plain versions with every layer exchanged live
    d = engine.data
    check_bits("halo after churn vs K2 full exchange", engine._halo0,
               engine.full_boundary_exchange())
    engine.refresh()
    require(engine.fully_fresh, "refresh() left the engine stale")

    def plain_exchange(h, idx, mask):
        return halo.halo_gather_plain(h, idx, mask, with_inner=True)

    with torch.inference_mode():
        ref = forward(engine.params, engine.cfg, engine._feat, d.indptr,
                      d.edge_src, d.in_deg,
                      comm_update=lambda i, h: plain_exchange(
                          h, d.send_idx, d.send_mask),
                      spmm_fn=spmm.spmm_mean_plain)
    logits_err = check_close("logits after churn + refresh() vs plain "
                             "recompute", engine.logits, ref, LOGITS_ATOL,
                             LOGITS_RTOL)
    ids = torch.randperm(engine.num_global_nodes,
                         generator=torch.Generator().manual_seed(3))[:4096]
    got = torch.from_numpy(engine.query(ids.numpy()))
    want = ref[torch.from_numpy(engine._q_part[ids.numpy()]).cuda(),
               torch.from_numpy(engine._q_local[ids.numpy()]).cuda()].cpu()
    check_close("queried logits vs plain recompute", got, want, LOGITS_ATOL,
                LOGITS_RTOL)
    del ref

    # K18 at the cell's shapes: the send view, an old halo of random bits
    P, n_max, F = engine._feat.shape
    idx, mask = d.send_idx, d.send_mask
    B = idx.shape[2]
    h = engine._send_view()
    gen = torch.Generator(device="cuda").manual_seed(9)
    old = torch.randint(-2 ** 31, 2 ** 31 - 1, tuple(engine._halo0.shape),
                        generator=gen, device="cuda",
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    times = {}
    for n in (32, 256, 4096, P * n_max):
        dirty = dirty_rows(P, n_max, n, seed=n)
        label = "all" if n == P * n_max else str(n)
        k18_check(f"K18 cell, {label} dirty rows", fresh, h, old, dirty, idx,
                  mask)
        live = live_slots(dirty, idx, mask)
        n_slots = int(live.sum())
        work = old.clone()
        ms = time_ms(lambda: fresh.dirty_exchange(h, work, dirty, idx, mask))
        plain = time_ms(lambda: fresh.dirty_exchange_plain(
            h, work, dirty, idx, mask), reps=5)
        # library yardstick: the dirty bits and rows gathered per slot,
        # merged by one torch.where
        sender = (torch.arange(P, device="cuda")[:, None]
                  - torch.arange(1, P, device="cuda")[None, :]) % P
        dist = torch.arange(P - 1, device="cuda")[None, :]
        gidx = (sender[..., None] * n_max
                + idx[sender, dist].long().clamp(0, n_max - 1)).reshape(-1)
        gmask = mask[sender, dist].reshape(-1)
        flat, dflat = h.reshape(P * n_max, F), dirty.reshape(-1)
        wflat = work.view(-1, F)
        lib = time_ms(lambda: torch.where(
            (dflat[gidx] & gmask)[:, None], flat.index_select(0, gidx),
            wflat))
        n_bytes = P * (P - 1) * B * (4 + 1 + 1) + 2 * n_slots * F * 4
        times[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                            bound=bound_ms(n_bytes, 0), dirty_slots=n_slots,
                            shape=f"P={P} n_max={n_max} B={B} F={F} f32, "
                                  f"{label} dirty rows, {n_slots} dirty "
                                  "slots")
        log(f"  K18 {label} dirty rows ({n_slots} slots): {ms:.4f} ms, "
            f"plain {plain:.3f}, library {lib:.3f}, bound "
            f"{times[label]['bound'][0]:.4f} ms")
        del work, gidx, gmask
    del old
    k18_edge_phase(fresh, halo)
    k2_ms = time_ms(lambda: halo.halo_gather(h, idx, mask, False))
    refresh_ms = time_ms(engine.refresh, reps=5, warmup=1)

    # apply_updates and refresh_boundary of one 32-row churn batch: host
    # clock around the call and a synchronize, 20 batches; then the device
    # time of each (its kernels and copies, torch.profiler), 20 more
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    rng = np.random.default_rng(11)

    def batch():
        return (rng.integers(0, engine.num_global_nodes, 32),
                rng.standard_normal((32, engine.n_feat_raw),
                                    dtype=np.float32))

    host_a, host_b = [], []
    for _ in range(20):
        ids_u, vals = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.apply_updates(ids_u, vals)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.refresh_boundary()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host_a.append((t1 - t0) * 1e3)
        host_b.append((t2 - t1) * 1e3)
    labels = ("apply_updates", "refresh_boundary")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            ids_u, vals = batch()
            with record_function(labels[0]):
                engine.apply_updates(ids_u, vals)
            with record_function(labels[1]):
                engine.refresh_boundary()
        torch.cuda.synchronize()
    update_ms = {}
    for label, host in zip(labels, (host_a, host_b)):
        evs = [e for e in prof.events() if e.name == label
               and e.device_type == DeviceType.CPU]
        dev = sum(e.device_time_total for e in evs) / max(len(evs), 1)
        update_ms[f"{label}_host_ms"] = float(np.median(host))
        # microseconds of the range's kernels and copies; 0 = the
        # profiler saw no device activity: not measured
        update_ms[f"{label}_device_ms"] = dev / 1e3 if dev > 0 else None
    # K18's own kernel time in the same profile: it launches through
    # ctypes, not a torch op, so the profiler ties it to no CPU range and
    # refresh_boundary's device time above counts its torch work only (the
    # dirty bits' copy); the batch's device time is the sum of the two
    k18 = [e.device_time for e in prof.events()
           if e.device_type == DeviceType.CUDA and "dirty_exchange" in e.name]
    update_ms["k18_in_profile_ms"] = (float(np.mean(k18)) / 1e3
                                      if k18 else None)
    log(f"  K2 full exchange {k2_ms:.3f} ms; refresh (use_pp off) "
        f"{refresh_ms:.3f} ms; a 32-row batch: {update_ms}")
    check_bits("halo after the timed batches vs K2 full exchange",
               engine._halo0, engine.full_boundary_exchange())
    del h
    torch.cuda.empty_cache()

    # GCN: its send view pre-scales the rows by 1/sqrt(in_deg)
    gcli = build_parser().parse_args(
        ["--dataset", args.dataset, "--model", "gcn", *FRESH_FLAGS])
    gengine = build_serving_engine(gcli, log=log, sg=sg)
    gcn = fresh_serve(gengine, gcli, 2.0, gcli.serve_update_every, 0.0,
                      seed=5)
    check_bits("GCN halo after churn vs K2 full exchange of its send view",
               gengine._halo0, gengine.full_boundary_exchange())
    del gengine
    torch.cuda.empty_cache()
    stats = {"launches": launches, "engine_build_s": t_engine,
             "quiet": quiet, "churn": churn, "mixed": mixed, "gcn": gcn,
             "peak_mem_gib": peak_gib, "logits_max_abs_err": logits_err,
             "k18": times, "k2_full_exchange_ms": k2_ms,
             "refresh_ms": refresh_ms, **update_ms}
    return stats, engine  # the engine serves [36]'s wire guard


# ---------------------------------------------------------------------------
# phase 6: the training cell (scripts/reddit.sh) through cli/main.py


def counters(spmm, halo):
    """Every kernel wrapper of the port, by kernel name: each counts its
    own launches in ``.launches``."""
    from pipegcn_tpu_torch.ops import block_spmm as blk
    from pipegcn_tpu_torch.ops import bucket_spmm as bs
    from pipegcn_tpu_torch.ops import digest, gat
    from pipegcn_tpu_torch.serve import freshness as fresh

    return {"spmm_mean": spmm.spmm_mean, "halo_gather": halo.halo_gather,
            "spmm_mean_t": spmm.spmm_mean_t,
            "halo_scatter": halo.scatter_bgrad,
            "halo_return": halo.return_blocks,
            "gat_fwd": gat.gat_fwd, "gat_bwd_src": gat.gat_bwd_src,
            "bucket_gather": bs.bucket_gather,
            "transport_cast": bs.transport_cast,
            "part_amax": bs.part_amax,
            "block_dense": blk.block_dense,
            "block_dense_t": blk.block_dense_t,
            "halo_amax": halo.halo_amax, "halo_wire": halo.halo_wire,
            "block_dense_grouped": blk.block_dense_grouped,
            "block_dense_grouped_t": blk.block_dense_grouped_t,
            "dirty_exchange": fresh.dirty_exchange,
            # K19, by form: flat, per part (and distance block), rows
            "digest": digest.digest, "part_digests": digest.part_digests,
            "row_sums": digest.row_sums}


# the kernels each model's training path runs
COMM = ("halo_gather", "halo_scatter", "halo_return")
PATH_KERNELS = {"graphsage": ("spmm_mean", "spmm_mean_t") + COMM,
                "gcn": ("spmm_mean", "spmm_mean_t") + COMM,
                "gat": ("gat_fwd", "gat_bwd_src") + COMM,
                "bucket": ("bucket_gather", "transport_cast") + COMM,
                "block": ("block_dense", "block_dense_t", "bucket_gather",
                          "transport_cast") + COMM,
                # the union-gather tiles and the compressed halo wire: K2
                # runs only in the pp precompute, K5 never
                "wire": ("block_dense_grouped", "block_dense_grouped_t",
                         "bucket_gather", "transport_cast", "halo_amax",
                         "halo_wire", "halo_scatter"),
                # the integrity cell: the SAGE path with the wire lane and
                # the scrub (K19 in all three forms)
                "integrity": ("spmm_mean", "spmm_mean_t") + COMM
                + ("digest", "part_digests", "row_sums")}


def require_launched(launches, model, what):
    missing = [k for k in PATH_KERNELS[model] if launches.get(k, 0) <= 0]
    require(not missing, f"{what}: a kernel of the {model} path was never "
            f"launched: {missing} ({launches})")


def reset_counts(cnt) -> None:
    for fn in cnt.values():
        fn.launches = 0
        for k in getattr(fn, "by_mode", {}):
            fn.by_mode[k] = 0


def read_counts(cnt):
    return {k: fn.launches for k, fn in cnt.items()}


def read_modes(cnt):
    """The launches by row-type mode of the kernels that have modes (K4,
    K6, K8, K12, K13)."""
    return {k: dict(fn.by_mode) for k, fn in cnt.items()
            if hasattr(fn, "by_mode")}


def train_cli(args, pipeline=True, epochs=None, model="graphsage",
              extra=(), dtype="float32"):
    """The cell's command: ``scripts/reddit.sh`` (graphsage, use_pp, metis
    parts: the native partitioner); for gcn and gat the same minus
    ``--use-pp`` (which they refuse), gat with ``--n-heads 4``
    (``scripts/gat_bench.py``'s width); ``dtype`` the compute dtype
    (``--dtype``); ``extra`` flags appended (the bucket cell's)."""
    from pipegcn_tpu_torch.cli.main import build_parser

    argv = ["--dataset", args.dataset, "--dropout", "0.5", "--lr", "0.01",
            "--n-partitions", "2",
            "--n-epochs", str(epochs or args.train_epochs),
            "--model", model, "--n-layers", "4", "--n-hidden", "256",
            "--log-every", "10", "--inductive",
            "--norm", "layer", "--dtype", dtype,
            "--partition-method", "metis", "--fix-seed", "--seed", "0",
            "--device", "cuda"]
    if model == "graphsage":
        argv.append("--use-pp")
    if model == "gat":
        argv += ["--n-heads", "4"]
    return build_parser().parse_args(
        argv + (["--enable-pipeline"] if pipeline else []) + list(extra))


def train_phase(args, g, spmm, halo):
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer, prepare

    cli = train_cli(args)
    steps = {}
    sg, eval_graphs = prepare(cli, log=log, g=g, steps=steps)
    cnt = counters(spmm, halo)
    device = torch.device("cuda", 0)
    reset_counts(cnt)
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    trainer = build_trainer(cli, sg, device, log=log, steps=steps)
    t0 = time.monotonic()
    res = trainer.fit(eval_graphs, log_fn=log, inductive=True)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = read_counts(cnt)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps["eval_graph_csr"] = trainer.eval_setup_s
    losses = res["losses"]
    log(f"  fit: {len(losses)} epochs in {fit_s:.1f}s (eval-graph CSRs "
        f"{trainer.eval_setup_s:.1f}s of it), losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, best val "
        f"{res['best_val']:.4f}, test {res.get('test_acc', float('nan')):.4f},"
        f" launches {launches}, peak {peak_gib:.3f} GiB (held before the "
        f"build {base_gib:.3f} GiB)")
    require(len(losses) == cli.n_epochs, "fit ran the wrong epoch count")
    require(all(math.isfinite(x) for x in losses), f"non-finite loss: "
            f"{losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    require(last < first, f"loss did not fall: first-5 mean {first:.4f}, "
            f"last-5 mean {last:.4f}")
    require_launched(launches, "graphsage", "training run")
    accs = (res["best_val"], res.get("test_acc", float("nan")))
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
            f"accuracies not finite: {accs}")
    stats = {"epochs": len(losses), "losses": losses,
             "first5_mean": first, "last5_mean": last,
             "best_val": res["best_val"], "best_epoch": res["best_epoch"],
             "test_acc": res["test_acc"], "fit_s": fit_s,
             "epoch_time_s_mean": res["epoch_time"],
             "peak_mem_gib": peak_gib, "mem_before_build_gib": base_gib,
             "host_steps_s": steps, "launches": launches}
    return cli, sg, eval_graphs, trainer, stats


# ---------------------------------------------------------------------------
# phase 7: one training step through the kernels vs the plain versions


def rel_err(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def bf16_steps(a, b) -> int:
    """The elements of a bf16 tensor of two runs that differ by more than
    STEP_REL_TOL of its max: the rounding steps."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0
    return int((np.abs(a - b) > STEP_REL_TOL * np.abs(b).max()).sum())


def step_phase(trainer, epoch):
    """One epoch through the kernels, run twice from the same state and
    dropout seed (no kernel uses atomics: the rerun must be bit-identical),
    then once through the plain versions, held against the first within
    the STEP tolerances. The plain run applies the kernel run's relu masks:
    where the two forwards' rounding puts a pre-activation on the other
    side of 0, relu passes or stops that element's whole gradient, a jump
    no tolerance on rounding bounds. Such flips are counted and must stay
    below RELU_FLIP_FRAC of the relu elements. GAT's attention likewise
    takes the kernel run's leaky branch of every edge (from that run's el
    and er, ``ops.gat.LeakyBranch``); its flips must stay below
    LEAKY_FLIP_FRAC of the edge-heads. On the bucket path with a gather
    transport the plain run likewise takes the kernel run's transported
    values (``ops.bucket_spmm.TransportShare``; on the block path the
    remainder's; with a halo wire also its payloads and scales): a cast
    input within
    rounding of a rounding midpoint of the narrow format flips by a whole
    step of it; such transport flips must stay below TRANSPORT_FLIP_FRAC
    of the transported elements."""
    import numpy as np
    import torch
    from pipegcn_tpu_torch.ops import gat
    from pipegcn_tpu_torch.ops.bucket_spmm import TransportShare
    from pipegcn_tpu_torch.tree import tree_leaves

    snap = trainer.host_state()
    masks, flips = [], [0, 0]  # [differing signs, relu elements]
    logit_halves, branches = [], []  # GAT: the kernel run's (el, er)

    def record(h):
        masks.append(h > 0)
        return torch.relu(h)

    def replay(h):
        m = next(replayed)
        flips[0] += int((m != (h > 0)).sum())
        flips[1] += m.numel()
        return torch.where(m, h, h.new_zeros(()))

    def record_attn(z, el, er, *csr, **kw):
        logit_halves.append((el.detach(), er.detach()))
        return gat.gat_attention(z, el, er, *csr, **kw)

    def replay_attn(z, el, er, *csr, **kw):
        branches.append(gat.LeakyBranch(*next(replayed_attn)))
        return gat.gat_attention_plain(z, el, er, *csr,
                                       branch=branches[-1], **kw)

    def run(plain, act, attn=None, share=None):
        trainer.restore_state(snap)
        trainer.plain, trainer.act = plain, act
        trainer.share = share
        if attn is not None:
            trainer.attn = attn
        loss = trainer.train_epoch(epoch)
        return (loss, [g.detach().cpu().numpy() for g in trainer.last_grads],
                trainer.host_state())

    transported = (((trainer.bucket or trainer.block
                     or trainer.gat_transport is not None)
                    and trainer.cfg.rem_dtype is not None)
                   or trainer.tcfg.halo_dtype != "none")
    recorded = TransportShare() if transported else None
    replayed_share = None
    try:
        first = run(False, record, record_attn, recorded)
        rerun = run(False, torch.relu)
        replayed, replayed_attn = iter(masks), iter(logit_halves)
        if transported:
            replayed_share = TransportShare.replaying(recorded.recorded)
        plain = run(True, replay, replay_attn, replayed_share)
        own = run(True, torch.relu)  # on its own masks: shown, not held
    finally:
        trainer.plain, trainer.act, trainer.share = False, torch.relu, None
    del masks[:], logit_halves[:]
    if recorded is not None:
        del recorded.recorded[:]
    tflips = ([replayed_share.flips, replayed_share.elements]
              if replayed_share is not None else [0, 0])
    tflip_frac = tflips[0] / max(tflips[1], 1)
    trainer.restore_state(first[2])
    leaky = [sum(b.flips for b in branches), sum(b.elements for b in branches)]
    leaky_frac = leaky[0] / max(leaky[1], 1)

    def leaves(r):
        return [np.asarray(r[0])] + r[1] + [np.asarray(x) for x in
                                            tree_leaves(r[2])]

    same = all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for a, b in zip(leaves(first), leaves(rerun)))
    (lk, gk, sk), (lp, gp, sp) = first, plain
    loss_err = abs(lk - lp) / abs(lp)
    bf16 = trainer.cfg.dtype == "bfloat16"
    grad_err = max(rel_err(a, b) for a, b in zip(gk, gp))
    param_err = max(rel_err(a, b) for a, b in zip(
        tree_leaves(sk["params"]), tree_leaves(sp["params"])))
    # at bf16 compute the halo and bgrad carries are bf16: the elements a
    # rounding step apart are counted (bf16_steps)
    steps = [0, 0]  # [elements a rounding step apart, carry elements]
    comm_err = {}
    for grp in sk["comm"]:
        for k in sk["comm"][grp]:
            a, b = sk["comm"][grp][k], sp["comm"][grp][k]
            comm_err[f"{grp}.{k}"] = rel_err(a, b)
            if bf16 and grp in ("halo", "bgrad"):
                steps[0] += bf16_steps(a, b)
                steps[1] += np.asarray(b).size
    step_frac = steps[0] / max(steps[1], 1)
    tol = BF16_RTOL if bf16 else STEP_REL_TOL
    flip_frac = flips[0] / max(flips[1], 1)
    own_err = max([rel_err(a, b) for a, b in zip(gk, own[1])]
                  + [rel_err(a, b) for a, b in zip(
                      tree_leaves(sk["comm"]), tree_leaves(own[2]["comm"]))])
    ok = (loss_err <= STEP_LOSS_RTOL and grad_err <= tol
          and param_err <= tol
          and all(v <= tol for v in comm_err.values())
          and all(np.isfinite(g).all() for g in gk)
          and flip_frac <= RELU_FLIP_FRAC and leaky_frac <= LEAKY_FLIP_FRAC
          and tflip_frac <= (BF16_STEP_FRAC if bf16
                             else TRANSPORT_FLIP_FRAC)
          and step_frac <= BF16_STEP_FRAC)
    carries = (f"{max(comm_err.values()):.2e}" if comm_err
               else "none (vanilla)")
    log(f"  step rerun through the kernels (epoch {epoch}): bit-identical "
        f"{'ok' if same else 'FAIL'}")
    require(same, "two runs of one training epoch through the kernels "
            "from the same state differ")
    log(f"  step kernels vs plain (epoch {epoch}): loss {lk:.6f} vs "
        f"{lp:.6f} (rel {loss_err:.2e}, tol {STEP_LOSS_RTOL:g}); grads "
        f"{grad_err:.2e}, params {param_err:.2e}, carries {carries} (tol "
        f"{tol:g} of each tensor's max); relu flips {flips[0]} of "
        f"{flips[1]} (tol {RELU_FLIP_FRAC:g}); leaky flips {leaky[0]} of "
        f"{leaky[1]} (tol {LEAKY_FLIP_FRAC:g}); transport flips {tflips[0]} "
        f"of {tflips[1]} (tol "
        f"{BF16_STEP_FRAC if bf16 else TRANSPORT_FLIP_FRAC:g})"
        + (f"; bf16 carries a rounding step apart {steps[0]} of {steps[1]}"
           f" (tol {BF16_STEP_FRAC:g})" if bf16 else "")
        + f" {'ok' if ok else 'FAIL'}; "
        f"on the plain run's own masks grads and carries {own_err:.2e}")
    require(ok, f"training step through the kernels disagrees with the "
            f"plain versions: loss {loss_err}, grads {grad_err}, params "
            f"{param_err}, carries {comm_err}, relu flips {flips}, leaky "
            f"flips {leaky}, transport flips {tflips}, bf16 steps {steps}")
    return {"loss_kernel": lk, "loss_plain": lp, "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "param_rel_err": param_err,
            "carry_rel_err": comm_err, "relu_flips": flips[0],
            "relu_elements": flips[1], "leaky_flips": leaky[0],
            "leaky_elements": leaky[1], "transport_flips": tflips[0],
            "transported_elements": tflips[1], "rerun_bit_identical": same,
            "own_masks_rel_err": own_err, "dtype": trainer.cfg.dtype,
            "bf16_carry_steps": steps[0], "bf16_carry_elements": steps[1]}


# ---------------------------------------------------------------------------
# phase 8: K3, K4, K5 against their plain versions


def k1_train_phase(trainer, spmm, halo):
    """K1 at the training cell's shape (F = 256, f32 and bf16 rows): the
    slice rule's plan and forced slice plans bit-identical to S = 1, each
    rerun bit-identical."""
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(9)
    h = torch.randn((d.num_parts, d.n_max, 256), generator=gen,
                    device="cuda")
    fbuf = halo.halo_exchange(h, d.send_idx, d.send_mask)
    args = (d.indptr, d.edge_src, d.in_deg)
    k1_slices("K1 training f32 F=256", spmm, fbuf, args,
              ((32, 1), (64, 2)))
    k1_slices("K1 training bf16 F=256", spmm, fbuf.bfloat16(), args,
              ((64, 2), (128, 4)))


def k3_identities(name, spmm, g, it, dt, in_deg):
    """K3 ``torch.equal`` to K1's whole-row kernel over the prescaled
    cotangent g * (1 / in_deg) with in_deg = 1 (the same terms in the same
    order: the parent K3's arithmetic), and a rerun bit-identical. Returns
    K3's result."""
    import torch

    got = spmm.spmm_mean_t(g, it, dt, in_deg)
    require(torch.equal(spmm.spmm_mean_t(g, it, dt, in_deg), got),
            f"{name}: a K3 rerun is not bit-identical")
    x, ip, d, dg = (t if t.dim() == n else t[None] for t, n in (
        (g, 3), (it, 2), (dt, 2), (in_deg, 2)))
    gp = (x * torch.reciprocal(dg)[..., None]).contiguous()
    one = torch.ones((ip.shape[0], ip.shape[-1] - 1), device=g.device)
    k1 = spmm.k1_launch(gp, ip, d, one, plan=(g.shape[-1], 0))
    require(torch.equal(k1.reshape(got.shape), got),
            f"{name}: K3 is not K1's whole-row kernel over g / in_deg")
    log(f"  {name}: K3 bit-identical on a rerun and to K1's whole-row "
        f"kernel over g / in_deg")
    return got


def k3_phase(trainer, spmm):
    import numpy as np
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(6)
    P, n_max, H = d.num_parts, d.n_max, d.halo_size
    it, dt = d.transpose
    errs = []
    # F = 256 (the hidden layers) and 602 (GCN's layer 0, whose 602-wide
    # input takes K3 in the backward)
    for F in (256, 602):
        g = torch.randn((P, n_max, F), generator=gen, device="cuda")
        got = k3_identities(f"K3 f32 F={F} (cell)", spmm, g, it, dt,
                            d.in_deg)
        errs.append(check_close(
            f"K3 f32 F={F} (cell)", got,
            spmm.spmm_mean_t_plain(g, it, dt, d.in_deg), K3_ATOL, K3_RTOL,
            abs_sum=spmm.spmm_mean_t_plain(g.abs(), it, dt, d.in_deg)))
        del g, got
    # SpmmMean's backward (K3) for f32 and bf16 fbuf: d_fbuf in fbuf's
    # dtype; bf16 rounds the f32 sums once, so one bf16 ulp apart at most
    w = torch.randn((P, n_max, 256), generator=gen, device="cuda")
    fb32 = torch.randn((P, n_max + H, 256), generator=gen, device="cuda")
    w_abs = spmm.spmm_mean_t_plain(w.abs(), it, dt, d.in_deg)
    for dtp, atol, rtol in ((torch.float32, K3_ATOL, K3_RTOL),
                            (torch.bfloat16, 1e-6, 2.0 ** -7)):
        grads = []
        for fn in (spmm.spmm_mean, spmm.spmm_mean_plain):
            x = fb32.to(dtp).clone().requires_grad_(True)
            (fn(x, d.indptr, d.edge_src, d.in_deg, d.transpose)
             * w).sum().backward()
            grads.append(x.grad)
        require(grads[0].dtype == dtp, "SpmmMean: d_fbuf dtype")
        errs.append(check_close(f"SpmmMean backward {dtp} (cell)",
                                grads[0].float(), grads[1].float(), atol,
                                rtol, abs_sum=w_abs))
    # edge cases: sources with no edges (exact zero rows), a 5000-edge
    # source, n_src not a multiple of a CTA's rows (700) and F not one of
    # its column slice (1, 3, 41, 602), pad edges dropped, junk past
    # indptr_t[n_src] never read, int64 row pointers
    rng = np.random.default_rng(7)
    n_out, n_src = 300, 700
    deg = rng.integers(0, 80, n_out)
    dst = np.repeat(np.arange(n_out), deg)
    src_np = rng.integers(0, n_src, dst.size)
    src_np[rng.random(dst.size) < 0.45] = 5  # a ~5000-edge source row
    src_np[np.isin(src_np, np.arange(100, 160))] = 0  # empty rows
    pad = 37
    edge_dst = np.concatenate([dst, np.full(pad, n_out)])
    edge_src = np.concatenate([src_np, np.zeros(pad, np.int64)])
    ip_np, dt_np = spmm.csr_transpose(edge_src, edge_dst, n_out, n_src)
    it = torch.from_numpy(ip_np).cuda()
    dtt = torch.from_numpy(dt_np).cuda()
    in_deg = torch.from_numpy(rng.uniform(1, 50, n_out).astype(
        np.float32)).cuda()
    require(int(np.diff(ip_np)[5]) > 3000, "K3 edge case lost its heavy row")
    for F in (1, 3, 16, 41, 256, 602):
        g = torch.randn((n_out, F), generator=gen, device="cuda")
        got = k3_identities(f"K3 edge cases F={F}", spmm, g, it, dtt,
                            in_deg)
        errs.append(check_close(f"K3 edge cases F={F}", got,
                                spmm.spmm_mean_t_plain(g, it, dtt, in_deg),
                                K3_ATOL, K3_RTOL, abs_sum=spmm.spmm_mean_t_plain(
                                    g.abs(), it, dtt, in_deg)))
        require(bool((got[100:160] == 0).all()),
                "K3: sources without edges must be exactly zero")
        require(torch.equal(spmm.spmm_mean_t(g, it.long(), dtt, in_deg),
                            got),
                f"K3 int64 indptr_t F={F}: not bit-identical to int32")
    junk = dtt.clone()
    junk[dst.size:] = n_out - 1
    g = torch.randn((n_out, 16), generator=gen, device="cuda")
    require(torch.equal(spmm.spmm_mean_t(g, it, junk, in_deg),
                        spmm.spmm_mean_t(g, it, dtt, in_deg)),
            "K3 read an edge past indptr_t[n_src]")
    errs.append(check_close("K3 int64 indptr_t", spmm.spmm_mean_t(
        g, it.long(), dtt, in_deg), spmm.spmm_mean_t_plain(
        g, it, dtt, in_deg), K3_ATOL, K3_RTOL,
        abs_sum=spmm.spmm_mean_t_plain(g.abs(), it, dtt, in_deg)))
    return max(errs)


def index_add_ref(g, bgrad, send_idx, send_mask):
    """d_h from the send lists themselves, independent of the inverse CSR:
    one masked ``index_add_`` per part (the library yardstick's call)."""
    import torch

    out = g.clone(memory_format=torch.contiguous_format)
    P, F = g.shape[0], g.shape[2]
    for p in range(P):
        m = send_mask[p].reshape(-1)
        out[p].index_add_(0, send_idx[p].reshape(-1)[m].long(),
                          bgrad[p].reshape(-1, F)[m])
    return out


def k4_phase(trainer, halo):
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(8)
    P, n_max, H = d.num_parts, d.n_max, d.halo_size
    errs = []
    # P = 2 at the cell's shape, g a view of a [P, n_max + H, F] cotangent
    # as the backward hands it: at most one slot per row, bit-exact, and
    # equal to the index_add_ over the send lists (the CSR is right)
    full = torch.randn((P, n_max + H, 256), generator=gen, device="cuda")
    bg = torch.randn((P, H, 256), generator=gen, device="cuda")
    got = halo.scatter_bgrad(full[:, :n_max], bg, *d.inverse)
    errs.append(check_bits("K4 P=2 F=256 (cell)", got,
                           halo.scatter_bgrad_plain(full[:, :n_max], bg,
                                                    *d.inverse)))
    check_bits("K4 P=2 F=256 (cell) vs index_add_ over the send lists", got,
               index_add_ref(full[:, :n_max], bg, d.send_idx, d.send_mask))
    # P = 4, rows repeated across distances, masked-off slots, odd widths
    for F in (3, 256):
        P4, n4, B4 = 4, 64, 40
        idx = torch.stack([torch.stack([
            torch.randperm(n4, generator=gen, device="cuda")[:B4]
            for _ in range(P4 - 1)]) for _ in range(P4)]).int()
        mask = torch.rand((P4, P4 - 1, B4), generator=gen,
                          device="cuda") < 0.8
        ptr, slot = halo.send_csr(idx.cpu().numpy(), mask.cpu().numpy(), n4)
        ptr, slot = torch.from_numpy(ptr).cuda(), torch.from_numpy(slot).cuda()
        require(int(ptr.diff(dim=1).max()) > 1, "K4 case has no repeats")
        g = torch.randn((P4, n4, F), generator=gen, device="cuda")
        b = torch.randn((P4, (P4 - 1) * B4, F), generator=gen,
                        device="cuda")
        got = halo.scatter_bgrad(g, b, ptr, slot)
        errs.append(check_close(f"K4 P=4 F={F} (repeated rows)", got,
                                halo.scatter_bgrad_plain(g, b, ptr, slot),
                                K4_ATOL, K4_RTOL))
        check_close(f"K4 P=4 F={F} vs index_add_ over the send lists", got,
                    index_add_ref(g, b, idx, mask), K4_ATOL, K4_RTOL)
    return max(errs)


def k5_phase(trainer, halo):
    """K5 bit-exact against its plain version: the cell's strided view
    (P = 2, F = 256); P = 3 and 4 (blocks from different senders), F =
    3 / 7 / 41 / 256 / 602 (rows of no 16-byte multiple), f32 and bf16
    rows with a NaN and a -0.0, each a strided view whose part stride is
    no multiple of 16 bytes, and H = 0. A kernel fed one block from the
    wrong sender must fail the check."""
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(9)
    P, n_max, H = d.num_parts, d.n_max, d.halo_size
    full = torch.randn((P, n_max + H, 256), generator=gen, device="cuda")
    check_bits("K5 P=2 F=256 (cell, strided view)",
               halo.return_blocks(full[:, n_max:], d.b_max),
               halo.return_blocks_plain(full[:, n_max:], d.b_max))
    del full
    for P, B, F, dt in ((3, 20, 7, torch.float32),
                        (4, 9, 3, torch.bfloat16),
                        (4, 16, 256, torch.float32),
                        (3, 700, 41, torch.float32),
                        (4, 333, 41, torch.bfloat16),
                        (3, 257, 602, torch.float32),
                        (4, 129, 602, torch.bfloat16),
                        (2, 1001, 256, torch.bfloat16),
                        (3, 0, 64, torch.float32)):
        x = torch.randn((P, (P - 1) * B + 5, F), generator=gen,
                        device="cuda").to(dt)
        x[0, 0, 0] = float("nan")
        x[1, min(1, x.shape[1] - 1), 0] = -0.0
        v = x[:, 5:]
        check_bits(f"K5 P={P} B={B} F={F} {t_dtype(x)} (strided view, part "
                   f"stride {x.stride(0) * x.element_size()} B)",
                   halo.return_blocks(v, B), halo.return_blocks_plain(v, B))
    # one block from the wrong sender: receiver 0's distance-1 block
    # (sender 1) replaced in the kernel's input by sender 2's
    P, B = 3, 40
    v = torch.randn((P, (P - 1) * B, 41), generator=gen, device="cuda")
    bad = v.clone()
    bad[1, :B] = v[2, :B]
    got = halo.return_blocks(bad, B)
    ref = halo.return_blocks_plain(v, B)
    must_fail("K5 planted fault (one block from the wrong sender)",
              lambda: check_bits("K5 planted fault", got, ref))
    return 0.0


# ---------------------------------------------------------------------------
# phase 9: timings of K3-K5, the epoch and its split


def train_timings(trainer, spmm, halo, cnt):
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(10)
    P, n_max, H, B = d.num_parts, d.n_max, d.halo_size, d.b_max
    n_src = n_max + H
    F = 256
    it, dt = d.transpose
    edges = [int(it[p, -1]) for p in range(P)]
    n_edges = sum(edges)
    out = {}

    # --- K3 ------------------------------------------------------------
    g = torch.randn((P, n_max, F), generator=gen, device="cuda")
    k3 = time_ms(lambda: spmm.spmm_mean_t(g, it, dt, d.in_deg))
    # K1's whole-row kernel over the prescaled cotangent: the parent K3's
    # arithmetic and access pattern (one warp a row, every edge's whole
    # row gathered), in the same run
    gp = g * torch.reciprocal(d.in_deg)[..., None]
    one = torch.ones((P, n_src), device="cuda")
    k1_whole = time_ms(lambda: spmm.k1_launch(gp, it, dt, one,
                                              plan=(F, 0)))
    del gp, one
    k3_plain = time_ms(lambda: spmm.spmm_mean_t_plain(g, it, dt, d.in_deg),
                       reps=5)
    # library yardstick: one cuSPARSE CSR SpMM with the block-diagonal
    # transpose of both parts, values 1/in_deg[dst]
    crow = torch.cat([it[0].long()] + [
        it[p, 1:].long() + sum(edges[:p]) for p in range(1, P)])
    col = torch.cat([dt[p, :edges[p]].long() + p * n_max for p in range(P)])
    val = torch.cat([torch.reciprocal(d.in_deg[p]).index_select(
        0, dt[p, :edges[p]].long()) for p in range(P)])
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(crow, col, val,
                                    size=(P * n_src, P * n_max))
    dense = g.reshape(P * n_max, F)
    k3_lib = time_ms(lambda: torch.sparse.mm(a, dense))
    del a, crow, col, val
    k3_bytes = (g.numel() * 4 + n_edges * 4 + it.numel() * it.element_size()
                + d.in_deg.numel() * 4 + P * n_src * F * 4)
    # g[dst] / in_deg[dst] depends on dst alone: the function needs one
    # scaling per output element of g and one add per edge and element
    # (K3 multiplies per edge: work the bound does not count)
    k3_ops = n_edges * F + P * n_max * F
    out["K3"] = dict(ms=k3, plain_ms=k3_plain, library_ms=k3_lib,
                     bound=bound_ms(k3_bytes, k3_ops),
                     k1_whole_row_ms=k1_whole,
                     shape=f"P={P} n_out={n_max} n_src={n_src} F={F} "
                           f"edges={n_edges} f32")
    log(f"  K3: {k3:.3f} ms, K1's whole-row kernel over g / deg "
        f"{k1_whole:.3f}, torch.sparse.mm {k3_lib:.3f}, bound "
        f"{out['K3']['bound'][0]:.3f}")

    # --- K4 ------------------------------------------------------------
    full = torch.randn((P, n_src, F), generator=gen, device="cuda")
    gi = full[:, :n_max]
    bg = torch.randn((P, H, F), generator=gen, device="cuda")
    ptr, slot = d.inverse
    k4 = time_ms(lambda: halo.scatter_bgrad(gi, bg, ptr, slot))
    k4_plain = time_ms(lambda: halo.scatter_bgrad_plain(gi, bg, ptr, slot),
                       reps=5)
    # library yardstick: one index_add over the flattened parts, given the
    # inner rows contiguous and the masked slots' bgrad rows compacted
    m = d.send_mask.reshape(P, -1)
    rows = torch.cat([d.send_idx[p].reshape(-1)[m[p]].long() + p * n_max
                      for p in range(P)])
    vals = torch.cat([bg[p][m[p]] for p in range(P)])
    gflat = gi.contiguous().reshape(P * n_max, F)
    k4_lib = time_ms(lambda: torch.index_add(gflat, 0, rows, vals))
    nnz = int(rows.numel())
    k4_bytes = (2 * P * n_max * F * 4 + nnz * F * 4 + ptr.numel() * 4
                + nnz * 4)
    out["K4"] = dict(ms=k4, plain_ms=k4_plain, library_ms=k4_lib,
                     bound=bound_ms(k4_bytes, nnz * F),
                     shape=f"P={P} n_max={n_max} H={H} nnz={nnz} F={F} f32")
    del vals, gflat

    # --- K5 ------------------------------------------------------------
    gh = full[:, n_max:]
    k5 = time_ms(lambda: halo.return_blocks(gh, B))
    k5_plain = time_ms(lambda: halo.return_blocks_plain(gh, B), reps=5)
    # library yardstick: one index_select of every output row from the
    # flattened (contiguous) halo blocks
    r = torch.arange(P, device="cuda")[:, None]
    k = torch.arange(H, device="cuda")[None, :]
    ridx = (((r + k // B + 1) % P) * H + k).reshape(-1)
    ghc = gh.contiguous().reshape(P * H, F)
    k5_lib = time_ms(lambda: ghc.index_select(0, ridx))
    # the card's copy floor: a device-to-device copy_ of the same blocks,
    # unpermuted, from the same strided view (PyTorch's strided copy) and
    # from a contiguous copy of them (the same bytes in one flat run)
    dst = torch.empty((P, H, F), device="cuda")
    ghv = ghc.view(P, H, F)
    out["K5"] = dict(ms=k5, plain_ms=k5_plain, library_ms=k5_lib,
                     bound=bound_ms(2 * P * H * F * 4, 0),
                     # 20 calls back to back: the card's time a call,
                     # without the wrapper's host work that an event pair
                     # around one call on an idle card also counts
                     batched_ms=batched_ms(lambda: halo.return_blocks(gh, B)),
                     library_batched_ms=batched_ms(
                         lambda: ghc.index_select(0, ridx)),
                     copy_ms=time_ms(lambda: dst.copy_(gh)),
                     copy_batched_ms=batched_ms(lambda: dst.copy_(gh)),
                     copy_contig_ms=time_ms(lambda: dst.copy_(ghv)),
                     copy_contig_batched_ms=batched_ms(
                         lambda: dst.copy_(ghv)),
                     shape=f"P={P} H={H} B={B} F={F} f32")
    e = out["K5"]
    log(f"  K5: {k5:.4f} ms a call ({e['batched_ms']:.4f} back to back), "
        f"index_select {k5_lib:.4f} ({e['library_batched_ms']:.4f}), "
        f"copy_ of the strided blocks {e['copy_ms']:.4f} "
        f"({e['copy_batched_ms']:.4f}), of contiguous ones "
        f"{e['copy_contig_ms']:.4f} ({e['copy_contig_batched_ms']:.4f}), "
        f"bound {e['bound'][0]:.4f} ms, plain {k5_plain:.4f}")
    del ghc, ghv, gh, gi, bg, full, dst

    # --- K1 and K2 at the epoch's shapes, and the epoch ----------------
    out.update(k1_k2_timings(d, spmm, halo, with_inner=False, seed=11))
    reset_counts(cnt)
    base = trainer.tcfg.n_epochs + 10
    epochs = iter(range(base, base + 100))
    reps = 5
    out["epoch_ms"] = time_ms(lambda: trainer.train_epoch(next(epochs)),
                              reps=reps, warmup=1)
    per_epoch = {kk: v / (reps + 1) for kk, v in read_counts(cnt).items()}
    kernel_ms = (per_epoch["spmm_mean"] * out["K1"]["ms"]
                 + per_epoch["spmm_mean_t"] * k3
                 + per_epoch["halo_gather"] * out["K2"]["ms"]
                 + per_epoch["halo_scatter"] * k4
                 + per_epoch["halo_return"] * k5)
    out["launches_per_epoch"] = per_epoch
    out["epoch_kernel_ms"] = kernel_ms
    out["epoch_rest_ms"] = out["epoch_ms"] - kernel_ms
    log(f"  epoch {out['epoch_ms']:.3f} ms median: kernels "
        f"{kernel_ms:.3f} ms ({per_epoch}), rest "
        f"{out['epoch_rest_ms']:.3f} ms")
    return out


def vanilla_phase(args, sg, spmm, halo):
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer

    cli = train_cli(args, pipeline=False, epochs=3)
    cnt = counters(spmm, halo)
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log)
    reset_counts(cnt)
    losses = [trainer.train_epoch(e) for e in range(3)]
    launches = read_counts(cnt)
    log(f"  vanilla: losses {losses}, launches {launches}")
    require(all(math.isfinite(x) for x in losses), "vanilla: non-finite loss")
    require_launched(launches, "graphsage", "vanilla")
    # the differentiable exchange's backward (K5 then K4) through the
    # kernels against the plain versions, one epoch from the same state
    step = step_phase(trainer, 3)
    return {"losses": losses, "launches": launches, "step_check": step}


# ---------------------------------------------------------------------------
# phases 10-14: the GAT and GCN cells, K6 and K8


def gat_gamma(deg, extra=0):
    """The per-row factor of the sum term: GAT_SUM_C * sqrt(n) * u for a
    row of n terms, at least SUM_RTOL."""
    import torch

    return torch.clamp(GAT_SUM_C * torch.sqrt(deg.double() + extra) * F32_U,
                       min=SUM_RTOL)


def k6_checks(name, got, ref, abs_ref, deg):
    """K6's (out, m, s, n_neg, w_neg) against the plain version's: m
    bit-exact, the rest within GAT_ATOL + GAT_RTOL * |ref| + gamma_n *
    (the sum of the terms' magnitudes: the plain pass on |z|; s and
    w_neg sum positive terms, their own value)."""
    import torch

    out, m, s, n_neg, w_neg = got
    require(torch.equal(m, ref[1]), f"K6 {name}: the row max m differs "
            "from the plain version's")
    gi = gat_gamma(deg)
    return max(
        check_close(f"K6 {name}: s", s, ref[2], GAT_ATOL, GAT_RTOL,
                    abs_sum=ref[2], sum_rtol=gi[..., None]),
        check_close(f"K6 {name}: out", out, ref[0], GAT_ATOL, GAT_RTOL,
                    abs_sum=abs_ref[0], sum_rtol=gi[..., None, None]),
        check_close(f"K6 {name}: w_neg", w_neg, ref[4], GAT_ATOL, GAT_RTOL,
                    abs_sum=ref[4], sum_rtol=gi[..., None]),
        check_close(f"K6 {name}: n_neg", n_neg, ref[3], GAT_ATOL, GAT_RTOL,
                    abs_sum=abs_ref[3], sum_rtol=gi[..., None, None]))


# the worst K8 error seen in this run as a multiple of sqrt(n) u sum|terms|
# (GAT_SUM_C's unit), over the elements whose sum term is at least
# GAT_ATOL (where the absolute floor does not set the bound)
K8_WORST = {"c": 0.0, "where": None}


def k8_worst_c(name, got, ref, abs_sum, n):
    """Record the largest |got - ref| / (sqrt(n) u abs_sum) of one K8
    output in K8_WORST (n the terms of each element's sum)."""
    import torch

    unit = torch.sqrt(n.double()) * F32_U * abs_sum.double()
    live = unit >= GAT_ATOL
    if not bool(live.any()):
        return
    c = float(((got.double() - ref.double()).abs() / unit)[live].max())
    if c > K8_WORST["c"]:
        K8_WORST.update(c=c, where=name)


def k8_checks(name, got, ref, abs_ref, deg_t, dh):
    """K8's (d_z, d_el) against the plain version's, as k6_checks (the
    magnitudes from the plain pass on |z|, |g| and -|rho|; d_el's dot
    product adds dh terms); each output's error in GAT_SUM_C's unit goes
    into K8_WORST."""
    k8_worst_c(f"K8 {name}: d_z", got[0], ref[0], abs_ref[0],
               deg_t[..., None, None].expand_as(ref[0]))
    k8_worst_c(f"K8 {name}: d_el", got[1], ref[1], abs_ref[1],
               (deg_t + dh)[..., None].expand_as(ref[1]))
    return max(
        check_close(f"K8 {name}: d_z", got[0], ref[0], GAT_ATOL, GAT_RTOL,
                    abs_sum=abs_ref[0],
                    sum_rtol=gat_gamma(deg_t)[..., None, None]),
        check_close(f"K8 {name}: d_el", got[1], ref[1], GAT_ATOL, GAT_RTOL,
                    abs_sum=abs_ref[1],
                    sum_rtol=gat_gamma(deg_t, dh)[..., None]))


# the row types of K6 / K8: (z, g) dtypes by mode
def gat_modes():
    import torch

    return {"f32": (torch.float32, torch.float32),
            "bf16": (torch.bfloat16, torch.bfloat16),
            "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


def narrow(x, dt):
    """``x`` [P, rows, H, dh] f32 in the row type ``dt`` (K10's plain
    cast: fp8 saturates, bf16 rounds)."""
    import torch
    from pipegcn_tpu_torch.ops import bucket_spmm as bs

    if dt == torch.float32:
        return x
    P, rows = x.shape[:2]
    return bs.transport_cast_plain(x.reshape(P, rows, -1).contiguous(),
                                   dt)[0].view(x.shape)


def gat_check(name, gat, z, el, er, indptr, src, transpose, slope=0.2,
              seed=0, mode="f32"):
    """K6 (both modes) and K8 against their plain versions on one input
    (k6_checks, k8_checks), and pass A's d_er from K6's NEG outputs
    against d_er from the plain version's; the NEG mode leaves m and s bit
    for bit (its out may sum each leaky branch apart, so the eval mode's
    out is held to the plain version on its own); each kernel rerun
    bit-identical. ``mode`` picks the row
    types (``gat_modes``): z and the cotangent g are cast to them, and
    both sides read the same narrow rows (the plain versions widen them).
    Returns the largest error of each kernel (K6 including d_er)."""
    import torch

    it, dt = transpose
    zdt, gdt = gat_modes()[mode]
    z = narrow(z, zdt)
    P, R, H, dh = z.shape
    n = er.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    deg = indptr.diff(dim=1)
    name = f"{name} [{mode}]"
    got = gat.gat_fwd(z, el, er, indptr, src, slope, neg=True)
    ev = gat.gat_fwd(z, el, er, indptr, src, slope)
    require(all(torch.equal(a, b) for a, b in zip(ev[1:], got[1:3])),
            f"K6 {name}: the NEG mode changes m or s")
    ref = gat.gat_fwd_plain(z, el, er, indptr, src, slope, neg=True)
    abs_ref = gat.gat_fwd_plain(z.float().abs(), el, er, indptr, src,
                                slope, neg=True)
    e6 = max(k6_checks(name, got, ref, abs_ref, deg), check_close(
        f"K6 {name}: out (eval mode)", ev[0], ref[0], GAT_ATOL, GAT_RTOL,
        abs_sum=abs_ref[0], sum_rtol=gat_gamma(deg)[..., None, None]))
    g = torch.randn((P, n, H, dh), generator=gen, device="cuda")
    rho = (g * ref[0]).sum(-1)
    d_er = gat.gat_d_er(g, rho, got[3], got[4], slope)
    e6 = max(e6, check_close(
        f"pass A {name}: d_er from K6's n_neg, w_neg", d_er,
        gat.gat_d_er(g, rho, ref[3], ref[4], slope), GAT_ATOL, GAT_RTOL,
        abs_sum=(1 - slope) * (rho.abs() * ref[4]
                               + (g.abs() * abs_ref[3]).sum(-1)),
        sum_rtol=gat_gamma(deg, dh)[..., None]))
    gq = narrow(g, gdt)
    stats = (ref[1], ref[2], gq, rho)
    abs_stats = (ref[1], ref[2], gq.float().abs(), -rho.abs())
    d_src = gat.gat_bwd_src(z, el, er, *stats, it, dt, slope)
    e8 = k8_checks(name, d_src,
                   gat.gat_bwd_src_plain(z, el, er, *stats, it, dt, slope),
                   gat.gat_bwd_src_plain(z.float().abs(), el, er,
                                         *abs_stats, it, dt, slope),
                   it.diff(dim=1), dh)
    again = (*gat.gat_fwd(z, el, er, indptr, src, slope, neg=True),
             *gat.gat_fwd(z, el, er, indptr, src, slope),
             *gat.gat_bwd_src(z, el, er, *stats, it, dt, slope))
    require(all(torch.equal(a, b) for a, b in zip(again, (*got, *ev,
                                                          *d_src))),
            f"K6/K8 {name}: a rerun is not bit-identical")
    return {"K6": e6, "K8": e8}


def must_fail(name, check) -> None:
    """``check()`` must raise Failed: a planted fault has to show."""
    try:
        check()
    except Failed:
        log(f"  {name}: fails the check, as it must")
        return
    raise Failed(f"{name}: a planted fault passed the check")


def gat_fault_phase(gat, slope=0.2, mode="f32"):
    """The K6 / K8 checks catch a kernel that drops one edge: K6 and K8
    run on the edge-case CSR less one edge of the 5,000-edge row (the
    edge whose weights are nearest the row's mean, from a light source)
    and are held, with the checks' own tolerances, against the plain
    versions on the whole CSR. Each of K6's s and out and K8's d_z must
    fail, in the row types of ``mode``."""
    import numpy as np
    import torch
    from pipegcn_tpu_torch.ops.spmm import csr_indptr, csr_transpose

    P, n, R, H, dh = 2, 300, 700, 4, 64
    indptr, src, (it, dt) = gat_edge_graph(P, n, R, seed=P * 100 + dh)
    gen = torch.Generator(device="cuda").manual_seed(17)
    zdt, gdt = gat_modes()[mode]
    z = narrow(torch.randn((P, R, H, dh), generator=gen, device="cuda"),
               zdt)
    el = torch.randn((P, R, H), generator=gen, device="cuda")
    er = torch.randn((P, n, H), generator=gen, device="cuda")
    beg, end = int(indptr[0, 5]), int(indptr[0, 6])
    require(end - beg == 5000, "fault case lost its 5,000-edge row")
    srcs = src[0, beg:end].long()
    lp = el[0, srcs] + er[0, 5]
    w = torch.exp(torch.where(lp > 0, lp, slope * lp))
    w = w / w.max(0).values
    light = torch.bincount(src[0, :int(indptr[0, -1])].long(),
                           minlength=R)[srcs] < 40
    score = (w - w.mean(0)).abs().sum(1).masked_fill(~light, float("inf"))
    j = beg + int(score.argmin())
    # the CSR less edge j: row 5 one edge shorter, the index list shifted
    # left (its tail is pad, never read)
    src_np, ip_np = src.cpu().numpy().copy(), indptr.cpu().numpy()
    src_np[0, j:-1] = src_np[0, j + 1:].copy()
    ip_np = ip_np.copy()
    ip_np[0, 6:] -= 1
    dst_np = np.full(src_np.shape, n, np.int32)
    for p in range(P):
        dst_np[p, :ip_np[p, -1]] = np.repeat(np.arange(n), np.diff(ip_np[p]))
    require(np.array_equal(csr_indptr(dst_np, n), ip_np), "fault CSR")
    f_it, f_dt = (torch.from_numpy(x).cuda()
                  for x in csr_transpose(src_np, dst_np, n, R))
    f_ip, f_src = torch.from_numpy(ip_np).cuda(), torch.from_numpy(
        src_np).cuda()
    deg = indptr.diff(dim=1)
    got = gat.gat_fwd(z, el, er, f_ip, f_src, slope, neg=True)
    ref = gat.gat_fwd_plain(z, el, er, indptr, src, slope, neg=True)
    abs_ref = gat.gat_fwd_plain(z.float().abs(), el, er, indptr, src,
                                slope, neg=True)
    # each check alone: the fault must fail each of them
    gi = gat_gamma(deg)
    name = f"planted fault [{mode}] (one edge of the 5,000-edge row dropped)"
    must_fail(f"K6 {name}: s", lambda: check_close(
        f"K6 {name}: s", got[2], ref[2], GAT_ATOL, GAT_RTOL,
        abs_sum=ref[2], sum_rtol=gi[..., None]))
    must_fail(f"K6 {name}: out", lambda: check_close(
        f"K6 {name}: out", got[0], ref[0], GAT_ATOL, GAT_RTOL,
        abs_sum=abs_ref[0], sum_rtol=gi[..., None, None]))
    g = torch.randn((P, n, H, dh), generator=gen, device="cuda")
    rho = (g * ref[0]).sum(-1)
    gq = narrow(g, gdt)
    stats = (ref[1], ref[2], gq, rho)
    abs_stats = (ref[1], ref[2], gq.float().abs(), -rho.abs())
    d_z = gat.gat_bwd_src(z, el, er, *stats, f_it, f_dt, slope)[0]
    must_fail(f"K8 {name}: d_z", lambda: check_close(
        f"K8 {name}: d_z", d_z,
        gat.gat_bwd_src_plain(z, el, er, *stats, it, dt, slope)[0],
        GAT_ATOL, GAT_RTOL,
        abs_sum=gat.gat_bwd_src_plain(z.float().abs(), el, er, *abs_stats,
                                      it, dt, slope)[0],
        sum_rtol=gat_gamma(it.diff(dim=1))[..., None, None]))


def edge_case_edges(P, n, R, seed):
    """Sentinel-padded, dst-sorted edge lists ``(src, dst)`` ``[P, E]`` of
    P random parts with n destination and R source rows: empty rows, a
    5,000-in-edge row (row 5), a ~5,000-out-edge source (row 9) and 37
    pad edges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(P):
        deg = rng.integers(0, 40, n)
        deg[::7] = 0
        deg[5] = 5000
        dst = np.repeat(np.arange(n), deg)
        src = rng.integers(0, R, dst.size)
        src[rng.random(dst.size) < 0.3] = 9  # a heavy source row
        parts.append((src, dst))
    e_max = max(d.size for _, d in parts) + 37
    src = np.zeros((P, e_max), np.int32)
    dst = np.full((P, e_max), n, np.int32)
    for p, (a, b) in enumerate(parts):
        src[p, :a.size], dst[p, :b.size] = a, b
    return src, dst


def gat_edge_graph(P, n, R, seed):
    """Stacked destination and transpose CSRs of ``edge_case_edges`` (pad
    edges, whose src / dst_t tail holds junk the kernels must not read)."""
    import torch
    from pipegcn_tpu_torch.ops.spmm import csr_indptr, csr_transpose

    src, dst = edge_case_edges(P, n, R, seed)
    it, dt = csr_transpose(src, dst, n, R)
    return (torch.from_numpy(csr_indptr(dst, n)).cuda(),
            torch.from_numpy(src).cuda(),
            (torch.from_numpy(it).cuda(), torch.from_numpy(dt).cuda()))


def gat_narrow_edge_phase(gat, mode):
    """K6 and K8 in the narrow row types of ``mode`` on edge cases: empty
    rows, the 5,000-edge row, dh = 64 and the logits layer's 41 (F = 164:
    chunks of 4 elements straddle two heads), dh = 5 with H = 8; and rows
    whose base is not aligned to a vector (a tensor starting one element
    into its storage: the kernels take one element at a time there), whose
    results must equal the aligned ones bit for bit (K8's d_el within the
    GAT tolerance: its dot products group the products by chunk)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(22)
    zdt, gdt = gat_modes()[mode]
    errs = []
    n, R = 300, 700
    for P, H, dh in ((2, 4, 64), (2, 4, 41), (2, 8, 5)):
        indptr, src, tr = gat_edge_graph(P, n, R, seed=P * 100 + dh)
        z = torch.randn((P, R, H, dh), generator=gen, device="cuda")
        el = torch.randn((P, R, H), generator=gen, device="cuda")
        er = torch.randn((P, n, H), generator=gen, device="cuda")
        name = f"edge cases P={P} H={H} dh={dh}"
        errs.append(gat_check(name, gat, z, el, er, indptr, src, tr,
                              mode=mode))
        zq = narrow(z, zdt)
        zu = torch.empty(zq.numel() + 1, dtype=zdt, device="cuda")[1:]
        zu = zu.view(zq.shape)
        zu.copy_(zq)
        got = gat.gat_fwd(zq, el, er, indptr, src, neg=True)
        require(all(torch.equal(a, b) for a, b in zip(
            gat.gat_fwd(zu, el, er, indptr, src, neg=True), got)),
            f"K6 {name} [{mode}]: unaligned rows differ from aligned ones")
        g = narrow(torch.randn((P, n, H, dh), generator=gen, device="cuda"),
                   gdt)
        gu = torch.empty(g.numel() + 1, dtype=gdt, device="cuda")[1:]
        gu = gu.view(g.shape)
        gu.copy_(g)
        rho = torch.randn((P, n, H), generator=gen, device="cuda")
        a8 = (got[1], got[2])
        du = gat.gat_bwd_src(zu, el, er, *a8, gu, rho, *tr)
        da = gat.gat_bwd_src(zq, el, er, *a8, g, rho, *tr)
        require(torch.equal(du[0], da[0]),
                f"K8 {name} [{mode}]: unaligned rows differ from aligned "
                "ones (d_z)")
        # d_el's dot products add a chunk's products before the head sum
        # where the rows take 4-element loads: another order
        check_close(f"K8 {name} [{mode}] unaligned: d_el", du[1], da[1],
                    GAT_ATOL, GAT_RTOL)
        log(f"  K6 / K8 {name} [{mode}]: unaligned rows: K6 and K8's d_z "
            f"bit-identical ok")
    return {k: max(e[k] for e in errs) for k in ("K6", "K8")}


def gat_edge_phase(gat):
    """K6 and K8 on edge cases: empty rows, a 5,000-edge row, dh = 41 (the
    logits layer: heads straddle 16-byte vectors), dh = 5, H = 1 and
    H = 8, logits all equal, P = 1 and 2, int64 row pointers, junk past
    the CSRs' ends."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    errs = []
    n, R = 300, 700
    for P, H, dh in ((2, 4, 64), (2, 4, 41), (1, 4, 5), (1, 1, 3),
                     (2, 8, 8)):
        indptr, src, tr = gat_edge_graph(P, n, R, seed=P * 100 + dh)
        z = torch.randn((P, R, H, dh), generator=gen, device="cuda")
        el = torch.randn((P, R, H), generator=gen, device="cuda")
        er = torch.randn((P, n, H), generator=gen, device="cuda")
        name = f"edge cases P={P} H={H} dh={dh}"
        errs.append(gat_check(name, gat, z, el, er, indptr, src, tr))
        out = gat.gat_fwd(z, el, er, indptr, src)[0]
        empty = indptr[:, 1:] == indptr[:, :-1]
        require(bool((out[empty] == 0).all()),
                f"K6 {name}: rows without edges must be exactly zero")
        if dh == 41:
            errs.append(gat_check(name + " int64 row pointers", gat, z, el,
                                  er, indptr.long(), src,
                                  (tr[0].long(), tr[1])))
            junk, junk_t = src.clone(), tr[1].clone()
            for p in range(P):
                junk[p, int(indptr[p, -1]):] = 123
                junk_t[p, int(tr[0][p, -1]):] = n - 1
            require(torch.equal(gat.gat_fwd(z, el, er, indptr, junk)[0],
                                out), "K6 read a pad edge past indptr[n]")
            require(all(torch.equal(a, b) for a, b in zip(
                gat.gat_fwd(z, el, er, indptr, junk, neg=True),
                gat.gat_fwd(z, el, er, indptr, src, neg=True))),
                "K6 (NEG mode) read a pad edge past indptr[n]")
            g = torch.randn_like(out)
            rho = (g * out).sum(-1)
            m, s = gat.gat_fwd(z, el, er, indptr, src)[1:]
            require(torch.equal(
                gat.gat_bwd_src(z, el, er, m, s, g, rho, tr[0], junk_t)[0],
                gat.gat_bwd_src(z, el, er, m, s, g, rho, *tr)[0]),
                "K8 read an edge past indptr_t[R]")
        if (P, H, dh) == (2, 4, 64):
            # logits all equal: uniform attention, out = the rows' mean
            c_el = torch.full_like(el, 0.3)
            c_er = torch.full_like(er, 0.2)
            errs.append(gat_check(name + " equal logits", gat, z, c_el,
                                  c_er, indptr, src, tr))
    return {k: max(e[k] for e in errs) for k in ("K6", "K8")}


def gat_cell_inputs(d, dh, seed):
    """z, el, er, g at the cell's shapes: [P, n_max + H, 4, dh] etc."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    P, n, R = d.num_parts, d.n_max, d.n_max + d.halo_size
    z = torch.randn((P, R, 4, dh), generator=gen, device="cuda")
    el = torch.randn((P, R, 4), generator=gen, device="cuda")
    er = torch.randn((P, n, 4), generator=gen, device="cuda")
    return z, el, er


def gat_cell_phase(trainer, gat, modes=("f32",)):
    """K6 and K8 against their plain versions on the cell's CSRs, at the
    hidden layers' dh = 64 and the logits layer's dh = 41, in the row
    types of each of ``modes``."""
    d = trainer.data
    errs = []
    for mode in modes:
        for dh, seed in ((64, 13), (41, 14)):
            z, el, er = gat_cell_inputs(d, dh, seed)
            errs.append(gat_check(f"cell dh={dh}", gat, z, el, er, d.indptr,
                                  d.edge_src, d.transpose, seed=seed,
                                  mode=mode))
    return {k: max(e[k] for e in errs) for k in ("K6", "K8")}


def gat_timings(trainer, gat, mode="f32"):
    """K6 (training's NEG mode, and eval's plain mode) and K8 at the
    cell's shapes (dh = 64 and 41): ms, plain ms and the bound. The bound
    counts each input read once and each output written once, and the
    function's least work: one FMA (2 flops) per edge per element. For K8
    that holds too: beta is alpha on the positive leaky branch and slope
    * alpha on the negative one, so one accumulator per branch takes each
    edge's alpha * g[dst] once, and d_z and sum(beta * g[dst]) come from
    the two at the end (3 flops per row element, the d_el dot product
    included). K6's NEG mode splits the same way (out from both). No
    single PyTorch call computes the attention aggregation, so there is
    no library time. ``mode`` picks the row types of z and g (the bytes
    shrink with them; the operations do not)."""
    import torch

    d = trainer.data
    P, n, R = d.num_parts, d.n_max, d.n_max + d.halo_size
    it, dt = d.transpose
    E = sum(int(d.indptr[p, -1]) for p in range(P))
    ip_b = d.indptr.numel() * d.indptr.element_size()
    out = {}
    zdt, gdt = gat_modes()[mode]
    for dh, seed in ((64, 15), (41, 16)):
        z, el, er = gat_cell_inputs(d, dh, seed)
        z = narrow(z, zdt)
        H, F = 4, 4 * dh
        o, m, s = gat.gat_fwd(z, el, er, d.indptr, d.edge_src)
        g = torch.randn_like(o)
        rho = (g * o).sum(-1)
        g = narrow(g, gdt)
        z_b, el_b, nh_b, nf_b = (P * R * F * z.element_size(), P * R * H * 4,
                                 P * n * H * 4, P * n * F * 4)
        g_b = P * n * F * g.element_size()
        shape = (f"P={P} n={n} R={R} H={H} dh={dh} edges={E} z "
                 f"{t_dtype(z)} g {t_dtype(g)}")
        a6 = (z, el, er, d.indptr, d.edge_src)
        a8 = (z, el, er, m, s, g, rho, it, dt)
        fwd_in = z_b + el_b + nh_b + ip_b + E * 4
        for name, fn, plain, args, n_bytes, ops in (
                ("K6", lambda *a: gat.gat_fwd(*a, neg=True),
                 lambda *a: gat.gat_fwd_plain(*a, neg=True), a6,
                 fwd_in + 2 * nf_b + 4 * nh_b, 2 * E * F + 2 * P * n * F),
                ("K6 eval", gat.gat_fwd, gat.gat_fwd_plain, a6,
                 fwd_in + nf_b + 2 * nh_b, 2 * E * F + P * n * F),
                ("K8", gat.gat_bwd_src, gat.gat_bwd_src_plain, a8,
                 z_b + el_b + 4 * nh_b + g_b
                 + it.numel() * it.element_size() + E * 4
                 + P * R * F * 4 + el_b,
                 2 * E * F + 3 * P * R * F)):
            out.setdefault(name, {})[dh] = dict(
                ms=time_ms(lambda: fn(*args)),
                plain_ms=time_ms(lambda: plain(*args), reps=3, warmup=1),
                library_ms=None, bound=bound_ms(n_bytes, ops), shape=shape)
        del z, el, er, o, m, s, g, rho
    return out


def gat_train_phase(args, sg, eval_graphs, eval_cache, spmm, halo):
    """The GAT cell: the reddit.sh command with ``--model gat --n-heads
    4`` minus ``--use-pp``, through cli/main.py's functions, on the train
    subgraph and parts the SAGE cell built, sharing its eval-graph CSRs.
    Counts every launch from the trainer's build through the final
    val/test eval."""
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer

    cli = train_cli(args, epochs=args.gat_epochs, model="gat")
    cnt = counters(spmm, halo)
    steps = {}
    reset_counts(cnt)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log,
                            steps=steps)
    trainer.eval_cache = eval_cache
    t0 = time.monotonic()
    res = trainer.fit(eval_graphs, log_fn=log, inductive=True)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = read_counts(cnt)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = res["losses"]
    n_ep = cli.n_epochs
    log(f"  gat fit: {n_ep} epochs in {fit_s:.1f}s, losses {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}, best val {res['best_val']:.4f}, test "
        f"{res.get('test_acc', float('nan')):.4f}, launches {launches}, "
        f"peak {peak_gib:.3f} GiB")
    require(len(losses) == n_ep, "gat fit ran the wrong epoch count")
    require(all(math.isfinite(x) for x in losses),
            f"gat: non-finite loss: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    require(last < first, f"gat: loss did not fall: first-5 mean "
            f"{first:.4f}, last-5 mean {last:.4f}")
    require_launched(launches, "gat", "gat training run")
    require(launches["gat_bwd_src"] == 4 * n_ep,
            f"gat: K8 must run 4 times per epoch: {launches}")
    require(launches["gat_fwd"] >= 4 * n_ep and launches["gat_fwd"] % 4 == 0,
            f"gat: K6 must run 4 times per forward: {launches}")
    accs = (res["best_val"], res.get("test_acc", float("nan")))
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
            f"gat: accuracies not finite: {accs}")
    stats = {"epochs": n_ep, "losses": losses, "first5_mean": first,
             "last5_mean": last, "best_val": res["best_val"],
             "best_epoch": res["best_epoch"], "test_acc": res["test_acc"],
             "fit_s": fit_s, "epoch_time_s_mean": res["epoch_time"],
             "peak_mem_gib": peak_gib, "host_steps_s": steps,
             "launches": launches}
    return trainer, stats


def gat_epoch_split(trainer, cnt, gt, tt):
    """The GAT epoch (median of 5 after one warm epoch) and its split by
    this run's kernel times: K6 (NEG mode) and K8 at dh = 64 for layers
    0-2 and dh = 41 for the logits layer, the comm kernels at their F =
    256 times (layer 0 exchanges 602 features: its share is a lower
    estimate)."""
    reset_counts(cnt)
    base = trainer.tcfg.n_epochs + 10
    epochs = iter(range(base, base + 100))
    reps = 5
    epoch_ms = time_ms(lambda: trainer.train_epoch(next(epochs)), reps=reps,
                       warmup=1)
    per_epoch = {k: v / (reps + 1) for k, v in read_counts(cnt).items()}
    attn_ms = sum(3 * gt[k][64]["ms"] + gt[k][41]["ms"]
                  for k in ("K6", "K8"))
    comm_ms = (per_epoch["halo_gather"] * tt["K2"]["ms"]
               + per_epoch["halo_scatter"] * tt["K4"]["ms"]
               + per_epoch["halo_return"] * tt["K5"]["ms"])
    split = {"epoch_ms": epoch_ms, "attention_kernels_ms": attn_ms,
             "comm_kernels_ms": comm_ms,
             "rest_ms": epoch_ms - attn_ms - comm_ms,
             "launches_per_epoch": per_epoch}
    log(f"  gat epoch {epoch_ms:.3f} ms median: K6+K8 {attn_ms:.3f} ms, "
        f"comm kernels {comm_ms:.3f} ms, rest {split['rest_ms']:.3f} ms "
        f"({per_epoch})")
    return split


def gcn_phase(args, sg, spmm, halo):
    """A short GCN run of the cell's command (``--model gcn``, no use_pp):
    a finite, falling loss and the mean-SpMM kernels launched; then one
    pipelined epoch through the kernels held against the plain versions
    (``step_phase``: K1 and K3 with the 1/sqrt(deg) scalings around them,
    K3 at F = 602 in layer 0's backward)."""
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer

    epochs = args.gcn_epochs
    cli = train_cli(args, epochs=epochs, model="gcn")
    cnt = counters(spmm, halo)
    reset_counts(cnt)
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log)
    t0 = time.monotonic()
    losses = [trainer.train_epoch(e) for e in range(epochs)]
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    launches = read_counts(cnt)
    log(f"  gcn: {epochs} epochs in {secs:.1f}s, losses {losses}, "
        f"launches {launches}")
    require(all(math.isfinite(x) for x in losses), "gcn: non-finite loss")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    require(last < first, f"gcn: loss did not fall: first-3 mean "
            f"{first:.4f}, last-3 mean {last:.4f}")
    require_launched(launches, "gcn", "gcn run")
    step = step_phase(trainer, epochs)
    return {"epochs": epochs, "losses": losses, "first3_mean": first,
            "last3_mean": last, "seconds": secs, "launches": launches,
            "step_check": step}


# ---------------------------------------------------------------------------
# phases 15-18: the bucket cell (--spmm-impl bucket --rem-dtype float8),
# K9, K10 and K11


def check_cast(name, got, ref) -> int:
    """Bit-identical, except that any NaN equals any NaN. Returns the
    count of differing elements (0 when the check passes)."""
    import torch

    require(got.shape == ref.shape and got.dtype == ref.dtype,
            f"{name}: shape/dtype mismatch")
    gn, rn = torch.isnan(got.float()), torch.isnan(ref.float())
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        got.element_size()]
    differ = (gn != rn) | (~gn & ~rn & (got.view(bits) != ref.view(bits)))
    n_diff = int(differ.sum())
    log(f"  {name}: bit-exact (NaN = NaN) {'ok' if n_diff == 0 else 'FAIL'}"
        f" ({n_diff} of {got.numel()} elements differ)")
    require(n_diff == 0, f"{name}: kernel is not bit-exact against its "
            f"plain version ({n_diff} elements differ)")
    return n_diff


def cast_err(got, ref) -> float:
    """Largest |got - ref| over the elements finite in both, widened to
    f32 (NaN and the infinities are held by ``check_cast``'s bits)."""
    import torch

    a, b = got.float(), ref.float()
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b)[both].abs().max()) if bool(both.any()) else 0.0


def k9_check(name, bs, x, side, deg=None, inv=None) -> float:
    """K9 against its plain version on one input, bit for bit; a rerun
    bit-identical. Returns the largest |difference| (0)."""
    import torch

    got = bs.bucket_gather(x, side, deg, inv)
    ref = bs.bucket_gather_plain(x, side, deg, inv)
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    check_cast(name, got, ref)
    require(torch.equal(bs.bucket_gather(x, side, deg, inv), got),
            f"{name}: a rerun is not bit-identical")
    return max_err(got, ref)


def transport_inputs(d, seed, F=256):
    """Activations [P, n_max + H, F] (post-LayerNorm scale) and
    cotangents [P, n_max, F] (small, as g / in_deg gives them) on the
    cell's shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    P, n, R = d.num_parts, d.n_max, d.n_max + d.halo_size
    act = torch.randn((P, R, F), generator=gen, device="cuda") * 2.0
    cot = torch.randn((P, n, F), generator=gen, device="cuda") * 1e-3
    return act, cot


def k9_cell_phase(trainer, bs, halo):
    """K9 against its plain version on the bucket cell's tables: each
    direction in each input dtype (the transport's), with the amax
    inverse scale; at F = 602 the pp precompute's f32 and GCN layer 0's
    transport (the exchanged features in e4m3, cotangents / in_deg in
    e5m2; the GCN trainer builds the same tables from the same parts)."""
    import torch

    d = trainer.data
    t = d.bucket
    act, cot = transport_inputs(d, 20)
    errs = []
    for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
               torch.float8_e5m2):
        x = act if dt == torch.float32 else \
            bs.transport_cast_plain(act, dt)[0]
        errs.append(k9_check(f"K9 forward {dt} F=256 (cell)", bs, x, t.fwd,
                             d.in_deg))
        g = cot / d.in_deg[..., None]
        g = g if dt == torch.float32 else bs.transport_cast_plain(g, dt)[0]
        errs.append(k9_check(f"K9 backward {dt} F=256 (cell)", bs, g, t.bwd))
    y, inv = bs.transport_cast_plain(act, torch.float8_e4m3fn,
                                     amax=bs.part_amax_plain(act))
    errs.append(k9_check("K9 forward e4m3 amax (cell)", bs, y, t.fwd,
                         d.in_deg, inv))
    feat = halo.halo_exchange(d.feat, d.send_idx, d.send_mask)
    errs.append(k9_check("K9 forward f32 F=602 (cell, pp precompute)", bs,
                         feat, t.fwd, d.in_deg))
    del act, cot
    _, cot = transport_inputs(d, 24, F=feat.shape[-1])
    x = bs.transport_cast_plain(feat, torch.float8_e4m3fn)[0]
    errs.append(k9_check("K9 forward e4m3 F=602 (cell, GCN layer 0)", bs, x,
                         t.fwd, d.in_deg))
    y, inv = bs.transport_cast_plain(feat, torch.float8_e4m3fn,
                                     amax=bs.part_amax_plain(feat))
    errs.append(k9_check("K9 forward e4m3 amax F=602 (cell, GCN layer 0)",
                         bs, y, t.fwd, d.in_deg, inv))
    del feat, x, y
    g = bs.transport_cast_plain(cot, torch.float8_e5m2, d.in_deg)[0]
    errs.append(k9_check("K9 backward e5m2 F=602 (cell, GCN layer 0)", bs, g,
                         t.bwd))
    return max(errs)


def bucket_edge_case(bs, min_width):
    """The bucket tables (``min_width`` = the merge) of 2 parts of
    ``edge_case_edges`` (300 rows, 700 source rows) staged on the card,
    with the rows' in-degrees (at least 1) and their empty-row mask."""
    import types

    import numpy as np
    import torch

    P, n, R = 2, 300, 700
    src, dst = edge_case_edges(P, n, R, seed=31)
    sg = types.SimpleNamespace(num_parts=P, n_max=n, halo_size=R - n,
                               edge_src=src, edge_dst=dst)
    t = bs.stage_bucket_tables(bs.build_sharded_bucket_tables(
        sg, min_width=min_width), n, R, torch.device("cuda"))
    deg = np.stack([np.bincount(d, minlength=n + 1)[:n] for d in dst])
    return (t, torch.from_numpy(np.maximum(deg, 1).astype(
        np.float32)).cuda(), torch.from_numpy(deg == 0).cuda())


def k9_ladder_case(bs):
    """Bucket tables of 2 parts (60 output rows, 700 source rows) whose
    rows hold every width of the ladder up to 711 entries, one of each
    rung less one, 16, 17, 32 and 33 entries (a lane group's chunk and one
    entry more), empty rows and 0-40 entries: fewer than 64 table rows
    (the parts' caps), the fewest list rows a CTA holds in any row type's
    geometry, so one CTA walks every bucket width. Then the same tables
    flipped: a sentinel in the middle of the 17-, 33- and 711-entry rows
    (what a table flip makes), negative indices in the 13- and 711-entry
    rows, one output's inv pointing past the tables and another's at a
    row a third output owns. Returns ``(tables, flipped forward side,
    in-degrees, empty-row mask)`` on the card."""
    import bisect
    import types

    import numpy as np
    import torch

    P, n, R = 2, 60, 700
    rungs = bs.ladder_prefix(17)
    head = sorted(set(rungs + [w - 1 for w in rungs] + [16, 17, 32, 33]))
    rng = np.random.default_rng(33)
    src, dst = [], []
    for _ in range(P):
        deg = rng.integers(0, 41, n)
        deg[:len(head)] = head  # 0 (rung 1 less one) .. 711
        deg[len(head):len(head) + 3] = 0
        d = np.repeat(np.arange(n), deg)
        src.append(rng.integers(0, R, d.size).astype(np.int32))
        dst.append(d.astype(np.int32))
    sg = types.SimpleNamespace(num_parts=P, n_max=n, halo_size=R - n,
                               edge_src=src, edge_dst=dst)
    t = bs.stage_bucket_tables(bs.build_sharded_bucket_tables(sg), n, R,
                               torch.device("cuda"))
    require(t.fwd.widths == tuple(rungs) and int(t.fwd.meta[0, -1]) <= 64,
            f"K9 ladder case widths {t.fwd.widths}, "
            f"{int(t.fwd.meta[0, -1])} table rows")
    degs = np.stack([np.bincount(d, minlength=n) for d in dst])
    meta = t.fwd.meta.cpu()
    flip = bs.BucketSide(**{**t.fwd.__dict__, "idx": t.fwd.idx.clone(),
                            "inv": t.fwd.inv.clone()})
    flip.inv[0, 50] = int(meta[0, -1]) + 3
    flip.inv[1, 55] = flip.inv[1, head.index(28)]
    for p in range(P):
        for w, changes in ((17, ((8, R),)), (33, ((16, R + 5),)),
                           (711, ((300, R), (0, -3), (500, -1))),
                           (13, ((4, -7),))):
            r = head.index(w)
            j = int(t.fwd.inv[p, r])
            b = bisect.bisect_right(meta[0].tolist(), j) - 1
            base = int(meta[1, b]) + (j - int(meta[0, b])) * int(meta[2, b])
            for k, v in changes:
                flip.idx[p, base + k] = v
    return (t, flip, torch.from_numpy(np.maximum(degs, 1).astype(
        np.float32)).cuda(), torch.from_numpy(degs == 0).cuda())


def k9_edge_phase(bs):
    """K9 on edge cases: empty rows (exact zeros), a 5,000-entry row, the
    bucket merge 4, F = 5, 16, 256 and 602 in every input dtype (e4m3 /
    e5m2 rows at F = 602 only 2-byte aligned), both directions, and junk
    in the cap-padding table rows (never read); the ladder case
    (``k9_ladder_case``: one CTA's rows spanning every bucket width, rows
    one entry past a lane group's chunk, empty rows) and its flipped
    tables (sentinels in the middle of rows, negative indices, an inv past
    the tables and one repeating a row) at F = 1,
    3, 41, 256 and 602 in every dtype. Each check reruns the kernel
    (bit-identical)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(21)
    errs = []
    dts = (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
           torch.float8_e5m2)

    def rows(shape, dt):
        v = torch.randn(shape, generator=gen, device="cuda")
        return (v.to(dt) if dt in (torch.float32, torch.bfloat16)
                else bs.transport_cast_plain(v, dt)[0])

    t, flip, deg, empty = k9_ladder_case(bs)
    n, R = t.bwd.n_src, t.fwd.n_src
    for F in (1, 3, 41, 256, 602):
        for dt in dts:
            x, g = rows((2, R, F), dt), rows((2, n, F), dt)
            name = f"K9 ladder case F={F} {dt}"
            errs.append(k9_check(name + " forward", bs, x, t.fwd, deg))
            errs.append(k9_check(name + " backward", bs, g, t.bwd))
            errs.append(k9_check(name + " flipped tables", bs, x, flip,
                                 deg))
            out = bs.bucket_gather(x, t.fwd, deg)
            require(bool((out[empty] == 0).all()),
                    f"{name}: rows without edges must be exactly zero")
    del t, flip
    for merge in (0, 4):
        t, deg, empty = bucket_edge_case(bs, merge)
        n, R = t.bwd.n_src, t.fwd.n_src
        require(max(t.fwd.widths) >= 5000 and (merge == 0
                                               or min(t.fwd.widths) >= 4),
                f"K9 edge case ladder {t.fwd.widths}")
        for F in (5, 16, 256, 602):
            for dt in dts:
                x, g = rows((2, R, F), dt), rows((2, n, F), dt)
                name = f"K9 edge cases merge={merge} F={F} {dt}"
                errs.append(k9_check(name + " forward", bs, x, t.fwd, deg))
                errs.append(k9_check(name + " backward", bs, g, t.bwd))
                out = bs.bucket_gather(x, t.fwd, deg)
                require(bool((out[empty] == 0).all()),
                        f"{name}: rows without edges must be exactly zero")
        # junk in the cap-padding rows, which no inv entry points at
        x = torch.randn((2, R, 16), generator=gen, device="cuda")
        junk = bs.BucketSide(**{**t.fwd.__dict__, "idx": t.fwd.idx.clone()})
        meta = t.fwd.meta.cpu()
        n_junk = 0
        for p in range(2):
            used = torch.zeros(int(meta[0, -1]) + 1, dtype=torch.bool)
            used[t.fwd.inv[p].long().cpu()] = True
            for b in range(t.fwd.nb):
                r0, r1, e0, w = (int(meta[0, b]), int(meta[0, b + 1]),
                                 int(meta[1, b]), int(meta[2, b]))
                for r in range(r0, r1):
                    if not used[r]:
                        junk.idx[p, e0 + (r - r0) * w:
                                 e0 + (r - r0 + 1) * w] = 3
                        n_junk += 1
        require(n_junk > 0, "K9 edge case has no cap-padding rows")
        require(torch.equal(bs.bucket_gather(x, junk, deg),
                            bs.bucket_gather(x, t.fwd, deg)),
                "K9 read a cap-padding table row")
    return max(errs)


def k9_fault_phase(bs):
    """One index of the 5,000-entry row (the widest bucket's) dropped: K9
    on those tables, held against the plain version on the whole tables
    by the check's own comparison, must fail."""
    import torch

    t, deg, _ = bucket_edge_case(bs, 0)
    R = t.fwd.n_src
    meta = t.fwd.meta.cpu()
    b = t.fwd.nb - 1
    j = int(t.fwd.inv[0, 5])  # the 5,000-entry row of part 0
    r0, e0, w = int(meta[0, b]), int(meta[1, b]), int(meta[2, b])
    require(r0 <= j < int(meta[0, b + 1]), "fault row is not in the widest "
            "bucket")
    fault = bs.BucketSide(**{**t.fwd.__dict__, "idx": t.fwd.idx.clone()})
    fault.idx[0, e0 + (j - r0) * w + 1234] = R  # one entry -> sentinel
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn((2, R, 256), generator=gen, device="cuda")
    name = "planted fault (one index of the 5,000-entry row dropped)"
    got = bs.bucket_gather(x, fault, deg)
    must_fail(f"K9 {name}", lambda: check_cast(
        f"K9 {name}", got, bs.bucket_gather_plain(x, t.fwd, deg)))


def cast_sweep():
    """f32 bit patterns around the fp8 saturation points, their rounding
    midpoints and subnormals, f32 subnormals, zeros, infinities and NaNs,
    both signs: [1, rows, 128]."""
    import numpy as np
    import torch

    centers = np.array([448, 464, 480, 57344, 61440, 65536, 2.0 ** -6,
                        2.0 ** -9, 2.0 ** -10, 2.0 ** -14, 2.0 ** -16,
                        2.0 ** -17, 2.0 ** -18, 2.0 ** -126, 1.0, 3.4e38,
                        np.inf], np.float32).view(np.int32)
    span = np.arange(-2048, 2048, dtype=np.int64)
    bits = (centers[:, None].astype(np.int64) + span[None, :]).reshape(-1)
    bits = np.concatenate([bits, np.arange(0, 4096), [0x7fc00000,
                                                      0x7f800001]])
    bits = bits[(bits >= 0) & (bits < 2 ** 31)].astype(np.uint32)
    bits = np.concatenate([bits, bits | np.uint32(2 ** 31)])
    bits = bits[: bits.size // 128 * 128]
    return torch.from_numpy(bits.view(np.float32).copy()).reshape(
        1, -1, 128).cuda()


def k10_k11_phase(trainer, bs, halo):
    """K10 bit-exact against its plain version on the cell's activations
    and cotangents at F = 256 and at GCN layer 0's F = 602 (the exchanged
    features; several passes of the kernel's column loop), with static
    and amax scales and the backward's fused g / in_deg, and on a sweep
    of f32 bit patterns in f32 and bf16; K11 exact on the same inputs; a
    scale off by 2 must fail K10's check, one max over both parts K11's. Returns, per kernel, the
    largest |difference| over the elements finite in both, the count of
    differing elements and the count of elements compared."""
    import torch

    d = trainer.data
    res = {"K10": [0.0, 0, 0], "K11": [0.0, 0, 0]}

    def held(k, name, got, ref):
        n = check_cast(name, got, ref)
        r = res[k]
        r[0], r[1], r[2] = (max(r[0], cast_err(got, ref)), r[1] + n,
                            r[2] + got.numel())

    act, cot = transport_inputs(d, 23)
    feat = halo.halo_exchange(d.feat, d.send_idx, d.send_mask)
    _, cot602 = transport_inputs(d, 25, F=feat.shape[-1])
    for F, (a_in, c_in) in ((256, (act, cot)), (602, (feat, cot602))):
        for dt in (torch.float8_e4m3fn, torch.float8_e5m2, torch.bfloat16):
            for name, x, deg in (("activations", a_in, None),
                                 ("cotangents / in_deg", c_in, d.in_deg)):
                a = bs.part_amax(x, deg)
                held("K11", f"K11 {name} F={F} (cell)", a,
                     bs.part_amax_plain(x, deg))
                for amax in (None, a):
                    got = bs.transport_cast(x, dt, deg, amax)
                    ref = bs.transport_cast_plain(x, dt, deg, amax)
                    tag = (f"K10 {dt} {name} F={F}"
                           f"{' amax' if amax is not None else ''}")
                    held("K10", tag + " (cell)", got[0], ref[0])
                    if ref[1] is not None:
                        held("K10", tag + " inv_scale", got[1], ref[1])
                    del got, ref
    del feat, cot602
    sweep = cast_sweep()
    for src in (torch.float32, torch.bfloat16):
        x = sweep.to(src)
        held("K11", f"K11 sweep {src}", bs.part_amax(x),
             bs.part_amax_plain(x))
        for dt in (torch.float8_e4m3fn, torch.float8_e5m2, torch.bfloat16):
            held("K10", f"K10 sweep {src} -> {dt}",
                 bs.transport_cast(x, dt)[0],
                 bs.transport_cast_plain(x, dt)[0])
            scaled = torch.full((1,), 3.0e-3, device="cuda")
            held("K10", f"K10 sweep {src} -> {dt} amax 3e-3",
                 bs.transport_cast(x, dt, amax=scaled)[0],
                 bs.transport_cast_plain(x, dt, amax=scaled)[0])
    a = bs.part_amax(act)
    bad = bs.transport_cast(act, torch.float8_e4m3fn, amax=a / 2)[0]
    must_fail("K10 planted fault (scale off by 2)", lambda: check_cast(
        "K10 planted fault (scale off by 2)", bad,
        bs.transport_cast_plain(act, torch.float8_e4m3fn, amax=a)[0]))
    # K11's own: the kernel over the stack as one part (one max over both
    # parts, part 1 halved so the parts' maxima differ) against the
    # per-part amax
    halved = act.clone()
    halved[1:] *= 0.5
    P, F = halved.shape[0], halved.shape[-1]
    one = bs.part_amax(halved.reshape(1, -1, F)).expand(P).contiguous()
    must_fail("K11 planted fault (one max over both parts)", lambda:
              check_cast("K11 planted fault (one max over both parts)", one,
                         bs.part_amax_plain(halved)))
    del halved
    log(f"  K10 / K11: largest |difference| {res['K10'][0]:g} / "
        f"{res['K11'][0]:g}, {res['K10'][1]} / {res['K11'][1]} of "
        f"{res['K10'][2]} / {res['K11'][2]} elements differ")
    return res


def bucket_train_phase(args, sg, eval_graphs, eval_cache, spmm, halo):
    """The bucket cell: the reddit.sh command plus ``--spmm-impl bucket
    --rem-dtype float8`` through cli/main.py's functions on the SAGE
    cell's parts, sharing its eval-graph CSRs; counts from the trainer's
    build (the pp precompute's one K9 launch, transport off) through the
    final eval. Then one epoch alone (K9 and K10 6 times, K1 and K3 never)
    and 2 epochs of each transport variant on the same trainer and
    tables (the variant's flags parsed by the CLI, its ModelConfig
    swapped in)."""
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer, configs

    flags = ["--spmm-impl", "bucket", "--rem-dtype", "float8"]
    cli = train_cli(args, epochs=args.bucket_epochs, extra=flags)
    cnt = counters(spmm, halo)
    steps = {}
    reset_counts(cnt)
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30  # the eval CSRs
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log,
                            steps=steps)
    steps["bucket_tables"] = trainer.data.bucket_build_s
    trainer.eval_cache = eval_cache
    t0 = time.monotonic()
    res = trainer.fit(eval_graphs, log_fn=log, inductive=True)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = read_counts(cnt)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = res["losses"]
    n_ep = cli.n_epochs
    log(f"  bucket fit: {n_ep} epochs in {fit_s:.1f}s (tables "
        f"{steps['bucket_tables']:.1f}s), losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, best val {res['best_val']:.4f}, test "
        f"{res.get('test_acc', float('nan')):.4f}, launches {launches}, "
        f"peak {peak_gib:.3f} GiB (held before the build {base_gib:.3f} GiB)")
    require(len(losses) == n_ep, "bucket fit ran the wrong epoch count")
    require(all(math.isfinite(x) for x in losses),
            f"bucket: non-finite loss: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    require(last < first, f"bucket: loss did not fall: first-5 mean "
            f"{first:.4f}, last-5 mean {last:.4f}")
    require_launched(launches, "bucket", "bucket training run")
    require(launches["bucket_gather"] == 6 * n_ep + 1
            and launches["transport_cast"] == 6 * n_ep
            and launches["spmm_mean_t"] == 0 and launches["part_amax"] == 0,
            f"bucket: K9 must run 6 times an epoch (+1 for the pp "
            f"precompute), K10 6 times, K3 and K11 never: {launches}")
    accs = (res["best_val"], res.get("test_acc", float("nan")))
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
            f"bucket: accuracies not finite: {accs}")

    def epochs_of(label, n, epoch0, want):
        reset_counts(cnt)
        ls = [trainer.train_epoch(epoch0 + e) for e in range(n)]
        got = read_counts(cnt)
        log(f"  bucket {label}: losses {ls}, launches {got}")
        require(all(math.isfinite(x) for x in ls),
                f"bucket {label}: non-finite loss")
        per = {k: got[k] for k in want}
        require(per == {k: v * n for k, v in want.items()},
                f"bucket {label}: launches {got}, want {want} per epoch")
        return {"losses": ls, "launches": got}

    one = epochs_of("one epoch", 1, n_ep, {
        "bucket_gather": 6, "transport_cast": 6, "part_amax": 0,
        "spmm_mean": 0, "spmm_mean_t": 0})
    variants = {}
    base_cfg = trainer.cfg
    for i, (label, extra, k10, k11) in enumerate((
            ("--rem-amax", ["--rem-amax"], 6, 6),
            ("--rem-dtype bfloat16", ["--rem-dtype", "bfloat16"], 6, 0),
            ("--rem-dtype none", ["--rem-dtype", "none"], 0, 0))):
        vcli = train_cli(args, epochs=2, extra=flags + extra)
        trainer.cfg = configs(vcli, sg)[0]
        variants[label] = epochs_of(label, 2, n_ep + 1 + 2 * i, {
            "bucket_gather": 6, "transport_cast": k10, "part_amax": k11,
            "spmm_mean": 0, "spmm_mean_t": 0})
    trainer.cfg = base_cfg
    stats = {"epochs": n_ep, "losses": losses, "first5_mean": first,
             "last5_mean": last, "best_val": res["best_val"],
             "best_epoch": res["best_epoch"], "test_acc": res["test_acc"],
             "fit_s": fit_s, "epoch_time_s_mean": res["epoch_time"],
             "peak_mem_gib": peak_gib, "mem_before_build_gib": base_gib,
             "host_steps_s": steps,
             "launches": launches, "one_epoch": one, "variants": variants,
             "amax_launches": variants["--rem-amax"]["launches"]}
    return trainer, stats


def bucket_gcn_phase(args, sg, spmm, halo):
    """``--model gcn --spmm-impl bucket --rem-dtype float8`` (no use_pp)
    for a few pipelined epochs: finite, falling loss; K9 and K10 8 times
    an epoch (4 layers forward and backward: layer 0's buffer takes the
    halo probe, whose cotangent the pipeline returns). Then one epoch
    through the kernels held against the plain versions (``step_phase``:
    relu masks and transported values shared, K9 and K10 at F = 602 in
    layer 0)."""
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer

    n = args.bucket_gcn_epochs
    cli = train_cli(args, epochs=n, model="gcn", extra=[
        "--spmm-impl", "bucket", "--rem-dtype", "float8"])
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log)
    cnt = counters(spmm, halo)
    reset_counts(cnt)
    losses = [trainer.train_epoch(e) for e in range(n)]
    launches = read_counts(cnt)
    log(f"  bucket gcn: losses {losses}, launches {launches}")
    require(all(math.isfinite(x) for x in losses),
            "bucket gcn: non-finite loss")
    require(losses[-1] < losses[0], f"bucket gcn: loss did not fall: "
            f"{losses}")
    require(launches["bucket_gather"] == 8 * n
            and launches["transport_cast"] == 8 * n
            and launches["spmm_mean"] == 0 and launches["spmm_mean_t"] == 0,
            f"bucket gcn: K9 and K10 must run 8 times an epoch: {launches}")
    step = step_phase(trainer, n)
    return {"epochs": n, "losses": losses, "launches": launches,
            "bucket_tables_s": trainer.data.bucket_build_s,
            "step_check": step}


def csr_library(d, reverse):
    """One cuSPARSE CSR matrix over the block-diagonal parts with values
    1/in_deg[dst] (forward, [P n_max, P R]) or its transpose with values 1
    (``reverse``: the backward's sum of g / in_deg over out-edges)."""
    import torch

    P, n, R = d.num_parts, d.n_max, d.n_max + d.halo_size
    dst, src, val = [], [], []
    for p in range(P):
        ne = int(d.indptr[p, -1])
        rows = torch.repeat_interleave(
            torch.arange(n, device="cuda"), d.indptr[p].diff().long())
        dst.append(rows + p * n)
        src.append(d.edge_src[p, :ne].long() + p * R)
        val.append(torch.ones(ne, device="cuda") if reverse
                   else 1.0 / d.in_deg[p].index_select(0, rows))
    dst, src, val = torch.cat(dst), torch.cat(src), torch.cat(val)
    idx = torch.stack([src, dst] if reverse else [dst, src])
    size = (P * R, P * n) if reverse else (P * n, P * R)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, val, size).coalesce() \
            .to_sparse_csr()


def bucket_timings(trainer, bs):
    """K9 forward and backward in each transport dtype at the cell's
    shapes (ms, plain ms, bound; cuSPARSE over the CSR for f32 only: no
    single PyTorch call gathers bf16 or fp8 rows into f32 sums), K10
    forward (e4m3) and backward (e5m2, g / in_deg fused) against
    ``clamp().to()`` (two calls), K11 against one
    ``torch.linalg.vector_norm(ord=inf)``, both also 20 calls back to
    back (``batched_ms``: at ~0.1 ms an event pair around one call counts
    the wrapper's host work as well). Bounds count each input read
    once and each output written once (K9: the real table entries, not
    the sentinel padding) and K9's least work: one add per real entry and
    column and (forward) one division per output element. The static
    transport of the epoch passes no inverse scale."""
    import torch

    d = trainer.data
    t = d.bucket
    P, n, R = d.num_parts, d.n_max, d.n_max + d.halo_size
    F = 256
    act, cot = transport_inputs(d, 24)
    gd = cot / d.in_deg[..., None]
    out = {"K9": {}, "K10": {}, "K11": {}}
    lib = {}
    for name, reverse in (("forward", False), ("backward", True)):
        a = csr_library(d, reverse)
        dense = (act if not reverse else gd).reshape(-1, F)
        lib[name] = time_ms(lambda: torch.sparse.mm(a, dense))
        del a
    for name, side, x0, deg in (("forward", t.fwd, act, d.in_deg),
                                ("backward", t.bwd, gd, None)):
        E = int((side.idx < side.n_src).sum())
        n_out = side.n_out
        for dt in (torch.float32, torch.bfloat16,
                   torch.float8_e4m3fn if name == "forward"
                   else torch.float8_e5m2):
            x = x0 if dt == torch.float32 else \
                bs.transport_cast_plain(x0, dt)[0]
            n_bytes = (x.numel() * x.element_size() + E * 4
                       + side.inv.numel() * 4 + side.meta.numel() * 8
                       + (deg.numel() * 4 if deg is not None else 0)
                       + P * n_out * F * 4)
            ops = E * F + (P * n_out * F if deg is not None else 0)
            out["K9"][f"{name} {str(dt).split('.')[-1]}"] = dict(
                ms=time_ms(lambda: bs.bucket_gather(x, side, deg)),
                # one call: the plain version (a launch per table
                # column of each bucket) is slow, and it ran in the
                # checks before
                plain_ms=time_ms(lambda: bs.bucket_gather_plain(
                    x, side, deg), reps=1, warmup=0),
                library_ms=lib[name] if dt == torch.float32 else None,
                bound=bound_ms(n_bytes, ops),
                shape=f"P={P} n_src={side.n_src} n_out={n_out} F={F} "
                      f"entries={E} {dt}")
    for name, x, dt, deg in (
            ("forward e4m3", act, torch.float8_e4m3fn, None),
            ("backward e5m2", cot, torch.float8_e5m2, d.in_deg)):
        m = bs.F8_MAX[dt]
        n_bytes = x.numel() * 5 + (deg.numel() * 4 if deg is not None else 0)
        ops = x.numel() * (2 if deg is not None else 1)
        out["K10"][name] = dict(
            ms=time_ms(lambda: bs.transport_cast(x, dt, deg)),
            plain_ms=time_ms(lambda: bs.transport_cast_plain(x, dt, deg)),
            library_ms=time_ms(lambda: torch.clamp(x, -m, m).to(dt)),
            library_calls="torch.clamp + Tensor.to (two calls; the "
                          "backward's division not included)",
            bound=bound_ms(n_bytes, ops),
            shape=f"{tuple(x.shape)} f32 -> {dt}"
                  f"{' / in_deg' if deg is not None else ''}")
        a = bs.part_amax(x, deg)
        scaled = dict(
            ms=time_ms(lambda: bs.transport_cast(x, dt, deg, a)),
            plain_ms=time_ms(lambda: bs.transport_cast_plain(x, dt, deg, a)),
            library_ms=None, bound=bound_ms(n_bytes + P * 8, ops + x.numel()),
            shape=out["K10"][name]["shape"] + " amax scale")
        out["K10"][name + " amax"] = scaled
        norm = (lambda: torch.linalg.vector_norm(  # noqa: E731
            x, ord=float("inf"), dim=(1, 2)))
        out["K11"][name] = dict(
            ms=time_ms(lambda: bs.part_amax(x, deg)),
            plain_ms=time_ms(lambda: bs.part_amax_plain(x, deg)),
            library_ms=time_ms(norm),
            batched_ms=batched_ms(lambda: bs.part_amax(x, deg)),
            library_batched_ms=batched_ms(norm),
            bound=bound_ms(x.numel() * 4 + P * 4
                           + (deg.numel() * 4 if deg is not None else 0),
                           x.numel()),
            shape=f"{tuple(x.shape)} f32"
                  f"{' / in_deg' if deg is not None else ''}")
    for k, v in out.items():
        for name, e in v.items():
            dev = (f", back to back {e['batched_ms']:.3f} / library "
                   f"{e['library_batched_ms']:.3f}"
                   if "batched_ms" in e else "")
            log(f"  {k} {name}: {e['ms']:.3f} ms (plain {e['plain_ms']:.3f},"
                f" library {e['library_ms']}, bound {e['bound'][0]:.3f} "
                f"{e['bound'][1]}{dev}) [{e['shape']}]")
    return out


def bucket_epoch_split(trainer, cnt, bt, tt):
    """The bucket epoch (median of 5 after one warm epoch) and its split
    by this run's kernel times: K9 (3 forward e4m3 + 3 backward e5m2),
    K10 (3 + 3), the comm kernels at the SAGE cell's F = 256 times, the
    rest by subtraction; beside it the xla epoch of the SAGE cell."""
    reset_counts(cnt)
    base = trainer.tcfg.n_epochs + 20
    epochs = iter(range(base, base + 100))
    reps = 5
    epoch_ms = time_ms(lambda: trainer.train_epoch(next(epochs)), reps=reps,
                       warmup=1)
    per_epoch = {k: v / (reps + 1) for k, v in read_counts(cnt).items()}
    k9 = 3 * (bt["K9"]["forward float8_e4m3fn"]["ms"]
              + bt["K9"]["backward float8_e5m2"]["ms"])
    k10 = 3 * (bt["K10"]["forward e4m3"]["ms"]
               + bt["K10"]["backward e5m2"]["ms"])
    comm = (per_epoch["halo_gather"] * tt["K2"]["ms"]
            + per_epoch["halo_scatter"] * tt["K4"]["ms"]
            + per_epoch["halo_return"] * tt["K5"]["ms"])
    split = {"epoch_ms": epoch_ms, "k9_ms": k9, "k10_ms": k10,
             "comm_kernels_ms": comm, "rest_ms": epoch_ms - k9 - k10 - comm,
             "xla_epoch_ms": tt["epoch_ms"],
             "xla_k1_k3_ms": 3 * (tt["K1"]["ms"] + tt["K3"]["ms"]),
             "launches_per_epoch": per_epoch}
    log(f"  bucket epoch {epoch_ms:.3f} ms median: K9 {k9:.3f} ms, K10 "
        f"{k10:.3f} ms, comm kernels {comm:.3f} ms, rest "
        f"{split['rest_ms']:.3f} ms ({per_epoch}); the xla epoch "
        f"{tt['epoch_ms']:.3f} ms (3 x (K1 + K3) "
        f"{split['xla_k1_k3_ms']:.3f} ms)")
    return split


# ---------------------------------------------------------------------------
# phases 19-23: the block cell (--spmm-impl block --rem-dtype float8), K12
# and K13

# bf16 tensor-core peak of one H100 SXM (dense, 700 W): the floor of the
# tile products were they run there (a second bound beside bound_ms)
BF16_TC_FLOP_PER_S = 989e12
# K12 and K13 against their plain version: both form the same exact
# products of the f32 inputs and the A values (0/1, or integers that
# int8, bf16 and f32 hold exactly; the kernels split each input into
# three bf16 terms whose products with A are exact, or, for f32 A, use
# fmaf), the plain version sums them by bmm (cuBLAS in f32, TF32 off) and
# index_add_ across pairs, the kernels on the tensor cores within a pair
# (adds that truncate: a few ulps of the pair's partial sum, ~1 edge of a
# row at the cell's density) and in f32 across pairs, in list order. A
# zero entry adds nothing, so a sum runs over a row's dense edges (~240
# at the cell); two orders of n terms differ by a few sqrt(n) u of the
# terms' magnitudes (~5e-6 at n = 240), under BLOCK_SUM_RTOL, while one
# flipped A bit moves an output element by a whole input value (~1e-1 of
# the sum of ~240 unit terms): the planted fault must fail.
BLOCK_SUM_RTOL = 1e-5
BLOCK_ATOL = 1e-30  # the bound of an empty row is 0: both write zeros


def dense_fn(blk, side):
    """The kernel wrapper of one side: K12 / K13 over pair lists, K16 /
    K17 over union groups."""
    if isinstance(side, blk.GroupSide):
        return (blk.block_dense_grouped_t if side.transpose
                else blk.block_dense_grouped)
    return blk.block_dense_t if side.transpose else blk.block_dense


def block_check(name, blk, x, tables, side) -> float:
    """K12 (K13 for a transpose side; K16 / K17 over union groups) against
    the plain version on one input within BLOCK_SUM_RTOL * sum|terms| (the
    plain product on |x|: A >= 0); a rerun bit-identical. The check's name
    carries the C entry that ran it (``tile_entry``). Returns the largest
    |difference|."""
    import torch

    fn = dense_fn(blk, side)
    entry = blk.tile_entry(isinstance(side, blk.GroupSide), side.transpose,
                           tables.a.dtype)
    name = f"{name} [{entry}]"
    got = fn(x, tables)
    ref = blk.block_dense_plain(x, tables, side)
    abs_sum = blk.block_dense_plain(x.abs(), tables, side)
    err = check_close(name, got, ref, BLOCK_ATOL, 0.0, abs_sum,
                      BLOCK_SUM_RTOL)
    require(torch.equal(fn(x, tables), got),
            f"{name}: a rerun is not bit-identical")
    return err


def block_side(pairs, n_keys, n_out, n_in, transpose):
    """One part's BlockSide on the card from ``pairs`` [(key tile, block,
    input tile)] in list order."""
    import numpy as np
    import torch
    from pipegcn_tpu_torch.ops import block_spmm as blk

    pairs = sorted(pairs, key=lambda q: q[0])  # stable: list order kept
    keys = np.array([q[0] for q in pairs], np.int64)
    ptr = np.zeros(n_keys + 1, np.int32)
    np.cumsum(np.bincount(keys, minlength=n_keys), out=ptr[1:])
    blks = np.array([q[1] for q in pairs] or [0], np.int32)
    tiles = np.array([q[2] for q in pairs] or [0], np.int32)
    put = (lambda a: torch.from_numpy(a[None]).cuda())  # noqa: E731
    return blk.BlockSide(ptr=put(ptr), blk=put(blks), tile=put(tiles),
                         n_out=n_out, n_in=n_in, transpose=transpose)


def block_tables_of(a, packed, tile, pairs, n_out, n_in):
    """BlockTables of one part on the card: A ``a`` [1, B, T, T(/8)] and
    the forward pairs [(output tile, block, input tile)]; the transpose
    lists hold the same pairs keyed by input tile. No remainder."""
    from pipegcn_tpu_torch.ops import block_spmm as blk

    n_out_t, n_in_t = -(-n_out // tile), -(-n_in // tile)
    return blk.BlockTables(
        a=a.cuda(), packed=packed, tile=tile,
        fwd=block_side(pairs, n_out_t, n_out, n_in, False),
        bwd=block_side([(t, b, i) for i, b, t in pairs], n_in_t, n_in,
                       n_out, True), rem_fwd=None, rem_bwd=None)


_PLANTED = {}


def planted_multigraph_tables(dup, seed, group=1):
    """The block tables of a small community multigraph in the cluster
    layout (6,000 nodes, ~120 edges a node, 2 random parts, tile 256 at
    the cell's 602-wide hint) with one (dst, src) pair planted ``dup``
    more times and five others 3 times: ``dup`` 3 ships int8 A, 200 bf16,
    300 f32; ``group`` > 1 the union-gather layout. The graph is built
    once a (dup, seed)."""
    import numpy as np
    import torch
    from pipegcn_tpu_torch.graph.synthetic import synthetic_graph
    from pipegcn_tpu_torch.ops import block_spmm as blk
    from pipegcn_tpu_torch.partition.halo import ShardedGraph
    from pipegcn_tpu_torch.partition.partitioner import (locality_clusters,
                                                         partition_graph)

    if (dup, seed) not in _PLANTED:
        g = synthetic_graph(num_nodes=6000, avg_degree=120, n_feat=8,
                            n_class=6, seed=seed)
        cluster = locality_clusters(g, target_size=256, seed=0)
        rng = np.random.default_rng(seed)
        pick = rng.integers(0, g.num_edges, 6)
        reps = np.concatenate([np.full(dup, pick[0]),
                               np.repeat(pick[1:], 3)])
        g.src = np.concatenate([g.src, g.src[reps]]).astype(g.src.dtype)
        g.dst = np.concatenate([g.dst, g.dst[reps]]).astype(g.dst.dtype)
        _PLANTED[(dup, seed)] = ShardedGraph.build(
            g, partition_graph(g, 2, method="random", seed=0), n_parts=2,
            cluster=cluster)
    sg = _PLANTED[(dup, seed)]
    st = {}
    tables, _ = blk.build_sharded_block_tables(sg, tile=256, n_feat_hint=602,
                                               group=group, stats=st)
    staged = blk.stage_block_tables(tables, 256, sg.n_max,
                                    sg.n_max + sg.halo_size,
                                    torch.device("cuda", 0))
    return staged, st


def k12_k13_edge_phase(blk):
    """K12 and K13 on edge cases, both directions: every A encoding from a
    planted multigraph (int8, bf16, f32) at F = 256 and 602, and with
    bf16 rows (the bf16 mode) at F = 256; an empty
    pair list (zeros out); a ragged last output and input tile with F = 5
    and 64; one tile of 256 x 256 ones."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(31)
    errs = []

    def both(label, t, F, dtype=torch.float32):
        for side in (t.fwd, t.bwd):
            x = torch.randn((t.a.shape[0], side.n_in, F), generator=gen,
                            device="cuda").to(dtype)
            errs.append(block_check(
                f"{'K13' if side.transpose else 'K12'} {label} F={F} "
                f"{t_dtype(x)} rows", blk, x, t, side))

    for dup, want_bits in ((3, 8), (200, 16), (300, 32)):
        t, st = planted_multigraph_tables(dup, seed=dup)
        require(st["bits"] == want_bits and not t.packed,
                f"planted multigraph x{dup}: {st['bits']}-bit A, want "
                f"{want_bits}")
        log(f"  planted multigraph x{dup}: {st['bits']}-bit A "
            f"({t.a.dtype}), {st['blocks']} blocks")
        for F in (256, 602):
            both(f"{t.a.dtype} A", t, F)
        # the bf16 mode over every A encoding (f32 A: the scalar path)
        both(f"{t.a.dtype} A", t, 256, torch.bfloat16)
    T = 256
    gb = torch.Generator().manual_seed(5)
    bits = torch.randint(0, 256, (1, 4, T, T // 8), generator=gb,
                         dtype=torch.uint8)
    # 300 output rows (2 tiles, the last ragged: 44 rows), 700 input rows
    # (3 tiles, the last 188 rows)
    pairs = [(0, 0, 0), (0, 1, 2), (1, 2, 1), (1, 3, 2), (1, 0, 0)]
    empty = block_tables_of(bits, True, T, [], 300, 700)
    for side in (empty.fwd, empty.bwd):
        x = torch.randn((1, side.n_in, 64), generator=gen, device="cuda")
        fn = blk.block_dense_t if side.transpose else blk.block_dense
        out = fn(x, empty)
        require(out.shape == (1, side.n_out, 64) and not bool(out.any()),
                "K12/K13 empty pair list: output is not all zeros")
    log("  K12 / K13 empty pair list: zeros ok")
    ragged = block_tables_of(bits, True, T, pairs, 300, 700)
    for F in (5, 64):
        both("ragged tiles", ragged, F)
    ones = torch.full((1, 1, T, T // 8), 255, dtype=torch.uint8)
    full = block_tables_of(ones, True, T, [(0, 0, 0)], T, T)
    both("256 x 256 ones", full, 256)
    return max(errs)


def k12_tma_edge_phase(blk):
    """K12 on csrc/block_tma.cu (pair lists as union lists of group 1)
    over hand-made pair lists against the plain version
    (BLOCK_SUM_RTOL * sum|terms|, each rerun bit-identical): T = 32, 96
    (T % 64 == 32: a chunk of two k-steps), 160 (two CTAs a tile, the
    second ragged) and 224; 1-bit, int8 and bf16 A; f32 rows at F = 1
    (one column of a 64-column plane), 64 and 602 (a padded split plane);
    bf16 rows at F = 5 and 100 (the pre-pass's padded copy) and 64 (read
    as they are); a ragged last output and input tile, and output tiles
    with an empty pair list, whose rows must be zeros. One flipped A bit
    at T = 96 must fail the check."""
    import dataclasses

    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(61)
    gb = torch.Generator().manual_seed(11)
    rng = np.random.default_rng(61)
    errs = []
    f32, bf = torch.float32, torch.bfloat16
    cases = (
        # T, A encoding, output tiles, input tiles, [(F, row dtype)],
        # output tiles with no pair
        (32, "bits", 7, 9, [(1, f32), (64, f32), (5, bf)], (3,)),
        (96, "bits", 10, 7, [(1, f32), (602, f32), (100, bf), (64, bf)],
         (0, 4)),
        (96, "int8", 6, 5, [(64, f32), (64, bf)], (5,)),
        (160, "bits", 9, 6, [(1, f32), (256, f32), (602, f32), (5, bf),
                             (256, bf)], (2,)),
        (160, "bf16", 5, 4, [(130, f32), (100, bf)], ()),
        (224, "int8", 4, 5, [(256, f32)], (1,)),
    )
    for T, enc, n_t, n_in_t, runs, empty in cases:
        pairs = []
        for i in range(n_t):
            if i in empty:
                continue
            for tl in rng.choice(n_in_t, min(4, n_in_t), replace=False):
                pairs.append((i, len(pairs), int(tl)))
        nb = len(pairs)
        if enc == "bits":
            a = torch.randint(0, 256, (1, nb, T, T // 8), generator=gb,
                              dtype=torch.uint8)
        elif enc == "int8":
            a = torch.randint(0, 4, (1, nb, T, T), generator=gb,
                              dtype=torch.int8)
        else:
            a = torch.randint(0, 3, (1, nb, T, T), generator=gb).to(bf)
        n_out, n_in = n_t * T - 20, n_in_t * T - 30
        tb = block_tables_of(a, enc == "bits", T, pairs, n_out, n_in)
        require(blk.tile_entry(False, False, tb.a.dtype)
                == "pgt_block_grouped_tma", f"K12 T={T} {enc} A: not "
                "routed to block_tma.cu")
        for F, dt in runs:
            x = torch.randn((1, n_in, F), generator=gen,
                            device="cuda").to(dt)
            errs.append(block_check(
                f"K12 tma T={T} {enc} A F={F} {t_dtype(x)} rows "
                f"({nb} pairs, empty tiles {list(empty)})", blk, x, tb,
                tb.fwd))
            got = blk.block_dense(x, tb)
            for i in empty:
                require(not bool(got[0, i * T:(i + 1) * T].any()),
                        f"K12 tma T={T}: empty output tile {i} not zeros")
        if T == 96 and enc == "bits":
            bad = dataclasses.replace(tb, a=tb.a.clone())
            bad.a[0, 0, 7, 3] ^= 1 << 5
            x = torch.randn((1, n_in, 64), generator=gen, device="cuda")
            got = blk.block_dense(x, bad)
            ref = blk.block_dense_plain(x, tb, tb.fwd)
            abs_sum = blk.block_dense_plain(x.abs(), tb, tb.fwd)
            must_fail("K12 tma planted fault (one A bit flipped, T=96)",
                      lambda: check_close("K12 tma planted fault", got, ref,
                                          BLOCK_ATOL, 0.0, abs_sum,
                                          BLOCK_SUM_RTOL))
    log(f"  K12 on block_tma.cu, edge cases: worst |diff| {max(errs):.3e}")
    return max(errs)


def block_fault_phase(blk, trainer, dtype=None):
    """One bit of one A block flipped (the block of part 0's first pair):
    K12's and K13's checks (K16's and K17's on union-gather tables) at the
    cell's shapes must fail against the plain versions on the true A (on
    ``dtype`` rows: f32, or bf16 for the bf16 mode)."""
    import dataclasses

    import torch

    t = trainer.data.block
    first = t.fwd.blk[0][t.fwd.blk[0] != t.b_max]  # no pads in pair lists
    b = int(first.reshape(-1)[0])
    bad = dataclasses.replace(t, a=t.a.clone())
    bad.a[0, b, 7, 3] ^= 1 << 5  # row 7, input column 3 * 8 + 5
    gen = torch.Generator(device="cuda").manual_seed(41)
    grouped = t.group > 1
    for name, side in (("K16" if grouped else "K12", t.fwd),
                       ("K17" if grouped else "K13", t.bwd)):
        fn = dense_fn(blk, side)
        x = torch.randn((t.a.shape[0], side.n_in, 256), generator=gen,
                        device="cuda").to(dtype or torch.float32)
        if dtype is not None:
            name = f"{name} [{t_dtype(x)}]"
        got = fn(x, bad)
        ref = blk.block_dense_plain(x, t, side)
        abs_sum = blk.block_dense_plain(x.abs(), t, side)
        must_fail(f"{name} planted fault (one A bit flipped)",
                  lambda: check_close(f"{name} planted fault", got, ref,
                                      BLOCK_ATOL, 0.0, abs_sum,
                                      BLOCK_SUM_RTOL))


def k12_k13_cell_phase(trainer, blk, halo):
    """K12 and K13 at the cell's shapes: F = 256 (the hidden layers) and
    602 (the pp precompute's exchanged features, GCN layer 0)."""
    import torch

    d = trainer.data
    t = d.block
    gen = torch.Generator(device="cuda").manual_seed(33)
    R = d.n_max + d.halo_size
    errs = []
    act = torch.randn((d.num_parts, R, 256), generator=gen, device="cuda")
    g = torch.randn((d.num_parts, d.n_max, 256), generator=gen,
                    device="cuda")
    errs.append(block_check("K12 cell F=256", blk, act, t, t.fwd))
    errs.append(block_check("K13 cell F=256", blk, g, t, t.bwd))
    # F = 1: Freivalds' projection through the block trainer's
    # aggregation (one column, padded to a 64-column plane)
    errs.append(block_check("K12 cell F=1 (Freivalds)", blk,
                            act[..., :1].contiguous(), t, t.fwd))
    del act, g
    fbuf = halo.halo_gather(d.feat, d.send_idx, d.send_mask, with_inner=True)
    errs.append(block_check("K12 cell F=602 (pp precompute)", blk, fbuf, t,
                            t.fwd))
    del fbuf
    g = torch.randn((d.num_parts, d.n_max, 602), generator=gen,
                    device="cuda")
    errs.append(block_check("K13 cell F=602", blk, g, t, t.bwd))
    return max(errs)


def block_train_phase(args, sg, eval_graphs, eval_cache, spmm, halo):
    """The block cell: the reddit.sh command plus ``--spmm-impl block
    --rem-dtype float8`` through cli/main.py's functions on the SAGE
    cell's parts (the cluster layout), sharing its eval-graph CSRs; counts
    from the trainer's build (the pp precompute: K12 and K9 once each,
    transport off) through the final eval. Then 2 epochs of
    ``--rem-dtype none`` on the same trainer and tables."""
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer, configs
    from pipegcn_tpu_torch.ops import block_spmm as blk

    flags = ["--spmm-impl", "block", "--rem-dtype", "float8"]
    cli = train_cli(args, epochs=args.block_epochs, extra=flags)
    cnt = counters(spmm, halo)
    steps = {}
    reset_counts(cnt)
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30  # the eval CSRs
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log,
                            steps=steps)
    d = trainer.data
    st = d.block_stats
    steps["block_tables"] = d.block_build_s
    trainer.eval_cache = eval_cache
    t0 = time.monotonic()
    res = trainer.fit(eval_graphs, log_fn=log, inductive=True)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = read_counts(cnt)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = res["losses"]
    n_ep = cli.n_epochs
    coverage = sum(st["dense_edges"]) / max(sum(st["edges"]), 1)
    # the structural estimate (estimate_block_coverage, which JAX's auto
    # reads) at the same tile, hint and budget: the same split
    t0 = time.monotonic()
    estimate = blk.estimate_block_coverage(sg, 256, 602)
    est_s = time.monotonic() - t0
    per_tile = sum(st["dense_edges"]) / max(sum(st["blocks"]), 1)
    log(f"  block tables: {d.block_build_s:.1f}s, dense coverage "
        f"{coverage:.4f} (estimate_block_coverage {estimate:.4f} in "
        f"{est_s:.1f}s; {st['dense_edges']} of {st['edges']} edges), "
        f"blocks {st['blocks']} ({per_tile:.1f} dense edges a tile), A "
        f"{st['bits']}-bit ({t_dtype(d.block.a)}), {st['a_bytes']} bytes "
        f"a part")
    log(f"  block fit: {n_ep} epochs in {fit_s:.1f}s, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, best val "
        f"{res['best_val']:.4f}, test {res.get('test_acc', float('nan')):.4f},"
        f" launches {launches}, peak {peak_gib:.3f} GiB (held before the "
        f"build {base_gib:.3f} GiB)")
    require(len(losses) == n_ep, "block fit ran the wrong epoch count")
    require(all(math.isfinite(x) for x in losses),
            f"block: non-finite loss: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    require(last < first, f"block: loss did not fall: first-5 mean "
            f"{first:.4f}, last-5 mean {last:.4f}")
    require_launched(launches, "block", "block training run")
    want = {"block_dense": 3 * n_ep + 1, "block_dense_t": 3 * n_ep,
            "bucket_gather": 6 * n_ep + 1, "transport_cast": 6 * n_ep,
            "spmm_mean_t": 0, "part_amax": 0}
    require({k: launches[k] for k in want} == want,
            f"block: K12 must run 3 times an epoch (+1 for the pp "
            f"precompute), K13 3 times, K9 6 (+1), K10 6, K3 and K11 "
            f"never: {launches}, want {want}")
    require(coverage > 0.0 and min(st["blocks"]) > 0,
            f"block: no dense tiles on the cluster layout: {st}")
    require(estimate == coverage, f"block: estimate_block_coverage "
            f"{estimate} != the tables' coverage {coverage}")
    accs = (res["best_val"], res.get("test_acc", float("nan")))
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
            f"block: accuracies not finite: {accs}")
    # --rem-dtype none on the same trainer and tables
    vcli = train_cli(args, epochs=2, extra=flags[:2] + ["--rem-dtype",
                                                        "none"])
    base_cfg = trainer.cfg
    trainer.cfg = configs(vcli, sg)[0]
    reset_counts(cnt)
    ls = [trainer.train_epoch(n_ep + e) for e in range(2)]
    got = read_counts(cnt)
    trainer.cfg = base_cfg
    log(f"  block --rem-dtype none: losses {ls}, launches {got}")
    require(all(math.isfinite(x) for x in ls),
            "block --rem-dtype none: non-finite loss")
    want = {"block_dense": 6, "block_dense_t": 6, "bucket_gather": 12,
            "transport_cast": 0, "spmm_mean": 0, "spmm_mean_t": 0}
    require({k: got[k] for k in want} == want,
            f"block --rem-dtype none: launches {got}, want {want}")
    stats = {"epochs": n_ep, "losses": losses, "first5_mean": first,
             "last5_mean": last, "best_val": res["best_val"],
             "best_epoch": res["best_epoch"], "test_acc": res["test_acc"],
             "fit_s": fit_s, "epoch_time_s_mean": res["epoch_time"],
             "peak_mem_gib": peak_gib, "mem_before_build_gib": base_gib,
             "host_steps_s": steps, "launches": launches,
             "tables": {**st, "coverage": coverage,
                        "dense_edges_per_tile": per_tile,
                        "estimate_block_coverage": estimate,
                        "estimate_s": est_s,
                        "a_dtype": t_dtype(d.block.a),
                        "build_s": d.block_build_s},
             "rem_none": {"losses": ls, "launches": got}}
    return trainer, stats


def t_dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


def dense_csr(t, n_out, n_in, reverse):
    """One cuSPARSE CSR matrix of the dense tiles' edges over the
    block-diagonal parts, values the multiplicities: ``[P n_out, P n_in]``
    (the forward) or its transpose (``reverse``) — the sums K12 / K13
    take, as one PyTorch call (timed only) — and the dense edges, each
    counted as often as it occurs (the sum of the multiplicities)."""
    import torch
    from pipegcn_tpu_torch.ops import block_spmm as blk

    side, T = t.fwd, t.tile
    P = t.a.shape[0]
    rows, cols, vals = [], [], []
    for p in range(P):
        owner, blocks, tiles = blk._products(side, t.b_max, p,
                                             torch.device("cuda", 0))
        for i in range(0, owner.shape[0], 512):
            j = min(owner.shape[0], i + 512)
            a = blk._unpack(t.a[p].index_select(0, blocks[i:j]), t.packed)
            k, r, c = a.nonzero(as_tuple=True)
            vals.append(a[k, r, c])
            rows.append(owner[i:j][k] * T + r + p * n_out)
            cols.append(tiles[i:j][k] * T + c + p * n_in)
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    idx = torch.stack([c, r] if reverse else [r, c])
    size = (P * n_in, P * n_out) if reverse else (P * n_out, P * n_in)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, v, size).coalesce() \
            .to_sparse_csr(), int(v.sum())


def block_timings(trainer, blk, bs, dtype=None, remainder=True):
    """K12 and K13 at the cell's shape (F = 256; ms, plain ms, bound,
    cuSPARSE over the dense edges' CSR) and the tile-product floors; K9
    on the block trainer's remainder tables (e4m3 forward, e5m2
    backward). The bound is the least time of the function over the
    dense edges, counted as K1's and K9's are: the whole input read once,
    one int32 index per dense edge and a row pointer per output row (the
    dense edges' CSR), the output written once, and one add per dense
    edge and column. The bytes of the stored A blocks the pair lists read
    are the chosen representation's cost, not the function's: they are
    reported beside the bound (``a_bytes``, ``a_bytes_ms``), as are the
    floors of the tile products, 2 * pairs * T * T * F flops: over the
    bf16 tensor-core peak for one product an entry, three times that for
    K12 / K13's design (the three-term split of each input), and over the
    f32 CUDA-core peak. With ``dtype`` bf16 (K12 / K13's bf16 mode: one
    bf16 product an entry) the rows are bf16, the bytes shrink with them,
    the K9 remainder is not timed again, and no library call is timed (no
    single PyTorch call multiplies bf16 rows into f32 sums). On
    union-gather tables (K16 / K17) ``pairs`` counts the tile products
    (the (tile, union slot) entries with a block: the same products as
    group 1's pairs) beside ``union_slots``, the input tiles staged once
    a group; ``remainder`` False skips K9 (the remainder tables are the
    group-1 cell's)."""
    import torch

    d = trainer.data
    t = d.block
    P, n, R, F, T = d.num_parts, d.n_max, d.n_max + d.halo_size, 256, t.tile
    act, cot = transport_inputs(d, 25)
    gd = cot / d.in_deg[..., None]
    if dtype is not None:
        act, gd = act.to(dtype), gd.to(dtype)
    out = {}
    grouped = t.group > 1
    for name, side, x in ((("K16" if grouped else "K12"), t.fwd, act),
                          (("K17" if grouped else "K13"), t.bwd, gd)):
        fn = dense_fn(blk, side)
        a, e_dense = dense_csr(t, n, R, side.transpose)
        lib = lib_b = None
        if dtype is None:
            lib = time_ms(lambda: torch.sparse.mm(a, x.reshape(-1, F)))
            lib_b = batched_ms(lambda: torch.sparse.mm(a, x.reshape(-1, F)))
        del a
        pairs = sum(int(blk._products(side, t.b_max, p, x.device)[0]
                        .shape[0]) for p in range(P))
        a_bytes = pairs * t.a[0, 0].numel() * t.a.element_size()
        n_bytes = (x.numel() * x.element_size() + e_dense * 4
                   + P * (side.n_out + 1) * 4 + P * side.n_out * F * 4)
        tile_ops = 2 * pairs * T * T * F
        out[name] = dict(
            ms=time_ms(lambda: fn(x, t)),
            # 20 calls back to back (the card's time a call), beside the
            # library call's
            batched_ms=batched_ms(lambda: fn(x, t)),
            library_batched_ms=lib_b,
            plain_ms=time_ms(lambda: blk.block_dense_plain(x, t, side),
                             reps=3, warmup=1),
            library_ms=lib, bound=bound_ms(n_bytes, e_dense * F),
            a_bytes=a_bytes, a_bytes_ms=a_bytes / HBM_BYTES_PER_S * 1e3,
            tile_floor_bf16_tc_ms=tile_ops / BF16_TC_FLOP_PER_S * 1e3,
            tile_floor_split3_tc_ms=3 * tile_ops / BF16_TC_FLOP_PER_S * 1e3,
            tile_floor_f32_ms=tile_ops / F32_FLOP_PER_S * 1e3,
            shape=f"P={P} n_out={side.n_out} n_in={side.n_in} F={F} T={T} "
                  f"pairs={pairs} dense_edges={e_dense} "
                  f"A {t_dtype(t.a)}{' bits' if t.packed else ''} "
                  f"rows {t_dtype(x)}"
                  + (f" group={t.group} union_slots="
                     f"{int(side.ptr[:, -1].sum())}" if grouped else ""))
        if grouped:
            out[name]["union_slots"] = int(side.ptr[:, -1].sum())
            out[name]["pairs"] = pairs
    for name, side, x0, dt in () if dtype is not None or not remainder \
            else (
            ("K9 remainder forward e4m3", t.rem_fwd, act,
             torch.float8_e4m3fn),
            ("K9 remainder backward e5m2", t.rem_bwd, gd,
             torch.float8_e5m2)):
        x = bs.transport_cast_plain(x0, dt)[0]
        E = int((side.idx < side.n_src).sum())
        n_bytes = (x.numel() + E * 4 + side.inv.numel() * 4
                   + side.meta.numel() * 8 + P * side.n_out * F * 4)
        out[name] = dict(ms=time_ms(lambda: bs.bucket_gather(x, side)),
                         plain_ms=None, library_ms=None,
                         bound=bound_ms(n_bytes, E * F),
                         shape=f"P={P} n_src={side.n_src} "
                               f"n_out={side.n_out} F={F} entries={E} {dt}")
    for k, e in out.items():
        floors = ""
        if "tile_floor_f32_ms" in e:
            floors = (f", stored A {e['a_bytes']} bytes = "
                      f"{e['a_bytes_ms']:.3f} ms at the memory rate"
                      f", tile floors {e['tile_floor_bf16_tc_ms']:.3f} "
                      f"(bf16 tensor cores, one product) / "
                      f"{e['tile_floor_split3_tc_ms']:.3f} (three-term "
                      f"split) / {e['tile_floor_f32_ms']:.3f} (f32 CUDA "
                      f"cores)")
        batched = ""
        if "batched_ms" in e:
            batched = (f", back to back {e['batched_ms']:.3f} (library "
                       f"{e['library_batched_ms']})")
        log(f"  {k}: {e['ms']:.3f} ms (plain {e['plain_ms']}, library "
            f"{e['library_ms']}, bound {e['bound'][0]:.3f} "
            f"{e['bound'][1]}{batched}{floors}) [{e['shape']}]")
    return out


def block_epoch_split(trainer, cnt, kt, bt, tt, bucket_split):
    """The block epoch (median of 5 after one warm epoch) and its split by
    this run's kernel times: K12 (3 forward) and K13 (3 backward) at F =
    256, K9 on the remainder (3 + 3), K10 (3 + 3, the bucket cell's
    times: the same shapes), the comm kernels at the SAGE cell's times,
    the rest by subtraction; beside it the xla and bucket epochs of the
    same run."""
    import torch

    reset_counts(cnt)
    base = trainer.tcfg.n_epochs + 20
    epochs = iter(range(base, base + 100))
    reps = 5
    torch.cuda.reset_peak_memory_stats()
    epoch_ms = time_ms(lambda: trainer.train_epoch(next(epochs)), reps=reps,
                       warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_epoch = {k: v / (reps + 1) for k, v in read_counts(cnt).items()}
    k12, k13 = 3 * kt["K12"]["ms"], 3 * kt["K13"]["ms"]
    k9 = 3 * (kt["K9 remainder forward e4m3"]["ms"]
              + kt["K9 remainder backward e5m2"]["ms"])
    k10 = 3 * (bt["K10"]["forward e4m3"]["ms"]
               + bt["K10"]["backward e5m2"]["ms"])
    comm = (per_epoch["halo_gather"] * tt["K2"]["ms"]
            + per_epoch["halo_scatter"] * tt["K4"]["ms"]
            + per_epoch["halo_return"] * tt["K5"]["ms"])
    split = {"epoch_ms": epoch_ms, "k12_ms": k12, "k13_ms": k13,
             "k9_remainder_ms": k9, "k10_ms": k10, "comm_kernels_ms": comm,
             "rest_ms": epoch_ms - k12 - k13 - k9 - k10 - comm,
             "xla_epoch_ms": tt["epoch_ms"],
             "bucket_epoch_ms": bucket_split["epoch_ms"],
             "epoch_peak_mem_gib": peak, "launches_per_epoch": per_epoch}
    log(f"  block epoch {epoch_ms:.3f} ms median: K12 {k12:.3f} ms, K13 "
        f"{k13:.3f} ms, K9 (remainder) {k9:.3f} ms, K10 {k10:.3f} ms, comm "
        f"kernels {comm:.3f} ms, rest {split['rest_ms']:.3f} ms "
        f"({per_epoch}); peak {peak:.3f} GiB; the xla epoch "
        f"{tt['epoch_ms']:.3f} ms, the bucket epoch "
        f"{bucket_split['epoch_ms']:.3f} ms")
    return split


def table_serving_phase(ktrainer, btrainer, spmm, halo):
    """[23a] Serving through the trainers' aggregation, as the JAX engine
    serves: a ServingEngine on the block cell's staged parts and tables
    (``spmm_impl="block"``: K12 and K9 on the remainder) and one on the
    bucket cell's (``"bucket"``: K9), both over the shared parts, no new
    artifact and no new tables; beside them ``"xla"`` (K1) on the block
    cell's parts. GraphSAGE 602 -> 256 x3 -> 41, use_pp, LayerNorm,
    random weights; the config names ``--rem-dtype float8``, which the
    serving refresh must not take (the transport is off). Each engine's
    build (the use_pp precompute) and one refresh: the counts set to 0
    just before and read just after; the table kernels must grow, K1's
    must not. The logits within the serving tolerance of a recompute
    through the plain versions of the same aggregation; the refresh
    timed (median of 5)."""
    import torch
    from pipegcn_tpu_torch.models.sage import (ModelConfig, forward,
                                               init_params)
    from pipegcn_tpu_torch.parallel.staging import (precompute_pp,
                                                    table_spmm)
    from pipegcn_tpu_torch.serve import ServingEngine

    cnt = counters(spmm, halo)
    base = ktrainer.cfg
    out = {}
    for impl, trainer in (("block", ktrainer), ("bucket", btrainer),
                          ("xla", ktrainer)):
        d = trainer.data
        cfg = ModelConfig(layer_sizes=base.layer_sizes, use_pp=True,
                          norm="layer", dropout=0.0, spmm_impl=impl,
                          block_tile=trainer.cfg.block_tile,
                          block_group=trainer.cfg.block_group,
                          bucket_merge=trainer.cfg.bucket_merge,
                          rem_dtype="float8")
        params = init_params(cfg, torch.Generator().manual_seed(5),
                             d.device)
        reset_counts(cnt)
        t0 = time.monotonic()
        eng = ServingEngine(trainer.sg, d, cfg, params)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        built = read_counts(cnt)
        reset_counts(cnt)
        eng.refresh()
        torch.cuda.synchronize()
        got = read_counts(cnt)
        n_agg = cfg.n_layers - 1
        want = {"block": {"block_dense": n_agg, "bucket_gather": n_agg,
                          "spmm_mean": 0, "transport_cast": 0},
                "bucket": {"bucket_gather": n_agg, "spmm_mean": 0,
                           "block_dense": 0, "transport_cast": 0},
                "xla": {"spmm_mean": n_agg, "bucket_gather": 0,
                        "block_dense": 0}}[impl]
        cell = "block" if trainer is ktrainer else "bucket"
        log(f"  {impl} engine on the {cell} cell's staged parts: build (pp precompute) {build_s:.2f}s, "
            f"launches {({k: v for k, v in built.items() if v})}; one "
            f"refresh: {({k: v for k, v in got.items() if v})}")
        require({k: got[k] for k in want} == want,
                f"{impl} serving refresh: launches {got}, want {want}")
        pp_want = {k: min(v, 1) for k, v in want.items()}
        require({k: built[k] for k in pp_want} == pp_want,
                f"{impl} serving precompute: launches {built}, want "
                f"{pp_want}")
        logits = eng.logits
        require(bool(torch.isfinite(logits).all()),
                f"{impl} serving: non-finite logits")
        plain_spmm = table_spmm(d, cfg, plain=True) or spmm.spmm_mean_plain

        def plain_exchange(h, idx, mask):
            return halo.halo_gather_plain(h, idx, mask, with_inner=True)

        with torch.inference_mode():
            pp = precompute_pp(d, exchange=plain_exchange,
                               spmm_fn=plain_spmm)
            ref = forward(params, cfg, pp, d.indptr, d.edge_src, d.in_deg,
                          comm_update=lambda i, h: plain_exchange(
                              h, d.send_idx, d.send_mask),
                          spmm_fn=plain_spmm)
        del pp
        err = check_close(f"{impl} served logits vs plain recompute",
                          logits, ref, LOGITS_ATOL, LOGITS_RTOL)
        del ref
        refresh_ms = time_ms(eng.refresh, reps=5, warmup=1)
        log(f"  {impl} refresh {refresh_ms:.3f} ms (median of 5)")
        out[impl] = {"refresh_ms": refresh_ms, "engine_build_s": build_s,
                     "launches_build": built, "launches_refresh": got,
                     "logits_max_abs_err": err}
        del eng, logits
        torch.cuda.empty_cache()
    return out


def block_gcn_phase(args, sg, spmm, halo):
    """``--model gcn --spmm-impl block --rem-dtype float8`` (no use_pp)
    for a few pipelined epochs: finite, falling loss; K12 and K13 4 times
    an epoch (layer 0 at F = 602), K9 and K10 8 times. Then one epoch
    through the kernels held against the plain versions (``step_phase``:
    relu masks and the remainder's transported values shared)."""
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer

    n = args.block_gcn_epochs
    cli = train_cli(args, epochs=n, model="gcn", extra=[
        "--spmm-impl", "block", "--rem-dtype", "float8"])
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log)
    cnt = counters(spmm, halo)
    reset_counts(cnt)
    losses = [trainer.train_epoch(e) for e in range(n)]
    launches = read_counts(cnt)
    log(f"  block gcn: losses {losses}, launches {launches}")
    require(all(math.isfinite(x) for x in losses),
            "block gcn: non-finite loss")
    require(losses[-1] < losses[0], f"block gcn: loss did not fall: "
            f"{losses}")
    want = {"block_dense": 4 * n, "block_dense_t": 4 * n,
            "bucket_gather": 8 * n, "transport_cast": 8 * n,
            "spmm_mean": 0, "spmm_mean_t": 0}
    require({k: launches[k] for k in want} == want,
            f"block gcn: launches {launches}, want {want}")
    step = step_phase(trainer, n)
    return {"epochs": n, "losses": losses, "launches": launches,
            "block_tables_s": trainer.data.block_build_s,
            "step_check": step}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the bf16 phases: K4 in bf16, K2 / K5 on bf16 rows, the bf16 SAGE cells,
# K12 / K13's bf16 mode and the bf16 GAT cell (scripts/gat_bench.py)


def bf16_comm_phase(trainer, halo):
    """K4 in bf16 at the cell's shape (P = 2: one add a row, done in f32
    and rounded to bf16 once) and at P = 4 with rows repeated across
    distances (an add and a rounding a slot, in slot order): bit-exact
    against the plain version, which rounds at the same places; K2 (with
    and without the inner rows) and K5 bit-exact on bf16 rows."""
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(18)
    P, n_max, H = d.num_parts, d.n_max, d.halo_size
    bf = torch.bfloat16
    full = torch.randn((P, n_max + H, 256), generator=gen,
                       device="cuda").to(bf)
    bg = torch.randn((P, H, 256), generator=gen, device="cuda").to(bf)
    got = halo.scatter_bgrad(full[:, :n_max], bg, *d.inverse)
    require(got.dtype == bf, "K4 bf16: output is not bf16")
    check_bits("K4 bf16 P=2 F=256 (cell)", got, halo.scatter_bgrad_plain(
        full[:, :n_max], bg, *d.inverse))
    want = (full[:, :n_max].float() + halo.scatter_bgrad(
        torch.zeros_like(full[:, :n_max]).float(), bg.float(),
        *d.inverse)).to(bf)
    check_bits("K4 bf16 P=2 F=256 (cell) vs round_bf16(g + inj) in f32",
               got, want)
    for F in (3, 256):
        P4, n4, B4 = 4, 64, 40
        idx = torch.stack([torch.stack([
            torch.randperm(n4, generator=gen, device="cuda")[:B4]
            for _ in range(P4 - 1)]) for _ in range(P4)]).int()
        mask = torch.rand((P4, P4 - 1, B4), generator=gen,
                          device="cuda") < 0.8
        ptr, slot = halo.send_csr(idx.cpu().numpy(), mask.cpu().numpy(), n4)
        ptr, slot = torch.from_numpy(ptr).cuda(), torch.from_numpy(slot).cuda()
        g = torch.randn((P4, n4, F), generator=gen, device="cuda").to(bf)
        b = torch.randn((P4, (P4 - 1) * B4, F), generator=gen,
                        device="cuda").to(bf)
        check_bits(f"K4 bf16 P=4 F={F} (repeated rows)",
                   halo.scatter_bgrad(g, b, ptr, slot),
                   halo.scatter_bgrad_plain(g, b, ptr, slot))
    h = torch.randn((P, n_max, 256), generator=gen, device="cuda").to(bf)
    for inner in (False, True):
        check_bits(f"K2 bf16 F=256 (cell, inner rows {inner})",
                   halo.halo_gather(h, d.send_idx, d.send_mask, inner),
                   halo.halo_gather_plain(h, d.send_idx, d.send_mask,
                                          inner))
    check_bits("K5 bf16 F=256 (cell, strided view)",
               halo.return_blocks(full[:, n_max:], d.b_max),
               halo.return_blocks_plain(full[:, n_max:], d.b_max))
    return 0.0


def k4_bf16_timing(trainer, halo):
    """K4 in bf16 at the cell's shape beside its plain version, the
    library call (one bf16 index_add) and its bound (bytes: half the f32
    mode's; one add an injected element)."""
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(19)
    P, n_max, H, F = d.num_parts, d.n_max, d.halo_size, 256
    bf = torch.bfloat16
    full = torch.randn((P, n_max + H, F), generator=gen,
                       device="cuda").to(bf)
    gi = full[:, :n_max]
    bg = torch.randn((P, H, F), generator=gen, device="cuda").to(bf)
    ptr, slot = d.inverse
    m = d.send_mask.reshape(P, -1)
    rows = torch.cat([d.send_idx[p].reshape(-1)[m[p]].long() + p * n_max
                      for p in range(P)])
    vals = torch.cat([bg[p][m[p]] for p in range(P)])
    gflat = gi.contiguous().reshape(P * n_max, F)
    nnz = int(rows.numel())
    n_bytes = 2 * P * n_max * F * 2 + nnz * F * 2 + ptr.numel() * 4 + nnz * 4
    out = dict(ms=time_ms(lambda: halo.scatter_bgrad(gi, bg, ptr, slot)),
               plain_ms=time_ms(lambda: halo.scatter_bgrad_plain(
                   gi, bg, ptr, slot), reps=3, warmup=1),
               library_ms=time_ms(lambda: torch.index_add(gflat, 0, rows,
                                                          vals)),
               bound=bound_ms(n_bytes, nnz * F),
               shape=f"P={P} n_max={n_max} H={H} nnz={nnz} F={F} bf16")
    log(f"  K4 bf16: {out['ms']:.3f} ms (plain {out['plain_ms']:.3f}, "
        f"index_add {out['library_ms']:.3f}, bound {out['bound'][0]:.3f} "
        f"{out['bound'][1]})")
    return out


def switch_dtype(trainer, vcli, sg):
    """Run ``trainer`` on ``vcli``'s config from here on, on the same
    staged graph and tables: the variant's ModelConfig swapped in (as the
    bucket cell's variants are), the features cast to its compute dtype
    (after the f32 pp precompute, as Trainer does) and the comm carry
    started anew in its dtypes."""
    from pipegcn_tpu_torch.cli.main import configs

    trainer.cfg = configs(vcli, sg)[0]
    trainer.feat = trainer.feat.to(trainer.cfg.compute_dtype)
    trainer.comm = trainer._init_comm()


def bf16_epochs(label, trainer, cnt, epoch0, n, want, modes):
    """``n`` epochs of a bf16 cell with the counts set to 0 just before
    and read just after: finite losses, the launches ``want`` a kernel an
    epoch and, for the kernels with row-type modes, ``modes`` (kernel ->
    mode -> an epoch); then one epoch held against the plain versions
    (``step_phase``)."""
    import math

    import torch

    reset_counts(cnt)
    t0 = time.monotonic()
    losses = [trainer.train_epoch(epoch0 + e) for e in range(n)]
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    got, got_modes = read_counts(cnt), read_modes(cnt)
    log(f"  {label}: {n} epochs in {secs:.1f}s, losses {losses}, launches "
        f"{got}, by row type {got_modes}")
    require(all(math.isfinite(x) for x in losses),
            f"{label}: non-finite loss")
    require({k: got[k] for k in want} == {k: v * n for k, v in want.items()},
            f"{label}: launches {got}, want {want} an epoch")
    for k, per in modes.items():
        require({m: got_modes[k][m] for m in per}
                == {m: v * n for m, v in per.items()},
                f"{label}: {k} launches by row type {got_modes[k]}, want "
                f"{per} an epoch")
    step = step_phase(trainer, epoch0 + n)
    reset_counts(cnt)
    more = iter(range(epoch0 + n + 10, epoch0 + n + 100))
    epoch_ms = time_ms(lambda: trainer.train_epoch(next(more)), reps=5,
                       warmup=1)
    per_epoch = {k: v / 6 for k, v in read_counts(cnt).items()}
    log(f"  {label}: epoch {epoch_ms:.3f} ms median ({per_epoch})")
    return {"epochs": n, "losses": losses, "seconds": secs,
            "launches": got, "launches_by_mode": got_modes,
            "step_check": step, "epoch_ms": epoch_ms,
            "launches_per_epoch": per_epoch}


def bf16_split(label, stats, kernel_ms):
    """A bf16 cell's epoch split: ``kernel_ms`` (kernel -> this run's ms
    of one launch at the cell's shapes, or an estimate where noted) times
    its launches an epoch, the rest by subtraction."""
    per = stats["launches_per_epoch"]
    parts = {k: per[k] * ms for k, ms in kernel_ms.items()}
    rest = stats["epoch_ms"] - sum(parts.values())
    log(f"  {label} epoch {stats['epoch_ms']:.3f} ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", rest {rest:.3f} ms")
    stats["split"] = {"kernels_ms": parts, "rest_ms": rest}


def k1_bf16_timing(trainer, spmm, halo):
    """K1 on bf16 rows (the bf16 xla cell's aggregation input) at the
    cell's shape: ms, plain ms and the bound (the rows' bytes halve; the
    operations do not); no single PyTorch call gathers bf16 rows into f32
    means, so no library time."""
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(26)
    P, n_max, F = d.num_parts, d.n_max, 256
    h = torch.randn((P, n_max, F), generator=gen,
                    device="cuda").to(torch.bfloat16)
    fbuf = halo.halo_exchange(h, d.send_idx, d.send_mask)
    args = (d.indptr, d.edge_src, d.in_deg)
    n_edges = sum(int(d.indptr[p, -1]) for p in range(P))
    n_bytes = (fbuf.numel() * 2 + n_edges * 4 + d.indptr.numel()
               * d.indptr.element_size() + d.in_deg.numel() * 4
               + P * n_max * F * 4)
    plan = spmm.k1_plan(fbuf.shape[1], F, 2, spmm._l2_bytes(fbuf.device),
                        fbuf.data_ptr())
    out = dict(ms=time_ms(lambda: spmm.spmm_mean(fbuf, *args)),
               whole_ms=time_ms(lambda: spmm.k1_launch(fbuf, *args,
                                                       plan=(F, 0))),
               plan=list(plan),
               plain_ms=time_ms(lambda: spmm.spmm_mean_plain(fbuf, *args),
                                reps=3, warmup=1),
               library_ms=None,
               bound=bound_ms(n_bytes, n_edges * F + P * n_max * F),
               shape=f"P={P} n_out={n_max} n_src={fbuf.shape[1]} F={F} "
                     f"edges={n_edges} bf16 rows")
    log(f"  K1 on bf16 rows: {out['ms']:.3f} ms at W={plan[0]} "
        f"vec={plan[1]}, {out['whole_ms']:.3f} at S = 1 (plain "
        f"{out['plain_ms']:.3f}, bound {out['bound'][0]:.3f} "
        f"{out['bound'][1]})")
    return out


def bf16_sage_xla_phase(args, sg, spmm, halo):
    """``scripts/reddit.sh --dtype bfloat16`` (xla: K1 on bf16 rows, K3 on
    the f32 cotangent with d_fbuf cast to bf16 once, K4 in bf16, K2 / K5
    on bf16 rows) through cli/main.py's trainer for a few epochs, then
    its step check."""
    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer

    cli = train_cli(args, epochs=args.bf16_epochs, dtype="bfloat16")
    cnt = counters(spmm, halo)
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log)
    require(trainer.feat.dtype == torch.bfloat16, "bf16 xla: features")
    stats = bf16_epochs(
        "bf16 xla", trainer, cnt, 0, args.bf16_epochs,
        {"spmm_mean": 3, "spmm_mean_t": 3, "halo_gather": 3,
         "halo_return": 3, "halo_scatter": 3, "bucket_gather": 0},
        {"halo_scatter": {"bfloat16": 3, "float32": 0}})
    return stats, k1_bf16_timing(trainer, spmm, halo)


def block_bf16_checks(trainer, blk):
    """K12 and K13's bf16 mode against the plain version (which widens the
    same bf16 rows): at the cell's shapes (F = 256 and 602) and on the
    edge cases (ragged tiles at F = 5 and 64, one tile of ones), each
    rerun bit-identical; then a flipped A bit must fail both."""
    import torch

    d = trainer.data
    t = d.block
    gen = torch.Generator(device="cuda").manual_seed(34)
    R = d.n_max + d.halo_size
    bf = torch.bfloat16
    errs = []
    for F in (256, 602):
        x = torch.randn((d.num_parts, R, F), generator=gen,
                        device="cuda").to(bf)
        errs.append(block_check(f"K12 bf16 mode cell F={F}", blk, x, t,
                                t.fwd))
        g = torch.randn((d.num_parts, d.n_max, F), generator=gen,
                        device="cuda").to(bf)
        errs.append(block_check(f"K13 bf16 mode cell F={F}", blk, g, t,
                                t.bwd))
        del x, g
    T = 256
    gb = torch.Generator().manual_seed(5)
    bits = torch.randint(0, 256, (1, 4, T, T // 8), generator=gb,
                         dtype=torch.uint8)
    ragged = block_tables_of(bits, True, T, [(0, 0, 0), (0, 1, 2),
                                             (1, 2, 1), (1, 3, 2),
                                             (1, 0, 0)], 300, 700)
    ones = block_tables_of(torch.full((1, 1, T, T // 8), 255,
                                      dtype=torch.uint8), True, T,
                           [(0, 0, 0)], T, T)
    for label, tb, widths in (("ragged tiles", ragged, (5, 64)),
                              ("256 x 256 ones", ones, (256,))):
        for F in widths:
            for side in (tb.fwd, tb.bwd):
                x = torch.randn((1, side.n_in, F), generator=gen,
                                device="cuda").to(bf)
                errs.append(block_check(
                    f"{'K13' if side.transpose else 'K12'} bf16 mode "
                    f"{label} F={F}", blk, x, tb, side))
    block_fault_phase(blk, trainer, dtype=bf)
    return max(errs)


def bf16_gat_phase(args, sg, eval_graphs, eval_cache, spmm, halo):
    """This slice's cell: ``scripts/gat_bench.py``'s configuration through
    cli/main.py's functions (``--model gat --n-heads 4 --n-layers 4
    --n-hidden 256 --dtype bfloat16 --spmm-impl bucket --rem-dtype
    float8`` with reddit.sh's ``--inductive --enable-pipeline``, dropout
    0.5, Adam lr 0.01, LayerNorm) on the SAGE cell's parts, sharing its
    eval-graph CSRs, counts from the trainer's build through the final
    eval: a finite, falling loss, finite accuracies, K6 (e4m3 z rows) and
    K8 (e5m2 cotangent rows) 4 times an epoch, K10 8 times (z and g of
    each layer), K4 in bf16; then 2 epochs each of ``--rem-dtype
    bfloat16`` and ``none`` on the same trainer."""
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer, configs

    flags = ["--spmm-impl", "bucket", "--rem-dtype", "float8"]
    n_ep = args.bf16_gat_epochs
    cli = train_cli(args, epochs=n_ep, model="gat", extra=flags,
                    dtype="bfloat16")
    cnt = counters(spmm, halo)
    steps = {}
    reset_counts(cnt)
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log,
                            steps=steps)
    trainer.eval_cache = eval_cache
    t0 = time.monotonic()
    res = trainer.fit(eval_graphs, log_fn=log, inductive=True,
                      reference_logs=True)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches, modes = read_counts(cnt), read_modes(cnt)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = res["losses"]
    log(f"  bf16 gat fit: {n_ep} epochs in {fit_s:.1f}s, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, best val "
        f"{res['best_val']:.4f}, test {res.get('test_acc', float('nan')):.4f}"
        f", launches {launches}, by row type {modes}, peak {peak_gib:.3f} "
        f"GiB (held before the build {base_gib:.3f} GiB)")
    require(trainer.feat.dtype == torch.bfloat16
            and trainer.comm["halo"]["1"].dtype == torch.bfloat16,
            "bf16 gat: features and carries must be bf16")
    require(len(losses) == n_ep and all(math.isfinite(x) for x in losses),
            f"bf16 gat: losses {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    require(last < first, f"bf16 gat: loss did not fall: first-5 mean "
            f"{first:.4f}, last-5 mean {last:.4f}")
    require_launched(launches, "gat", "bf16 gat training run")
    require(launches["gat_bwd_src"] == 4 * n_ep
            and modes["gat_bwd_src"]["gat_attn_fp8"] == 4 * n_ep
            and launches["transport_cast"] == 8 * n_ep
            and modes["gat_fwd"]["gat_attn_fp8"] == 4 * n_ep
            and modes["halo_scatter"]["bfloat16"] >= 3 * n_ep
            and modes["halo_scatter"]["float32"] == 0,
            f"bf16 gat: K8 and K6 (e4m3 / e5m2 rows) 4 times an epoch, "
            f"K10 8 times, K4 in bf16: {launches} {modes}")
    accs = (res["best_val"], res.get("test_acc", float("nan")))
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
            f"bf16 gat: accuracies not finite: {accs}")
    variants = {}
    base_cfg = trainer.cfg
    for i, (rem, k10, per_mode) in enumerate((
            ("bfloat16", 8, {"gat_attn_bf16": 4}),
            ("none", 0, {"gat_attn_bf16": 3, "gat_attn": 1}))):
        vcli = train_cli(args, epochs=2, model="gat", dtype="bfloat16",
                         extra=flags[:2] + ["--rem-dtype", rem])
        trainer.cfg = configs(vcli, sg)[0]
        reset_counts(cnt)
        ls = [trainer.train_epoch(n_ep + 2 * i + e) for e in range(2)]
        got, got_modes = read_counts(cnt), read_modes(cnt)
        log(f"  bf16 gat --rem-dtype {rem}: losses {ls}, launches {got}, "
            f"by row type {got_modes}")
        require(all(math.isfinite(x) for x in ls),
                f"bf16 gat --rem-dtype {rem}: non-finite loss")
        require(got["transport_cast"] == 2 * k10
                and {m: got_modes["gat_fwd"][m] for m in per_mode}
                == {m: 2 * v for m, v in per_mode.items()}
                and {m: got_modes["gat_bwd_src"][m] for m in per_mode}
                == {m: 2 * v for m, v in per_mode.items()},
                f"bf16 gat --rem-dtype {rem}: launches {got} {got_modes}")
        variants[rem] = {"losses": ls, "launches": got,
                         "launches_by_mode": got_modes}
        for k, fn in cnt.items():  # the cell's run: every launch counts
            launches[k] += got[k]
            for m in getattr(fn, "by_mode", {}):
                modes[k][m] += got_modes[k][m]
    trainer.cfg = base_cfg
    stats = {"epochs": n_ep, "losses": losses, "first5_mean": first,
             "last5_mean": last, "best_val": res["best_val"],
             "best_epoch": res["best_epoch"], "test_acc": res["test_acc"],
             "fit_s": fit_s, "epoch_time_s_mean": res["epoch_time"],
             "peak_mem_gib": peak_gib, "mem_before_build_gib": base_gib,
             "host_steps_s": steps, "launches": launches,
             "launches_by_mode": modes, "variants": variants}
    return trainer, stats


def bf16_gat_split(trainer, cnt, g16, g8, gf, k4b, tt):
    """The bf16 GAT epoch (median of 5 after one warm epoch, the cell's
    float8 transport) and its split by this run's kernel times: K6 and K8
    in the e4m3 / e5m2 row types at dh = 64 (layers 0-2) and 41 (the
    logits layer), K10 8 times (the bucket cell's f32 -> e4m3 time at F =
    256 for each: an estimate), K4 in bf16, K2 / K5 at their f32 times
    (an upper estimate: the rows are half as wide), the rest by
    subtraction."""
    reset_counts(cnt)
    base = trainer.tcfg.n_epochs + 20
    epochs = iter(range(base, base + 100))
    reps = 5
    epoch_ms = time_ms(lambda: trainer.train_epoch(next(epochs)), reps=reps,
                       warmup=1)
    per_epoch = {k: v / (reps + 1) for k, v in read_counts(cnt).items()}
    attn_ms = sum(3 * g8[k][64]["ms"] + g8[k][41]["ms"]
                  for k in ("K6", "K8"))
    comm_ms = (per_epoch["halo_gather"] * tt["K2"]["ms"]
               + per_epoch["halo_scatter"] * k4b["ms"]
               + per_epoch["halo_return"] * tt["K5"]["ms"])
    split = {"epoch_ms": epoch_ms, "attention_kernels_ms": attn_ms,
             "comm_kernels_ms": comm_ms,
             "rest_ms": epoch_ms - attn_ms - comm_ms,
             "launches_per_epoch": per_epoch}
    log(f"  bf16 gat epoch {epoch_ms:.3f} ms median: K6+K8 (e4m3/e5m2) "
        f"{attn_ms:.3f} ms, comm kernels {comm_ms:.3f} ms, rest "
        f"{split['rest_ms']:.3f} ms ({per_epoch}); the same kernels in "
        f"bf16 rows {sum(3 * g16[k][64]['ms'] + g16[k][41]['ms'] for k in ('K6', 'K8')):.3f} ms, "
        f"in f32 {sum(3 * gf[k][64]['ms'] + gf[k][41]['ms'] for k in ('K6', 'K8')):.3f} ms")
    return split


# ---------------------------------------------------------------------------
# the union-gather block + fp8 halo wire cell: K14 / K15 (the compressed
# halo wire, ops/csrc/halo_wire.cu) and K16 / K17 (the union-gather tile
# products, ops/csrc/block_tma.cu)

WIRE_FLAGS = ["--spmm-impl", "block", "--block-group", "4", "--rem-dtype",
              "float8", "--halo-dtype", "float8"]


def wire_check(name, halo, x, idx, mask, b_max, dt):
    """K14 (fp8 wires) and K15 against their plain versions on one input,
    the exchange (``idx`` given) or the return: the blocks' amaxes, the
    decoded halo, the wire payload and the inverse scales bit-exact (NaN
    equal to any NaN); a rerun bit-identical. Returns the kernels' ``(amax,
    halo, wire, inv)``."""
    import torch
    from pipegcn_tpu_torch.ops.bucket_spmm import F8_MAX

    amax = amax_p = None
    if dt in F8_MAX:
        amax = halo.halo_amax(x, idx, mask, b_max)
        amax_p = halo.halo_amax_plain(x, idx, mask, b_max)
        check_cast(f"{name}: K14 amax", amax, amax_p)
    got = halo.halo_wire(x, idx, mask, b_max, dt, amax)
    ref = halo.halo_wire_plain(x, idx, mask, b_max, dt, amax_p)
    for part, g, r in zip(("halo", "wire", "inverse scales"), got, ref):
        if r is not None:
            check_cast(f"{name}: K15 {part}", g, r)
    again = halo.halo_wire(x, idx, mask, b_max, dt, amax)
    require(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                for a, b in zip(got, again) if a is not None),
            f"{name}: a rerun of K15 is not bit-identical")
    return (amax,) + tuple(got)


def wire_dtypes():
    import torch

    return (torch.float8_e4m3fn, torch.float8_e5m2, torch.bfloat16)


def k14_k15_cell_phase(trainer, halo):
    """K14 / K15 at the cell's shapes: the exchange of [P, n_max, 256]
    rows through the send lists and the return of [P, H, 256] boundary
    gradients (a strided view of a [P, n_max + H, 256] cotangent, as the
    probe's is), on bf16 rows (the cell's) and f32 rows, in the wires the
    cell runs (e4m3 / e5m2 and bf16)."""
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(51)
    P, n, H = d.num_parts, d.n_max, d.halo_size
    for rows in (torch.bfloat16, torch.float32):
        h = (torch.randn((P, n, 256), generator=gen, device="cuda")
             * 2.0).to(rows)
        full = (torch.randn((P, n + H, 256), generator=gen, device="cuda")
                * 1e-3).to(rows)
        for dt in (torch.float8_e4m3fn, torch.bfloat16):
            wire_check(f"exchange {t_dtype(h)} rows -> {str(dt)[6:]} (cell)",
                       halo, h, d.send_idx, d.send_mask, d.b_max, dt)
        for dt in (torch.float8_e5m2, torch.bfloat16):
            wire_check(f"return {t_dtype(h)} rows -> {str(dt)[6:]} (cell)",
                       halo, full[:, n:], None, None, d.b_max, dt)
        del h, full


def wire_p4_case(seed, F=48):
    """An emulated P = 4 set of send lists on a small graph (2,000 nodes,
    4 random parts) with each sender's rows scaled by 8**d, d the least
    distance that sends them, so that a sender's blocks take different
    scales at different distances (a per-part scale would not do);
    returns ``(x, send_idx, send_mask, b_max)`` on the card."""
    import torch
    from pipegcn_tpu_torch.graph.synthetic import synthetic_graph
    from pipegcn_tpu_torch.partition.halo import ShardedGraph
    from pipegcn_tpu_torch.partition.partitioner import partition_graph

    g = synthetic_graph(num_nodes=2000, avg_degree=6, n_feat=4, n_class=3,
                        seed=seed)
    sg = ShardedGraph.build(g, partition_graph(g, 4, method="random",
                                               seed=seed), n_parts=4)
    idx = torch.from_numpy(sg.send_idx).cuda()
    mask = torch.from_numpy(sg.send_mask).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((4, sg.n_max, F), generator=gen, device="cuda")
    for s in range(4):
        scale = torch.ones(sg.n_max, device="cuda")
        for d in range(3, 0, -1):  # the least distance's scale wins
            scale[idx[s, d - 1][mask[s, d - 1]].long()] = 8.0 ** d
        x[s] *= scale[:, None]
    return x, idx, mask, sg.b_max


def k15_edge_phase(halo):
    """K14 / K15 bit-exact on the vector's edge cases, P = 3, f32 and bf16
    rows, every wire: F = 1, 3, 41 and 602 (vectors of 1 or 2 elements),
    the exchange and the return from a contiguous block and from a
    strided view whose part stride and base are no multiple of 16 bytes
    (F = 42); B = 5, less than a block's chunk of rows; every row masked
    (the halo exact +0, scale 1)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(53)
    P, n = 3, 40

    def case(F, B, p_mask=0.8):
        x = torch.randn((P, n, F), generator=gen, device="cuda") * 3.0
        idx = torch.randint(-2, n + 2, (P, P - 1, B), generator=gen,
                            device="cuda", dtype=torch.int32)
        mask = torch.rand((P, P - 1, B), generator=gen,
                          device="cuda") < p_mask
        full = torch.randn((P, 1 + (P - 1) * B, F), generator=gen,
                           device="cuda")
        return x, idx, mask, full

    for F, B, p_mask in ((1, 12, 0.8), (3, 12, 0.8), (41, 12, 0.8),
                         (602, 12, 0.8), (42, 12, 0.8), (64, 5, 0.8),
                         (64, 12, 0.0)):
        x, idx, mask, full = case(F, B, p_mask)
        for rows in (torch.float32, torch.bfloat16):
            xr, fr = x.to(rows), full.to(rows)
            for dt in wire_dtypes():
                tag = (f"F={F} B={B}{' all masked' if p_mask == 0 else ''} "
                       f"{t_dtype(xr)} rows -> {str(dt)[6:]}")
                _, out, _, inv = wire_check(f"vector edge case {tag}", halo,
                                            xr, idx, mask, B, dt)
                if p_mask == 0:
                    require(bool((out.float() == 0).all())
                            and not bool(torch.signbit(out.float()).any())
                            and (inv is None or bool((inv == 1).all())),
                            f"vector edge case {tag}: an all-masked "
                            f"exchange must give +0 and scale 1")
                wire_check(f"vector edge case {tag} return", halo,
                           fr[:, 1:].contiguous(), None, None, B, dt)
                view = fr[:, 1:]  # part stride (1 + (P-1) B) F elements
                wire_check(f"vector edge case {tag} return, strided view "
                           f"(part stride {view.stride(0) * fr.element_size()}"
                           f" bytes)", halo, view, None, None, B, dt)


def k14_k15_check_phase(trainer, halo):
    """K14 / K15 bit-exact against their plain versions: at the cell's
    shapes; on an emulated P = 4 set whose per-block scales differ across
    distances, every wire (e4m3, e5m2, bf16) on f32 and bf16 rows, both
    directions; on edge cases (an all-masked block, a zero-amax block, a
    NaN row, the f32 bit-pattern sweep around the fp8 saturation points
    and subnormals in blocks that hold a NaN, so their scale is 1); on
    the vector's edge cases (``k15_edge_phase``). A planted fault, the
    decode with the receiver's own scale in place of the sender's, must
    fail the K15 check."""
    import torch
    from pipegcn_tpu_torch.ops import bucket_spmm as bs

    k14_k15_cell_phase(trainer, halo)
    k15_edge_phase(halo)
    x, idx, mask, B = wire_p4_case(7)
    sc = bs.pow2_scale(halo.halo_amax(x, idx, mask, B), 448.0)
    require(bool((sc != sc[:, :1]).any()),
            f"P = 4 set: a sender's blocks should take different scales "
            f"at different distances: {sc.tolist()}")
    log(f"  P = 4 set: per-block scales {sc.tolist()}")
    P = 4
    g = torch.randn((P, (P - 1) * B, x.shape[2]), device="cuda") * \
        (8.0 ** torch.arange(1, P, device="cuda").repeat_interleave(B)
         )[None, :, None] * 1e-4
    for rows in (torch.float32, torch.bfloat16):
        for dt in wire_dtypes():
            res = wire_check(f"P=4 exchange {t_dtype(x.to(rows))} rows -> "
                             f"{str(dt)[6:]}", halo, x.to(rows), idx, mask,
                             B, dt)
            wire_check(f"P=4 return {t_dtype(x.to(rows))} rows -> "
                       f"{str(dt)[6:]}", halo, g.to(rows), None, None, B,
                       dt)
            if dt == torch.float8_e4m3fn and rows == torch.float32:
                planted = res
    # the planted fault: each receiver decodes with its own scale at that
    # distance (that of the block it sends there), not its sender's
    _, out, wire, inv = planted
    snd = halo._senders(P, True).cuda()
    col = torch.arange(P - 1, device="cuda")[None, :]
    own = torch.empty_like(inv)
    own[snd, col] = inv  # inv in sender order: receiver r's own block
    bad = (wire.float() * own[..., None, None]).reshape(out.shape)
    require(not torch.equal(own, inv), "P = 4 set: the receivers' own "
            "scales equal their senders': the fault would not show")
    must_fail("K15 planted fault (decoded with the receiver's own scale)",
              lambda: check_cast("K15 planted fault", bad, out))
    # edge cases on P = 3: an all-masked block, a zero-amax block (its
    # rows zero, mask on) and a NaN row
    gen = torch.Generator(device="cuda").manual_seed(52)
    P, n, B, F = 3, 40, 12, 64
    x = torch.randn((P, n, F), generator=gen, device="cuda") * 3.0
    idx = torch.randint(0, n, (P, P - 1, B), generator=gen, device="cuda",
                        dtype=torch.int32)
    mask = torch.rand((P, P - 1, B), generator=gen, device="cuda") < 0.8
    mask[0, 1] = False                        # all masked
    x[1, idx[1, 0].long()] = 0.0              # block (1, d=1): amax 0
    mask[1, 0, 0] = True
    x[2, int(idx[2, 0, 3])] = float("nan")    # block (2, d=1): a NaN row
    mask[2, 0, 3] = True
    g = torch.randn((P, (P - 1) * B, F), generator=gen, device="cuda")
    g[0, B:2 * B] = 0.0                       # sender 0's block d=2
    g[2, 5, 7] = float("nan")
    for rows in (torch.float32, torch.bfloat16):
        for dt in wire_dtypes():
            amax, out, _, inv = wire_check(
                f"edge cases {t_dtype(x.to(rows))} rows -> {str(dt)[6:]}",
                halo, x.to(rows), idx, mask, B, dt)
            # receivers of the all-masked (0, d=2) and zero (1, d=1)
            # blocks: (0 + 2) mod 3 slot 1, (1 + 1) mod 3 slot 0
            for r, d1 in ((2, 1), (2, 0)):
                blk = out[r, d1 * B:(d1 + 1) * B]
                require(bool((blk.float() == 0).all())
                        and not bool(torch.signbit(blk.float()).any()),
                        f"edge cases {dt}: an all-masked or zero block is "
                        f"not exact +0")
            if inv is not None:
                require(float(inv[2, 0]) == 1.0 and float(inv[0, 0]) == 1.0
                        and bool(torch.isnan(amax[2, 0])),
                        f"edge cases {dt}: a zero or NaN amax must give "
                        f"scale 1 ({inv.tolist()}, {amax.tolist()})")
                require(bool(torch.isnan(out[0, :B].float()).any()),
                        f"edge cases {dt}: the NaN row must stay NaN")
            wire_check(f"edge cases return {t_dtype(x.to(rows))} rows -> "
                       f"{str(dt)[6:]}", halo, g.to(rows), None, None, B,
                       dt)
    # the bit-pattern sweep: 2 parts, every row sent, each block holding
    # NaNs (scale 1: the casts meet the saturation points unscaled)
    sweep = cast_sweep()[0]
    R = sweep.shape[0]
    xs = torch.stack([sweep, -sweep])
    si = torch.arange(R, device="cuda", dtype=torch.int32).repeat(2, 1, 1)
    sm = torch.ones((2, 1, R), dtype=torch.bool, device="cuda")
    for rows in (torch.float32, torch.bfloat16):
        for dt in wire_dtypes():
            wire_check(f"sweep {t_dtype(xs.to(rows))} rows -> {str(dt)[6:]}",
                       halo, xs.to(rows), si, sm, R, dt)
            wire_check(f"sweep return {t_dtype(xs.to(rows))} rows -> "
                       f"{str(dt)[6:]}", halo, xs.to(rows), None, None, R,
                       dt)


def group_side(entries, n_o, n_i, transpose, g, b_max, tile):
    """One part's GroupSide on the card from ``entries`` [(group, input
    tile, [block or None for each of the g tiles])] in list order, over
    ``n_o`` output and ``n_i`` input rows."""
    import torch
    from pipegcn_tpu_torch.ops import block_spmm as blk

    entries = sorted(entries, key=lambda q: q[0])  # stable
    ptr = [0] * (-(-n_o // (tile * g)) + 1)
    for q in entries:
        ptr[q[0] + 1] += 1
    for i in range(1, len(ptr)):
        ptr[i] += ptr[i - 1]
    til = [q[1] for q in entries] or [0]
    bl = [[b_max if b is None else b for b in q[2]]
          for q in entries] or [[b_max] * g]
    put = (lambda v: torch.tensor([v], dtype=torch.int32,
                                  device="cuda"))  # noqa: E731
    return blk.GroupSide(ptr=put(ptr), tile=put(til), blk=put(bl), group=g,
                         n_out=n_o, n_in=n_i, n_out_tiles=-(-n_o // tile),
                         transpose=transpose)


def grouped_tables_of(a, G, slots, n_out, n_in, tile=256):
    """BlockTables of one part on the card over hand-made union groups:
    ``slots`` [(group, input tile, [block or None for each of the G
    tiles])] in list order; the transpose lists hold the same products
    keyed by input tile, one group a tile. No remainder."""
    from pipegcn_tpu_torch.ops import block_spmm as blk

    b_max = a.shape[1]
    # the transpose: each input tile's products, one "group" of 1 a tile
    tr = sorted((t, g * G + d, b) for g, t, bs in slots
                for d, b in enumerate(bs) if b is not None)
    bwd = group_side([(t, o, [b]) for t, o, b in tr], n_in, n_out, True, 1,
                     b_max, tile)
    return blk.BlockTables(
        a=a.cuda(), packed=True, tile=tile,
        fwd=group_side(slots, n_out, n_in, False, G, b_max, tile), bwd=bwd,
        rem_fwd=None, rem_bwd=None)


def k16_k17_check_phase(trainer, blk, halo):
    """K16 / K17 against their plain version within BLOCK_SUM_RTOL *
    sum|terms| (f32 rows) and in the bf16 mode, each rerun bit-identical:
    at the cell's shapes (group 4, 1-bit A; F = 256 and 602); for every A
    encoding (int8, bf16, f32 from planted multigraphs, group 4); at
    groups 2 and 8; on hand-made groups (a tail group of one tile with a
    ragged last row tile, an empty group, a one-tile union, pads inside a
    union) at F = 5 and 64. A flipped A bit must fail both, in both
    modes."""
    import torch

    d = trainer.data
    t = d.block
    gen = torch.Generator(device="cuda").manual_seed(53)
    R = d.n_max + d.halo_size
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        for F in (256, 602):
            x = torch.randn((d.num_parts, R, F), generator=gen,
                            device="cuda").to(dt)
            errs.append(block_check(f"K16 cell F={F} {t_dtype(x)} rows",
                                    blk, x, t, t.fwd))
            gc = torch.randn((d.num_parts, d.n_max, F), generator=gen,
                             device="cuda").to(dt)
            errs.append(block_check(f"K17 cell F={F} {t_dtype(gc)} rows",
                                    blk, gc, t, t.bwd))
            del x, gc

    def both(label, tb, F, dtype):
        for side in (tb.fwd, tb.bwd):
            x = torch.randn((tb.a.shape[0], side.n_in, F), generator=gen,
                            device="cuda").to(dtype)
            errs.append(block_check(
                f"{'K17' if side.transpose else 'K16'} {label} F={F} "
                f"{t_dtype(x)} rows", blk, x, tb, side))

    for dup, group, want_bits in ((3, 4, 8), (200, 4, 16), (300, 4, 32),
                                  (3, 2, 8), (3, 8, 8)):
        tb, st = planted_multigraph_tables(dup, seed=dup, group=group)
        require(st["bits"] == want_bits and tb.group == group,
                f"planted multigraph x{dup} group {group}: {st['bits']}-bit"
                f" A, group {tb.group}")
        for dtype in (torch.float32, torch.bfloat16):
            both(f"{t_dtype(tb.a)} A group {group}", tb, 256, dtype)
    T = 256
    gb = torch.Generator().manual_seed(5)
    a = torch.randint(0, 256, (1, 6, T, T // 8), generator=gb,
                      dtype=torch.uint8)
    # 5 output tiles (the last ragged: 212 rows) in 2 groups of 4: group
    # 0 has two slots (pads inside), group 1 (the tail: tile 4 only) a
    # one-tile union; output tile 3 has no block; 3 input tiles
    slots = [(0, 2, [0, None, 1, None]), (0, 0, [None, 2, None, None]),
             (1, 1, [3, None, None, None])]
    hand = grouped_tables_of(a, 4, slots, 5 * T - 44, 3 * T - 68)
    empty = grouped_tables_of(a, 4, [], 5 * T - 44, 3 * T - 68)
    for dtype in (torch.float32, torch.bfloat16):
        for F in (5, 64):
            both("hand-made groups", hand, F, dtype)
        for side in (empty.fwd, empty.bwd):
            x = torch.randn((1, side.n_in, 64), generator=gen,
                            device="cuda").to(dtype)
            out = dense_fn(blk, side)(x, empty)
            require(out.shape == (1, side.n_out, 64)
                    and not bool(out.any()),
                    "K16/K17 empty groups: output is not all zeros")
    log("  K16 / K17 empty groups: zeros ok")
    for dtype in (None, torch.bfloat16):
        block_fault_phase(blk, trainer, dtype=dtype)
    tile_split_phase(trainer, blk)
    errs.append(k16_edge_phase(blk))
    errs.append(k17_edge_phase(blk))
    return max(errs)


def random_groups(T, G, n_tiles, n_in_t, seed, empty=(), extra=()):
    """Hand-made union slots [(group, input tile, blocks)] over ``n_tiles``
    output tiles (the last group a tail where G does not divide it): each
    group but those in ``empty`` ~5 slots of distinct random input tiles,
    each of its tiles a block with probability 0.5 (one at least), then
    the slots of ``extra`` [(group, input tile, tiles with a block)];
    every product its own block. Returns ``(slots, n_blocks)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    slots, nb = [], 0
    for g in range(-(-n_tiles // G)):
        live = [d for d in range(G) if g * G + d < n_tiles]
        rows = []
        if g not in empty:
            for t in rng.choice(n_in_t, min(5, n_in_t), replace=False):
                use = [d for d in live if rng.random() < 0.5] or live[:1]
                rows.append((int(t), use))
        rows += [(t, use) for gg, t, use in extra if gg == g]
        for t, use in rows:
            bs = [None] * G
            for d in use:
                bs[d] = nb
                nb += 1
            slots.append((g, t, bs))
    return slots, max(nb, 1)


def k16_edge_phase(blk):
    """K16's TMA / wgmma path on hand-made union groups against the plain
    version (BLOCK_SUM_RTOL * sum|terms|, each rerun bit-identical), f32
    rows and the bf16 mode: T = 32, 96, 224 (224: a tile's second CTA
    ragged, 96 rows past T) and 256; groups of 2, 4, 8 and 16; f32 rows at
    F = 602 (a padded split plane); bf16 rows with F % 8 != 0 (the
    pre-pass's padded copy) and F % 8 == 0 (read as they are); a tail
    group of 5 tiles, an empty group, a slot none of the first 8 tiles of
    a 16-tile group uses and a slot no tile uses. One flipped A bit must
    fail the check."""
    import dataclasses

    import torch

    gen = torch.Generator(device="cuda").manual_seed(57)
    gb = torch.Generator().manual_seed(7)
    errs = []
    cases = (
        # T, G, output tiles, input tiles, [(F, row dtype)], empty, extra
        (32, 2, 7, 9, [(64, torch.float32), (64, torch.bfloat16),
                       (5, torch.bfloat16)], (), ()),
        (96, 4, 10, 7, [(602, torch.float32), (100, torch.bfloat16)], (1,),
         ()),
        (224, 8, 11, 6, [(256, torch.float32), (256, torch.bfloat16),
                         (602, torch.float32), (5, torch.bfloat16)], (), ()),
        (256, 16, 37, 6, [(256, torch.float32), (100, torch.bfloat16)],
         (1,), ((0, 5, list(range(8, 16))), (0, 4, []))),
        (128, 4, 9, 5, [(130, torch.float32)], (), ()),
    )
    for T, G, n_t, n_in_t, runs, empty, extra in cases:
        slots, nb = random_groups(T, G, n_t, n_in_t, seed=T + G,
                                  empty=empty, extra=extra)
        a = torch.randint(0, 256, (1, nb, T, T // 8), generator=gb,
                          dtype=torch.uint8)
        tb = grouped_tables_of(a, G, slots, n_t * T - 20, n_in_t * T - 30,
                               tile=T)
        for F, dt in runs:
            x = torch.randn((1, tb.fwd.n_in, F), generator=gen,
                            device="cuda").to(dt)
            errs.append(block_check(
                f"K16 edge T={T} G={G} F={F} {t_dtype(x)} rows "
                f"({len(slots)} slots)", blk, x, tb, tb.fwd))
        if T == 96:
            b = next(q for q in slots[0][2] if q is not None)
            bad = dataclasses.replace(tb, a=tb.a.clone())
            bad.a[0, b, 7, 3] ^= 1 << 5
            x = torch.randn((1, tb.fwd.n_in, 64), generator=gen,
                            device="cuda")
            got = blk.block_dense_grouped(x, bad)
            ref = blk.block_dense_plain(x, tb, tb.fwd)
            abs_sum = blk.block_dense_plain(x.abs(), tb, tb.fwd)
            must_fail("K16 edge planted fault (one A bit flipped, T=96)",
                      lambda: check_close("K16 edge planted fault", got,
                                          ref, BLOCK_ATOL, 0.0, abs_sum,
                                          BLOCK_SUM_RTOL))
    return max(errs)


def k17_edge_phase(blk):
    """K17 on csrc/block_tma.cu over hand-made transposed union groups
    (``bwd``: groups of output tiles, each slot an input tile and A^T's
    blocks) against the plain version (BLOCK_SUM_RTOL * sum|terms|, each
    rerun bit-identical), f32 rows and the bf16 mode: T = 32, 96, 128, 160,
    224 and 256; groups of 1, 2, 4, 8 and 16; 1-bit, int8 and bf16 A; f32
    rows at F = 602 (a padded split plane) and 130, bf16 rows with F % 8
    != 0 (the pre-pass's padded copy) and F % 8 == 0 (read as they are); a
    tail group, an empty group, a slot none of the first 8 tiles of a
    16-tile group uses and a slot no tile uses. Two planted faults must
    fail in every A encoding: one A entry changed, and the same products
    with A read untransposed (the forward kernel over the transposed
    lists: ``fwd`` holds them marked untransposed). Returns the largest
    |difference|."""
    import dataclasses

    import torch

    gen = torch.Generator(device="cuda").manual_seed(67)
    gb = torch.Generator().manual_seed(13)
    errs = []
    f32, bf = torch.float32, torch.bfloat16
    cases = (
        # T, G, A encoding, output tiles, input tiles, [(F, row dtype)],
        # empty groups, extra slots
        (32, 2, "bits", 7, 9, [(64, f32), (64, bf), (5, bf)], (), ()),
        (96, 4, "bits", 10, 7, [(602, f32), (100, bf)], (1,), ()),
        (96, 4, "int8", 6, 5, [(64, f32), (64, bf)], (), ()),
        (160, 2, "bf16", 5, 4, [(130, f32), (100, bf)], (), ()),
        (224, 8, "bits", 11, 6, [(256, f32), (256, bf), (5, bf)], (), ()),
        (256, 16, "bits", 37, 6, [(256, f32), (100, bf)], (1,),
         ((0, 5, list(range(8, 16))), (0, 4, []))),
        (128, 1, "int8", 9, 5, [(130, f32)], (), ()),
    )
    faulted = set()
    for T, G, enc, n_t, n_in_t, runs, empty, extra in cases:
        slots, nb = random_groups(T, G, n_t, n_in_t, seed=T + G + 1,
                                  empty=empty, extra=extra)
        if enc == "bits":
            a = torch.randint(0, 256, (1, nb, T, T // 8), generator=gb,
                              dtype=torch.uint8)
        elif enc == "int8":
            a = torch.randint(0, 4, (1, nb, T, T), generator=gb,
                              dtype=torch.int8)
        else:
            a = torch.randint(0, 3, (1, nb, T, T), generator=gb).to(bf)
        side = group_side(slots, n_t * T - 20, n_in_t * T - 30, True, G, nb,
                          T)
        tb = blk.BlockTables(a=a.cuda(), packed=enc == "bits", tile=T,
                             fwd=dataclasses.replace(side, transpose=False),
                             bwd=side, rem_fwd=None, rem_bwd=None)
        require(blk.tile_entry(True, True, tb.a.dtype)
                == "pgt_block_grouped_tma", f"K17 T={T} {enc} A: not "
                "routed to block_tma.cu")
        for F, dt in runs:
            x = torch.randn((1, side.n_in, F), generator=gen,
                            device="cuda").to(dt)
            errs.append(block_check(
                f"K17 edge T={T} G={G} {enc} A F={F} {t_dtype(x)} rows "
                f"({len(slots)} slots)", blk, x, tb, side))
        if enc in faulted:
            continue
        faulted.add(enc)
        x = torch.randn((1, side.n_in, 64), generator=gen, device="cuda")
        ref = blk.block_dense_plain(x, tb, side)
        abs_sum = blk.block_dense_plain(x.abs(), tb, side)
        b = next(q for q in slots[0][2] if q is not None)
        bad = dataclasses.replace(tb, a=tb.a.clone())
        if enc == "bits":
            bad.a[0, b, 7, 3] ^= 1 << 5  # A[7, 29]: output row 29
        else:
            bad.a[0, b, 7, 29] += 1
        for label, got in (
                ("one A entry changed", blk.block_dense_grouped_t(x, bad)),
                ("A read untransposed", blk.block_dense_grouped(x, tb))):
            name = f"K17 edge planted fault [{enc} A, T={T}] ({label})"
            must_fail(name, lambda: check_close(
                name, got, ref, BLOCK_ATOL, 0.0, abs_sum, BLOCK_SUM_RTOL))
    require(faulted == {"bits", "int8", "bf16"}, "K17 edge faults: an A "
            f"encoding untested ({sorted(faulted)})")
    log(f"  K17 on block_tma.cu, edge cases: worst |diff| {max(errs):.3e}")
    return max(max(errs), k13_edge_cases(blk, gen, gb))


def k13_edge_cases(blk, gen, gb):
    """K13 on csrc/block_tma.cu (the transposed products over the
    backward's pair lists, their union view at G = 1) over hand-made pair
    lists against the plain version (BLOCK_SUM_RTOL * sum|terms|, each
    rerun bit-identical): T = 32, 96, 160, 224 and 256; 1-bit, int8 and
    bf16 A; f32 rows (F = 602: a padded split plane; 64, 130, 256) and bf16
    rows (F = 5, 100: a padded copy; 64, 256: read as they are); an output
    tile with no pairs (zeros). In every A encoding one A entry changed
    and A read untransposed (K12's forward over the same lists) must
    fail. Returns the largest |difference|."""
    import dataclasses

    import torch

    errs = []
    f32, bf = torch.float32, torch.bfloat16
    cases = (
        # T, A encoding, output tiles, input tiles, [(F, row dtype)]
        (32, "bits", 7, 9, [(64, f32), (64, bf), (5, bf)]),
        (96, "int8", 6, 5, [(602, f32), (100, bf)]),
        (160, "bf16", 5, 4, [(130, f32), (64, bf)]),
        (224, "bits", 6, 5, [(256, f32), (100, bf)]),
        (256, "bits", 9, 6, [(256, f32), (256, bf)]),
        (256, "int8", 4, 3, [(64, f32)]),
        (128, "bf16", 3, 5, [(256, bf)]),
    )
    faulted = set()
    for T, enc, n_t, n_in_t, runs in cases:
        slots, nb = random_groups(T, 1, n_t, n_in_t, seed=3 * T + 1,
                                  empty=(1,))
        if enc == "bits":
            a = torch.randint(0, 256, (1, nb, T, T // 8), generator=gb,
                              dtype=torch.uint8)
        elif enc == "int8":
            a = torch.randint(0, 4, (1, nb, T, T), generator=gb,
                              dtype=torch.int8)
        else:
            a = torch.randint(0, 3, (1, nb, T, T), generator=gb).to(bf)
        g1 = group_side(slots, n_t * T - 20, n_in_t * T - 30, True, 1, nb, T)
        side = blk.BlockSide(ptr=g1.ptr, blk=g1.blk[..., 0].contiguous(),
                             tile=g1.tile, n_out=g1.n_out, n_in=g1.n_in,
                             transpose=True)
        tb = blk.BlockTables(a=a.cuda(), packed=enc == "bits", tile=T,
                             fwd=dataclasses.replace(side, transpose=False),
                             bwd=side, rem_fwd=None, rem_bwd=None)
        require(blk.tile_entry(False, True, tb.a.dtype)
                == "pgt_block_grouped_tma", f"K13 T={T} {enc} A: not "
                "routed to block_tma.cu")
        for F, dt in runs:
            x = torch.randn((1, side.n_in, F), generator=gen,
                            device="cuda").to(dt)
            errs.append(block_check(
                f"K13 edge T={T} {enc} A F={F} {t_dtype(x)} rows "
                f"({len(slots)} pairs)", blk, x, tb, side))
            got = blk.block_dense_t(x, tb)
            require(bool((got[0, T:2 * T] == 0).all()),
                    f"K13 edge T={T}: the tile with no pairs is not zeros")
        if enc in faulted:
            continue
        faulted.add(enc)
        x = torch.randn((1, side.n_in, 64), generator=gen, device="cuda")
        ref = blk.block_dense_plain(x, tb, side)
        abs_sum = blk.block_dense_plain(x.abs(), tb, side)
        b = slots[0][2][0]
        bad = dataclasses.replace(tb, a=tb.a.clone())
        if enc == "bits":
            bad.a[0, b, 7, 3] ^= 1 << 5  # A[7, 29]: output row 29
        else:
            bad.a[0, b, 7, 29] += 1
        for label, got in (
                ("one A entry changed", blk.block_dense_t(x, bad)),
                ("A read untransposed", blk.block_dense(x, tb))):
            name = f"K13 edge planted fault [{enc} A, T={T}] ({label})"
            must_fail(name, lambda: check_close(
                name, got, ref, BLOCK_ATOL, 0.0, abs_sum, BLOCK_SUM_RTOL))
    require(faulted == {"bits", "int8", "bf16"}, "K13 edge faults: an A "
            f"encoding untested ({sorted(faulted)})")
    log(f"  K13 on block_tma.cu, edge cases: worst |diff| {max(errs):.3e}")
    return max(errs)


def tile_split_phase(trainer, blk):
    """K16's pre-pass bit-exact against its plain version on the wire
    cell's rows (f32 at F = 256 and 602) and on the finite patterns of the
    f32 bit-pattern sweep (near the fp8 limits, subnormals, zeros, near
    the largest finite); bf16 rows with F % 8 != 0 (the padded copy)."""
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(59)
    R = d.n_max + d.halo_size
    for F in (256, 602):
        x = torch.randn((d.num_parts, R, F), generator=gen, device="cuda")
        check_bits(f"K16 pre-split F={F} (cell rows)", blk.tile_split(x),
                   blk.tile_split_plain(x))
        del x
    sw = cast_sweep()
    sw = torch.where(torch.isfinite(sw), sw, torch.zeros_like(sw))
    check_bits("K16 pre-split (finite bit-pattern sweep)",
               blk.tile_split(sw), blk.tile_split_plain(sw))
    xb = torch.randn((2, 1000, 100), generator=gen,
                     device="cuda").to(torch.bfloat16)
    check_bits("K16 pre-split bf16 rows F=100", blk.tile_split(xb),
               blk.tile_split_plain(xb))


def wire_train_phase(args, sg, eval_graphs, eval_cache, spmm, halo):
    """This slice's cell: the reddit.sh command plus ``--dtype bfloat16
    --spmm-impl block --block-group 4 --rem-dtype float8 --halo-dtype
    float8`` through cli/main.py's functions on the SAGE cell's parts,
    sharing its eval-graph CSRs; counts from the trainer's build (the pp
    precompute: K16 on f32 rows, K9 and K2 once each) through the final
    eval: a finite, falling loss, finite accuracies, K16 / K17 in the bf16
    mode 3 times an epoch, K9 6 and K10 6, K14 and K15 6 (the exchange
    and the return of 3 layers: e4m3 and e5m2), K4 in bf16, K5 and the
    group-1 kernels never. Then 2 epochs each of ``--halo-dtype
    bfloat16`` (K15 bf16, no K14) and ``none`` (K2 and K5 again) on the
    same trainer and tables (the train config swapped)."""
    import dataclasses
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer

    n_ep = args.wire_epochs
    cli = train_cli(args, epochs=n_ep, extra=WIRE_FLAGS, dtype="bfloat16")
    cnt = counters(spmm, halo)
    steps = {}
    reset_counts(cnt)
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log,
                            steps=steps)
    d = trainer.data
    st = d.block_stats
    steps["block_tables"] = d.block_build_s
    trainer.eval_cache = eval_cache
    t0 = time.monotonic()
    res = trainer.fit(eval_graphs, log_fn=log, inductive=True,
                      reference_logs=True)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches, modes = read_counts(cnt), read_modes(cnt)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = res["losses"]
    slots = {k: int(s.ptr[:, -1].sum()) for k, s in (("fwd", d.block.fwd),
                                                     ("bwd", d.block.bwd))}
    pairs = sum(st["blocks"])
    log(f"  wire cell tables: {d.block_build_s:.1f}s, group "
        f"{d.block.group}, {pairs} dense blocks, union slots fwd "
        f"{slots['fwd']} / bwd {slots['bwd']} ({slots['fwd'] / pairs:.3f}"
        f" / {slots['bwd'] / pairs:.3f} of the pairs)")
    log(f"  wire fit: {n_ep} epochs in {fit_s:.1f}s, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, best val "
        f"{res['best_val']:.4f}, test {res.get('test_acc', float('nan')):.4f}"
        f", launches {launches}, by mode {modes}, peak {peak_gib:.3f} GiB "
        f"(held before the build {base_gib:.3f} GiB); halo wire "
        f"{trainer.est_halo_bytes_per_epoch()} bytes an epoch "
        f"({trainer.est_halo_bytes_per_epoch(compressed=False)} in bf16)")
    require(trainer.feat.dtype == torch.bfloat16
            and trainer.comm["halo"]["1"].dtype == torch.bfloat16,
            "wire cell: features and carries must be bf16")
    require(len(losses) == n_ep and all(math.isfinite(x) for x in losses),
            f"wire cell: losses {losses}")
    first, last = (sum(losses[:3]) / 3, sum(losses[-3:]) / 3)
    require(last < first, f"wire cell: loss did not fall: first-3 mean "
            f"{first:.4f}, last-3 mean {last:.4f}")
    require_launched(launches, "wire", "wire cell training run")
    want = {"block_dense_grouped": 3 * n_ep + 1,
            "block_dense_grouped_t": 3 * n_ep, "bucket_gather": 6 * n_ep + 1,
            "transport_cast": 6 * n_ep, "halo_amax": 6 * n_ep,
            "halo_wire": 6 * n_ep, "halo_gather": 1, "halo_return": 0,
            "block_dense": 0, "block_dense_t": 0, "part_amax": 0,
            "spmm_mean_t": 0}
    want_modes = {
        "block_dense_grouped": {"bfloat16": 3 * n_ep, "float32": 1},
        "block_dense_grouped_t": {"bfloat16": 3 * n_ep, "float32": 0},
        "halo_wire": {"float8_e4m3fn": 3 * n_ep, "float8_e5m2": 3 * n_ep,
                      "bfloat16": 0},
        "halo_amax": {"exchange": 3 * n_ep, "return": 3 * n_ep},
        "halo_scatter": {"bfloat16": 3 * n_ep, "float32": 0}}
    require({k: launches[k] for k in want} == want
            and all(modes[k] == v for k, v in want_modes.items()),
            f"wire cell: launches {launches} {modes}, want {want} "
            f"{want_modes}")
    accs = (res["best_val"], res.get("test_acc", float("nan")))
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
            f"wire cell: accuracies not finite: {accs}")
    variants = {}
    base_tcfg = trainer.tcfg
    for i, (hd, want) in enumerate((
            ("bfloat16", {"halo_wire": 12, "halo_amax": 0,
                          "halo_gather": 0, "halo_return": 0}),
            ("none", {"halo_wire": 0, "halo_amax": 0, "halo_gather": 6,
                      "halo_return": 6}))):
        trainer.tcfg = dataclasses.replace(base_tcfg, halo_dtype=hd)
        reset_counts(cnt)
        ls = [trainer.train_epoch(n_ep + 2 * i + e) for e in range(2)]
        got, got_modes = read_counts(cnt), read_modes(cnt)
        log(f"  wire cell --halo-dtype {hd}: losses {ls}, launches {got}, "
            f"by mode {got_modes}")
        require(all(math.isfinite(x) for x in ls),
                f"wire cell --halo-dtype {hd}: non-finite loss")
        require({k: got[k] for k in want} == want
                and got["block_dense_grouped"] == 6,
                f"wire cell --halo-dtype {hd}: launches {got}, want {want}")
        variants[hd] = {"losses": ls, "launches": got,
                        "launches_by_mode": got_modes}
        for k, fn in cnt.items():  # the cell's run: every launch counts
            launches[k] += got[k]
            for m in getattr(fn, "by_mode", {}):
                modes[k][m] += got_modes[k][m]
    trainer.tcfg = base_tcfg
    stats = {"epochs": n_ep, "losses": losses, "first3_mean": first,
             "last3_mean": last, "best_val": res["best_val"],
             "best_epoch": res["best_epoch"], "test_acc": res["test_acc"],
             "fit_s": fit_s, "epoch_time_s_mean": res["epoch_time"],
             "peak_mem_gib": peak_gib, "mem_before_build_gib": base_gib,
             "host_steps_s": steps, "launches": launches,
             "launches_by_mode": modes, "variants": variants,
             "tables": {**st, "union_slots": slots, "pairs": pairs,
                        "build_s": d.block_build_s},
             "halo_bytes_per_epoch": trainer.est_halo_bytes_per_epoch(),
             "halo_bytes_per_epoch_bf16":
                 trainer.est_halo_bytes_per_epoch(compressed=False)}
    return trainer, stats


def wire_group_variants(args, sg, spmm, halo):
    """The slice's command at ``--block-group`` 2, 4 and 8 and both compute
    dtypes: for each group a trainer built at f32 (its own tables, the f32
    pp precompute) runs 2 epochs, then the same trainer and tables at
    bf16 (``switch_dtype``: the features cast as Trainer casts them, the
    carries anew) 2 more; counts set to 0 before each build: finite
    losses, K16 / K17 3 times an epoch in the row type of the compute
    dtype (K16 once more for the pp precompute), K14 and K15 6 times, the
    group-1 kernels never. Returns the launches by kernel and mode over
    all six runs, and each run's losses and union slots."""
    import math

    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer

    cnt = counters(spmm, halo)
    total = {k: 0 for k in cnt}
    total_modes = {k: dict.fromkeys(fn.by_mode, 0) for k, fn in cnt.items()
                   if hasattr(fn, "by_mode")}
    runs = {}
    for group in (2, 4, 8):
        flags = [f if f != "4" else str(group) for f in WIRE_FLAGS]
        reset_counts(cnt)
        trainer = build_trainer(train_cli(args, epochs=2, extra=flags),
                                sg, torch.device("cuda", 0), log=log)
        d = trainer.data
        require(d.block.group == group, f"group {group}: tables of group "
                f"{d.block.group}")
        for dtype in ("float32", "bfloat16"):
            if dtype == "bfloat16":
                switch_dtype(trainer, train_cli(args, epochs=2, extra=flags,
                                                dtype=dtype), sg)
            ls = [trainer.train_epoch(e) for e in range(2)]
            got, modes = read_counts(cnt), read_modes(cnt)
            pp = 1 if dtype == "float32" else 0  # the build's precompute
            want = {"block_dense_grouped": 6 + pp,
                    "block_dense_grouped_t": 6, "halo_amax": 12,
                    "halo_wire": 12, "block_dense": 0, "block_dense_t": 0,
                    "halo_return": 0}
            log(f"  group {group} {dtype}: losses {ls}, launches {got}")
            require(all(math.isfinite(x) for x in ls)
                    and {k: got[k] for k in want} == want
                    and modes["block_dense_grouped_t"][dtype] == 6
                    and modes["block_dense_grouped"][dtype] == 6 + pp,
                    f"group {group} {dtype}: losses {ls}, launches {got} "
                    f"{modes}, want {want}")
            runs[f"group {group} {dtype}"] = {
                "losses": ls, "union_slots": int(d.block.fwd.ptr[:, -1]
                                                 .sum()),
                "pairs": sum(d.block_stats["blocks"])}
            for k in cnt:
                total[k] += got[k]
                for m in total_modes.get(k, {}):
                    total_modes[k][m] += modes[k][m]
            reset_counts(cnt)
        del trainer, d
        torch.cuda.empty_cache()
    return {"launches": total, "launches_by_mode": total_modes,
            "runs": runs}


def wire_timings(trainer, halo):
    """K14 and K15 at the cell's shapes on bf16 rows (ms, plain ms, the
    bound): the exchange's amax and e4m3 wire over the send lists, the
    return's amax and e5m2 wire over the [P, H, 256] cotangent, and K15's
    bf16 wire both ways. The bound counts the sent rows' bytes once (a
    masked row is never read), the send lists, the amaxes, the wire
    payload and the decoded rows written once, and an operation an
    element for K14 (|x| and the max), four for K15 (the scale, the two
    casts, the decode). No single PyTorch call computes either function
    (a gather, a per-block amax, a scaled saturating cast, a permute and
    a decode): no library time."""
    import torch

    d = trainer.data
    gen = torch.Generator(device="cuda").manual_seed(54)
    P, n, H, B, F = d.num_parts, d.n_max, d.halo_size, d.b_max, 256
    bf = torch.bfloat16
    h = (torch.randn((P, n, F), generator=gen, device="cuda") * 2.0).to(bf)
    full = (torch.randn((P, n + H, F), generator=gen, device="cuda")
            * 1e-3).to(bf)
    g = full[:, n:]
    sent = int(d.send_mask.sum())
    lists = d.send_idx.numel() * 4 + d.send_mask.numel()
    out = {}
    for name, x, idx, mask, rows_read in (
            ("exchange", h, d.send_idx, d.send_mask, sent),
            ("return", g, None, None, P * H)):
        extra = lists if idx is not None else 0
        out[f"K14 {name}"] = dict(
            ms=time_ms(lambda: halo.halo_amax(x, idx, mask, B)),
            plain_ms=time_ms(lambda: halo.halo_amax_plain(x, idx, mask, B),
                             reps=5, warmup=1),
            library_ms=None,
            bound=bound_ms(rows_read * F * 2 + extra + P * (P - 1) * 4,
                           2 * rows_read * F),
            shape=f"P={P} B={B} F={F} bf16 rows, {rows_read} rows read")
        amax = halo.halo_amax(x, idx, mask, B)
        for dt in ((torch.float8_e4m3fn if name == "exchange"
                    else torch.float8_e5m2), bf):
            a = amax if dt != bf else None
            wb = torch.tensor([], dtype=dt).element_size()
            out[f"K15 {name} {str(dt)[6:]}"] = dict(
                ms=time_ms(lambda: halo.halo_wire(x, idx, mask, B, dt, a)),
                plain_ms=time_ms(lambda: halo.halo_wire_plain(
                    x, idx, mask, B, dt, a), reps=5, warmup=1),
                library_ms=None,
                bound=bound_ms(rows_read * F * 2 + extra
                               + (P * (P - 1) * 8 if a is not None else 0)
                               + P * H * F * (wb + 2),
                               4 * P * H * F),
                shape=f"P={P} B={B} F={F} bf16 rows -> {dt}, "
                      f"{rows_read} rows read")
    for k, e in out.items():
        log(f"  {k}: {e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, bound "
            f"{e['bound'][0]:.3f} {e['bound'][1]}; no single library "
            f"call) [{e['shape']}]")
    return out


def wire_epoch_split(trainer, cnt, wt, gt16, kt, bt, k4b, block_ms):
    """The wire cell's epoch (median of 5 after one warm epoch, the
    cell's float8 wire) and its split by this run's kernel times at the
    cell's shapes: K16 and K17 in the bf16 mode 3 times each, K9 on the
    remainder 6 (the f32 block cell's: the same tables and e4m3 / e5m2
    rows), K10 6 (the bucket cell's f32-input times: an upper estimate),
    K14 and K15 3 times each way, K4 in bf16, the rest by subtraction;
    the peak memory."""
    import torch

    reset_counts(cnt)
    base = trainer.tcfg.n_epochs + 20
    epochs = iter(range(base, base + 100))
    reps = 5
    torch.cuda.reset_peak_memory_stats()
    epoch_ms = time_ms(lambda: trainer.train_epoch(next(epochs)), reps=reps,
                       warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_epoch = {k: v / (reps + 1) for k, v in read_counts(cnt).items()}
    parts = {
        "k16_ms": 3 * gt16["K16"]["ms"], "k17_ms": 3 * gt16["K17"]["ms"],
        "k9_remainder_ms": 3 * (kt["K9 remainder forward e4m3"]["ms"]
                                + kt["K9 remainder backward e5m2"]["ms"]),
        "k10_ms": 3 * (bt["K10"]["forward e4m3"]["ms"]
                       + bt["K10"]["backward e5m2"]["ms"]),
        "k14_ms": 3 * (wt["K14 exchange"]["ms"] + wt["K14 return"]["ms"]),
        "k15_ms": 3 * (wt["K15 exchange float8_e4m3fn"]["ms"]
                       + wt["K15 return float8_e5m2"]["ms"]),
        "k4_bf16_ms": per_epoch["halo_scatter"] * k4b["ms"]}
    split = {"epoch_ms": epoch_ms, **parts,
             "rest_ms": epoch_ms - sum(parts.values()),
             "epoch_peak_mem_gib": peak, "launches_per_epoch": per_epoch}
    log(f"  wire cell epoch {epoch_ms:.3f} ms median: "
        + ", ".join(f"{k[:-3]} {v:.3f} ms" for k, v in parts.items())
        + f", rest {split['rest_ms']:.3f} ms ({per_epoch}); peak "
        f"{peak:.3f} GiB; this run's group-1 block epochs (no wire): "
        f"{block_ms}")
    split["group1_block_epochs_ms"] = block_ms
    return split


# ---------------------------------------------------------------------------
# phases 34-37: the integrity plane (--integrity-check-every, the bitflip
# drills, the wire guard) and K19


def records(buf, event=None):
    """The JSONL records a ``MetricsLogger`` wrote into ``buf``."""
    recs = [json.loads(x) for x in buf.getvalue().splitlines()]
    return [r for r in recs if event is None or r["event"] == event]


def require_checks_ok(recs, what):
    """Every integrity verdict ok and none skipped (a Freivalds exception
    is reported as an ok with "skipped: ...", as JAX reports it)."""
    integ = [r for r in recs if r["event"] == "integrity"]
    require(integ, f"{what}: no integrity record")
    bad = [r for r in integ if r["outcome"] != "ok"
           or str(r.get("detail", "")).startswith("skipped")]
    require(not bad, f"{what}: checks not ok or skipped: {bad}")
    return integ


def freivalds_launches(trainer, cnt, epoch=1):
    """Freivalds' device half alone, the counts set to 0 around it: the
    kernels the aggregation check ran (at F = 1)."""
    import numpy as np
    import torch

    r = np.random.default_rng(epoch).integers(
        0, 2, size=int(trainer.feat.shape[-1])).astype(np.float32) * 2 - 1
    reset_counts(cnt)
    from pipegcn_tpu_torch.resilience import IntegrityPlane

    IntegrityPlane(1)._freivalds_device(trainer, r)
    torch.cuda.synchronize()
    return read_counts(cnt)


def integrity_cell_phase(args, sg, eval_graphs, eval_cache, spmm, halo):
    """[34] The reddit.sh command plus ``--integrity-check-every 2``
    through cli/main.py's functions on the shared parts, the counts set to
    0 before the build and read after the final eval: every check ok and
    none skipped, K19 (all three forms) and the SAGE path's kernels
    launched; Freivalds' device half runs K2 and K1 once each at F = 1;
    the median epoch with no check, with the boundary (dynamic) check and
    with the deep check."""
    import dataclasses
    import io
    import math

    import numpy as np
    import torch
    from pipegcn_tpu_torch.cli.main import build_trainer
    from pipegcn_tpu_torch.obs import MetricsLogger
    from pipegcn_tpu_torch.resilience import IntegrityPlane

    cli = train_cli(args, epochs=args.integrity_epochs,
                    extra=["--integrity-check-every", "2"])
    cnt = counters(spmm, halo)
    steps = {}
    reset_counts(cnt)
    trainer = build_trainer(cli, sg, torch.device("cuda", 0), log=log,
                            steps=steps)
    trainer.eval_cache = eval_cache
    buf = io.StringIO()
    t0 = time.monotonic()
    res = trainer.fit(eval_graphs, log_fn=log, inductive=True,
                      metrics=MetricsLogger(buf))
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = read_counts(cnt)
    recs = records(buf)
    integ = require_checks_ok(recs, "integrity cell")
    require(not [r for r in recs if r["event"] in ("fault", "recovery")],
            f"integrity cell: a fault without a planted one: {recs}")
    losses = res["losses"]
    require(len(losses) == cli.n_epochs
            and all(math.isfinite(x) for x in losses),
            f"integrity cell: losses {losses}")
    require_launched(launches, "integrity", "integrity cell")
    deep = sorted({r["epoch"] for r in integ if r["check"] == "freivalds"})
    require(deep == list(range(2, cli.n_epochs, 2)),
            f"integrity cell: deep checks at {deep}")
    residuals = [float(r["detail"].split()[1]) for r in integ
                 if r["check"] == "freivalds"]
    log(f"  fit: {len(losses)} epochs in {fit_s:.1f}s, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, {len(integ)} integrity "
        f"records all ok, Freivalds residuals {residuals}, launches "
        f"{launches}")
    fl = freivalds_launches(trainer, cnt)
    require(fl["spmm_mean"] == 1 and fl["halo_gather"] == 1
            and sum(fl.values()) == 2,
            f"Freivalds' device half: launches {fl} (want K1 and K2 once)")
    log(f"  Freivalds' device half: K1 and K2 once each at F = 1 ({fl})")

    # the cost of a check: the epoch alone (the lane off), with the
    # boundary check (the dynamic digests before, the capture after) and
    # with the deep one (also the static scrub and Freivalds); median of 3
    tc = trainer.tcfg
    plane = IntegrityPlane(tc.integrity_check_every)
    plane.baseline(trainer)
    epoch = [100]

    def run(check):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if check is not None:
            out = plane.run_checks(trainer, epoch[0], deep=check)
            require(all(r.outcome == "ok" for r in out), f"checks {out}")
        trainer.train_epoch(epoch[0])
        if check is not None:
            int(trainer.wire_bad)
            plane.note_dynamic(trainer)
        torch.cuda.synchronize()
        epoch[0] += 1
        return (time.perf_counter() - t0) * 1e3

    trainer.tcfg = dataclasses.replace(tc, integrity_check_every=0)
    run(None)
    none_ms = float(np.median([run(None) for _ in range(3)]))
    trainer.tcfg = tc
    plane.note_dynamic(trainer)  # the state the unchecked epochs left
    run(False)
    boundary_ms = float(np.median([run(False) for _ in range(3)]))
    deep_ms = float(np.median([run(True) for _ in range(3)]))
    log(f"  epoch (host clock, synchronized; median of 3): no check "
        f"{none_ms:.3f} ms, boundary check {boundary_ms:.3f} ms, deep "
        f"check {deep_ms:.3f} ms")

    # where the boundary check's time goes: its parts on the host clock (a
    # synchronize after each; median of 5): the digests before the step,
    # the guarded step, the lane's read-back and the capture after; and
    # the device time of every kernel and copy of one unchecked and one
    # checked epoch (torch.profiler)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def parts():
        marks = []
        for step in (lambda: require(all(
                         r.outcome == "ok" for r in plane.run_checks(
                             trainer, epoch[0], deep=False)),
                         "boundary checks in the split"),
                     lambda: trainer.train_epoch(epoch[0]),
                     lambda: (int(trainer.wire_bad),
                              plane.note_dynamic(trainer))):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            step()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        epoch[0] += 1
        return np.diff(marks) * 1e3

    split = np.median([parts() for _ in range(5)], axis=0)

    def device_ms(check):
        """Milliseconds of device time by kernel or copy name."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(check)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
        return {k: v / 1e3 for k, v in by_name.items()}

    trainer.tcfg = dataclasses.replace(tc, integrity_check_every=0)
    dev_none = device_ms(None)
    trainer.tcfg = tc
    plane.note_dynamic(trainer)
    dev_boundary = device_ms(False)
    # the names whose device time the check adds most to (None: the
    # profiler saw no device activity, not measured)
    grew = sorted(((dev_boundary.get(k, 0.0) - dev_none.get(k, 0.0), k)
                   for k in set(dev_none) | set(dev_boundary)),
                  reverse=True)[:8]
    boundary_split = {"checks_before_ms": float(split[0]),
                      "guarded_step_ms": float(split[1]),
                      "readback_and_capture_ms": float(split[2]),
                      "device_ms_no_check": sum(dev_none.values()) or None,
                      "device_ms_boundary_check":
                          sum(dev_boundary.values()) or None,
                      "device_ms_added_by_name": {
                          k[:80]: round(v, 4) for v, k in grew}}
    log(f"  boundary check's split (host clock, median of 5; device time "
        f"from torch.profiler, one epoch each): {boundary_split}")
    stats = {"epochs": len(losses), "losses": losses, "fit_s": fit_s,
             "epoch_time_s_mean": res["epoch_time"],
             "best_val": res["best_val"], "test_acc": res.get("test_acc"),
             "launches": launches, "integrity_records": len(integ),
             "freivalds_residuals": residuals,
             "freivalds_device_launches": fl,
             "epoch_ms_no_check": none_ms,
             "epoch_ms_boundary_check": boundary_ms,
             "epoch_ms_deep_check": deep_ms,
             "boundary_check_split": boundary_split, "host_steps_s": steps}
    return trainer, stats


def detection_matrix_phase(trainer):
    """[35] One fit per target class on the integrity cell's trainer,
    ``bitflip@3:<class>``, 8 epochs, eval off: the flip injected at epoch
    3, detected by epoch 5, attributed to its class in an integrity record,
    recovered (its recovery record), the run reaching epoch 8 with finite
    losses. Returns each class's detection epoch and fit seconds."""
    import dataclasses
    import io
    import math

    import torch
    from pipegcn_tpu_torch.obs import MetricsLogger
    from pipegcn_tpu_torch.resilience import TARGETS, FaultPlan

    tc = trainer.tcfg
    trainer.tcfg = dataclasses.replace(tc, n_epochs=8, eval=False)
    out = {}
    for target in TARGETS:
        buf = io.StringIO()
        lines = []

        def log_fn(msg):
            lines.append(msg)
            log(f"    {msg}")

        t0 = time.monotonic()
        res = trainer.fit(None, log_fn=log_fn, metrics=MetricsLogger(buf),
                          fault_plan=FaultPlan.parse(f"bitflip@3:{target}"))
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        recs = records(buf)
        inj = [r for r in recs if r["event"] == "fault"
               and r["kind"] == "injected"]
        hits = [r for r in recs if r["event"] == "integrity"
                and r["outcome"] == "mismatch"]
        rec = [r for r in recs if r["event"] == "recovery"]
        require(len(inj) == 1 and inj[0]["epoch"] == 3
                and inj[0]["reason"] == f"bitflip:{target}",
                f"bitflip:{target}: injection records {inj}")
        require(hits and all(r["target"] == target for r in hits)
                and min(r["epoch"] for r in hits) <= 5,
                f"bitflip:{target}: detections {hits}")
        require(len(rec) == 1 and rec[0]["target"] == target,
                f"bitflip:{target}: recovery records {rec}")
        require(trainer.last_epoch == 8
                and all(math.isfinite(x) for x in res["losses"]),
                f"bitflip:{target}: run ended at {trainer.last_epoch}, "
                f"losses {res['losses']}")
        ok = [r for r in recs if r["event"] == "integrity"
              and r["outcome"] == "ok"]
        require(not [r for r in ok if str(r.get("detail", "")).startswith(
            "skipped")], f"bitflip:{target}: a skipped check")
        first = min(r["epoch"] for r in hits)
        out[target] = {"detected_epoch": first,
                       "check": hits[0]["check"],
                       "dirty_shards": hits[0].get("dirty_shards"),
                       "recovery": {k: v for k, v in rec[0].items()
                                    if k not in ("event", "time_unix")},
                       "epochs_run": len(res["losses"]), "fit_s": secs}
        log(f"  bitflip:{target}: injected at 3, detected at {first} by "
            f"{hits[0]['check']}, recovered ({out[target]['recovery']}), "
            f"{len(res['losses'])} epochs run in {secs:.1f}s")
    trainer.tcfg = tc
    return out


def table_drill(name, trainer, cnt, kernels):
    """[35] On a trainer of the bucket or block cell: Freivalds ok through
    its own aggregation at F = 1 (``kernels`` launched, the transport off)
    and not skipped; a table flip scrubbed, attributed to part 0, rebuilt
    from the host artifact and cleared."""
    import torch
    from pipegcn_tpu_torch.resilience import IntegrityPlane

    plane = IntegrityPlane(1)
    plane.baseline(trainer)
    reset_counts(cnt)
    fr = plane.freivalds(trainer, 1)
    torch.cuda.synchronize()
    fl = read_counts(cnt)
    require(fr.outcome == "ok" and fr.detail.startswith("residual"),
            f"{name}: Freivalds {fr}")
    require(all(fl[k] >= 1 for k in kernels),
            f"{name}: Freivalds launched {fl}, want {kernels}")
    require(trainer._inject_bitflip("tables", 3, log), f"{name}: no flip")
    bad = plane.scrub_static(trainer)
    require(bad.outcome == "mismatch" and bad.dirty_shards == (0,),
            f"{name}: scrub after the flip {bad}")
    t0 = time.monotonic()
    n = trainer._rebuild_static_data(bad.dirty_shards)
    torch.cuda.synchronize()
    rebuild_s = time.monotonic() - t0
    clean = plane.scrub_static(trainer)
    require(clean.outcome == "ok", f"{name}: scrub after the rebuild {clean}")
    log(f"  {name}: Freivalds {fr.detail} (launches {fl}); the table flip "
        f"{bad.detail}, part {list(bad.dirty_shards)}; rebuilt ({n}) in "
        f"{rebuild_s:.1f}s, scrub ok")
    return {"freivalds": fr.detail, "freivalds_launches": fl,
            "scrub": bad.detail, "dirty_shards": list(bad.dirty_shards),
            "rebuild_s": rebuild_s}


def guard_identity(name, trainer, epoch, cnt, want):
    """[36] One pipelined epoch with the wire lane against the same epoch
    (same state, same dropout seed) without it: the loss, the parameters
    and the carry bit-identical, ``wire_bad`` 0, ``want`` launched in the
    guarded run."""
    import dataclasses

    import torch
    from pipegcn_tpu_torch.tree import tree_leaves

    tc = trainer.tcfg
    snap = trainer.host_state()
    reset_counts(cnt)
    trainer.tcfg = dataclasses.replace(tc, integrity_check_every=2)
    loss_g = trainer.train_epoch(epoch)
    bad = int(trainer.wire_bad)
    launches = read_counts(cnt)
    params_g = [t.detach().clone() for t in tree_leaves(trainer.params)]
    comm_g = [t.clone() for t in tree_leaves(trainer.comm)]
    trainer.restore_state(snap)
    trainer.tcfg = dataclasses.replace(tc, integrity_check_every=0)
    loss_u = trainer.train_epoch(epoch)
    same = (loss_g == loss_u and all(
        torch.equal(a.view(torch.uint8), b.detach().view(torch.uint8))
        for a, b in zip(params_g + comm_g, tree_leaves(trainer.params)
                        + tree_leaves(trainer.comm))))
    trainer.tcfg = tc
    log(f"  {name}: guarded epoch vs unguarded bit-identical "
        f"{'ok' if same else 'FAIL'}, wire_bad {bad}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    require(same, f"{name}: the guarded epoch differs from the unguarded")
    require(bad == 0, f"{name}: wire_bad {bad} on a clean wire")
    require(all(launches[k] >= 1 for k in want),
            f"{name}: guarded launches {launches}, want {want}")
    return {"bit_identical": same, "wire_bad": bad,
            "launches": {k: v for k, v in launches.items() if v}}


def planted_wire_fault(trainer, halo):
    """[36] The script wraps K2's wrapper (not the package) to flip one bit
    of one received block after the copy: a guarded epoch counts it
    (``wire_bad`` 1); through fit, armed in the last epoch only, the JAX
    log line and a flushed carry."""
    import dataclasses

    from pipegcn_tpu_torch.ops.digest import flip_bit_

    orig = halo.KERNELS.gather
    armed = [False]

    def corrupt(h, send_idx, send_mask, with_inner):
        out = orig(h, send_idx, send_mask, with_inner)
        if armed[0]:
            armed[0] = False  # one block of one exchange an epoch
            flip_bit_(out[1, 0], bit=13, index=5)
        return out

    halo.KERNELS.gather = corrupt
    try:
        armed[0] = True
        trainer.train_epoch(200)
        bad = int(trainer.wire_bad)
        require(bad == 1, f"planted wire fault: wire_bad {bad}, want 1")
        tc = trainer.tcfg
        trainer.tcfg = dataclasses.replace(tc, n_epochs=2, eval=False)
        lines = []
        real = trainer.train_epoch

        def train_epoch(epoch):
            armed[0] = epoch == 1
            return real(epoch)

        trainer.train_epoch = train_epoch
        try:
            trainer.fit(None, log_fn=lines.append)
        finally:
            del trainer.train_epoch
            trainer.tcfg = tc
    finally:
        halo.KERNELS.gather = orig
    want = ("integrity: halo wire checksum mismatch in 1 distance block(s) "
            "at epoch 1; flushing carry")
    flushed = all(not bool(t.any()) for grp in trainer.comm.values()
                  for t in grp.values())
    log(f"  planted wire fault: wire_bad {bad}; fit logged "
        f"{[x for x in lines if x.startswith('integrity')]}, carry flushed "
        f"{flushed}")
    require(want in lines, f"planted wire fault: fit logged {lines}")
    require(flushed, "planted wire fault: the carry was not flushed")
    return {"wire_bad": bad, "fit_line": want, "carry_flushed": flushed}


def planted_k15_faults(trainer, halo, epoch):
    """[36] The script wraps K15's wrapper (not the package) to flip one
    bit of one receiver slot after the launch: of the decoded halo the
    receiver consumes, of the narrow payload, or of the fp8 inverse scale.
    One guarded epoch of the wire cell for each, under ``--halo-dtype
    float8`` and ``bfloat16``: ``wire_bad`` 1 each time."""
    import dataclasses

    from pipegcn_tpu_torch.ops.digest import flip_bit_

    orig = halo.KERNELS.wire
    plant = [None]

    def corrupt(x, send_idx, send_mask, b_max, dt, amax=None):
        out, wire, inv = orig(x, send_idx, send_mask, b_max, dt, amax)
        target, plant[0] = plant[0], None  # one slot of one wire an epoch
        if target == "halo":
            flip_bit_(out[1, 0], bit=13, index=5)
        elif target == "payload":
            flip_bit_(wire[1, 0, 0], bit=5, index=5)
        elif target == "scale":
            flip_bit_(inv[1, 0], bit=3)
        return out, wire, inv

    tc = trainer.tcfg
    res = {}
    halo.KERNELS.wire = corrupt
    try:
        for hd, targets in (("float8", ("halo", "payload", "scale")),
                            ("bfloat16", ("halo", "payload"))):
            trainer.tcfg = dataclasses.replace(tc, halo_dtype=hd,
                                               integrity_check_every=2)
            for target in targets:
                plant[0] = target
                trainer.train_epoch(epoch)
                bad = int(trainer.wire_bad)
                res[f"{hd} {target}"] = bad
                require(bad == 1, f"planted K15 fault ({hd}, {target}): "
                        f"wire_bad {bad}, want 1")
    finally:
        halo.KERNELS.wire = orig
        trainer.tcfg = tc
    log(f"  planted K15 faults: wire_bad {res}")
    return res


def serving_guard_phase(engine, fresh, cnt):
    """[36] The freshness engine of [5a] with the wire guard on, ten
    32-row churn batches: the halo bit-identical to K2's full exchange
    after each, ``wire_bad_total`` 0, K19 and K18 launched; the guarded
    batch's refresh_boundary against an unguarded one (host clock, median);
    then the script wraps K18's wrapper to flip one bit of a received
    dirty row after the copy: detected (``wire_bad_total`` 1) and the halo
    rebuilt by the full exchange."""
    import io

    import numpy as np
    import torch
    from pipegcn_tpu_torch.obs import MetricsLogger
    from pipegcn_tpu_torch.ops.digest import flip_bit_

    rng = np.random.default_rng(13)

    def batch():
        engine.apply_updates(
            rng.integers(0, engine.num_global_nodes, 32),
            rng.standard_normal((32, engine.n_feat_raw), dtype=np.float32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.refresh_boundary()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    engine.wire_guard = False
    plain_ms = float(np.median([batch() for _ in range(10)]))
    engine.wire_guard = True
    reset_counts(cnt)
    guarded = []
    for _ in range(10):
        guarded.append(batch())
        same = torch.equal(engine._halo0.view(torch.int32),
                           engine.full_boundary_exchange().view(torch.int32))
        require(same, "serving guard: the halo differs from K2's full "
                "exchange")
    launches = read_counts(cnt)
    require(engine.wire_bad_total == 0,
            f"serving guard: wire_bad_total {engine.wire_bad_total}")
    require(launches["dirty_exchange"] >= 20 and launches["row_sums"] >= 30
            and launches["part_digests"] >= 10,
            f"serving guard: launches {launches}")
    guard_ms = float(np.median(guarded))
    orig = fresh.dirty_exchange

    def corrupt(h, halo_, dirty, send_idx, send_mask, guard=False):
        out = orig(h, halo_, dirty, send_idx, send_mask, guard=guard)
        if not guard and h.dtype != torch.uint8:
            live = live_slots(dirty, send_idx, send_mask)
            r, k = (int(v) for v in torch.nonzero(live)[0])
            flip_bit_(halo_[r, k], bit=17, index=3)
        return out

    # K18's wrapper counts through its module name: the stand-in takes
    # the count while it is installed
    corrupt.launches = orig.launches
    fresh.dirty_exchange = corrupt
    try:
        buf = io.StringIO()
        engine.apply_updates(
            rng.integers(0, engine.num_global_nodes, 32),
            rng.standard_normal((32, engine.n_feat_raw), dtype=np.float32))
        engine.refresh_boundary(ml=MetricsLogger(buf))
    finally:
        fresh.dirty_exchange = orig
        orig.launches = corrupt.launches
    rec = records(buf, "integrity")
    rebuilt = torch.equal(engine._halo0.view(torch.int32),
                          engine.full_boundary_exchange().view(torch.int32))
    log(f"  serving guard: 10 guarded 32-row batches bit-identical to the "
        f"full exchange, wire_bad_total 0, refresh_boundary {guard_ms:.3f} "
        f"ms guarded vs {plain_ms:.3f} ms (host clock, median); planted "
        f"fault: wire_bad_total {engine.wire_bad_total}, halo rebuilt "
        f"{rebuilt}, record {[(r['check'], r['blocks']) for r in rec]}")
    require(engine.wire_bad_total == 1 and rebuilt and len(rec) == 1,
            "serving guard: the planted fault was not detected and rebuilt")
    return {"batches": 10, "launches": launches,
            "refresh_boundary_guarded_ms": guard_ms,
            "refresh_boundary_unguarded_ms": plain_ms,
            "planted_fault_detected": True}


def k19_check(name, x):
    """K19's flat and per-part forms on ``x`` against their plain versions
    bit for bit, and the flat form against the numpy host_digest of the
    same bytes."""
    import numpy as np
    import torch
    from pipegcn_tpu_torch.ops import digest as dg

    got = dg.as_u32(dg.digest(x))
    ok = np.array_equal(got, dg.as_u32(dg.digest_plain(x)))
    host = x.detach().cpu().contiguous()
    if host.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                      torch.float8_e5m2):  # numpy has no such dtype
        host = host.view(torch.int16 if host.element_size() == 2
                         else torch.uint8)
    ok = ok and np.array_equal(got, dg.host_digest(host.numpy()))
    if x.dim() >= 1 and x.shape[0] > 1 and x.numel():
        ok = ok and torch.equal(dg.part_digests(x),
                                dg.part_digests_plain(x))
    log(f"  K19 {name}: bit-exact vs plain and host_digest "
        f"{'ok' if ok else 'FAIL'} ({got.tolist()})")
    require(ok, f"K19 {name}: disagrees with its plain version or numpy")


def k19_phase(trainer, spmm, halo):
    """[37] K19 against its plain version bit for bit, and against the
    numpy host_digest: every dtype at 0, 1 and 97 elements and an unaligned
    view; the cell's largest staged tensor (the use_pp features); the
    per-part form and the halo's distance blocks; the rows form at the
    guard's shape; one flipped bit must change the digest and name its
    part. Then the timings: K19 over the trainer's static data (the
    scrub), over the features alone (flat and per part), the rows form,
    their plain versions, the one-call library sum for s1 (no call
    computes the weighted sum), beside the bytes bound."""
    import numpy as np
    import torch
    from pipegcn_tpu_torch.ops import digest as dg
    from pipegcn_tpu_torch.resilience.integrity import (_digest_rows,
                                                        static_tensors)

    gen = torch.Generator(device="cuda").manual_seed(37)
    base = torch.randn(1001, generator=gen, device="cuda") * 50
    dts = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f16": torch.float16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
           "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
    for label, dt in dts.items():
        if dt == torch.bool:
            full = base > 0
        elif dt in (torch.int32, torch.int64, torch.uint8):
            full = (base * 1e6 if dt != torch.uint8 else base.abs()).to(dt)
        elif dt == torch.float8_e4m3fn:
            full = base.clamp(-400, 400).to(dt)
        else:
            full = base.to(dt)
        for n in (0, 1, 97):
            k19_check(f"{label}, {n} elements", full[:n].contiguous())
        k19_check(f"{label}, unaligned view (offset 1, 999 elements)",
                  full[1:1000])
        k19_check(f"{label}, [2, 500] per part", full[:1000].view(2, 500))
    feat = trainer.feat
    k19_check(f"the use_pp features {list(feat.shape)} {feat.dtype}", feat)
    d = trainer.data
    P, B = d.num_parts, d.b_max
    hrows = torch.randn((P, d.n_max, 256), generator=gen, device="cuda")
    blocks = halo.exchange_blocks(hrows, d.send_idx, d.send_mask)
    same = (torch.equal(dg.part_digests(blocks, P - 1),
                        dg.part_digests_plain(blocks, P - 1))
            and torch.equal(dg.row_sums(hrows, d.send_idx, d.send_mask),
                            dg.row_sums_plain(hrows, d.send_idx,
                                              d.send_mask)))
    # the rows form against the numpy sums of the blocks K2 delivered
    rcv = dg.as_u32(dg.part_digests(blocks, P - 1))[:, 0].reshape(P, P - 1)
    snd = dg.as_u32(dg.row_sums(hrows, d.send_idx, d.send_mask))
    host_ok = all(
        rcv[(s + dd) % P, dd - 1] == snd[s, dd - 1]
        == dg.host_digest(blocks[(s + dd) % P, (dd - 1) * B:dd * B]
                          .cpu().numpy())[0]
        for s in range(P) for dd in range(1, P))
    dirty = torch.rand((P, d.n_max), generator=gen, device="cuda") < 0.01
    same = same and torch.equal(
        dg.row_sums(hrows, d.send_idx, d.send_mask, dirty),
        dg.row_sums_plain(hrows, d.send_idx, d.send_mask, dirty))
    log(f"  K19 rows form and distance blocks at the guard's shape (P = "
        f"{P}, B = {B}, F = 256 f32; 1 % dirty rows): bit-exact vs plain "
        f"{'ok' if same else 'FAIL'}, sender = receiver = numpy "
        f"{'ok' if host_ok else 'FAIL'}")
    require(same and host_ok, "K19 rows form disagrees")
    flipped = feat.clone()
    dg.flip_bit_(flipped[1], bit=0, index=12345)
    pf, pr = (dg.as_u32(dg.part_digests(t)) for t in (flipped, feat))
    changed = np.nonzero(np.any(pf != pr, axis=-1))[0].tolist()
    log(f"  a flipped bit (part 1, element 12345, bit 0): digests of parts "
        f"{changed} changed")
    require(changed == [1], f"K19: a flipped bit changed parts {changed}")
    del flipped

    # timings at the main path's shapes
    named = static_tensors(trainer)
    st_bytes = sum(t.numel() * t.element_size() for t in named.values())
    x32 = feat.view(torch.int32) if feat.dtype == torch.float32 else \
        feat.view(torch.int16)
    t = {}
    scrub_ms = time_ms(lambda: _digest_rows(named, P), reps=10)
    t["scrub"] = dict(ms=scrub_ms, plain_ms=None, library_ms=None,
                      bound=bound_ms(st_bytes, 0),
                      shape=f"the SAGE trainer's {len(named)} static "
                            f"tensors, {st_bytes} bytes (one launch each, "
                            f"one read-back)")
    fb = feat.numel() * feat.element_size()
    t["flat"] = dict(
        ms=time_ms(lambda: dg.digest(feat)),
        plain_ms=time_ms(lambda: dg.digest_plain(feat), reps=3, warmup=1),
        library_ms=time_ms(lambda: x32.sum(dtype=torch.int64)),
        bound=bound_ms(fb, 0),
        shape=f"the use_pp features {list(feat.shape)} {feat.dtype}, "
              f"{fb} bytes")
    t["per_part"] = dict(
        ms=time_ms(lambda: dg.part_digests(feat)),
        plain_ms=time_ms(lambda: dg.part_digests_plain(feat), reps=3,
                         warmup=1),
        library_ms=time_ms(lambda: x32.view(P, -1).sum(
            dim=1, dtype=torch.int64)),
        bound=bound_ms(fb, 0), shape=t["flat"]["shape"] + ", per part")
    on = int(d.send_mask.sum())
    rb = on * 256 * 4 + d.send_idx.numel() * 5
    t["rows"] = dict(
        ms=time_ms(lambda: dg.row_sums(hrows, d.send_idx, d.send_mask)),
        plain_ms=time_ms(lambda: dg.row_sums_plain(hrows, d.send_idx,
                                                   d.send_mask), reps=3,
                         warmup=1),
        library_ms=None, bound=bound_ms(rb, 0),
        shape=f"P = {P}, B = {B}, {on} send rows of 256 f32 (a layer's "
              f"exchange)")
    t["blocks"] = dict(
        ms=time_ms(lambda: dg.part_digests(blocks, P - 1)),
        plain_ms=time_ms(lambda: dg.part_digests_plain(blocks, P - 1),
                         reps=3, warmup=1),
        library_ms=time_ms(lambda: blocks.view(torch.int32).view(
            P * (P - 1), -1).sum(dim=1, dtype=torch.int64)),
        bound=bound_ms(blocks.numel() * 4, 0),
        shape=f"the received halo [{P}, {(P - 1) * B}, 256] f32 in "
              f"{P * (P - 1)} distance blocks")
    for k, v in t.items():
        log(f"  K19 {k}: {v['ms']:.4f} ms, plain {v['plain_ms']}, library "
            f"(s1 alone) {v['library_ms']}, bound {v['bound'][0]:.4f} ms "
            f"({v['bound'][1]}); {v['shape']}")
    del hrows, blocks
    return t


def kernel_entry(name, source, replaces, launches, err, t, serving=None):
    """One kernel of the ``kernels`` line: ``t`` timed at the shape whose
    launches are counted (the training run's); K1/K2 also carry their
    serving-path timings and serving-run count under ``serving``."""
    bound, by = t["bound"]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": bound, "bound_by": by,
             "library_ms": t["library_ms"], "shape": t["shape"]}
    # K1: its time at S = 1 (the whole-row kernel) and the slice plan;
    # K3: K1's whole-row kernel over the prescaled cotangent
    entry.update({k: t[k] for k in ("whole_ms", "plan", "k1_whole_row_ms")
                  if k in t})
    if serving is not None:
        t, n = serving
        entry["serving"] = {"launches": n, "ms": t["ms"],
                            "plain_ms": t["plain_ms"],
                            "bound_ms": t["bound"][0],
                            "bound_by": t["bound"][1],
                            "library_ms": t["library_ms"],
                            "shape": t["shape"],
                            **{k: t[k] for k in ("whole_ms", "plan")
                               if k in t}}
    return entry


def parent_ab(parent):
    """K5 (one call and back to back), K11 (both forms), K12, K13, K16 and
    K17 (both modes; K17 also the transposed copy's alternative) and K15
    (the exchange's e4m3 and bf16 wires, the return's e5m2 and bf16; one
    call and 20 back to back) of a
    parent checkout against this one's at tools/time_tile_products.py's
    shapes, and K1 (F = 256 and 602 f32, bf16 rows), K3, K9 (clustered
    tables: e4m3, e5m2 over the transpose's, bf16, f32; random tables:
    e4m3), K6 (NEG and eval modes) and K8 (f32, bf16 and e4m3 z rows, dh
    = 64 and 41) at tools/time_gather_kernels.py's, each tool run in its
    own
    process (each checkout builds its own kernels, the parent's first, all
    together), in turns: parent, this, this, parent. Returns each key's
    two runs a side and their means."""
    tools = [os.path.join(ROOT, "pipegcn_tpu_torch", "tools", t)
             for t in ("time_tile_products.py", "time_gather_kernels.py")]
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "from pipegcn_tpu_torch.ops import _build; "
         "_build.build(n for n in sys.argv[2:] "
         "if (_build.CSRC / f'{n}.cu').exists())",
         parent, "block_spmm", "block_tma", "transport_cast", "halo_gather",
         "spmm_mean", "gat_attn", "gat_attn_bf16", "gat_attn_fp8",
         "bucket_spmm", "halo_wire"],
        capture_output=True, text=True, timeout=900)
    require(r.returncode == 0, f"the parent's kernels did not build: "
            f"{r.stderr[-3000:]}")
    runs = {"parent": [], "change": []}
    for label, root in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        both = {}
        for tool in tools:
            r = subprocess.run([sys.executable, tool, root, label],
                               capture_output=True, text=True, timeout=900)
            require(r.returncode == 0, f"{os.path.basename(tool)} on "
                    f"{root} failed: {r.stderr[-3000:]}")
            both.update(json.loads(r.stdout.strip().splitlines()[-1]))
        runs[label].append(both)
        log(f"  {label}: {both}")
    out = {}
    for k in ("K11", "K11 deg", "K5", "K5 batched",
              *(f"{k} torch.{d}" for k in ("K12", "K13", "K16", "K17",
                                           "K17 alt")
                for d in ("float32", "bfloat16")),
              "K1 serving f32 F=256", "K1 serving f32 F=602",
              "K1 serving bf16 F=256", "K3 serving f32 F=256",
              "K3 clustered f32 F=256",
              *(f"K9 clustered {r} F=256" for r in ("e4m3", "e5m2", "bf16",
                                                    "f32")),
              "K9 random e4m3 F=256",
              *(f"K15 {k}{b}" for k in ("exchange e4m3", "return e5m2",
                                        "exchange bf16", "return bf16")
                for b in ("", " batched")),
              *(f"{k} {r}" for k in ("K6 NEG", "K6 eval", "K8")
                for r in ("f32", "bf16", "e4m3")),
              *(f"K8 {r} dh=41" for r in ("f32", "bf16", "e4m3"))):
        par = [x[k] for x in runs["parent"]]
        new = [x[k] for x in runs["change"]]
        tool = ("time_tile_products.py" if k.split()[0] in (
            "K5", "K11", "K12", "K13", "K15", "K16", "K17")
            else "time_gather_kernels.py")
        out[k] = {"parent_ms": sum(par) / 2, "ms": sum(new) / 2,
                  "parent_runs_ms": par, "runs_ms": new,
                  "shape": f"pipegcn_tpu_torch/tools/{tool}'s"}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="synthetic-reddit",
                    help="graph of both cells (default: the full-width "
                         "cell)")
    ap.add_argument("--serve-seconds", type=float, default=5.0)
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--train-epochs", type=int, default=10)
    ap.add_argument("--step-repeats", type=int, default=1,
                    help="run [7] and [11] on this many consecutive epochs")
    ap.add_argument("--gat-epochs", type=int, default=6)
    ap.add_argument("--gcn-epochs", type=int, default=4)
    ap.add_argument("--bucket-epochs", type=int, default=10)
    ap.add_argument("--bucket-gcn-epochs", type=int, default=3)
    ap.add_argument("--block-epochs", type=int, default=6)
    ap.add_argument("--block-gcn-epochs", type=int, default=3)
    ap.add_argument("--bf16-epochs", type=int, default=3,
                    help="epochs of each bf16 GraphSAGE cell")
    ap.add_argument("--bf16-gat-epochs", type=int, default=12,
                    help="epochs of the bf16 GAT cell at --rem-dtype float8")
    ap.add_argument("--wire-epochs", type=int, default=6,
                    help="epochs of the union-gather block + fp8 halo wire "
                         "cell")
    ap.add_argument("--integrity-epochs", type=int, default=6,
                    help="epochs of the integrity cell")
    ap.add_argument("--parent", default=None,
                    help="a parent checkout: K1, K3, K5, K6, K8, K9, K11, "
                         "K12, K13, K15, K16 and K17 of both timed in turns "
                         "by "
                         "tools/time_tile_products.py and "
                         "tools/time_gather_kernels.py, carried in the "
                         "kernels line as parent_ab")
    args = ap.parse_args()

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing to measure")
        return 2
    sys.path.insert(0, ROOT)
    try:
        from pipegcn_tpu_torch import native
        from pipegcn_tpu_torch.graph.datasets import load_data
        from pipegcn_tpu_torch.ops import _build, gat, spmm
        from pipegcn_tpu_torch.ops import block_spmm as blk
        from pipegcn_tpu_torch.ops import bucket_spmm as bs
        from pipegcn_tpu_torch.parallel import halo
        from pipegcn_tpu_torch.serve import freshness as fresh
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

    # the kernels build (one nvcc a source, all started together) while
    # the host loads the graph and builds the serving artifact; the first
    # launch waits for them
    t0 = time.monotonic()
    built = {}

    def build_all():
        try:
            built["secs"] = _build.build([
                "spmm_mean", "halo_gather", "halo_scatter", *gat.LIBRARIES,
                "bucket_spmm", "transport_cast", "block_spmm", "block_tma",
                "halo_wire", "digest"])
        except Exception as exc:  # noqa: BLE001 — re-raised on the main thread
            built["error"] = exc

    compiling = threading.Thread(target=build_all)
    compiling.start()

    def kernels_built():
        compiling.join()
        if "error" in built:
            raise built["error"]
        log(f"    kernels built (started {time.monotonic() - t0:.1f}s ago): "
            f"{built['secs']}")

    log("[2] kernels building in the background; the native library")
    # the native partitioner and radix sort (g++): the training cells
    # partition by metis on it, as the JAX CLI does; its absence fails
    t0 = time.monotonic()
    require(native.available(), "the native host library "
            "(pipegcn_tpu_torch/native, built with g++) is unavailable")
    native_s = time.monotonic() - t0
    log(f"    native library {native.lib_path()} built and loaded in "
        f"{native_s:.1f}s")

    t0 = time.monotonic()
    g = load_data(args.dataset)
    load_s = time.monotonic() - t0
    log(f"    load_data {args.dataset}: {load_s:.1f}s ({g.num_nodes} "
        f"nodes, {g.num_edges} edges)")

    log(f"[3] serving path: {args.dataset}, 2 parts, GraphSAGE 4x256 "
        "use_pp")
    try:
        serve_sg, engine, summary, launches, serve_stats = serve_phase(
            args, g, spmm, halo, kernels_built)
    finally:
        compiling.join()  # no nvcc outlives a failed phase

    log("[4] K1, K2 vs plain versions")
    errs = {"K1": k1_phase(engine, spmm, halo), "K2": k2_phase(engine, halo)}

    log("[5] K1, K2 timings")
    serve_t, pp = timings(engine, spmm, halo)
    del engine
    torch.cuda.empty_cache()

    log("[5a] serving freshness: bench.py --serve's configuration (GraphSAGE "
        "602 -> 256x3 -> 41, use_pp off, 100 qps, refresh every 0.5 s, "
        "32-row churn every 0.5 s, then --update-fraction 0.05) on the same "
        "2 random parts; K18 vs its plain version, a planted fault; GCN")
    fresh_stats, fresh_engine = freshness_phase(args, serve_sg, spmm, halo,
                                                fresh)
    del serve_sg
    torch.cuda.empty_cache()

    log(f"[6] training cell: scripts/reddit.sh at full width on "
        f"{args.dataset} (--inductive --enable-pipeline --use-pp, dropout "
        f"0.5, lr 0.01, 2 metis parts by the native partitioner, the "
        f"default --local-reorder cluster: native locality clusters of "
        f"the train subgraph, shared by every training cell); cut: "
        f"{args.train_epochs} epochs instead of 3000")
    cli, sg, eval_graphs, trainer, train_stats = train_phase(args, g, spmm,
                                                            halo)
    del g
    train_launches = train_stats["launches"]

    log("[7] one pipelined epoch: kernels vs plain versions")
    step = step_phase(trainer, cli.n_epochs)
    for r in range(1, args.step_repeats):
        step_phase(trainer, cli.n_epochs + r)

    log("[8] K3, K4, K5 vs plain versions; K4 in bf16, K2 and K5 on bf16 "
        "rows")
    k1_train_phase(trainer, spmm, halo)
    errs.update(K3=k3_phase(trainer, spmm), K4=k4_phase(trainer, halo),
                K5=k5_phase(trainer, halo))
    errs["K4 bf16"] = bf16_comm_phase(trainer, halo)

    log("[9] K3-K5 timings (K4 also in bf16), the epoch and its split; 3 "
        "vanilla epochs")
    tt = train_timings(trainer, spmm, halo, counters(spmm, halo))
    k4b = k4_bf16_timing(trainer, halo)
    eval_cache = trainer.eval_cache  # the GAT cell evaluates the same graphs
    del trainer
    torch.cuda.empty_cache()
    vanilla = vanilla_phase(args, sg, spmm, halo)
    torch.cuda.empty_cache()

    log(f"[10] GAT cell: the command with --model gat --n-heads 4 minus "
        f"--use-pp (602 -> 256x3 -> 41, LayerNorm, dropout 0.5, lr 0.01, "
        f"pipelined), {args.gat_epochs} epochs on the same parts")
    gtrainer, gat_stats = gat_train_phase(args, sg, eval_graphs, eval_cache,
                                          spmm, halo)

    log("[11] one pipelined GAT epoch: kernels vs plain versions")
    gat_step = step_phase(gtrainer, args.gat_epochs)
    for r in range(1, args.step_repeats):
        step_phase(gtrainer, args.gat_epochs + r)

    log("[12] K6, K8 vs plain versions in each row type (f32; bf16; e4m3 z "
        "with e5m2 g); a planted fault must fail in each")
    edge = gat_edge_phase(gat)
    cell = gat_cell_phase(gtrainer, gat)
    errs.update({k: max(edge[k], cell[k]) for k in edge})
    gat_fault_phase(gat)
    for mode in ("bf16", "fp8"):
        e_edge = gat_narrow_edge_phase(gat, mode)
        e_cell = gat_cell_phase(gtrainer, gat, modes=(mode,))
        errs.update({f"{k} {mode}": max(e_edge[k], e_cell[k])
                     for k in e_edge})
        gat_fault_phase(gat, mode=mode)
    log(f"  K8's worst error in GAT_SUM_C's unit (sqrt(n) u sum|terms|): "
        f"{K8_WORST['c']:.3f} against GAT_SUM_C = {GAT_SUM_C:g} "
        f"({K8_WORST['where']})")

    log("[13] K6, K8 timings in each row type, the GAT epoch and its split")
    gt = gat_timings(gtrainer, gat)
    gt16 = gat_timings(gtrainer, gat, mode="bf16")
    gt8 = gat_timings(gtrainer, gat, mode="fp8")
    gat_split = gat_epoch_split(gtrainer, counters(spmm, halo), gt, tt)
    del gtrainer
    torch.cuda.empty_cache()

    log(f"[14] GCN: {args.gcn_epochs} pipelined epochs on the same parts, "
        f"then one epoch: kernels vs plain versions")
    gcn_stats = gcn_phase(args, sg, spmm, halo)
    torch.cuda.empty_cache()

    log(f"[15] bucket cell: the command plus --spmm-impl bucket --rem-dtype "
        f"float8, {args.bucket_epochs} epochs on the same parts; then one "
        f"epoch alone and 2 epochs each of --rem-amax, --rem-dtype "
        f"bfloat16 and none")
    btrainer, bucket_stats = bucket_train_phase(args, sg, eval_graphs,
                                                eval_cache, spmm, halo)

    log("[16] one pipelined bucket epoch: kernels vs plain versions "
        "(relu masks and transported values shared)")
    bucket_step = step_phase(btrainer, args.bucket_epochs + 10)

    log("[17] K9, K10, K11 vs plain versions; planted faults must fail")
    errs["K9"] = max(k9_cell_phase(btrainer, bs, halo), k9_edge_phase(bs))
    k9_fault_phase(bs)
    cast_res = k10_k11_phase(btrainer, bs, halo)
    errs["K10"], errs["K11"] = cast_res["K10"][0], cast_res["K11"][0]

    log("[18] K9-K11 timings, the bucket epoch and its split; GCN on the "
        "bucket path, then one epoch: kernels vs plain versions")
    bt = bucket_timings(btrainer, bs)
    bucket_split = bucket_epoch_split(btrainer, counters(spmm, halo), bt, tt)

    log(f"[19] bf16 bucket cell: the bucket command with --dtype bfloat16 "
        f"on the same trainer and tables, {args.bf16_epochs} epochs (K9 on "
        f"e4m3 / e5m2 rows cast from bf16, K4 in bf16), then one epoch: "
        f"kernels vs plain versions")
    switch_dtype(btrainer, train_cli(
        args, extra=["--spmm-impl", "bucket", "--rem-dtype", "float8"],
        dtype="bfloat16"), sg)
    bf16_bucket = bf16_epochs(
        "bf16 bucket", btrainer, counters(spmm, halo), 200, args.bf16_epochs,
        {"bucket_gather": 6, "transport_cast": 6, "spmm_mean": 0,
         "spmm_mean_t": 0}, {"halo_scatter": {"bfloat16": 3, "float32": 0}})
    torch.cuda.empty_cache()  # btrainer stays for [35]
    bucket_gcn = bucket_gcn_phase(args, sg, spmm, halo)
    torch.cuda.empty_cache()

    log(f"[20] block cell: the command plus --spmm-impl block --rem-dtype "
        f"float8, {args.block_epochs} epochs on the same parts; then 2 "
        f"epochs of --rem-dtype none")
    ktrainer, block_stats = block_train_phase(args, sg, eval_graphs,
                                              eval_cache, spmm, halo)

    log("[21] one pipelined block epoch: kernels vs plain versions (relu "
        "masks and the remainder's transported values shared)")
    block_step = step_phase(ktrainer, args.block_epochs + 10)

    log("[22] K12, K13 vs plain versions (f32 rows and the bf16 mode); a "
        "planted fault must fail in each")
    errs["K12/K13 cell"] = k12_k13_cell_phase(ktrainer, blk, halo)
    errs["K12/K13 edge"] = max(k12_k13_edge_phase(blk),
                               k12_tma_edge_phase(blk))
    block_fault_phase(blk, ktrainer)
    errs["K12/K13 bf16"] = block_bf16_checks(ktrainer, blk)

    log("[23] K12, K13 timings (f32 rows and the bf16 mode), the block "
        "epoch and its split")
    kt = block_timings(ktrainer, blk, bs)
    kt16 = block_timings(ktrainer, blk, bs, dtype=torch.bfloat16)
    block_split = block_epoch_split(ktrainer, counters(spmm, halo), kt, bt,
                                    tt, bucket_split)

    log("[23a] serving through the trainers' aggregation (transport off): "
        "engines on the block cell's staged parts and tables (block: K12 + "
        "K9) and on the bucket cell's (bucket: K9), xla (K1) beside them")
    table_serving = table_serving_phase(ktrainer, btrainer, spmm, halo)

    log(f"[24] bf16 block cell: the block command with --dtype bfloat16 on "
        f"the same trainer and tables, {args.bf16_epochs} epochs (K12 / K13 "
        f"in their bf16 mode), then one epoch: kernels vs plain versions")
    switch_dtype(ktrainer, train_cli(
        args, extra=["--spmm-impl", "block", "--rem-dtype", "float8"],
        dtype="bfloat16"), sg)
    bf16_block = bf16_epochs(
        "bf16 block", ktrainer, counters(spmm, halo), 200, args.bf16_epochs,
        {"block_dense": 3, "block_dense_t": 3, "bucket_gather": 6,
         "transport_cast": 6},
        {"block_dense": {"bfloat16": 3, "float32": 0},
         "block_dense_t": {"bfloat16": 3, "float32": 0},
         "halo_scatter": {"bfloat16": 3, "float32": 0}})
    torch.cuda.empty_cache()  # ktrainer stays for [35]

    log(f"[25] GCN on the block path: {args.block_gcn_epochs} epochs, then "
        f"one epoch: kernels vs plain versions")
    block_gcn = block_gcn_phase(args, sg, spmm, halo)
    torch.cuda.empty_cache()

    log(f"[26] bf16 xla cell: scripts/reddit.sh --dtype bfloat16, "
        f"{args.bf16_epochs} epochs, then one epoch: kernels vs plain "
        f"versions")
    bf16_xla, k1b = bf16_sage_xla_phase(args, sg, spmm, halo)
    torch.cuda.empty_cache()
    # the bf16 SAGE epochs split by this run's kernel times (K2 / K5 at
    # their f32 times, K10 at its f32-input times: upper estimates, the
    # rows are bf16)
    comm = {"halo_gather": tt["K2"]["ms"], "halo_scatter": k4b["ms"],
            "halo_return": tt["K5"]["ms"]}
    k9_ms = (bt["K9"]["forward float8_e4m3fn"]["ms"]
             + bt["K9"]["backward float8_e5m2"]["ms"]) / 2
    k10_ms = (bt["K10"]["forward e4m3"]["ms"]
              + bt["K10"]["backward e5m2"]["ms"]) / 2
    bf16_split("bf16 xla", bf16_xla, {"spmm_mean": k1b["ms"],
                                      "spmm_mean_t": tt["K3"]["ms"], **comm})
    bf16_split("bf16 bucket", bf16_bucket, {"bucket_gather": k9_ms,
                                            "transport_cast": k10_ms, **comm})
    rem9 = (kt["K9 remainder forward e4m3"]["ms"]
            + kt["K9 remainder backward e5m2"]["ms"]) / 2
    bf16_split("bf16 block", bf16_block, {
        "block_dense": kt16["K12"]["ms"], "block_dense_t": kt16["K13"]["ms"],
        "bucket_gather": rem9, "transport_cast": k10_ms, **comm})

    log(f"[27] bf16 GAT cell (scripts/gat_bench.py): --model gat --n-heads "
        f"4 --dtype bfloat16 --spmm-impl bucket --rem-dtype float8 with "
        f"reddit.sh's --inductive --enable-pipeline, {args.bf16_gat_epochs}"
        f" epochs on the same parts, then 2 epochs each of --rem-dtype "
        f"bfloat16 and none")
    g16trainer, bf16_gat = bf16_gat_phase(args, sg, eval_graphs, eval_cache,
                                          spmm, halo)

    log("[28] one pipelined bf16 GAT epoch: kernels vs plain versions (relu "
        "masks, leaky branches and transported values shared); the epoch "
        "and its split")
    bf16_gat_step = step_phase(g16trainer, args.bf16_gat_epochs + 10)
    bf16_gat["split"] = bf16_gat_split(g16trainer, counters(spmm, halo),
                                       gt16, gt8, gt, k4b, tt)
    del g16trainer
    torch.cuda.empty_cache()

    log(f"[29] union-gather block + fp8 halo wire cell: the command plus "
        f"--dtype bfloat16 {' '.join(WIRE_FLAGS)}, {args.wire_epochs} "
        f"epochs on the same parts, then 2 epochs each of --halo-dtype "
        f"bfloat16 and none")
    wtrainer, wire_stats = wire_train_phase(args, sg, eval_graphs,
                                            eval_cache, spmm, halo)
    log("  the command at --block-group 2, 4 and 8, each at f32 and bf16 "
        "compute, 2 epochs each")
    wire_stats["groups"] = wire_group_variants(args, sg, spmm, halo)

    log("[30] one pipelined epoch of the wire cell: kernels vs plain "
        "versions (relu masks, the remainder's transported values and the "
        "halo wire's payloads and scales shared)")
    wire_step = step_phase(wtrainer, args.wire_epochs + 10)

    log("[31] K14, K15 bit-exact vs plain versions (the cell, an emulated "
        "P = 4 set, every wire on f32 and bf16 rows, edge cases); a planted "
        "fault must fail")
    k14_k15_check_phase(wtrainer, halo)

    log("[32] K16, K17 vs plain versions (the cell, every A encoding, "
        "groups 2, 4 and 8, hand-made groups); a planted fault must fail")
    errs["K16/K17"] = k16_k17_check_phase(wtrainer, blk, halo)

    log("[33] K14-K17 timings, the union dedupe beside K12's pairs, the "
        "wire cell's epoch and its split")
    wt = wire_timings(wtrainer, halo)
    gt32 = block_timings(wtrainer, blk, bs, remainder=False)
    gt16b = block_timings(wtrainer, blk, bs, dtype=torch.bfloat16)
    log(f"  union dedupe: K16 stages {gt32['K16']['union_slots']} union "
        f"tiles for {gt32['K16']['pairs']} products "
        f"({gt32['K16']['union_slots'] / gt32['K16']['pairs']:.3f}); K17 "
        f"{gt32['K17']['union_slots']} for {gt32['K17']['pairs']}; K16 "
        f"{gt32['K16']['ms']:.3f} ms beside K12's group-1 "
        f"{kt['K12']['ms']:.3f} ms (bf16 mode {gt16b['K16']['ms']:.3f} / "
        f"{kt16['K12']['ms']:.3f} ms)")
    wire_stats["split"] = wire_epoch_split(
        wtrainer, counters(spmm, halo), wt, gt16b, kt, bt, k4b,
        {"f32 block": block_split["epoch_ms"],
         "bf16 block": bf16_block["epoch_ms"]})
    torch.cuda.empty_cache()  # wtrainer stays for [36]

    log(f"[34] integrity cell: the command plus --integrity-check-every 2, "
        f"{args.integrity_epochs} epochs on the same parts (a deep check at "
        f"every second boundary, the wire lane in every exchange and "
        f"return)")
    itrainer, integ_stats = integrity_cell_phase(args, sg, eval_graphs,
                                                 eval_cache, spmm, halo)
    del eval_graphs, eval_cache

    log("[35] the detection matrix: bitflip@3:<class> per target class on "
        "the integrity cell's trainer; Freivalds and a table flip on the "
        "bucket and block trainers")
    integ_stats["detection"] = detection_matrix_phase(itrainer)
    cnt = counters(spmm, halo)
    integ_stats["bucket_tables"] = table_drill(
        "bucket trainer ([15], bf16 since [19])", btrainer, cnt,
        ["bucket_gather"])
    del btrainer
    integ_stats["block_tables"] = table_drill(
        "block trainer ([20], bf16 since [24])", ktrainer, cnt,
        ["block_dense", "bucket_gather"])
    del ktrainer
    torch.cuda.empty_cache()

    log("[36] the wire guard: guarded epochs bit-identical (K2 / K5; K15's "
        "e4m3 / e5m2 and bf16 wires), planted K15 faults, a planted corrupt "
        "copy; the serving guard on the freshness engine of [5a]")
    guard = {"sage": guard_identity(
        "SAGE (K2 / K5)", itrainer, 300, cnt,
        ["halo_gather", "halo_return", "row_sums", "part_digests"])}
    wtc = wtrainer.tcfg
    for hd in ("float8", "bfloat16"):
        wtrainer.tcfg = dataclasses.replace(wtc, halo_dtype=hd)
        guard[f"wire {hd}"] = guard_identity(
            f"wire cell, --halo-dtype {hd} (K15)", wtrainer, 400, cnt,
            ["halo_wire", "part_digests"])
    wtrainer.tcfg = wtc
    guard["planted K15"] = planted_k15_faults(wtrainer, halo, 410)
    del wtrainer
    guard["planted"] = planted_wire_fault(itrainer, halo)
    guard["serving"] = serving_guard_phase(fresh_engine, fresh, cnt)
    integ_stats["wire_guard"] = guard
    del fresh_engine
    torch.cuda.empty_cache()

    log("[37] K19 vs its plain version and numpy bit for bit; its timings")
    k19t = k19_phase(itrainer, spmm, halo)
    del itrainer
    torch.cuda.empty_cache()

    # the main path of this slice is training: every kernel's launches
    # are its training-run count and its times are taken at the epoch's
    # shapes; K1/K2 carry their serving-path numbers beside them
    src = "pipegcn_tpu_torch/ops/csrc/"
    n = train_launches
    kernels = [
        kernel_entry("spmm_mean", src + "spmm_mean.cu",
                     "pipegcn_tpu/ops/spmm.py:33", n["spmm_mean"],
                     errs["K1"], tt["K1"],
                     (serve_t["K1"], launches["spmm_mean"])),
        kernel_entry("halo_gather", src + "halo_gather.cu",
                     "pipegcn_tpu/parallel/halo.py:173", n["halo_gather"],
                     errs["K2"], tt["K2"],
                     (serve_t["K2"], launches["halo_gather"])),
        kernel_entry("spmm_mean_t", src + "spmm_mean.cu",
                     "pipegcn_tpu/ops/spmm.py:143", n["spmm_mean_t"],
                     errs["K3"], tt["K3"]),
        kernel_entry("halo_scatter", src + "halo_scatter.cu",
                     "pipegcn_tpu/parallel/halo.py:285", n["halo_scatter"],
                     errs["K4"], tt["K4"]),
        kernel_entry("halo_return", src + "halo_gather.cu",
                     "pipegcn_tpu/parallel/halo.py:244", n["halo_return"],
                     errs["K5"], tt["K5"]),
    ]
    # K1 at the pp precompute's F = 602 (serving: once an engine, and
    # layer 0 of every use_pp-off refresh)
    t602 = serve_t["K1 F=602"]
    kernels[0]["serving_f602"] = {
        "ms": t602["ms"], "whole_ms": t602["whole_ms"], "plan": t602["plan"],
        "plain_ms": t602["plain_ms"], "bound_ms": t602["bound"][0],
        "bound_by": t602["bound"][1], "library_ms": t602["library_ms"],
        "shape": t602["shape"]}
    # K5: beside the event pair around one call, 20 calls back to back
    # (the card's time a call) and index_select's likewise, and the
    # card's copy floor (a copy_ of the same blocks, unpermuted)
    for f in ("batched_ms", "library_batched_ms", "copy_ms",
              "copy_batched_ms", "copy_contig_ms", "copy_contig_batched_ms"):
        kernels[-1][f] = tt["K5"][f]
    # K18: the freshness phase's run (build, the quiet, churn and mixed
    # runs); times at the cell's shape with 32 dirty rows (a churn
    # batch), the other dirty counts under "by_dirty_rows"
    k18t = fresh_stats["k18"]
    e = kernel_entry("dirty_exchange", src + "halo_gather.cu",
                     "pipegcn_tpu/serve/freshness.py:51",
                     fresh_stats["launches"]["dirty_exchange"], 0.0,
                     k18t["32"])
    e["by_dirty_rows"] = {k: {**{f: v[f] for f in ("ms", "plain_ms",
                                                     "library_ms",
                                                     "dirty_slots")},
                              "bound_ms": v["bound"][0],
                              "bound_by": v["bound"][1]}
                          for k, v in k18t.items()}
    e["launches_run"] = "the serving-freshness phase's runs"
    kernels.append(e)
    # K6, K8: times at the hidden layers' shape (dh = 64) beside the GAT
    # training run's launches; the logits layer's (dh = 41) under "dh41";
    # K6 in training's NEG mode (which also gives pass A), its eval mode
    # under "eval"
    ng = gat_stats["launches"]

    def sub(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "shape": t["shape"]}

    for name, kname, replaces, also in (
            ("K6", "gat_fwd", "pipegcn_tpu/ops/gat_bucket.py:344",
             ["pipegcn_tpu/ops/gat_bucket.py:419",
              "pipegcn_tpu/models/sage.py:331"]),
            ("K8", "gat_bwd_src", "pipegcn_tpu/ops/gat_bucket.py:450",
             ["pipegcn_tpu/models/sage.py:331"])):
        entry = kernel_entry(kname, src + "gat_attn.cu", replaces, ng[kname],
                             errs[name], gt[name][64])
        entry["dh41"] = sub(gt[name][41])
        if name == "K6":
            entry["eval"] = {"dh64": sub(gt["K6 eval"][64]),
                             "dh41": sub(gt["K6 eval"][41])}
        else:  # every row type's checks, in GAT_SUM_C's unit
            entry["worst_sum_c"] = K8_WORST["c"]
            entry["worst_sum_c_at"] = K8_WORST["where"]
        entry["also_replaces"] = also
        kernels.append(entry)
    # K9-K11: the bucket cell's run (K11: its --rem-amax variant's), times
    # at its shapes; K9's main numbers are the e4m3 forward, the other
    # directions and dtypes under "by_dtype"
    nb = bucket_stats["launches"]
    k9 = kernel_entry("bucket_gather", src + "bucket_spmm.cu",
                      "pipegcn_tpu/ops/bucket_spmm.py:290", nb["bucket_gather"],
                      errs["K9"], bt["K9"]["forward float8_e4m3fn"])
    k9["by_dtype"] = {k: {**sub(v), "library_ms": v["library_ms"]}
                      for k, v in bt["K9"].items()}
    k9["also_replaces"] = ["pipegcn_tpu/ops/bucket_spmm.py:490",
                           "pipegcn_tpu/ops/bucket_spmm.py:777"]
    k10 = kernel_entry("transport_cast", src + "transport_cast.cu",
                       "pipegcn_tpu/ops/bucket_spmm.py:451",
                       nb["transport_cast"], errs["K10"],
                       bt["K10"]["forward e4m3"])
    k10["library_calls"] = bt["K10"]["forward e4m3"]["library_calls"]
    k10["others"] = {k: {**sub(v), "library_ms": v["library_ms"]}
                     for k, v in bt["K10"].items() if k != "forward e4m3"}
    k10["also_replaces"] = ["pipegcn_tpu/ops/bucket_spmm.py:462"]
    k11 = kernel_entry("part_amax", src + "transport_cast.cu",
                       "pipegcn_tpu/ops/bucket_spmm.py:462",
                       bucket_stats["amax_launches"]["part_amax"],
                       errs["K11"], bt["K11"]["forward e4m3"])
    k11["launches_run"] = "the --rem-amax variant, 2 epochs"
    for k, e in (("K10", k10), ("K11", k11)):
        e["differing_elements"], e["checked_elements"] = cast_res[k][1:]
    k11["backward"] = {**sub(bt["K11"]["backward e5m2"]),
                       "library_ms": bt["K11"]["backward e5m2"]["library_ms"]}
    # the card's time with the host running ahead, beside the event-pair
    # ms that also counts the wrappers' host work
    for e, t in ((k11, bt["K11"]["forward e4m3"]),
                 (k11["backward"], bt["K11"]["backward e5m2"])):
        e["batched_ms"] = t["batched_ms"]
        e["library_batched_ms"] = t["library_batched_ms"]
    kernels += [k9, k10, k11]
    # K12, K13: the block cell's run, times at its shape (F = 256); the
    # stored A bytes and the tile-product floors beside the bound
    nk = block_stats["launches"]
    for kname, key, replaces, also in (
            ("block_dense", "K12", "pipegcn_tpu/ops/block_spmm.py:520",
             ["pipegcn_tpu/ops/block_spmm.py:89",
              "pipegcn_tpu/ops/block_spmm.py:660",
              "pipegcn_tpu/ops/block_spmm.py:952"]),
            ("block_dense_t", "K13", "pipegcn_tpu/ops/block_spmm.py:520",
             ["pipegcn_tpu/ops/block_spmm.py:89",
              "pipegcn_tpu/ops/block_spmm.py:685",
              "pipegcn_tpu/ops/block_spmm.py:952"])):
        # with the cell's 1-bit A both run on block_tma.cu (tile_entry)
        e = kernel_entry(kname, src + "block_tma.cu", replaces, nk[kname],
                         max(errs["K12/K13 cell"], errs["K12/K13 edge"]),
                         kt[key])
        for f in ("a_bytes", "a_bytes_ms", "tile_floor_bf16_tc_ms",
                  "tile_floor_split3_tc_ms", "tile_floor_f32_ms",
                  "batched_ms", "library_batched_ms"):
            e[f] = kt[key][f]
        e["also_replaces"] = also
        if key == "K12":
            e["serving_launches"] = {
                k: v["launches_refresh"]["block_dense"]
                for k, v in table_serving.items()}
        kernels.append(e)
    # the bf16 and narrow row-type modes of K4, K6, K8, K12 and K13, each
    # with its launches by mode in the run of its own cell: K4, K6 and K8
    # in the bf16 GAT cell (this slice's path; K6 / K8 also timed at the
    # logits layer's dh = 41 under "dh41"), K12 / K13 in the bf16 block
    # cell
    gm = bf16_gat["launches_by_mode"]
    e = kernel_entry("halo_scatter[bf16]", src + "halo_scatter.cu",
                     "pipegcn_tpu/parallel/halo.py:285",
                     gm["halo_scatter"]["bfloat16"], errs["K4 bf16"], k4b)
    kernels.append(e)
    for mode, tmode, lib, label in (
            ("bf16", gt16, "gat_attn_bf16", "bf16"),
            ("fp8", gt8, "gat_attn_fp8", "e4m3 z, e5m2 g")):
        for name, kname, replaces in (
                ("K6", "gat_fwd", "pipegcn_tpu/ops/gat_bucket.py:344"),
                ("K8", "gat_bwd_src", "pipegcn_tpu/ops/gat_bucket.py:450")):
            e = kernel_entry(f"{kname}[{label}]", src + lib + ".cu",
                             replaces, gm[kname][lib], errs[f"{name} {mode}"],
                             tmode[name][64])
            e["dh41"] = sub(tmode[name][41])
            if name == "K6":
                e["eval"] = {"dh64": sub(tmode["K6 eval"][64]),
                             "dh41": sub(tmode["K6 eval"][41])}
            e["header"] = src + "gat_attn.cuh"
            kernels.append(e)
    e = kernel_entry("spmm_mean[bf16 rows]", src + "spmm_mean.cu",
                     "pipegcn_tpu/ops/spmm.py:99",
                     bf16_xla["launches"]["spmm_mean"], errs["K1"], k1b)
    e["launches_run"] = "the bf16 xla cell's epochs"
    kernels.append(e)
    bm = bf16_block["launches_by_mode"]
    for kname, key in (("block_dense", "K12"), ("block_dense_t", "K13")):
        e = kernel_entry(f"{kname}[bf16]", src + "block_tma.cu",
                         "pipegcn_tpu/ops/block_spmm.py:520",
                         bm[kname]["bfloat16"], errs["K12/K13 bf16"],
                         kt16[key])
        for f in ("a_bytes", "a_bytes_ms", "tile_floor_bf16_tc_ms",
                  "tile_floor_f32_ms", "batched_ms"):
            e[f] = kt16[key][f]
        kernels.append(e)

    # K14 / K15: the wire cell's run (fit and its halo-dtype variants),
    # times at its shapes on bf16 rows (the exchange's e4m3 wire the main
    # numbers; the return's e5m2 and the bf16 wires under "others"); no
    # single PyTorch call computes either: library_ms null
    nw, mw = wire_stats["launches"], wire_stats["launches_by_mode"]
    e = kernel_entry("halo_amax", src + "halo_wire.cu",
                     "pipegcn_tpu/parallel/halo.py:127", nw["halo_amax"],
                     0.0, wt["K14 exchange"])
    e["launches_by_mode"] = mw["halo_amax"]
    e["others"] = {"return": sub(wt["K14 return"])}
    e["also_replaces"] = ["pipegcn_tpu/ops/bucket_spmm.py:462"]
    e["library"] = "none: no single PyTorch call takes a per-block amax " \
        "over gathered send rows"
    kernels.append(e)
    e = kernel_entry("halo_wire", src + "halo_wire.cu",
                     "pipegcn_tpu/parallel/halo.py:127", nw["halo_wire"],
                     0.0, wt["K15 exchange float8_e4m3fn"])
    e["launches_by_mode"] = mw["halo_wire"]
    e["others"] = {k[4:]: sub(v) for k, v in wt.items()
                   if k.startswith("K15") and k != "K15 exchange "
                   "float8_e4m3fn"}
    e["also_replaces"] = ["pipegcn_tpu/parallel/halo.py:48",
                          "pipegcn_tpu/parallel/halo.py:173",
                          "pipegcn_tpu/parallel/halo.py:244"]
    e["library"] = "none: no single PyTorch call gathers, scales, casts, " \
        "permutes and decodes"
    kernels.append(e)
    # K16 / K17: the wire cell's run; the bf16 mode (the cell's rows) and
    # the f32-row mode (the pp precompute's one K16 launch), times at F =
    # 256 beside the dense edges' cuSPARSE time (f32), the union slots
    # and the products
    for kname, key, replaces, also in (
            ("block_dense_grouped", "K16",
             "pipegcn_tpu/ops/block_spmm.py:558",
             ["pipegcn_tpu/ops/block_spmm.py:154",
              "pipegcn_tpu/ops/block_spmm.py:418",
              "pipegcn_tpu/ops/block_spmm.py:648"]),
            ("block_dense_grouped_t", "K17",
             "pipegcn_tpu/ops/block_spmm.py:558",
             ["pipegcn_tpu/ops/block_spmm.py:154",
              "pipegcn_tpu/ops/block_spmm.py:691"])):
        for mode, tm, run in (
                ("bfloat16", gt16b, wire_stats),
                ("float32", gt32, wire_stats["groups"])):
            e = kernel_entry(
                f"{kname}[{'bf16' if mode == 'bfloat16' else 'f32'}]",
                src + "block_tma.cu", replaces,
                run["launches_by_mode"][kname][mode], errs["K16/K17"],
                tm[key])
            e["launches_run"] = ("the wire cell's" if run is wire_stats
                                 else "the group 2 / 4 / 8 runs'")
            for f in ("a_bytes", "a_bytes_ms", "tile_floor_bf16_tc_ms",
                      "tile_floor_f32_ms", "union_slots", "pairs"):
                e[f] = tm[key][f]
            e["group1_ms"] = (kt16 if mode == "bfloat16" else kt)[
                "K12" if key == "K16" else "K13"]["ms"]
            e["also_replaces"] = also
            kernels.append(e)

    # K19, by form: launches over the integrity cell's run ([34]: the
    # build, the epochs with their checks, the final eval), times at the
    # main path's shapes ([37]); the flat form's main numbers over the
    # use_pp features, the scrub's whole static data under "scrub"
    ni = integ_stats["launches"]
    for kname, key, replaces, also in (
            ("digest", "flat", "pipegcn_tpu/resilience/integrity.py:115",
             ["pipegcn_tpu/resilience/integrity.py:155",
              "pipegcn_tpu/parallel/halo.py:106"]),
            ("part_digests", "per_part",
             "pipegcn_tpu/resilience/integrity.py:213",
             ["pipegcn_tpu/resilience/integrity.py:115",
              "pipegcn_tpu/parallel/halo.py:127"]),
            ("row_sums", "rows", "pipegcn_tpu/parallel/halo.py:106",
             ["pipegcn_tpu/parallel/halo.py:127",
              "pipegcn_tpu/serve/freshness.py:51"])):
        e = kernel_entry(kname, src + "digest.cu", replaces, ni[kname], 0.0,
                         k19t[key])
        e["also_replaces"] = also
        e["library"] = (
            "none: no single PyTorch call gathers send rows and sums "
            "their bits" if key == "rows" else
            "x.view(int32).sum(dtype=int64) gives the plain sum s1 only; "
            "no call computes the weighted sum s2 (no uint32 arithmetic "
            "on CUDA)")
        if key == "flat":
            e["scrub"] = {"ms": k19t["scrub"]["ms"],
                          "bound_ms": k19t["scrub"]["bound"][0],
                          "bound_by": k19t["scrub"]["bound"][1],
                          "shape": k19t["scrub"]["shape"]}
        if key == "per_part":
            e["blocks"] = {**sub(k19t["blocks"]),
                           "library_ms": k19t["blocks"]["library_ms"]}
        kernels.append(e)

    if args.parent is not None:
        log(f"[38] K1, K3, K5, K6, K8, K9, K11, K12, K13, K15, K16 and "
            f"K17 of the parent checkout {args.parent} against this one's "
            f"(time_tile_products.py, time_gather_kernels.py, in turns)")
        torch.cuda.empty_cache()
        ab = parent_ab(args.parent)
        for e in kernels:
            key = {"part_amax": "K11",
                   "halo_return": "K5",
                   "spmm_mean": "K1 serving f32 F=256",
                   "spmm_mean[bf16 rows]": "K1 serving bf16 F=256",
                   "spmm_mean_t": "K3 clustered f32 F=256",
                   "gat_fwd": "K6 NEG f32",
                   "gat_fwd[bf16]": "K6 NEG bf16",
                   "gat_fwd[e4m3 z, e5m2 g]": "K6 NEG e4m3",
                   "gat_bwd_src": "K8 f32",
                   "gat_bwd_src[bf16]": "K8 bf16",
                   "gat_bwd_src[e4m3 z, e5m2 g]": "K8 e4m3",
                   "block_dense": "K12 torch.float32",
                   "block_dense[bf16]": "K12 torch.bfloat16",
                   "block_dense_t": "K13 torch.float32",
                   "block_dense_t[bf16]": "K13 torch.bfloat16",
                   "block_dense_grouped[bf16]": "K16 torch.bfloat16",
                   "block_dense_grouped[f32]": "K16 torch.float32",
                   "block_dense_grouped_t[bf16]": "K17 torch.bfloat16",
                   "block_dense_grouped_t[f32]": "K17 torch.float32",
                   "bucket_gather": "K9 clustered e4m3 F=256",
                   "halo_wire": "K15 exchange e4m3"}.get(e["name"])
            if key is not None:
                e["parent_ab"] = ab[key]
            if e["name"].startswith("block_dense_grouped_t"):
                # the alternative: K16 over a transposed copy of A
                e["alternative_transposed_copy"] = ab[
                    key.replace("K17", "K17 alt")]
            if e["name"].startswith("gat_bwd_src"):
                e["dh41"]["parent_ab"] = ab[f"{key} dh=41"]
            if e["name"] == "spmm_mean":
                e["serving_f602"]["parent_ab"] = ab["K1 serving f32 F=602"]
            if e["name"] == "spmm_mean_t":
                # the witness without locality (random rows)
                e["parent_ab_serving"] = ab["K3 serving f32 F=256"]
            if e["name"].startswith("gat_fwd"):
                row = key.split()[-1]
                e["eval"]["parent_ab"] = ab[f"K6 eval {row}"]
            if e["name"] == "part_amax":
                e["backward"]["parent_ab"] = ab["K11 deg"]
            if e["name"] == "halo_return":
                e["parent_ab_batched"] = ab["K5 batched"]
            if e["name"] == "bucket_gather":
                e["parent_ab_others"] = {
                    k: ab[k] for k in ("K9 clustered e5m2 F=256",
                                       "K9 clustered bf16 F=256",
                                       "K9 clustered f32 F=256",
                                       "K9 random e4m3 F=256")}
            if e["name"] == "halo_wire":
                e["parent_ab_others"] = {
                    k: ab[k] for k in ab if k.startswith("K15")
                    and k != "K15 exchange e4m3"}
    print(json.dumps({"kernels": kernels}))

    print(json.dumps({
        "serving": {"dataset": args.dataset,
                    "cuts": ["2 random parts of the full graph (not "
                             "metis)", "--local-reorder none (no second "
                             "clustering of the full graph)"],
                    "refresh_ms":
                    serve_stats["refresh_ms"], "p50_ms": summary["p50_ms"],
                    "p99_ms": summary["p99_ms"], "qps": summary["qps"],
                    "n_queries": summary["n_queries"],
                    "peak_mem_gib": serve_stats["peak_mem_gib"],
                    "load_data_s": load_s,
                    "artifact_build_s": serve_stats["artifact_build_s"],
                    "engine_build_s": serve_stats["engine_build_s"],
                    "logits_max_abs_err": serve_stats["logits_max_abs_err"],
                    **pp}}))
    fr = {k: v for k, v in fresh_stats.items() if k != "k18"}
    print(json.dumps({"serving_freshness": {
        "dataset": args.dataset,
        "cell": "bench.py --serve: graphsage 602 -> 256 x3 -> 41, "
                "LayerNorm, use_pp off, dropout 0, 2 random parts of the "
                "full graph, 100 qps, refresh every 0.5 s, 32-row churn "
                "every 0.5 s (10 s), then --update-fraction 0.05 (5 s); "
                "5 s without churn first; GCN 2 s of churn",
        "cuts": ["2 random parts of the full graph (not metis)",
                 "--local-reorder none (the serving artifact)"],
        **fr, "card": smi}}))
    print(json.dumps({"training": {
        "dataset": args.dataset,
        "cell": "scripts/reddit.sh: graphsage 4x256 --use-pp --inductive "
                "--enable-pipeline, dropout 0.5, lr 0.01, 2 parts, "
                "LayerNorm, f32",
        "cuts": [f"{args.train_epochs} epochs (not 3000)"],
        "native_library_s": native_s,
        **train_stats,
        "step_check": step,
        "epoch_ms_median": tt["epoch_ms"],
        "epoch_kernel_ms": tt["epoch_kernel_ms"],
        "epoch_rest_ms": tt["epoch_rest_ms"],
        "launches_per_epoch": tt["launches_per_epoch"],
        "vanilla": vanilla,
        "card": smi}}))
    print(json.dumps({"gat_training": {
        "dataset": args.dataset,
        "cell": "reddit.sh with --model gat --n-heads 4 minus --use-pp "
                "(scripts/gat_bench.py widths): 602 -> 256 x3 -> 41, 4 "
                "heads, LayerNorm, dropout 0.5, lr 0.01, pipelined, "
                "--inductive, 2 parts, f32",
        "cuts": [f"{args.gat_epochs} epochs (not 3000)",
                 "f32 (gat_bench.py runs bf16: the bf16_gat_training "
                 "line)"],
        **gat_stats, "step_check": gat_step, **gat_split,
        "gcn": gcn_stats, "card": smi}}))
    print(json.dumps({"bucket_training": {
        "dataset": args.dataset,
        "cell": "scripts/reddit.sh + --spmm-impl bucket --rem-dtype float8: "
                "graphsage 4x256 --use-pp --inductive --enable-pipeline, "
                "dropout 0.5, lr 0.01, 2 parts, LayerNorm, f32 compute, "
                "e4m3 / e5m2 gather transport",
        "cuts": [f"{args.bucket_epochs} epochs (not 3000)"],
        "bf16": bf16_bucket,
        **bucket_stats, "step_check": bucket_step, **bucket_split,
        "gcn": bucket_gcn, "card": smi}}))
    print(json.dumps({"block_training": {
        "dataset": args.dataset,
        "cell": "scripts/reddit.sh + --spmm-impl block --rem-dtype float8: "
                "graphsage 4x256 --use-pp --inductive --enable-pipeline, "
                "dropout 0.5, lr 0.01, 2 parts, LayerNorm, f32 compute, "
                "256 x 256 dense tiles (K12/K13) plus an e4m3 / e5m2 "
                "bucket remainder (K9/K10), --local-reorder cluster",
        "cuts": [f"{args.block_epochs} epochs (not 3000)"],
        **block_stats, "step_check": block_step, **block_split,
        "kernel_timings": kt, "kernel_timings_bf16": kt16,
        "bf16": bf16_block, "gcn": block_gcn,
        "serving_through_tables": table_serving, "card": smi}}))
    print(json.dumps({"bf16_gat_training": {
        "dataset": args.dataset,
        "cell": "scripts/gat_bench.py: --model gat --n-heads 4 --n-layers "
                "4 --n-hidden 256 --dtype bfloat16 --spmm-impl bucket "
                "--rem-dtype float8, with reddit.sh's --inductive "
                "--enable-pipeline, dropout 0.5, lr 0.01, LayerNorm, 2 "
                "metis parts",
        "cuts": [f"{args.bf16_gat_epochs} epochs (not 3000), then 2 each "
                 f"of --rem-dtype bfloat16 and none"],
        **bf16_gat, "step_check": bf16_gat_step,
        "xla_graphsage_bf16": bf16_xla, "card": smi}}))
    print(json.dumps({"wire_block_training": {
        "dataset": args.dataset,
        "cell": "union-gather block + fp8 halo wire: scripts/reddit.sh + "
                "--dtype bfloat16 " + " ".join(WIRE_FLAGS) + " (graphsage "
                "4x256 --use-pp --inductive --enable-pipeline, dropout 0.5,"
                " lr 0.01, LayerNorm, 2 metis parts, the cluster layout)",
        "cuts": [f"{args.wire_epochs} epochs (not 3000), then 2 each of "
                 f"--halo-dtype bfloat16 and none"],
        **wire_stats, "step_check": wire_step, "kernel_timings": wt,
        "tile_timings": gt32, "tile_timings_bf16": gt16b, "card": smi}}))
    print(json.dumps({"integrity_training": {
        "dataset": args.dataset,
        "cell": "scripts/reddit.sh + --integrity-check-every 2: graphsage "
                "4x256 --use-pp --inductive --enable-pipeline, dropout 0.5, "
                "lr 0.01, LayerNorm, f32, 2 metis parts; drills "
                "bitflip@3:<params|carry|tables|halo>, 8 epochs, eval off",
        "cuts": [f"{args.integrity_epochs} epochs (not 3000)"],
        **integ_stats, "k19_timings": k19t, "card": smi}}))
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
