"""bf16 compute (ModelConfig(dtype="bfloat16")) in the port against the JAX
package on the CPU: the dense layers, LayerNorm and the GraphSAGE, GCN and
GAT forwards; the stale-concat backward (K4's plain version); the bucket
and block aggregations in both directions; and the trainer (GraphSAGE on
xla, bucket and block, GCN and GAT on bucket) against JAX's emulated
trainer at dropout 0.

Tolerances. Both packages round to bf16 at the same places, but the f32
values they round can differ in their last bits (another summation order,
a multiply by 1/deg where JAX divides), and then a rounding can land one
bf16 step apart: an element is held within 2 bf16 ulps of its own
magnitude (``BF16_ULPS``) where one rounding stands between the f32 sums,
bit-exact where the inputs of the rounding are the same (the stale concat
at P = 2). Whole models follow ROADMAP's bf16 rtol of 2e-2: losses over 3
epochs, and params and carries within 2e-2 of their max. The trainers run
on JAX's transported values and relu masks (tapped as
test_torch_train_bucket_transport.py taps them), with the flips counted:
a value within a rounding of a midpoint of the narrow format (or of 0)
moves by a whole step of it, a jump no rounding tolerance bounds."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import pipegcn_tpu.ops.block_spmm as jblk
import pipegcn_tpu.ops.bucket_spmm as jbs
from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.models import sage as jsage
from pipegcn_tpu.parallel.halo import make_stale_concat as jax_msc
from pipegcn_tpu.parallel.trainer import TrainConfig as JaxTrainConfig
from pipegcn_tpu.parallel.trainer import Trainer as JaxTrainer
from pipegcn_tpu_torch.models import ModelConfig, first_copy, params_from_jax
from pipegcn_tpu_torch.models.sage import _dense, _layer_norm, forward
from pipegcn_tpu_torch.ops import block_spmm as pblk
from pipegcn_tpu_torch.ops import bucket_spmm as pbs
from pipegcn_tpu_torch.ops.bucket_spmm import TransportShare
from pipegcn_tpu_torch.ops.spmm import csr_indptr
from pipegcn_tpu_torch.parallel.halo import make_stale_concat, send_csr
from pipegcn_tpu_torch.parallel.trainer import TrainConfig, Trainer
from pipegcn_tpu_torch.tree import tree_leaves
from test_torch_block import _staged
from test_torch_block import sharded as block_sharded
from test_torch_bucket import sharded as bucket_sharded
from test_torch_bucket import to_torch
from test_torch_halo import _repeat_case
from test_torch_train import (CPU, MODES, SIZES, one_torch_thread,
                              port_sharded, sharded)
from test_torch_train_bucket_transport import JaxTap

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

BF16 = torch.bfloat16
BF16_ULPS = 2
RTOL = 2e-2
# relu and transport flips as a share of their elements. XLA's jit keeps
# excess precision (its default xla_allow_excess_precision) where a bf16
# result is widened again inside one fusion (a dense layer's output into
# LayerNorm), where the port rounds as the JAX program says, as JAX's own
# eager mode does (test_the_port_rounds_where_the_program_says): 30-50 %
# of the activations then differ by one bf16 step, and a bf16 value's
# e4m3 cast moves with it in about one case in eight (measured 1.6-2.9 %
# of GraphSAGE's transported elements; relu flips 5e-4 of the relu
# elements). GAT's z transport reads the matmul's output, which XLA casts
# to e4m3 from the unrounded f32 product where the program rounds it to
# bf16 first: 14 % of its transported elements differ. The shared values
# keep both runs on JAX's; the bound only catches a cast of another
# tensor.
FLIP_FRAC = 1e-2
TRANSPORT_FLIP_FRAC = 0.25


def bf16_np(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def t_bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16)


def assert_ulps(got, want, what="", ulps=BF16_ULPS, atol=0.0):
    """|got - want| within ``ulps`` bf16 steps of want's magnitude (a
    step is at most 2**-7 of it) plus ``atol``."""
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    tol = ulps * 2.0 ** -7 * np.abs(want) + atol
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, int(bad.sum()),
                           float(np.abs(got - want).max()))


def close_to_max(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# dense, LayerNorm, the layer forwards


def test_dense_rounds_the_f32_product_once():
    """A hidden dense layer: bf16 x times the bf16-cast weight into bf16
    plus the bf16-cast bias (JAX ``dense`` with out_dtype bf16); the
    logits layer: the same bf16 operands into an f32 product plus the f32
    bias, never rounded to bf16."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    w = rng.uniform(-.3, .3, (48, 24)).astype(np.float32)
    b = rng.uniform(-.3, .3, (24,)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    for out_dt, t_dt in ((jnp.bfloat16, BF16), (jnp.float32, torch.float32)):
        want = jnp.matmul(xb, jnp.asarray(w).astype(jnp.bfloat16),
                          preferred_element_type=out_dt) \
            + jnp.asarray(b).astype(out_dt)
        got = _dense(t_bf16(x), torch.from_numpy(w), torch.from_numpy(b),
                     t_dt)
        assert got.dtype == t_dt
        if t_dt == BF16:
            assert_ulps(got, np.asarray(want, np.float32), "hidden dense")
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
            # exact products: the f32 sum of the bf16 operands
            ref = (t_bf16(x).double() @ torch.from_numpy(w).to(BF16)
                   .double()).numpy() + b
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-6)


def test_layer_norm_keeps_f32_statistics():
    rng = np.random.default_rng(1)
    h = (3 + rng.standard_normal((50, 32)) * 4).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(32)).astype(np.float32)
    want = jsage._layer_norm(jnp.asarray(bf16_np(h)), scale, bias)
    got = _layer_norm(t_bf16(h), torch.from_numpy(scale),
                      torch.from_numpy(bias))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_ulps(got, np.asarray(want, np.float32), "layer norm", ulps=1)


def test_the_port_rounds_where_the_program_says():
    """A dense layer into LayerNorm at bf16: the port rounds the dense
    output to bf16 and LayerNorm widens it again, as the JAX program
    states and as JAX computes it op by op (eager), bit for bit. (Under
    jit XLA may skip that rounding, keeping excess precision: the JAX
    trainer's activations then differ from these by a bf16 step in a share
    of the elements.)"""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((200, 24)).astype(np.float32)
    w = rng.uniform(-.4, .4, (24, 16)).astype(np.float32)
    b = rng.uniform(-.3, .3, (16,)).astype(np.float32)
    sc = (1 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(16)).astype(np.float32)
    xb = jnp.asarray(bf16_np(x))
    y = jnp.matmul(xb, jnp.asarray(w).astype(jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16) \
        + jnp.asarray(b).astype(jnp.bfloat16)
    want = np.asarray(jsage._layer_norm(y, sc, bi), np.float32)
    got = _layer_norm(_dense(t_bf16(x), torch.from_numpy(w),
                             torch.from_numpy(b), BF16),
                      torch.from_numpy(sc), torch.from_numpy(bi))
    np.testing.assert_array_equal(got.float().numpy(), want)


def _graph():
    g = synthetic_graph(num_nodes=300, avg_degree=8, n_feat=12, n_class=5,
                        seed=4)
    order = np.argsort(g.dst, kind="stable")
    return g, g.src[order].astype(np.int32), g.dst[order].astype(np.int32)


@pytest.mark.parametrize("model,use_pp", [("graphsage", True),
                                          ("graphsage", False),
                                          ("gcn", False), ("gat", False)])
def test_full_graph_forward_matches_jax(model, use_pp):
    """The eval forward of the whole model at bf16 (dense layers, the
    aggregations, GCN's scalings, GAT's attention, LayerNorm, relu): the
    f32 logits within 2e-2 of their max."""
    g, src, dst = _graph()
    N = g.num_nodes
    sizes = (12, 16, 16, 5)
    kw = dict(layer_sizes=sizes, model=model, use_pp=use_pp, norm="layer",
              dropout=0.0, dtype="bfloat16")
    jcfg = jsage.ModelConfig(**kw, sorted_edges=True)
    tree = jax.tree_util.tree_map(
        np.asarray, jsage.init_params(jax.random.PRNGKey(3), jcfg))
    deg = np.maximum(np.bincount(dst, minlength=N), 1).astype(np.float32)
    feat = np.asarray(g.ndata["feat"], np.float32)
    want, _ = jsage.forward(tree, jcfg, jnp.asarray(feat), jnp.asarray(src),
                            jnp.asarray(dst), jnp.asarray(deg), N,
                            training=False, eval_pp_agg=use_pp)
    got = forward(params_from_jax(tree, CPU), ModelConfig(**kw),
                  torch.from_numpy(feat)[None],
                  torch.from_numpy(csr_indptr(dst, N))[None],
                  torch.from_numpy(src)[None], torch.from_numpy(deg)[None],
                  eval_pp_agg=use_pp)[0]
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close_to_max(got.numpy(), np.asarray(want), model)


# ---------------------------------------------------------------------------
# the stale-concat backward (K4's plain version)


@pytest.mark.parametrize("P", [2, 4])
def test_stale_concat_backward_bf16(P):
    """d_h = g[:n] + the stale bgrad scattered onto the send rows, in bf16
    with a rounding after every add: bit-exact against JAX's bf16
    ``.at[].add`` at P = 2 (one add a row), within one bf16 step a repeat
    at P = 4 (a row takes up to P - 1 adds; JAX's scatter and the port add
    them in slot order)."""
    n_max, B, F = 30, 12, 8
    h, idx, mask = _repeat_case(P, n_max, B, F, seed=20 + P)
    H = (P - 1) * B
    rng = np.random.default_rng(P)
    bgrad = bf16_np(rng.standard_normal((P, H, F)))
    gr = bf16_np(rng.standard_normal((P, n_max + H, F)))
    ptr, slot = (torch.from_numpy(a) for a in send_csr(idx, mask, n_max))
    th = t_bf16(h).requires_grad_(True)
    probe = torch.zeros((P, H, F), dtype=BF16, requires_grad=True)
    out = make_stale_concat(ptr, slot)(
        th, torch.zeros((P, H, F), dtype=BF16), to_torch(bgrad), probe)
    d_h, d_probe = torch.autograd.grad(out, [th, probe], to_torch(gr))
    assert d_h.dtype == BF16
    for p in range(P):
        jop = jax_msc(jnp.asarray(idx[p]), jnp.asarray(mask[p]), n_max)
        _, vjp = jax.vjp(jop, jnp.asarray(bf16_np(h[p])),
                         jnp.zeros((H, F), jnp.bfloat16),
                         jnp.asarray(bgrad[p]), jnp.zeros((H, F),
                                                          jnp.bfloat16))
        w_dh, _, _, w_dp = vjp(jnp.asarray(gr[p]))
        want = np.asarray(w_dh, np.float32)
        if P == 2:
            np.testing.assert_array_equal(d_h[p].float().numpy(), want)
        else:
            assert_ulps(d_h[p], want, "d_h", ulps=P - 2,
                        atol=2.0 ** -8 * np.abs(want).max())
        np.testing.assert_array_equal(d_probe[p].float().numpy(),
                                      np.asarray(w_dp, np.float32))


# ---------------------------------------------------------------------------
# the bucket and block aggregations at bf16


def _jax_side(fn_of_part, fb, g, P):
    outs, grads = [], []
    for p in range(P):
        want, vjp = jax.vjp(fn_of_part(p), jnp.asarray(bf16_np(fb[p])))
        (wg,) = vjp(jnp.asarray(g[p]))
        assert wg.dtype == jnp.bfloat16
        outs.append(np.asarray(want))
        grads.append(np.asarray(wg, np.float32))
    return np.stack(outs), np.stack(grads)


@pytest.mark.parametrize("rem", [None, "bfloat16", "float8"])
@pytest.mark.parametrize("path", ["bucket", "block"])
def test_table_spmm_bf16_matches_jax_vjp(path, rem):
    """BucketSpmm / BlockSpmm on bf16 rows (K9's bf16 gather, K12/K13's
    bf16 mode) against make_device_bucket_spmm_fn /
    make_device_block_spmm_fn: the f32 mean within 1e-5, the bf16
    d_fbuf (bf16(g / deg) through the transpose, JAX ``:686-687``)
    within 2 bf16 ulps; the transports cast the same bf16 inputs, so no
    flip."""
    P, F = 2, 10
    sg = bucket_sharded(P) if path == "bucket" else block_sharded(P)
    n_src = sg.n_max + sg.halo_size
    rng = np.random.default_rng(11)
    fb = rng.standard_normal((P, n_src, F)).astype(np.float32)
    g = rng.standard_normal((P, sg.n_max, F)).astype(np.float32)
    deg = sg.in_deg.astype(np.float32)
    if path == "bucket":
        tables = jbs.build_sharded_bucket_tables(sg)
        staged = pbs.stage_bucket_tables(tables, sg.n_max, n_src, CPU)

        def fn_of_part(p):
            return jbs.make_device_bucket_spmm_fn(
                {k: jnp.asarray(v[p]) for k, v in tables.items()},
                jnp.asarray(deg[p]), n_src, rem_dtype=rem)
        run = pbs.bucket_spmm
    else:
        tables, staged = _staged(sg)

        def fn_of_part(p):
            return jblk.make_device_block_spmm_fn(
                {k: jnp.asarray(v[p]) for k, v in tables.items()},
                jnp.asarray(deg[p]), sg.n_max, n_src, 16, rem_dtype=rem)
        run = pblk.block_spmm
    want_out, want_grad = _jax_side(fn_of_part, fb, g, P)
    share = TransportShare()
    x = t_bf16(fb).requires_grad_(True)
    out = run(x, staged, torch.from_numpy(deg), rem, False, False, share)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and x.grad.dtype == BF16
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5,
                               atol=1e-6)
    assert_ulps(x.grad, want_grad, "d_fbuf",
                atol=1e-6 * np.abs(want_grad).max())
    if rem is not None:
        assert [y.dtype for y, _ in share.recorded] == [
            {"bfloat16": BF16, "float8": torch.float8_e4m3fn}[rem],
            {"bfloat16": BF16, "float8": torch.float8_e5m2}[rem]]


# ---------------------------------------------------------------------------
# the trainer


class Bf16Tap(JaxTap):
    """JaxTap for bf16 runs: records as (rows, -1) f32 arrays (GAT's z
    casts are [R, H, dh] in JAX, [R, H*dh] in the port), and a cast JAX
    repeats on the same input (gat_bwd recasts z, the port keeps the
    forward's) is recorded once."""

    def _keep(self, x, y, inv):
        x = np.array(x, np.float32)
        x = x.reshape(x.shape[0], -1)
        yt = to_torch(np.asarray(y))
        yt = yt.reshape(yt.shape[0], -1)
        inv = float(inv)
        for r in self.records:
            if r[1].dtype == yt.dtype and np.array_equal(r[0], x):
                return
        self.records.append((x, yt, None if np.isnan(inv) else inv))

    def act(self, h):
        m = torch.stack([torch.from_numpy(np.asarray(
            self._nearest(self.relus, h[p].detach().float().numpy())[0],
            np.float32) > 0) for p in range(h.shape[0])])
        self.relu_flips += int((m != (h > 0)).sum())
        self.relu_elements += m.numel()
        return torch.where(m, h, h.new_zeros(()))


CASES = {
    "sage-xla": dict(spmm_impl="xla", use_pp=True),
    "sage-bucket-fp8": dict(spmm_impl="bucket", use_pp=True,
                            rem_dtype="float8"),
    "sage-block-fp8": dict(spmm_impl="block", use_pp=True,
                           rem_dtype="float8", block_tile=32),
    "gcn-bucket-bf16": dict(model="gcn", spmm_impl="bucket",
                            rem_dtype="bfloat16"),
    "gat-bucket-fp8": dict(model="gat", spmm_impl="bucket", n_heads=2,
                           rem_dtype="float8"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_trainer_matches_jax(monkeypatch, case):
    """Pipelined P = 2 at bf16 over 3 epochs against the JAX emulated
    trainer, on JAX's transported values and relu masks: losses within
    2e-2; the bf16 carries after the first epoch (both runs' work from the
    same params) and Adam's first moments after the third within 2e-2 of
    their max, and the params after the third as the comment below
    says."""
    from test_torch_train_block import sharded as cluster_sharded

    kw = dict(layer_sizes=SIZES, norm="layer", dropout=0.0,
              dtype="bfloat16", **CASES[case])
    sg = cluster_sharded(2) if kw["spmm_impl"] == "block" else sharded(2)
    kw["train_size"] = sg.n_train_global
    tap = Bf16Tap(monkeypatch)
    jt = JaxTrainer(sg, jsage.ModelConfig(**kw),
                    JaxTrainConfig(seed=1, emulate_parts=True,
                                   **MODES["pipelined"]))
    params = first_copy(jax.device_get(jt.state["params"]))
    pt = Trainer(port_sharded(sg), ModelConfig(**kw),
                 TrainConfig(seed=1, **MODES["pipelined"]), CPU,
                 params=params_from_jax(params, CPU))
    assert pt.feat.dtype == BF16
    pt.act = tap.act
    shares = []
    jl, pl = [], []
    for e in range(3):
        jl.append(jt.train_epoch(e))
        jax.effects_barrier()
        if kw.get("rem_dtype"):
            pt.share = TransportShare(source=tap.source)
            shares.append(pt.share)
        pl.append(pt.train_epoch(e))
        if e == 0:
            js, ps = jax.device_get(jt.state), pt.host_state()
            assert pt.comm["halo"]["1"].dtype == BF16
            for grp in js["comm"]:
                for k, want in js["comm"][grp].items():
                    close_to_max(ps["comm"][grp][k],
                                 np.asarray(want, np.float32), f"{grp}[{k}]")
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    assert not tap.relus and not tap.records  # every record used
    assert tap.relu_flips <= FLIP_FRAC * tap.relu_elements, (
        tap.relu_flips, tap.relu_elements)
    flips = sum(s.flips for s in shares)
    elements = sum(s.elements for s in shares)
    assert bool(kw.get("rem_dtype")) == (elements > 0)
    assert flips <= TRANSPORT_FLIP_FRAC * max(elements, 1), (flips,
                                                            elements)
    check_moments_and_params(jax.device_get(jt.state), pt.host_state(),
                             RTOL, 3)


def check_moments_and_params(js, ps, tol, epochs, beyond_frac=0.01):
    """Hold a run's host state to the JAX trainer's after ``epochs``."""
    # Adam's first moments are linear in the gradients: within ``tol`` of
    # the largest of them (a small leaf, such as the logits layer's
    # attention vectors, sums terms that cancel). A parameter moves by up
    # to the learning rate a step whichever way its gradient points, so
    # where a near-zero gradient differs in sign the two runs part by up
    # to 2 lr a step: all within that, and at most ``beyond_frac`` of them
    # beyond ``tol`` of their max
    mu_w = tree_leaves(first_copy(js["opt"]["mu"]))
    mu_max = max(float(np.abs(w).max()) for w in mu_w)
    for w, gv in zip(mu_w, tree_leaves(ps["opt"]["mu"])):
        np.testing.assert_allclose(gv, w, rtol=0, atol=tol * mu_max,
                                   err_msg="mu")
    lr, beyond, total = TrainConfig().lr, 0, 0
    for w, gv in zip(tree_leaves(first_copy(js["params"])),
                     tree_leaves(ps["params"])):
        w, gv = np.asarray(w, np.float64), np.asarray(gv, np.float64)
        d = np.abs(gv - w)
        assert d.max() <= tol * np.abs(w).max() + 2 * lr * epochs, "params"
        beyond += int((d > tol * np.abs(w).max()).sum())
        total += d.size
    assert beyond <= beyond_frac * total, (beyond, total)
