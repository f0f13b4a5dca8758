"""GAT's gather transport (``rem_dtype``) and GAT at bf16 compute in the
port against the JAX package on the CPU.

- The attention op (``ops.gat.gat_attention_plain`` with ``rem_dtype``
  float8 / bfloat16, z in f32 or bf16) against ``make_device_gat_fn``
  with the same ``rem_dtype``: the casts are bit-exact
  (test_torch_bucket.py), so both read the same quantized z and g, and
  out, d_z, d_el and d_er differ in summation order only: the GAT
  tolerances of test_torch_gat.py (out rtol 1e-5, gradients 1e-5 of
  their max), a bf16 d_z within 2 bf16 ulps (its f32 sum rounded once).
- The trainer (spmm_impl bucket, P = 2 pipelined, f32 compute) with each
  transport against the JAX trainer, on JAX's transported values and
  relu masks.
- The raw-edge path at bf16 (``_gat_layer`` without ``gat_fn``, the JAX
  trainer's ``--spmm-impl xla``) autodiffs ``z[src].astype(f32)``: its
  d_z is a bf16 scatter-add, which rounds after every edge and stalls
  at a source of many out-edges. The port accumulates d_z in f32 on
  every path, as ``make_device_gat_fn`` does: against an f64 reference
  only d_z differs, and the port's is the closer (ROADMAP §C, a known,
  intended difference)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegcn_tpu.models import sage as jsage
from pipegcn_tpu.ops.gat_bucket import (build_sharded_gat_tables,
                                        make_device_gat_fn)
from pipegcn_tpu.parallel.trainer import TrainConfig as JaxTrainConfig
from pipegcn_tpu.parallel.trainer import Trainer as JaxTrainer
from pipegcn_tpu_torch.models import ModelConfig, first_copy, params_from_jax
from pipegcn_tpu_torch.ops.bucket_spmm import TransportShare
from pipegcn_tpu_torch.ops.gat import gat_attention_plain
from pipegcn_tpu_torch.parallel.trainer import TrainConfig, Trainer
from test_torch_bf16 import (Bf16Tap, assert_ulps, bf16_np,
                             check_moments_and_params, t_bf16)
from test_torch_gat import (EMPTY, H, N, P, R, SLOPE, close_to_max, graph,
                            inputs, port_csr)
from test_torch_train import (CPU, MODES, SIZES, one_torch_thread,
                              port_sharded, sharded)

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture


def jax_gat_fns(src, dst, rem):
    sg = types.SimpleNamespace(num_parts=P, n_max=N, halo_size=R - N,
                               edge_src=src, edge_dst=dst)
    tables = build_sharded_gat_tables(sg)
    return [make_device_gat_fn({k: jnp.asarray(v[p])
                                for k, v in tables.items()},
                               N, R, H, SLOPE, rem_dtype=rem)
            for p in range(P)]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("rem", ["float8", "bfloat16"])
def test_attention_with_transport_matches_jax(rem, compute):
    """dh = 5: the kernels' 4-element chunks straddle two heads."""
    dh = 5
    src, dst = graph()
    z, el, er, g = inputs(dh)
    if compute == "bfloat16":
        zj, zt = bf16_np(z), t_bf16(z)
    else:
        zj, zt = z, torch.from_numpy(z)
    indptr, srct, tr = port_csr(src, dst)
    zt = zt.requires_grad_(True)
    elt = torch.from_numpy(el).requires_grad_(True)
    ert = torch.from_numpy(er).requires_grad_(True)
    share = TransportShare()
    out = gat_attention_plain(zt, elt, ert, indptr, srct, tr, SLOPE,
                              rem_dtype=rem, share=share)
    out.backward(torch.from_numpy(g))
    assert zt.grad.dtype == zt.dtype
    # one cast of z (the forward's, kept for the backward) and one of g
    narrow = {"float8": (torch.float8_e4m3fn, torch.float8_e5m2),
              "bfloat16": (torch.bfloat16, torch.bfloat16)}[rem]
    assert tuple(y.dtype for y, _ in share.recorded) == narrow
    for p, fn in enumerate(jax_gat_fns(src, dst, rem)):
        want, pull = jax.vjp(fn, jnp.asarray(zj[p]), jnp.asarray(el[p]),
                             jnp.asarray(er[p]))
        dz, de, dr = (np.asarray(x, np.float32)
                      for x in pull(jnp.asarray(g[p])))
        np.testing.assert_allclose(out[p].detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        assert not out[p, EMPTY].any()
        if compute == "bfloat16":
            assert_ulps(zt.grad[p], dz, "d_z", atol=1e-6 * np.abs(dz).max())
        else:
            close_to_max(zt.grad[p].numpy(), dz, "d_z")
        close_to_max(elt.grad[p].numpy(), de, "d_el")
        close_to_max(ert.grad[p].numpy(), dr, "d_er")
    if rem == compute:
        return  # bf16 z through a bf16 transport: the same values
    # the transport changes the result: the test sees it on or off
    plain = gat_attention_plain(zt.detach(), elt.detach(), ert.detach(),
                                indptr, srct, tr, SLOPE)
    assert not torch.allclose(out.detach(), plain, rtol=1e-5, atol=0)


@pytest.mark.parametrize("rem", ["float8", "bfloat16"])
def test_gat_transport_trainer_matches_jax(monkeypatch, rem):
    """GAT on the attention-bucket path with the transport, P = 2
    pipelined, f32 compute, against the JAX trainer on its transported
    values and relu masks: losses over 5 epochs within 1e-4, the carries
    after the first epoch (both runs from the same params) within 1e-5 of
    their max (the GAT tolerance of test_torch_gat.py), Adam's first
    moments after the fifth within 1e-4 of the largest. The params are
    held as in test_torch_bf16.py: a gradient that the e5m2 cotangents
    leave near zero can differ in sign, and Adam then moves that
    parameter by the learning rate either way."""
    sg = sharded(2)
    kw = dict(layer_sizes=SIZES, model="gat", n_heads=2, norm="layer",
              dropout=0.0, train_size=sg.n_train_global, spmm_impl="bucket",
              rem_dtype=rem)
    tap = Bf16Tap(monkeypatch)
    jt = JaxTrainer(sg, jsage.ModelConfig(**kw),
                    JaxTrainConfig(seed=1, emulate_parts=True,
                                   **MODES["pipelined"]))
    params = first_copy(jax.device_get(jt.state["params"]))
    pt = Trainer(port_sharded(sg), ModelConfig(**kw),
                 TrainConfig(seed=1, **MODES["pipelined"]), CPU,
                 params=params_from_jax(params, CPU))
    assert pt.gat_transport == rem
    pt.act = tap.act
    shares, jl, pl = [], [], []
    for e in range(5):
        jl.append(jt.train_epoch(e))
        jax.effects_barrier()
        pt.share = TransportShare(source=tap.source)
        shares.append(pt.share)
        pl.append(pt.train_epoch(e))
        if e == 0:
            js, ps = jax.device_get(jt.state), pt.host_state()
            for grp in js["comm"]:
                for k, want in js["comm"][grp].items():
                    close_to_max(ps["comm"][grp][k], want, f"{grp}[{k}]")
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0]
    assert not tap.records and not tap.relus
    flips = sum(s.flips for s in shares)
    elements = sum(s.elements for s in shares)
    assert elements > 0 and flips <= 1e-3 * elements, (flips, elements)
    # fp8 leaves more gradients near zero than bf16: up to 5 % of the
    # params beyond 1e-4 of their max (13 of 793 seen)
    check_moments_and_params(jax.device_get(jt.state), pt.host_state(),
                             1e-4, 5, beyond_frac=0.05)


def test_raw_path_bf16_dz_differs_and_the_port_is_closer():
    """One source feeding 3,000 destinations, all cotangents positive: the
    JAX raw path's bf16 scatter-add of d_z stalls where an edge's term
    falls under half a bf16 step of the running sum; the port sums in f32
    and rounds once. out, d_el and d_er agree (within a bf16 rounding:
    the raw path's d_el / d_er come back through the bf16 z); d_z does
    not, and the port's is the closer to an f64 reference."""
    n, r_src, dh, h = 3000, 3100, 8, 2
    rng = np.random.default_rng(7)
    other = rng.integers(1, r_src, (n, 3))
    src = np.concatenate([np.zeros((n, 1), np.int64), other], 1).reshape(-1)
    dst = np.repeat(np.arange(n), 4)
    z = bf16_np(rng.uniform(0.5, 1.5, (r_src, h, dh))).astype(np.float32)
    # logits el + er: odd multiples of 2**-6, never exactly 0 (where the
    # raw path's leaky_relu takes slope 1 and the port the slope: ROADMAP
    # §C), exact in bf16
    el = (2 * rng.integers(-40, 40, (r_src, h)) + 1) / 64.0
    er = rng.integers(-20, 20, (n, h)) / 32.0
    el, er = el.astype(np.float32), er.astype(np.float32)
    g = rng.uniform(0.5, 1.0, (n, h, dh)).astype(np.float32)

    # JAX raw path: z's columns plus el / er columns picked by one-hot
    # attention vectors through an identity weight (exact in bf16)
    er_all = np.concatenate([er, np.zeros((r_src - n, h), np.float32)])
    fbuf = np.concatenate([z, el[..., None], er_all[..., None]], -1)
    F = h * (dh + 2)
    lp = {"w": jnp.eye(F, dtype=jnp.float32),
          "b": jnp.zeros((F,), jnp.float32),
          "a_src": jnp.tile(jax.nn.one_hot(dh, dh + 2), (h, 1)),
          "a_dst": jnp.tile(jax.nn.one_hot(dh + 1, dh + 2), (h, 1))}

    def raw(fb):
        out = jsage._gat_layer(fb, lp, jnp.asarray(src, jnp.int32),
                               jnp.asarray(dst, jnp.int32), n, h, SLOPE,
                               False, jnp.float32)
        return out.reshape(n, h, dh + 2)[..., :dh]

    out_j, pull = jax.vjp(raw, jnp.asarray(bf16_np(fbuf.reshape(r_src, F))))
    (d_fb,) = pull(jnp.asarray(g))
    d_fb = np.asarray(d_fb, np.float32).reshape(r_src, h, dh + 2)
    dz_j, del_j, der_j = d_fb[..., :dh], d_fb[..., dh], d_fb[:n, :, dh + 1]

    # the port (plain versions on the CPU) on the same bf16 z
    from pipegcn_tpu_torch.ops.spmm import csr_indptr, csr_transpose

    ip = torch.from_numpy(csr_indptr(dst[None].astype(np.int32), n))
    st = torch.from_numpy(src[None].astype(np.int32))
    tr = tuple(torch.from_numpy(a) for a in csr_transpose(
        src[None].astype(np.int32), dst[None].astype(np.int32), n, r_src))
    zt = t_bf16(z)[None].requires_grad_(True)
    elt = torch.from_numpy(el)[None].requires_grad_(True)
    ert = torch.from_numpy(er)[None].requires_grad_(True)
    out_p = gat_attention_plain(zt, elt, ert, ip, st, tr, SLOPE)
    out_p.backward(torch.from_numpy(g)[None])
    dz_p = zt.grad[0].float().numpy()

    # f64 reference
    lg = el[src].astype(np.float64) + er[dst]
    lg = np.where(lg > 0, lg, SLOPE * lg)
    m = np.full((n, h), -np.inf)
    np.maximum.at(m, dst, lg)
    w = np.exp(lg - m[dst])
    s = np.zeros((n, h))
    np.add.at(s, dst, w)
    alpha = w / s[dst]
    dz_ref = np.zeros((r_src, h, dh))
    np.add.at(dz_ref, src, alpha[..., None] * g[dst])
    out_ref = np.zeros((n, h, dh))
    np.add.at(out_ref, dst, alpha[..., None] * z[src])

    np.testing.assert_allclose(out_p[0].detach().numpy(), out_ref,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_j), out_ref, rtol=1e-5,
                               atol=1e-6)
    assert_ulps(elt.grad[0], del_j, "d_el", ulps=1,
                atol=1e-3 * np.abs(del_j).max())
    assert_ulps(ert.grad[0], der_j, "d_er", ulps=1,
                atol=1e-3 * np.abs(der_j).max())
    err_p = np.abs(dz_p - dz_ref).max(axis=(1, 2))
    err_j = np.abs(dz_j - dz_ref).max(axis=(1, 2))
    # the port: one bf16 rounding of the f32 sum everywhere
    assert_ulps(dz_p, dz_ref, "port d_z", ulps=1)
    # the hub row: the raw path's bf16 accumulation stalls far off
    assert err_j[0] > 20 * max(err_p[0], 2.0 ** -8 * abs(dz_ref[0]).max())
    # elsewhere either may be the closer by a rounding; not in sum
    assert err_p.sum() < err_j.sum()
