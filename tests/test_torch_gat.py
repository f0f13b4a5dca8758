"""The port's GAT attention (ops/gat.py, plain versions on the CPU) against
both JAX formulations of the same function: the raw-edge aggregation of
``models/sage.py:_gat_layer`` (gat_fn None) and ``ops/gat_bucket.py``'s
``make_device_gat_fn`` over ``build_sharded_gat_tables``.

Inputs are made from a seed with numpy: P = 2 parts, each with halo rows
(R > n source rows), an empty destination row, a heavy row (250
in-edges), pad edges at the tail (dst = n, src = 0), H = 4 heads of
dh = 4 or 5 (a head width that is not a multiple of 4 straddles the
16-byte vectors the kernels load). Forward within rtol 1e-5, atol 1e-6;
backward ``(d_z, d_el, d_er)`` within 1e-5 of each tensor's max against
``jax.vjp`` of both (the three differ only in summation order, and the
JAX raw path clamps an empty row's normaliser with ``max(s, 1e-16)``
where the port and gat_bucket use ``s = 1``: both give out = 0 there).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegcn_tpu.models.sage import _gat_layer as jax_gat_layer
from pipegcn_tpu.ops.gat_bucket import (build_sharded_gat_tables,
                                        make_device_gat_fn)
from pipegcn_tpu_torch.models.sage import _gat_layer
from pipegcn_tpu_torch.ops.gat import (LeakyBranch, gat_attention_plain,
                                       gat_bwd_src_plain, gat_d_er,
                                       gat_fwd_plain)
from pipegcn_tpu_torch.ops.spmm import csr_indptr, csr_transpose

pytestmark = pytest.mark.torch

P, N, R, H, SLOPE = 2, 40, 70, 4, 0.2
EMPTY, HEAVY = 3, 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def graph(seed=0):
    """Stacked dst-sorted, sentinel-padded edge lists [P, E] over n = N
    destinations and R = N + halo source rows."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(P):
        deg = rng.integers(1, 8, N)
        deg[EMPTY] = 0
        deg[HEAVY] = 250
        dst = np.repeat(np.arange(N), deg)
        parts.append((rng.integers(0, R, dst.size), dst))
    e_max = max(d.size for _, d in parts) + 5
    src = np.zeros((P, e_max), np.int32)
    dst = np.full((P, e_max), N, np.int32)
    for p, (s, d) in enumerate(parts):
        src[p, :s.size], dst[p, :d.size] = s, d
    return src, dst


def inputs(dh, seed=1):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((P, R, H, dh)).astype(np.float32)
    el = rng.standard_normal((P, R, H)).astype(np.float32)
    er = rng.standard_normal((P, N, H)).astype(np.float32)
    g = rng.standard_normal((P, N, H, dh)).astype(np.float32)
    return z, el, er, g


def port_csr(src, dst):
    it, dt = csr_transpose(src, dst, N, R)
    return (torch.from_numpy(csr_indptr(dst, N)), torch.from_numpy(src),
            (torch.from_numpy(it), torch.from_numpy(dt)))


def jax_raw(z, el, er, src, dst):
    """``_gat_layer``'s raw-edge aggregation as a function of (z, el, er)
    of one part: each head's row carries two extra columns holding el
    and er, picked out by one-hot a_src / a_dst through an identity
    weight (exact in f32), and the output drops them again."""
    dh = z.shape[-1]
    er_all = jnp.concatenate([er, jnp.zeros((R - N, H), jnp.float32)])
    fbuf = jnp.concatenate([z, el[..., None], er_all[..., None]], -1)
    F = H * (dh + 2)
    lp = {"w": jnp.eye(F, dtype=jnp.float32),
          "b": jnp.zeros((F,), jnp.float32),
          "a_src": jnp.tile(jax.nn.one_hot(dh, dh + 2), (H, 1)),
          "a_dst": jnp.tile(jax.nn.one_hot(dh + 1, dh + 2), (H, 1))}
    out = jax_gat_layer(fbuf.reshape(R, F), lp, jnp.asarray(src),
                        jnp.asarray(dst), N, H, SLOPE, False, jnp.float32)
    return out.reshape(N, H, dh + 2)[..., :dh]


def jax_bucket_fns(src, dst):
    sg = types.SimpleNamespace(num_parts=P, n_max=N, halo_size=R - N,
                               edge_src=src, edge_dst=dst)
    tables = build_sharded_gat_tables(sg)
    return [make_device_gat_fn({k: jnp.asarray(v[p])
                                for k, v in tables.items()},
                               N, R, H, SLOPE) for p in range(P)]


def jax_vjp(fn, z, el, er, g):
    out, pull = jax.vjp(fn, jnp.asarray(z), jnp.asarray(el), jnp.asarray(er))
    return np.asarray(out), [np.asarray(x) for x in pull(jnp.asarray(g))]


def close_to_max(got, want, name):
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("form", ["raw", "bucket"])
@pytest.mark.parametrize("dh", [4, 5])
def test_attention_matches_jax(form, dh):
    src, dst = graph()
    z, el, er, g = inputs(dh)
    indptr, srct, tr = port_csr(src, dst)
    zt = torch.from_numpy(z).requires_grad_(True)
    elt = torch.from_numpy(el).requires_grad_(True)
    ert = torch.from_numpy(er).requires_grad_(True)
    out = gat_attention_plain(zt, elt, ert, indptr, srct, tr, SLOPE)
    out.backward(torch.from_numpy(g))
    fns = jax_bucket_fns(src, dst) if form == "bucket" else None
    for p in range(P):
        fn = fns[p] if fns else (
            lambda a, b, c, p=p: jax_raw(a, b, c, src[p], dst[p]))
        want, (dz, de, dr) = jax_vjp(fn, z[p], el[p], er[p], g[p])
        np.testing.assert_allclose(out[p].detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        assert not out[p, EMPTY].any()
        close_to_max(zt.grad[p].numpy(), dz, "d_z")
        close_to_max(elt.grad[p].numpy(), de, "d_el")
        close_to_max(ert.grad[p].numpy(), dr, "d_er")
        # rows without edges: zero output, and their el / er get nothing
        assert not ert.grad[p, EMPTY].any()


@pytest.mark.parametrize("dh", [4, 5])
def test_each_plain_pass_matches_jax(dh):
    """K6's and K8's plain versions alone against the JAX raw path's
    forward and its VJP's (d_z, d_el); pass A (``gat_d_er`` over the
    forward's negative-branch sums) against its d_er; m and s against
    the raw path's row max and normaliser. The forward's neg mode leaves
    out, m and s as they are without it."""
    src, dst = graph(2)
    z, el, er, g = inputs(dh, 3)
    indptr, srct, (it, dt) = port_csr(src, dst)
    args = [torch.from_numpy(x) for x in (z, el, er)]
    out, m, s, n_neg, w_neg = gat_fwd_plain(*args, indptr, srct, SLOPE,
                                            neg=True)
    for a, b in zip(gat_fwd_plain(*args, indptr, srct, SLOPE), (out, m, s)):
        assert torch.equal(a, b)
    gt = torch.from_numpy(g)
    rho = (gt * out).sum(-1)
    d_er = gat_d_er(gt, rho, n_neg, w_neg, SLOPE)
    d_z, d_el = gat_bwd_src_plain(*args, m, s, gt, rho, it, dt, SLOPE)
    for p in range(P):
        want, (dz, de, dr) = jax_vjp(
            lambda a, b, c, p=p: jax_raw(a, b, c, src[p], dst[p]),
            z[p], el[p], er[p], g[p])
        np.testing.assert_allclose(out[p].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        close_to_max(d_er[p].numpy(), dr, "pass A: d_er")
        close_to_max(d_z[p].numpy(), dz, "pass B: d_z")
        close_to_max(d_el[p].numpy(), de, "pass B: d_el")
        real = dst[p] < N
        lg = np.where(el[p][src[p][real]] + er[p][dst[p][real]] > 0,
                      el[p][src[p][real]] + er[p][dst[p][real]],
                      SLOPE * (el[p][src[p][real]] + er[p][dst[p][real]]))
        m_ref = np.full((N, H), -np.inf, np.float32)
        np.maximum.at(m_ref, dst[p][real], lg)
        m_ref[EMPTY] = 0.0
        np.testing.assert_array_equal(m[p].numpy(), m_ref)
        assert (s[p, EMPTY] == 1).all() and (s[p] >= 1).all()


def test_plain_passes_do_not_depend_on_the_chunk():
    src, dst = graph(4)
    z, el, er, g = inputs(5, 5)
    indptr, srct, (it, dt) = port_csr(src, dst)
    args = [torch.from_numpy(x) for x in (z, el, er)]
    gt = torch.from_numpy(g)
    runs = []
    for chunk in (7, 1 << 20):
        out, m, s, n_neg, w_neg = gat_fwd_plain(*args, indptr, srct, SLOPE,
                                                chunk=chunk, neg=True)
        rho = (gt * out).sum(-1)
        runs.append([out, m, s, n_neg, w_neg,
                     *gat_bwd_src_plain(*args, m, s, gt, rho, it, dt, SLOPE,
                                        chunk=chunk)])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_leaky_branch_counts_flips_and_overrides():
    """With another run's el / er as the branch, the plain versions take
    that run's leaky branch of every edge and count where their own
    logits disagree; with the run's own el / er, nothing flips and the
    result is unchanged."""
    src, dst = graph(6)
    z, el, er, _ = inputs(4, 7)
    indptr, srct, tr = port_csr(src, dst)
    zt, elt, ert = (torch.from_numpy(x) for x in (z, el, er))
    base = gat_attention_plain(zt, elt, ert, indptr, srct, tr, SLOPE)
    same = LeakyBranch(elt, ert)
    assert torch.equal(gat_attention_plain(zt, elt, ert, indptr, srct, tr,
                                           SLOPE, same), base)
    n_real = sum(int((dst[p] < N).sum()) for p in range(P))
    assert same.flips == 0 and same.elements == n_real * H
    other = LeakyBranch(-elt, -ert)
    flipped = gat_attention_plain(zt, elt, ert, indptr, srct, tr, SLOPE,
                                  other)
    assert other.flips == other.elements == n_real * H
    assert not torch.allclose(flipped, base)


def test_gat_layer_parameter_gradients_match_jax():
    """The whole layer (z = fbuf @ w, el / er, attention, head concat or
    mean, bias) and its parameter and input gradients against jax.vjp of
    ``_gat_layer``, on the hidden (dh = d_out / H) and the logits layer
    (dh = d_out, heads averaged)."""
    src, dst = graph(8)
    indptr, srct, tr = port_csr(src, dst)
    rng = np.random.default_rng(9)
    d_in = 12
    for is_last, d_out in ((False, 16), (True, 5)):
        dh = d_out if is_last else d_out // H
        fbuf = rng.standard_normal((P, R, d_in)).astype(np.float32)
        lp = {"w": rng.uniform(-.3, .3, (d_in, H * dh)),
              "b": rng.uniform(-.3, .3, (d_out,)),
              "a_src": rng.uniform(-.5, .5, (H, dh)),
              "a_dst": rng.uniform(-.5, .5, (H, dh))}
        lp = {k: v.astype(np.float32) for k, v in lp.items()}
        g = rng.standard_normal((P, N, d_out)).astype(np.float32)
        ft = torch.from_numpy(fbuf).requires_grad_(True)
        lpt = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in lp.items()}
        out = _gat_layer(ft, lpt, N, H, is_last,
                         lambda z, el, er: gat_attention_plain(
                             z, el, er, indptr, srct, tr, SLOPE))
        out.backward(torch.from_numpy(g))
        d_params = {k: 0.0 for k in lp}
        for p in range(P):
            def fn(fb, params, p=p):
                return jax_gat_layer(fb, params, jnp.asarray(src[p]),
                                     jnp.asarray(dst[p]), N, H, SLOPE,
                                     is_last, jnp.float32)

            want, pull = jax.vjp(fn, jnp.asarray(fbuf[p]),
                                 {k: jnp.asarray(v) for k, v in lp.items()})
            d_fb, d_lp = pull(jnp.asarray(g[p]))
            np.testing.assert_allclose(out[p].detach().numpy(), want,
                                       rtol=1e-5, atol=1e-6)
            close_to_max(ft.grad[p].numpy(), np.asarray(d_fb), "d_fbuf")
            for k in lp:  # parameter gradients sum over the parts
                d_params[k] = d_params[k] + np.asarray(d_lp[k])
        for k in lp:
            close_to_max(lpt[k].grad.numpy(), d_params[k], f"d_{k}")


@pytest.mark.parametrize("model", ["gat", "gcn"])
def test_params_trees_of_gat_and_gcn(model):
    """params_from_jax carries the JAX init's gat / gcn trees leaf for
    leaf, and the port's own init has the same keys, shapes and bounds
    (U(-1/sqrt(fan_in), +) for w and b, U(-1/sqrt(dh), +) for a_src and
    a_dst; dh = d_out / H on hidden layers, d_out on the logits layer)."""
    from pipegcn_tpu.models import sage as jsage
    from pipegcn_tpu_torch.models import ModelConfig, init_params
    from pipegcn_tpu_torch.models import params_from_jax

    sizes = (12, 16, 8, 5)
    jcfg = jsage.ModelConfig(layer_sizes=sizes, model=model, n_heads=4)
    tree = jax.tree_util.tree_map(
        np.asarray, jsage.init_params(jax.random.PRNGKey(0), jcfg))
    cpu = torch.device("cpu")
    conv = params_from_jax(tree, cpu)
    own = init_params(ModelConfig(layer_sizes=sizes, model=model,
                                  n_heads=4), torch.Generator().manual_seed(0),
                      cpu)
    want_keys = {"gat": ["a_dst", "a_src", "b", "w"], "gcn": ["b", "w"]}
    for i, jl in enumerate(tree["layers"]):
        assert sorted(jl) == sorted(conv["layers"][i]) \
            == sorted(own["layers"][i]) == want_keys[model]
        for k, v in jl.items():
            np.testing.assert_array_equal(conv["layers"][i][k].numpy(), v)
            assert tuple(own["layers"][i][k].shape) == v.shape, (i, k)
            fan = v.shape[1] if k.startswith("a_") else sizes[i]
            assert float(own["layers"][i][k].abs().max()) <= fan ** -0.5
    if model == "gat":
        assert tree["layers"][0]["w"].shape == (12, 16)
        assert tree["layers"][0]["a_src"].shape == (4, 4)
        assert tree["layers"][2]["a_dst"].shape == (4, 5)
    assert len(conv["norms"]) == len(own["norms"]) == 2


def test_gat_config_checks_follow_jax():
    from pipegcn_tpu_torch.models import ModelConfig

    with pytest.raises(ValueError, match="use_pp"):
        ModelConfig(layer_sizes=(4, 8, 3), model="gat", use_pp=True)
    with pytest.raises(ValueError, match="divisible"):
        ModelConfig(layer_sizes=(4, 6, 3), model="gat", n_heads=4)
    with pytest.raises(ValueError, match="n_heads"):
        ModelConfig(layer_sizes=(4, 8, 3), model="gat", n_heads=0)
    with pytest.raises(ValueError, match="does not apply to gat"):
        ModelConfig(layer_sizes=(4, 8, 3), model="gat", spmm_impl="block")
    with pytest.raises(ValueError, match="unknown model"):
        ModelConfig(layer_sizes=(4, 8, 3), model="gin")
    for impl in ("xla", "bucket", "auto"):
        assert ModelConfig(layer_sizes=(4, 8, 3), model="gat",
                           spmm_impl=impl).spmm_impl == impl
    assert ModelConfig(layer_sizes=(4, 8, 3), rem_dtype="none").rem_dtype \
        is None


def _fma32(a, b, c):
    """f32 fused multiply-add, emulated: the exact product (f64 holds a
    product of two f32) plus c, rounded once to f32 (a double rounding in
    rare ties: the emulation is held at the f32 tolerance, not bit for
    bit)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def k6_emulated(z, el, er, indptr, src):
    """K6's arithmetic in its NEG mode (``csrc/gat_attn.cuh``) on f32 z
    rows, one part, in f32: the row max over the edges' leaky logits; per
    32-edge chunk, lane l takes edge l of the chunk, its weight exp(logit
    - m), and adds it into its own s and (negative branch) w_neg sums,
    which a xor butterfly over the 32 lanes combines; each edge adds
    weight * z[src] (one fused multiply-add an element) in edge order:
    where dh is a multiple of the kernel's 4-element chunk, into the sum
    of its leaky branch, out = (pos + neg) / s; otherwise (on f32 rows the
    chunks straddle two heads) into a sum over all edges and, on the
    negative branch, one over those, out = all / s. n_neg = neg / s,
    w_neg = sum / s; a row without edges gets m = 0, s = 1 and zeros."""
    n, (R, Hh, dh) = indptr.shape[0] - 1, z.shape
    out = np.zeros((n, Hh, dh), np.float32)
    n_neg = np.zeros_like(out)
    m = np.zeros((n, Hh), np.float32)
    s = np.ones((n, Hh), np.float32)
    w_neg = np.zeros((n, Hh), np.float32)
    for d in range(n):
        e0, e1 = int(indptr[d]), int(indptr[d + 1])
        if e0 == e1:
            continue
        cols = np.clip(src[e0:e1], 0, R - 1)
        lp = (el[cols] + er[d]).astype(np.float32)
        lg = np.where(lp > 0, lp, np.float32(SLOPE) * lp)
        m[d] = lg.max(0)
        w = np.exp(lg - m[d]).astype(np.float32)
        wn = np.where(lp > 0, np.float32(0), w)
        lanes = np.zeros((2, 32, Hh), np.float32)
        for j in range(e1 - e0):
            lanes[0, j % 32] += w[j]
            lanes[1, j % 32] += wn[j]
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ off]
        s[d], nsum = lanes[0, 0], lanes[1, 0]
        split = dh % 4 == 0
        pos = np.zeros((Hh, dh), np.float32)
        neg = np.zeros((Hh, dh), np.float32)
        for j, c in enumerate(cols):
            on_neg = (lp[j] <= 0)[:, None]
            neg = np.where(on_neg, _fma32(w[j][:, None], z[c], neg), neg)
            if split:
                pos = np.where(on_neg, pos,
                               _fma32(w[j][:, None], z[c], pos))
            else:
                pos = _fma32(w[j][:, None], z[c], pos)
        out[d] = ((pos + neg) if split else pos) / s[d][:, None]
        n_neg[d] = neg / s[d][:, None]
        w_neg[d] = nsum / s[d]
    return out, m, s, n_neg, w_neg


@pytest.mark.parametrize("dh", [41, 64])
def test_k6_arithmetic_matches_jax_forward(dh):
    """K6's arithmetic (``k6_emulated``: per-branch sums at dh = 64, a
    sum over all edges and one over the negative branch at dh = 41) on a
    graph with a 250-edge row (eight 32-edge chunks) and an empty one,
    against JAX's
    ``make_device_gat_fn`` forward: out, m and s from its forward pass,
    n_neg and w_neg from the same m and s over the negative-branch edges;
    and pass A's d_er (``gat_d_er`` over the emulation's n_neg, w_neg)
    against the d_er of JAX's VJP. At the f32 tolerance (rtol 1e-5, atol
    1e-6; d_er 1e-5 of its max)."""
    src, dst = graph(10)
    z, el, er, g = inputs(dh, 11)
    indptr = csr_indptr(dst, N)
    fns = jax_bucket_fns(src, dst)
    for p in range(P):
        got = k6_emulated(z[p], el[p], er[p], indptr[p], src[p])
        out, (_, _, _, _, m, s) = fns[p].fwd(
            jnp.asarray(z[p]), jnp.asarray(el[p]), jnp.asarray(er[p]))
        real = dst[p] < N
        sp, dp = src[p][real], dst[p][real]
        lp = el[p][sp] + er[p][dp]
        neg = jnp.asarray(lp <= 0)
        alpha = jnp.exp(jnp.where(lp > 0, lp, SLOPE * lp)
                        - m[dp]) / s[dp]
        a_neg = jnp.where(neg, alpha, 0.0)
        w_neg = jax.ops.segment_sum(a_neg, dp, N)
        n_neg = jax.ops.segment_sum(a_neg[..., None] * z[p][sp], dp, N)
        for name, a, b in zip(("out", "m", "s", "n_neg", "w_neg"), got,
                              (out, m, s, n_neg, w_neg)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        assert not got[0][EMPTY].any() and (got[2][EMPTY] == 1).all()
        _, (_, _, dr) = jax_vjp(fns[p], z[p], el[p], er[p], g[p])
        gt = torch.from_numpy(g[p])
        rho = (gt * torch.from_numpy(got[0])).sum(-1)
        d_er = gat_d_er(gt, rho, torch.from_numpy(got[3]),
                        torch.from_numpy(got[4]), SLOPE)
        close_to_max(d_er.numpy(), dr, "pass A: d_er")


def k8_emulated(z, el, er, m, s, g, rho, indptr_t, dst_t):
    """K8's arithmetic (``csrc/gat_attn.cuh``, pass B) on f32 z and g rows,
    one part, in f32: per source row r and 32-edge chunk of its out-edges
    in the transpose CSR, lane l takes edge l of the chunk, its alpha =
    exp(leaky(l) - m[dst]) / s[dst] and beta (alpha, or slope * alpha on
    the negative branch), and adds beta * rho[dst] into its own sum (a
    fused multiply-add), which a xor butterfly over the 32 lanes combines;
    each edge adds alpha * g[dst] (one fused multiply-add an element) in
    edge order into the sum of its leaky branch (at every dh: where the
    kernel's 4-element chunks straddle two heads, the branch is taken per
    element), d_z = pos + neg and the beta sum = fma(slope, neg, pos).
    d_el = z[r] . beta sum - sum beta rho, the dot product a fused
    multiply-add chain a lane's 4-element chunk, added into the chunk's
    head(s), then the butterfly. A row without edges gets zeros."""
    R, Hh, dh = z.shape
    n, F = er.shape[0], Hh * dh
    slope = np.float32(SLOPE)
    d_z = np.zeros((R, Hh, dh), np.float32)
    d_el = np.zeros((R, Hh), np.float32)

    def butterfly(lanes):
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(32) ^ off]
        return lanes[0]

    for r in range(R):
        e0, e1 = int(indptr_t[r]), int(indptr_t[r + 1])
        dsts = np.clip(dst_t[e0:e1], 0, n - 1)
        lp = (el[r] + er[dsts]).astype(np.float32)
        lg = np.where(lp > 0, lp, slope * lp)
        alpha = (np.exp(lg - m[dsts]) / s[dsts]).astype(np.float32)
        beta = np.where(lp > 0, alpha, alpha * slope)
        lanes = np.zeros((32, Hh), np.float32)
        for j in range(e1 - e0):
            lanes[j % 32] = _fma32(beta[j], rho[dsts[j]], lanes[j % 32])
        brho = butterfly(lanes)
        pos = np.zeros(F, np.float32)
        neg = np.zeros(F, np.float32)
        for j, d in enumerate(dsts):
            on_neg = np.repeat(lp[j] <= 0, dh)
            prod = _fma32(np.repeat(alpha[j], dh), g[d].reshape(F),
                          np.where(on_neg, neg, pos))
            pos = np.where(on_neg, pos, prod)
            neg = np.where(on_neg, prod, neg)
        acc, accb = pos + neg, _fma32(slope, neg, pos)
        d_z[r] = acc.reshape(Hh, dh)
        zr = z[r].reshape(F)
        dots = np.zeros((32, Hh), np.float32)
        for c0 in range(0, F, 4):  # lane (c0 / 4) % 32's chunks, in order
            t = {}
            for k in range(c0, min(c0 + 4, F)):
                t[k // dh] = _fma32(zr[k], accb[k],
                                    t.get(k // dh, np.float32(0)))
            for h, v in t.items():
                dots[(c0 // 4) % 32, h] += v
        d_el[r] = butterfly(dots) - brho
    return d_z, d_el


def out_edge_graph(seed):
    """``graph(seed)`` with the transpose's edge cases: 250 of each
    part's edges leave source HEAVY (eight 32-edge chunks of its row in
    the transpose CSR) and none leaves source EMPTY."""
    src, dst = graph(seed)
    rng = np.random.default_rng(seed + 1)
    for p in range(P):
        real = np.flatnonzero(dst[p] < N)
        src[p, real[src[p, real] == EMPTY]] = EMPTY + 1
        src[p, rng.choice(real, 250, replace=False)] = HEAVY
    return src, dst


@pytest.mark.parametrize("dh", [41, 64])
def test_k8_arithmetic_matches_jax_backward(dh):
    """K8's arithmetic (``k8_emulated``: per-branch sums, one weight a
    4-element chunk at dh = 64, the branch per element at dh = 41, where
    the chunks straddle two heads) on a graph whose transpose has a
    250-edge row and an empty one, against the d_z and d_el of the VJP of
    JAX's
    ``make_device_gat_fn`` (its pass B), from JAX's forward m and s, at
    the f32 tolerance (1e-5 of each tensor's max, the module's backward
    tolerance)."""
    src, dst = out_edge_graph(12)
    z, el, er, g = inputs(dh, 13)
    it, dt = csr_transpose(src, dst, N, R)
    fns = jax_bucket_fns(src, dst)
    for p in range(P):
        assert it[p, HEAVY + 1] - it[p, HEAVY] >= 250
        assert it[p, EMPTY + 1] == it[p, EMPTY]
        out, (_, _, _, _, m, s) = fns[p].fwd(
            jnp.asarray(z[p]), jnp.asarray(el[p]), jnp.asarray(er[p]))
        out, m, s = (np.asarray(x) for x in (out, m, s))
        rho = (g[p] * out).sum(-1).astype(np.float32)
        d_z, d_el = k8_emulated(z[p], el[p], er[p], m, s, g[p], rho, it[p],
                                dt[p])
        _, (dz, de, _) = jax_vjp(fns[p], z[p], el[p], er[p], g[p])
        close_to_max(d_z, dz, "d_z")
        close_to_max(d_el, de, "d_el")
        assert not d_z[EMPTY].any() and not d_el[EMPTY].any()
