"""The port's bucket aggregation and gather transport (plain path, CPU)
against the JAX ``ops/bucket_spmm.py``: the stacked tables array for
array, the bounds check, the transport casts bit for bit, the per-part
amax and its exact power-of-two scale, ``BucketSpmm`` forward and
backward against ``jax.vjp`` of ``make_device_bucket_spmm_fn`` per
transport, and the plain K9 against the port's CSR ``spmm_mean``.

Tolerances: the casts are bit-exact (a NaN equal to any NaN: the two
frameworks write different NaN bit patterns). Given bit-identical
transported inputs the aggregations differ only in f32 summation order:
rtol 1e-5, atol 1e-6."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import pipegcn_tpu.ops.bucket_spmm as jbs
from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.ops import bucket_spmm as pbs
from pipegcn_tpu_torch.ops.spmm import csr_indptr, csr_transpose, spmm_mean
from test_torch_train import one_torch_thread, port_sharded

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

CPU = torch.device("cpu")
_SG = {}
# torch dtype -> the JAX / numpy dtype of the same format
NP_DT = {torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
         torch.float8_e5m2: ml_dtypes.float8_e5m2,
         torch.bfloat16: ml_dtypes.bfloat16}
BITS = {1: (np.uint8, torch.uint8), 2: (np.uint16, torch.int16)}


def sharded(P):
    """A skewed graph (a few hubs) so the ladders have several rungs."""
    if P not in _SG:
        g = synthetic_graph(num_nodes=400, avg_degree=9, n_feat=8,
                            n_class=4, seed=21)
        rng = np.random.default_rng(5)
        hubs = rng.integers(0, g.num_nodes, 3)
        extra_src = rng.integers(0, g.num_nodes, 240)
        extra_dst = np.repeat(hubs, 80)
        g.src = np.concatenate([g.src, extra_src, extra_dst]).astype(
            g.src.dtype)
        g.dst = np.concatenate([g.dst, extra_dst, extra_src]).astype(
            g.dst.dtype)
        parts = partition_graph(g, P, method="random", seed=0)
        _SG[P] = ShardedGraph.build(g, parts, n_parts=P)
    return _SG[P]


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes included) as a torch tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy())
    tdt = {v: k for k, v in NP_DT.items()}[a.dtype.type]
    npb, tb = BITS[a.dtype.itemsize]
    return torch.from_numpy(a.view(npb).copy()).view(tb).view(tdt)


def assert_same_values(got: torch.Tensor, want: torch.Tensor, what=""):
    """Bit-identical, except that any NaN equals any NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan = torch.isnan(got.float())
    assert torch.equal(nan, torch.isnan(want.float())), what
    bits = BITS.get(got.element_size(), (None, torch.int32))[1]
    g, w = got.view(bits), want.view(bits)
    assert torch.equal(g[~nan], w[~nan]), (
        what, int((g != w)[~nan].sum()))


@pytest.mark.parametrize("min_width", [0, 4])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_tables_equal_the_jax_build(P, min_width):
    sg = sharded(P)
    want = jbs.build_sharded_bucket_tables(sg, min_width=min_width)
    got = pbs.build_sharded_bucket_tables(port_sharded(sg),
                                          min_width=min_width)
    assert sorted(got) == sorted(want)
    assert sum(k.startswith("bkt_fwd_") for k in got) > 4
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if min_width:
        widths = [got[k].shape[-1] for k in sorted(got)
                  if k.startswith("bkt_fwd_") and not k.endswith("inv")]
        assert min(widths) >= min_width
    assert pbs.ladder_prefix(8) == jbs.ladder_prefix(8)


@pytest.mark.parametrize("stem,value", [("bkt_fwd_", 10 ** 6),
                                        ("bkt_bwd_inv", -1)])
def test_validate_refuses_a_corrupt_index(stem, value):
    sg = sharded(2)
    tables = pbs.build_sharded_bucket_tables(port_sharded(sg))
    key = min(k for k in tables if k.startswith(stem))
    tables[key] = tables[key].copy()
    tables[key].reshape(-1)[3] = value
    n_src = sg.n_max + sg.halo_size
    for mod in (pbs, jbs):
        with pytest.raises(ValueError, match=f"bucket table '{key}' holds "
                           "out-of-bounds indices"):
            mod.validate_bucket_tables(tables, sg.n_max, n_src)


def cast_inputs():
    """f32 values over 1e-4..1e5 in magnitude, zeros, infinities, NaN, the
    saturation points and their neighbours, and f32 and fp8 subnormals."""
    rng = np.random.default_rng(7)
    mag = 10.0 ** rng.uniform(-4, 5, 20000)
    x = (mag * rng.choice([-1.0, 1.0], mag.size)).astype(np.float32)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 448, 464, 465,
                      -448, -464.0001, 480, 57344, 61440, 61441, -57344,
                      -61440, 65536, 3.4e38, 1e-40, -1e-40, 2.0 ** -9,
                      2.0 ** -10, 3 * 2.0 ** -11, 2.0 ** -16, 2.0 ** -17,
                      1.5 * 2.0 ** -17, 2.0 ** -126], np.float32)
    nxt = np.nextafter(edges, np.float32(np.inf)).astype(np.float32)
    prv = np.nextafter(edges, np.float32(-np.inf)).astype(np.float32)
    return np.concatenate([x, edges, nxt, prv]).reshape(1, -1, 1)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("dt", [torch.float8_e4m3fn, torch.float8_e5m2,
                                torch.bfloat16],
                         ids=["e4m3", "e5m2", "bf16"])
def test_transport_cast_is_bit_exact_against_jax(dt, src):
    x = cast_inputs()
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x[0])
    if src == "bfloat16":
        xt = xt.to(torch.bfloat16)
        xj = xj.astype(jnp.bfloat16)
    got, inv = pbs.transport_cast(xt, dt)
    assert inv is None
    want = to_torch(np.asarray(jbs.transport_cast(xj, NP_DT[dt])))
    assert_same_values(got[0], want, str(dt))


def test_transport_dtypes_match_jax():
    for spec in (None, "none", "bfloat16", "float8"):
        got = pbs.transport_dtypes(spec)
        want = jbs.transport_dtypes(spec)
        assert [None if d is None else NP_DT[d] for d in got] == \
            [None if d is None else jnp.dtype(d).type for d in want]
    with pytest.raises(ValueError):
        pbs.transport_dtypes("int8")


def test_amax_is_per_part_and_matches_jax_under_vmap():
    """One amax per part's [rows, F] slab, as the JAX emulated step's vmap
    computes it; scales bit-exact where XLA's exp2 is exact (the forward
    activations' exponents, here k in [-12, 12])."""
    rng = np.random.default_rng(3)
    amax = np.array([0.03, 1.7, 90.0, 0.2], np.float32)
    x = rng.standard_normal((4, 50, 16)).astype(np.float32)
    x *= (amax / np.abs(x).max(axis=(1, 2)))[:, None, None]
    x[2, 7, 3] = -amax[2]
    xt = torch.from_numpy(x)
    a = pbs.part_amax(xt)
    np.testing.assert_array_equal(a.numpy(), np.abs(x).max(axis=(1, 2)))
    assert float(a.max()) != float(a.min())
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        y, inv = pbs.transport_cast(xt, dt, amax=a)
        wy, winv = jax.vmap(lambda v: jbs.amax_transport_cast(
            v, NP_DT[dt]))(jnp.asarray(x))
        s = 1.0 / inv.numpy()
        k = np.log2(s)
        assert np.array_equal(k, np.round(k)), k
        if dt == torch.float8_e4m3fn:
            assert ((k >= -12) & (k <= 12)).all()
            assert_same_values(y, to_torch(np.asarray(wy)), str(dt))
            np.testing.assert_array_equal(inv.numpy(), np.asarray(winv))
        # one amax over the whole stack would give other scales
        one = pbs.pow2_scale(a.max().expand(4), pbs.F8_MAX[dt])
        assert not torch.equal(1.0 / inv, one)
    # the backward's division before the cast: amax of g / deg
    deg = torch.from_numpy(rng.uniform(1, 9, (4, 50)).astype(np.float32))
    np.testing.assert_array_equal(
        pbs.part_amax(xt, deg).numpy(),
        np.abs(x / deg.numpy()[..., None]).max(axis=(1, 2)))


def test_amax_degenerate_keeps_scale_one():
    x = torch.zeros((3, 4, 5))
    x[1, 0, 0] = float("nan")
    x[2, 1, 1] = float("inf")
    a = pbs.part_amax(x)
    assert a[0] == 0 and torch.isnan(a[1]) and torch.isinf(a[2])
    y, inv = pbs.transport_cast(x, torch.float8_e4m3fn, amax=a)
    assert torch.equal(inv, torch.ones(3))
    assert torch.isnan(y[1, 0, 0].float()) and y[2, 1, 1].float() == 448


def test_amax_scale_is_exact_where_xla_exp2_is_not():
    """The reference's backward scale: cotangents g / in_deg with amax
    ~1e-5 against e5m2's 28672 put k = floor(log2(28672 / amax)) at 31,
    where XLA-CPU's exp2 rounds off 2**31 (ROADMAP C, an intended
    difference). The port's scale is 2**31 exactly; the reference's
    within 16 ulps of it. Where XLA's exp2 is exact (k in [-12, 12]: the
    forward activations' amax from 0.055 to 9e5 against e4m3's 224) the
    scales agree bit for bit."""
    amax = np.float32(1.0e-5)
    x = np.full((1, 2, 3), amax, np.float32)
    _, winv = jbs.amax_transport_cast(jnp.asarray(x[0]), ml_dtypes.float8_e5m2)
    s_jax = np.float32(1.0) / np.float32(winv)
    k = int(np.floor(np.log2(np.float32(28672.0) / amax)))
    assert k == 31
    _, inv = pbs.transport_cast(torch.from_numpy(x), torch.float8_e5m2,
                                amax=pbs.part_amax(torch.from_numpy(x)))
    assert float(inv[0]) == 2.0 ** -31
    exact = np.float32(2.0 ** 31)
    assert s_jax != exact
    ulps = abs(int(s_jax.view(np.int32)) - int(exact.view(np.int32)))
    assert 0 < ulps <= 16, ulps
    for k in range(-12, 13):
        a = np.float32(224.0 * 2.0 ** -k)
        xv = np.full((2, 3), a, np.float32)
        _, wi = jbs.amax_transport_cast(jnp.asarray(xv),
                                        ml_dtypes.float8_e4m3fn)
        _, pi = pbs.transport_cast(torch.from_numpy(xv[None]),
                                   torch.float8_e4m3fn,
                                   amax=torch.tensor([a]))
        assert float(pi[0]) == float(wi), k


@pytest.mark.parametrize("rem,amax", [(None, False), ("bfloat16", False),
                                      ("float8", False), ("float8", True)],
                         ids=["none", "bf16", "fp8", "fp8-amax"])
def test_bucket_spmm_matches_jax_vjp(rem, amax):
    P, F = 2, 12
    sg = sharded(P)
    n_src = sg.n_max + sg.halo_size
    tables = jbs.build_sharded_bucket_tables(sg)
    staged = pbs.stage_bucket_tables(tables, sg.n_max, n_src, CPU)
    rng = np.random.default_rng(9)
    fb = rng.standard_normal((P, n_src, F)).astype(np.float32)
    g = rng.standard_normal((P, sg.n_max, F)).astype(np.float32)
    deg = sg.in_deg.astype(np.float32)
    x = torch.from_numpy(fb).requires_grad_(True)
    out = pbs.bucket_spmm(x, staged, torch.from_numpy(deg), rem, amax)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and out.shape == (P, sg.n_max, F)
    for p in range(P):
        fn = jbs.make_device_bucket_spmm_fn(
            {k: jnp.asarray(v[p]) for k, v in tables.items()},
            jnp.asarray(deg[p]), n_src,
            rem_dtype=rem, rem_amax=amax)
        want, vjp = jax.vjp(fn, jnp.asarray(fb[p]))
        (want_grad,) = vjp(jnp.asarray(g[p]))
        np.testing.assert_allclose(out[p].detach().numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(x.grad[p].numpy(), np.asarray(want_grad),
                                   rtol=1e-5, atol=1e-6)
    if rem is not None:
        # the transport changes the result: the test sees it on or off
        plain = pbs.bucket_spmm(x.detach(), staged, torch.from_numpy(deg))
        assert not torch.allclose(out.detach(), plain, rtol=1e-5, atol=0)


def test_plain_k9_is_the_csr_mean():
    """At transport none the bucket path computes spmm_mean's function:
    forward and gradient within the f32 summation tolerance; rows with
    no edges exactly zero; junk in the cap-padding rows is never read."""
    P, F = 4, 7
    sg = sharded(P)
    n_src = sg.n_max + sg.halo_size
    staged = pbs.stage_bucket_tables(
        pbs.build_sharded_bucket_tables(port_sharded(sg)), sg.n_max, n_src,
        CPU)
    rng = np.random.default_rng(4)
    fb = torch.from_numpy(
        rng.standard_normal((P, n_src, F)).astype(np.float32))
    g = torch.from_numpy(
        rng.standard_normal((P, sg.n_max, F)).astype(np.float32))
    deg = torch.from_numpy(sg.in_deg.astype(np.float32))
    indptr = torch.from_numpy(csr_indptr(sg.edge_dst, sg.n_max))
    src = torch.from_numpy(sg.edge_src)
    tr = tuple(torch.from_numpy(a) for a in csr_transpose(
        sg.edge_src, sg.edge_dst, sg.n_max, n_src))
    grads = []
    outs = []
    for fn in (lambda x: pbs.bucket_spmm(x, staged, deg),
               lambda x: spmm_mean(x, indptr, src, deg, tr)):
        x = fb.clone().requires_grad_(True)
        out = fn(x)
        out.backward(g)
        outs.append(out.detach())
        grads.append(x.grad)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5, atol=1e-6)
    empty = torch.from_numpy(np.diff(indptr.numpy(), axis=1) == 0)
    assert bool(empty.any()) and bool((outs[0][empty] == 0).all())
    # junk past the tables: cap-padding rows hold sentinels no inv reads
    junk = pbs.BucketSide(**{**staged.fwd.__dict__,
                             "idx": staged.fwd.idx.clone()})
    meta = junk.meta
    for p in range(P):
        used = torch.zeros(int(meta[0, -1]), dtype=torch.bool)
        used[junk.inv[p].long().clamp(max=int(meta[0, -1]) - 1)] = True
        for b in range(junk.nb):
            r0, r1 = int(meta[0, b]), int(meta[0, b + 1])
            e0, w = int(meta[1, b]), int(meta[2, b])
            for r in range(r0, r1):
                if not used[r]:
                    junk.idx[p, e0 + (r - r0) * w:
                             e0 + (r - r0 + 1) * w] = 5
    assert not torch.equal(junk.idx, staged.fwd.idx)
    assert torch.equal(pbs.bucket_gather(fb, junk, deg),
                       pbs.bucket_gather(fb, staged.fwd, deg))


# ---------------------------------------------------------------------------
# K9's design (csrc/bucket_spmm.cu bucket_kernel), emulated in numpy


# K9's geometry (csrc/bucket_spmm.cu): kGroup lanes a row, one vector of
# at most 16 bytes a lane; Geometry<XT>: threads a CTA, rows a lane group
# and entries a row a step, by row type
K9_GROUP = 16
K9_GEOMETRY = {torch.float32: (1024, 3, 2), torch.bfloat16: (1024, 1, 8),
               torch.float8_e4m3fn: (1024, 1, 4),
               torch.float8_e5m2: (1024, 1, 4)}


def _k9_vec(F, dt):
    """The kernel's vector (elements): the widest of 16 bytes and down
    that F allows (the tensors here are aligned)."""
    vec = 16 // torch.empty((), dtype=dt).element_size()
    while F % vec:
        vec //= 2
    return vec


def _k9_emulated(x, side, in_deg=None, inv_scale=None):
    """K9's walk in numpy f32: for every part, the pre-pass's list (each
    output at its table row, in output order; the outputs sent to the zero
    row or to a row already claimed after them), then for every CTA
    (``threads / K9_GROUP`` lane groups of ``rows`` consecutive list
    entries each, entry ``slot + slots * j``), column slice of
    ``K9_GROUP`` vectors and lane group, its rows stepped together a chunk
    of ``K9_GROUP`` table entries at a time, ``depth`` entries of each row
    a step, each element adding its row's widened values in table order
    from +0.0; a sentinel (>= n_src) skipped wherever it sits, a negative
    index read as row 0, an inv clipped to [0, total] and its bucket found
    by the kernel's binary search over the row offsets. Returns the output
    and each (part, output)'s visited entry offsets (slice 0)."""
    P, n_src, F = x.shape
    threads, rpg, depth = K9_GEOMETRY[x.dtype]
    slots, G = threads // K9_GROUP, K9_GROUP
    W = G * _k9_vec(F, x.dtype)
    xf = x.float().numpy()
    idx = side.idx.numpy()
    inv = side.inv.numpy().astype(np.int64)
    meta = side.meta.numpy()
    nb, n_out = side.nb, side.n_out
    total = int(meta[0, nb])
    rows = side.rows if side.rows is not None else total
    out = np.zeros((P, n_out, F), np.float32)
    visits = {}
    for p in range(P):
        perm, over = [-1] * rows, []
        for o in range(n_out):
            t = max(int(inv[p, o]), 0)
            if t < min(total, rows) and perm[t] < 0:
                perm[t] = o
            else:
                over.append(o)
        order = perm + over
        for row0 in range(0, len(order), slots * rpg):
            for c0 in range(0, F, W):
                cols = slice(c0, min(F, c0 + W))
                for slot in range(slots):
                    walk = {}  # output -> [entry offsets, next chunk, sum]
                    for j in range(rpg):
                        r = row0 + slot + slots * j
                        if r >= len(order) or order[r] < 0:
                            continue
                        i = order[r]
                        t = max(int(inv[p, i]), 0)
                        ents = []
                        if t < total:
                            lo, hi = 0, nb - 1
                            while lo < hi:
                                mid = (lo + hi + 1) >> 1
                                lo, hi = ((mid, hi) if meta[0, mid] <= t
                                          else (lo, mid - 1))
                            w = int(meta[2, lo])
                            e0 = int(meta[1, lo]) + (t - int(meta[0, lo])) * w
                            ents = list(range(e0, e0 + w))
                        walk[i] = [ents, 0, np.zeros(cols.stop - c0,
                                                     np.float32)]
                    while any(c < len(e) for e, c, _ in walk.values()):
                        # a chunk of each row, ``depth`` entries a step
                        for q in range(0, G, depth):
                            for i, st in walk.items():
                                ents, c, acc = st
                                for e in ents[c + q:c + q + depth]:
                                    s = int(idx[p, e])
                                    if s >= n_src:
                                        continue
                                    acc = (acc + xf[p, max(s, 0), cols]
                                           ).astype(np.float32)
                                    if c0 == 0:
                                        visits.setdefault((p, i),
                                                          []).append(e)
                                st[2] = acc
                        for st in walk.values():
                            st[1] += G
                    for i, (_, _, acc) in walk.items():
                        y = acc
                        if in_deg is not None:
                            y = (y / in_deg[p, i].numpy()).astype(np.float32)
                        if inv_scale is not None:
                            y = (y * inv_scale[p].numpy()).astype(np.float32)
                        out[p, i, cols] = y
    return torch.from_numpy(out), visits


@pytest.mark.parametrize("F", [1, 41, 256])
def test_k9_walk_sums_each_row_in_table_order(F):
    """K9's walk (numpy emulation at the kernel's geometry: the pre-pass's
    outputs in table order, lane groups, rows stepped together, chunks of
    the table, column slices) visits each real entry of each output's
    table row once, in table order, and gives
    ``bucket_gather_plain``'s bits on both directions' tables, for f32,
    bf16, e4m3 and e5m2 rows, with the in-degree and an inverse scale:
    on tables flipped to hold sentinels in the middle of rows and
    negative indices too, and with rows sent to the zero row (empty rows,
    and an inv flipped past the tables) or to a row another output claims
    (an inv flipped to repeat one)."""
    P = 2
    sg = sharded(P)
    n_src = sg.n_max + sg.halo_size
    t = pbs.stage_bucket_tables(
        pbs.build_sharded_bucket_tables(port_sharded(sg)), sg.n_max, n_src,
        CPU)
    # the flips: a sentinel in the middle of the widest rows, a negative
    # index in some row of every bucket, an inv past the tables
    flip = pbs.BucketSide(**{**t.fwd.__dict__, "idx": t.fwd.idx.clone(),
                             "inv": t.fwd.inv.clone()})
    meta = flip.meta.numpy()
    w_top = int(meta[2, flip.nb - 1])
    e_top = int(meta[1, flip.nb - 1])
    flip.idx[:, e_top + w_top // 2] = n_src + 3
    flip.idx[0, meta[1, :-1]] = -2
    flip.inv[1, 3] = int(meta[0, -1]) + 7
    flip.inv[0, 9] = flip.inv[0, 2]
    rng = np.random.default_rng(F)
    deg = torch.from_numpy(np.maximum(sg.in_deg, 1).astype(np.float32))
    scale = torch.tensor([0.5, 4.0])
    for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
               torch.float8_e5m2):
        for side, d, sc in ((t.fwd, deg, None), (t.bwd, None, scale),
                            (flip, deg, scale)):
            x = torch.from_numpy(rng.standard_normal(
                (P, side.n_src, F)).astype(np.float32) * 3.0)
            x = x.to(dt) if dt in (torch.float32, torch.bfloat16) else \
                pbs.quantize(x, dt)
            got, visits = _k9_emulated(x, side, d, sc)
            assert_same_values(got, pbs.bucket_gather_plain(x, side, d, sc),
                               f"{dt} {side.n_out}")
            # every real entry of every row once, in table order
            idx, m = side.idx.numpy(), side.meta.numpy()
            for p in range(P):
                for i in range(side.n_out):
                    tr = max(int(side.inv[p, i]), 0)
                    want = []
                    if tr < int(m[0, -1]):
                        b = int(np.searchsorted(m[0], tr, side="right")) - 1
                        e0 = int(m[1, b]) + (tr - int(m[0, b])) * int(m[2, b])
                        want = [e for e in range(e0, e0 + int(m[2, b]))
                                if idx[p, e] < side.n_src]
                    assert visits.get((p, i), []) == want, (p, i)


# ---------------------------------------------------------------------------
# K10's design (csrc/transport_cast.cu cast_kernel), emulated


def csrc_constant(source: str, name: str) -> int:
    """``constexpr int <name> = <n>;`` of ``pipegcn_tpu_torch/ops/csrc/
    <source>``: the emulations run at the kernel's own geometry."""
    import re

    from pipegcn_tpu_torch.ops import _build

    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _k10_emulated(x, dt, deg=None, amax=None):
    """K10's split: the vector ``pbs.k10_vec`` picks; for every part, a
    block a chunk of ``kCastThreads * kCastAhead`` consecutive vectors,
    each thread ``kCastAhead`` vectors ``kCastThreads`` apart, the last
    chunk cut at the part's end; with ``deg`` one divisor a vector, its
    first element's row. Each element is then cast as the plain version casts
    it, with that divisor and the part's scale. Returns ``(y, inv, writes,
    rows_of_vector)``: the count of stores of each element, and per vector
    the rows its elements lie in."""
    T = csrc_constant("transport_cast.cu", "kCastThreads")
    A = csrc_constant("transport_cast.cu", "kCastAhead")
    P, rows, F = x.shape
    y = torch.empty(x.shape, dtype=dt)
    vec = pbs.k10_vec(x, y, deg)
    run = F if deg is not None else rows * F
    assert run % vec == 0
    assert (x.data_ptr() // x.element_size()) % vec == 0
    n_vec = rows * F // vec
    chunk = T * A
    vs = []
    for b in range(max(1, -(-n_vec // chunk))):
        v = (b * chunk + np.arange(T)[None, :]
             + np.arange(A)[:, None] * T).ravel()
        vs.append(v[v < n_vec])
    v = np.concatenate(vs) if vs else np.zeros(0, np.int64)
    el = v[:, None] * vec + np.arange(vec)[None, :]   # [vectors, vec]
    writes = np.zeros((P, rows * F), np.int64)
    for p in range(P):
        np.add.at(writes[p], el.ravel(), 1)
    xf = x.reshape(P, -1)
    scale = None
    if amax is not None and dt in pbs.F8_MAX:
        scale = pbs.pow2_scale(amax, pbs.F8_MAX[dt])
    flat = y.view(P, -1)
    for p in range(P):
        e = torch.from_numpy(el.ravel())
        vals = xf[p, e].float()
        if deg is not None:
            # one deg a vector: its first element's row
            vals = vals / deg[p, torch.from_numpy(el[:, 0] // F)].repeat_interleave(vec)
        if scale is not None:
            vals = vals * scale[p]
        m = pbs.F8_MAX.get(dt)
        if m is not None:
            vals = torch.clamp(vals, -m, m)
        flat[p, e] = vals.to(dt)
    inv = None if scale is None else 1.0 / scale
    return y, inv, writes, el // F


@pytest.mark.parametrize("F", [1, 3, 41, 164, 256, 602])
def test_k10_vectors_cover_every_element_once(F):
    """K10's split (the vector its wrapper picks, a block a chunk of
    vectors, a thread's vectors in flight, one deg a vector) writes every element of y exactly once, no vector straddles
    a row where a deg is loaded, and what it writes is
    ``transport_cast_plain``'s, bit for bit: f32 and bf16 input, e4m3,
    e5m2 and bf16 output, with and without deg and the amax scale, P = 1,
    2 and 3, from aligned storage and from storage one element past it
    (narrower vectors, a part's rows x F no multiple of the vector)."""
    rng = np.random.default_rng(F)
    rows = max(5, 12001 // F)
    for P in (1, 2, 3):
        n = P * rows * F
        base = rng.standard_normal(n + 1).astype(np.float32) * 3.0
        base[rng.integers(0, n + 1, 3)] = [np.nan, np.inf, 1e6]
        deg = torch.from_numpy(rng.integers(1, 50, (P, rows)).astype(
            np.float32))
        for src in (torch.float32, torch.bfloat16):
            buf = torch.from_numpy(base).to(src)
            for x in (buf[:n].view(P, rows, F), buf[1:].view(P, rows, F)):
                for d in (None, deg):
                    amax = pbs.part_amax_plain(x, d)
                    for dt in (torch.float8_e4m3fn, torch.float8_e5m2,
                               torch.bfloat16):
                        for a in (None, amax):
                            what = (P, src, x.storage_offset(), d is None,
                                    dt, a is None)
                            y, inv, writes, vrows = _k10_emulated(x, dt, d,
                                                                  a)
                            assert (writes == 1).all(), what
                            if d is not None:
                                assert (vrows == vrows[:, :1]).all(), what
                            want, want_inv = pbs.transport_cast_plain(
                                x, dt, d, a)
                            assert_same_values(y, want, str(what))
                            assert (inv is None) == (want_inv is None)
                            if inv is not None:
                                assert torch.equal(inv, want_inv), what
