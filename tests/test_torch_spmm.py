"""The port's mean SpMM (plain path, CPU) against the JAX spmm_mean, on the
padded, dst-sorted per-part edge lists of a real ShardedGraph: the
forward, the transpose CSR, and the backward against jax.vjp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.ops.spmm import spmm_mean as jax_spmm_mean
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.ops import spmm
from pipegcn_tpu_torch.ops.spmm import (csr_indptr, csr_transpose, spmm_mean,
                                        spmm_mean_t, spmm_mean_t_plain)

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module", params=[2, 4])
def sg(request):
    g = synthetic_graph(num_nodes=300, avg_degree=10, n_feat=8, n_class=4,
                        seed=11)
    parts = partition_graph(g, request.param, method="random", seed=0)
    return ShardedGraph.build(g, parts, n_parts=request.param)


def _fbuf(sg, F, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (sg.num_parts, sg.n_max + sg.halo_size, F)).astype(np.float32)


@pytest.mark.parametrize("chunk", [None, 64], ids=["unchunked", "chunk64"])
def test_f32_matches_jax(sg, chunk):
    F = 16
    fb = _fbuf(sg, F, seed=1)
    indptr = torch.from_numpy(csr_indptr(sg.edge_dst, sg.n_max))
    src = torch.from_numpy(sg.edge_src)
    deg = torch.from_numpy(sg.in_deg)
    stacked = spmm_mean(torch.from_numpy(fb), indptr, src, deg).numpy()
    for p in range(sg.num_parts):
        want = np.asarray(jax_spmm_mean(
            jnp.asarray(fb[p]), jnp.asarray(sg.edge_src[p]),
            jnp.asarray(sg.edge_dst[p]), jnp.asarray(sg.in_deg[p]),
            sg.n_max, chunk, True))
        got = spmm_mean(torch.from_numpy(fb[p]), indptr[p], src[p],
                        deg[p]).numpy()
        assert got.dtype == np.float32 and got.shape == (sg.n_max, F)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(stacked[p], got)


def test_bf16_fbuf_matches_jax(sg):
    """bf16 messages, f32 accumulation and output on both sides (the
    same numpy values rounded to bf16 by each framework)."""
    fb = _fbuf(sg, 12, seed=2)
    indptr = torch.from_numpy(csr_indptr(sg.edge_dst, sg.n_max))
    for p in range(sg.num_parts):
        want = np.asarray(jax_spmm_mean(
            jnp.asarray(fb[p], jnp.bfloat16), jnp.asarray(sg.edge_src[p]),
            jnp.asarray(sg.edge_dst[p]), jnp.asarray(sg.in_deg[p]),
            sg.n_max, None, True))
        got = spmm_mean(torch.from_numpy(fb[p]).bfloat16(), indptr[p],
                        torch.from_numpy(sg.edge_src[p]),
                        torch.from_numpy(sg.in_deg[p]))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-3)


def test_padding_contract_and_indptr(sg):
    """Pad edges (dst = n_out, src = row 0) end the dst-sorted list:
    indptr[n_out] is the real edge count, rows match a searchsorted CSR,
    and whatever a pad edge's src holds is never read."""
    indptr = csr_indptr(sg.edge_dst, sg.n_max)
    assert indptr.dtype == np.int32
    assert indptr.shape == (sg.num_parts, sg.n_max + 1)
    for p in range(sg.num_parts):
        e = int(sg.edge_count[p])
        assert indptr[p, -1] == e
        assert (sg.edge_dst[p, e:] == sg.n_max).all()
        assert (sg.edge_src[p, e:] == 0).all()
        np.testing.assert_array_equal(
            indptr[p], np.searchsorted(sg.edge_dst[p],
                                       np.arange(sg.n_max + 1)))
    fb = torch.from_numpy(_fbuf(sg, 4, seed=3))
    src = sg.edge_src.copy()
    for p in range(sg.num_parts):
        src[p, sg.edge_count[p]:] = sg.n_max + sg.halo_size - 1
    args = (torch.from_numpy(indptr), torch.from_numpy(sg.in_deg))
    a = spmm_mean(fb, args[0], torch.from_numpy(sg.edge_src), args[1])
    b = spmm_mean(fb, args[0], torch.from_numpy(src), args[1])
    assert torch.equal(a, b)
    # int64 row pointers give the same result
    c = spmm_mean(fb, args[0].long(), torch.from_numpy(sg.edge_src), args[1])
    assert torch.equal(a, c)


def test_indptr_rejects_bad_edge_lists():
    with pytest.raises(ValueError, match="not sorted"):
        csr_indptr(np.array([0, 2, 1, 3]), 3)
    with pytest.raises(ValueError, match="outside"):
        csr_indptr(np.array([0, 1, 5]), 3)
    ip = csr_indptr(np.array([0, 0, 2, 3, 3]), 3)
    np.testing.assert_array_equal(ip, [0, 2, 2, 3])


def test_empty_rows_and_degree_division():
    # row 1 has no edges (exact zero), row 2 one edge, in_deg from the
    # full graph (not the local count) divides
    fb = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    indptr = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    src = torch.tensor([0, 3, 1, 0, 0], dtype=torch.int32)
    deg = torch.tensor([4.0, 1.0, 2.0])
    out = spmm_mean(fb, indptr, src, deg)
    np.testing.assert_allclose(out.numpy(), [
        [(0 + 9) / 4, (1 + 10) / 4, (2 + 11) / 4], [0, 0, 0],
        [3 / 2, 4 / 2, 5 / 2]])


def test_csr_transpose_matches_stable_argsort(sg):
    """The source-keyed CSR lists, per source row, the dst of its real
    edges in their dst-sorted order (a stable argsort by source); pad
    edges are dropped and the tail is zero."""
    n_src = sg.n_max + sg.halo_size
    it, dt = csr_transpose(sg.edge_src, sg.edge_dst, sg.n_max, n_src)
    assert it.dtype == np.int32 and dt.dtype == np.int32
    assert it.shape == (sg.num_parts, n_src + 1)
    assert dt.shape == sg.edge_src.shape
    for p in range(sg.num_parts):
        e = int(sg.edge_count[p])
        s, d = sg.edge_src[p, :e], sg.edge_dst[p, :e]
        order = np.argsort(s, kind="stable")
        assert it[p, -1] == e
        np.testing.assert_array_equal(dt[p, :e], d[order])
        assert (dt[p, e:] == 0).all()
        np.testing.assert_array_equal(
            it[p], np.searchsorted(s[order], np.arange(n_src + 1)))
        for r in (0, n_src // 2, n_src - 1):  # rows in ascending dst
            row = dt[p, it[p, r]:it[p, r + 1]]
            assert (np.diff(row) >= 0).all()


def _jax_vjp(fb, sg, p, g, dtype):
    import jax

    def f(x, deg):
        return jax_spmm_mean(x, jnp.asarray(sg.edge_src[p]),
                             jnp.asarray(sg.edge_dst[p]), deg, sg.n_max,
                             None, True)

    out, vjp = jax.vjp(f, jnp.asarray(fb[p], dtype),
                       jnp.asarray(sg.in_deg[p]))
    d_fb, d_deg = vjp(jnp.asarray(g[p]))
    return np.asarray(out), np.asarray(d_fb.astype(jnp.float32)), \
        np.asarray(d_deg)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_spmm_mean_backward_matches_jax_vjp(sg, bf16):
    """SpmmMean's backward (the plain transpose on the CPU) against
    jax.vjp of spmm_mean: d_fbuf in fbuf's dtype and d_in_deg. f32: the
    same terms summed in the same edge order up to the division (JAX
    divides g by in_deg, the port multiplies by its reciprocal), rtol
    1e-5; bf16: one rounding of d_fbuf to bf16 on each side, rtol 2e-2."""
    F = 8
    fb = _fbuf(sg, F, seed=5)
    g = np.random.default_rng(6).standard_normal(
        (sg.num_parts, sg.n_max, F)).astype(np.float32)
    n_src = sg.n_max + sg.halo_size
    indptr = torch.from_numpy(csr_indptr(sg.edge_dst, sg.n_max))
    it, dt = (torch.from_numpy(a) for a in csr_transpose(
        sg.edge_src, sg.edge_dst, sg.n_max, n_src))
    dtype = torch.bfloat16 if bf16 else torch.float32
    x = torch.from_numpy(fb).to(dtype).requires_grad_(True)
    deg = torch.from_numpy(sg.in_deg).requires_grad_(True)
    out = spmm_mean(x, indptr, torch.from_numpy(sg.edge_src), deg, (it, dt))
    out.backward(torch.from_numpy(g))
    assert x.grad.dtype == dtype
    tol = dict(rtol=2e-2, atol=1e-2) if bf16 else dict(rtol=1e-5, atol=1e-6)
    for p in range(sg.num_parts):
        w_out, w_dfb, w_ddeg = _jax_vjp(
            fb, sg, p, g, jnp.bfloat16 if bf16 else jnp.float32)
        np.testing.assert_allclose(out[p].detach().numpy(), w_out, **tol)
        np.testing.assert_allclose(x.grad[p].float().numpy(), w_dfb, **tol)
        np.testing.assert_allclose(deg.grad[p].numpy(), w_ddeg, **tol)


def test_spmm_mean_t_plain_is_the_transpose():
    """<spmm(x), g> == <x, spmm_t(g)> on a random CSR with empty source
    rows, and the plain and dispatching wrappers agree on the CPU."""
    rng = np.random.default_rng(12)
    n_out, n_src, F = 40, 90, 5
    deg = rng.integers(0, 9, n_out)
    dst = np.repeat(np.arange(n_out), deg)
    src = rng.integers(0, n_src - 10, dst.size)  # sources >= 80 empty
    in_deg = rng.uniform(1, 5, n_out).astype(np.float32)
    ip = torch.from_numpy(csr_indptr(dst, n_out))
    it, dt = (torch.from_numpy(a) for a in csr_transpose(src, dst, n_out,
                                                         n_src))
    x = torch.from_numpy(rng.standard_normal((n_src, F)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n_out, F)).astype(np.float32))
    dg = torch.from_numpy(in_deg)
    fwd = spmm_mean(x, ip, torch.from_numpy(src.astype(np.int32)), dg)
    bwd = spmm_mean_t(g, it, dt, dg)
    assert torch.equal(bwd, spmm_mean_t_plain(g, it, dt, dg))
    assert (bwd[80:] == 0).all()
    np.testing.assert_allclose(float((fwd * g).sum()), float((x * bwd).sum()),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="transpose CSR"):
        spmm_mean(x.requires_grad_(True), ip,
                  torch.from_numpy(src.astype(np.int32)), dg).sum().backward()


# the H100's L2 as the card reports it (cudaDevAttrL2CacheSize)
H100_L2 = 52428800


@pytest.mark.parametrize("n_src", [1000, 143584, 232976, 2000000])
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("F", [1, 41, 164, 256, 602, 1204])
def test_k1_slices_tile_the_columns_within_the_l2_budget(F, elem, n_src):
    """K1's slice rule: the S slices of W columns tile [0, F) exactly (the
    last one cut by F); S = 1 where the table of a part fits the L2
    budget (``K1_L2_SHARE`` of the L2); otherwise each (part, slice)
    table stays within that budget, unless not even the narrowest slice
    fits, which is then taken. The launch plan
    narrows the slice only as its loads require: width / vec lanes a row,
    8, 16 or 32, and F a multiple of vec."""
    budget = spmm.K1_L2_SHARE * H100_L2
    W, S = spmm.k1_slice_width(n_src, F, elem, H100_L2)
    assert 1 <= W <= F and S == -(-F // W)
    bounds = [(s * W, min((s + 1) * W, F)) for s in range(S)]
    assert bounds[0][0] == 0 and bounds[-1][1] == F
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    if n_src * F * elem <= budget:
        assert S == 1
    elif S > 1:
        assert W * elem in spmm.K1_SLICE_BYTES
        narrowest = n_src * min(spmm.K1_SLICE_BYTES)
        assert n_src * W * elem <= budget or (
            narrowest > budget and W * elem == min(spmm.K1_SLICE_BYTES))
    for ptr in (256, 2 * elem):  # an aligned and a barely aligned table
        width, vec = spmm.k1_plan(n_src, F, elem, H100_L2, ptr)
        if S == 1:
            assert (width, vec) == (F, 0)
            continue
        assert width <= W and width // vec in (8, 16, 32)
        assert width % vec == 0 and F % vec == 0
        assert ptr % (vec * elem) == 0



# ---------------------------------------------------------------------------
# K3's design (csrc/spmm_mean.cu gather_t_kernel), emulated in numpy


# K3's geometry (csrc/spmm_mean.cu): kK3Threads threads a CTA, each lane
# group kK3RowsPerGroup rows; the slice is ops/spmm.py K3_SLICE
K3_THREADS, K3_ROWS_PER_GROUP = 1024, 3


def _k3_emulated(g, it, dt, deg):
    """K3's arithmetic and walk in numpy f32, one part: the prescale
    g * (1 / deg) rounded into column slices of ``K3_SLICE`` (zero past
    F), then for every CTA, slice and lane group, its rows stepped together
    a chunk of ``K3_SLICE / 4`` edges at a time, each element adding its
    row's gathered values in CSR order. Returns the output and each row's
    visited edges (one slice's walk)."""
    width, rpg = spmm.K3_SLICE, K3_ROWS_PER_GROUP
    n_out, F = g.shape
    n_src = it.shape[0] - 1
    G = width // 4
    slots = K3_THREADS // G
    S = -(-F // width)
    gp = np.zeros((S, n_out, width), np.float32)
    rc = (np.float32(1) / deg.astype(np.float32)).astype(np.float32)
    for s in range(S):
        cols = slice(s * width, min(F, (s + 1) * width))
        w = cols.stop - cols.start
        gp[s, :, :w] = g[:, cols] * rc[:, None]
    out = np.zeros((n_src, S * width), np.float32)
    visits = [[] for _ in range(n_src)]
    for row0 in range(0, n_src, slots * rpg):
        for s in range(S):
            for slot in range(slots):
                rows = [row0 + slot + slots * j for j in range(rpg)]
                cur = {r: int(it[r]) for r in rows if r < n_src}
                acc = {r: np.zeros(width, np.float32) for r in cur}
                while any(cur[r] < it[r + 1] for r in cur):
                    for r in cur:  # one chunk of each row, in turn
                        stop = min(cur[r] + G, int(it[r + 1]))
                        for e in range(cur[r], stop):
                            d = min(max(int(dt[e]), 0), n_out - 1)
                            acc[r] = (acc[r] + gp[s, d]).astype(np.float32)
                            if s == 0:
                                visits[r].append(e)
                        cur[r] = stop
                for r in cur:
                    out[r, s * width:(s + 1) * width] = acc[r]
    return out[:, :F], visits


@pytest.mark.parametrize("F,n_src", [(41, 130), (64, 400), (130, 250),
                                     (1, 130)])
def test_k3_walk_sums_each_row_in_csr_order(F, n_src):
    """K3's sliced walk (numpy emulation at the kernel's geometry; one or
    more CTAs and column slices) visits each edge of each row once, in CSR
    order, so every output element is the parent K3's sum bit for bit: the
    terms g[dst] * (1 / in_deg[dst]), rounded, added in edge order from 0
    (K1's whole-row kernel over the prescaled cotangent); rows with no
    edges are exactly zero; and it is the plain version's function up to
    summation order, which K3's CPU path runs."""
    rng = np.random.default_rng(F + n_src)
    n_out = 50
    deg = rng.integers(0, 30, n_out)
    dst = np.repeat(np.arange(n_out), deg)
    src = rng.integers(0, n_src, dst.size)
    src[rng.random(dst.size) < 0.3] = 7  # a heavy row across chunks
    src[np.isin(src, np.arange(20, 30))] = 0  # empty rows
    it, dt = csr_transpose(src, dst, n_out, n_src)
    g = rng.standard_normal((n_out, F)).astype(np.float32)
    in_deg = rng.uniform(1, 9, n_out).astype(np.float32)
    got, visits = _k3_emulated(g, it, dt, in_deg)
    for r in range(n_src):
        assert visits[r] == list(range(it[r], it[r + 1]))
    rc = (np.float32(1) / in_deg).astype(np.float32)
    for r in (0, 7, 25, n_src - 1):
        want = np.zeros(F, np.float32)
        for e in range(it[r], it[r + 1]):
            want = (want + g[dt[e]] * rc[dt[e]]).astype(np.float32)
        np.testing.assert_array_equal(got[r], want)
    assert (got[20:30] == 0).all()
    args = (torch.from_numpy(g), torch.from_numpy(it), torch.from_numpy(dt),
            torch.from_numpy(in_deg))
    plain = spmm_mean_t_plain(*args)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(spmm_mean_t(*args), plain)
