"""The port's stacked-parts halo exchange (plain path, CPU) against the JAX
exchange_blocks / halo_exchange under shard_map on the CPU mesh:
bit-exact, including masked-off slots and clipped indices; and its
gradients against return_blocks, make_stale_concat's VJP and
jax.vjp(halo_exchange)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.parallel.halo import exchange_blocks as jax_exchange
from pipegcn_tpu.parallel.halo import halo_exchange as jax_halo_exchange
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.parallel.halo import (exchange_blocks, halo_exchange,
                                             make_stale_concat,
                                             return_blocks, scatter_bgrad,
                                             scatter_bgrad_plain, send_csr)

pytestmark = pytest.mark.torch


def _jax_stacked(fn, P, h, idx, mask):
    """Run a per-shard JAX halo function on P CPU devices over stacked
    [P, ...] inputs; returns the stacked [P, ...] result as numpy."""
    mesh = Mesh(np.array(jax.devices()[:P]), ("parts",))
    spec = PartitionSpec("parts")

    def body(h, idx, mask):
        return fn(h[0], idx[0], mask[0], "parts", P)[None]

    run = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                                out_specs=spec))
    return np.asarray(run(jnp.asarray(h), jnp.asarray(idx),
                          jnp.asarray(mask)))


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


def _case(P, n_max, B, F, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((P, n_max, F)).astype(np.float32)
    h[0, 0, 0] = np.nan
    h[P - 1, 1, 0] = -0.0
    idx = rng.integers(-3, n_max + 3, (P, P - 1, B)).astype(np.int32)
    mask = rng.random((P, P - 1, B)) < 0.7
    return h, idx, mask


@pytest.mark.parametrize("P", [2, 4])
def test_exchange_blocks_bit_exact_random(P):
    """Random send lists with out-of-range (clipped) indices, masked-off
    slots, NaN and -0.0 payloads."""
    h, idx, mask = _case(P, n_max=20, B=7, F=5, seed=P)
    want = _jax_stacked(jax_exchange, P, h, idx, mask)
    got = exchange_blocks(torch.from_numpy(h), torch.from_numpy(idx),
                          torch.from_numpy(mask)).numpy()
    assert got.shape == (P, (P - 1) * 7, 5)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    full = halo_exchange(torch.from_numpy(h), torch.from_numpy(idx),
                         torch.from_numpy(mask)).numpy()
    want_full = _jax_stacked(jax_halo_exchange, P, h, idx, mask)
    np.testing.assert_array_equal(_bits(full), _bits(want_full))


def test_exchange_blocks_bit_exact_bf16():
    P = 4
    h, idx, mask = _case(P, n_max=16, B=5, F=6, seed=9)
    # one rounding to bf16 (the frameworks encode NaN differently), the
    # same bits handed to both
    hb = np.asarray(jnp.asarray(h, jnp.bfloat16))
    want = _jax_stacked(jax_halo_exchange, P, hb, idx, mask)
    got = halo_exchange(torch.from_numpy(hb.view(np.int16).copy())
                        .view(torch.bfloat16),
                        torch.from_numpy(idx), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("P", [2, 4])
def test_halo_exchange_on_sharded_graph(P):
    """The real send lists of a ShardedGraph: the halo rows land in the
    slots its edge_src numbering expects."""
    g = synthetic_graph(num_nodes=240, avg_degree=8, n_feat=6, n_class=3,
                        seed=5)
    sg = ShardedGraph.build(g, partition_graph(g, P, method="random"),
                            n_parts=P)
    want = _jax_stacked(jax_halo_exchange, P, sg.feat, sg.send_idx,
                        sg.send_mask)
    got = halo_exchange(torch.from_numpy(sg.feat),
                        torch.from_numpy(sg.send_idx),
                        torch.from_numpy(sg.send_mask)).numpy()
    assert got.shape == (P, sg.n_max + sg.halo_size, sg.n_feat)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # every halo row used by an edge holds its global owner's features
    nid = sg.global_nid
    for r in range(P):
        e = int(sg.edge_count[r])
        s = sg.edge_src[r, :e]
        halo = s >= sg.n_max
        k = s[halo] - sg.n_max
        d = k // sg.b_max + 1
        owner = (r - d) % P
        rows = sg.send_idx[owner, d - 1, k % sg.b_max]
        np.testing.assert_array_equal(got[r, s[halo]],
                                      g.ndata["feat"][nid[owner, rows]])


def test_single_part_has_no_halo():
    h = torch.randn(1, 5, 3)
    idx = torch.zeros((1, 0, 4), dtype=torch.int32)
    mask = torch.zeros((1, 0, 4), dtype=torch.bool)
    assert halo_exchange(h, idx, mask) is h
    assert exchange_blocks(h, idx, mask).shape == (1, 0, 3)


# ---------------------------------------------------------------------------
# the gradients: return_blocks (K5), the stale concat and the exchange
# backward (K5 + K4 over the inverse send CSR)


def _repeat_case(P, n_max, B, F, seed):
    """Send lists unique within a distance that repeat rows across
    distances (as a node bordering several parts does), with masked-off
    pad slots."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((P, n_max, F)).astype(np.float32)
    idx = np.stack([np.stack([rng.permutation(n_max)[:B]
                              for _ in range(P - 1)]) for _ in range(P)])
    mask = rng.random((P, P - 1, B)) < 0.8
    idx = np.where(mask, idx, 0).astype(np.int32)  # pads: idx 0, mask off
    return h, idx, mask


def _sg(P):
    g = synthetic_graph(num_nodes=240, avg_degree=8, n_feat=6, n_class=3,
                        seed=5)
    return ShardedGraph.build(g, partition_graph(g, P, method="random"),
                              n_parts=P)


@pytest.mark.parametrize("P", [2, 4])
def test_return_blocks_bit_exact(P):
    from pipegcn_tpu.parallel.halo import return_blocks as jax_return

    B, F = 7, 5
    g = np.random.default_rng(P).standard_normal(
        (P, (P - 1) * B, F)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:P]), ("parts",))
    spec = PartitionSpec("parts")
    run = jax.jit(jax.shard_map(
        lambda x: jax_return(x[0], "parts", P, B)[None], mesh=mesh,
        in_specs=(spec,), out_specs=spec))
    want = np.asarray(run(jnp.asarray(g)))
    got = return_blocks(torch.from_numpy(g), B).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # a strided view of the halo rows, as the exchange backward hands it
    full = torch.from_numpy(np.concatenate(
        [np.zeros((P, 3, F), np.float32), g], axis=1))
    assert torch.equal(return_blocks(full[:, 3:], B), torch.from_numpy(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [41, 602])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_return_blocks_plain_matches_jax(P, F, dtype):
    """K5's plain version, which the card holds the kernel to bit for bit,
    against JAX's return_blocks under shard_map: P = 2, 3, 4 (blocks from
    different senders), F = 41 / 602 (rows of no 16-byte multiple), f32
    and bf16 rows with NaN and -0.0 payloads, a strided view (the halo
    rows of a [P, n_max + H, F] cotangent, 3 inner rows)."""
    from pipegcn_tpu.parallel.halo import return_blocks as jax_return
    from pipegcn_tpu_torch.parallel.halo import return_blocks_plain

    B = 6
    rng = np.random.default_rng(P * 1000 + F)
    g = rng.standard_normal((P, 3 + (P - 1) * B, F)).astype(np.float32)
    g[0, 3, 0], g[P - 1, 4, 1] = np.nan, -0.0
    if dtype == "bfloat16":  # bf16 bits: the top half of each f32
        bits = (g.view(np.uint32) >> 16).astype(np.uint16)
        tg = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        jg = jnp.asarray(bits).view(jnp.bfloat16)
    else:
        bits, tg, jg = g.view(np.uint32), torch.from_numpy(g), jnp.asarray(g)
    mesh = Mesh(np.array(jax.devices()[:P]), ("parts",))
    spec = PartitionSpec("parts")
    run = jax.jit(jax.shard_map(
        lambda x: jax_return(x[0, 3:], "parts", P, B)[None], mesh=mesh,
        in_specs=(spec,), out_specs=spec))
    want = np.asarray(run(jg).view(
        jnp.uint16 if dtype == "bfloat16" else jnp.uint32))
    view = tg[:, 3:]
    assert not view.is_contiguous()
    got = return_blocks_plain(view, B)
    assert got.dtype == tg.dtype and got.shape == (P, (P - 1) * B, F)
    got_bits = got.view(torch.int16 if dtype == "bfloat16"
                        else torch.int32).numpy().view(want.dtype)
    np.testing.assert_array_equal(got_bits, want)
    # the per-receiver blocks come from the senders the ring names
    for r in range(P):
        for d in range(1, P):
            np.testing.assert_array_equal(
                got_bits[r, (d - 1) * B:d * B],
                bits[(r + d) % P, 3 + (d - 1) * B:3 + d * B])


@pytest.mark.parametrize("P", [2, 4])
def test_send_csr_inverts_the_send_lists(P):
    h, idx, mask = _repeat_case(P, n_max=30, B=12, F=2, seed=P)
    ptr, slot = send_csr(idx, mask, 30)
    assert ptr.dtype == np.int32 and slot.dtype == np.int32
    for p in range(P):
        fi, fm = idx[p].reshape(-1), mask[p].reshape(-1)
        assert ptr[p, -1] == fm.sum()
        for i in range(30):
            row = slot[p, ptr[p, i]:ptr[p, i + 1]]
            np.testing.assert_array_equal(row, np.flatnonzero(fm & (fi == i)))
    if P > 2:
        assert np.diff(ptr, axis=1).max() > 1  # a row with several slots


@pytest.mark.parametrize("P", [2, 4])
def test_stale_concat_backward_matches_jax(P):
    """make_stale_concat's custom VJP per part: d_h = g[:N] + the masked
    stale bgrad scattered onto the send rows (repeats at P = 4), d_probe =
    this epoch's halo cotangent, nothing for the stale buffers. The same
    adds in the same slot order: rtol 1e-6."""
    from pipegcn_tpu.parallel.halo import make_stale_concat as jax_msc

    n_max, B, F = 30, 12, 4
    h, idx, mask = _repeat_case(P, n_max, B, F, seed=10 + P)
    H = (P - 1) * B
    rng = np.random.default_rng(P)
    stale_halo = rng.standard_normal((P, H, F)).astype(np.float32)
    stale_bgrad = rng.standard_normal((P, H, F)).astype(np.float32)
    g = rng.standard_normal((P, n_max + H, F)).astype(np.float32)
    ptr, slot = (torch.from_numpy(a) for a in send_csr(idx, mask, n_max))
    th = torch.from_numpy(h).requires_grad_(True)
    probe = torch.zeros((P, H, F), requires_grad=True)
    op = make_stale_concat(ptr, slot)
    out = op(th, torch.from_numpy(stale_halo), torch.from_numpy(stale_bgrad),
             probe)
    d_h, d_probe = torch.autograd.grad(out, [th, probe], torch.from_numpy(g))
    for p in range(P):
        jop = jax_msc(jnp.asarray(idx[p]), jnp.asarray(mask[p]), n_max)
        w_out, vjp = jax.vjp(jop, h[p], stale_halo[p], stale_bgrad[p],
                             np.zeros((H, F), np.float32))
        w_dh, w_dsh, w_dsb, w_dp = vjp(jnp.asarray(g[p]))
        np.testing.assert_array_equal(out[p].detach().numpy(),
                                      np.asarray(w_out))
        np.testing.assert_allclose(d_h[p].numpy(), np.asarray(w_dh),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(d_probe[p].numpy(), np.asarray(w_dp))
        assert not np.asarray(w_dsh).any() and not np.asarray(w_dsb).any()


@pytest.mark.parametrize("case", ["graph", "repeats"])
@pytest.mark.parametrize("P", [2, 4])
def test_halo_exchange_backward_matches_jax_vjp(P, case):
    """The vanilla exchange's backward (return along the reverse ring,
    then the scatter onto the send rows) against jax.vjp(halo_exchange)
    under shard_map: the real send lists of a ShardedGraph, and random
    ones repeating rows across distances. rtol 1e-6 (the same adds, XLA
    may order a row's up to P-1 slots differently)."""
    if case == "graph":
        sg = _sg(P)
        h, idx, mask = sg.feat, sg.send_idx, sg.send_mask
    else:
        h, idx, mask = _repeat_case(P, n_max=30, B=12, F=4, seed=20 + P)
    n_max, F = h.shape[1], h.shape[2]
    H = idx.shape[1] * idx.shape[2]
    g = np.random.default_rng(P).standard_normal(
        (P, n_max + H, F)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:P]), ("parts",))
    spec = PartitionSpec("parts")

    def body(h, g, i, m):
        _, vjp = jax.vjp(lambda x: jax_halo_exchange(x, i[0], m[0], "parts",
                                                     P), h[0])
        return vjp(g[0])[0][None]

    run = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                                out_specs=spec))
    want = np.asarray(run(jnp.asarray(h), jnp.asarray(g), jnp.asarray(idx),
                          jnp.asarray(mask)))
    th = torch.from_numpy(np.ascontiguousarray(h)).requires_grad_(True)
    inverse = tuple(torch.from_numpy(a) for a in send_csr(idx, mask, n_max))
    out = halo_exchange(th, torch.from_numpy(idx.astype(np.int32)),
                        torch.from_numpy(mask), inverse)
    (d_h,) = torch.autograd.grad(out, [th], torch.from_numpy(g))
    np.testing.assert_allclose(d_h.numpy(), want, rtol=1e-6, atol=1e-6)


def test_scatter_bgrad_plain_against_index_add():
    """The plain K4 (over the inverse CSR) equals a masked index_add_ over
    the send lists themselves, bit for bit on the CPU."""
    P, n_max, B, F = 4, 25, 10, 3
    h, idx, mask = _repeat_case(P, n_max, B, F, seed=3)
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.standard_normal((P, n_max, F)).astype(
        np.float32))
    bg = torch.from_numpy(rng.standard_normal((P, (P - 1) * B, F)).astype(
        np.float32))
    ptr, slot = (torch.from_numpy(a) for a in send_csr(idx, mask, n_max))
    got = scatter_bgrad(g, bg, ptr, slot)
    want = g.clone()
    for p in range(P):
        m = torch.from_numpy(mask[p].reshape(-1))
        want[p].index_add_(0, torch.from_numpy(idx[p].reshape(-1))[m].long(),
                           bg[p][m])
    assert torch.equal(got, want)
    assert torch.equal(got, scatter_bgrad_plain(g, bg, ptr, slot))
