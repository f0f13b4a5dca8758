"""The port's union-gather block layout (``--block-group > 1``; plain path,
CPU) against the JAX ``ops/block_spmm.py``: ``_group_union`` array for
array at group 2, 4 and 8 (and its ladder extension), the grouped stacked
tables key for key, the staged per-group lists, ``BlockSpmm`` forward and
backward against ``jax.vjp`` of the grouped ``make_device_block_spmm_fn``
at f32 and bf16 compute, and the GraphSAGE trainer at ``--spmm-impl block
--block-group 4 --rem-dtype float8 --halo-dtype float8`` against JAX's
emulated trainer at f32 and bf16.

Tolerances. Given the same inputs the grouped tile products sum the same
products as JAX's contraction in another order, and the port skips the
zero blocks JAX multiplies at a group's pads (ROADMAP C): at f32 each
output within 1e-5 of the sum of its terms' magnitudes; at bf16 compute
(rows and cotangents rounded to bf16 where JAX rounds them) within the
repo's bf16 tolerance, 2e-2 of each tensor's max. The trainers run on
JAX's transported values, wire values and relu masks, as
test_torch_halo_wire.py's and test_torch_bf16.py's do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipegcn_tpu.ops.block_spmm as jblk
import pipegcn_tpu.ops.bucket_spmm as jbs
from pipegcn_tpu_torch.models import first_copy
from pipegcn_tpu_torch.ops import block_spmm as pblk
from pipegcn_tpu_torch.ops.bucket_spmm import TransportShare
from pipegcn_tpu_torch.tree import tree_leaves
from test_torch_bf16 import (RTOL, TRANSPORT_FLIP_FRAC, Bf16Tap,
                             check_moments_and_params, close_to_max)
from test_torch_block import assert_tables_equal, sharded
from test_torch_bucket import to_torch
from test_torch_halo_wire import WireTap
from test_torch_train import CPU, one_torch_thread, port_sharded
from test_torch_train_bucket_transport import FLIP_FRAC

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

SUM_RTOL = 1e-5


def _blocks(seed, n_key, n_other, n_blocks):
    """Distinct (key tile, other tile) pairs in block order (sorted by
    key, then other: BlockPlan's dense-block order)."""
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(n_key * n_other, n_blocks, replace=False))
    return flat // n_other, flat % n_other


@pytest.mark.parametrize("group", [2, 4, 8, "extend"])
def test_group_union_matches_jax(group):
    """Classes, inv, counts and widths array-equal, both directions of a
    random block set (and of tests/test_block_spmm.py's ladder-extension
    case, a given ladder topping out below the widest union)."""
    if group == "extend":
        cases = [(np.array([0, 1, 2, 3, 0, 1]), np.arange(6), 4, 6, 4,
                  [1, 2])]
    else:
        keys, others = _blocks(group, 37, 41, 300)
        cases = [(keys, others, 37, 41, group, None),
                 (others, keys, 41, 37, group, None),
                 (keys, others, 37, 41, group, [1, 2, 3])]
    for keys, others, nk, no, g, widths in cases:
        keys, others = keys.astype(np.int64), others.astype(np.int64)
        nb = keys.shape[0]
        want = jblk._group_union(keys, others, nk, no, g, nb,
                                 widths=None if widths is None
                                 else list(widths))
        got = pblk._group_union(keys, others, nk, no, g, nb,
                                widths=None if widths is None
                                else list(widths))
        assert got[3] == want[3] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[0]) == len(want[0])
        for (ga, gt), (wa, wt) in zip(got[0], want[0]):
            np.testing.assert_array_equal(ga, wa)
            np.testing.assert_array_equal(gt, wt)
    if group == "extend":
        assert got[3][-1] >= 6
    # no blocks: empty classes, every tile on the sentinel
    e = np.zeros(0, np.int64)
    assert pblk._group_union(e, e, 5, 5, 2, 0)[1].tolist() == \
        jblk._group_union(e, e, 5, 5, 2, 0)[1].tolist()


# (P, duplicated pair count, group)
CASES = {"g2": (2, 0, 2), "g4": (2, 0, 4), "g8": (2, 0, 8),
         "g4-P4": (4, 0, 4), "g4-int8": (2, 2, 4), "g4-bf16A": (2, 200, 4)}


@pytest.mark.parametrize("case", list(CASES))
def test_grouped_tables_equal_the_jax_build(case):
    P, dup, group = CASES[case]
    sg = sharded(P, dup)
    want, _ = jblk.build_sharded_block_tables(sg, tile=16, n_feat_hint=16,
                                              group=group)
    stats = {}
    got, _ = pblk.build_sharded_block_tables(port_sharded(sg), tile=16,
                                             n_feat_hint=16, group=group,
                                             stats=stats)
    assert "blk_fwdu_inv" in got and "blk_fwd_ginv" not in got
    assert_tables_equal(got, want)
    assert stats["group"] == group


def _staged(sg, group, tile=16, hint=16):
    tables, _ = jblk.build_sharded_block_tables(sg, tile=tile,
                                                n_feat_hint=hint,
                                                group=group)
    np_tables = {k: (np.asarray(v).view(np.uint16)
                     if np.asarray(v).dtype.name == "bfloat16"
                     else np.asarray(v)) for k, v in tables.items()}
    return tables, pblk.stage_block_tables(
        np_tables, tile, sg.n_max, sg.n_max + sg.halo_size, CPU)


def test_group_lists_follow_the_classes():
    """Each group's slots are its class row's slots that hold a block, in
    order, with the row's A blocks per tile; every dense block appears
    once a direction; groups without a row have no slots; the union slots
    number fewer than the blocks (the dedupe)."""
    group = 4
    sg = sharded(2)
    tables, staged = _staged(sg, group)
    b_max = int(np.asarray(tables["blk_a_bits"]).shape[1])
    for direction, side in (("fwd", staged.fwd), ("bwd", staged.bwd)):
        assert isinstance(side, pblk.GroupSide) and side.group == group
        keys = sorted(k[:-1] for k in tables
                      if k.startswith(f"blk_{direction}u_g")
                      and k.endswith("a"))
        inv = np.asarray(tables[f"blk_{direction}u_inv"])
        for p in range(2):
            rows = []
            for k in keys:
                a, t = (np.asarray(tables[k + "a"])[p],
                        np.asarray(tables[k + "t"])[p])
                rows += [(a[r], t[r]) for r in range(a.shape[0])]
            ptr = side.ptr[p].numpy()
            for j in range(side.n_groups):
                lo, hi = ptr[j], ptr[j + 1]
                pos = inv[p, j * group]
                if pos == len(rows) * group:
                    assert lo == hi
                    continue
                a, t = rows[pos // group]
                keep = (a != b_max).any(axis=0)
                np.testing.assert_array_equal(side.tile[p, lo:hi].numpy(),
                                              t[keep])
                np.testing.assert_array_equal(side.blk[p, lo:hi].numpy(),
                                              a[:, keep].T)
            n = int(ptr[-1])
            blk = side.blk[p, :n]
            real = blk[blk != b_max]
            assert sorted(real.tolist()) == list(range(
                int((np.asarray(tables["blk_a_bits"])[p]
                     .reshape(b_max, -1).any(axis=1)).sum())))
            assert n < real.numel()


@pytest.mark.parametrize("stem,value", [("blk_fwdu_g", 10 ** 6),
                                        ("blk_bwdu_inv", -1),
                                        ("blk_fwdu_inv", 1)])
def test_grouped_staging_refuses_a_corrupt_index(stem, value):
    """A tile index past the input's tiles, a negative position, an inv
    whose tiles of one group point at different rows: the kernels trust
    the staged lists, so staging checks them."""
    sg = port_sharded(sharded(2))
    tables, _ = pblk.build_sharded_block_tables(sg, tile=16, n_feat_hint=16,
                                                group=4)
    key = next(k for k in sorted(tables) if k.startswith(stem)
               and k[-1] in "tv")
    bad = dict(tables)
    bad[key] = tables[key].copy()
    if key.endswith("t"):
        a = tables[key[:-1] + "a"]
        bad[key][(a != tables["blk_a_bits"].shape[1]).any(axis=2)] = value
        match = "out of"
    elif value < 0:
        bad[key].flat[0] = value
        match = "out of"
    else:  # tile 1 of a group with a row: the next row's tile 1
        total = sum(v.shape[1] for k, v in tables.items()
                    if k.startswith("blk_fwdu_g") and k.endswith("a"))
        inv = bad[key][0]
        j = int(np.nonzero(inv[::4] != total * 4)[0][0])
        row = int(inv[4 * j]) // 4
        inv[4 * j + 1] = ((row + 1) % total) * 4 + 1
        match = "one row"
    with pytest.raises(ValueError, match=match):
        pblk.stage_block_tables(bad, 16, sg.n_max,
                                sg.n_max + sg.halo_size, CPU)


def test_grouped_plain_edge_cases():
    """The plain grouped products on hand-made lists (16 x 16 tiles of
    bits, group 4): 5 output tiles (the last group's tail holds one tile,
    the last rows ragged), a group with no slot (zeros), a one-slot union,
    pads inside a union; against the group-1 plain products over the same
    (tile, block, input tile) entries. K16 / K17 refuse pair lists."""
    T, G = 16, 4
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 256, (1, 6, T, T // 8),
                                      dtype=np.uint8))
    n_out, n_in = 5 * T - 3, 3 * T
    # group 0: slots (tile 2: blocks [0, pad, 1, pad]), (tile 0: [pad, 2,
    # pad, pad]); group 1 (tile 4 only): slot (tile 1: [3, pad, pad, pad])
    pad = 6
    slots = [(0, 2, [0, pad, 1, pad]), (0, 0, [pad, 2, pad, pad]),
             (1, 1, [3, pad, pad, pad])]
    ptr = torch.tensor([[0, 2, 3]], dtype=torch.int32)
    tile = torch.tensor([[s[1] for s in slots]], dtype=torch.int32)
    blk = torch.tensor([[s[2] for s in slots]], dtype=torch.int32)
    fwd = pblk.GroupSide(ptr=ptr, tile=tile, blk=blk, group=G, n_out=n_out,
                         n_in=n_in, n_out_tiles=5, transpose=False)
    # the same products as pair lists keyed by output tile
    pairs = sorted((g * G + d, b, t) for g, t, bs in slots
                   for d, b in enumerate(bs) if b != pad)
    pptr = np.zeros(6, np.int32)
    np.cumsum(np.bincount([q[0] for q in pairs], minlength=5), out=pptr[1:])
    bside = pblk.BlockSide(
        ptr=torch.from_numpy(pptr[None]),
        blk=torch.tensor([[q[1] for q in pairs]], dtype=torch.int32),
        tile=torch.tensor([[q[2] for q in pairs]], dtype=torch.int32),
        n_out=n_out, n_in=n_in, transpose=False)
    gt = pblk.BlockTables(a=a, packed=True, tile=T, fwd=fwd, bwd=fwd,
                          rem_fwd=None, rem_bwd=None)
    bt = pblk.BlockTables(a=a, packed=True, tile=T, fwd=bside, bwd=bside,
                          rem_fwd=None, rem_bwd=None)
    x = torch.from_numpy(rng.standard_normal((1, n_in, 7))
                         .astype(np.float32))
    got = pblk.block_dense_grouped(x, gt)
    want = pblk.block_dense(x, bt)
    assert got.shape == (1, n_out, 7)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not bool(got[0, 3 * T:4 * T].any())  # tile 3: no block
    assert bool(got[0, 4 * T:].any())
    with pytest.raises(ValueError, match="union-gather"):
        pblk.block_dense_grouped(x, bt)
    with pytest.raises(ValueError, match="union-gather"):
        pblk.block_dense_grouped_t(x, bt)


def _jax_sides(tables, sg, fb, g, rem, tile=16):
    """JAX's forward and cotangent of every part, and its transported
    values (forward then backward), as test_torch_block.py takes them."""
    P = fb.shape[0]
    n_src = sg.n_max + sg.halo_size
    deg = sg.in_deg.astype(np.float32)
    outs, grads, casts = [], [], []
    for p in range(P):
        fn = jblk.make_device_block_spmm_fn(
            {k: jnp.asarray(v[p]) for k, v in tables.items()},
            jnp.asarray(deg[p]), sg.n_max, n_src, tile, rem_dtype=rem)
        want, vjp = jax.vjp(fn, jnp.asarray(fb[p]))
        (wg,) = vjp(jnp.asarray(g[p], want.dtype))
        outs.append(np.asarray(want, np.float32))
        grads.append(np.asarray(wg))
    if rem is not None:
        fwd_dt, bwd_dt = jbs.transport_dtypes(rem)
        gd = g.astype(np.float32) / deg[..., None]
        for x, dt in ((fb, fwd_dt), (gd, bwd_dt)):
            ys = [to_torch(np.asarray(jbs.transport_cast(jnp.asarray(x[p]),
                                                         dt)))
                  for p in range(P)]
            casts.append((torch.stack(ys), None))
    return np.stack(outs), np.stack(grads), casts


@pytest.mark.parametrize("group,rem", [(2, None), (4, "float8"), (8, None)])
@pytest.mark.parametrize("dup", [0, 200], ids=["bits", "bf16A"])
def test_grouped_block_spmm_matches_jax_vjp(group, rem, dup):
    """f32: forward and cotangent within 1e-5 of the sum of the terms'
    magnitudes (the port's plain products on |x|, |g|)."""
    P, F = 2, 10
    sg = sharded(P, dup)
    n_src = sg.n_max + sg.halo_size
    tables, staged = _staged(sg, group)
    rng = np.random.default_rng(9)
    fb = rng.standard_normal((P, n_src, F)).astype(np.float32)
    g = rng.standard_normal((P, sg.n_max, F)).astype(np.float32)
    deg = torch.from_numpy(sg.in_deg.astype(np.float32))
    want_out, want_grad, casts = _jax_sides(tables, sg, fb, g, rem)
    share = TransportShare.replaying(casts) if rem is not None else None
    x = torch.from_numpy(fb).requires_grad_(True)
    out = pblk.block_spmm(x, staged, deg, rem, share=share)
    out.backward(torch.from_numpy(g))
    abs_out = pblk.block_spmm(x.detach().abs(), staged, deg)
    xa = x.detach().abs().requires_grad_(True)
    pblk.block_spmm(xa, staged, deg).backward(torch.from_numpy(np.abs(g)))
    for got, want, mag in ((out.detach(), want_out, abs_out),
                           (x.grad, want_grad, xa.grad)):
        err = np.abs(got.numpy() - want)
        assert (err <= SUM_RTOL * mag.numpy() + 1e-6).all(), err.max()
    if rem is not None:
        assert share.flips == 0 and share.elements == fb.size + g.size


@pytest.mark.parametrize("group", [4])
def test_grouped_block_spmm_bf16_matches_jax_vjp(group):
    """bf16 compute (bf16 rows into the tile products, the cotangent
    rounded to bf16 before them, as JAX's ``:686-687``): within 2e-2 of
    each tensor's max; the f32 forward sum within 1e-5 of the terms."""
    P, F = 2, 10
    sg = sharded(P)
    n_src = sg.n_max + sg.halo_size
    tables, staged = _staged(sg, group)
    rng = np.random.default_rng(3)
    fb = np.asarray(jnp.asarray(rng.standard_normal((P, n_src, F)),
                                jnp.bfloat16))
    g = rng.standard_normal((P, sg.n_max, F)).astype(np.float32)
    deg = torch.from_numpy(sg.in_deg.astype(np.float32))
    want_out, want_grad, casts = _jax_sides(tables, sg, fb, g, "float8")
    x = to_torch(fb).requires_grad_(True)
    out = pblk.block_spmm(x, staged, deg, "float8",
                          share=TransportShare.replaying(casts))
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    abs_out = pblk.block_spmm(x.detach().abs(), staged, deg, "float8",
                              share=TransportShare.replaying(
                                  [(c[0].abs(), None) for c in casts]))
    err = np.abs(out.detach().numpy() - want_out)
    assert (err <= SUM_RTOL * abs_out.detach().numpy() + 1e-6).all()
    close_to_max(x.grad.float().numpy(), np.asarray(want_grad, np.float32),
                 "d_fbuf")


# ---------------------------------------------------------------------------
# the trainer: the slice's command at a small size


class Bf16WireTap(Bf16Tap, WireTap):
    """Bf16Tap's records plus the wire's casts."""


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group4_fp8_wire_trainer_matches_jax(monkeypatch, dtype):
    """GraphSAGE at --spmm-impl block --block-group 4 --rem-dtype float8
    --halo-dtype float8, pipelined P = 2, dropout 0, 3 epochs against
    the JAX emulated trainer on JAX's transported and wire values and
    relu masks: at f32 losses within 1e-4 and carries within 1e-5; at
    bf16 losses within 2e-2, the carries after the first epoch and the
    moments and params after the third as test_torch_bf16.py holds
    them."""
    from test_torch_halo_wire import tap_pair
    from test_torch_train_block import sharded as cluster_sharded

    bf16 = dtype == "bfloat16"
    sg = cluster_sharded(2)
    tap, jt, pt, _ = tap_pair(
        monkeypatch, 2, "pipelined", "float8", sg=sg,
        tap_cls=Bf16WireTap if bf16 else WireTap, spmm_impl="block",
        block_tile=32, block_group=4, rem_dtype="float8", dtype=dtype)
    assert pt.data.block.group == 4
    assert pt.feat.dtype == (torch.bfloat16 if bf16 else torch.float32)
    shares, jl, pl = [], [], []
    for e in range(3):
        jl.append(jt.train_epoch(e))
        jax.effects_barrier()
        pt.share = TransportShare(source=tap.source)
        shares.append(pt.share)
        pl.append(pt.train_epoch(e))
        if e and bf16:
            continue
        js, ps = jax.device_get(jt.state), pt.host_state()
        for grp in js["comm"]:
            for k, want in js["comm"][grp].items():
                want = np.asarray(want, np.float32)
                if bf16:
                    close_to_max(ps["comm"][grp][k], want, f"{grp}[{k}]")
                else:
                    np.testing.assert_allclose(ps["comm"][grp][k], want,
                                               rtol=1e-5, atol=1e-6,
                                               err_msg=f"{grp}[{k}]")
    np.testing.assert_allclose(pl, jl, rtol=RTOL if bf16 else 1e-4)
    assert not tap.records and not tap.relus  # every record used
    flips = sum(s.flips for s in shares)
    elements = sum(s.elements for s in shares)
    assert elements > 0
    assert flips <= (TRANSPORT_FLIP_FRAC if bf16 else FLIP_FRAC) * elements
    assert tap.relu_flips <= (1e-2 if bf16 else FLIP_FRAC) * \
        tap.relu_elements
    if bf16:
        check_moments_and_params(jax.device_get(jt.state), pt.host_state(),
                                 RTOL, 3)
    else:
        js, ps = jax.device_get(jt.state), pt.host_state()
        for w, gv in zip(tree_leaves(first_copy(js["params"])),
                         tree_leaves(ps["params"])):
            np.testing.assert_allclose(gv, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max())
