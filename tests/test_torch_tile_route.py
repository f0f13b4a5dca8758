"""The tile products' route onto csrc/block_tma.cu (plain path, CPU; the
kernels run only on the card, where chip_smoke.py holds them against
block_dense_plain): ``tile_entry`` case by case; K12's and K13's view
of a pair list as the union list of group 1 (``union_view``), array for array the
lists that ``_group_union`` and ``_flatten_unions`` build at group 1 over
the same dense blocks, with the same plain products through either; and
K17's function, A^T over the backward's union lists, equal to K16's
forward over a transposed copy of A on the same lists."""

import dataclasses

import numpy as np
import pytest
import torch

from pipegcn_tpu_torch.ops import block_spmm as pblk
from test_torch_block import sharded
from test_torch_train import CPU, one_torch_thread, port_sharded

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

A_DTYPES = {"bits": torch.uint8, "int8": torch.int8,
            "bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("a", list(A_DTYPES))
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("grouped", [False, True], ids=["pairs", "groups"])
def test_tile_entry(grouped, transpose, a):
    """1-bit, int8 or bf16 A runs on the TMA / wgmma entry in both
    directions, over pair lists (K12, K13) and union groups (K16, K17);
    f32 A keeps block_spmm.cu's entries."""
    got = pblk.tile_entry(grouped, transpose, A_DTYPES[a])
    if a != "f32":
        want = "pgt_block_grouped_tma"
    else:
        want = "pgt_block_grouped" if grouped else "pgt_block_dense"
    assert got == want


def _union_tables_at_group_1(psg, tile, hint, b_max):
    """The forward union-gather tables of the stacked build's layout at
    group 1 over each part's dense blocks (BlockPlan's selection):
    ``_group_union`` per part on one shared ladder, pads mapped to the
    shared zero block ``b_max``, rows padded to the shared caps, inv
    reoffset to them."""
    n_src = psg.n_max + psg.halo_size
    plans, unions = [], []
    for r in range(psg.num_parts):
        e = pblk.PartEdges(psg.edge_src[r], psg.edge_dst[r], psg.n_max,
                           n_src, tile)
        plans.append(pblk.BlockPlan(e, hint))
    ladder = None
    for _ in range(2):  # the second pass on the longest part's ladder
        unions = []
        for p in plans:
            bd = p.dense_ids // p.n_src_tiles
            bs = p.dense_ids % p.n_src_tiles
            unions.append(pblk._group_union(bd, bs, p.n_dst_tiles,
                                            p.n_src_tiles, 1, p.B,
                                            widths=ladder))
        ladder = max((u[3] for u in unions), key=len)
    caps = [max(u[2][w] for u in unions) for w in range(len(ladder))]
    tables = {}
    for p, (classes, inv, counts, _) in zip(plans, unions):
        tables.setdefault("blk_fwdu_inv", []).append(
            pblk._reoffset_inv(inv, counts, caps))
        for w, (a_idx, t_mat) in enumerate(classes):
            if not caps[w]:
                continue
            a_idx = np.where(a_idx == p.B, b_max, a_idx)
            tables.setdefault(f"blk_fwdu_g{w:02d}a", []).append(
                pblk._pad_rows(a_idx, caps[w], b_max).astype(np.int32))
            tables.setdefault(f"blk_fwdu_g{w:02d}t", []).append(
                pblk._pad_rows(t_mat, caps[w], p.n_src_tiles)
                .astype(np.int32))
    return ({k: np.stack(v) for k, v in tables.items()},
            [p.B for p in plans])


@pytest.mark.parametrize("P", [1, 2])
def test_union_view_equals_the_group_1_union_lists(P):
    psg = port_sharded(sharded(P))
    tile, hint = 16, 8
    n_src = psg.n_max + psg.halo_size
    st = {}
    host, _ = pblk.build_sharded_block_tables(psg, tile=tile,
                                              n_feat_hint=hint, stats=st)
    t = pblk.stage_block_tables(host, tile, psg.n_max, n_src, CPU)
    assert isinstance(t.fwd, pblk.BlockSide) and min(st["blocks"]) > 0
    view = pblk.union_view(t.fwd)
    # a view of the same tensors, no copy
    assert view.blk.data_ptr() == t.fwd.blk.data_ptr()
    assert view.ptr is t.fwd.ptr and view.tile is t.fwd.tile
    assert (view.group, view.n_groups, view.n_out_tiles) == \
        (1, t.fwd.n_out_tiles, t.fwd.n_out_tiles)
    for p in range(P):  # no slot holds the pad
        n = int(view.ptr[p, -1])
        assert not bool((view.blk[p, :n, 0] == t.b_max).any())

    tables, blocks = _union_tables_at_group_1(psg, tile, hint, t.b_max)
    assert blocks == st["blocks"]
    ptr, til, blk, group = pblk._flatten_unions(
        tables, "fwd", t.b_max, -(-n_src // tile))
    assert group == 1
    np.testing.assert_array_equal(view.ptr.numpy(), ptr)
    np.testing.assert_array_equal(view.tile.numpy(), til)
    np.testing.assert_array_equal(view.blk.numpy(), blk)

    built = pblk.GroupSide(ptr=torch.from_numpy(ptr),
                           tile=torch.from_numpy(til),
                           blk=torch.from_numpy(blk), group=1,
                           n_out=psg.n_max, n_in=n_src,
                           n_out_tiles=t.fwd.n_out_tiles, transpose=False)
    x = torch.from_numpy(np.random.default_rng(P).standard_normal(
        (P, n_src, 24)).astype(np.float32))
    want = pblk.block_dense_plain(x, t, t.fwd)
    assert bool(want.any())
    for side in (view, built):
        assert torch.equal(pblk.block_dense_plain(x, t, side), want)


@pytest.mark.parametrize("P", [1, 2])
def test_k13_view_of_the_backward_pairs(P):
    """K13's route: the backward pair list seen as the union list of group
    1 (``union_view``, a view of the same tensors, transposed as the
    list), whose plain products (A^T over each source tile's pairs) equal
    those of the pair list; ``tile_entry`` sends it to the TMA entry."""
    psg = port_sharded(sharded(P))
    tile, hint = 16, 8
    n_src = psg.n_max + psg.halo_size
    host, _ = pblk.build_sharded_block_tables(psg, tile=tile,
                                              n_feat_hint=hint)
    t = pblk.stage_block_tables(host, tile, psg.n_max, n_src, CPU)
    assert isinstance(t.bwd, pblk.BlockSide) and t.bwd.transpose
    view = pblk.union_view(t.bwd)
    assert view.transpose and view.group == 1
    assert view.blk.data_ptr() == t.bwd.blk.data_ptr()
    assert (view.n_out, view.n_in, view.n_out_tiles) == (
        t.bwd.n_out, t.bwd.n_in, t.bwd.n_out_tiles)
    assert pblk.tile_entry(False, True, t.a.dtype) == "pgt_block_grouped_tma"
    g = torch.from_numpy(np.random.default_rng(P + 7).standard_normal(
        (P, psg.n_max, 24)).astype(np.float32))
    want = pblk.block_dense_plain(g, t, t.bwd)
    assert bool(want.any())
    assert torch.equal(pblk.block_dense_plain(g, t, view), want)
    assert torch.equal(pblk.block_dense_t(g, t), want)


def _transposed(a: torch.Tensor, packed: bool) -> torch.Tensor:
    """Stored A blocks ``[P, B, T, T(/8)]`` each transposed: 1-bit blocks
    unpacked, transposed and packed again (little-endian in each byte)."""
    if not packed:
        return a.transpose(-1, -2).contiguous()
    T = a.shape[2]
    bits = pblk._unpack(a, True).to(torch.uint8).transpose(-1, -2)
    shifts = torch.arange(8, dtype=torch.uint8)
    return (bits.reshape(*a.shape[:2], T, T // 8, 8) << shifts).sum(
        -1, dtype=torch.uint8)


@pytest.mark.parametrize("dup", [0, 2, 200], ids=["bits", "int8", "bf16"])
def test_k17_is_k16_over_the_transposed_blocks(dup):
    """K17's function (A^T over the backward's union lists at group 4,
    which the TMA entry now runs) equals K16's forward over a transposed
    copy of A on the same lists (the alternative K17 design timed in
    tools/time_tile_products.py), in the 1-bit, int8 and bf16 encodings;
    reading A untransposed over those lists (the planted fault of
    chip_smoke.py's K17 checks) gives another result."""
    psg = port_sharded(sharded(2, dup))
    tile, n_src = 16, psg.n_max + psg.halo_size
    host, _ = pblk.build_sharded_block_tables(psg, tile=tile,
                                              n_feat_hint=16, group=4)
    t = pblk.stage_block_tables(host, tile, psg.n_max, n_src, CPU)
    want_dtype = {0: torch.uint8, 2: torch.int8, 200: torch.bfloat16}[dup]
    assert t.a.dtype == want_dtype and t.bwd.transpose and t.group == 4
    assert pblk.tile_entry(True, True, t.a.dtype) == "pgt_block_grouped_tma"
    g = torch.from_numpy(np.random.default_rng(dup).standard_normal(
        (2, t.bwd.n_in, 24)).astype(np.float32))
    want = pblk.block_dense_plain(g, t, t.bwd)
    assert bool(want.any())
    lists = dataclasses.replace(t.bwd, transpose=False)
    copy = dataclasses.replace(t, a=_transposed(t.a, t.packed))
    got = pblk.block_dense_plain(g, copy, lists)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    wrong = pblk.block_dense_plain(g, t, lists)
    assert (wrong - want).abs().max() > 1e-2
