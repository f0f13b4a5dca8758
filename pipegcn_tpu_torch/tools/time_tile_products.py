"""Time K12 / K13 (the tile products, f32 rows and the bf16 mode), K16 /
K17 (the union-gather forward and transpose, both modes), K11 (the
per-part amax, plain and ``deg`` forms), K5 (the reverse-ring return,
one call and 20 back to back), K15 (the halo wire's encode, ring copy
and decode), K10 (the transport cast) and K14 (the halo wire's per-block
amax) of the port in one checkout, on the card:

    python3 pipegcn_tpu_torch/tools/time_tile_products.py <checkout> <label>
    python3 pipegcn_tpu_torch/tools/time_tile_products.py <checkout> <label> \\
        --k15-only          # K15 alone
    python3 pipegcn_tpu_torch/tools/time_tile_products.py <checkout> <label> \\
        --k10-k14-only      # K10 and K14 alone

Shapes. K12 / K13: the block cell's (P = 2, T = 256, F = 256, n_max =
71,792, H = n_max, ~5,600 random pairs a part each way, random 1-bit A).
K16: union tables at G = 4 over the same rows, each group ~30 union slots
of distinct random input tiles, each slot's block for each of the group's
tiles present with probability 0.66 (the pad otherwise; the wire cell
runs 11,311 products over 4,279 slots, 2.64 a slot). K17: the backward's
union tables at G = 4 alike (groups of source tiles, slots of destination
tiles), and beside it the alternative of a transposed copy of A: K16's
forward over the copy and the same lists (the same products), and the
copy's own build (unpack, transpose, pack on the card). K11: the bucket
cell's activations [2, n_max + H, 256] (plain form) and cotangents [2,
n_max, 256] with a random in-degree (``deg`` form), beside
``torch.linalg.vector_norm(ord=inf)`` over the same activations. K5: the
SAGE cell's return, the halo rows of a [2, n_max + H, 256] f32 cotangent
(a strided view), beside ``index_select`` of the same rows and a
``copy_`` of the same blocks, from the strided view and from a
contiguous copy (the card's copy floor), one call per event
pair and 20 calls back to back (the card's time a call, without the
wrapper's host work). K10, one call and 20 back to back: the bucket
cell's activations [2, n_max + H, 256] f32 and bf16 to e4m3 (the
forward), its cotangents [2, n_max, 256] f32 with a random in-degree to
e5m2 (the backward's ``g / in_deg``). K14, one call and 20 back to back,
at K15's shapes below: the exchange's amax over the permuted send rows,
the return's over the strided cotangent view. Each K10 and K14 key also
reports whether the kernel's output equals its plain version's bits
(``... exact``). K15: the wire cell's (P = 2, n_max = 71,792 bf16
rows of F = 256): the exchange of a block of 71,792 send rows, a random
permutation of each part's rows, mask set, on the e4m3 and bf16 wires
(the e4m3 wire with its blocks' K14 amax, computed once); the return of
the halo rows of a [2, n_max + H, 256] bf16 cotangent (a strided view, as
K5's) on the e5m2 and bf16 wires; one call and 20 back to back.

Prints one JSON line of medians (ms). To compare two commits, unpack the
other one (``git archive``) into a git-ignored directory and run the two
alternately in one call (parent, change, change, parent): each checkout
builds its own kernels."""
import dataclasses
import json
import sys
import time

import torch

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
from pipegcn_tpu_torch.ops import _build  # noqa: E402
from pipegcn_tpu_torch.ops import block_spmm as blk  # noqa: E402
from pipegcn_tpu_torch.ops import bucket_spmm as bs  # noqa: E402
from pipegcn_tpu_torch.parallel import halo  # noqa: E402

k15_only = "--k15-only" in sys.argv[3:]
k10_k14_only = "--k10-k14-only" in sys.argv[3:]
# the checkout's kernels, built together (a parent checkout may lack a
# source this one has)
_build.build([n for n in (
    ("halo_wire",) if k15_only else ("transport_cast", "halo_wire")
    if k10_k14_only else ("block_spmm", "block_tma", "transport_cast",
                          "halo_gather", "halo_wire"))
              if (_build.CSRC / f"{n}.cu").exists()])
torch.manual_seed(0)
P, T, F, G = 2, 256, 256, 4
n_out, n_in = 71792, 143584


def time_ms(fn, reps=30, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return sorted(ts)[len(ts) // 2]


def batched_ms(fn, calls=20):
    def run():
        for _ in range(calls):
            fn()
    return time_ms(run, reps=10, warmup=1) / calls


def k15(out):
    """K15 at the wire cell's shape: one call and 20 back to back."""
    h = torch.randn((P, n_out, F), device="cuda").bfloat16() * 2.0
    sidx = torch.stack([torch.randperm(n_out, device="cuda")
                        for _ in range(P)]).int().view(P, 1, n_out)
    smask = torch.ones((P, 1, n_out), dtype=torch.bool, device="cuda")
    cot = (torch.randn((P, n_out + n_out, F), device="cuda")
           * 1e-3).bfloat16()[:, n_out:]
    for key, x, si, sm, dt in (
            ("K15 exchange e4m3", h, sidx, smask, torch.float8_e4m3fn),
            ("K15 return e5m2", cot, None, None, torch.float8_e5m2),
            ("K15 exchange bf16", h, sidx, smask, torch.bfloat16),
            ("K15 return bf16", cot, None, None, torch.bfloat16)):
        amax = (halo.halo_amax(x, si, sm, n_out) if dt != torch.bfloat16
                else None)
        out[key] = time_ms(
            lambda: halo.halo_wire(x, si, sm, n_out, dt, amax))
        out[key + " batched"] = batched_ms(
            lambda: halo.halo_wire(x, si, sm, n_out, dt, amax))


def same_bits(a, b):
    """Equal bits, a NaN equal to any NaN."""
    nan = torch.isnan(a.float())
    if not torch.equal(nan, torch.isnan(b.float())):
        return False
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return bool(torch.equal(a.view(bits)[~nan], b.view(bits)[~nan]))


def k10_k14(out):
    """K10 at the bucket cell's shapes and K14 at K15's: one call and 20
    back to back, and whether each equals its plain version's bits."""
    act = torch.randn((P, n_in, F), device="cuda") * 2.0
    cot = torch.randn((P, n_out, F), device="cuda") * 1e-3
    deg = torch.randint(1, 600, (P, n_out), device="cuda").float()
    for key, x, dt, d in (
            ("K10 forward e4m3", act, torch.float8_e4m3fn, None),
            ("K10 backward e5m2", cot, torch.float8_e5m2, deg),
            ("K10 forward e4m3 bf16 rows", act.bfloat16(),
             torch.float8_e4m3fn, None)):
        out[key] = time_ms(lambda: bs.transport_cast(x, dt, d))
        out[key + " batched"] = batched_ms(
            lambda: bs.transport_cast(x, dt, d))
        out[key + " exact"] = same_bits(bs.transport_cast(x, dt, d)[0],
                                        bs.transport_cast_plain(x, dt, d)[0])
    del act, cot, deg
    h = torch.randn((P, n_out, F), device="cuda").bfloat16() * 2.0
    sidx = torch.stack([torch.randperm(n_out, device="cuda")
                        for _ in range(P)]).int().view(P, 1, n_out)
    smask = torch.ones((P, 1, n_out), dtype=torch.bool, device="cuda")
    cot = (torch.randn((P, n_out + n_out, F), device="cuda")
           * 1e-3).bfloat16()[:, n_out:]
    for key, x, si, sm in (("K14 exchange", h, sidx, smask),
                           ("K14 return", cot, None, None)):
        out[key] = time_ms(lambda: halo.halo_amax(x, si, sm, n_out))
        out[key + " batched"] = batched_ms(
            lambda: halo.halo_amax(x, si, sm, n_out))
        out[key + " exact"] = same_bits(
            halo.halo_amax(x, si, sm, n_out),
            halo.halo_amax_plain(x, si, sm, n_out))


if k15_only or k10_k14_only:
    res = {"label": label, "csrc": str(_build.CSRC),
           "card": torch.cuda.get_device_name(0)}
    (k15 if k15_only else k10_k14)(res)
    print(json.dumps(res))
    sys.exit(0)
n_out_t, n_in_t = -(-n_out // T), -(-n_in // T)
B = n_out_t * 20  # A blocks a part: 5,620 (the cell: 5,656)
a = torch.randint(0, 256, (P, B, T, T // 8), dtype=torch.uint8).cuda()


def side(n_keys, n_o, n_i, n_other_t, transpose):
    per = 20 if not transpose else 10  # ~5,600 pairs a part each way
    ptr = torch.arange(0, n_keys * per + 1, per, dtype=torch.int32)
    bl = torch.stack([torch.randperm(B)[:n_keys * per] for _ in range(P)])
    ti = torch.randint(0, n_other_t, (P, n_keys * per))
    return blk.BlockSide(ptr=ptr.repeat(P, 1).cuda(), blk=bl.int().cuda(),
                         tile=ti.int().cuda(), n_out=n_o, n_in=n_i,
                         transpose=transpose)


def union_side(slots_per_group=30, p_block=0.66, transpose=False):
    """The union lists at G = 4 (``transpose``: the backward's, keyed by
    source tile): distinct random input tiles a group, a block for each
    (slot, tile) with probability ``p_block``, at least one a slot, random
    blocks."""
    n_key_t, n_in_tiles = (n_in_t, n_out_t) if transpose else (n_out_t,
                                                               n_in_t)
    n_groups = -(-n_key_t // G)
    S = n_groups * slots_per_group
    til = torch.stack([torch.cat([torch.randperm(n_in_tiles)[
        :slots_per_group] for _ in range(n_groups)])
                       for _ in range(P)]).int()
    use = torch.rand((P, S, G)) < p_block
    use[..., 0] |= ~use.any(-1)
    bl = torch.full((P, S, G), B, dtype=torch.int32)
    for p in range(P):
        n = int(use[p].sum())
        bl[p][use[p]] = torch.randint(0, B, (n,), dtype=torch.int32)
    ptr = torch.arange(0, S + 1, slots_per_group, dtype=torch.int32)
    return blk.GroupSide(ptr=ptr.repeat(P, 1).cuda(), tile=til.cuda(),
                         blk=bl.cuda(), group=G,
                         n_out=n_in if transpose else n_out,
                         n_in=n_out if transpose else n_in,
                         n_out_tiles=n_key_t, transpose=transpose)


def transposed_bits(a):
    """Every 1-bit block of ``a`` [P, B, T, T // 8] transposed (unpacked,
    transposed, packed again, little-endian within each byte)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=a.device)
    bits = ((a[..., None] >> shifts) & 1).reshape(*a.shape[:2], T, T)
    bits = bits.transpose(2, 3).reshape(*a.shape[:2], T, T // 8, 8)
    return (bits << shifts).sum(-1, dtype=torch.uint8)


fwd = side(n_out_t, n_out, n_in, n_in_t, False)
t = blk.BlockTables(a=a, packed=True, tile=T, fwd=fwd, bwd=fwd,
                    rem_fwd=None, rem_bwd=None)
tt = blk.BlockTables(a=a, packed=True, tile=T,
                     fwd=side(n_in_t, n_in, n_out, n_out_t, True),
                     bwd=side(n_in_t, n_in, n_out, n_out_t, True),
                     rem_fwd=None, rem_bwd=None)
ug = union_side()
tg = blk.BlockTables(a=a, packed=True, tile=T, fwd=ug, bwd=ug,
                     rem_fwd=None, rem_bwd=None)
ugt = union_side(transpose=True)
tgt = blk.BlockTables(a=a, packed=True, tile=T, fwd=ugt, bwd=ugt,
                      rem_fwd=None, rem_bwd=None)


out = {"label": label, "csrc": str(_build.CSRC),
       "card": torch.cuda.get_device_name(0),
       "K16 union_slots": int(ug.ptr[:, -1].sum()),
       "K16 products": int((ug.blk != B).sum()),
       "K17 union_slots": int(ugt.ptr[:, -1].sum()),
       "K17 products": int((ugt.blk != B).sum())}
x = torch.randn((P, n_in, F), device="cuda")
g = torch.randn((P, n_in, F), device="cuda")[:, :n_out].contiguous()
torch.cuda.synchronize()
t0 = time.monotonic()
a_t = transposed_bits(a)
torch.cuda.synchronize()
out["K17 alt transposed copy build"] = (time.monotonic() - t0) * 1e3
tgt_copy = blk.BlockTables(
    a=a_t, packed=True, tile=T, fwd=dataclasses.replace(ugt, transpose=False),
    bwd=ugt, rem_fwd=None, rem_bwd=None)
for dt in (torch.float32, torch.bfloat16):
    xd, gd = x.to(dt), g.to(dt)
    out[f"K12 {dt}"] = time_ms(lambda: blk.block_dense(xd, t))
    out[f"K13 {dt}"] = time_ms(lambda: blk.block_dense_t(gd, tt))
    out[f"K16 {dt}"] = time_ms(lambda: blk.block_dense_grouped(xd, tg))
    out[f"K17 {dt}"] = time_ms(lambda: blk.block_dense_grouped_t(gd, tgt))
    # the alternative: K16's forward over the transposed copy
    out[f"K17 alt {dt}"] = time_ms(
        lambda: blk.block_dense_grouped(gd, tgt_copy))
    out[f"K17 alt {dt} bit-identical"] = bool(torch.equal(
        blk.block_dense_grouped(gd, tgt_copy),
        blk.block_dense_grouped_t(gd, tgt)))
del x, g, a_t, tgt_copy
act = torch.randn((P, n_in, F), device="cuda") * 2.0
cot = torch.randn((P, n_out, F), device="cuda") * 1e-3
deg = torch.randint(1, 600, (P, n_out), device="cuda").float()
out["K11"] = time_ms(lambda: bs.part_amax(act))
out["K11 deg"] = time_ms(lambda: bs.part_amax(cot, deg))
out["K11 library vector_norm"] = time_ms(lambda: torch.linalg.vector_norm(
    act, ord=float("inf"), dim=(1, 2)))
del act, cot, deg


full = torch.randn((P, n_out + n_out, F), device="cuda")
gh = full[:, n_out:]  # H = n_max at P = 2: one block a part
ridx = ((torch.arange(P, device="cuda")[:, None] + 1) % P * n_out
        + torch.arange(n_out, device="cuda")[None, :]).reshape(-1)
ghc = gh.contiguous().reshape(P * n_out, F)
dst = torch.empty((P, n_out, F), device="cuda")
out["K5"] = time_ms(lambda: halo.return_blocks(gh, n_out))
out["K5 batched"] = batched_ms(lambda: halo.return_blocks(gh, n_out))
out["K5 library index_select"] = time_ms(lambda: ghc.index_select(0, ridx))
out["K5 library index_select batched"] = batched_ms(
    lambda: ghc.index_select(0, ridx))
out["K5 copy_ floor"] = time_ms(lambda: dst.copy_(gh))
out["K5 copy_ floor batched"] = batched_ms(lambda: dst.copy_(gh))
ghv = ghc.view(P, n_out, F)
out["K5 copy_ contiguous"] = time_ms(lambda: dst.copy_(ghv))
out["K5 copy_ contiguous batched"] = batched_ms(lambda: dst.copy_(ghv))
del full, gh, ghc, ghv, dst, ridx
k15(out)
k10_k14(out)
print(json.dumps(out))
