"""Time K12 and K13 (the tile products, f32 rows and the bf16 mode) of the
port in one checkout, at the block cell's shapes (P = 2, T = 256, F = 256,
n_max = 71,792, H = n_max, ~5,600 random pairs a part each way, random
1-bit A), on the card:

    python3 pipegcn_tpu_torch/tools/time_tile_products.py <checkout> <label>

prints one JSON line of medians (ms). To compare two commits, unpack the
other one (``git archive``) into a git-ignored directory and run the two
alternately in one call (parent, change, change, parent): each checkout
builds its own kernels."""
import json
import sys

import torch

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
from pipegcn_tpu_torch.ops import _build  # noqa: E402
from pipegcn_tpu_torch.ops import block_spmm as blk  # noqa: E402

torch.manual_seed(0)
P, T, F = 2, 256, 256
n_out, n_in = 71792, 143584
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


fwd = side(n_out_t, n_out, n_in, n_in_t, False)
t = blk.BlockTables(a=a, packed=True, tile=T, fwd=fwd, bwd=fwd,
                    rem_fwd=None, rem_bwd=None)
tt = blk.BlockTables(a=a, packed=True, tile=T,
                     fwd=side(n_in_t, n_in, n_out, n_out_t, True),
                     bwd=side(n_in_t, n_in, n_out, n_out_t, True),
                     rem_fwd=None, rem_bwd=None)


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


out = {"label": label, "csrc": str(_build.CSRC),
       "card": torch.cuda.get_device_name(0)}
x = torch.randn((P, n_in, F), device="cuda")
g = torch.randn((P, n_in, F), device="cuda")[:, :n_out].contiguous()
for dt in (torch.float32, torch.bfloat16):
    xd, gd = x.to(dt), g.to(dt)
    out[f"K12 {dt}"] = time_ms(lambda: blk.block_dense(xd, t))
    out[f"K13 {dt}"] = time_ms(lambda: blk.block_dense_t(gd, tt))
print(json.dumps(out))
