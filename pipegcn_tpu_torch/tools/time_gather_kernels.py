"""Time K1 (the mean SpMM forward), K3 (its transpose), K6 (the GAT
attention forward) and K8 (its src-keyed backward pass) of the port in one
checkout, on the card:

    python3 pipegcn_tpu_torch/tools/time_gather_kernels.py <checkout> <label>
    python3 pipegcn_tpu_torch/tools/time_gather_kernels.py <checkout> <label> \\
        --sweep             # K1 at each slice plan, K6 and K8 against
                            # their plain versions
    python3 pipegcn_tpu_torch/tools/time_gather_kernels.py <checkout> <label> \\
        --gat-only          # K6 and K8 alone, with --sweep's check of them

Shapes (random CSRs made on the card from a seed: uniform sources, no
locality, as the serving layout's random parts):
  - K1: the serving cell's (P = 2, n_out = 116,488, n_src = 232,976,
    57,425,872 edges a part) at F = 256 f32, F = 602 f32 (the pp
    precompute) and F = 256 bf16; ``--sweep`` adds the training cell's
    sizes (n_out = 71,792, n_src = 143,584, 20,695,742 edges a part).
  - K3: the serving CSR's sizes transposed (n_src rows gathering F = 256
    f32 rows of n_out), with no reuse for a CTA's rows; and the training
    cell's sizes with its locality ("K3 clustered": P = 2, n_out =
    71,792, n_src = 143,584, 20,695,742 edges a part; source row s draws
    80 % of its edges uniformly from the 10 consecutive 256-row windows
    centred at s n_out / n_src and 20 % uniformly over all n_out,
    ascending within the row: about 10 dense windows a 256-row group,
    ~2,900 edges each, as the block cell's tiles).
  - K6 (training's NEG mode) and K8: the GAT cell's sizes (P = 2, n =
    71,792, R = 143,584, 20,695,742 edges a part, H = 4, dh = 64; K8 also
    at the logits layer's dh = 41), z rows f32, bf16 and e4m3 (K8's g rows
    f32, bf16, e5m2).

Each time is the median of CUDA event pairs around one call. Prints one
JSON line (ms). To compare two commits, unpack the other one (``git
archive``) into a git-ignored directory and run the two alternately in one
call (parent, change, change, parent): each checkout builds its own
kernels. ``--sweep`` needs this checkout's K1 plan entry
(``ops/spmm.py k1_launch``)."""
import json
import sys

import torch

root, label = sys.argv[1], sys.argv[2]
flags = sys.argv[3:]
sys.path.insert(0, root)
from pipegcn_tpu_torch.ops import _build, gat, spmm  # noqa: E402

SEED = 0
P = 2
SERVE = dict(n_out=116488, n_src=232976, edges=57425872)
TRAIN = dict(n_out=71792, n_src=143584, edges=20695742)
DH, H = 64, 4


def time_ms(fn, reps=15, warmup=3):
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


def random_csr(n_rows, n_idx, edges, seed):
    """indptr [P, n_rows + 1] int32 and idx [P, edges] int32: each edge's
    row and index uniform at random, rows sorted."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    indptr = torch.zeros((P, n_rows + 1), dtype=torch.int32, device="cuda")
    idx = torch.randint(0, n_idx, (P, edges), generator=gen, device="cuda",
                        dtype=torch.int32)
    for p in range(P):
        rows = torch.randint(0, n_rows, (edges,), generator=gen,
                             device="cuda")
        indptr[p, 1:] = torch.bincount(rows, minlength=n_rows).cumsum(0)
        del rows
    return indptr, idx


def deg_of(indptr):
    return indptr.diff(dim=1).clamp(min=1).float().contiguous()


def clustered_csr(n_rows, n_idx, edges, seed, local=0.8, win=256, span=10):
    """indptr [P, n_rows + 1] int32 and idx [P, edges] int32: rows uniform
    at random, each edge's index with probability ``local`` uniform in
    the ``span`` windows of ``win`` rows centred at row * n_idx / n_rows
    (kept inside [0, n_idx)), else uniform over all; ascending within a
    row."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    indptr = torch.zeros((P, n_rows + 1), dtype=torch.int32, device="cuda")
    idx = torch.empty((P, edges), dtype=torch.int32, device="cuda")
    w = span * win
    for p in range(P):
        rows = torch.randint(0, n_rows, (edges,), generator=gen,
                             device="cuda").sort().values
        indptr[p, 1:] = torch.bincount(rows, minlength=n_rows).cumsum(0)
        lo = (rows * n_idx // n_rows - w // 2).clamp(0, n_idx - w)
        near = lo + torch.randint(0, w, (edges,), generator=gen,
                                  device="cuda")
        far = torch.randint(0, n_idx, (edges,), generator=gen,
                            device="cuda")
        pick = torch.rand(edges, generator=gen, device="cuda") < local
        d = torch.where(pick, near, far)
        key = (rows * n_idx + d).sort().values
        idx[p] = (key % n_idx).int()
        del rows, lo, near, far, pick, d, key
    return indptr, idx


out = {"label": label, "csrc": str(_build.CSRC),
       "card": torch.cuda.get_device_name(0)}
gat_only = "--gat-only" in flags
_build.build(([] if gat_only else ["spmm_mean"]) + list(gat.LIBRARIES))


def k1_k3(gen):
    """K1 at the serving shape (``--sweep``: at every slice plan, and at
    the training cell's sizes), K3 at the serving CSR's transpose and at
    the training cell's locality."""
    # --- K1 / K3 at the serving shape ---------------------------------------
    ip, src = random_csr(SERVE["n_out"], SERVE["n_src"], SERVE["edges"], 1)
    deg = deg_of(ip)
    x256 = torch.randn((P, SERVE["n_src"], 256), generator=gen, device="cuda")
    x602 = torch.randn((P, SERVE["n_src"], 602), generator=gen, device="cuda")
    xb = x256.bfloat16()
    cases = {"K1 serving f32 F=256": x256, "K1 serving f32 F=602": x602,
             "K1 serving bf16 F=256": xb}
    for name, x in cases.items():
        out[name] = time_ms(lambda: spmm.spmm_mean(x, ip, src, deg),
                            reps=9 if x.shape[-1] > 256 else 15)
    if "--sweep" in flags:
        sweep = {}
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        out["l2_bytes"] = l2
        for name, x in cases.items():
            F, eb = x.shape[-1], x.element_size()
            whole = spmm.k1_launch(x, ip, src, deg, plan=(F, 0))
            res = {"whole": time_ms(lambda: spmm.k1_launch(
                x, ip, src, deg, plan=(F, 0)), reps=9)}
            for wb in (64, 128, 256):
                W = wb // eb
                for vec in (1, 2, 4, 8):
                    if W % vec or W // vec not in (8, 16, 32) \
                            or vec > 16 // eb or F % vec:
                        continue
                    plan = (W, vec)
                    got = spmm.k1_launch(x, ip, src, deg, plan=plan)
                    res[f"W={W} vec={vec}"] = {
                        "ms": time_ms(lambda: spmm.k1_launch(
                            x, ip, src, deg, plan=plan), reps=9),
                        "bit_identical": bool(torch.equal(got, whole))}
                    del got
            res["rule"] = list(spmm.k1_plan(x.shape[1], F, eb, l2,
                                             x.data_ptr()))
            sweep[name] = res
            del whole
        out["K1 sweep"] = sweep
    del x256, x602, xb, cases

    # K3 over the transposed sizes, dividing by the serving CSR's in-degrees
    it, dt = random_csr(SERVE["n_src"], SERVE["n_out"], SERVE["edges"], 2)
    g = torch.randn((P, SERVE["n_out"], 256), generator=gen, device="cuda")
    out["K3 serving f32 F=256"] = time_ms(
        lambda: spmm.spmm_mean_t(g, it, dt, deg))
    del ip, src, deg, it, dt, g
    k3_clustered(gen)

    if "--sweep" in flags:
        ip, src = random_csr(TRAIN["n_out"], TRAIN["n_src"], TRAIN["edges"], 4)
        deg = deg_of(ip)
        x = torch.randn((P, TRAIN["n_src"], 256), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            eb = xd.element_size()
            res = {"whole": time_ms(lambda: spmm.k1_launch(
                xd, ip, src, deg, plan=(256, 0)))}
            for wb in (64, 128, 256):
                W = wb // eb
                vec = max(1, W // 32)
                res[f"W={W} vec={vec}"] = time_ms(lambda: spmm.k1_launch(
                    xd, ip, src, deg, plan=(W, vec)))
            out["K1 sweep"][f"K1 train-size random {dtype}"] = res
        del ip, src, deg, x, xd


def k3_clustered(gen):
    """K3 at the training cell's sizes and locality."""
    it, dt = clustered_csr(TRAIN["n_src"], TRAIN["n_out"], TRAIN["edges"], 3)
    deg = torch.randint(1, 600, (P, TRAIN["n_out"]), generator=gen,
                        device="cuda").float()
    g = torch.randn((P, TRAIN["n_out"], 256), generator=gen, device="cuda")
    out["K3 clustered f32 F=256"] = time_ms(
        lambda: spmm.spmm_mean_t(g, it, dt, deg))
    del it, dt, deg, g


if not gat_only:
    k1_k3(torch.Generator(device="cuda").manual_seed(SEED))

# --- K6 / K8 at the GAT cell's sizes ------------------------------------------
gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
n, R = TRAIN["n_out"], TRAIN["n_src"]
ip, src = random_csr(n, R, TRAIN["edges"], 5)
it, dt = random_csr(R, n, TRAIN["edges"], 6)
z = torch.randn((P, R, H, DH), generator=gen, device="cuda")
el = torch.randn((P, R, H), generator=gen, device="cuda")
er = torch.randn((P, n, H), generator=gen, device="cuda")
rows = {"f32": (torch.float32, torch.float32),
        "bf16": (torch.bfloat16, torch.bfloat16),
        "e4m3": (torch.float8_e4m3fn, torch.float8_e5m2)}
for name, (zdt, gdt) in rows.items():
    zq = z.to(zdt)
    o, m, s = gat.gat_fwd(zq, el, er, ip, src)
    gg = torch.randn_like(o)
    rho = (gg * o).sum(-1)
    gq = gg.to(gdt)
    out[f"K6 NEG {name}"] = time_ms(
        lambda: gat.gat_fwd(zq, el, er, ip, src, neg=True))
    out[f"K6 eval {name}"] = time_ms(lambda: gat.gat_fwd(zq, el, er, ip, src))
    out[f"K8 {name}"] = time_ms(
        lambda: gat.gat_bwd_src(zq, el, er, m, s, gq, rho, it, dt))
    del o, m, s, gg, rho, gq, zq
    # K8 at the logits layer's dh = 41 (chunks of 4 straddle two heads)
    zq = z[..., :41].contiguous().to(zdt)
    o, m, s = gat.gat_fwd(zq, el, er, ip, src)
    gg = torch.randn_like(o)
    rho = (gg * o).sum(-1)
    gq = gg.to(gdt)
    out[f"K8 {name} dh=41"] = time_ms(
        lambda: gat.gat_bwd_src(zq, el, er, m, s, gq, rho, it, dt))
    del o, m, s, gg, rho, gq, zq

if gat_only or "--sweep" in flags:
    # K6 and K8 against their plain versions on a cut of the cell's sizes
    # (K8 over a random transpose CSR of its own): K6's m bit-exact, the
    # rest at a relative error far below the GAT tolerances that
    # chip_smoke.py holds them to; K8's d_z on rows one element off
    # alignment bit-identical to the aligned rows'
    small = random_csr(4000, 9000, 1200000, 7)
    small_t = random_csr(9000, 4000, 1200000, 8)
    zs = torch.randn((P, 9000, H, DH), generator=gen, device="cuda")
    els = torch.randn((P, 9000, H), generator=gen, device="cuda")
    ers = torch.randn((P, 4000, H), generator=gen, device="cuda")
    gs = torch.randn((P, 4000, H, DH), generator=gen, device="cuda")

    def unaligned(x):
        u = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:]
        return u.view(x.shape).copy_(x)

    def rel(got, ref):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, ref)]

    k6c, k8c = {}, {}
    for name, (zdt, gdt) in rows.items():
        for dh in (64, 41):
            zq = zs[..., :dh].contiguous().to(zdt)
            got = gat.gat_fwd(zq, els, ers, *small, neg=True)
            ref = gat.gat_fwd_plain(zq, els, ers, *small, neg=True)
            again = gat.gat_fwd(zq, els, ers, *small, neg=True)
            k6c[f"{name} dh={dh}"] = {
                "m_bit_exact": bool(torch.equal(got[1], ref[1])),
                "rerun_bit_identical": all(
                    torch.equal(a, b) for a, b in zip(got, again)),
                "rel_err": rel(got, ref)}
            gq = gs[..., :dh].contiguous().to(gdt)
            rho = (gq.float() * ref[0]).sum(-1)
            a8 = (zq, els, ers, ref[1], ref[2], gq, rho, *small_t)
            got = gat.gat_bwd_src(*a8)
            k8c[f"{name} dh={dh}"] = {
                "rerun_bit_identical": all(
                    torch.equal(a, b)
                    for a, b in zip(got, gat.gat_bwd_src(*a8))),
                "unaligned_d_z_bit_identical": bool(torch.equal(
                    gat.gat_bwd_src(unaligned(zq), *a8[1:5], unaligned(gq),
                                    *a8[6:])[0], got[0])),
                "rel_err": rel(got, gat.gat_bwd_src_plain(*a8))}
    out["K6 check"], out["K8 check"] = k6c, k8c
    del small, small_t, zs, els, ers, gs

print(json.dumps(out))
