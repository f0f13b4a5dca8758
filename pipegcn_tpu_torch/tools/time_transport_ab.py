"""Time K10 (the transport cast), K14 (the halo wire's per-block amax),
K15 (the halo wire), K18 (the dirty-row exchange) and K19 (the rows and
ranges forms of the integrity digests) of several checkouts side by side
in one process, on the card:

    python3 pipegcn_tpu_torch/tools/time_transport_ab.py \\
        parent=<checkout> change=<checkout> [<label>=<checkout> ...] \\
        [--rounds 12] [--only K18,K19]

Each checkout builds its own ``transport_cast``, ``halo_wire``,
``halo_gather`` and ``digest`` libraries (one process each, all
together); this process loads them all with ``ctypes`` and calls their C
entry points on the same tensors, in interleaved rounds (the checkouts in
order, then reversed). Separate processes, as ``time_tile_products.py``
runs them, place their tensors anew each time, and K14's 73.5 MB of rows
against the 50 MB L2 then read up to 40 % apart from one process to the
next; side by side most keys' rounds stay within 1 % of each other.
``--only`` keeps the keys that start with one of the given prefixes.
Shapes: ``time_tile_products.py``'s K10 and K14 keys (K10: the bucket
cell's activations [2, 143,584, 256] f32 and bf16 to e4m3, its
cotangents [2, 71,792, 256] f32 / a random in-degree to e5m2; K14: the
exchange of 71,792 permuted bf16 rows a part, the return of the strided
halo view of a [2, 143,584, 256] bf16 cotangent; K15: the same exchange
on the e4m3 and bf16 wires, the same return on the e5m2 and bf16 wires,
the fp8 wires with their blocks' amax); K18 at the serving freshness
cell's shapes (P = 2, n_max = B = 116,488, F = 602 f32 rows, a permuted
send list with 0.1 % of its slots masked off) with 32, 4,096 and all
rows dirty, and with every slot masked off (the scan alone); K19's rows
form at the training wire lane's shape (71,792 permuted send rows of 256
f32 a part, 3 % masked off) and at the serving guard's (K18's send lists
and rows, 32 dirty rows), and its ranges form over the guard's received
halo ([2, 71,792, 256] f32, one distance block a part). Each kernel's
output is first held to this checkout's plain versions, bit for bit.

Prints one JSON line: per label and key the median ms of 20 calls back
to back ("hot": the rows partly in L2 from the call before) and of one
call after a 160 MB write ("cold"), and for K18 and K19 the kernel time
a call that ``torch.profiler`` reads over 20 calls, the mean over the
launches it saw ("device": a call of these small kernels from Python may
take longer on the host than on the card, so that "hot" counts the
host), with each's lowest and highest round."""
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from pipegcn_tpu_torch.ops import bucket_spmm as bs  # noqa: E402
from pipegcn_tpu_torch.ops import digest as dg  # noqa: E402
from pipegcn_tpu_torch.parallel import halo  # noqa: E402
from pipegcn_tpu_torch.serve import freshness as fresh  # noqa: E402

args = [a for a in sys.argv[1:] if "=" in a]
rounds = (int(sys.argv[sys.argv.index("--rounds") + 1])
          if "--rounds" in sys.argv else 12)
only = (tuple(sys.argv[sys.argv.index("--only") + 1].split(","))
        if "--only" in sys.argv else ("",))
checkouts = dict(a.split("=", 1) for a in args)
# the libraries the chosen keys run: a key's kernel by its prefix
LIBS = {"K10": "transport_cast", "K14": "halo_wire", "K15": "halo_wire",
        "K18": "halo_gather", "K19": "digest"}
names = sorted({n for k, n in LIBS.items()
                if any(k.startswith(o) or o.startswith(k) for o in only)})
# each checkout's libraries and whether its entries take the vector
# width (older checkouts take none)
probe = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from pipegcn_tpu_torch.ops import _build, bucket_spmm; "
         "names = sys.argv[2:]; _build.build(names); "
         "print(json.dumps({n: str(_build._lib_path(n)) for n in names} | "
         "{'vec': hasattr(bucket_spmm, 'k10_vec')}))")
procs = {k: subprocess.Popen([sys.executable, "-c", probe, v, *names],
                             stdout=subprocess.PIPE, text=True)
         for k, v in checkouts.items()}
P_, I_, LL_, F_ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# each C entry: its library and its arguments (``vec``: the vector width
# where the checkout takes one)
ENTRIES = {
    "amax": ("halo_wire", "pgt_halo_amax",
             [P_, I_, LL_, I_, I_, I_, I_, P_, P_, P_, "vec", P_]),
    "cast": ("transport_cast", "pgt_transport_cast",
             [P_, I_, I_, I_, I_, P_, P_, I_, F_, P_, P_, "vec", P_]),
    "wire": ("halo_wire", "pgt_halo_wire",
             [P_, I_, LL_, I_, I_, I_, I_, P_, P_, P_, I_, F_, P_, P_, P_,
              I_, P_]),
    "dirty": ("halo_gather", "pgt_dirty_exchange",
              [P_, LL_, P_, LL_, P_, P_, P_, I_, I_, I_, I_, P_]),
    "rows": ("digest", "pgt_digest_rows",
             [P_, LL_, I_, I_, I_, I_, I_, P_, P_, P_, P_, P_]),
    "ranges": ("digest", "pgt_digest_ranges",
               [P_, LL_, LL_, I_, I_, LL_, I_, P_, P_])}
libs = {}
for k, p in procs.items():
    out, _ = p.communicate()
    if p.returncode:
        sys.exit(f"{k}: the build failed")
    info = json.loads(out.strip().splitlines()[-1])
    libs[k] = {"vec": info["vec"]}
    for e, (lib, sym, argt) in ENTRIES.items():
        if lib in info:
            fn = getattr(ctypes.CDLL(info[lib]), sym)
            fn.argtypes = [I_ if a == "vec" else a for a in argt
                           if a != "vec" or info["vec"]]
            libs[k][e] = fn

P, F, n_out, n_in = 2, 256, 71792, 143584
st = torch.cuda.current_stream().cuda_stream
torch.manual_seed(0)
h = torch.randn((P, n_out, F), device="cuda").bfloat16() * 2.0
sidx = torch.stack([torch.randperm(n_out, device="cuda")
                    for _ in range(P)]).int().view(P, 1, n_out)
smask = torch.ones((P, 1, n_out), dtype=torch.bool, device="cuda")
g16 = (torch.randn((P, 2 * n_out, F), device="cuda")
       * 1e-3).bfloat16()[:, n_out:]
act = torch.randn((P, n_in, F), device="cuda") * 2.0
act16 = act.bfloat16()
cot = torch.randn((P, n_out, F), device="cuda") * 1e-3
deg = torch.randint(1, 600, (P, n_out), device="cuda").float()
amax = torch.zeros((P, P - 1), dtype=torch.int32, device="cuda")
y8 = torch.empty((P, n_in, F), dtype=torch.float8_e4m3fn, device="cuda")
y5 = torch.empty((P, n_out, F), dtype=torch.float8_e5m2, device="cuda")
evict = torch.empty(160 * 2 ** 20, dtype=torch.uint8, device="cuda")


def k14(k, x, si, sm):
    fn, vec = libs[k]["amax"], libs[k]["vec"]
    extra = (halo.k14_vec(x),) if vec else ()
    return lambda: fn(x.data_ptr(), 1, x.stride(0), P, x.shape[1], F, n_out,
                      None if si is None else si.data_ptr(),
                      None if sm is None else sm.data_ptr(),
                      amax.data_ptr(), *extra, st)


def k10(k, x, y, d, dt):
    fn, vec = libs[k]["cast"], libs[k]["vec"]
    extra = (bs.k10_vec(x, y, d),) if vec else ()
    return lambda: fn(x.data_ptr(), int(x.dtype == torch.bfloat16), P,
                      x.shape[1], F, None if d is None else d.data_ptr(),
                      None, bs._OUT_TYPES[dt], bs.F8_MAX[dt], y.data_ptr(),
                      None, *extra, st)


wires = {}  # per (wire type, path): its blocks' amax, wire, inv, out


def k15(k, x, si, sm, dt):
    fn = libs[k]["wire"]
    key = (dt, si is None)
    if key not in wires:
        a = (halo.halo_amax_plain(x, si, sm, n_out) if dt in bs.F8_MAX
             else None)
        wires[key] = (a, torch.empty((P, P - 1, n_out, F), dtype=dt,
                                     device="cuda"),
                      torch.empty((P, P - 1), device="cuda"),
                      torch.empty((P, (P - 1) * n_out, F), dtype=x.dtype,
                                  device="cuda"))
    a, w, inv, out = wires[key]
    return lambda: fn(x.data_ptr(), 1, x.stride(0), P, x.shape[1], F, n_out,
                      None if si is None else si.data_ptr(),
                      None if sm is None else sm.data_ptr(),
                      None if a is None else a.data_ptr(),
                      bs._OUT_TYPES[dt], bs.F8_MAX.get(dt, 0.0),
                      w.data_ptr(), inv.data_ptr(), out.data_ptr(),
                      halo.k15_vec(x, w, out), st)


# K18 / K19 at the serving freshness cell's shapes and the training wire
# lane's
n_fr, F_fr = 116488, 602
h_fr = torch.randn((P, n_fr, F_fr), device="cuda")
idx_fr = torch.stack([torch.randperm(n_fr, device="cuda")
                      for _ in range(P)]).int().view(P, 1, n_fr)
mask_fr = torch.rand((P, 1, n_fr), device="cuda") > 0.001
off_fr = torch.zeros_like(mask_fr)
halo_fr = torch.randn((P, n_fr, F_fr), device="cuda")


def dirty_rows(n):
    d = torch.zeros(P * n_fr, dtype=torch.bool, device="cuda")
    d[torch.randperm(P * n_fr, device="cuda")[:n]] = True
    return d.view(P, n_fr)


dirty_fr = {n: dirty_rows(n) for n in (32, 4096, P * n_fr)}
mask_wl = torch.rand((P, 1, n_out), device="cuda") > 0.03
h_wl = torch.randn((P, n_out, F), device="cuda")
# K19's words: [P, P-1] for the rows form, [P, 2] for the ranges form
sums = torch.zeros((P, 2), dtype=torch.int32, device="cuda")


def k18(k, h_, dirty_, mask_):
    fn = libs[k]["dirty"]
    rb = h_.shape[2] * h_.element_size()
    return lambda: fn(h_.data_ptr(), h_.shape[1] * rb, halo_fr.data_ptr(),
                      n_fr * rb, idx_fr.data_ptr(), mask_.data_ptr(),
                      dirty_.data_ptr(), P, h_.shape[1], n_fr, rb, st)


def k19_rows(k, h_, idx_, mask_, dirty_):
    fn = libs[k]["rows"]
    rb = h_.shape[2] * h_.element_size()
    return lambda: fn(h_.data_ptr(), h_.stride(0) * 4, P, h_.shape[1], rb, 4,
                      idx_.shape[2], idx_.data_ptr(), mask_.data_ptr(),
                      None if dirty_ is None else dirty_.data_ptr(),
                      sums.data_ptr(), st)


def k19_ranges(k, x):
    fn = libs[k]["ranges"]
    n = x[0].numel()
    return lambda: fn(x.data_ptr(), x.stride(0) * 4, n * 4, P, 1, n, 4,
                      sums.data_ptr(), st)


cases = {
    "K10 forward e4m3": (k10, (act, y8, None, torch.float8_e4m3fn)),
    "K10 backward e5m2": (k10, (cot, y5, deg, torch.float8_e5m2)),
    "K10 forward e4m3 bf16 rows": (k10, (act16, y8, None,
                                         torch.float8_e4m3fn)),
    "K14 exchange": (k14, (h, sidx, smask)),
    "K14 return": (k14, (g16, None, None)),
    "K15 exchange e4m3": (k15, (h, sidx, smask, torch.float8_e4m3fn)),
    "K15 return e5m2": (k15, (g16, None, None, torch.float8_e5m2)),
    "K15 exchange bf16": (k15, (h, sidx, smask, torch.bfloat16)),
    "K15 return bf16": (k15, (g16, None, None, torch.bfloat16)),
    "K18 32 dirty": (k18, (h_fr, dirty_fr[32], mask_fr)),
    "K18 4096 dirty": (k18, (h_fr, dirty_fr[4096], mask_fr)),
    "K18 all dirty": (k18, (h_fr, dirty_fr[P * n_fr], mask_fr)),
    "K18 none live": (k18, (h_fr, dirty_fr[P * n_fr], off_fr)),
    "K19 rows": (k19_rows, (h_wl, sidx, mask_wl, None)),
    "K19 rows guard 32 dirty": (k19_rows, (h_fr, idx_fr, mask_fr,
                                           dirty_fr[32])),
    "K19 ranges guard halo": (k19_ranges, (h_wl,))}
cases = {key: v for key, v in cases.items() if key.startswith(only)}
for k in libs:
    for key, (mk, a) in cases.items():
        amax.zero_()  # the earlier checkouts' K14 takes zeroed words
        sums.zero_()  # K19 adds to zeroed words
        if mk is k18:
            want = fresh.dirty_exchange_plain(a[0], halo_fr.clone(), a[1],
                                              idx_fr, a[2])
        mk(k, *a)()
        torch.cuda.synchronize()
        if mk is k10:
            pairs = [(a[1], bs.transport_cast_plain(a[0], a[3], a[2])[0])]
        elif mk is k14:
            pairs = [(amax, halo.halo_amax_plain(*a, n_out))]
        elif mk is k18:
            pairs = [(halo_fr, want)]
        elif mk is k19_rows:
            pairs = [(sums.view(-1)[:P * (P - 1)].view(P, P - 1),
                      dg.row_sums_plain(*a))]
        elif mk is k19_ranges:
            pairs = [(sums, dg.part_digests_plain(a[0]))]
        else:
            wa, w, inv, out = wires[(a[3], a[1] is None)]
            want = halo.halo_wire_plain(*a[:3], n_out, a[3], wa)
            pairs = [(out, want[0]), (w, want[1])] + (
                [(inv, want[2])] if want[2] is not None else [])
        if not all(torch.equal(g.view(torch.uint8), r.view(torch.uint8))
                   for g, r in pairs):
            sys.exit(f"{k} {key}: not bit-exact against the plain version")


def hot(fn, calls=20):
    for _ in range(3):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def cold(fn, calls=10):
    ts = []
    for _ in range(calls):
        evict.fill_(1)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def device(fn, calls=20, pad=0.05, tries=3):
    """The card's kernel time a call as torch.profiler (CUPTI) reads it
    over ``calls`` calls of one launch each: the mean over the launches it
    saw, the window held open ``pad`` seconds before the first call and
    after the last (four times more in each further session, while it saw
    fewer than ``calls``; ``profiler_window.py`` shows a window closed at
    the last kernel losing them as the process ages). Exits when no
    session saw any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad * 4 ** t)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad * 4 ** t)
        us = [e.device_time for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if len(us) > len(best):
            best = us
        if len(best) >= calls:
            break
    if not best:
        sys.exit(f"the profiler saw no kernel in {tries} sessions")
    return sum(best) / len(best) / 1e3


# the profiler's reading for the small kernels, whose back-to-back calls
# the host's ctypes calls may not keep ahead of
profiled = ("K18", "K19")
runs = {k: {key: {"hot": [], "cold": [], "device": []} for key in cases}
        for k in libs}
order = list(libs)
for r in range(rounds):
    for k in (order if r % 2 == 0 else order[::-1]):
        for key, (mk, a) in cases.items():
            fn = mk(k, *a)
            runs[k][key]["hot"].append(hot(fn))
            runs[k][key]["cold"].append(cold(fn))
            if key.startswith(profiled):
                runs[k][key]["device"].append(device(fn))
print(json.dumps({
    "card": torch.cuda.get_device_name(0), "rounds": rounds,
    "ms": {k: {key: {m: [statistics.median(v), min(v), max(v)]
                     for m, v in d.items() if v} for key, d in r.items()}
           for k, r in runs.items()}}))
