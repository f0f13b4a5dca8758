"""Time K10 (the transport cast), K14 (the halo wire's per-block amax) and
K15 (the halo wire) of several checkouts side by side in one process, on
the card:

    python3 pipegcn_tpu_torch/tools/time_transport_ab.py \\
        parent=<checkout> change=<checkout> [<label>=<checkout> ...] \\
        [--rounds 12]

Each checkout builds its own ``transport_cast`` and ``halo_wire``
libraries (one process each, all together); this process loads them all
with ``ctypes`` and calls their C entry points on the same tensors, in
interleaved rounds (the checkouts in order, then reversed). Separate
processes, as ``time_tile_products.py`` runs them, place their tensors
anew each time, and K14's 73.5 MB of rows against the 50 MB L2 then read
up to 40 % apart from one process to the next; side by side most keys'
rounds stay within 1 % of each other. Shapes: ``time_tile_products.py``'s K10 and K14 keys
(K10: the bucket cell's activations [2, 143,584, 256] f32 and bf16 to
e4m3, its cotangents [2, 71,792, 256] f32 / a random in-degree to e5m2;
K14: the exchange of 71,792 permuted bf16 rows a part, the return of the
strided halo view of a [2, 143,584, 256] bf16 cotangent; K15: the same
exchange on the e4m3 and bf16 wires, the same return on the e5m2 and
bf16 wires, the fp8 wires with their blocks' amax). Each kernel's output
is first held to this checkout's plain versions, bit for bit.

Prints one JSON line: per label and key the median ms of 20 calls back
to back ("hot": the rows partly in L2 from the call before) and of one
call after a 160 MB write ("cold"), with each's lowest and highest
round."""
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from pipegcn_tpu_torch.ops import bucket_spmm as bs  # noqa: E402
from pipegcn_tpu_torch.parallel import halo  # noqa: E402

args = [a for a in sys.argv[1:] if "=" in a]
rounds = (int(sys.argv[sys.argv.index("--rounds") + 1])
          if "--rounds" in sys.argv else 12)
checkouts = dict(a.split("=", 1) for a in args)
# each checkout's libraries and whether its entries take the vector
# width (the checkouts before it took none)
probe = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from pipegcn_tpu_torch.ops import _build, bucket_spmm; "
         "_build.build(['transport_cast', 'halo_wire']); "
         "print(json.dumps({n: str(_build._lib_path(n)) for n in "
         "('transport_cast', 'halo_wire')} | "
         "{'vec': hasattr(bucket_spmm, 'k10_vec')}))")
procs = {k: subprocess.Popen([sys.executable, "-c", probe, v],
                             stdout=subprocess.PIPE, text=True)
         for k, v in checkouts.items()}
P_, I_, LL_, F_ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
libs = {}
for k, p in procs.items():
    out, _ = p.communicate()
    if p.returncode:
        sys.exit(f"{k}: the build failed")
    info = json.loads(out.strip().splitlines()[-1])
    vec = [I_] if info["vec"] else []
    amax = ctypes.CDLL(info["halo_wire"]).pgt_halo_amax
    amax.argtypes = [P_, I_, LL_, I_, I_, I_, I_, P_, P_, P_] + vec + [P_]
    cast = ctypes.CDLL(info["transport_cast"]).pgt_transport_cast
    cast.argtypes = [P_, I_, I_, I_, I_, P_, P_, I_, F_, P_, P_] + vec + [P_]
    wire = ctypes.CDLL(info["halo_wire"]).pgt_halo_wire
    wire.argtypes = [P_, I_, LL_, I_, I_, I_, I_, P_, P_, P_, I_, F_, P_, P_,
                     P_, I_, P_]
    libs[k] = (amax, cast, info["vec"], wire)

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
    fn, _, vec, _ = libs[k]
    extra = (halo.k14_vec(x),) if vec else ()
    return lambda: fn(x.data_ptr(), 1, x.stride(0), P, x.shape[1], F, n_out,
                      None if si is None else si.data_ptr(),
                      None if sm is None else sm.data_ptr(),
                      amax.data_ptr(), *extra, st)


def k10(k, x, y, d, dt):
    _, fn, vec, _ = libs[k]
    extra = (bs.k10_vec(x, y, d),) if vec else ()
    return lambda: fn(x.data_ptr(), int(x.dtype == torch.bfloat16), P,
                      x.shape[1], F, None if d is None else d.data_ptr(),
                      None, bs._OUT_TYPES[dt], bs.F8_MAX[dt], y.data_ptr(),
                      None, *extra, st)


wires = {}  # per (wire type, path): its blocks' amax, wire, inv, out


def k15(k, x, si, sm, dt):
    fn = libs[k][3]
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
    "K15 return bf16": (k15, (g16, None, None, torch.bfloat16))}
for k in libs:
    for key, (mk, a) in cases.items():
        amax.zero_()  # the earlier checkouts' K14 takes zeroed words
        mk(k, *a)()
        torch.cuda.synchronize()
        if mk is k10:
            pairs = [(a[1], bs.transport_cast_plain(a[0], a[3], a[2])[0])]
        elif mk is k14:
            pairs = [(amax, halo.halo_amax_plain(*a, n_out))]
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


runs = {k: {key: {"hot": [], "cold": []} for key in cases} for k in libs}
order = list(libs)
for r in range(rounds):
    for k in (order if r % 2 == 0 else order[::-1]):
        for key, (mk, a) in cases.items():
            fn = mk(k, *a)
            runs[k][key]["hot"].append(hot(fn))
            runs[k][key]["cold"].append(cold(fn))
print(json.dumps({
    "card": torch.cuda.get_device_name(0), "rounds": rounds,
    "ms": {k: {key: {m: [statistics.median(v), min(v), max(v)]
                     for m, v in d.items()} for key, d in r.items()}
           for k, r in runs.items()}}))
