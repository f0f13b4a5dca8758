"""The port's compressed halo wire (``--halo-dtype``; plain path, CPU)
against the JAX package: ``exchange_blocks`` / ``return_blocks`` with each
wire under shard_map on the CPU mesh (P = 2, 3, 4, f32 and bf16 compute),
the four JAX trainer tests of the wire (tests/test_floor_levers.py) on the
port's trainer, and the port's emulated trainer against JAX's at
``halo_dtype="float8"``.

Tolerances. The bf16 wire is a cast: bit-exact (a NaN equal to any NaN:
the frameworks write different NaN patterns). The fp8 wire scales each
(sender, distance) block by a power of two from its amax: bit-exact where
XLA-CPU's ``exp2`` forms that power exactly (|k| <= 12, the inputs below);
where it does not (a boundary gradient's small amax against e5m2), the
port's scale is the exact power and the test hands it JAX's scale (ROADMAP
C), as test_torch_bucket.py does for the gather transport. The trainers
run on JAX's wire values and relu masks (tapped with
``jax.debug.callback``), the flips counted, at test_torch_train.py's
tolerances: losses 1e-4, carries 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import pipegcn_tpu.ops.bucket_spmm as jbs
import pipegcn_tpu.parallel.halo as jhalo
from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.models.sage import ModelConfig as JaxModelConfig
from pipegcn_tpu.parallel.trainer import TrainConfig as JaxTrainConfig
from pipegcn_tpu.parallel.trainer import Trainer as JaxTrainer
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu_torch.models import ModelConfig, first_copy, params_from_jax
from pipegcn_tpu_torch.ops import bucket_spmm as pbs
from pipegcn_tpu_torch.ops.bucket_spmm import (F8_MAX, TransportShare,
                                               quantize)
from pipegcn_tpu_torch.parallel import halo as phalo
from pipegcn_tpu_torch.parallel.trainer import TrainConfig, Trainer
from test_torch_bucket import to_torch
from test_torch_train import (CPU, MODES, SIZES, one_torch_thread,
                              port_sharded, sharded)
from test_torch_train_bucket_transport import FLIP_FRAC, JaxTap

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

BF16 = torch.bfloat16
WIRES = {"bfloat16": (BF16, BF16),
         "float8": (torch.float8_e4m3fn, torch.float8_e5m2)}
JAX_WIRES = {"bfloat16": (jnp.bfloat16, jnp.bfloat16),
             "float8": (jnp.float8_e4m3fn, jnp.float8_e5m2)}


def _jax_wire(P, exchange, dt):
    """JAX's exchange_blocks (or return_blocks) with wire ``dt`` on P CPU
    devices over stacked inputs, jitted once per case."""
    mesh = Mesh(np.array(jax.devices()[:P]), ("parts",))
    spec = PartitionSpec("parts")
    if exchange:
        def body(h, idx, mask):
            return jhalo.exchange_blocks(h[0], idx[0], mask[0], "parts", P,
                                         transport_dt=dt)[None]
        n_in = 3
    else:
        def body(g):
            return jhalo.return_blocks(g[0], "parts", P, g.shape[1] // (P - 1),
                                       transport_dt=dt)[None]
        n_in = 1
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * n_in,
                                 out_specs=spec))


def _same(got: torch.Tensor, want: np.ndarray) -> None:
    """Bit-exact, a NaN equal to any NaN."""
    w = to_torch(np.asarray(want))
    assert got.dtype == w.dtype and got.shape == w.shape
    gb = got.view(torch.int16 if got.element_size() == 2 else torch.int32)
    wb = w.view(gb.dtype)
    nan = torch.isnan(got.float()) & torch.isnan(w.float())
    assert bool(((gb == wb) | nan).all()), int((~((gb == wb) | nan)).sum())


def _wire_case(P, seed, cdt):
    """Send lists with clipped indices and masked slots over rows whose
    blocks differ in scale by sender and distance (a per-part scale would
    not do), one NaN, a -0.0 and an all-masked block; boundary gradients
    at ~50 (k <= 12 against e5m2's 28672). In ``cdt``."""
    n, B, F = 24, 9, 6
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((P, n, F)).astype(np.float32)
    h *= (2.0 ** np.arange(P))[:, None, None]
    idx = rng.integers(-2, n + 2, (P, P - 1, B)).astype(np.int32)
    mask = rng.random((P, P - 1, B)) < 0.75
    # each distance reads its own rows, scaled apart
    for d in range(P - 1):
        rows = np.clip(idx[:, d], 0, n - 1)
        for s in range(P):
            h[s, rows[s]] *= 4.0 ** d
    h[0, 3, 1] = -0.0
    mask[P - 1, P - 2] = False  # an all-masked block: exact zeros
    g = (50.0 * rng.standard_normal((P, (P - 1) * B, F))).astype(np.float32)
    g[P - 1, 2, 3] = np.nan
    if cdt == "bfloat16":
        h = np.asarray(jnp.asarray(h, jnp.bfloat16))
        g = np.asarray(jnp.asarray(g, jnp.bfloat16))
    return h, idx, mask, g, B


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["bfloat16", "float8"])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_wire_matches_jax(P, wire, cdt):
    """exchange_blocks with the feature wire and return_blocks with the
    boundary-gradient wire, bit-exact against JAX's under shard_map."""
    h, idx, mask, g, B = _wire_case(P, seed=10 + P, cdt=cdt)
    fdt, bdt = WIRES[wire]
    jf, jb = JAX_WIRES[wire]
    want_x = _jax_wire(P, True, jf)(h, idx, mask)
    want_r = _jax_wire(P, False, jb)(g)
    ht, gt = to_torch(h), to_torch(g)
    got_x = phalo.exchange_blocks(ht, torch.from_numpy(idx),
                                  torch.from_numpy(mask), fdt)
    got_r = phalo.return_blocks(gt, B, bdt)
    _same(got_x, want_x)
    _same(got_r, want_r)
    # the all-masked block lands at receiver (P-1 + P-1) mod P, slot P-2
    r = (P - 1 + P - 1) % P
    assert bool((got_x[r, (P - 2) * B:(P - 1) * B].float() == 0).all())
    # the wire changes the values (the test sees it on or off)
    plain_x = phalo.exchange_blocks(ht, torch.from_numpy(idx),
                                    torch.from_numpy(mask))
    if not (wire == "bfloat16" and cdt == "bfloat16"):
        assert not torch.equal(plain_x, got_x)
    else:  # bf16 rows cross a bf16 wire unchanged
        assert torch.equal(plain_x, got_x)


def test_wire_plain_steps_and_scales():
    """The plain wire's pieces on P = 4: the amax of each (sender,
    distance) block (masked rows as 0), the per-block scales (they differ
    by distance), the payload at the receiver's slot, the sender's
    inverse scale beside it, the decode; the kernel wrappers take the
    plain path on CPU tensors."""
    P = 4
    h, idx, mask, g, B = _wire_case(P, seed=3, cdt="float32")
    ht, it, mt = (torch.from_numpy(a) for a in (h, idx, mask))
    amax = phalo.halo_amax(ht, it, mt, B)
    blk = phalo._sender_blocks(ht, it, mt, B)
    np.testing.assert_array_equal(amax.numpy(),
                                  blk.abs().amax(dim=(2, 3)).numpy())
    assert float(amax[P - 1, P - 2]) == 0.0  # the all-masked block
    out, wire, inv = phalo.halo_wire(ht, it, mt, B, torch.float8_e4m3fn,
                                     amax)
    assert wire.shape == (P, P - 1, B, h.shape[2])
    assert wire.dtype == torch.float8_e4m3fn and inv.shape == (P, P - 1)
    # a sender's blocks take different scales at different distances
    sc = pbs.pow2_scale(amax, 448.0)
    assert bool((sc != sc[:, :1]).any())
    for r in range(P):
        for d in range(1, P):
            s = (r - d) % P
            ref = jbs.amax_transport_cast(
                jnp.asarray(blk[s, d - 1].numpy()), jnp.float8_e4m3fn)[1]
            assert float(inv[r, d - 1]) == float(ref)
            y = quantize(blk[s, d - 1][None], torch.float8_e4m3fn, None,
                         1.0 / inv[r, d - 1:d])[0]
            assert torch.equal(wire[r, d - 1].view(torch.uint8),
                               y.view(torch.uint8))
    rows = out.view(P, P - 1, B, -1)
    assert torch.equal(rows, (wire.float() * inv[..., None, None]))
    # a bf16 wire takes no amax; an fp8 wire needs one
    with pytest.raises(ValueError, match="amax"):
        phalo.halo_wire(ht, it, mt, B, torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="amax"):
        phalo.halo_wire(ht, it, mt, B, BF16, amax)


def test_scale_is_shared_where_xla_exp2_is_not():
    """Boundary gradients ~1e-6 against e5m2: k ~ 33, where XLA-CPU's exp2
    rounds off the power of two (ROADMAP C). The port's scale is the
    exact power; handed JAX's payload and scale (``TransportShare``), its
    return path decodes to JAX's rows bit for bit, and its own cast at
    JAX's scale gives JAX's payload (no flip)."""
    P, B, F = 3, 5, 4
    rng = np.random.default_rng(8)
    g = (1e-6 * rng.standard_normal((P, (P - 1) * B, F))).astype(np.float32)
    want = _jax_wire(P, False, jnp.float8_e5m2)(g)
    blocks = g.reshape(P * (P - 1), B, F)
    rec = [jbs.amax_transport_cast(jnp.asarray(b), jnp.float8_e5m2)
           for b in blocks]
    ys = torch.stack([to_torch(np.asarray(y)) for y, _ in rec])
    invs = torch.tensor([float(i) for _, i in rec])
    own = phalo.halo_amax_plain(torch.from_numpy(g), None, None, B)
    own_inv = phalo.halo_wire_plain(torch.from_numpy(g), None, None, B,
                                    torch.float8_e5m2, own)[2]
    assert bool((own_inv < 2.0 ** -12).all())  # k > 12 in every block
    assert bool((torch.log2(own_inv) == torch.round(torch.log2(own_inv)))
                .all())  # the port's: exact powers of two
    assert not torch.equal(own_inv.reshape(-1).sort()[0], invs.sort()[0])
    share = TransportShare.replaying([(ys, invs)])
    got = phalo.return_blocks(torch.from_numpy(g), B, torch.float8_e5m2,
                              share)
    _same(got, want)
    assert share.flips == 0 and share.elements == g.size


def test_kernel_and_plain_ops_swap_as_a_unit():
    """HaloOps carries the wire pair: KERNELS' wrappers run the plain
    versions on CPU tensors, so both give the same halo; a recording
    share holds the payload in sender order, and replaying it gives the
    same rows."""
    P = 3
    h, idx, mask, g, B = _wire_case(P, seed=5, cdt="float32")
    ht, it, mt = (torch.from_numpy(a) for a in (h, idx, mask))
    rec = TransportShare()
    a = phalo.exchange_blocks(ht, it, mt, torch.float8_e4m3fn,
                              ops=phalo.KERNELS, share=rec)
    b = phalo.exchange_blocks(ht, it, mt, torch.float8_e4m3fn,
                              ops=phalo.PLAIN)
    assert torch.equal(a, b)
    (y, inv), = rec.recorded
    assert y.shape == (P * (P - 1), B, h.shape[2]) and inv.shape == (
        P * (P - 1),)
    blk = phalo._sender_blocks(ht, it, mt, B).reshape(-1, B, h.shape[2])
    assert torch.equal(y.view(torch.uint8), quantize(
        blk, torch.float8_e4m3fn, None, 1.0 / inv).view(torch.uint8))
    rep = TransportShare.replaying(rec.recorded)
    c = phalo.exchange_blocks(ht, it, mt, torch.float8_e4m3fn,
                              ops=phalo.PLAIN, share=rep)
    assert torch.equal(a, c) and rep.flips == 0
    # one part: no halo, no wire
    one = phalo.exchange_blocks(ht[:1], it[:1, :0], mt[:1, :0],
                                torch.float8_e4m3fn)
    assert one.shape == (1, 0, h.shape[2])


# ---------------------------------------------------------------------------
# the four JAX trainer tests of the wire (tests/test_floor_levers.py:95-148)

_LEVER = {}


def lever_sharded():
    if "sg" not in _LEVER:
        g = synthetic_graph(num_nodes=400, avg_degree=8, n_feat=12,
                            n_class=4, seed=11)
        parts = partition_graph(g, 4, seed=0)
        _LEVER["sg"] = port_sharded(ShardedGraph.build(g, parts, n_parts=4))
    return _LEVER["sg"]


def _mk(sg, **tkw):
    cfg = ModelConfig(layer_sizes=(sg.n_feat, 16, sg.n_class), norm="layer",
                      dropout=0.0, use_pp=False,
                      train_size=sg.n_train_global)
    return Trainer(sg, cfg, TrainConfig(**tkw), CPU)


@pytest.mark.parametrize("halo_dtype", ["bfloat16", "float8"])
def test_compressed_halo_keeps_staleness_semantics(halo_dtype):
    """Epoch 0 consumes zero buffers (the uncompressed pipelined run's
    loss), and with frozen params the warm epochs reproduce the vanilla
    loss to wire precision, through the stale concat and the boundary-
    gradient return."""
    sg = lever_sharded()
    tu = _mk(sg, seed=3, lr=0.0, enable_pipeline=True)
    lu = [tu.train_epoch(e) for e in range(4)]
    tc = _mk(sg, seed=3, lr=0.0, enable_pipeline=True,
             halo_dtype=halo_dtype)
    lc = [tc.train_epoch(e) for e in range(4)]
    np.testing.assert_allclose(lc[0], lu[0], rtol=1e-6)
    lv = float(_mk(sg, seed=3, lr=0.0).train_epoch(0))
    np.testing.assert_allclose(lc[2], lv, rtol=1e-3)
    np.testing.assert_allclose(lc[3], lv, rtol=1e-3)


@pytest.mark.parametrize("halo_dtype", ["bfloat16", "float8"])
def test_compressed_halo_training_tracks_f32_wire(halo_dtype):
    """Live training (boundary gradients cross the wire every epoch)
    tracks the f32-wire run."""
    sg = lever_sharded()
    t0 = _mk(sg, seed=3, enable_pipeline=True)
    tc = _mk(sg, seed=3, enable_pipeline=True, halo_dtype=halo_dtype)
    l0 = np.asarray([t0.train_epoch(e) for e in range(10)])
    lc = np.asarray([tc.train_epoch(e) for e in range(10)])
    assert np.isfinite(lc).all()
    np.testing.assert_allclose(lc, l0, rtol=0.02, atol=0.01)
    assert lc[-1] < lc[0] * 0.5


def test_halo_dtype_requires_pipeline():
    """The vanilla exchange is differentiated and must stay exact:
    compression without enable_pipeline is a config error."""
    with pytest.raises(ValueError, match="enable_pipeline"):
        _mk(lever_sharded(), seed=3, halo_dtype="bfloat16").train_epoch(0)
    with pytest.raises(ValueError, match="halo_dtype"):
        TrainConfig(halo_dtype="int8")


def test_compressed_halo_reports_reduced_wire_bytes():
    """est_halo_bytes_per_epoch reflects the wire dtype; the uncompressed
    estimate stays available; at bf16 compute a bf16 wire saves nothing."""
    sg = lever_sharded()
    t8 = _mk(sg, seed=3, enable_pipeline=True, halo_dtype="float8")
    comp = t8.est_halo_bytes_per_epoch()
    unc = t8.est_halo_bytes_per_epoch(compressed=False)
    assert comp * 4 == unc
    t0 = _mk(sg, seed=3, enable_pipeline=True)
    assert t0.est_halo_bytes_per_epoch() == unc
    # 2 directions x P parts x H rows x (12 + 16: the two exchanged
    # layers' input widths, no use_pp) x 4 B
    assert unc == 2 * 4 * sg.halo_size * (12 + 16) * 4


# ---------------------------------------------------------------------------
# the emulated trainer against JAX's at halo_dtype="float8"


class WireTap(JaxTap):
    """JaxTap plus the JAX wire's casts (``_permute_compressed``'s
    ``amax_transport_cast``, one record a sender block), into the same
    pool: the port's shares pick each record by its input."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        wire0 = jhalo.amax_transport_cast

        def wire_cast(x, dt):
            if dt == jnp.bfloat16:  # a plain cast, as transport_cast's
                y = x.astype(dt)
                jax.debug.callback(self._keep, x, y, jnp.float32(np.nan))
                return y, None
            y, inv = wire0(x, dt)
            jax.debug.callback(self._keep, x, y, inv)
            return y, inv

        monkeypatch.setattr(jhalo, "amax_transport_cast", wire_cast)


def tap_pair(monkeypatch, P, mode, halo_dtype, sg=None, tap_cls=WireTap,
             **model_kw):
    """A JAX emulated trainer and the port's from its params, the JAX
    step's wire casts, transport casts and relus tapped (``tap_cls``); the
    port's relu takes JAX's masks. Returns ``(tap, jax trainer, port
    trainer, the initial params)``."""
    sg = sharded(P) if sg is None else sg
    kw = dict(layer_sizes=SIZES, use_pp=True, norm="layer", dropout=0.0,
              train_size=sg.n_train_global, **model_kw)
    tap = tap_cls(monkeypatch)
    jt = JaxTrainer(sg, JaxModelConfig(**kw), JaxTrainConfig(
        seed=1, emulate_parts=True, halo_dtype=halo_dtype, **MODES[mode]))
    params = first_copy(jax.device_get(jt.state["params"]))
    pt = Trainer(port_sharded(sg), ModelConfig(**kw), TrainConfig(
        seed=1, halo_dtype=halo_dtype, **MODES[mode]), CPU,
        params=params_from_jax(params, CPU))
    pt.act = tap.act
    return tap, jt, pt, params


@pytest.mark.parametrize("P,mode", [(2, "pipelined"), (4, "corr")])
def test_wire_trainer_matches_jax(monkeypatch, P, mode):
    """4 epochs at dropout 0 on JAX's wire values and relu masks: losses
    within 1e-4, every carry within 1e-5 after every epoch; the flips of
    the port's own casts and relus counted."""
    tap, jt, pt, params = tap_pair(monkeypatch, P, mode, "float8")
    shares = []
    for e in range(4):
        jl = jt.train_epoch(e)
        jax.effects_barrier()
        pt.share = TransportShare(source=tap.source)
        shares.append(pt.share)
        pl = pt.train_epoch(e)
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
        js, ps = jax.device_get(jt.state), pt.host_state()
        for grp in js["comm"]:
            for k, want in js["comm"][grp].items():
                np.testing.assert_allclose(ps["comm"][grp][k], want,
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{grp}[{k}] epoch {e}")
    flips = sum(s.flips for s in shares)
    elements = sum(s.elements for s in shares)
    # the exchange and the return of 2 layers, every part, every epoch
    assert elements == 4 * 2 * 2 * P * pt.data.halo_size * 16
    assert not tap.records and not tap.relus  # every record used
    assert flips <= FLIP_FRAC * elements, (flips, elements)
    assert tap.relu_flips <= FLIP_FRAC * tap.relu_elements
    # the wire changes the carries: the test sees it on or off
    runs = [Trainer(port_sharded(sharded(P)), pt.cfg, TrainConfig(
        seed=1, halo_dtype=hd, **MODES[mode]), CPU,
        params=params_from_jax(params, CPU)) for hd in ("none", "float8")]
    for t in runs:
        t.train_epoch(0)
    assert not torch.equal(runs[0].comm["halo"]["1"],
                           runs[1].comm["halo"]["1"])


# ---------------------------------------------------------------------------
# K15's design (csrc/halo_wire.cu wire_kernel), emulated


# K15's geometry (csrc/halo_wire.cu): kWireWarps warps a block, each
# kWireRows rows of one slot block, a block a chunk of rows
K15_WARPS, K15_ROWS = 8, 4


def _k15_emulated(x, send_idx, send_mask, b_max, dt, amax):
    """K15's split: the vector ``phalo.k15_vec`` picks; for every slot
    block (receiver r, distance d; sender s), each block's chunk of
    ``K15_WARPS * K15_ROWS`` rows, each warp's rows, each lane's vectors
    (lane, lane + 32, ...): the offsets in x's storage that the vector's
    elements are read from (the sender row's, -1 for a masked row) and the
    receiver slot's offsets they are written to. Then the elements so read
    are encoded as the plain cast does (the sender block's scale) and
    decoded. Returns ``(halo, wire, inv, writes)``, writes the count of
    stores of each element."""
    P, n, F = x.shape
    B = b_max
    wire = torch.empty((P, P - 1, B, F), dtype=dt)
    out = torch.empty((P, (P - 1) * B, F), dtype=x.dtype)
    vec = phalo.k15_vec(x, wire, out)
    assert F % vec == 0 and x.stride(0) % vec == 0
    assert (x.data_ptr() // x.element_size()) % vec == 0
    flat = x.as_strided(((P - 1) * x.stride(0) + n * F,), (1,),
                        x.storage_offset())
    src = np.full(out.numel(), -2, np.int64)
    writes = np.zeros(out.numel(), np.int64)
    nvec, chunk = F // vec, K15_WARPS * K15_ROWS
    lanes = [(np.arange(lane, nvec, 32)[:, None] * vec
              + np.arange(vec)).ravel() for lane in range(32)]
    senders = {}
    for r in range(P):
        for d1 in range(P - 1):
            s = (r - d1 - 1) % P if send_idx is not None else (r + d1 + 1) % P
            slot = r * (P - 1) + d1
            senders[slot] = (s, d1)
            for c0 in range(0, B, chunk):
                for w0 in range(c0, min(B, c0 + chunk), K15_ROWS):
                    for b in range(w0, min(B, w0 + K15_ROWS)):
                        row = s * x.stride(0) + (d1 * B + b) * F
                        if send_idx is not None:
                            row = -1
                            if send_mask[s, d1, b]:
                                i = min(max(int(send_idx[s, d1, b]), 0),
                                        n - 1)
                                row = s * x.stride(0) + i * F
                        for el in lanes:
                            o = (slot * B + b) * F + el
                            src[o] = row + el if row >= 0 else -1
                            writes[o] += 1
    got = torch.from_numpy(src)
    vals = torch.where(got >= 0, flat[got.clamp(min=0)].float(),
                       torch.zeros(()))
    vals = vals.view(P * (P - 1), B, F)
    inv = None if amax is None else torch.empty((P, P - 1))
    wv, ov = wire.view(-1, B, F), out.view(-1, B, F)
    for slot, (s, d1) in senders.items():
        scale = (None if amax is None
                 else pbs.pow2_scale(amax[s, d1].view(1), F8_MAX[dt]))
        q = pbs.quantize(vals[slot:slot + 1], dt, None, scale)
        y = q.float() if scale is None else q.float() * (1.0 / scale[0])
        wv[slot], ov[slot] = q[0], y[0].to(x.dtype)
        if inv is not None:
            inv.view(-1)[slot] = 1.0 / scale[0]
    return out, wire, inv, torch.from_numpy(writes)


@pytest.mark.parametrize("F", [1, 3, 41, 48, 256, 602])
def test_k15_chunks_cover_every_element_once(F):
    """K15's split (the vector its wrapper picks, a block a chunk of rows,
    a warp's rows, a lane's vectors) writes every (row, column) of the
    payload and the decoded halo exactly once, and what it writes is
    ``halo_wire_plain``'s, bit for bit: f32 and bf16 rows, the exchange
    (P = 3, clipped and masked send rows) and the return, from aligned
    parts and from views whose part stride (and base) is odd, every
    wire."""
    P, n, B = 3, 40, 37  # B past one block's chunk of rows
    rng = np.random.default_rng(F)
    idx = torch.from_numpy(rng.integers(-2, n + 2, (P, P - 1, B)).astype(
        np.int32))
    mask = torch.from_numpy(rng.random((P, P - 1, B)) < 0.8)
    for rows in (torch.float32, torch.bfloat16):
        big = torch.from_numpy(rng.standard_normal(
            (P, n + 1, F)).astype(np.float32) * 3.0).to(rows)
        g = torch.from_numpy(rng.standard_normal(
            (P, 1 + (P - 1) * B, F)).astype(np.float32)).to(rows)
        cases = [(big[:, :n].contiguous(), idx, mask),
                 (big[:, 1:], idx, mask),  # part stride (n + 1) F
                 (g[:, 1:].contiguous(), None, None),
                 (g[:, 1:], None, None)]
        for x, si, sm in cases:
            for dt in (torch.float8_e4m3fn, torch.float8_e5m2, BF16):
                amax = (phalo.halo_amax(x, si, sm, B) if dt in F8_MAX
                        else None)
                got = _k15_emulated(x, si, sm, B, dt, amax)
                want = phalo.halo_wire_plain(x, si, sm, B, dt, amax)
                assert bool((got[3] == 1).all()), (rows, dt, x.stride())
                for a, b in zip(got[:3], want):
                    if b is not None:
                        assert torch.equal(a.view(torch.uint8),
                                           b.view(torch.uint8)), (
                            rows, dt, x.stride())
