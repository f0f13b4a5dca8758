"""The port's integrity plane (plain path, CPU) against the JAX package's
(``pipegcn_tpu/resilience/integrity.py``, its fault grammar, its trainer's
``fit`` drills and the serving wire guard), with the same numpy inputs.

  - K19's plain digests (flat, per part) equal JAX's ``host_digest`` and
    ``device_digest`` / ``shard_digests`` bit for bit in every dtype;
    ``wire_sum`` and ``flip_bit`` equal JAX's;
  - ``FaultPlan`` parses ``bitflip`` as JAX does and refuses other kinds;
  - the plane in isolation (tests/test_integrity.py's checks): the scrub
    names JAX's dirty part, the rebuild clears it, the params flip is
    caught, Freivalds passes on the xla, bucket and block paths and fails
    in both packages after the same ``edge_src`` flip;
  - the detection matrix through ``fit`` (cadence 2, ``bitflip@3``,
    dropout 0): under xla every class, the fault / integrity / recovery
    records equal JAX's in order and the losses within 1e-4 (JAX reads
    them from its epoch records); under bucket, tables and params;
  - the guarded pipelined epoch equals the unguarded one bit for bit with
    ``wire_bad`` 0 (the K2 path and the bf16 and fp8 wires); a corrupted
    copy counts its blocks and ``fit`` flushes the carry;
  - the serving guard: the halo equal to the full exchange and to JAX's
    guarded engine, a corrupted copy rebuilt;
  - the CLI drill prints the JAX CLI's ``integrity:`` lines.

The losses hold at 1e-4 (the trainers' tolerance, test_torch_train.py). A
``send_idx`` flip reaches K2's gather in the port and also the scatter of
JAX's backward, which the port runs over its own host-built inverse
(ROADMAP §C): the epochs between the flip and the rebuild differ by up to
7e-5 of the loss at this seed; every other drill agrees to ~3e-7."""

import io
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.models import ModelConfig as JaxModelConfig
from pipegcn_tpu.obs import MetricsLogger as JaxMetricsLogger
from pipegcn_tpu.parallel import Trainer as JaxTrainer
from pipegcn_tpu.parallel import TrainConfig as JaxTrainConfig
from pipegcn_tpu.parallel.halo import wire_sum as jax_wire_sum
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu.resilience import FaultPlan as JaxFaultPlan
from pipegcn_tpu.resilience import integrity as jint
from pipegcn_tpu_torch.models import ModelConfig, first_copy, params_from_jax
from pipegcn_tpu_torch.obs import MetricsLogger
from pipegcn_tpu_torch.ops import digest as pdig
from pipegcn_tpu_torch.parallel import halo as phalo
from pipegcn_tpu_torch.parallel.trainer import TrainConfig, Trainer
from pipegcn_tpu_torch.resilience import FaultPlan, IntegrityPlane
from pipegcn_tpu_torch.resilience import integrity as pint
from test_torch_bucket import csrc_constant
from test_torch_train import CPU, one_torch_thread, port_sharded

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

_BITS = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}
_TORCH_DT = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float16): torch.float16,
             np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
             np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
             np.dtype(ml_dtypes.bfloat16): torch.bfloat16,
             np.dtype(ml_dtypes.float8_e4m3fn): torch.float8_e4m3fn,
             np.dtype(ml_dtypes.float8_e5m2): torch.float8_e5m2}


def as_torch(a: np.ndarray) -> torch.Tensor:
    """Any numpy array (ml_dtypes included) as a torch tensor, bit for
    bit."""
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a.view(_BITS[a.dtype.itemsize]).copy())
    return t.view(_TORCH_DT[a.dtype])


def _arrays():
    rng = np.random.default_rng(7)
    f = rng.normal(size=97).astype(np.float32) * 3
    return {
        "f32": f,
        "i32": np.arange(-40, 40, dtype=np.int32).reshape(8, 10),
        "u8": np.arange(256, dtype=np.uint8),
        "bool": np.arange(30) % 3 == 0,
        "f16": np.linspace(-2, 2, 64).astype(np.float16),
        "bf16": f.astype(ml_dtypes.bfloat16),
        "e4m3": np.clip(f, -400, 400).astype(ml_dtypes.float8_e4m3fn),
        "e5m2": f.astype(ml_dtypes.float8_e5m2),
        "empty": np.zeros(0, np.float32),
        "one": np.asarray([-1.5], np.float32),
    }


# ---------------- digests ---------------------------------------------


@pytest.mark.parametrize("name", list(_arrays()))
def test_digests_equal_jax_bit_for_bit(name):
    """The flat digest equals JAX's host_digest and device_digest; the
    per-part form (a leading axis of 2 where the array splits) equals
    shard_digests, the weight index restarting in each part."""
    a = _arrays()[name]
    t = as_torch(a)
    want = jint.host_digest(a)
    assert np.array_equal(pdig.as_u32(pdig.digest(t)), want)
    assert np.array_equal(np.asarray(jint.device_digest(jnp.asarray(a))),
                          want)
    if a.size and a.size % 2 == 0:
        parts = a.reshape(2, -1)
        got = pdig.as_u32(pdig.part_digests(as_torch(parts)))
        assert np.array_equal(got, jint.shard_digests(jnp.asarray(parts)))
        assert np.array_equal(got[1], jint.host_digest(parts[1]))


def test_int64_digest_and_wrapping_weights():
    """8-byte dtypes enter as their two u32 halves (JAX x64 is off: held
    against host_digest); all-ones words wrap both sums."""
    a = np.random.default_rng(1).integers(-2 ** 62, 2 ** 62, size=33)
    assert np.array_equal(pdig.as_u32(pdig.digest(torch.from_numpy(a))),
                          jint.host_digest(a))
    ones = np.full(70_001, -1, np.int32)
    assert np.array_equal(pdig.as_u32(pdig.digest(torch.from_numpy(ones))),
                          jint.host_digest(ones))


def test_wire_sum_and_flip_bit_equal_jax():
    a = np.random.default_rng(1).normal(size=257).astype(np.float32)
    s = phalo.wire_sum(torch.from_numpy(a))
    assert int(pdig.as_u32(s)) == int(np.asarray(jax_wire_sum(
        jnp.asarray(a))))
    for arr in (a, np.arange(10, dtype=np.uint8),
                np.linspace(0, 1, 9).astype(ml_dtypes.bfloat16),
                np.arange(5, dtype=np.int64), np.arange(6) % 2 == 0):
        for bit, index in ((0, 0), (11, 3), (7, 40), (31, 2)):
            want = jint.flip_bit(arr, bit=bit, index=index)
            assert np.array_equal(
                pdig.flip_bit(arr, bit=bit, index=index).view(np.uint8),
                want.view(np.uint8))
            t = as_torch(arr)
            pdig.flip_bit_(t, bit=bit, index=index)
            assert torch.equal(t.view(torch.uint8),
                               as_torch(want).view(torch.uint8))


def test_row_sums_are_the_send_blocks_sums():
    """K19's rows form equals the sums of the blocks K2 sends (the
    exchange's received blocks, sender by sender), with clipped indices,
    masked rows and the dirty bits."""
    g = torch.Generator().manual_seed(0)
    P, n, F, B = 3, 10, 5, 6
    h = torch.randn(P, n, F, generator=g)
    idx = torch.randint(-3, n + 3, (P, P - 1, B), generator=g,
                        dtype=torch.int32)
    mask = torch.rand(P, P - 1, B, generator=g) > 0.3
    dirty = torch.rand(P, n, generator=g) > 0.5
    halo = phalo.exchange_blocks(h, idx, mask)
    for bits in (None, dirty):
        got = pdig.as_u32(pdig.row_sums(h, idx, mask, bits))
        for s in range(P):
            for d in range(1, P):
                rows = h[s][idx[s, d - 1].long().clamp(0, n - 1)]
                on = mask[s, d - 1] & (True if bits is None else
                                       bits[s][idx[s, d - 1].long().clamp(
                                           0, n - 1)])
                want = jint.host_digest(rows[on].numpy())[0]
                assert got[s, d - 1] == want
                if bits is None:  # the receiver's block of the exchange
                    r = (s + d) % P
                    blk = halo[r, (d - 1) * B:d * B].numpy()
                    assert want == jint.host_digest(blk)[0]


# K19's rows form (csrc/digest.cu rows_kernel), its split emulated

# blocks the card holds at once in the emulation of the rows form's one
# wave (cut so that at these sizes the warps stride)
WAVE = 4
ROWS = {"f32 F=1": (torch.float32, 1), "f32 F=41": (torch.float32, 41),
        "f32 F=602": (torch.float32, 602), "bf16 F=41": (torch.bfloat16, 41),
        "u8 F=1": (torch.uint8, 1)}


def _rows_emulated(h, idx, mask, dirty):
    """The rows form's split at the kernel's constants (``kRowsWarps``,
    ``kRowsRows``): per (sender, distance) block, one wave of ``WAVE``
    blocks spread over the P (P - 1) blocks, the warps striding over the
    block's slots 32 at a time, lane i slot i: the mask and index, the
    clip, the dirty bit where the mask is on; the live rows summed
    ``kRowsRows`` at a time, lanes over the row's vectors (the widest of
    16, 8, 4, 2 bytes, never under a word, that the pointer, part stride
    and row size allow); each vector's words zero-extended and added in u32. Returns ``(sums [P,
    P-1] u32, reads)``, reads the count of reads of each byte of each
    slot's row (``[P, P-1, B, row bytes]``)."""
    Wr = csrc_constant("digest.cu", "kRowsWarps")
    R = csrc_constant("digest.cu", "kRowsRows")
    P, n = h.shape[:2]
    B = idx.shape[2]
    es = h.element_size()
    W = 4 if es == 8 else es
    row_bytes = h[0, 0].numel() * es
    part_bytes = h.stride(0) * es
    a = h.data_ptr() | part_bytes | row_bytes
    NB = next((w for w in (16, 8, 4, 2) if w >= W and a % w == 0), W)
    nv = row_bytes // NB
    vs = np.concatenate([np.arange(lane, nv, 32) for lane in range(32)])
    offs = (vs[:, None] * NB + np.arange(NB)).ravel()
    span = (P - 1) * h.stride(0) + h[0].numel()
    hb = h.as_strided((span,), (1,), h.storage_offset()).contiguous()
    hb = hb.view(torch.uint8).numpy()  # the parts' bytes, from h[0, 0]
    words = {1: np.uint8, 2: np.uint16, 4: np.uint32}[W]
    m = mask.numpy()
    ix = idx.numpy()
    bits = None if dirty is None else dirty.numpy().astype(bool)
    sums = np.zeros((P, P - 1), np.uint32)
    reads = np.zeros((P, P - 1, B, row_bytes), np.int64)
    slots = P * (P - 1)
    grid = max(1, min(-(-WAVE // slots), -(-B // (Wr * 32))))
    for slot in range(slots):
        s, d1 = divmod(slot, P - 1)
        for blk in range(grid):
            for warp in range(Wr):
                for b0 in range((blk * Wr + warp) * 32, B, grid * Wr * 32):
                    b = b0 + np.arange(32)
                    b = b[b < B]
                    i = np.clip(ix[s, d1, b], 0, n - 1)
                    live = m[s, d1, b].astype(bool)
                    if bits is not None:
                        live[live] = bits[s, i[live]]
                    lanes = np.nonzero(live)[0]
                    groups = [lanes[g:g + R]
                              for g in range(0, lanes.size, R)]
                    for grp in groups:
                        for lane in grp:
                            row = s * part_bytes + int(i[lane]) * row_bytes
                            got = hb[row + offs]
                            reads[s, d1, b[lane], offs] += 1
                            w = np.ascontiguousarray(got).view(words)
                            with np.errstate(over="ignore"):
                                sums[s, d1] += np.add.reduce(
                                    w.astype(np.uint32), dtype=np.uint32)
    return sums, reads


@pytest.mark.parametrize("rows", list(ROWS))
@pytest.mark.parametrize("P", [2, 3, 4])
def test_rows_form_split_sums_every_live_row_once(P, rows):
    """The rows form's split reads every byte of every live row (mask on,
    and the owner row dirty where bits are given) exactly once and nothing
    else, and its sums are ``row_sums_plain``'s bits (held to JAX's
    ``wire_sum`` above): B not a multiple of 32, enough slots that the
    warps stride (F <= 41), clipped indices, masked-off slots at
    out-of-range indices, contiguous parts and parts one row apart; no
    bits, every slot masked off, no rows dirty, all rows dirty, random."""
    dt, F = ROWS[rows]
    n, B = 50, (37 if F == 602 else 1037)
    rng = np.random.default_rng(P * 1000 + F)
    idx = rng.integers(-3, n + 3, (P, P - 1, B)).astype(np.int32)
    mask = rng.random((P, P - 1, B)) < 0.8
    idx[:, :, -1] = n + 5        # out of range, masked off
    mask[:, :, -1] = False
    if dt == torch.uint8:
        big = torch.from_numpy(rng.integers(0, 256, (P, n + 1, F),
                                            dtype=np.uint8))
    else:
        big = torch.from_numpy(rng.standard_normal(
            (P, n + 1, F), dtype=np.float32) * 3.0).to(dt)
    ti = torch.from_numpy(idx)
    cases = {
        "no bits": (mask, None),
        "every slot masked off": (np.zeros_like(mask), np.ones((P, n), bool)),
        "no rows dirty": (mask, np.zeros((P, n), bool)),
        "all rows dirty": (mask, np.ones((P, n), bool)),
        "random": (mask, rng.random((P, n)) < 0.3),
    }
    for h in (big[:, :n].contiguous(), big[:, 1:]):  # part stride n, n + 1
        for name, (m, bits) in cases.items():
            tm = torch.from_numpy(m)
            tb = None if bits is None else torch.from_numpy(bits)
            got, reads = _rows_emulated(h, ti, tm, tb)
            live = m & (True if bits is None else
                        bits[np.arange(P)[:, None, None],
                             np.clip(idx, 0, n - 1)])
            what = (name, tuple(h.stride()))
            assert np.array_equal(reads, np.broadcast_to(
                live[..., None], reads.shape).astype(np.int64)), what
            want = pdig.as_u32(pdig.row_sums_plain(h, ti, tm, tb))
            assert np.array_equal(got, want), what
            assert live.any() == (name not in ("every slot masked off",
                                               "no rows dirty")), what


# ---------------- fault grammar ----------------------------------------


def _entries(plan):
    return [(e.kind, e.epoch, e.rank, e.sarg) for e in plan._entries]


def test_fault_plan_parses_bitflip_as_jax():
    for spec in ("bitflip@3:params", "bitflip@5:r1:tables,bitflip@2:halo",
                 "bitflip@0:carry"):
        assert _entries(FaultPlan.parse(spec)) == \
            _entries(JaxFaultPlan.parse(spec))
    for plan in (FaultPlan.parse("bitflip@3:params,bitflip@5:r1:tables"),
                 JaxFaultPlan.parse("bitflip@3:params,bitflip@5:r1:tables")):
        assert plan.due_str_arg("bitflip", 3) == "params"
        assert plan.due_str_arg("bitflip", 3) is None  # consumed
        assert plan.due_str_arg("bitflip", 5) is None  # rank 1's
    assert FaultPlan.parse("bitflip@5:r1:tables", rank=1).due_str_arg(
        "bitflip", 5) == "tables"
    for bad, match in (("bitflip@3", "target class"),
                       ("bitflip@3:meteor", "target class"),
                       ("sigterm@3:params", "word argument"),
                       ("bitflip@x:params", "bad fault-plan entry"),
                       ("meteor@3", "unknown fault kind")):
        for parse in (FaultPlan.parse, JaxFaultPlan.parse):
            with pytest.raises(ValueError, match=match):
                parse(bad)
    JaxFaultPlan.parse("nan-loss@5:r1,sigterm@8")
    with pytest.raises(NotImplementedError, match="nan-loss.*ROADMAP A9"):
        FaultPlan.parse("nan-loss@5:r1,sigterm@8")


def test_targets_and_codes_equal_jax():
    assert pint.TARGETS == jint.TARGETS
    assert pint.SDC_CODES == jint.SDC_CODES
    assert pint.SDC_NAMES == jint.SDC_NAMES
    assert pint.QUARANTINE_STRIKES == jint.QUARANTINE_STRIKES
    plane = IntegrityPlane(2)
    assert [plane.due(e) for e in range(5)] == \
        [jint.IntegrityPlane(2, log=print).due(e) for e in range(5)]
    plane.detections = {"params": 1, "halo": 1}
    assert plane.total_detections() == 2 and plane.should_quarantine()


# ---------------- the plane in isolation -------------------------------


_CACHE = {}


def sharded():
    if "sg" not in _CACHE:
        g = synthetic_graph(num_nodes=300, avg_degree=6, n_feat=8,
                            n_class=3, seed=1)
        _CACHE["sg"] = ShardedGraph.build(g, partition_graph(g, 2, seed=0),
                                          n_parts=2)
    return _CACHE["sg"]


def pair(impl="xla", sg=None, **tkw):
    """A JAX emulated trainer and the port's over the same graph and
    params (tests/test_integrity.py's ``_trainer``: 8 -> 16 -> 3)."""
    sg = sharded() if sg is None else sg
    kw = dict(layer_sizes=(sg.n_feat, 16, sg.n_class), dropout=0.0,
              train_size=sg.n_train_global, spmm_impl=impl)
    if impl == "block":
        kw.update(block_tile=32)
    tkw.setdefault("n_epochs", 8)
    tkw.setdefault("log_every", 50)
    jt = JaxTrainer(sg, JaxModelConfig(**kw),
                    JaxTrainConfig(emulate_parts=True, **tkw))
    params = first_copy(jax.device_get(jt.state["params"]))
    pt = Trainer(port_sharded(sg), ModelConfig(**kw), TrainConfig(**tkw),
                 CPU, params=params_from_jax(params, CPU))
    return jt, pt


def test_scrub_names_the_dirty_part_and_the_rebuild_clears_it():
    jt, pt = pair(n_epochs=2)
    ji, pi = jint.IntegrityPlane(1, log=print), IntegrityPlane(1)
    ji.baseline(jt)
    pi.baseline(pt)
    assert pi.scrub_static(pt).outcome == "ok"
    for t in (jt, pt):
        assert t._inject_bitflip("tables", 0, print)
    jr, pr = ji.scrub_static(jt), pi.scrub_static(pt)
    assert pr.outcome == jr.outcome == "mismatch"
    assert pr.target == "tables" and "send_idx" in pr.detail
    assert pr.dirty_shards == jr.dirty_shards == (0,)
    pt._rebuild_static_data(pr.dirty_shards)
    assert pi.scrub_static(pt).outcome == "ok"


def test_dynamic_digest_catches_the_params_flip():
    _, pt = pair(n_epochs=2)
    plane = IntegrityPlane(1)
    plane.note_dynamic(pt)
    assert all(r.outcome == "ok" for r in plane.verify_dynamic(pt))
    assert pt._inject_bitflip("params", 0, print)
    bad = [r for r in plane.verify_dynamic(pt) if r.outcome == "mismatch"]
    assert [r.target for r in bad] == ["params"]
    plane.drop_dynamic()
    assert plane.verify_dynamic(pt) == []


def _block_graph():
    if "block" not in _CACHE:
        from pipegcn_tpu_torch.partition.partitioner import \
            locality_clusters
        from test_torch_train import port_graph

        g = synthetic_graph(num_nodes=600, avg_degree=36, n_feat=12,
                            n_class=5, seed=3, label_noise=0.3)
        cluster = locality_clusters(port_graph(g), target_size=64)
        _CACHE["block"] = ShardedGraph.build(
            g, partition_graph(g, 2, method="random", seed=0), n_parts=2,
            cluster=cluster)
    return _CACHE["block"]


@pytest.mark.parametrize("impl", ["xla", "bucket", "block"])
def test_freivalds_passes_clean(impl):
    jt, pt = pair(impl, sg=_block_graph() if impl == "block" else None,
                  n_epochs=2)
    if impl == "block":
        assert min(pt.data.block_stats["blocks"]) > 0
    pt.train_epoch(0)
    jt.train_epoch(0)
    res = IntegrityPlane(1).freivalds(pt, 1)
    want = jint.IntegrityPlane(1, log=print).freivalds(jt, 1)
    assert want.outcome == "ok" and "residual" in want.detail
    assert res.check == "freivalds" and res.outcome == "ok", res.detail
    assert res.detail.startswith("residual")
    assert float(res.detail.split()[1]) < 1e-5


def test_freivalds_fails_in_both_after_an_edge_src_flip():
    """Freivalds checks the aggregation: the same flip of an edge_src
    element (under xla) is a mismatch in both packages."""
    jt, pt = pair(n_epochs=2)
    arr = jt.data["edge_src"]
    jt.data = dict(jt.data)
    jt.data["edge_src"] = jax.device_put(jnp.asarray(jint.flip_bit(
        jax.device_get(arr), bit=5, index=7)), arr.sharding)
    pt.data.edge_src = pdig.flip_bit_(pt.data.edge_src.clone(), bit=5,
                                      index=7)
    want = jint.IntegrityPlane(1, log=print).freivalds(jt, 1)
    got = IntegrityPlane(1).freivalds(pt, 1)
    assert want.outcome == got.outcome == "mismatch", (want, got)
    assert "projection residual" in got.detail


# ---------------- the detection matrix through fit ---------------------


def _records(buf):
    keys = ("event", "kind", "epoch", "check", "target", "outcome",
            "dirty_shards")
    return [{k: r.get(k) for k in keys} for r in map(
        json.loads, buf.getvalue().splitlines())
        if r["event"] in ("fault", "integrity", "recovery")]


@pytest.fixture(scope="module")
def families():
    """One JAX trainer and one port trainer per family (the JAX step
    compiles once): every drill of the family continues from the state
    the one before left, in both."""
    out = {impl: pair(impl, enable_pipeline=True, integrity_check_every=2,
                      n_epochs=8) for impl in ("xla", "bucket")}
    yield out


@pytest.mark.parametrize("impl,targets", [
    ("xla", ("params", "carry", "tables", "halo")),
    ("bucket", ("tables", "params"))])
def test_detection_matrix_matches_jax(families, impl, targets):
    jt, pt = families[impl]
    for target in targets:
        jb, pb = io.StringIO(), io.StringIO()
        jt.fit(eval_graphs=None, log_fn=lambda s: None,
               metrics=JaxMetricsLogger(jb),
               fault_plan=JaxFaultPlan.parse(f"bitflip@3:{target}"))
        lines = []
        res = pt.fit(None, log_fn=lines.append, metrics=MetricsLogger(pb),
                     fault_plan=FaultPlan.parse(f"bitflip@3:{target}"))
        want, got = _records(jb), _records(pb)
        assert got == want, (impl, target)
        injected = [r for r in got if r["event"] == "fault"
                    and r["kind"] == "injected"]
        hits = [r for r in got if r["event"] == "integrity"
                and r["outcome"] == "mismatch"]
        assert injected and injected[0]["epoch"] == 3
        assert hits and all(r["target"] == target and 3 <= r["epoch"] <= 5
                            for r in hits), (impl, target)
        assert [r for r in got if r["event"] == "recovery"]
        assert pt.last_epoch == jt.last_epoch == 8
        assert any(line.startswith("integrity: ") for line in lines)
        jl = [json.loads(line)["loss"] for line in jb.getvalue().splitlines()
              if json.loads(line)["event"] == "epoch"]
        assert len(res["losses"]) == len(jl)
        assert np.isfinite(res["losses"]).all()
        np.testing.assert_allclose(res["losses"], jl, rtol=1e-4,
                                   err_msg=f"{impl} {target}")


# ---------------- the wire lane -----------------------------------------


def _guarded_pair(halo_dtype="none", dtype="float32"):
    """The same pipelined epoch 2 on two port trainers from one state, one
    with the lane (P = 3: six distance blocks an exchange)."""
    g = synthetic_graph(num_nodes=300, avg_degree=6, n_feat=8, n_class=3,
                        seed=4)
    sg = port_sharded(ShardedGraph.build(
        g, partition_graph(g, 3, method="random", seed=0), n_parts=3))
    out = []
    for every in (0, 2):
        cfg = ModelConfig(layer_sizes=(8, 16, 16, 3), dropout=0.0,
                          train_size=sg.n_train_global, dtype=dtype)
        out.append(Trainer(sg, cfg, TrainConfig(
            enable_pipeline=True, halo_dtype=halo_dtype, n_epochs=3,
            integrity_check_every=every, log_every=50), CPU))
    return out


@pytest.mark.parametrize("halo_dtype,dtype", [
    ("none", "float32"), ("none", "bfloat16"), ("bfloat16", "float32"),
    ("float8", "float32")], ids=["k2-f32", "k2-bf16", "wire-bf16",
                                 "wire-fp8"])
def test_guarded_epoch_is_bit_identical(halo_dtype, dtype):
    plain, guarded = _guarded_pair(halo_dtype, dtype)
    for e in range(3):
        assert plain.train_epoch(e) == guarded.train_epoch(e)
        assert plain.wire_bad is None and int(guarded.wire_bad) == 0
    for a, b in zip(plain.host_state()["comm"]["halo"].values(),
                    guarded.host_state()["comm"]["halo"].values()):
        assert np.array_equal(a, b)
    for a, b in zip(plain._leaves, guarded._leaves):
        assert torch.equal(a, b)


def _corrupting(orig, blocks, calls):
    """A gather (K2's signature) whose first ``calls[0]`` calls flip one
    bit in each of ``blocks`` received blocks."""
    def gather(h, send_idx, send_mask, with_inner):
        out = orig(h, send_idx, send_mask, with_inner)
        if calls[0] > 0:
            calls[0] -= 1
            B = send_idx.shape[2]
            for r, d in blocks:
                pdig.flip_bit_(out[r, (d - 1) * B], bit=9, index=0)
        return out
    return gather


def test_corrupted_copy_is_counted_and_flushes_the_carry(monkeypatch):
    _, guarded = _guarded_pair()
    orig = phalo.KERNELS.gather
    guarded.train_epoch(0)
    monkeypatch.setattr(phalo.KERNELS, "gather",
                        _corrupting(orig, [(0, 1), (2, 2)], [1]))
    guarded.train_epoch(1)
    assert int(guarded.wire_bad) == 2
    # through fit: the JAX log line, the carry flushed after the epoch
    lines = []
    buf = io.StringIO()
    calls = [0]

    def train_epoch(epoch, _orig=guarded.train_epoch):
        calls[0] = 1 if epoch == 2 else 0
        return _orig(epoch)

    monkeypatch.setattr(phalo.KERNELS, "gather",
                        _corrupting(orig, [(1, 1)], calls))
    monkeypatch.setattr(guarded, "train_epoch", train_epoch)
    guarded.fit(None, log_fn=lines.append, metrics=MetricsLogger(buf))
    assert ("integrity: halo wire checksum mismatch in 1 distance "
            "block(s) at epoch 2; flushing carry") in lines
    rec = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [r["check"] for r in rec if r["event"] == "integrity"
            and r["outcome"] == "mismatch"] == ["wire"]
    assert all(not t.any() for grp in guarded.comm.values()
               for t in grp.values())


def _corrupting_wire(orig, target, blocks, calls):
    """A compressed wire (K15's signature) whose first ``calls[0]`` calls
    flip one bit at each of ``blocks`` receiver slots ``(r, d)``: in the
    decoded halo the receiver consumes, in the narrow payload, or in the
    inverse scale."""
    def wire_fn(x, send_idx, send_mask, b_max, dt, amax=None):
        out, wire, inv = orig(x, send_idx, send_mask, b_max, dt, amax)
        if calls[0] > 0:
            calls[0] -= 1
            for r, d in blocks:
                if target == "halo":
                    pdig.flip_bit_(out[r, (d - 1) * b_max], bit=9)
                elif target == "payload":
                    pdig.flip_bit_(wire[r, d - 1, 0], bit=5)
                else:
                    pdig.flip_bit_(inv[r, d - 1], bit=3)
        return out, wire, inv
    return wire_fn


@pytest.mark.parametrize("halo_dtype,target", [
    ("float8", "halo"), ("float8", "payload"), ("float8", "scale"),
    ("bfloat16", "halo"), ("bfloat16", "payload")])
def test_corrupted_wire_is_counted(monkeypatch, halo_dtype, target):
    """The compressed wire's lane (K15's path) counts each corrupted
    receiver slot: the decoded halo against an independent decode of the
    payload, the scale against its sender's."""
    _, guarded = _guarded_pair(halo_dtype)
    guarded.train_epoch(0)
    assert int(guarded.wire_bad) == 0
    monkeypatch.setattr(phalo.KERNELS, "wire", _corrupting_wire(
        phalo.KERNELS.wire, target, [(0, 1), (2, 2)], [1]))
    guarded.train_epoch(1)
    assert int(guarded.wire_bad) == 2


# ---------------- the serving guard -------------------------------------


def test_serving_guard_matches_jax_and_rebuilds_a_corrupt_copy(monkeypatch):
    from pipegcn_tpu.serve import ServingEngine as JaxEngine
    from pipegcn_tpu_torch.parallel.staging import stage
    from pipegcn_tpu_torch.serve import engine as pengine
    from pipegcn_tpu_torch.serve import freshness as pfresh

    sg = sharded()
    kw = dict(layer_sizes=(sg.n_feat, 16, sg.n_class), dropout=0.0,
              train_size=sg.n_train_global)
    # the JAX engine serves from a trainer on a device mesh (2 CPU devices)
    jt = JaxTrainer(sg, JaxModelConfig(**kw), JaxTrainConfig(
        enable_pipeline=True, integrity_check_every=1, n_epochs=2))
    jt.train_epoch(0)
    jeng = JaxEngine.for_trainer(jt)
    assert jeng._wire_guard
    tree = jax.tree_util.tree_map(np.asarray, jt.state["params"])
    eng = pengine.ServingEngine(
        port_sharded(sg), stage(port_sharded(sg), CPU), ModelConfig(**kw),
        params_from_jax(tree, CPU), integrity_check_every=1)
    rng = np.random.default_rng(3)
    for _ in range(3):
        ids = rng.integers(0, eng.num_global_nodes, 12).astype(np.int64)
        vals = rng.normal(size=(12, eng.n_feat_raw)).astype(np.float32)
        for e in (eng, jeng):
            e.apply_updates(ids, vals)
            e.refresh_boundary()
        assert torch.equal(eng._halo0, eng.full_boundary_exchange())
        assert np.array_equal(eng._halo0.numpy(),
                              np.asarray(jeng._halo0)[:, :])
    assert eng.wire_bad_total == jeng.wire_bad_total == 0
    # feature updates are no topology delta (JAX bumps the counter only in
    # apply_graph_deltas)
    assert eng.topo_generation == jeng.topo_generation == 0
    # a copy that corrupts a received (dirty) row: detected, rebuilt
    orig = pfresh.dirty_exchange

    def corrupt(h, halo, dirty, send_idx, send_mask, guard=False):
        out = orig(h, halo, dirty, send_idx, send_mask, guard=guard)
        if not guard and h.dtype != torch.uint8:
            n = h.shape[1]
            live = dirty[0].bool()[send_idx[0, 0].long().clamp(0, n - 1)] \
                & send_mask[0, 0]
            pdig.flip_bit_(halo[1, int(torch.nonzero(live)[0])], bit=3)
        return out

    monkeypatch.setattr(pfresh, "dirty_exchange", corrupt)
    buf = io.StringIO()
    # part 0's rows on its send list to part 1
    rows = sg.send_idx[0, 0][sg.send_mask[0, 0]][:8]
    ids = np.asarray(sg.global_nid)[0][rows]
    eng.apply_updates(ids, rng.normal(size=(ids.size, eng.n_feat_raw)
                                      ).astype(np.float32))
    eng.refresh_boundary(ml=MetricsLogger(buf))
    assert eng.wire_bad_total == 1
    assert torch.equal(eng._halo0, eng.full_boundary_exchange())
    rec = json.loads(buf.getvalue())
    assert (rec["event"], rec["check"], rec["blocks"], rec["epoch"]) == \
        ("integrity", "wire", 1, jeng.topo_generation)


# ---------------- the CLI drill -----------------------------------------


def test_cli_drill_prints_the_jax_integrity_lines(capsys, tmp_path):
    from pipegcn_tpu.cli.main import run as jax_run
    from pipegcn_tpu.cli.parser import create_parser as jax_parser
    from pipegcn_tpu_torch.cli import main as cli
    from test_torch_cli_train import _tiny_argv

    argv = _tiny_argv(["--n-epochs", "8", "--integrity-check-every", "2",
                       "--fault-plan", "bitflip@3:tables", "--no-eval"])
    cli.run(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    port = [x.split(" (")[0] for x in capsys.readouterr().out.splitlines()
            if x.startswith(("integrity:", "fault-injected"))]
    jax_run(jax_parser().parse_args(argv + [
        "--partition-dir", str(tmp_path / "parts"),
        "--model-dir", str(tmp_path / "model"),
        "--results-dir", str(tmp_path / "results")]))
    theirs = [x.split(" (")[0] for x in capsys.readouterr().out.splitlines()
              if x.startswith(("integrity:", "fault-injected"))]
    assert port == theirs == [
        "fault-injected bitflip:tables at epoch 3",
        "integrity: scrub mismatch on tables at epoch 4",
        "integrity: rebuilt shards [0] from the host artifact at epoch 4"]
