"""Serving freshness in the port (live feature updates with the
incremental dirty-row halo refresh) against the JAX package on the CPU.

- ``Layer0Cache`` against JAX's and against a brute-force slot walk;
- ``dirty_exchange_plain`` (K18's plain version) against a full exchange
  of the new rows on the dirty slots and the old bytes on the clean ones,
  bit for bit;
- the engine, GraphSAGE and GCN at P = 2 and 4: after rounds of
  ``apply_updates`` + ``refresh_boundary`` its halo equals its own full
  exchange and a JAX engine's full exchange over a ``ShardedGraph`` whose
  features were patched on the host, bit for bit; after ``refresh()`` the
  logits match that engine's (rtol / atol 1e-5); the staleness ledger, the
  refusals, and a batch of repeated ids against JAX's patch program;
- the serving loop's churn, the generator's arrays against JAX's, and the
  CLI.

The reference is the freshness contract (incremental == full exchange of
the updated send view); JAX's own incremental program is not an oracle
here (ROADMAP §C: its bit-identity tests fail now and then under load).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pipegcn_tpu.cli.serve import build_parser as jax_serve_parser
from pipegcn_tpu.graph import synthetic_graph
from pipegcn_tpu.models import ModelConfig as JaxModelConfig
from pipegcn_tpu.parallel import TrainConfig, Trainer
from pipegcn_tpu.partition import ShardedGraph, partition_graph
from pipegcn_tpu.serve import Layer0Cache as JaxLayer0Cache
from pipegcn_tpu.serve import OpenLoopGenerator as JaxOpenLoopGenerator
from pipegcn_tpu.serve import ServingEngine as JaxServingEngine
from pipegcn_tpu_torch.cli import serve as port_cli
from pipegcn_tpu_torch.models import ModelConfig, init_params, params_from_jax
from pipegcn_tpu_torch.parallel.halo import halo_gather_plain
from pipegcn_tpu_torch.parallel.staging import stage
from pipegcn_tpu_torch.serve import (FreshnessTracker, Layer0Cache,
                                     OpenLoopGenerator, ServingEngine,
                                     run_serving_loop)
from pipegcn_tpu_torch.serve.freshness import (dirty_exchange,
                                               dirty_exchange_plain)
from test_torch_bucket import csrc_constant

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
INT_OF = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # parallel test workers share the cores: one intra-op thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(INT_OF[t.dtype]).numpy()


# ---------------- Layer0Cache -----------------------------------------


def _brute_stale(send_idx, send_mask, dirty_pairs):
    P, _, B = send_idx.shape
    expect = np.zeros((P, (P - 1) * B), bool)
    for p in range(P):
        for d in range(1, P):
            for k in range(B):
                if send_mask[p, d - 1, k] and \
                        (p, int(send_idx[p, d - 1, k])) in dirty_pairs:
                    expect[(p + d) % P, (d - 1) * B + k] = True
    return expect


@pytest.mark.parametrize("P", [2, 3, 4])
def test_layer0_cache_matches_jax_and_brute_force(P):
    rng = np.random.default_rng(10 + P)
    n, B = 40, 9
    send_idx = rng.integers(0, n, (P, P - 1, B)).astype(np.int32)
    send_mask = rng.random((P, P - 1, B)) < 0.7
    ours, theirs = Layer0Cache(send_idx, send_mask), \
        JaxLayer0Cache(send_idx, send_mask)
    assert ours.n_stale == theirs.n_stale == 0
    assert ours.hit_rate is None and theirs.hit_rate is None
    seen = set()
    for step in range(5):
        k = int(rng.integers(1, 7))
        parts = rng.integers(0, P, k)
        rows = rng.integers(0, n, k)
        touched = ours.invalidate_rows(parts, rows)
        assert touched == theirs.invalidate_rows(parts, rows)
        now = {(int(p), int(r)) for p, r in zip(parts, rows)}
        assert touched == int(_brute_stale(send_idx, send_mask, now).sum())
        seen |= now
        expect = _brute_stale(send_idx, send_mask, seen)
        np.testing.assert_array_equal(ours.stale, expect)
        np.testing.assert_array_equal(ours.stale, theirs.stale)
        assert ours.n_stale == theirs.n_stale == int(expect.sum())
        for q in range(P):
            np.testing.assert_array_equal(ours.stale_slots(q),
                                          theirs.stale_slots(q))
        if step == 2:
            ours.mark_fresh()
            theirs.mark_fresh()
            assert ours.n_stale == theirs.n_stale == 0
            seen = set()
    # a row on no send list touches nothing
    off = sorted(set(range(n)) - set(send_idx[0][send_mask[0]].tolist()))
    if off:
        assert ours.invalidate_rows(np.array([0]), np.array(off[:1])) == 0
    for n_q, hit in ((8, True), (2, False), (5, True)):
        ours.record_queries(n_q, hit)
        theirs.record_queries(n_q, hit)
    assert ours.hit_rate == theirs.hit_rate == pytest.approx(13 / 15)


def test_freshness_tracker():
    t = FreshnessTracker(3, 5)
    assert not t.any and t.dirty.shape == (3, 5)
    t.mark(np.array([0, 2, 2]), np.array([4, 1, 1]))
    assert t.any
    np.testing.assert_array_equal(t.counts(), [1, 0, 1])
    t.clear()
    assert not t.any and t.counts().sum() == 0


# ---------------- dirty_exchange_plain (K18's plain version) -----------


def _send_lists(P, n_max, B, seed):
    """Send lists with masked-off slots whose indices are out of range, and
    (P > 2) one owner row on several distances and slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_max - 4, (P, P - 1, B)).astype(np.int32)
    mask = rng.random((P, P - 1, B)) < 0.75
    idx[:, :, -1] = n_max + 5      # out of range, masked off
    idx[:, :, -2] = -7
    mask[:, :, -2:] = False
    if P > 2:
        for d in range(P - 1):     # owner row 3 of part 0 at every distance
            idx[0, d, :2] = 3
            mask[0, d, :2] = True
    return idx, mask


def _expected(h_new, old, dirty, idx, mask):
    P, n_max = h_new.shape[:2]
    B = idx.shape[2]
    full = halo_gather_plain(h_new, torch.from_numpy(idx),
                             torch.from_numpy(mask), with_inner=False)
    want = _bits(old).copy()
    fresh = _bits(full)
    live = np.zeros(want.shape[:2], bool)
    for r in range(P):
        for d in range(1, P):
            s = (r - d) % P
            for b in range(B):
                i = min(max(int(idx[s, d - 1, b]), 0), n_max - 1)
                if mask[s, d - 1, b] and dirty[s, i]:
                    k = (d - 1) * B + b
                    want[r, k] = fresh[r, k]
                    live[r, k] = True
    return want, live


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("P", [2, 4])
def test_dirty_exchange_plain_is_a_full_exchange_on_dirty_slots(P, dtype):
    n_max, B, F = 30, 12, 5
    idx, mask = _send_lists(P, n_max, B, seed=P)
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.standard_normal((P, n_max, F),
                                             dtype=np.float32)).to(dtype)
    # the old halo: distinct NaN payloads (and random bits) that a clean
    # slot must keep byte for byte
    ib = INT_OF[dtype]
    info = torch.iinfo(ib)
    old = torch.from_numpy(rng.integers(
        info.min, info.max, (P, (P - 1) * B, F)).astype(np.int64)
    ).to(ib).view(dtype)
    nan_base = 0x7FC00001 if dtype == torch.float32 else 0x7FC1
    n_nan = P * 3
    flat = old.view(ib).view(-1)
    flat[:n_nan] = torch.arange(nan_base, nan_base + n_nan).to(ib)
    on_list = np.zeros((P, n_max), bool)
    for p in range(P):
        on_list[p, idx[p][mask[p]]] = True
    cases = {
        "empty": np.zeros((P, n_max), bool),
        "all": np.ones((P, n_max), bool),
        "off-list": ~on_list,
        "random": rng.random((P, n_max)) < 0.3,
        "one owner": np.zeros((P, n_max), bool),
    }
    cases["one owner"][0, 3] = True
    for name, dirty in cases.items():
        want, live = _expected(h, old, dirty, idx, mask)
        halo = old.clone()
        got = dirty_exchange_plain(h, halo, torch.from_numpy(dirty),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(mask))
        assert got is halo
        np.testing.assert_array_equal(_bits(halo), want, err_msg=name)
        # the wrapper on CPU tensors is the plain version, in place, and
        # takes the bits as uint8 too
        halo2 = old.clone()
        dirty_exchange(h, halo2, torch.from_numpy(dirty.astype(np.uint8)),
                       torch.from_numpy(idx), torch.from_numpy(mask))
        np.testing.assert_array_equal(_bits(halo2), want, err_msg=name)
        # the cache ledger names exactly the slots the exchange wrote
        cache = Layer0Cache(idx, mask)
        pp, rr = np.nonzero(dirty)
        touched = cache.invalidate_rows(pp, rr)
        np.testing.assert_array_equal(cache.stale, live, err_msg=name)
        assert touched == int(live.sum())
        if name in ("empty", "off-list"):
            assert not live.any()
        if name == "one owner" and P > 2:
            assert live.sum() >= P - 1  # every distance it sits on
        if name == "all":
            full = _bits(halo_gather_plain(
                h, torch.from_numpy(idx), torch.from_numpy(mask), False))
            np.testing.assert_array_equal(_bits(halo)[live], full[live])
    # the planted NaN payloads were there to keep (clean slots of "empty")
    assert _bits(old).reshape(-1)[:n_nan].tolist() == list(
        range(nan_base, nan_base + n_nan))


def test_dirty_exchange_checks_its_arguments():
    P, n_max, B, F = 2, 6, 3, 4
    h = torch.zeros((P, n_max, F))
    idx = torch.zeros((P, P - 1, B), dtype=torch.int32)
    mask = torch.ones((P, P - 1, B), dtype=torch.bool)
    dirty = torch.zeros((P, n_max), dtype=torch.bool)
    with pytest.raises(ValueError, match="halo must be"):
        dirty_exchange(h, torch.zeros((P, B + 1, F)), dirty, idx, mask)
    with pytest.raises(TypeError, match="share a dtype"):
        dirty_exchange(h, torch.zeros((P, B, F), dtype=torch.bfloat16),
                       dirty, idx, mask)
    with pytest.raises(ValueError, match="dirty must be"):
        dirty_exchange(h, torch.zeros((P, B, F)),
                       torch.zeros((P, n_max), dtype=torch.int32), idx, mask)


# ---------------- K18's split (csrc/halo_gather.cu), emulated ---------

# the row types of the split tests: (dtype, F)
K18_ROWS = {"f32 F=1": (torch.float32, 1), "f32 F=41": (torch.float32, 41),
            "f32 F=602": (torch.float32, 602),
            "bf16 F=41": (torch.bfloat16, 41), "u8 F=1": (torch.uint8, 1)}


def _k18_emulated(h, halo, dirty, idx, mask):
    """K18's split at the kernel's constants (``kDirtyWarps``,
    ``kDirtyAhead``): a block a chunk of 32 ``kDirtyWarps`` slots of the
    send lists in their own order (sender, distance, slot), lane l of the
    grid's warp g on slot g + l G (G the grid's warps); the mask and index
    of every slot, the dirty bit only where the mask is on; the warp's
    live slots copied one row at a time in lane order, lanes over the
    row's vectors (K2's widest vector the pointers, part strides and row
    size allow; ``kDirtyAhead`` of each row a lane at a time). Returns ``(halo after, writes,
    straddles)``: the halo's bytes written how many times each (``[P,
    (P-1)*B, row bytes]``), and the warps whose slots span two (sender,
    distance) blocks."""
    Wp = csrc_constant("halo_gather.cu", "kDirtyWarps")
    U = csrc_constant("halo_gather.cu", "kDirtyAhead")
    P, n_max, F = h.shape
    B = idx.shape[2]
    row_bytes = F * h.element_size()
    per_sender = (P - 1) * B
    a = (h.data_ptr() | halo.data_ptr() | n_max * row_bytes
         | per_sender * row_bytes | row_bytes)
    V = next(w for w in (16, 8, 4, 2, 1) if a % w == 0)
    nv = row_bytes // V
    # lanes over the row's vectors: lane v0 = lane, lane + 32 U, ... loads
    # v0, v0 + 32, ..., v0 + 32 (U - 1)
    vs = np.array([v0 + 32 * u for lane in range(32)
                   for v0 in range(lane, nv, 32 * U) for u in range(U)
                   if v0 + 32 * u < nv], np.int64)
    offs = (vs[:, None] * V + np.arange(V)).ravel()
    hb = h.contiguous().view(torch.uint8).numpy().reshape(-1)
    out = halo.clone()
    ob = out.view(torch.uint8).numpy().reshape(-1)  # out's bytes
    writes = np.zeros(ob.size, np.int64)
    m = mask.numpy().reshape(-1)
    ix = idx.numpy().reshape(-1)
    bits = dirty.numpy().reshape(-1).astype(bool)
    n_slots = P * per_sender
    G = -(-n_slots // (32 * Wp)) * Wp
    straddles = 0
    for g in range(G):
        e = g + G * np.arange(32)
        e = e[e < n_slots]
        straddles += len(np.unique(e // B)) > 1
        on = m[e].astype(bool)
        s = e // per_sender
        i = np.clip(ix[e], 0, n_max - 1)
        live = np.zeros(e.size, bool)
        live[on] = bits[s[on] * n_max + i[on]]  # on slots only
        k = e - s * per_sender
        r = (s + k // B + 1) % P
        src = s * n_max * row_bytes + i * row_bytes
        dst = r * per_sender * row_bytes + k * row_bytes
        for lane in np.nonzero(live)[0]:  # one row at a time, lane order
            ob[dst[lane] + offs] = hb[src[lane] + offs]
            writes[dst[lane] + offs] += 1
    return out, writes.reshape(P, per_sender, row_bytes), straddles


def _live_slots(dirty, idx, mask):
    """``[P, (P-1)*B]``: the receiver slots whose sender has the slot on
    its list and the (clipped) row dirty."""
    P, n_max = dirty.shape
    B = idx.shape[2]
    live = np.zeros((P, (P - 1) * B), bool)
    for r in range(P):
        for d in range(1, P):
            s = (r - d) % P
            i = np.clip(idx[s, d - 1], 0, n_max - 1)
            live[r, (d - 1) * B:d * B] = mask[s, d - 1] & dirty[s, i]
    return live


@pytest.mark.parametrize("rows", list(K18_ROWS))
@pytest.mark.parametrize("P", [2, 3, 4])
def test_k18_split_writes_every_live_slot_once(P, rows):
    """K18's split writes every live slot (mask on, owner row dirty)
    exactly once and never a clean or masked-off slot, and the halo it
    leaves is ``dirty_exchange_plain``'s bit for bit (which the tests above
    hold to a full exchange): B not a multiple of 32, warps whose slots
    straddle distances and senders, several blocks (F <= 41: B = 1,037),
    clipped indices, masked-off slots at out-of-range indices; every slot
    masked off, no rows dirty, all rows dirty, random, off-list."""
    dt, F = K18_ROWS[rows]
    n_max, B = 50, (37 if F == 602 else 1037)
    idx, mask = _send_lists(P, n_max, B, seed=10 * P + F)
    idx[:, :, 5] = n_max + 3   # out of range, on: clipped to the last row
    mask[:, :, 5] = True
    rng = np.random.default_rng(F)
    if dt == torch.uint8:
        h = torch.from_numpy(rng.integers(0, 256, (P, n_max, F),
                                          dtype=np.uint8))
        old = torch.from_numpy(rng.integers(0, 256, (P, (P - 1) * B, F),
                                            dtype=np.uint8))
    else:
        h = torch.from_numpy(rng.standard_normal(
            (P, n_max, F), dtype=np.float32)).to(dt)
        old = torch.from_numpy(rng.standard_normal(
            (P, (P - 1) * B, F), dtype=np.float32)).to(dt)
    on_list = np.zeros((P, n_max), bool)
    for p in range(P):
        on_list[p, np.clip(idx[p][mask[p]], 0, n_max - 1)] = True
    cases = {
        "every slot masked off": (np.zeros_like(mask), np.ones((P, n_max),
                                                                bool)),
        "no rows dirty": (mask, np.zeros((P, n_max), bool)),
        "all rows dirty": (mask, np.ones((P, n_max), bool)),
        "random": (mask, rng.random((P, n_max)) < 0.3),
        "off-list": (mask, ~on_list),
    }
    ti = torch.from_numpy(idx)
    for name, (m, bits) in cases.items():
        tm, tb = torch.from_numpy(m), torch.from_numpy(bits)
        got, writes, straddles = _k18_emulated(h, old, tb, ti, tm)
        live = _live_slots(bits, idx, m)
        assert straddles > 0, (name, "no warp straddles")
        assert writes.max() <= 1, (name, "a byte written twice")
        assert np.array_equal(writes.sum(-1), live * writes.shape[-1]), name
        want = dirty_exchange_plain(h, old.clone(), tb, ti, tm)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), \
            name
        if name in ("every slot masked off", "no rows dirty", "off-list"):
            assert not live.any(), name
        else:
            assert live.any(), name


# ---------------- the engine against JAX -------------------------------


def _graph(P):
    g = synthetic_graph(num_nodes=300, avg_degree=8, n_feat=12, n_class=5,
                        seed=21)
    return g, ShardedGraph.build(g, partition_graph(g, P, method="random"),
                                 n_parts=P)


def _jax_engine(sg, model, tree=None):
    sizes = (sg.n_feat, 16, 16, sg.n_class)
    trainer = Trainer(sg, JaxModelConfig(
        layer_sizes=sizes, model=model, norm="layer", dropout=0.0,
        use_pp=False, train_size=sg.n_train_global),
        TrainConfig(seed=3, n_epochs=0, eval=False))
    eng = JaxServingEngine(trainer, max_batch=64, ladder_min=8)
    if tree is None:
        tree = jax.tree_util.tree_map(np.asarray, trainer.state["params"])
        rng = np.random.default_rng(5)
        for n in tree["norms"]:  # LayerNorm off its (1, 0) init
            n["scale"] = (1 + 0.3 * rng.standard_normal(n["scale"].shape)
                          ).astype(np.float32)
            n["bias"] = (0.2 * rng.standard_normal(n["bias"].shape)
                         ).astype(np.float32)
    eng.load_params(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                    trainer.state["norm"])
    return eng, tree


def _port_engine(sg, model, tree):
    sizes = (sg.n_feat, 16, 16, sg.n_class)
    cfg = ModelConfig(layer_sizes=sizes, model=model, use_pp=False,
                      norm="layer")
    return ServingEngine(sg, stage(sg, CPU), cfg, params_from_jax(tree, CPU),
                         max_batch=64, ladder_min=8)


def _owner(sg):
    nid = np.asarray(sg.global_nid)
    n = int((nid >= 0).sum())
    part = np.zeros(n, np.int64)
    local = np.zeros(n, np.int64)
    for p in range(sg.num_parts):
        own = np.nonzero(nid[p] >= 0)[0]
        part[nid[p, own]] = p
        local[nid[p, own]] = own
    return part, local


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("model", ["graphsage", "gcn"])
def test_incremental_halo_equals_full_exchange_and_jax(model, P):
    g, sg = _graph(P)
    _, tree = _jax_engine(sg, model)
    eng = _port_engine(sg, model, tree)
    eng.warmup()
    staged_feat = eng.data.feat.clone()
    assert eng.refresh_boundary() == 0  # clean: nothing to replay
    part, local = _owner(sg)
    feat = np.array(sg.feat, dtype=np.float32)  # host-patched features
    rng = np.random.default_rng(1)
    probe = rng.integers(0, g.num_nodes, 4)
    before = eng.query(probe)
    for round_i in range(3):
        n = 10 + 5 * round_i
        ids = rng.integers(0, g.num_nodes, n).astype(np.int64)
        vals = rng.normal(size=(n, sg.n_feat)).astype(np.float32)
        for i, v in zip(ids, vals):  # in order: the last row of an id wins
            feat[part[i], local[i]] = v
        eng.apply_updates(ids, vals)
        assert eng.staleness_age >= 1 and not eng.fully_fresh
        n_stale = eng.cache.n_stale
        assert eng.refresh_boundary() == n_stale
        assert eng.refresh_boundary() == 0
        ref = eng.full_boundary_exchange()
        assert eng._halo0.dtype == ref.dtype and eng._halo0.shape == ref.shape
        np.testing.assert_array_equal(_bits(eng._halo0), _bits(ref),
                                      err_msg=f"{model} round {round_i}")
    # the engine patched its own copy: the staged graph is intact
    np.testing.assert_array_equal(_bits(eng._feat),
                                  feat.view(np.int32))
    assert torch.equal(eng.data.feat, staged_feat)

    # JAX over the host-patched graph: its full exchange and its logits
    jeng, _ = _jax_engine(dataclasses.replace(sg, feat=feat), model, tree)
    jhalo = np.asarray(jeng.full_boundary_exchange())
    assert jhalo.dtype == np.float32
    np.testing.assert_array_equal(_bits(eng._halo0),
                                  jhalo[..., :sg.n_feat].view(np.int32))
    eng.refresh()
    jeng.refresh()
    assert eng.fully_fresh
    ids = np.arange(g.num_nodes)
    np.testing.assert_allclose(eng.query(ids), jeng.query(ids), rtol=1e-5,
                               atol=1e-5)
    after = eng.query(probe)
    assert np.isfinite(after).all() and not np.allclose(before, after)


def test_staleness_ledger_and_refusals():
    g, sg = _graph(2)
    _, tree = _jax_engine(sg, "graphsage")
    eng = _port_engine(sg, "graphsage", tree)
    eng.refresh()
    assert eng.staleness_age == 0 and eng.fully_fresh
    rng = np.random.default_rng(2)
    ids = rng.integers(0, eng.num_global_nodes, 8).astype(np.int64)
    vals = rng.normal(size=(8, eng.n_feat_raw)).astype(np.float32)
    assert eng.apply_updates(ids, vals) > 0
    assert eng.staleness_age == 1 and eng._halo_lag == 1
    eng.apply_updates(ids, vals)
    assert eng.staleness_age == 2 and eng._halo_lag == 2
    eng.refresh_boundary()
    assert eng._halo_lag == 0 and eng.staleness_age == 2
    eng.refresh()
    assert eng.staleness_age == 0 and eng.fully_fresh
    # refresh() without a boundary refresh leaves the halo lag visible
    eng.apply_updates(ids, vals)
    eng.refresh()
    assert eng.staleness_age == eng._halo_lag == 1
    eng.refresh_boundary()
    eng.refresh()
    assert eng.fully_fresh
    # a row on no send list dirties no slot: the halo lag stays put
    on_list = np.zeros((2, eng.n_max), bool)
    for p in range(2):
        on_list[p, np.asarray(sg.send_idx)[p][np.asarray(sg.send_mask)[p]]] \
            = True
    part, local = _owner(sg)
    off = np.nonzero(~on_list[part, local])[0]
    if off.size:
        assert eng.apply_updates(off[:1], vals[:1]) == 0
        assert eng.staleness_age == 1 and eng._halo_lag == 0
        eng.refresh()
        assert eng.fully_fresh
    # queries record hits and misses as JAX's engine does
    h0 = eng.cache.hits
    eng.query(ids)
    assert eng.cache.hits == h0 + ids.size
    eng.apply_updates(ids, vals)
    eng.query(ids)
    assert eng.cache.misses == ids.size
    # the JAX engine's validation
    with pytest.raises(ValueError, match="values must be"):
        eng.apply_updates(ids, vals[:, :2])
    with pytest.raises(ValueError, match="out of range"):
        eng.apply_updates(np.array([eng.num_global_nodes]), vals[:1])
    # use_pp folds the raw features into the precompute: refused
    cfg = ModelConfig(layer_sizes=(sg.n_feat, 16, 16, sg.n_class),
                      use_pp=True, norm="layer")
    eng_pp = ServingEngine(sg, stage(sg, CPU), cfg,
                           init_params(cfg, torch.Generator().manual_seed(0),
                                       CPU))
    assert np.isfinite(eng_pp.query(ids)).all()
    with pytest.raises(ValueError, match="use_pp"):
        eng_pp.apply_updates(ids, vals)
    assert eng_pp.refresh_boundary() == 0


def test_repeated_ids_patch_as_jax_patches():
    """A batch that repeats ids (the churn draws with replacement): the
    last row of each id wins, across JAX's 256-row update chunks too."""
    g, sg = _graph(2)
    jeng, tree = _jax_engine(sg, "graphsage")
    eng = _port_engine(sg, "graphsage", tree)
    rng = np.random.default_rng(3)
    for n, pool in ((40, 10), (300, 25)):
        ids = rng.integers(0, pool, n).astype(np.int64)
        vals = rng.normal(size=(n, sg.n_feat)).astype(np.float32)
        assert len(np.unique(ids)) < n
        assert eng.apply_updates(ids, vals) == jeng.apply_updates(ids, vals)
        want = np.asarray(jeng._feat)[..., :sg.n_feat]
        np.testing.assert_array_equal(_bits(eng._feat), want.view(np.int32))
    assert eng.staleness_age == jeng.staleness_age == 2
    np.testing.assert_array_equal(eng.freshness.dirty, jeng.freshness.dirty)
    np.testing.assert_array_equal(eng.cache.stale, jeng.cache.stale)


# ---------------- the loop and the CLI --------------------------------


@pytest.mark.parametrize("fraction", [0.0, 0.05, 0.3])
def test_generator_matches_jax(fraction):
    for seed in (0, 4):
        ours = OpenLoopGenerator(500, 80.0, 3.0, seed=seed,
                                 update_fraction=fraction)
        theirs = JaxOpenLoopGenerator(500, 80.0, 3.0, seed=seed,
                                      update_fraction=fraction)
        np.testing.assert_array_equal(ours.arrivals, theirs.arrivals)
        np.testing.assert_array_equal(ours.queries, theirs.queries)
        np.testing.assert_array_equal(ours.is_update, theirs.is_update)
        assert ours.is_update.any() == (fraction > 0)


def _fake_clock():
    t = [0.0]

    def clock():
        return t[0]

    def sleep(dt):
        t[0] += dt

    return clock, sleep


@pytest.mark.parametrize("use_pp", [False, True], ids=["plain", "pp"])
def test_serving_loop_churn(use_pp):
    g, sg = _graph(2)
    cfg = ModelConfig(layer_sizes=(sg.n_feat, 16, 16, sg.n_class),
                      use_pp=use_pp, norm="layer")
    eng = ServingEngine(sg, stage(sg, CPU), cfg,
                        init_params(cfg, torch.Generator().manual_seed(0),
                                    CPU))
    feat0 = eng._feat.clone()
    clock, sleep = _fake_clock()
    s = run_serving_loop(eng, duration_s=2.0, qps=100.0, seed=4,
                         refresh_every_s=0.5, report_every_s=1.0,
                         update_every_s=0.3, update_rows=8,
                         update_fraction=0.1, clock=clock, sleep=sleep)
    assert s["drained"] and s["conserved"] and not s["stopped_early"]
    assert s["n_update_arrivals"] > 0
    assert s["n_queries"] + s["n_update_arrivals"] == 200
    assert s["n_queries"] == s["n_served"] == s["n_submitted"]
    if use_pp:
        # inert: no update reaches the engine
        assert torch.equal(eng._feat, feat0)
        assert s["cache_hit_rate"] == 1.0 and s["staleness_age_max"] == 0
    else:
        assert not torch.equal(eng._feat, feat0)
        assert s["cache_hit_rate"] < 1.0 and s["staleness_age_max"] >= 1
        assert not eng.freshness.any  # every churn batch was re-exchanged
        np.testing.assert_array_equal(_bits(eng._halo0),
                                      _bits(eng.full_boundary_exchange()))


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
def test_cli_serves_with_updates_on_cpu(tmp_path, model):
    cmd = [sys.executable, "-m", "pipegcn_tpu_torch.cli.serve",
           "--device", "cpu", "--dataset", "synthetic:300:8:12:5",
           "--n-partitions", "2", "--partition-method", "random",
           "--n-layers", "4", "--n-hidden", "16", "--model", model,
           "--serve-build", "--partition-dir", str(tmp_path),
           "--serve-duration", "1", "--serve-qps", "80",
           "--serve-refresh-every", "0.3", "--serve-update-every", "0.2",
           "--serve-update-rows", "16", "--update-fraction", "0.05"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    s = json.loads(r.stdout.strip().splitlines()[-1])
    assert s["serve"] is True and s["drained"] and s["conserved"]
    assert s["n_queries"] > 0 and s["n_update_arrivals"] > 0
    assert s["cache_hit_rate"] < 1.0 and s["staleness_age_max"] >= 1


def test_cli_refuses_use_pp_for_gcn():
    for model in ("gcn", "gat"):
        with pytest.raises(ValueError, match="GraphSAGE-only"):
            port_cli.main(["--device", "cpu", "--dataset", "karate",
                           "--model", model, "--use-pp",
                           "--partition-dir", "unused-nonexistent"])


def test_update_flags_parse_as_the_jax_parser():
    for argv in ([], ["--serve-update-every", "0.5", "--serve-update-rows",
                      "64", "--update-fraction", "0.05", "--model", "gcn"],
                 ["--serve_update_every", "0.2", "--serve_update_rows", "8",
                  "--update_fraction", "0.3"]):
        ours = vars(port_cli.build_parser().parse_args(argv))
        theirs = vars(jax_serve_parser().parse_args(argv))
        for k in ("serve_update_every", "serve_update_rows",
                  "update_fraction", "model", "use_pp"):
            assert ours[k] == theirs[k], (argv, k)
