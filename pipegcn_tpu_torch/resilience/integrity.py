"""Silent-data-corruption defense, the integrity plane — port of
``pipegcn_tpu/resilience/integrity.py`` (``TARGETS``, ``SDC_CODES``,
``CheckResult``, ``IntegrityPlane``) for the stacked one-card trainer.

Three detectors, driven by ``Trainer.fit`` under ``--integrity-check-every
N``:

  digest scrub     K19 digests (``ops/digest.py``: order-free uint32 sums,
                   bit-identical to the numpy ``host_digest``) of every
                   static device tensor — the staged graph's arrays and its
                   bucket and block tables, and the features the step
                   reads — against a baseline, naming the dirty parts; and
                   of the parameters and the pipelined carry (the halo
                   group apart from the rest) against the digests taken
                   where they were last produced;
  Freivalds        the features projected onto a per-epoch random +-1
                   vector r, exchanged with K2 and aggregated through the
                   production aggregation (K1, K9, or K12 with the K9
                   remainder, at F = 1, the transport off), against an
                   independent raw-edge f64 reference on the host from the
                   partition artifact;
  wire lane        the pipelined exchange's checksums
                   (``parallel/halo.py`` ``guard=True``), harvested by fit.

Recovery is per target class (fit): ``tables`` rebuilds the static data
from the host artifact, ``halo`` / ``carry`` flush the pipelined carry,
``params`` roll back to the last good snapshot.

Differences from the JAX plane (ROADMAP §C): the host reference sums with
``np.bincount(weights=)`` in f64 where JAX uses ``np.add.at`` (the same
sums to within rounding, far inside ``FREIVALDS_RTOL``; ``np.add.at`` over
41M edges costs seconds); one process holds every part, so nothing spans
processes and no consensus word carries the SDC code; the quarantine
markers (read by the elastic supervisor, written under a coordinator)
wait for ROADMAP A8.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import digest as _digest

# target classes the chaos grammar can flip and the records attribute
TARGETS = ("params", "carry", "tables", "halo")

# SDC codes (the JAX consensus word's; 0 = none)
SDC_CODES = {t: i + 1 for i, t in enumerate(TARGETS)}
SDC_NAMES = {v: k for k, v in SDC_CODES.items()}

# a member whose run detects this many SDC events is asked to leave the
# fleet (the quarantine marker of ROADMAP A8)
QUARANTINE_STRIKES = 2

# staged tensors without a leading part axis: they name every part
_NO_PART_AXIS = ("meta",)


@dataclasses.dataclass
class CheckResult:
    """One detector's verdict at one check boundary."""

    check: str                   # scrub | freivalds | wire
    outcome: str                 # ok | mismatch
    target: Optional[str] = None  # params | carry | tables | halo
    detail: str = ""
    dirty_shards: Tuple[int, ...] = ()
    overhead_s: float = 0.0


def _named(prefix: str, obj, out: Dict[str, torch.Tensor]) -> None:
    """Every tensor of a dataclass of tensors (nested: the bucket and block
    tables), by dotted name."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = f"{prefix}{f.name}"
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif dataclasses.is_dataclass(v):
            _named(name + ".", v, out)


def static_tensors(trainer) -> Dict[str, torch.Tensor]:
    """The static device tensors the scrub guards, by name: every tensor of
    the trainer's ``StagedGraph`` (its bucket and block tables as
    ``bucket.fwd.idx``, ``block.a``, ...), with ``feat`` the features the
    step reads (the use_pp concat, in the compute dtype: JAX's
    ``data["feat"]``); the staged raw features are not read after the
    precompute."""
    out: Dict[str, torch.Tensor] = {}
    _named("", trainer.data, out)
    out["feat"] = trainer.feat
    return dict(sorted(out.items()))


def is_table(name: str) -> bool:
    """A kernel gather table (the chaos lane's ``tables`` class)."""
    return name.startswith(("bucket.", "block."))


def _digest_rows(named: Dict[str, torch.Tensor], P: Optional[int]
                 ) -> Dict[str, np.ndarray]:
    """``{name: [rows, 2] uint32}``: the per-part digests of each tensor
    with a leading part axis of ``P`` (``[P, 2]``, JAX ``shard_digests``),
    a flat digest otherwise and for every tensor when ``P`` is None
    (``[1, 2]``), all launched into one buffer and read back at once."""
    plan = []
    rows = 0
    for k, t in named.items():
        parts = (P is not None and t.dim() > 0 and t.shape[0] == P
                 and k.rsplit(".", 1)[-1] not in _NO_PART_AXIS)
        n = P if parts else 1
        plan.append((k, t, parts, rows, n))
        rows += n
    if not plan:
        return {}
    dev = next(iter(named.values())).device
    buf = torch.zeros((rows, 2), dtype=torch.int32, device=dev)
    for k, t, parts, r0, n in plan:
        t = t.detach()
        if parts:
            _digest.part_digests(t.contiguous(), out=buf[r0:r0 + n])
        else:
            _digest.digest(t.contiguous(), out=buf[r0])
    host = _digest.as_u32(buf)
    return {k: host[r0:r0 + n] for k, _, _, r0, n in plan}


def digest_tree(tree) -> Dict[str, np.ndarray]:
    """``{path: [2] uint32}`` flat digests of every leaf of a nested dict
    or list of tensors (JAX ``digest_tree``), in one read-back."""
    named: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}[{k!r}]", node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}[{i}]", v)
        else:
            named[prefix] = node

    walk("", tree)
    return {k: v[0] for k, v in _digest_rows(named, None).items()}


class IntegrityPlane:
    """Per-trainer SDC detector set, driven by fit at cadence.

    ``baseline(trainer)`` captures the static digests (again after any
    table rebuild); ``note_dynamic(trainer)`` captures params and carry
    digests right after a step; ``run_checks(trainer, epoch)`` at the next
    boundary re-digests and compares, and at the cadence also scrubs the
    static tensors and runs Freivalds."""

    # relative tolerance of the Freivalds comparison: the kernels sum in
    # f32, the host reference in f64; a flipped table index mis-routes
    # whole rows, orders of magnitude above this
    FREIVALDS_RTOL = 5e-2

    def __init__(self, check_every: int):
        self.check_every = max(int(check_every), 0)
        self._static_refs: Optional[Dict[str, np.ndarray]] = None
        self._dynamic_refs: Optional[Dict[str, Dict[str, np.ndarray]]] = None
        self.detections: Dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return self.check_every > 0

    def due(self, epoch: int) -> bool:
        return (self.enabled and epoch > 0
                and epoch % self.check_every == 0)

    # ---------------- baselines ---------------------------------------

    def baseline(self, trainer) -> float:
        """(Re)capture the static digest baseline; returns seconds."""
        t0 = time.perf_counter()
        self._static_refs = _digest_rows(static_tensors(trainer), trainer.P)
        return time.perf_counter() - t0

    @staticmethod
    def _dynamic(trainer) -> Dict[str, Dict[str, np.ndarray]]:
        refs = {"params": digest_tree(trainer.params)}
        comm = trainer.comm or {}
        if comm:
            refs["halo"] = digest_tree(comm.get("halo", {}))
            refs["carry"] = digest_tree(
                {k: v for k, v in comm.items() if k != "halo"})
        return refs

    def note_dynamic(self, trainer) -> float:
        """Capture params and carry digests at their production point
        (right after a step); the next boundary compares against them."""
        t0 = time.perf_counter()
        self._dynamic_refs = self._dynamic(trainer)
        return time.perf_counter() - t0

    def drop_dynamic(self) -> None:
        """Forget the params / carry baselines (rollback, carry flush: the
        state changed outside a step, legitimately)."""
        self._dynamic_refs = None

    # ---------------- checks ------------------------------------------

    def scrub_static(self, trainer) -> CheckResult:
        """Every static tensor against its baseline; mismatches name the
        dirty parts for the rebuild."""
        t0 = time.perf_counter()
        if self._static_refs is None:
            self.baseline(trainer)
            return CheckResult("scrub", "ok", target="tables",
                               detail="baseline captured",
                               overhead_s=time.perf_counter() - t0)
        cur = _digest_rows(static_tensors(trainer), trainer.P)
        bad: List[str] = []
        dirty: set = set()
        for k, now in cur.items():
            ref = self._static_refs.get(k)
            if ref is None:  # a key a rebuild added
                continue
            if now.shape != ref.shape:
                bad.append(k)
                dirty.update(range(trainer.P))
                continue
            rows = np.nonzero(np.any(now != ref, axis=-1))[0]
            if rows.size:
                bad.append(k)
                if now.shape[0] == trainer.P:
                    dirty.update(int(r) for r in rows)
                else:  # a tensor without a part axis names every part
                    dirty.update(range(trainer.P))
        dt = time.perf_counter() - t0
        if not bad:
            return CheckResult("scrub", "ok", target="tables", overhead_s=dt)
        return CheckResult(
            "scrub", "mismatch", target="tables",
            detail="digest mismatch in " + ", ".join(sorted(bad)[:6]),
            dirty_shards=tuple(sorted(dirty)), overhead_s=dt)

    def verify_dynamic(self, trainer) -> List[CheckResult]:
        """Params and carry digests against their production baselines."""
        t0 = time.perf_counter()
        if self._dynamic_refs is None:
            return []
        cur = self._dynamic(trainer)
        dt = time.perf_counter() - t0
        out: List[CheckResult] = []
        for target, refs in self._dynamic_refs.items():
            now = cur.get(target)
            if now is None:
                continue
            bad = [k for k, v in refs.items()
                   if not np.array_equal(now.get(k), v)]
            if bad:
                out.append(CheckResult(
                    "scrub", "mismatch", target=target,
                    detail="digest mismatch in " + ", ".join(sorted(bad)[:6]),
                    overhead_s=dt))
            else:
                out.append(CheckResult("scrub", "ok", target=target,
                                       overhead_s=dt))
        return out

    def freivalds(self, trainer, epoch: int) -> Optional[CheckResult]:
        """Randomized algebraic check of the production aggregation: the
        features projected onto a random +-1 vector, aggregated through the
        trainer's own kernels and tables, against a raw-edge f64 host
        reference from the partition artifact. GAT's aggregation depends
        on the parameters: None (the scrub covers it)."""
        if trainer.cfg.model == "gat":
            return None
        t0 = time.perf_counter()
        sg = trainer.sg
        rng = np.random.default_rng(
            (int(epoch) * 1000003 + 12345) & 0xFFFFFFFF)
        feat_w = int(trainer.feat.shape[-1])
        r = rng.integers(0, 2, size=feat_w).astype(np.float32) * 2 - 1
        try:
            u, w_fbuf = self._freivalds_device(trainer, r)
        except Exception as exc:  # noqa: BLE001 — a detector, not a crash
            return CheckResult(
                "freivalds", "ok", target="tables",
                detail=f"skipped: {exc!r}"[:160],
                overhead_s=time.perf_counter() - t0)
        u = u.astype(np.float64)
        w_fbuf = w_fbuf.astype(np.float64)
        es = np.asarray(sg.edge_src)
        ed = np.asarray(sg.edge_dst)
        deg = np.asarray(sg.in_deg, np.float64)
        n_max = sg.n_max
        worst = 0.0
        for p in range(trainer.P):
            # pad edges land on the sentinel row n_max, cut off below
            acc = np.bincount(ed[p], weights=w_fbuf[p][es[p]],
                              minlength=n_max + 1)
            v = acc[:n_max] / deg[p]
            scale = max(float(np.max(np.abs(v))), 1.0) if v.size else 1.0
            err = float(np.max(np.abs(u[p] - v))) if v.size else 0.0
            worst = max(worst, err / scale)
        dt = time.perf_counter() - t0
        if worst > self.FREIVALDS_RTOL:
            return CheckResult(
                "freivalds", "mismatch", target="tables",
                detail=f"projection residual {worst:.3e} "
                       f"(rtol {self.FREIVALDS_RTOL:g})",
                overhead_s=dt)
        return CheckResult("freivalds", "ok", target="tables",
                           detail=f"residual {worst:.3e}", overhead_s=dt)

    def _freivalds_device(self, trainer, r: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Device half of Freivalds: project the features (f32), exchange
        the projection (K2 at F = 1) and aggregate it through the step's
        aggregation with the transport off (K1, K9, or K12 and K9, at F =
        1). Returns ``(u [P, n_max], w_fbuf [P, n_max + H])`` on the
        host."""
        from ..parallel.halo import halo_exchange
        from ..parallel.trainer import exact_matmuls

        d = trainer.data
        with torch.no_grad(), exact_matmuls():
            r_t = torch.from_numpy(r).to(trainer.device)
            w = (trainer.feat.float() @ r_t)[..., None].contiguous()
            wb = halo_exchange(w, d.send_idx, d.send_mask,
                               ops=trainer._halo_ops)
            agg = trainer._step_spmm(transport=False)(
                wb, d.indptr, d.edge_src, d.in_deg)
        return (agg[..., 0].float().cpu().numpy(),
                wb[..., 0].float().cpu().numpy())

    # ---------------- the per-boundary checks -------------------------

    def run_checks(self, trainer, epoch: int, *,
                   deep: bool = True) -> List[CheckResult]:
        """The detectors in attribution order: the dynamic digest compare
        at every boundary, the static scrub and Freivalds when ``deep``
        (the cadence boundaries). Mismatches count toward the strikes."""
        results: List[CheckResult] = []
        results.extend(self.verify_dynamic(trainer))
        if deep:
            results.append(self.scrub_static(trainer))
            fr = self.freivalds(trainer, epoch)
            if fr is not None:
                results.append(fr)
        for res in results:
            if res.outcome == "mismatch" and res.target:
                self.detections[res.target] = \
                    self.detections.get(res.target, 0) + 1
        return results

    def total_detections(self) -> int:
        return sum(self.detections.values())

    def should_quarantine(self) -> bool:
        return self.total_detections() >= QUARANTINE_STRIKES
