"""Micro-batching request layer — port copy of
``pipegcn_tpu/serve/batcher.py`` (``bucket_ladder``, ``bucket_for``,
``MicroBatcher``, ``ServingStats``), host-side and torch-free.

Not carried in this slice: overload shedding (the bounded queue and the
ticket deadline; the fleet router that relies on them is not ported), the
graduated
``AdmissionLadder`` (shaped traffic / autoscaling) and the sampled
per-query span hooks (tracing).

Node-id queries accumulate under a max-latency / max-batch policy and
are padded to a small ladder of power-of-two batch shapes. The batcher
drives an injected `run(ids) -> logits` callable (ServingEngine.query in
production, a fake in tests) and takes an injectable clock so the
latency policy is deterministically testable.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def bucket_ladder(min_bucket: int = 8, max_bucket: int = 64) -> List[int]:
    """Power-of-two batch shapes from min_bucket to max_bucket
    (both rounded up to powers of two). Every query batch pads to one
    of these, so the compiled-program population is O(log max/min)."""
    lo = _next_pow2(max(1, int(min_bucket)))
    hi = _next_pow2(max(lo, int(max_bucket)))
    ladder, b = [], lo
    while b <= hi:
        ladder.append(b)
        b *= 2
    return ladder


def bucket_for(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder shape holding n rows (callers chunk above the
    top shape, so n must not exceed ladder[-1])."""
    if n > ladder[-1]:
        raise ValueError(f"batch of {n} exceeds max bucket {ladder[-1]}")
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


class Ticket:
    """One submitted query: node ids in, logits rows out after the
    batch it rode in flushes."""

    __slots__ = ("ids", "t_submit", "result", "latency_s", "done")

    def __init__(self, ids: np.ndarray, t_submit: float):
        self.ids = ids
        self.t_submit = t_submit
        self.result: Optional[np.ndarray] = None
        self.latency_s: Optional[float] = None
        self.done = False


class MicroBatcher:
    """Accumulate query tickets; flush when the batch fills or the
    oldest ticket has waited max_delay_ms (the latency-vs-batch-fill
    tradeoff knob).

    `run(ids)` is called with the concatenated UNPADDED ids, and
    `observer(bucket, n_valid, latencies_s)` fires per flushed batch for
    stats collection."""

    def __init__(self, run: Callable[[np.ndarray], np.ndarray],
                 max_batch: int = 64, max_delay_ms: float = 5.0,
                 ladder_min: int = 8,
                 clock: Callable[[], float] = time.monotonic,
                 observer: Optional[Callable] = None):
        self._run = run
        self.ladder = bucket_ladder(ladder_min, max_batch)
        self.max_batch = self.ladder[-1]
        self.max_delay_s = max_delay_ms / 1000.0
        self._clock = clock
        self._observer = observer
        self._pending: List[Ticket] = []
        self.n_flushed_batches = 0
        self.n_served_rows = 0
        # every row ever handed to submit(): the conservation invariant
        # submitted == served + queue_depth holds at all times
        self.n_submitted_rows = 0

    # ---------------- intake ------------------------------------------

    def submit(self, node_ids) -> Ticket:
        ids = np.atleast_1d(np.asarray(node_ids, np.int64))
        if ids.size > self.max_batch:
            raise ValueError(
                f"a single query of {ids.size} ids exceeds max_batch "
                f"{self.max_batch}; split it")
        t = Ticket(ids, self._clock())
        self.n_submitted_rows += ids.size
        self._pending.append(t)
        return t

    @property
    def queue_depth(self) -> int:
        """Queued query rows (node ids) not yet flushed."""
        return int(sum(t.ids.size for t in self._pending))

    def oldest_wait_s(self, now: Optional[float] = None) -> float:
        if not self._pending:
            return 0.0
        now = self._clock() if now is None else now
        return now - self._pending[0].t_submit

    def due(self, now: Optional[float] = None) -> bool:
        if not self._pending:
            return False
        if self.queue_depth >= self.max_batch:
            return True
        return self.oldest_wait_s(now) >= self.max_delay_s

    # ---------------- flush -------------------------------------------

    def take_batch(self, now: Optional[float] = None,
                   force: bool = False):
        """Pop one due batch WITHOUT running it: returns (tickets,
        concatenated ids), or None when nothing is due."""
        now = self._clock() if now is None else now
        if not self._pending or not (force or self.due(now)):
            return None
        take, rows = [], 0
        while self._pending and rows + self._pending[0].ids.size \
                <= self.max_batch:
            t = self._pending.pop(0)
            take.append(t)
            rows += t.ids.size
        if not take:  # single oversized ticket is rejected at submit
            return None
        return take, np.concatenate([t.ids for t in take])

    def complete_batch(self, take: List[Ticket], out: np.ndarray,
                       t_done: Optional[float] = None) -> None:
        """Fill a taken batch's tickets from the concatenated result
        rows and fire the observer."""
        t_done = self._clock() if t_done is None else t_done
        off = 0
        lats = []
        rows = 0
        for t in take:
            t.result = out[off:off + t.ids.size]
            off += t.ids.size
            rows += t.ids.size
            t.latency_s = t_done - t.t_submit
            t.done = True
            lats.extend([t.latency_s] * t.ids.size)
        self.n_flushed_batches += 1
        self.n_served_rows += rows
        if self._observer is not None:
            self._observer(bucket_for(rows, self.ladder), rows, lats)

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """Flush every due batch (or everything with force=True);
        returns the number of batches dispatched."""
        n = 0
        while True:
            batch = self.take_batch(now, force=force)
            if batch is None:
                return n
            take, ids = batch
            self.complete_batch(take, self._run(ids))
            n += 1

    def drain(self) -> int:
        """Flush the whole queue regardless of policy (shutdown path:
        the engine must answer every accepted query before exiting)."""
        return self.pump(force=True)


class ServingStats:
    """Windowed aggregation of serving metrics, snapshotted into the
    fields of the JAX package's `serving` record."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        # parameter-generation axis (v7): persists across windows — the
        # served generation doesn't vanish just because a window rolled
        self.param_generation = -1
        self.param_staleness = 0
        self.reset()

    def reset(self) -> None:
        self._t0 = self._clock()
        self.n_queries = 0
        self.n_batches = 0
        self._lat_s: List[float] = []
        self._fills: List[float] = []
        self.hits = 0
        self.misses = 0
        self.max_staleness = 0

    # fed by MicroBatcher's observer hook
    def note_batch(self, bucket: int, n_valid: int,
                   latencies_s: Sequence[float]) -> None:
        self.n_batches += 1
        self._fills.append(n_valid / max(bucket, 1))
        self._lat_s.extend(latencies_s)

    # fed by ServingEngine.query (which knows freshness at serve time)
    def note_serve(self, n: int, hit: bool, staleness_age: int) -> None:
        self.n_queries += int(n)
        if hit:
            self.hits += int(n)
        else:
            self.misses += int(n)
        self.max_staleness = max(self.max_staleness, int(staleness_age))

    # fed by the checkpoint watcher / engine after a (non-)swap
    def note_params(self, generation: int, staleness: int = 0) -> None:
        self.param_generation = int(generation)
        self.param_staleness = int(staleness)

    def snapshot(self, queue_depth: int = 0, reset: bool = True) -> dict:
        """One `serving` record's worth of fields; resets the window."""
        dt = max(self._clock() - self._t0, 1e-9)
        lat = np.asarray(self._lat_s, np.float64) * 1000.0
        served = self.hits + self.misses
        rec = {
            "window_s": float(dt),
            "queries": int(self.n_queries),
            "qps": float(self.n_queries / dt),
            "batch_fill": (float(np.mean(self._fills))
                           if self._fills else None),
            "queue_depth": int(queue_depth),
            "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
            "p95_ms": float(np.percentile(lat, 95)) if lat.size else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
            "cache_hit_rate": (float(self.hits / served)
                               if served else None),
            "staleness_age": int(self.max_staleness),
            "param_generation": int(self.param_generation),
            "param_staleness": int(self.param_staleness),
        }
        if reset:
            self.reset()
        return rec
