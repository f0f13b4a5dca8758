"""Open-loop load generator + the serving loop — port of
``pipegcn_tpu/serve/loadgen.py`` (``OpenLoopGenerator`` and
``run_serving_loop`` for constant-rate traffic).

Open-loop means arrival times are fixed up front and do NOT adapt to
service time — closed-loop generators hide overload by slowing down with
the server (coordinated omission). Arrivals are a homogeneous Poisson
process at ``qps``; at the same seed the stream is the JAX package's
constant-rate stream, arrival for arrival.

Feature-update churn as in JAX: a timer batch of ``update_rows`` random
rows every ``update_every_s``, and the mixed workload, where an
``update_fraction`` share of the arrivals are updates instead of
queries; both draw from ``default_rng(seed + 1)`` and both are inert
under use_pp.

Not carried yet (ROADMAP A9): shaped traffic (diurnal / flash-crowd /
trace replay), overload shedding, sampled tracing and metrics records.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from .batcher import ServingStats


class OpenLoopGenerator:
    """Deterministic (seeded) Poisson arrival schedule over random
    single-node queries. ``update_fraction`` > 0 marks that share of the
    arrivals as feature updates (``is_update``), drawn after the queries
    from the same generator and only when the fraction is non-zero, so
    the arrays equal JAX's at every seed."""

    def __init__(self, num_nodes: int, qps: float, duration_s: float,
                 seed: int = 0, update_fraction: float = 0.0):
        rng = np.random.default_rng(seed)
        n = max(1, int(round(qps * duration_s)))
        gaps = rng.exponential(1.0 / max(qps, 1e-9), n)
        self.arrivals = np.minimum(np.cumsum(gaps), duration_s)
        self.queries = rng.integers(0, num_nodes, (n, 1), dtype=np.int64)
        if update_fraction > 0:
            self.is_update = rng.random(n) < float(update_fraction)
        else:
            self.is_update = np.zeros(n, bool)
        self.update_fraction = float(update_fraction)
        self.duration_s = float(duration_s)

    def __len__(self) -> int:
        return len(self.arrivals)


def run_serving_loop(engine, *, duration_s: float, qps: float,
                     max_delay_ms: float = 5.0,
                     report_every_s: float = 2.0,
                     refresh_every_s: float = 0.5,
                     update_every_s: float = 0.0,
                     update_rows: int = 32,
                     seed: int = 0,
                     update_fraction: float = 0.0,
                     stop: Optional[Callable[[], bool]] = None,
                     clock: Callable[[], float] = time.monotonic,
                     sleep: Callable[[float], None] = time.sleep) -> dict:
    """Drive the engine under open-loop load; returns the summary dict of
    the JAX loop (qps, n_queries, duration_s, p50/p95/p99_ms,
    batch_fill, cache_hit_rate, staleness_age_max, n_records, drained,
    stopped_early, n_submitted, n_served, conserved, ...).

    Cadences: every `refresh_every_s` the engine recomputes its logits;
    every `update_every_s` (0 disables; off under use_pp) a churn batch
    of `update_rows` random feature rows is applied and the dirty
    boundary rows re-exchanged (``apply_updates`` then
    ``refresh_boundary``); every `report_every_s` a window of serving
    stats closes (a record). `update_fraction` turns that share of the
    arrivals into the same churn instead of queries (counted in
    ``n_update_arrivals``; applied unless use_pp). `stop()` is polled
    between arrivals; on stop (or at the end) the queue drains, so every
    accepted query is answered before return."""
    stats = ServingStats(clock)
    all_lat: list = []
    fills: list = []

    def observer(bucket, n_valid, lats):
        stats.note_batch(bucket, n_valid, lats)
        all_lat.extend(lats)
        fills.append(n_valid / bucket)

    batcher = engine.make_batcher(stats=stats, max_delay_ms=max_delay_ms,
                                  clock=clock, observer=observer)
    gen = OpenLoopGenerator(engine.num_global_nodes, qps, duration_s,
                            seed=seed, update_fraction=update_fraction)
    churn = np.random.default_rng(seed + 1)
    do_updates = update_every_s > 0 and not engine.cfg.use_pp
    # the mixed workload's churn: the same inertness rule as the timer's
    do_arrival_updates = gen.update_fraction > 0 and not engine.cfg.use_pp
    n_update_arrivals = 0

    def apply_churn():
        ids = churn.integers(0, engine.num_global_nodes, update_rows,
                             dtype=np.int64)
        vals = churn.standard_normal(
            (update_rows, engine.n_feat_raw)).astype(np.float32)
        engine.apply_updates(ids, vals)
        engine.refresh_boundary()

    t0 = clock()
    next_report = t0 + report_every_s
    next_refresh = t0 + refresh_every_s
    next_update = t0 + update_every_s if do_updates else float("inf")
    n_records = 0
    total_q = 0
    stale_max = 0
    hits = misses = 0
    n_refresh = 0

    def emit():
        nonlocal n_records, total_q, stale_max, hits, misses
        h, m = stats.hits, stats.misses
        rec = stats.snapshot(queue_depth=batcher.queue_depth)
        total_q += rec["queries"]
        stale_max = max(stale_max, rec["staleness_age"])
        hits += h
        misses += m
        n_records += 1

    def tick(now):
        nonlocal next_report, next_refresh, n_refresh, next_update
        if do_updates and now >= next_update:
            apply_churn()
            next_update = now + update_every_s
        if now >= next_refresh:
            engine.refresh()
            n_refresh += 1
            next_refresh = now + refresh_every_s
        if now >= next_report:
            emit()
            next_report = now + report_every_s

    stopped = False
    for i, (t_arr, q) in enumerate(zip(gen.arrivals, gen.queries)):
        if stop is not None and stop():
            stopped = True
            break
        target = t0 + t_arr
        while True:
            now = clock()
            if now >= target:
                break
            batcher.pump(now)
            tick(now)
            if stop is not None and stop():
                stopped = True
                break
            sleep(min(target - now, 0.0005))
        if stopped:
            break
        if gen.is_update[i]:
            # mixed workload: this arrival is churn, not a query; it
            # never enters the ticket ledger
            n_update_arrivals += 1
            if do_arrival_updates:
                apply_churn()
        else:
            batcher.submit(q)
        now = clock()
        batcher.pump(now)
        tick(now)

    # shutdown: answer everything accepted, then the final window
    batcher.drain()
    emit()

    lat = np.asarray(all_lat, np.float64) * 1000.0
    dt = max(clock() - t0, 1e-9)
    served = hits + misses
    return {
        "qps": float(total_q / dt),
        "n_queries": int(total_q),
        "duration_s": float(dt),
        "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
        "p95_ms": float(np.percentile(lat, 95)) if lat.size else None,
        "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
        "batch_fill": float(np.mean(fills)) if fills else None,
        "cache_hit_rate": (float(hits / served) if served else None),
        "staleness_age_max": int(stale_max),
        "n_records": int(n_records),
        "n_refresh": int(n_refresh),
        "drained": batcher.queue_depth == 0,
        "stopped_early": bool(stopped),
        "traffic": "constant",
        "n_update_arrivals": int(n_update_arrivals),
        "n_submitted": int(batcher.n_submitted_rows),
        "n_served": int(batcher.n_served_rows),
        # zero tickets lost: submitted == served once the queue is
        # drained
        "conserved": bool(
            batcher.n_submitted_rows
            == batcher.n_served_rows + batcher.queue_depth),
        "param_generation": int(stats.param_generation),
        "param_staleness": int(stats.param_staleness),
    }
