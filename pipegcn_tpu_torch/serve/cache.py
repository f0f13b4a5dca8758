"""Layer-0 boundary cache bookkeeping — the port's own copy of
``pipegcn_tpu/serve/cache.py`` (``Layer0Cache``; pure numpy, so it is
copied as it is).

The serving engine keeps the layer-0 halo block — the ``[(P-1)*B, F]``
concatenation of peer boundary rows that ``parallel.halo.exchange_blocks``
produces — resident on the device and feeds it to the first exchanged
layer of every refresh instead of a live exchange. This class is the
host-side staleness ledger for that cache: when a feature update dirties
owned rows, the send lists that route the exchange tell exactly which
receiver-side slots now hold stale values.

Slot math (as the exchange lays it out): at ring distance d, part p sends
``send_idx[p, d-1]`` to receiver q = (p+d) % P, and the receiver stores
that block at slots [(d-1)*B, d*B) in sender order. So a dirty owned row r
on p invalidates slot (d-1)*B + k on q for every (d, k) with
``send_mask[p, d-1, k]`` and ``send_idx[p, d-1, k] == r``.
"""

from __future__ import annotations

import numpy as np


class Layer0Cache:
    """Host-side staleness bitmap + hit accounting for the device-resident
    layer-0 halo block. The values live on the device in
    ``ServingEngine._halo0``; this class only answers "which slots are
    stale" and "what fraction of queries were served fully fresh"."""

    def __init__(self, send_idx: np.ndarray, send_mask: np.ndarray):
        # send_idx/send_mask: [P, P-1, B] as built by ShardedGraph
        self.send_idx = np.asarray(send_idx)
        self.send_mask = np.asarray(send_mask).astype(bool)
        self.num_parts = int(self.send_idx.shape[0])
        self.b_max = int(self.send_idx.shape[2]) \
            if self.send_idx.ndim == 3 and self.send_idx.shape[1] else 0
        n_dist = max(self.num_parts - 1, 0)
        self.stale = np.zeros((self.num_parts, n_dist * self.b_max), bool)
        self.hits = 0
        self.misses = 0

    # ---------------- invalidation ------------------------------------

    def invalidate_rows(self, parts: np.ndarray, rows: np.ndarray) -> int:
        """Mark receiver-side slots stale for dirty owned rows
        (partition-local indices). Returns the number of slots touched by
        THIS call (stale or not before), i.e. > 0 iff a dirty row is on a
        send list and the halo therefore needs a refresh."""
        parts = np.atleast_1d(np.asarray(parts))
        rows = np.atleast_1d(np.asarray(rows))
        touched = 0
        for p in np.unique(parts):
            local = rows[parts == p]
            for d in range(1, self.num_parts):
                q = (p + d) % self.num_parts
                sel = self.send_mask[p, d - 1] & np.isin(
                    self.send_idx[p, d - 1], local)
                k = np.nonzero(sel)[0]
                if k.size:
                    self.stale[q, (d - 1) * self.b_max + k] = True
                    touched += int(k.size)
        return touched

    def stale_slots(self, part: int) -> np.ndarray:
        """Stale slot indices into this receiver's halo block."""
        return np.nonzero(self.stale[part])[0]

    @property
    def n_stale(self) -> int:
        return int(self.stale.sum())

    def mark_fresh(self) -> None:
        """The incremental exchange just replayed every dirty row."""
        self.stale[:] = False

    # ---------------- hit accounting ----------------------------------

    def record_queries(self, n: int, hit: bool) -> None:
        if hit:
            self.hits += int(n)
        else:
            self.misses += int(n)

    @property
    def hit_rate(self):
        served = self.hits + self.misses
        return (self.hits / served) if served else None
