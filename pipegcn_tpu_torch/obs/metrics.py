"""The JSONL event sink — a reduced port of ``pipegcn_tpu/obs/metrics.py``
(``MetricsLogger``): ``write`` and the ``fault``, ``recovery`` and
``integrity`` records the integrity plane emits, with the JAX field names
(``obs/schema.py`` ``INTEGRITY_FIELDS``). One line per record, written to a
writable object the caller owns and flushed at once. The file sink (its
fsync of fault records and mismatch verdicts), schema validation, the
io-degraded ring buffer, the run header, epoch and eval records and the
probes wait for ``--metrics-out`` (ROADMAP A3).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional


def _jsonable(v: Any) -> Any:
    """Best-effort conversion to JSON-serializable types (numpy and torch
    scalars and arrays included)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    item = getattr(v, "item", None)
    if callable(item) and getattr(v, "ndim", None) == 0:
        return _jsonable(v.item())
    tolist = getattr(v, "tolist", None)
    if callable(tolist):
        return _jsonable(tolist())
    return str(v)


class MetricsLogger:
    """Append-only JSONL sink over ``f``, a text stream (``write`` and
    ``flush``: an open file, ``io.StringIO``) the caller owns and
    closes."""

    def __init__(self, f: Any):
        self._f = f

    def write(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        rec = {k: _jsonable(v) for k, v in rec.items()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    def fault(self, kind: str, epoch: int, rank: Optional[int] = None,
              **extra) -> Dict[str, Any]:
        """A detected or injected fault; extras carry the kind's detail.
        ``rank`` defaults to 0, the port's one process."""
        extra.setdefault("time_unix", time.time())
        return self.write({"event": "fault", "kind": str(kind),
                           "epoch": int(epoch),
                           "rank": 0 if rank is None else int(rank),
                           **extra})

    def recovery(self, kind: str, epoch: int, rank: Optional[int] = None,
                 **extra) -> Dict[str, Any]:
        """A completed recovery from the matching fault kind."""
        extra.setdefault("time_unix", time.time())
        return self.write({"event": "recovery", "kind": str(kind),
                           "epoch": int(epoch),
                           "rank": 0 if rank is None else int(rank),
                           **extra})

    def integrity(self, epoch: int, check: str, outcome: str,
                  target: Optional[str], cadence: int,
                  overhead_s: float, **extra) -> Dict[str, Any]:
        """One integrity-plane verdict (a digest scrub, a Freivalds check
        or a halo wire checksum) at a check boundary."""
        extra.setdefault("time_unix", time.time())
        return self.write({"event": "integrity", "epoch": int(epoch),
                           "check": str(check), "outcome": str(outcome),
                           "target": None if target is None else str(target),
                           "cadence": int(cadence),
                           "overhead_s": float(overhead_s), **extra})
