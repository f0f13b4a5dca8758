"""Deterministic fault injection — port of ``pipegcn_tpu/resilience/
faults.py`` (``FaultPlan``) for the one kind the port runs.

A fault plan is a comma-separated list of ``kind@epoch[:rN]`` entries with
the JAX grammar (the same ``_ENTRY_RE``, the same ValueErrors for malformed
entries and unknown kinds). The port injects ``bitflip@E[:rN]:<params|
carry|tables|halo>``: one real bit flipped in the named state class at
that epoch boundary, exercising the integrity plane's detect / attribute
/ recover path (``resilience/integrity.py``). The class argument is
required. Every other JAX kind parses and is then refused by name
(ROADMAP A9).

Every entry fires at most once (a recovered re-run of the same epoch is
not flipped again). The optional ``:rN`` qualifier targets one rank; the
port runs one process, rank 0. Injection is host-side: the kernels are
never altered.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

# every kind the JAX grammar knows (pipegcn_tpu/resilience/faults.py KINDS
# with its storage kinds); the port runs bitflip only
KINDS = ("nan-loss", "nan-grad", "sigterm", "crash", "corrupt-ckpt",
         "desync", "hang", "slow-rank", "overflow", "kernel-crash",
         "kill", "rejoin", "replica-kill", "graph-delta",
         "journal-torn", "net-delay", "net-drop", "net-partition",
         "bitflip", "enospc", "torn-write", "ro-dir", "slow-fs")
PORTED_KINDS = ("bitflip",)

_ENTRY_RE = re.compile(
    r"^([a-z-]+)@(\d+)(?::([rm]?)(\d+))?(?::([a-z0-9]+))?$")

# kinds whose entries may carry a bare numeric argument (milliseconds;
# net-partition seconds)
_ARG_KINDS = ("slow-fs", "hang", "slow-rank", "net-delay",
              "net-partition")
# kinds whose entries carry a REQUIRED word argument (the SDC class)
_STR_ARG_KINDS = ("bitflip",)
_BITFLIP_CLASSES = ("params", "carry", "tables", "halo")


@dataclasses.dataclass
class _Entry:
    kind: str
    epoch: int
    rank: Optional[int] = None    # None = every rank (``:rN``)
    member: Optional[int] = None  # serving replica target (``:mK``)
    arg: Optional[int] = None     # per-kind numeric argument
    sarg: Optional[str] = None    # per-kind word argument (bitflip class)
    consumed: bool = False


class FaultPlan:
    """Parsed, single-shot fault schedule of one process."""

    def __init__(self, entries: List[_Entry], rank: int = 0):
        self._entries = sorted(entries, key=lambda e: e.epoch)
        self._rank = int(rank)

    @classmethod
    def parse(cls, spec: str, rank: int = 0) -> "FaultPlan":
        """Parse ``kind@epoch[:rN][,...]`` as the JAX ``FaultPlan.parse``
        does (ValueError with the grammar on a malformed entry or an
        unknown kind); a kind the port does not run raises
        NotImplementedError naming it."""
        entries = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            m = _ENTRY_RE.match(raw)
            if not m:
                raise ValueError(
                    f"bad fault-plan entry {raw!r}: expected "
                    f"kind@epoch[:rN] or kind@window[:mK] (e.g. "
                    f"nan-loss@5:r1,sigterm@8,replica-kill@2:m1)")
            kind, epoch = m.group(1), int(m.group(2))
            erank = emember = earg = esarg = None
            if m.group(3) == "r":
                erank = int(m.group(4))
            elif m.group(3) == "m":
                emember = int(m.group(4))
            elif m.group(3) == "" and m.group(4) is not None:
                earg = int(m.group(4))
            if m.group(5) is not None:
                if earg is not None:
                    raise ValueError(
                        f"bad fault-plan entry {raw!r}: at most one "
                        f"bare numeric argument (kind@E[:rN]:<N>)")
                if m.group(5).isdigit():
                    earg = int(m.group(5))
                else:
                    esarg = m.group(5)
            if earg is not None and kind not in _ARG_KINDS:
                raise ValueError(
                    f"bad fault-plan entry {raw!r}: a bare numeric "
                    f"argument (kind@E[:rN]:<N>) is only valid for "
                    f"{' / '.join(_ARG_KINDS)} (milliseconds)")
            if esarg is not None and kind not in _STR_ARG_KINDS:
                raise ValueError(
                    f"bad fault-plan entry {raw!r}: expected "
                    f"kind@epoch[:rN] — a word argument "
                    f"(kind@E[:rN]:<word>) is only valid for "
                    f"{' / '.join(_STR_ARG_KINDS)}")
            if kind in _STR_ARG_KINDS and esarg not in _BITFLIP_CLASSES:
                raise ValueError(
                    f"bad fault-plan entry {raw!r}: {kind} needs a "
                    f"target class, one of "
                    f"{' / '.join(_BITFLIP_CLASSES)} "
                    f"(e.g. bitflip@6:r0:tables)")
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; known: "
                    f"{', '.join(KINDS)}")
            if kind not in PORTED_KINDS:
                raise NotImplementedError(
                    f"fault kind {kind!r} is not ported yet (ROADMAP A9); "
                    f"the port injects {', '.join(PORTED_KINDS)}")
            entries.append(_Entry(kind, epoch, erank, emember, earg,
                                  esarg))
        return cls(entries, rank=rank)

    def _mine(self, e: _Entry) -> bool:
        return e.rank is None or e.rank == self._rank

    def due_str_arg(self, kind: str, epoch: int) -> Optional[str]:
        """The word argument of a ``kind`` entry for this rank scheduled
        at or before ``epoch``, consuming it (``bitflip@E[:rN]:<class>``);
        None when nothing is due."""
        for e in self._entries:
            if not e.consumed and e.kind == kind and e.epoch <= epoch \
                    and self._mine(e):
                e.consumed = True
                return e.sarg
        return None
