"""The port's resilience layer: the integrity plane and the bit-flip chaos
lane (ROADMAP A9 holds the rest of the JAX package's)."""

from .faults import FaultPlan
from .integrity import (QUARANTINE_STRIKES, SDC_CODES, SDC_NAMES, TARGETS,
                        CheckResult, IntegrityPlane)

__all__ = ["FaultPlan", "IntegrityPlane", "CheckResult", "TARGETS",
           "SDC_CODES", "SDC_NAMES", "QUARANTINE_STRIKES"]
