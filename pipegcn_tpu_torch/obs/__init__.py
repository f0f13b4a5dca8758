"""The port's telemetry: the JSONL event sink of the integrity plane."""

from .metrics import MetricsLogger

__all__ = ["MetricsLogger"]
