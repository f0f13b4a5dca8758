"""Online serving runtime of the port: stacked-parts inference engine,
micro-batched queries, the open-loop serving loop with feature-update
churn, and the freshness ledger (``FreshnessTracker``, ``Layer0Cache``).
Entry point: ``python -m pipegcn_tpu_torch.cli.serve``."""

from .batcher import (MicroBatcher, ServingStats, Ticket,  # noqa: F401
                      bucket_for, bucket_ladder)
from .cache import Layer0Cache  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .freshness import FreshnessTracker  # noqa: F401
from .loadgen import OpenLoopGenerator, run_serving_loop  # noqa: F401
