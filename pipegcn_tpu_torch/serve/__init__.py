"""Online serving runtime of the port: stacked-parts inference engine,
micro-batched queries and the open-loop serving loop. Entry point:
``python -m pipegcn_tpu_torch.cli.serve``."""

from .batcher import (MicroBatcher, ServingStats, Ticket,  # noqa: F401
                      bucket_for, bucket_ladder)
from .engine import ServingEngine  # noqa: F401
from .loadgen import OpenLoopGenerator, run_serving_loop  # noqa: F401
