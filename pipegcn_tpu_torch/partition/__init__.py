from .partitioner import partition_graph
from .halo import ShardedGraph

__all__ = ["partition_graph", "ShardedGraph"]
