from .halo import exchange_blocks, halo_exchange
from .staging import StagedGraph, precompute_pp, stage

__all__ = ["exchange_blocks", "halo_exchange", "StagedGraph",
           "precompute_pp", "stage"]
