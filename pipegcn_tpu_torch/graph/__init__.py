from .csr import Graph, add_self_loops, remove_self_loops, normalize_self_loops
from .synthetic import synthetic_graph, karate_club
from .datasets import load_data

__all__ = [
    "Graph",
    "add_self_loops",
    "remove_self_loops",
    "normalize_self_loops",
    "synthetic_graph",
    "karate_club",
    "load_data",
]
