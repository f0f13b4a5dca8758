"""Nested dicts and lists of tensors (the port's parameter, optimizer and
comm layouts) — the few pytree helpers the port needs, without JAX."""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf (anything that is not a dict, list or
    tuple), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    """The leaves in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_numpy(tree):
    """Tensors -> numpy copies on the host; bf16 tensors as exact f32
    copies (numpy has no bfloat16 and the port does not depend on
    ml_dtypes)."""
    def host(t):
        if not isinstance(t, torch.Tensor):
            return np.asarray(t)
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    return tree_map(host, tree)
