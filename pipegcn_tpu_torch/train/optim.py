"""Adam — port of ``pipegcn_tpu/train/optim.py`` (``adam_init``,
``adam_update``).

``torch.optim.Adam`` semantics as the reference uses them: L2 weight decay
folded into the gradient (not AdamW), bias-corrected moments, update
``lr * m_hat / (sqrt(v_hat) + eps)``, in the JAX package's op order. The
state is a plain dict mirroring the params' layout (``{'mu', 'nu',
'step'}``), so it converts to and from the JAX pytree directly. The update
writes the params and moments in place (no second copy of the model);
call it under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..tree import tree_leaves, tree_map


def adam_init(params) -> Dict[str, Any]:
    def zeros(t):
        return torch.zeros_like(t, requires_grad=False)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": 0}


def adam_update(grads, state: Dict[str, Any], params, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> None:
    """One Adam step, in place on ``params`` and ``state``. ``grads`` has
    the params' layout (or is the flat list of their leaves)."""
    state["step"] += 1
    ps = tree_leaves(params)
    gs = grads if isinstance(grads, list) else tree_leaves(grads)
    mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    dev = ps[0].device
    # bias corrections in f32, as the JAX step computes them
    t = torch.tensor(float(state["step"]), dtype=torch.float32, device=dev)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), t)
    for p, g, m, v in zip(ps, gs, mus, nus):
        if weight_decay:
            g = g + weight_decay * p
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * (g * g))
        p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
