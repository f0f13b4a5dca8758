"""Parameter exchange with the JAX package.

``params_from_jax`` turns the params pytree of
``pipegcn_tpu.models.sage.init_params`` (or a trained one), handed over
as numpy arrays, into the port's parameter dict, so both packages
compute the same function. torch cannot reproduce JAX's RNG streams, so
this is how a test (or a JAX checkpoint) gives the port the exact
weights the reference holds. The reverse view is ``tree.tree_numpy`` (the
port's layout is the JAX pytree's), and ``first_copy`` takes one copy of
the stacked ``[P, ...]`` leaves an emulated JAX trainer keeps.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..tree import tree_map
from .sage import Params


def params_from_jax(tree: Mapping[str, Any],
                    device: torch.device) -> Params:
    """``{'layers': [...], 'norms': [...]}`` of numpy (or array-like)
    leaves -> the same layout of float32 tensors on ``device``. Weights
    keep their ``[in, out]`` storage, as both forwards right-multiply."""

    def leaf(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return {
        "layers": [{k: leaf(v) for k, v in lp.items()}
                   for lp in tree["layers"]],
        "norms": [{k: leaf(v) for k, v in nrm.items()}
                  for nrm in tree["norms"]],
    }


def first_copy(tree: Mapping[str, Any]) -> dict:
    """``v[0]`` of every leaf: one copy of an emulated JAX trainer's
    stacked ``[P, ...]`` params (or optimizer moments), as numpy."""
    return tree_map(lambda v: np.asarray(v)[0], tree)
