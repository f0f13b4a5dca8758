"""Explicit device choice for every entry point of the port.

No JAX counterpart: the JAX package lets ``jax.devices()`` pick the
platform. Here the rule is explicit — CUDA unless the caller passes
``"cpu"``, and an error (never a silent CPU fallback) when CUDA was
wanted but is absent.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/``"cuda"`` -> the CUDA device (raises when CUDA is
    unavailable); ``"cpu"`` -> the CPU, where every kernel wrapper
    runs its plain PyTorch version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (CLI: "
                "--device cpu) to run the plain PyTorch path on the CPU")
        return dev if dev.index is not None else torch.device("cuda", 0)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
