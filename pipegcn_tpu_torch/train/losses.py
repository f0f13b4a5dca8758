"""Loss — port of ``pipegcn_tpu/train/losses.py`` (``cross_entropy_sum``).

Sum-reduced over the masked train rows, as the reference's
``CrossEntropyLoss(reduction='sum')``; the 1/n_train normalization happens
on the gradients (the trainer divides), so per-part sums add up to the
global sum. Multilabel BCE waits for ROADMAP A5.
"""

from __future__ import annotations

import torch


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Sum of CE over rows where ``mask`` is True; ``logits [..., C]``,
    integer ``labels [...]``. Labels are clipped to [0, C-1] so padded
    rows index validly (they are masked out)."""
    logp = torch.log_softmax(logits, dim=-1)
    safe = labels.clamp(0, logits.shape[-1] - 1)
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -(picked * mask.to(picked.dtype)).sum()
