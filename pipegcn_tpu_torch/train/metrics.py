"""Evaluation metrics — a copy of ``pipegcn_tpu/train/metrics.py``
(numpy, no JAX): accuracy for single-label, micro-F1 for multi-label
(reference train.py:11-17 ``calc_acc``)."""

from __future__ import annotations

import numpy as np


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float((logits.argmax(axis=-1) == labels).mean()) \
        if len(labels) else 0.0


def micro_f1(logits: np.ndarray, labels: np.ndarray) -> float:
    """Micro-averaged F1 with predictions = logits > 0 (multi-label)."""
    pred = logits > 0
    lab = labels > 0.5
    tp = float(np.logical_and(pred, lab).sum())
    fp = float(np.logical_and(pred, ~lab).sum())
    fn = float(np.logical_and(~pred, lab).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def calc_acc(logits: np.ndarray, labels: np.ndarray) -> float:
    """Dispatch on label rank, like reference train.py:11-17."""
    if labels.ndim == 1:
        return accuracy(logits, labels)
    return micro_f1(logits, labels)
