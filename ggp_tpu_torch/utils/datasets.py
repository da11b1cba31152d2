"""Dataset helpers (counterpart of ``normalize`` in ``ggp_tpu/utils/datasets.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["normalize"]


def normalize(A: np.ndarray):
    """Z-score by column; returns (normalized, mean, std)."""
    mean = A.mean(axis=0, keepdims=True)
    std = A.std(axis=0, keepdims=True) + 1e-6
    return (A - mean) / std, mean, std
