"""Prebuilt kernels (counterpart of ``ggp_tpu/kernels/composite.py``)."""

from __future__ import annotations

from .base import RBF, Kernel, Scale


def default_rbf(ard: bool = True) -> Kernel:
    """Scale(RBF(ard)), the default model kernel."""
    return Scale(RBF(ard=ard))
