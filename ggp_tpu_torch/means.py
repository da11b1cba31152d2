"""Mean functions (counterpart of ``ggp_tpu/means.py``).

A mean function is an immutable description; its parameters live in a
separate dict, as the kernels' do. The port carries ``Zero``, the mean of
the JointHMC configuration it runs; ``Constant`` and ``Linear`` (the CO2
JointHMC mean) are still to be ported.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["MeanFunction", "Zero"]


@dataclasses.dataclass(frozen=True)
class MeanFunction:
    """Base: immutable structure; parameters are a separate dict."""

    def init_params(self, input_dim: int) -> dict:
        raise NotImplementedError

    def __call__(self, params: dict, X: torch.Tensor) -> torch.Tensor:
        """Mean values at rows of X: (N, D) -> (N,)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Zero(MeanFunction):
    """The zero mean. No parameters."""

    def init_params(self, input_dim: int) -> dict:
        return {}

    def __call__(self, params, X):
        return torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
