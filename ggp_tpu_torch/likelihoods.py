"""Gaussian observation likelihood (counterpart of
``GaussianLikelihood`` in ``ggp_tpu/likelihoods.py``)."""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["GaussianLikelihood"]


@dataclasses.dataclass(frozen=True)
class GaussianLikelihood:
    """y = f + eps, eps ~ N(0, sigma_n^2); noise stored as log(sigma_n^2)."""

    def init_params(self, *, dtype: torch.dtype, device) -> dict:
        return {"log_noise": torch.zeros((), dtype=dtype, device=device)}

    def noise(self, params):
        return torch.exp(params["log_noise"])

    def log_prob(self, params, f, y):
        s2 = self.noise(params)
        return -0.5 * (torch.log(2.0 * math.pi * s2) + (y - f) ** 2 / s2)

    def variational_expectation(self, params, mu, var, y):
        """E_{N(f | mu, var)}[log p(y | f)] in closed form."""
        s2 = self.noise(params)
        return -0.5 * (torch.log(2.0 * math.pi * s2) + ((y - mu) ** 2 + var) / s2)

    def predictive(self, params, mu, var):
        return mu, var + self.noise(params)
