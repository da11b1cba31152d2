"""Prior log-densities over hyperparameters in unconstrained space
(counterpart of ``ggp_tpu/priors.py``).

Every prior is a callable ``logpdf_unconstrained(u)`` for a leaf whose
natural parameter is ``x = exp(u)``; the log-Jacobian is folded in.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Prior", "Gamma", "HalfCauchy", "HalfCauchyOnStd", "HalfNormal",
           "LogNormal", "Normal", "Flat", "log_prior", "prior_tree_rbf"]


@dataclasses.dataclass(frozen=True)
class Prior:
    def logpdf_unconstrained(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Gamma(Prior):
    """Gamma(alpha, beta) on x = exp(u)."""

    alpha: float = 2.0
    beta: float = 1.0

    def logpdf_unconstrained(self, u):
        a, b = self.alpha, self.beta
        lp = a * math.log(b) - math.lgamma(a) + (a - 1.0) * u - b * torch.exp(u)
        return torch.sum(lp + u)


@dataclasses.dataclass(frozen=True)
class HalfCauchy(Prior):
    """HalfCauchy(scale) on x = exp(u)."""

    scale: float = 1.0

    def logpdf_unconstrained(self, u):
        s = self.scale
        lp = math.log(2.0 / (math.pi * s)) - torch.log1p((torch.exp(u) / s) ** 2)
        return torch.sum(lp + u)


@dataclasses.dataclass(frozen=True)
class HalfNormal(Prior):
    scale: float = 1.0

    def logpdf_unconstrained(self, u):
        s = self.scale
        lp = (0.5 * math.log(2.0 / math.pi) - math.log(s)
              - 0.5 * (torch.exp(u) / s) ** 2)
        return torch.sum(lp + u)


@dataclasses.dataclass(frozen=True)
class LogNormal(Prior):
    """u ~ N(mu, sigma^2): a plain Normal in unconstrained space."""

    mu: float = 0.0
    sigma: float = 1.0

    def logpdf_unconstrained(self, u):
        z = (u - self.mu) / self.sigma
        return torch.sum(-0.5 * z * z - math.log(self.sigma)
                         - 0.5 * math.log(2.0 * math.pi))


@dataclasses.dataclass(frozen=True)
class Normal(LogNormal):
    """Normal prior on an unconstrained quantity itself (no transform)."""


@dataclasses.dataclass(frozen=True)
class HalfCauchyOnStd(Prior):
    """HalfCauchy(scale) on the standard deviation s when the leaf stores a
    log-variance u = log(s^2); s = exp(u/2), log-Jacobian log(s/2)."""

    scale: float = 1.0

    def logpdf_unconstrained(self, u):
        sc = self.scale
        s = torch.exp(0.5 * u)
        lp = math.log(2.0 / (math.pi * sc)) - torch.log1p((s / sc) ** 2)
        return torch.sum(lp + torch.log(0.5 * s))


@dataclasses.dataclass(frozen=True)
class Flat(Prior):
    """Improper flat prior (contributes 0)."""

    def logpdf_unconstrained(self, u):
        return torch.zeros((), dtype=u.dtype, device=u.device)


def log_prior(prior_tree, params) -> torch.Tensor:
    """Sum of prior log-densities over a nested dict (and tuple) of Prior
    objects whose structure mirrors the parameter tree."""
    if isinstance(prior_tree, Prior):
        return prior_tree.logpdf_unconstrained(params)
    if isinstance(prior_tree, tuple):
        return sum(log_prior(p, v) for p, v in zip(prior_tree, params))
    return sum(log_prior(prior_tree[k], params[k]) for k in sorted(prior_tree))


def prior_tree_rbf() -> dict:
    """Default hyper-priors for Scale(RBF) + Gaussian noise: lengthscales
    Gamma(2,1), outputscale and noise std HalfCauchy(1)."""
    return {
        "kernel": {
            "log_outputscale": HalfCauchyOnStd(1.0),
            "base": {"log_lengthscale": Gamma(2.0, 1.0)},
        },
        "log_noise": HalfCauchyOnStd(1.0),
    }
