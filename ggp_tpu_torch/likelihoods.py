"""Observation likelihoods (counterpart of ``ggp_tpu/likelihoods.py``).

The four observation models of the reference: Gaussian, Bernoulli-probit,
Softmax and log-Cox Poisson. Each is a small functional object with

* ``log_prob(params, f, y)``: elementwise log p(y | f);
* ``variational_expectation(params, mu, var, y)``: E_{N(f | mu, var)}[log
  p(y | f)], in closed form where one exists, by 20-node Gauss-Hermite
  otherwise (Softmax: antithetic Monte Carlo);
* ``predictive(params, mu, var)``: moments or probabilities of y at a test
  point given q(f) = N(mu, var).

Random numbers of the Monte Carlo terms are passed in (``eps``) or drawn
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Likelihood", "GaussianLikelihood", "BernoulliProbit", "Softmax",
           "PoissonLogCox", "gauss_hermite"]


def gauss_hermite(n: int = 20):
    """Normalised Gauss-Hermite nodes and weights for E_{N(0,1)}[g(eps)],
    as float64 tensors."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    return torch.as_tensor(x), torch.as_tensor(w / np.sum(w))


@dataclasses.dataclass(frozen=True)
class Likelihood:
    def init_params(self, *, dtype: torch.dtype, device) -> dict:
        return {}

    def log_prob(self, params, f, y):
        raise NotImplementedError

    def variational_expectation(self, params, mu, var, y):
        """E_{N(f | mu, var)}[log p(y | f)] by Gauss-Hermite quadrature."""
        x, w = (a.to(dtype=mu.dtype, device=mu.device) for a in gauss_hermite())
        f = mu[..., None] + torch.sqrt(torch.clamp(var, min=1e-12))[..., None] * x
        return (self.log_prob(params, f, y[..., None]) * w).sum(-1)


@dataclasses.dataclass(frozen=True)
class GaussianLikelihood(Likelihood):
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


@dataclasses.dataclass(frozen=True)
class BernoulliProbit(Likelihood):
    """p(y = 1 | f) = Phi(f), y in {0, 1}."""

    def log_prob(self, params, f, y):
        return torch.special.log_ndtr((2.0 * y - 1.0) * f)

    def predictive(self, params, mu, var):
        """P(y = 1) = Phi(mu / sqrt(1 + var)), exact for the probit link."""
        p = torch.special.ndtr(mu / torch.sqrt(1.0 + var))
        return p, p * (1.0 - p)


@dataclasses.dataclass(frozen=True)
class Softmax(Likelihood):
    """Multi-class softmax over C latent functions; f has a trailing
    dimension C, y holds integer class labels."""

    num_classes: int = 3
    num_mc: int = 64

    def log_prob(self, params, f, y):
        logp = torch.log_softmax(f, dim=-1)
        return torch.gather(logp, -1, y[..., None].long())[..., 0]

    def variational_expectation(self, params, mu, var, y, eps=None, generator=None):
        """Monte Carlo over ``num_mc`` antithetic draws: ``eps`` (num_mc // 2,
        *mu.shape) standard normals, drawn from ``generator`` when None, and
        their negatives."""
        if eps is None:
            eps = torch.randn((self.num_mc // 2,) + tuple(mu.shape), generator=generator,
                              dtype=mu.dtype, device=mu.device)
        eps = torch.cat([eps, -eps], dim=0)
        f = mu[None] + torch.sqrt(torch.clamp(var, min=1e-12))[None] * eps
        lp = self.log_prob(params, f, torch.broadcast_to(y, f.shape[:-1]))
        return lp.mean(0)

    def predictive(self, params, mu, var, eps=None, generator=None):
        """Class probabilities averaged over ``num_mc`` draws ``eps``
        (num_mc, *mu.shape), drawn from ``generator`` when None."""
        if eps is None:
            eps = torch.randn((self.num_mc,) + tuple(mu.shape), generator=generator,
                              dtype=mu.dtype, device=mu.device)
        f = mu[None] + torch.sqrt(torch.clamp(var, min=1e-12))[None] * eps
        p = torch.softmax(f, dim=-1).mean(0)
        return p, p * (1.0 - p)


@dataclasses.dataclass(frozen=True)
class PoissonLogCox(Likelihood):
    """y ~ Poisson(exp(f)), the log-Gaussian Cox observation model."""

    def log_prob(self, params, f, y):
        return y * f - torch.exp(f) - torch.lgamma(y + 1.0)

    def variational_expectation(self, params, mu, var, y):
        """y mu - exp(mu + var / 2) - log y!, in closed form."""
        return y * mu - torch.exp(mu + 0.5 * var) - torch.lgamma(y + 1.0)

    def predictive(self, params, mu, var):
        mean = torch.exp(mu + 0.5 * var)
        return mean, torch.exp(2.0 * mu + 2.0 * var) - mean ** 2 + mean
