"""Mixture posterior-predictive summaries (counterpart of
``ggp_tpu/utils/posterior_predictive.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["get_posterior_predictive_means_stds",
           "log_predictive_mixture_density"]


def get_posterior_predictive_means_stds(means: torch.Tensor, vars_: torch.Tensor):
    """Equal-weight mixture moments from per-component (S, Nt) moments."""
    mix_mean = means.mean(0)
    second = (vars_ + means ** 2).mean(0)
    return mix_mean, torch.sqrt(torch.clamp(second - mix_mean ** 2, min=1e-12))


def log_predictive_mixture_density(means, vars_, y):
    """Per-point log density of the equal-weight Gaussian mixture."""
    comp_lp = -0.5 * (torch.log(2.0 * math.pi * vars_) + (y[None, :] - means) ** 2 / vars_)
    return torch.logsumexp(comp_lp, 0) - math.log(means.shape[0])
