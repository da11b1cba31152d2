"""Benchmark metrics with the reference's conventions (counterpart of
``ggp_tpu/utils/metrics.py``): everything de-standardises by ``y_std``;
``nlpd_mixture`` is the mean of per-component NLPDs, not the log-mixture
density."""

from __future__ import annotations

import math

import torch

__all__ = ["rmse", "nlpd", "nlpd_mixture"]


def rmse(pred_mean, y, y_std=1.0):
    return torch.sqrt(torch.mean((pred_mean - y) ** 2)) * y_std


def nlpd(pred_mean, pred_var, y, y_std=1.0):
    """Per-point marginal NLPD plus log y_std."""
    lp = -0.5 * (torch.log(2.0 * math.pi * pred_var) + (y - pred_mean) ** 2 / pred_var)
    return -torch.mean(lp) + math.log(y_std)


def nlpd_mixture(pred_means, pred_vars, y, y_std=1.0):
    """Mean over S components of the per-component NLPD; (S, Nt) inputs."""
    lp = -0.5 * (torch.log(2.0 * math.pi * pred_vars)
                 + (y[None, :] - pred_means) ** 2 / pred_vars)
    return torch.mean(-lp.mean(-1)) + math.log(y_std)
