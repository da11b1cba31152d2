"""Titsias collapsed bound and SGPR predictive in plain PyTorch
(counterpart of ``ggp_tpu/models/sgpr.py``: ``_common``, ``sgpr_elbo``,
``sgpr_predict``).

``sgpr_elbo`` is the autograd reference the hand-derived bound and its
kernels are tested against; ``sgpr_predict`` serves the mixture
predictive.

  L  = chol(Kmm + jitter I),  A = L^-1 Kmn / sigma,  B = I + A A^T
  c  = LB^-1 A y / sigma
  ELBO = -N/2 log(2 pi s2) - sum log diag LB - (y^T y / s2 - c^T c)/2
         - (sum k_diag - s2 ||A||_F^2) / (2 s2)
"""

from __future__ import annotations

import math

import torch

from ..kernels import Kernel
from ..ops.linalg import safe_cholesky, tri_solve

__all__ = ["sgpr_elbo", "sgpr_predict"]


def _common(kernel: Kernel, params: dict, X: torch.Tensor, y: torch.Tensor,
            jitter: float):
    """Shared factorisation for the bound and the predictive."""
    Z = params["Z"]
    kp = params["kernel"]
    sigma2 = torch.exp(params["log_noise"])
    sigma = torch.sqrt(sigma2)
    Kmm = kernel.gram(kp, Z, Z)
    Kmn = kernel.gram(kp, Z, X)
    L = safe_cholesky(Kmm, jitter, relative=True)
    A = tri_solve(L, Kmn) / sigma
    B = A @ A.T + torch.eye(Z.shape[0], dtype=X.dtype, device=X.device)
    LB = safe_cholesky(B, 0.0)
    c = tri_solve(LB, A @ y) / sigma
    return dict(Z=Z, kp=kp, sigma2=sigma2, L=L, A=A, LB=LB, c=c)


def sgpr_elbo(kernel: Kernel, params: dict, X: torch.Tensor, y: torch.Tensor,
              jitter: float) -> torch.Tensor:
    """Collapsed VFE bound, total over the N rows."""
    n = X.shape[0]
    f = _common(kernel, params, X, y, jitter)
    sigma2, A, LB, c = f["sigma2"], f["A"], f["LB"], f["c"]
    kdiag_sum = kernel.diag(f["kp"], X).sum()
    qdiag_sum = sigma2 * (A * A).sum()
    bound = -0.5 * n * torch.log(2.0 * math.pi * sigma2)
    bound = bound - torch.log(torch.diagonal(LB)).sum()
    bound = bound - 0.5 * ((y * y).sum() / sigma2 - (c * c).sum())
    return bound - 0.5 * (kdiag_sum - qdiag_sum) / sigma2


def sgpr_predict(kernel: Kernel, params: dict, X: torch.Tensor, y: torch.Tensor,
                 X_test: torch.Tensor, jitter: float,
                 include_noise: bool = True):
    """Marginal posterior predictive mean and variance at ``X_test``
    (plus the observation noise when ``include_noise``)."""
    f = _common(kernel, params, X, y, jitter)
    Kts = kernel.gram(f["kp"], f["Z"], X_test)
    tmp1 = tri_solve(f["L"], Kts)
    tmp2 = tri_solve(f["LB"], tmp1)
    mean = tmp2.T @ f["c"]
    var = (kernel.diag(f["kp"], X_test) - (tmp1 * tmp1).sum(0)
           + (tmp2 * tmp2).sum(0))
    var = torch.clamp(var, min=1e-12)
    if include_noise:
        var = var + f["sigma2"]
    return mean, var
