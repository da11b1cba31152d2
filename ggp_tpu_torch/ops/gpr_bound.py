"""Dense GP marginal potential of the Scale(RBF-ARD) x Gaussian model (the
GPR_HMC target): value and analytic gradient, plain PyTorch beside the
``"gpr"`` core of the CUDA kernels (``csrc/gpr_bound.cuh``).

Counterpart of ``ggp_tpu/ops/fused_bound.py`` ``_gpr_neg_logpost_vg`` (the
core the fused sampler kernels run with ``target="gpr"``) and of
``make_gpr_potential``, on unpadded inputs: ``theta`` (d+2,) in ravel order
``[log_lengthscale (d), log_outputscale, log_noise]``, ``X`` (n, d), ``y``
(n,). The JAX core pads rows to a multiple of 128 for the TPU's lanes; the
port does not pad.

With K = Kcore + (s2 + jitter) I, the jitter ABSOLUTE (``add_jitter(...,
relative=False)``, as ``gp_marginal_loglik`` adds it), U = chol(K)^T, t =
U^-T y and a = K^-1 y = U^-1 t:

  F    = -(t.t + 2 sum log diag U + n log 2 pi) / 2
  Kbar = dF/dK = (a a^T - K^-1) / 2,   K^-1 = V V^T with V = U^-1
  dF/dlog_noise = s2 tr(Kbar),  P = Kbar o Kcore,  dF/dlog_os = sum P

then the RBF-ARD chain rule to the lengthscales and the closed-form priors
(``ops/vfe_bound.prior_terms``). A factorisation that meets a non-positive
pivot gives NaN, which the samplers read as a divergence.
"""

from __future__ import annotations

import math

import torch

from .linalg import capped_inv_ls, chol_upper

__all__ = ["gpr_neg_logpost_vg", "make_gpr_potential"]

_DIM_MAX = 128               # state row of the kernels (csrc kMaxDim)


def gpr_neg_logpost_vg(theta, X, y, jitter, *, prior_spec=None):
    """Plain PyTorch potential U = -(dense GP marginal log-likelihood + log
    prior) and dU/dtheta under the static prior spec (the default tree
    when None)."""
    from .vfe_bound import prior_terms
    n, d = X.shape
    dt, dev = X.dtype, X.device
    eye = torch.eye(n, dtype=dt, device=dev)
    inv_ls = capped_inv_ls(theta[:d], X)
    sf2 = torch.exp(theta[d])
    s2 = torch.exp(theta[d + 1])

    Xs = X * inv_ls
    Xs2 = Xs * Xs
    xn = Xs2.sum(1)
    Kcore = sf2 * torch.exp(-0.5 * torch.clamp(xn[:, None] + xn[None, :]
                                               - 2.0 * Xs @ Xs.T, min=0.0))
    U = chol_upper(Kcore + (s2 + jitter) * eye)                   # NaN if not PD
    V = torch.linalg.solve_triangular(U, eye, upper=True)         # U^-1
    t = torch.linalg.solve_triangular(U.T, y[:, None], upper=False)[:, 0]
    a = torch.linalg.solve_triangular(U, t[:, None], upper=True)[:, 0]
    logdet = 2.0 * torch.log(torch.diagonal(U)).sum()
    F = -0.5 * ((t * t).sum() + logdet + n * math.log(2.0 * math.pi))

    Kbar = 0.5 * (torch.outer(a, a) - V @ V.T)
    dlog_noise = s2 * torch.diagonal(Kbar).sum()
    P = Kbar * Kcore
    dlog_os = P.sum()
    dls = P.sum(1) @ Xs2 + P.sum(0) @ Xs2 - 2.0 * (Xs * (P @ Xs)).sum(0)

    lp, gp = prior_terms(theta, d, prior_spec)
    g = torch.cat([dls, dlog_os[None], dlog_noise[None]]) + gp
    return -(F + lp), -g


def make_gpr_potential(X, y, jitter: float, prior_spec=None):
    """Factory: ``potential_fn(theta) -> (U, dU/dtheta)`` for the dense
    GPR_HMC target (counterpart of ``fused_bound.make_gpr_potential``):
    the plain version on CPU tensors, the ``"gpr"`` potential kernel on
    CUDA tensors (``ops.vfe_bound.vfe_potential(core="gpr")``). Returns None
    when the state row d + 2 exceeds the kernels' 128 entries. Unlike the
    JAX package there is no row cap: the kernel's scratch is 3 n^2 values
    per chain in device memory."""
    from .vfe_bound import vfe_potential
    d = X.shape[1]
    if d + 2 > _DIM_MAX:
        return None
    Z = X.new_empty((0, d))
    jitter = float(jitter)

    def potential_fn(theta):
        return vfe_potential(theta, X, y, Z, jitter, prior_spec=prior_spec,
                             core="gpr")

    return potential_fn
