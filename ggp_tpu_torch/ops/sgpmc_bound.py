"""Whitened JointHMC (SGPMC) potential of the Scale(RBF-ARD) x Gaussian x
Zero-mean model: value and analytic gradient, plain PyTorch beside the
``"sgpmc"`` core of the CUDA kernels, which runs on a group of blocks per
chain (``csrc/sgpmc_group.cuh``; the plain model of its order is
``ops.vfe_group.sgpmc_group_neg_logpost_vg``).

Counterpart of ``ggp_tpu/ops/fused_bound.py`` ``_sgpmc_neg_logpost_vg``
(the core the fused sampler kernels run with ``target="sgpmc"`` and the
fused warm start runs with ``want_z_grad``), on unpadded inputs: ``state``
(d+2+m,) in the ravel order of the JAX state ``{"kernel", "lik", "mean":
{}, "v"}`` = ``[log_lengthscale (d), log_outputscale, log_noise, v (m)]``,
``X`` (n, d), ``y`` (n,), ``Z`` (m, d).

With L = chol(Kmm + jitter max(sf2, 1) I), A = L^-1 Kms, mean = A^T v,
var = max(sf2 - colsum(A o A), 1e-12) and e = y - mean:

  F = -n/2 log(2 pi s2) - (||e||^2 + sum var) / (2 s2) - ||v||^2 / 2
      [+ sum over the d+2 hypers of 2u - e^u, the Gamma(2,1) priors]

and, with msk = [var_raw > 1e-12] (the clamp's adjoint),

  Abar  = (v e^T + A o msk) / s2,     dF/dv = A e / s2 - v
  Kms_b = L^-T Abar,                  Kmm_b = -L^-T S L^-1 / 2

where S = tril(Abar A^T) + tril(Abar A^T, -1)^T; then the RBF-ARD chain
rule to the lengthscales (and to Z with ``want_z_grad``). Products with
L^-1 are triangular solves against the factor.
"""

from __future__ import annotations

import math

import torch

from .linalg import capped_inv_ls, chol_upper

__all__ = ["sgpmc_neg_logpost_vg"]


def _solve_upper(U, B):
    """U^-1 B for upper-triangular U."""
    return torch.linalg.solve_triangular(U, B, upper=True)


def sgpmc_neg_logpost_vg(state, X, y, Z, jitter, *, want_z_grad=False,
                         want_prior=True, pivot_floor=None):
    """Plain PyTorch potential U = -(whitened log posterior) and dU/dstate
    (+ dU/dZ with ``want_z_grad``). ``want_prior=False`` drops the
    Gamma(2,1) hyperpriors and keeps the N(0, I) term on v (the warm
    start's objective); ``pivot_floor`` selects the trainers' modified
    Cholesky (relative to max(sf2, 1))."""
    n, d = X.shape
    m = Z.shape[0]
    dt, dev = X.dtype, X.device
    eye = torch.eye(m, dtype=dt, device=dev)
    log_os, log_noise, v = state[d], state[d + 1], state[d + 2:]
    inv_ls = capped_inv_ls(state[:d], X, Z)
    sf2 = torch.exp(log_os)
    s2 = torch.exp(log_noise)

    Xs, Zs = X * inv_ls, Z * inv_ls
    Xs2, Zs2 = Xs * Xs, Zs * Zs
    xn, zn = Xs2.sum(1), Zs2.sum(1)
    Kmm = sf2 * torch.exp(-0.5 * torch.clamp(zn[:, None] + zn[None, :]
                                             - 2.0 * Zs @ Zs.T, min=0.0))
    Kms = sf2 * torch.exp(-0.5 * torch.clamp(zn[:, None] + xn[None, :]
                                             - 2.0 * Zs @ Xs.T, min=0.0))
    jit_scale = torch.clamp(sf2, min=1.0)
    U = chol_upper(Kmm + (jitter * jit_scale) * eye,
                   None if pivot_floor is None else pivot_floor * jit_scale)
    A = torch.linalg.solve_triangular(U.T, Kms, upper=False)      # L^-1 Kms
    e = y - v @ A
    var_raw = sf2 - (A * A).sum(0)
    msk = (var_raw > 1e-12).to(dt)
    var = torch.clamp(var_raw, min=1e-12)
    see, svar = (e * e).sum(), var.sum()
    F = (-0.5 * n * torch.log(2.0 * math.pi * s2) - 0.5 * (see + svar) / s2
         - 0.5 * (v * v).sum())
    pr = 1.0 if want_prior else 0.0
    if want_prior:
        hyp = state[:d + 2]
        F = F + (2.0 * hyp - torch.exp(hyp)).sum()

    g_v = A @ e / s2 - v
    Abar = (v[:, None] * e[None, :] + A * msk[None, :]) / s2
    Kms_b = _solve_upper(U, Abar)                                 # L^-T Abar
    T = Abar @ A.T
    S = torch.tril(T) + torch.tril(T, -1).T
    Kmm_b = -0.5 * _solve_upper(U, _solve_upper(U, S).T)          # L^-T S L^-1
    Kmm_b = 0.5 * (Kmm_b + Kmm_b.T)

    dF_ds2 = -0.5 * n / s2 + 0.5 * (see + svar) / (s2 * s2)
    dlog_noise = dF_ds2 * s2 + pr * (2.0 - s2)
    Pmm, Pms = Kmm_b * Kmm, Kms_b * Kms
    dlog_os = (Pmm.sum() + Pms.sum()
               + jitter * sf2 * (sf2 > 1.0).to(dt) * torch.diagonal(Kmm_b).sum()
               - 0.5 * msk.sum() * sf2 / s2 + pr * (2.0 - sf2))
    rs_mm, cs_mm = Pmm.sum(1), Pmm.sum(0)
    rs_ms, cs_ms = Pms.sum(1), Pms.sum(0)
    PmmZs, PmsXs = Pmm @ Zs, Pms @ Xs
    dls = ((rs_mm + cs_mm + rs_ms) @ Zs2 + cs_ms @ Xs2
           - 2.0 * (Zs * (PmmZs + PmsXs)).sum(0))
    g_ls = dls + pr * (2.0 - torch.exp(state[:d]))
    g = torch.cat([g_ls, dlog_os[None], dlog_noise[None], g_v])
    if not want_z_grad:
        return -F, -g
    dZs = (-2.0 * (rs_mm[:, None] * Zs - PmmZs)
           - (rs_ms[:, None] * Zs - PmsXs))
    return -F, -g, -(dZs * inv_ls)
