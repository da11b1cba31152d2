"""Dense linear-algebra helpers (counterpart of ``ggp_tpu/ops/linalg.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["add_jitter", "safe_cholesky", "tri_solve", "chol_upper",
           "capped_inv_ls", "mvn_logpdf_chol"]

_INV_LS_CAP_NUM = 1024.0


def add_jitter(K: torch.Tensor, jitter: float, relative: bool = False) -> torch.Tensor:
    """K + jitter*I; with ``relative=True`` the jitter is scaled by the mean
    diagonal floored at 1, so conditioning tracks the outputscale."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    if relative:
        scale = torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1).mean(-1), min=1.0)
        return K + (jitter * scale)[..., None, None] * eye
    return K + jitter * eye


def safe_cholesky(K: torch.Tensor, jitter: float = 0.0,
                  relative: bool = False) -> torch.Tensor:
    """Lower Cholesky factor of K + jitter*I. A matrix that is not positive
    definite gives an all-NaN factor instead of raising, as
    ``jnp.linalg.cholesky`` does: the samplers read NaN as a divergence."""
    L, info = torch.linalg.cholesky_ex(add_jitter(K, jitter, relative))
    bad = (info > 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def tri_solve(L: torch.Tensor, b: torch.Tensor, lower: bool = True,
              trans: bool = False) -> torch.Tensor:
    """Solve L x = b (or L^T x = b with ``trans``) for triangular L; b may
    be a vector or a matrix."""
    vec = b.ndim == L.ndim - 1
    B = b.unsqueeze(-1) if vec else b
    A = L.transpose(-2, -1) if trans else L
    x = torch.linalg.solve_triangular(A, B, upper=(lower == trans))
    return x.squeeze(-1) if vec else x


def chol_upper(K: torch.Tensor, pivot_floor=None) -> torch.Tensor:
    """U = chol(K)^T. Without ``pivot_floor`` a non-positive-definite K
    gives NaN (sampler divergence semantics). With it, the modified
    Cholesky of ``block_chol_u(..., pivot_floor=...)``: a pivot below the
    floor becomes a sqrt(floor) e_i row and its elimination is skipped."""
    if pivot_floor is None:
        return safe_cholesky(K).T
    floor = torch.as_tensor(pivot_floor, dtype=K.dtype, device=K.device)
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) == 0 and bool((torch.diagonal(L) ** 2 >= floor).all()):
        return L.T                  # no pivot reaches the floor
    m = K.shape[0]
    P = K.clone()
    U = torch.zeros_like(K)
    for i in range(m):
        dp = P[i, i]
        if bool(dp >= floor):
            row = P[i, i:] * torch.rsqrt(dp)
            U[i, i:] = row
            P[i + 1:, i + 1:] -= torch.outer(row[1:], row[1:])
        else:
            U[i, i] = torch.sqrt(floor)
    return U


def capped_inv_ls(log_ls: torch.Tensor, X: torch.Tensor,
                  Z: torch.Tensor | None = None) -> torch.Tensor:
    """exp(-log_ls) capped at 1024 / max(1e-3, max|X|, max|Z|), the fused
    cores' guard (``fused_bound.capped_inv_ls``): beyond the cap the norm
    expansion of the squared distances loses all accuracy in float32. The
    dense GPR core has no Z and caps by max|X| alone (``Z=None``)."""
    scale = X.abs().max()
    if Z is not None:
        scale = torch.maximum(scale, Z.abs().max())
    return torch.minimum(torch.exp(-log_ls),
                         _INV_LS_CAP_NUM / torch.clamp(scale, min=1e-3))


def mvn_logpdf_chol(y: torch.Tensor, mean: torch.Tensor,
                    L: torch.Tensor) -> torch.Tensor:
    """log N(y | mean, L L^T) for a single (n,) observation."""
    n = y.shape[-1]
    alpha = tri_solve(L, y - mean)
    quad = (alpha * alpha).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
