"""Dense linear-algebra helpers (counterpart of ``ggp_tpu/ops/linalg.py``)."""

from __future__ import annotations

import torch

__all__ = ["add_jitter", "safe_cholesky", "tri_solve"]


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
