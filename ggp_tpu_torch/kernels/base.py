"""Scale(RBF-ARD) covariance (counterpart of ``ggp_tpu/kernels/base.py``).

A kernel is an immutable description; its parameters live in a nested
dict of unconstrained (log-space) tensors, the layout the JAX package uses
(``{"log_outputscale": (), "base": {"log_lengthscale": (d,)}}``). ``gram``
broadcasts over leading dimensions of the parameters (C chains:
``log_outputscale`` (C,), ``log_lengthscale`` (C, d) or (C,)) and of the
inputs.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["sq_dist", "Kernel", "RBF", "Scale", "is_scale_rbf"]


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances by norm expansion, clamped at 0."""
    n1 = (x1 * x1).sum(-1, keepdim=True)
    n2 = (x2 * x2).sum(-1, keepdim=True).transpose(-2, -1)
    return torch.clamp(n1 + n2 - 2.0 * x1 @ x2.transpose(-2, -1), min=0.0)


@dataclasses.dataclass(frozen=True)
class Kernel:
    def init_params(self, input_dim: int, *, dtype: torch.dtype,
                    device: torch.device | str) -> dict:
        raise NotImplementedError

    def gram(self, params: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def diag(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class RBF(Kernel):
    """k(x, z) = exp(-0.5 ||(x - z) / l||^2)."""

    ard: bool = True

    def init_params(self, input_dim, *, dtype, device):
        shape = (input_dim,) if self.ard else ()
        return {"log_lengthscale": torch.zeros(shape, dtype=dtype, device=device)}

    def gram(self, params, x1, x2):
        ls = torch.exp(params["log_lengthscale"])
        ls = ls[..., None, :] if self.ard else ls[..., None, None]
        return torch.exp(-0.5 * sq_dist(x1 / ls, x2 / ls))

    def diag(self, params, x):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class Scale(Kernel):
    """outputscale * base."""

    base: Kernel = None
    init_log_outputscale: float = 0.0

    def init_params(self, input_dim, *, dtype, device):
        return {"log_outputscale": torch.full((), self.init_log_outputscale,
                                              dtype=dtype, device=device),
                "base": self.base.init_params(input_dim, dtype=dtype, device=device)}

    def gram(self, params, x1, x2):
        os_ = torch.exp(params["log_outputscale"])[..., None, None]
        return os_ * self.base.gram(params["base"], x1, x2)

    def diag(self, params, x):
        return torch.exp(params["log_outputscale"]) * self.base.diag(params["base"], x)


def is_scale_rbf(kernel) -> bool:
    """Scale(RBF), with ARD or a scalar lengthscale."""
    return isinstance(kernel, Scale) and type(kernel.base) is RBF
