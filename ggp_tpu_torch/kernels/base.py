"""Covariance kernels (counterpart of ``ggp_tpu/kernels/base.py``).

A kernel is an immutable description; its parameters live in a nested
dict of unconstrained (log-space) tensors, the layout the JAX package uses
(``{"log_outputscale": (), "base": {"log_lengthscale": (d,)}}``; a Sum or
Product holds ``{"terms": (params of each term, ...)}``). ``gram`` and
``diag`` broadcast over leading dimensions of the parameters (C chains or S
trace rows: ``log_outputscale`` (C,), ``log_lengthscale`` (C, d) or (C,))
and of the inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = ["sq_dist", "dist", "Kernel", "RBF", "Matern32", "RationalQuadratic",
           "Periodic", "Scale", "Sum", "Product", "is_scale_rbf"]


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances by norm expansion, clamped at 0."""
    n1 = (x1 * x1).sum(-1, keepdim=True)
    n2 = (x2 * x2).sum(-1, keepdim=True).transpose(-2, -1)
    return torch.clamp(n1 + n2 - 2.0 * x1 @ x2.transpose(-2, -1), min=0.0)


def dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances with a gradient-safe sqrt at 0."""
    d2 = sq_dist(x1, x2)
    pos = d2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))),
                       torch.zeros_like(d2))


def _unit_diag(x):
    return torch.ones(x.shape[-2], dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class Kernel:
    def init_params(self, input_dim: int, *, dtype: torch.dtype,
                    device: torch.device | str) -> dict:
        raise NotImplementedError

    def gram(self, params: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def diag(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __add__(self, other: "Kernel") -> "Sum":
        return Sum((self, other))

    def __mul__(self, other: "Kernel") -> "Product":
        return Product((self, other))


@dataclasses.dataclass(frozen=True)
class _Stationary(Kernel):
    """Lengthscale handling of the stationary kernels: one lengthscale per
    input dimension with ``ard``, else one."""

    ard: bool = True

    def init_params(self, input_dim, *, dtype, device):
        shape = (input_dim,) if self.ard else ()
        return {"log_lengthscale": torch.zeros(shape, dtype=dtype, device=device)}

    def _scaled(self, params, x1, x2):
        ls = torch.exp(params["log_lengthscale"])
        ls = ls[..., None, :] if self.ard else ls[..., None, None]
        return x1 / ls, x2 / ls

    def _r2(self, params, x1, x2):
        return sq_dist(*self._scaled(params, x1, x2))

    def _r(self, params, x1, x2):
        return dist(*self._scaled(params, x1, x2))

    def diag(self, params, x):
        return _unit_diag(x)


@dataclasses.dataclass(frozen=True)
class RBF(_Stationary):
    """k(x, z) = exp(-0.5 ||(x - z) / l||^2)."""

    def gram(self, params, x1, x2):
        return torch.exp(-0.5 * self._r2(params, x1, x2))


@dataclasses.dataclass(frozen=True)
class Matern32(_Stationary):
    """Matern nu=3/2: (1 + r) exp(-r), r = sqrt(3) ||(x - z) / l||."""

    def gram(self, params, x1, x2):
        r = self._r(params, x1, x2) * math.sqrt(3.0)
        return (1.0 + r) * torch.exp(-r)


@dataclasses.dataclass(frozen=True)
class RationalQuadratic(_Stationary):
    """k = (1 + r^2 / (2 alpha))^-alpha, r = ||(x - z) / l||."""

    def init_params(self, input_dim, *, dtype, device):
        p = super().init_params(input_dim, dtype=dtype, device=device)
        p["log_alpha"] = torch.zeros((), dtype=dtype, device=device)
        return p

    def gram(self, params, x1, x2):
        alpha = torch.exp(params["log_alpha"])[..., None, None]
        return torch.pow(1.0 + self._r2(params, x1, x2) / (2.0 * alpha), -alpha)


@dataclasses.dataclass(frozen=True)
class Periodic(Kernel):
    """k = exp(-2 sum_d sin^2(pi (x_d - z_d) / p) / l^2). ``fixed_period``
    keeps the period out of the parameters (the CO2 seasonal component's
    period of one year)."""

    fixed_period: Optional[float] = None

    def init_params(self, input_dim, *, dtype, device):
        p = {"log_lengthscale": torch.zeros((), dtype=dtype, device=device)}
        if self.fixed_period is None:
            p["log_period"] = torch.zeros((), dtype=dtype, device=device)
        return p

    def gram(self, params, x1, x2):
        if self.fixed_period is not None:
            period = self.fixed_period
        else:
            period = torch.exp(params["log_period"])[..., None, None, None]
        ls2 = torch.exp(2.0 * params["log_lengthscale"])[..., None, None]
        diff = x1[..., :, None, :] - x2[..., None, :, :]
        s = torch.sin(math.pi * diff / period)
        return torch.exp(-2.0 * (s * s).sum(-1) / ls2)

    def diag(self, params, x):
        return _unit_diag(x)


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
        return (torch.exp(params["log_outputscale"])[..., None]
                * self.base.diag(params["base"], x))


@dataclasses.dataclass(frozen=True)
class _Combo(Kernel):
    terms: Tuple[Kernel, ...] = ()

    def init_params(self, input_dim, *, dtype, device):
        return {"terms": tuple(t.init_params(input_dim, dtype=dtype, device=device)
                               for t in self.terms)}

    def _fold(self, op, method, params, *xs):
        out = None
        for t, p in zip(self.terms, params["terms"]):
            v = getattr(t, method)(p, *xs)
            out = v if out is None else op(out, v)
        return out


@dataclasses.dataclass(frozen=True)
class Sum(_Combo):
    def gram(self, params, x1, x2):
        return self._fold(torch.add, "gram", params, x1, x2)

    def diag(self, params, x):
        return self._fold(torch.add, "diag", params, x)

    def __add__(self, other: Kernel) -> "Sum":
        return Sum(self.terms + (other,))


@dataclasses.dataclass(frozen=True)
class Product(_Combo):
    def gram(self, params, x1, x2):
        return self._fold(torch.mul, "gram", params, x1, x2)

    def diag(self, params, x):
        return self._fold(torch.mul, "diag", params, x)

    def __mul__(self, other: Kernel) -> "Product":
        return Product(self.terms + (other,))


def is_scale_rbf(kernel) -> bool:
    """Scale(RBF), with ARD or a scalar lengthscale."""
    return isinstance(kernel, Scale) and type(kernel.base) is RBF
