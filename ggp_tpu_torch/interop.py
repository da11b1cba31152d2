"""Exchange of parameters with the JAX package, through numpy.

``params_from_jax`` turns the JAX model's hyper pytree (as numpy arrays:
``{"kernel": {"base": {"log_lengthscale": (d,)}, "log_outputscale": ()},
"log_noise": ()}``) and Z into the port's flat ``theta`` (d+2,) and Z;
``params_to_numpy`` goes back. Both accept a leading sample axis, so a
hyper trace converts the same way. The tests use them so that both
packages compute from identical state.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(hypers: dict, Z=None, *, dtype=torch.float64,
                    device="cpu"):
    """(theta, Z) tensors from the JAX hyper dict (numpy leaves)."""
    ls = np.asarray(hypers["kernel"]["base"]["log_lengthscale"])
    os_ = np.asarray(hypers["kernel"]["log_outputscale"])[..., None]
    noise = np.asarray(hypers["log_noise"])[..., None]
    theta = torch.as_tensor(np.concatenate([ls, os_, noise], axis=-1),
                            dtype=dtype, device=device)
    if Z is None:
        return theta
    return theta, torch.as_tensor(np.asarray(Z), dtype=dtype, device=device)


def params_to_numpy(theta: torch.Tensor, Z: torch.Tensor | None = None):
    """The JAX hyper dict (numpy leaves) from ``theta`` (and Z)."""
    t = theta.detach().cpu().numpy()
    d = t.shape[-1] - 2
    hypers = {"kernel": {"base": {"log_lengthscale": t[..., :d]},
                         "log_outputscale": t[..., d]},
              "log_noise": t[..., d + 1]}
    if Z is None:
        return hypers
    return hypers, Z.detach().cpu().numpy()
