"""Exchange of parameters with the JAX package, through numpy.

``params_from_jax`` turns the JAX model's hyper pytree (as numpy arrays:
``{"kernel": {"base": {"log_lengthscale": (d,)}, "log_outputscale": ()},
"log_noise": ()}``) and Z into the port's flat ``theta`` (d+2,) and Z;
``params_to_numpy`` goes back. The same pair converts ``GPR_HMC.params``
and its trace: the JAX model's ``params`` has that tree, and its
``ravel_pytree`` order is the flat row's ``[log_ls (d), log_os,
log_noise]``. ``sgpmc_state_from_jax`` and
``sgpmc_state_to_numpy`` do the same for the SGPMC state (``{"kernel",
"lik": {"log_noise"}, "mean": {}, "v"}``) and its flat row ``[log_ls (d),
log_os, log_noise, v (m)]`` (``ravel_pytree`` order). All accept a leading
sample axis, so a trace converts the same way. ``svgp_params_from_jax`` and
``bsvgp_params_from_jax`` map the params dict of the JAX
``StochasticVariationalGP`` / ``BayesianStochasticVariationalGP`` (numpy
leaves) onto the port model's ``params``, which has the same tree;
``svgp_params_to_numpy`` and ``bsvgp_params_to_numpy`` go back. The tests use
them so that both packages compute from identical state.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy", "sgpmc_state_from_jax",
           "sgpmc_state_to_numpy", "svgp_params_from_jax", "svgp_params_to_numpy",
           "bsvgp_params_from_jax", "bsvgp_params_to_numpy"]


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


def sgpmc_state_from_jax(state: dict, Z=None, *, dtype=torch.float64,
                         device="cpu"):
    """The flat SGPMC state row(s) (and Z) from the JAX state dict (numpy
    leaves)."""
    hypers = {"kernel": state["kernel"], "log_noise": state["lik"]["log_noise"]}
    theta = params_from_jax(hypers, dtype=dtype, device=device)
    v = torch.as_tensor(np.asarray(state["v"]), dtype=dtype, device=device)
    flat = torch.cat([theta, v], dim=-1)
    if Z is None:
        return flat
    return flat, torch.as_tensor(np.asarray(Z), dtype=dtype, device=device)


def sgpmc_state_to_numpy(flat: torch.Tensor, d: int, Z: torch.Tensor | None = None):
    """The JAX SGPMC state dict (numpy leaves) from flat row(s) (and Z)."""
    hypers = params_to_numpy(flat[..., :d + 2])
    state = {"kernel": hypers["kernel"], "lik": {"log_noise": hypers["log_noise"]},
             "mean": {}, "v": flat[..., d + 2:].detach().cpu().numpy()}
    if Z is None:
        return state
    return state, Z.detach().cpu().numpy()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def svgp_params_from_jax(params: dict, *, dtype=torch.float64, device="cpu") -> dict:
    """The port's SVGP ``params`` ({"kernel", "lik", "Z", "q_mu",
    "q_sqrt_raw"}) from the JAX model's (numpy leaves)."""
    return _tree_map(lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device),
                     params)


def svgp_params_to_numpy(params: dict) -> dict:
    """The JAX SVGP params dict (numpy leaves) from the port's."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), params)


# The BayesianSVGP params tree (the SVGP tree without "lik", plus
# "hyper_mu" (h,) and the packed "hyper_L_vec") converts leaf by leaf alike.
bsvgp_params_from_jax = svgp_params_from_jax
bsvgp_params_to_numpy = svgp_params_to_numpy
