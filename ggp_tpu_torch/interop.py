"""Exchange of parameters with the JAX package, through numpy.

``params_from_jax`` turns the JAX model's hyper pytree (as numpy arrays:
``{"kernel": {"base": {"log_lengthscale": (d,)}, "log_outputscale": ()},
"log_noise": ()}``, or a composite kernel's tree such as the CO2
composite's ``{"kernel": {"terms": (...)}, "log_noise": ()}``) and Z into
the port's flat ``theta`` (its leaves in ``ravel_pytree`` order: (d+2,)
or 11) and Z; ``params_to_numpy`` goes back (given the ``kernel`` for a
composite tree). The same pair converts ``GPR_HMC.params``
and its trace: the JAX model's ``params`` has that tree, and its
``ravel_pytree`` order is the flat row's ``[log_ls (d), log_os,
log_noise]``. ``sgpmc_state_from_jax`` and
``sgpmc_state_to_numpy`` do the same for the SGPMC state (``{"kernel",
"lik": {"log_noise"}, "mean": {}, "v"}``) and its flat row ``[log_ls (d),
log_os, log_noise, v (m)]`` (``ravel_pytree`` order). All accept a leading
sample axis, so a trace converts the same way. Where the port keeps the JAX
package's own tree (the params of ``StochasticVariationalGP``,
``BayesianStochasticVariationalGP`` and ``SparseGPR``; SGHMC samples, the
state tree with leading (chains, kept) axes), ``tree_from_numpy`` converts
it leaf by leaf and ``tree_to_numpy`` goes back. The tests use them so that
both packages compute from identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.tree import tree_leaves, tree_map, unravel

__all__ = ["params_from_jax", "params_to_numpy", "sgpmc_state_from_jax",
           "sgpmc_state_to_numpy", "tree_from_numpy", "tree_to_numpy"]


def params_from_jax(hypers: dict, Z=None, *, dtype=torch.float64,
                    device="cpu"):
    """(theta, Z) tensors from the JAX hyper dict (numpy leaves), its leaves
    in ravel order; a leading sample axis of every leaf (that of the scalar
    ``log_noise``) is kept."""
    lead = np.shape(hypers["log_noise"])
    flat = np.concatenate([np.asarray(a).reshape(lead + (-1,))
                           for a in tree_leaves(hypers)], axis=-1)
    theta = torch.as_tensor(flat, dtype=dtype, device=device)
    if Z is None:
        return theta
    return theta, torch.as_tensor(np.asarray(Z), dtype=dtype, device=device)


def params_to_numpy(theta: torch.Tensor, Z: torch.Tensor | None = None, *, kernel=None):
    """The JAX hyper dict (numpy leaves) from ``theta`` (and Z): the
    Scale(RBF-ARD) layout, or with ``kernel`` that kernel's tree (its input
    dimension read from Z, else 1)."""
    if kernel is None:
        t = theta.detach().cpu().numpy()
        d = t.shape[-1] - 2
        hypers = {"kernel": {"base": {"log_lengthscale": t[..., :d]},
                             "log_outputscale": t[..., d]},
                  "log_noise": t[..., d + 1]}
    else:
        kw = dict(dtype=theta.dtype, device="cpu")
        like = {"kernel": kernel.init_params(1 if Z is None else Z.shape[-1], **kw),
                "log_noise": torch.zeros((), **kw)}
        hypers = tree_to_numpy(unravel(theta.detach().cpu(), like))
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


def tree_from_numpy(tree: dict, *, dtype=torch.float64, device="cpu") -> dict:
    """The port's tree of tensors from the JAX package's (numpy leaves)."""
    return tree_map(lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device), tree)


def tree_to_numpy(tree: dict) -> dict:
    """The JAX package's tree (numpy leaves) from the port's."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
