"""SGHMC, stochastic-gradient Hamiltonian Monte Carlo (Chen et al. 2014),
counterpart of ``ggp_tpu/inference/sghmc.py``.

Update rule in premultiplied momentum variables (rho = eps M^-1 r), with a
diagonal preconditioner ``minv``:

    rho <- (1 - a) rho - eps_t^2 minv grad U~(z) + N(0, 2 a eps_t^2 minv)
    z   <- z + rho

``U~`` is the minibatch potential estimate scaled to the full data set.
The step size decays geometrically over warmup from ``step_size`` to
``final_step_size``; the momentum is redrawn from its stationary law
every ``resample_momentum_every`` steps; ``adapt_mass`` switches in a
Welford diagonal preconditioner at the end of warmup; ``control_variate``
uses the SVRG-anchored gradient g~_B(z) - g~_B(z_a) + grad U(z_a), the
anchor refreshed every ``anchor_refresh_every`` steps.

C chains run as one leading dimension of the state (where the JAX package
vmaps): ``logpost_fn(params, idx)`` receives the parameter tree with a
leading dimension of R rows on every leaf and the row indices idx (R, B),
and returns the R log posteriors (or their sum). The two control-variate
evaluations, at z and at the anchor, are one call of 2C rows. The flat
state is in ``jax.flatten_util.ravel_pytree`` order (dict keys sorted), so
draws and the inverse mass line up with the JAX package's. Random numbers
come from an explicit ``torch.Generator``, or are injected with ``draws``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

__all__ = ["SGHMCConfig", "run_sghmc", "ravel_tree", "unravel_rows"]


@dataclasses.dataclass(frozen=True)
class SGHMCConfig:
    step_size: float = 1e-3
    final_step_size: Optional[float] = None   # decay target (None = constant)
    friction: float = 0.05                    # 'a' in the update rule
    num_steps: int = 2000
    batch_size: int = 1024
    thin: int = 10                  # keep every thin-th state
    num_warmup: int = 500           # discarded leading states
    resample_momentum_every: int = 50
    adapt_mass: bool = False        # Welford diagonal preconditioner
    control_variate: bool = False   # SVRG anchor gradient (needs full_logpost_fn)
    anchor_refresh_every: int = 200  # full-gradient anchor refresh period


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def ravel_tree(tree):
    """(flat (dim,), spec): the leaves in sorted-key order, as
    ``ravel_pytree`` lays them out."""
    spec = [(p, tuple(t.shape)) for p, t in _leaves(tree)]
    return torch.cat([t.reshape(-1) for _, t in _leaves(tree)]), spec


def unravel_rows(flat, spec):
    """The tree of (R, dim) rows: every leaf gains the leading R."""
    out, i = {}, 0
    for path, shape in spec:
        size = math.prod(shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[:, i:i + size].reshape(flat.shape[0], *shape)
        i += size
    return out


def _grad_u(fn, z, spec, *args):
    """grad of -sum(fn(rows, *args)) at each row of z."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        U = -fn(unravel_rows(zz, spec), *args).sum()
        g, = torch.autograd.grad(U, zz)
    return g


def run_sghmc(logpost_fn: Callable, init_params, generator: torch.Generator | None,
              num_data: int, cfg: SGHMCConfig = SGHMCConfig(), num_chains: int = 1,
              full_logpost_fn: Optional[Callable] = None, draws: Optional[dict] = None):
    """C = ``num_chains`` chains of SGHMC from ``init_params`` + 0.01 N(0, 1).

    ``full_logpost_fn(params)`` (rows as for ``logpost_fn``) is the exact
    full-data log posterior the control variate needs. ``draws``, when
    given, replaces the generator: ``idx`` (C, T, B) int64, ``noise`` and
    ``refresh`` (C, T, dim) standard normals for step t = 1..T, ``init``
    (C, dim). Returns (samples: the tree with leaves (C, kept, ...), stats
    with ``inv_mass`` (C, dim))."""
    if cfg.control_variate and full_logpost_fn is None:
        raise ValueError("control_variate=True requires full_logpost_fn")
    flat0, spec = ravel_tree(init_params)
    dt, dev = flat0.dtype, flat0.device
    C, dim, B = num_chains, flat0.shape[0], cfg.batch_size
    eps0 = cfg.step_size
    ratio = 1.0 if cfg.final_step_size is None else cfg.final_step_size / cfg.step_size
    alpha = cfg.friction
    warm = max(cfg.num_warmup, 1)
    kw = dict(generator=generator, dtype=dt, device=dev)

    def draw(name, t):
        if draws is not None:
            return draws[name][:, t - 1].to(device=dev, dtype=torch.int64 if name == "idx"
                                            else dt)
        if name == "idx":
            return torch.randint(0, num_data, (C, B), generator=generator, device=dev)
        return torch.randn((C, dim), **kw)

    init = draws["init"].to(device=dev, dtype=dt) if draws is not None \
        else torch.randn((C, dim), **kw)
    z = flat0[None] + 0.01 * init
    r = torch.zeros_like(z)
    minv = torch.ones_like(z)
    wf_mean, wf_m2 = torch.zeros_like(z), torch.zeros_like(z)
    wf_cnt = 0.0
    if cfg.control_variate:
        za, ga = z.clone(), _grad_u(full_logpost_fn, z, spec)
    kept = []
    for t in range(1, cfg.num_steps + 1):
        eps_t = eps0 * ratio ** min(t / warm, 1.0)
        idx = draw("idx", t)
        noise, mom = draw("noise", t), draw("refresh", t)
        if cfg.control_variate:
            if t % cfg.anchor_refresh_every == 0:
                za, ga = z.clone(), _grad_u(full_logpost_fn, z, spec)
            g2 = _grad_u(logpost_fn, torch.cat([z, za]), spec, torch.cat([idx, idx]))
            g = g2[:C] - g2[C:] + ga
        else:
            g = _grad_u(logpost_fn, z, spec, idx)
        scale = eps_t * torch.sqrt(minv)
        r = (1.0 - alpha) * r - (scale * scale) * g + math.sqrt(2.0 * alpha) * scale * noise
        if t % cfg.resample_momentum_every == 0:
            r = scale * mom
        z = z + r
        if cfg.adapt_mass:
            if t <= cfg.num_warmup:           # Welford over the warmup trajectory
                wf_cnt += 1.0
                delta = z - wf_mean
                wf_mean = wf_mean + delta / wf_cnt
                wf_m2 = wf_m2 + delta * (z - wf_mean)
            if t == cfg.num_warmup:           # switch in; momentum is premultiplied
                var = wf_m2 / max(wf_cnt - 1.0, 1.0)
                var = (wf_cnt / (wf_cnt + 5.0)) * var + 1e-3 * (5.0 / (wf_cnt + 5.0))
                minv = var / torch.clamp(var.amax(-1, keepdim=True), min=1e-12)
                r = torch.zeros_like(r)
        if t - 1 >= cfg.num_warmup and (t - 1 - cfg.num_warmup) % cfg.thin == 0:
            kept.append(z)
    zs = torch.stack(kept, 1) if kept else z.new_zeros((C, 0, dim))
    samples = _reshape_tree(unravel_rows(zs.reshape(-1, dim), spec), C)
    stats = {"step_size": float(cfg.step_size),
             "final_step_size": float(cfg.final_step_size if cfg.final_step_size is not None
                                      else cfg.step_size),
             "friction": alpha, "num_kept": zs.shape[1], "inv_mass": minv}
    return samples, stats


def _reshape_tree(tree, C):
    if isinstance(tree, dict):
        return {k: _reshape_tree(v, C) for k, v in tree.items()}
    return tree.reshape(C, -1, *tree.shape[1:])
