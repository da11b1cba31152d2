"""The model's two trainers in plain torch, from their published settings.

* The warm start: Adam (optax defaults: b1 0.9, b2 0.999, eps 1e-8, bias
  correction) on (theta, Z) of -F, non-finite gradient entries zeroed, the
  gradient clipped to global norm ``clip``, the log-hypers boxed to +-15 and
  the log-noise floored at log(min_noise).
* optimize_Z: Adam on Z alone of the mean over the hyper trace of -F, fresh
  moments each call, no clipping.

Both minimise -F with the trainers' modified Cholesky (pivot floor 1e-6,
on Kmm relative to max(sf2, 1)). Each returns the loss before every step, as
the program's trainers do.
"""

from __future__ import annotations

import math

import torch

from .bound import neg_elbo

__all__ = ["warm_start", "z_steps", "PIVOT_FLOOR"]

PIVOT_FLOOR = 1e-6


def _adam(p, g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    g = torch.where(g.abs() <= 3.0e38, g, torch.zeros_like(g))
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    return p - lr * (m / (1.0 - b1 ** t)) / (torch.sqrt(v / (1.0 - b2 ** t)) + eps), m, v


def warm_start(theta, Z, X, y, jitter, *, steps, lr, clip, min_noise):
    """(theta, Z, losses (steps,)) after ``steps`` Adam steps."""
    theta, Z = theta.clone(), Z.clone()
    mt, vt, mz, vz = (torch.zeros_like(a) for a in (theta, theta, Z, Z))
    floor = math.log(min_noise)
    losses = []
    for t in range(1, steps + 1):
        with torch.enable_grad():
            th, zz = theta.requires_grad_(True), Z.requires_grad_(True)
            loss = neg_elbo(th[None], X, y, zz, jitter, PIVOT_FLOOR)[0]
            gt, gz = torch.autograd.grad(loss, (th, zz))
        theta, Z = theta.detach(), Z.detach()
        gt, gz = (torch.where(g.abs() <= 3.0e38, g, torch.zeros_like(g)) for g in (gt, gz))
        sc = torch.clamp(clip / torch.sqrt((gt * gt).sum() + (gz * gz).sum()), max=1.0)
        theta, mt, vt = _adam(theta, gt * sc, mt, vt, t, lr)
        Z, mz, vz = _adam(Z, gz * sc, mz, vz, t, lr)
        theta = torch.clamp(theta, -15.0, 15.0)
        theta[-1] = torch.clamp(theta[-1], min=floor)
        losses.append(loss.detach())
    return theta, Z, torch.stack(losses)


def z_steps(Z, thetas, X, y, jitter, *, steps, lr):
    """(Z, losses (steps,)) after ``steps`` Adam steps over the trace rows
    ``thetas`` (S, d+2)."""
    Z = Z.clone()
    m, v = torch.zeros_like(Z), torch.zeros_like(Z)
    losses = []
    for t in range(1, steps + 1):
        with torch.enable_grad():
            zz = Z.requires_grad_(True)
            loss = neg_elbo(thetas, X, y, zz, jitter, PIVOT_FLOOR).mean()
            (g,) = torch.autograd.grad(loss, (zz,))
        Z, m, v = _adam(Z.detach(), g, m, v, t, lr)
        losses.append(loss.detach())
    return Z, torch.stack(losses)
