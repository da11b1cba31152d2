"""Sampler transitions replayed in plain torch, batched over transitions.

From a transition's start (the chain's previous draw), its step size, inverse
mass and random slabs, the leapfrog trajectory is integrated again on the
reference potential ``vg(z, rows)`` (``bound.neg_logpost_vg`` at the Z of
each row): L steps for fixed-leapfrog HMC, and for NUTS every doubling up to
the depth the program reports, each in the direction its tree uniform gives. A transition's next draw has to be a point of that
trajectory; and where the first leaf's acceptance is clear of rounding, the
chain had to leave its start.
"""

from __future__ import annotations

import math

import torch

__all__ = ["hmc_trajectories", "nuts_trajectories", "first_leaf_accepted"]

DIVERGENCE = 1000.0


def _kinetic(inv_mass, r):
    return 0.5 * (inv_mass * r * r).sum(-1)


def _leapfrog(z, r, g, step, inv_mass, vg):
    r_half = r - 0.5 * step[:, None] * g
    z = z + step[:, None] * inv_mass * r_half
    U, g = vg(z)
    return z, r_half - 0.5 * step[:, None] * g, U, g


def hmc_trajectories(z0, eps, inv_mass, mom, L, vg):
    """(points (R, 2, dim): the start and the end of L leapfrogs, accept
    probability (R,)) of R fixed-leapfrog HMC transitions."""
    r = mom / torch.sqrt(inv_mass)
    U0, g = vg(z0)
    H0 = U0 + _kinetic(inv_mass, r)
    z = z0
    for _ in range(L):
        z, r, U, g = _leapfrog(z, r, g, eps, inv_mass, vg)
    delta = U + _kinetic(inv_mass, r) - H0
    delta = torch.where(torch.isnan(delta), torch.full_like(delta, math.inf), delta)
    return torch.stack([z0, z], 1), torch.clamp(torch.exp(-delta), max=1.0)


def nuts_trajectories(z0, eps, inv_mass, mom, treeu, depths, vg):
    """Every leapfrog point of R NUTS transitions up to their depths.
    Returns (U0 (R,), r0 (R, dim), leaves): ``leaves[j][k]`` holds the
    (z, r, U) of doubling k of transition j, each stacked over its 2^k steps,
    on the host in float64."""
    R = z0.shape[0]
    r0 = mom / torch.sqrt(inv_mass)
    U0, g0 = vg(z0)
    ends = {+1: [z0.clone(), r0.clone(), g0.clone()], -1: [z0.clone(), r0.clone(), g0.clone()]}
    leaves = [[] for _ in range(R)]
    depths = [int(x) for x in depths]
    for k in range(max(depths, default=0)):
        rows = torch.tensor([j for j in range(R) if depths[j] > k], device=z0.device)
        dirs = torch.where(treeu[rows, k, 0] < 0.5, 1.0, -1.0).to(z0.dtype)
        fwd = dirs > 0
        z = torch.where(fwd[:, None], ends[+1][0][rows], ends[-1][0][rows])
        r = torch.where(fwd[:, None], ends[+1][1][rows], ends[-1][1][rows])
        g = torch.where(fwd[:, None], ends[+1][2][rows], ends[-1][2][rows])

        def vg_rows(zz):
            return vg(zz, rows)

        pts = []
        for _ in range(1 << k):
            z, r, U, g = _leapfrog(z, r, g, dirs * eps[rows], inv_mass[rows], vg_rows)
            pts.append((z, r, U))
        for side, sel in ((+1, fwd), (-1, ~fwd)):
            idx = rows[sel]
            ends[side][0][idx], ends[side][1][idx], ends[side][2][idx] = z[sel], r[sel], g[sel]
        zs = torch.stack([p[0] for p in pts], 1).double().cpu()
        rs = torch.stack([p[1] for p in pts], 1).double().cpu()
        Us = torch.stack([p[2] for p in pts], 1).double().cpu()
        for a, j in enumerate(rows.tolist()):
            leaves[j].append((zs[a], rs[a], Us[a]))
    return U0, r0, leaves


def first_leaf_accepted(r0, U0, leaves, treeu, inv_mass, margin):
    """(R,) bools: NUTS accepts its first doubling's one leaf by more than
    ``margin`` in log probability (log u < -dH - margin, no divergence).
    Once it does, the chain has left its start whatever the later doublings
    choose, so a chain that stayed there is stuck."""
    out = []
    for j in range(r0.shape[0]):
        z, r, U = (t[0] for t in leaves[j][0]) if leaves[j] else (None, None, None)
        if z is None:
            out.append(False)
            continue
        H0 = float(U0[j]) + float(_kinetic(inv_mass[j].double().cpu(), r0[j].double().cpu()))
        dH = float(U) + float(_kinetic(inv_mass[j].double().cpu(), r)) - H0
        dH = math.inf if math.isnan(dH) else dH
        out.append(dH <= DIVERGENCE and math.log(max(float(treeu[j, 0, 1]), 1e-12)) < -dH - margin)
    return out
