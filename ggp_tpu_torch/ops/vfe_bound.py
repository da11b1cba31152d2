"""Collapsed VFE bound of the Scale(RBF-ARD) x Gaussian model: value and
analytic gradient, plain PyTorch beside the CUDA kernel ``vfe_potential``.

Counterpart of ``ggp_tpu/ops/fused_bound.py`` ``_rbf_vfe_neg_logpost_vg``
(the core inlined by every fused kernel of the flagship path) and of the
single-evaluation potential kernel of ``ops/fused_nuts.py``
(``_potential_kernel_body``). The port's functions take unpadded inputs:
``theta`` (d+2,) in ravel order ``[log_lengthscale (d), log_outputscale,
log_noise]``, ``X`` (n, d), ``y`` (n,), ``Z`` (m, d).

Gradient (A = L^-1 Kmn / sigma, B = I + A A^T, v = B^-1 A y, w = L^-T v,
alpha = (y - A^T v) / s2):

  dF/dKnm = [A^T (I - B^-1) L^-1 + alpha w^T] / sigma
  dF/dKmm = -w w^T / (2 s2) + L^-T (2I - B - B^-1) L^-1 / 2
  dF/ds2  = ||alpha||^2 / 2 - tr(W) / 2 + t / (2 s2^2)

then the RBF-ARD chain rule. Vectors c, v, w come from triangular solves
against the factors, as in the JAX core.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .linalg import capped_inv_ls, chol_upper
from .sgpmc_bound import sgpmc_neg_logpost_vg

__all__ = ["rbf_vfe_neg_logpost_vg", "collapsed_bound", "vfe_potential",
           "prior_spec_of_tree", "leaf_spec", "prior_terms", "chol_upper",
           "SPEC_RBF_DEFAULT", "CORES", "state_dim", "neg_logpost_vg"]

SPEC_RBF_DEFAULT = (("gamma", 2.0, 1.0), ("hc_std", 1.0), ("hc_std", 1.0))
# Potentials the kernels carry (``make_fused_nuts(target=...)``): the
# collapsed bound over the d+2 log-hypers, the whitened JointHMC target
# over the hypers and the m whitened inducing values (ops/sgpmc_bound.py),
# the dense GP marginal over the d+2 log-hypers (ops/gpr_bound.py), and the
# collapsed bound of the Mauna Loa CO2 composite over its 11 log-hypers with
# a Matern32 or an RBF noise component (ops/co2_bound.py).
CORES = ("vfe", "sgpmc", "gpr", "co2_m32", "co2_rbf")


def leaf_spec(p):
    """("family", *params) of one prior leaf with a closed form here, else
    None."""
    from ..priors import (Flat, Gamma, HalfCauchy, HalfCauchyOnStd,
                          HalfNormal, LogNormal)
    if isinstance(p, Gamma):
        return ("gamma", float(p.alpha), float(p.beta))
    if isinstance(p, HalfCauchyOnStd):
        return ("hc_std", float(p.scale))
    if isinstance(p, HalfCauchy):
        return ("hc", float(p.scale))
    if isinstance(p, HalfNormal):
        return ("half_normal", float(p.scale))
    if isinstance(p, LogNormal):
        return ("lognormal", float(p.mu), float(p.sigma))
    if isinstance(p, Flat):
        return ("flat",)
    return None


def prior_spec_of_tree(prior_tree):
    """Static spec (ls, outputscale, noise) of a Scale(RBF-ARD) x Gaussian
    prior tree, each leaf a ("family", *params) tuple; None when the tree
    has another structure or a family without a closed form here."""
    leaf = leaf_spec
    try:
        if set(prior_tree) != {"kernel", "log_noise"} \
                or set(prior_tree["kernel"]) != {"log_outputscale", "base"} \
                or set(prior_tree["kernel"]["base"]) != {"log_lengthscale"}:
            return None
        spec = (leaf(prior_tree["kernel"]["base"]["log_lengthscale"]),
                leaf(prior_tree["kernel"]["log_outputscale"]),
                leaf(prior_tree["log_noise"]))
    except (KeyError, TypeError):
        return None
    return None if None in spec else spec


_KINDS = ("gamma", "hc_std", "hc", "half_normal", "lognormal", "flat")  # csrc PriorKind


def _leaf_params(leaf):
    """(p1, p2, c) of one prior leaf ``("family", *params)``: the constants
    of its closed form, as the plain version and the kernels both read them."""
    kind = leaf[0]
    if kind == "gamma":
        a, b = leaf[1], leaf[2]
        return a, b, a * math.log(b) - math.lgamma(a)
    if kind == "hc_std":
        s = leaf[1]
        return 2.0 * math.log(s), 0.0, math.log(2.0 / (math.pi * s)) + math.log(0.5)
    if kind == "hc":
        s = leaf[1]
        return math.log(s), 0.0, math.log(2.0 / (math.pi * s))
    if kind == "half_normal":
        s = leaf[1]
        return s * s, 0.0, 0.5 * math.log(2.0 / math.pi) - math.log(s)
    if kind == "lognormal":
        mu, sg = leaf[1], leaf[2]
        return mu, sg, -math.log(sg) - 0.5 * math.log(2.0 * math.pi)
    if kind == "flat":
        return 0.0, 0.0, 0.0
    raise ValueError(f"unknown prior family {kind!r}")


def _leaf_terms(leaf, u):
    """Elementwise (log density, d/du) of one prior leaf at unconstrained u
    (closed forms of the priors.py densities, log-Jacobian included; the
    arithmetic of ``prior_leaf`` in csrc/vfe_bound.cuh)."""
    kind, (p1, p2, c) = leaf[0], _leaf_params(leaf)
    if kind == "gamma":
        eu = torch.exp(u)
        return c + p1 * u - p2 * eu, p1 - p2 * eu
    if kind == "hc_std":
        t = u - p1
        return c + 0.5 * u - torch.log1p(torch.exp(t)), 0.5 - torch.sigmoid(t)
    if kind == "hc":
        t = 2.0 * (u - p1)
        return c + u - torch.log1p(torch.exp(t)), 1.0 - 2.0 * torch.sigmoid(t)
    if kind == "half_normal":
        e2u = torch.exp(2.0 * u) / p1
        return c + u - 0.5 * e2u, 1.0 - e2u
    if kind == "lognormal":
        z = (u - p1) / p2
        return c - 0.5 * z * z, -z / p2
    return torch.zeros_like(u), torch.zeros_like(u)            # flat


def prior_terms(theta, d, prior_spec=None):
    """(log prior, d log prior / d theta) under a static spec."""
    sp = SPEC_RBF_DEFAULT if prior_spec is None else prior_spec
    lp_ls, g_ls = _leaf_terms(sp[0], theta[:d])
    lp_os, g_os = _leaf_terms(sp[1], theta[d])
    lp_n, g_n = _leaf_terms(sp[2], theta[d + 1])
    return lp_ls.sum() + lp_os + lp_n, torch.cat([g_ls, g_os[None], g_n[None]])


def prior_leaf_doubles(prior_spec=None):
    """The doubles (kind, p1, p2, c) per leaf the kernels read: 12 for the
    three leaves of the rbf spec (the default), 44 for a co2 spec."""
    out = []
    for leaf in (SPEC_RBF_DEFAULT if prior_spec is None else prior_spec):
        out += [float(_KINDS.index(leaf[0])), *map(float, _leaf_params(leaf))]
    return out


def _tri(U, b, *, trans=False):
    """Solve U x = b (or U^T x = b) for upper-triangular U, vector b."""
    A = U.T if trans else U
    return torch.linalg.solve_triangular(A, b[:, None], upper=not trans)[:, 0]


def collapsed_bound(Knm, Kmm, y, s2, kdiag_sum, jitter, jit_scale, pivot_floor=None):
    """The kernel-agnostic part of the collapsed bound from the grams Knm (n,
    m) and Kmm (m, m), shared by the rbf and the co2 potentials: the value F
    and its adjoints (dF/dKnm, dF/dKmm, dF/dlog_noise). ``kdiag_sum`` is sum_i
    k(x_i, x_i); Kmm is factorised with jitter * jit_scale on its diagonal
    (the modified Cholesky, floor ``pivot_floor * jit_scale``, with
    ``pivot_floor``)."""
    n, m = Knm.shape
    eye = torch.eye(m, dtype=Knm.dtype, device=Knm.device)
    sigma = torch.sqrt(s2)
    Kmm_j = Kmm + (jitter * jit_scale) * eye
    U = chol_upper(Kmm_j, None if pivot_floor is None else pivot_floor * jit_scale)
    V = torch.linalg.solve_triangular(U, eye, upper=True)        # L^-T
    An = Knm @ V / sigma
    B = An.T @ An + eye
    UB = chol_upper(B, pivot_floor)
    VB = torch.linalg.solve_triangular(UB, eye, upper=True)
    Binv = VB @ VB.T
    u = An.T @ y
    c = _tri(UB, u, trans=True)
    v = _tri(UB, c)
    w = _tri(U, v)
    alpha = (y - An @ v) / s2

    logdetB = 2.0 * torch.log(torch.diagonal(UB)).sum()
    trB = torch.diagonal(B).sum()
    trBinv = torch.diagonal(Binv).sum()
    t_term = kdiag_sum - s2 * (trB - m)
    F = (-0.5 * n * torch.log(2.0 * math.pi * s2) - 0.5 * logdetB
         - 0.5 * ((y * y).sum() - (c * c).sum()) / s2 - 0.5 * t_term / s2)

    Y1 = (eye - Binv) @ V.T
    dKnm = (An @ Y1 + alpha[:, None] * w[None, :]) / sigma
    T0 = 2.0 * eye - B - Binv
    dKmm = -torch.outer(w, w) / (2.0 * s2) + 0.5 * (V @ T0) @ V.T
    trW = (n - m + trBinv) / s2
    dF_ds2 = 0.5 * (alpha * alpha).sum() - 0.5 * trW + t_term / (2.0 * s2 * s2)
    return F, dKnm, dKmm, dF_ds2 * s2


def rbf_vfe_neg_logpost_vg(theta, X, y, Z, jitter, *, want_z_grad=False,
                           want_prior=True, pivot_floor=None, prior_spec=None):
    """Plain PyTorch potential U = -(ELBO + log prior) and dU/dtheta
    (+ dU/dZ with ``want_z_grad``). ``want_prior=False`` drops the prior
    (the ML-II training objective); ``pivot_floor`` selects the trainers'
    modified Cholesky (relative to max(sf2, 1) on Kmm)."""
    n, d = X.shape
    dt = X.dtype
    log_os, log_noise = theta[d], theta[d + 1]
    inv_ls = capped_inv_ls(theta[:d], X, Z)
    sf2 = torch.exp(log_os)
    s2 = torch.exp(log_noise)

    Xs, Zs = X * inv_ls, Z * inv_ls
    Xs2, Zs2 = Xs * Xs, Zs * Zs
    xn, zn = Xs2.sum(1), Zs2.sum(1)
    Knm = sf2 * torch.exp(-0.5 * torch.clamp(xn[:, None] + zn[None, :]
                                             - 2.0 * Xs @ Zs.T, min=0.0))
    Kmm = sf2 * torch.exp(-0.5 * torch.clamp(zn[:, None] + zn[None, :]
                                             - 2.0 * Zs @ Zs.T, min=0.0))
    F, dKnm, dKmm, dlog_noise = collapsed_bound(
        Knm, Kmm, y, s2, n * sf2, jitter, torch.clamp(sf2, min=1.0), pivot_floor)
    dlog_os = ((dKmm * Kmm).sum() + (dKnm * Knm).sum()
               + jitter * sf2 * (sf2 > 1.0).to(dt) * torch.diagonal(dKmm).sum()
               - n * sf2 / (2.0 * s2))
    Pmm, Pnm = dKmm * Kmm, dKnm * Knm
    rs_mm, cs_mm = Pmm.sum(1), Pmm.sum(0)
    rs_nm, cs_nm = Pnm.sum(1), Pnm.sum(0)
    dls = (rs_mm @ Zs2 + cs_mm @ Zs2 - 2.0 * (Zs * (Pmm @ Zs)).sum(0)
           + rs_nm @ Xs2 + cs_nm @ Zs2 - 2.0 * (Xs * (Pnm @ Zs)).sum(0))
    g = torch.cat([dls, dlog_os[None], dlog_noise[None]])
    if want_prior:
        lp, gp = prior_terms(theta, d, prior_spec)
        F = F + lp
        g = g + gp
    if not want_z_grad:
        return -F, -g
    dZs = (-2.0 * (rs_mm[:, None] * Zs - Pmm @ Zs)
           - (cs_nm[:, None] * Zs - Pnm.T @ Xs))
    return -F, -g, -(dZs * inv_ls)


def state_dim(core, d, m):
    """Length of one state row of ``core``: d+2 log-hypers, and for
    ``"sgpmc"`` the m whitened inducing values after them; the co2 cores'
    11 log-hypers."""
    if core not in CORES:
        raise ValueError(f"core must be one of {CORES}, got {core!r}")
    if core.startswith("co2"):
        return 11
    return d + 2 + (m if core == "sgpmc" else 0)


def neg_logpost_vg(core, z, X, y, Z, jitter, *, want_z_grad=False,
                   want_prior=True, pivot_floor=None, prior_spec=None):
    """The plain potential of ``core`` at one state row. The sgpmc core's
    Gamma(2,1) hyperpriors are fixed (``prior_spec`` does not apply); the
    gpr core reads no Z and takes none of the trainers' options; the co2
    cores have no Z gradient and take an 11-leaf ``prior_spec``."""
    kw = dict(want_z_grad=want_z_grad, want_prior=want_prior,
              pivot_floor=pivot_floor)
    if core.startswith("co2"):
        from .co2_bound import co2_vfe_neg_logpost_vg
        _check_co2_options(want_z_grad)
        return co2_vfe_neg_logpost_vg(z, X, y, Z, jitter, noise_comp=core[4:],
                                      prior_spec=prior_spec, floor=pivot_floor,
                                      want_prior=want_prior)
    if core == "gpr":
        from .gpr_bound import gpr_neg_logpost_vg
        _check_gpr_options(**kw)
        return gpr_neg_logpost_vg(z, X, y, jitter, prior_spec=prior_spec)
    if core == "sgpmc":
        return sgpmc_neg_logpost_vg(z, X, y, Z, jitter, **kw)
    return rbf_vfe_neg_logpost_vg(z, X, y, Z, jitter, prior_spec=prior_spec, **kw)


def _check_gpr_options(want_z_grad, want_prior, pivot_floor):
    if want_z_grad or not want_prior or pivot_floor is not None:
        raise ValueError("the gpr core is a sampler target: no Z gradient, "
                         "no pivot floor, always with its prior")


def _check_co2_options(want_z_grad):
    if want_z_grad:
        raise ValueError("the co2 cores are sampler targets: no Z gradient")


def bound_cfg(n, m, d, jitter, *, want_z_grad, want_prior, pivot_floor,
              prior_spec, core="vfe", **extra):
    """The kernels' cfg array for one bound configuration; a co2 core reads
    its 11 prior leaves from ``LANE_PRIOR``."""
    if core.startswith("co2"):
        from .co2_bound import SPEC_CO2_DEFAULT
        priors = dict(LANE_PRIOR=prior_leaf_doubles(prior_spec or SPEC_CO2_DEFAULT))
    else:
        priors = dict(PRIOR=prior_leaf_doubles(prior_spec))
    return _build.cfg_array(
        N=n, M=m, D=d, JITTER=jitter,
        FLOOR=0.0 if pivot_floor is None else pivot_floor,
        WANT_PRIOR=int(want_prior), WANT_ZGRAD=int(want_z_grad), **priors, **extra)


def _check_shapes(name, z, X, y, Z, core="vfe"):
    """Raise unless the shapes fit ``core``. The gpr core has no inducing
    points: it takes an empty Z of shape (0, d) (``GPR_HMC`` passes one)."""
    n, d = X.shape
    if Z.ndim != 2 or Z.shape[1] != d or y.shape != (n,):
        raise ValueError(f"{name}: shapes X {tuple(X.shape)}, y {tuple(y.shape)}, "
                         f"Z {tuple(Z.shape)} do not fit (n,d), (n,), (m,d)")
    if (core == "gpr") != (Z.shape[0] == 0):
        raise ValueError(f"{name}: the gpr core takes an empty Z (0, d), every "
                         f"other core m >= 1 rows; got {tuple(Z.shape)}")
    if core.startswith("co2") and d != 1:
        raise ValueError(f"{name}: the co2 cores take 1-D inputs, got d={d}")
    dim = state_dim(core, d, Z.shape[0])
    if z.shape != (dim,):
        raise ValueError(f"{name}: a {core} state row is ({dim},), got {tuple(z.shape)}")
    if dim > 128:
        raise ValueError(f"{name}: state length {dim} exceeds 128")


def call_potential(core, zs, X, y, Z, jitter, *, want_z_grad=False,
                   want_prior=True, pivot_floor=None, prior_spec=None, stages=0):
    """One launch of the potential kernel of ``core`` (``csrc/vfe_potential.cu``)
    on the C rows of ``zs`` (C, dim), one block each. Returns (U (C,), g (C,
    dim)[, dU/dZ (C, m, d)]). ``stages`` > 0 stops the gpr core after that
    many of its six parts (``csrc/gpr_bound.cuh``), whose outputs are then
    not filled: it exists to time where one evaluation's time goes."""
    n, d = X.shape
    m = Z.shape[0]
    C, dim = zs.shape
    out = torch.empty((C, dim + 1), dtype=X.dtype, device=X.device)
    dZ = (torch.empty((C, m, d), dtype=X.dtype, device=X.device)
          if want_z_grad else None)
    work = _build.scratch(n, m, d, 0, X, chains=C, core=core)
    cfg = bound_cfg(n, m, d, jitter, want_z_grad=want_z_grad,
                    want_prior=want_prior, pivot_floor=pivot_floor,
                    prior_spec=prior_spec, core=core, CHAINS=C, STAGES=stages)
    P = _build.ptr
    err = _build.kernel_fn(f"ggp_potential_{core}", X.dtype)(
        ctypes.cast(cfg, ctypes.c_void_p), P(zs), P(X), P(y), P(Z), P(out),
        P(dZ), P(work), _build.stream_ptr(X.device))
    _build.check(err, f"{core} potential")
    res = (out[:, 0].contiguous(), out[:, 1:].contiguous())
    return res + (dZ,) if want_z_grad else res


def vfe_potential(theta, X, y, Z, jitter, *, want_z_grad=False,
                  want_prior=True, pivot_floor=None, prior_spec=None,
                  core="vfe"):
    """U and dU/dz (and dU/dZ) of :func:`neg_logpost_vg` at one state row
    of ``core`` (the potential kernel, site 1, of each core).

    CPU tensors run the plain version; CUDA tensors launch the potential
    kernel (``csrc/vfe_potential.cu``) at grid 1 or raise."""
    _check_shapes(f"{core} potential", theta, X, y, Z, core)
    if core == "gpr":
        _check_gpr_options(want_z_grad, want_prior, pivot_floor)
    if core.startswith("co2"):
        _check_co2_options(want_z_grad)
    kw = dict(want_z_grad=want_z_grad, want_prior=want_prior,
              pivot_floor=pivot_floor, prior_spec=prior_spec)
    if X.device.type == "cpu":
        return neg_logpost_vg(core, theta, X, y, Z, jitter, **kw)
    _build.require_cuda(f"{core} potential", X.dtype, theta, X, y, Z)
    out = call_potential(core, theta[None], X, y, Z, jitter, **kw)
    _build.LAUNCHES[_build.launch_key(core, "potential")] += 1
    return tuple(a[0] for a in out)
