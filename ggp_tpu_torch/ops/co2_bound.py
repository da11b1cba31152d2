"""Collapsed VFE bound of the Mauna Loa CO2 composite target: value and
analytic gradient over its 11 log-hypers, plain PyTorch beside the CUDA
cores ``Co2M32Core`` / ``Co2RbfCore`` (``csrc/co2_bound.cuh``).

Counterpart of ``ggp_tpu/ops/fused_bound.py`` ``_co2_vfe_neg_logpost_vg``
(the core the fused sampler kernels inline for target ``"co2_m32"`` /
``"co2_rbf"``), ``co2_fused_spec`` and ``make_co2_vfe_potential``. The
kernel is ``kernels.composite.co2_kernel``'s 1-D Sum

  K = s1 Periodic(p=1, lp) RBF(ld) + s2 RBF(lt) + s3 RQ(lm, alpha)
      + s4 Matern32(ln)   [or s4 RBF(ln)]

over ``theta`` (11,) in ravel order ``[log lp, log ld, log s1, log lt,
log s2, log alpha, log lm, log s3, log ln, log s4, log noise]`` (every s_i
a log-variance). The factorisation and the adjoints dF/dKnm, dF/dKmm are
the rbf bound's (:func:`~ggp_tpu_torch.ops.vfe_bound.collapsed_bound`);
the grams and the ten kernel-hyper contractions are elementwise in the
pairwise difference delta = x - z, formed directly: no norm expansion and
no lengthscale cap.
"""

from __future__ import annotations

import math

import torch

from .vfe_bound import _leaf_terms, collapsed_bound, leaf_spec, vfe_potential

__all__ = ["co2_vfe_neg_logpost_vg", "co2_fused_spec", "make_co2_vfe_potential",
           "co2_potential", "SPEC_CO2_DEFAULT", "NOISE_COMPS"]

# the experiment's LogNormal(0, 3) on every hyper
SPEC_CO2_DEFAULT = (("lognormal", 0.0, 3.0),) * 11
NOISE_COMPS = ("m32", "rbf")
_VAR_LANES = (2, 4, 7, 9)          # s1, s2, s3, s4


def _parts(th, a, z, noise_comp):
    """Component grams and the shared elementwise factors for the pairs of
    the 1-D coordinates ``a`` (R,) and ``z`` (M,)."""
    ilp2, ild2, s1 = torch.exp(-2.0 * th[0]), torch.exp(-2.0 * th[1]), torch.exp(th[2])
    ilt2, s2v, al = torch.exp(-2.0 * th[3]), torch.exp(th[4]), torch.exp(th[5])
    ilm2, s3, iln, s4 = torch.exp(-2.0 * th[6]), torch.exp(th[7]), torch.exp(-th[8]), \
        torch.exp(th[9])
    delta = a[:, None] - z[None, :]
    r2 = delta * delta
    sn = torch.sin(math.pi * delta)
    sin2 = sn * sn
    K1 = s1 * torch.exp(-2.0 * sin2 * ilp2 - 0.5 * r2 * ild2)
    K2 = s2v * torch.exp(-0.5 * r2 * ilt2)
    q = r2 * ilm2 / (2.0 * al)
    lnB = torch.log1p(q)
    K3 = s3 * torch.exp(-al * lnB)
    if noise_comp == "m32":
        t = math.sqrt(3.0) * torch.abs(delta) * iln
        e = torch.exp(-t)
        K4 = s4 * (1.0 + t) * e
        d4 = s4 * t * t * e                                  # dK4 / dlog ln
    else:
        K4 = s4 * torch.exp(-0.5 * r2 * iln * iln)
        d4 = K4 * r2 * iln * iln
    Bq = 1.0 + q
    # dK/dtheta_i of the ten kernel lanes
    dK = (K1 * 4.0 * sin2 * ilp2, K1 * r2 * ild2, K1, K2 * r2 * ilt2, K2,
          K3 * (-al * lnB + al * q / Bq), K3 * 2.0 * al * q / Bq, K3, d4, K4)
    return K1 + K2 + K3 + K4, dK


def co2_vfe_neg_logpost_vg(theta, X, y, Z, jitter, *, noise_comp="m32",
                           prior_spec=None, floor=None, want_prior=True):
    """Plain PyTorch potential U = -(ELBO + log prior) and dU/dtheta (11,)
    of the CO2 composite at ``theta``, with X (n, 1), y (n,), Z (m, 1).
    ``noise_comp`` is "m32" or "rbf"; ``prior_spec`` an 11-tuple of leaf
    specs (default: LogNormal(0, 3) on every lane); ``floor`` the modified
    Cholesky's pivot floor (relative to max(sum s_i, 1) on Kmm)."""
    if noise_comp not in NOISE_COMPS:
        raise ValueError(f"noise_comp must be one of {NOISE_COMPS}, got {noise_comp!r}")
    n = X.shape[0]
    x, z = X[:, 0], Z[:, 0]
    Knm, dKnm_parts = _parts(theta, x, z, noise_comp)
    Kmm, dKmm_parts = _parts(theta, z, z, noise_comp)
    s = torch.exp(theta[[2, 4, 7, 9]])
    svar = s[0] + s[1] + s[2] + s[3]                          # the mean diagonal
    s2 = torch.exp(theta[10])
    F, dKnm, dKmm, dlog_noise = collapsed_bound(
        Knm, Kmm, y, s2, n * svar, jitter, torch.clamp(svar, min=1.0), floor)
    jit_gate = jitter * (svar > 1.0).to(X.dtype) * torch.diagonal(dKmm).sum()
    tail = jit_gate - n / (2.0 * s2)
    g = []
    for i in range(10):
        gi = (dKnm * dKnm_parts[i]).sum() + (dKmm * dKmm_parts[i]).sum()
        if i in _VAR_LANES:
            gi = gi + s[_VAR_LANES.index(i)] * tail
        g.append(gi)
    g = torch.stack(g + [dlog_noise])
    if want_prior:
        spec = SPEC_CO2_DEFAULT if prior_spec is None else prior_spec
        terms = [_leaf_terms(spec[i], theta[i]) for i in range(11)]
        F = F + sum(t[0] for t in terms)
        g = g + torch.stack([t[1] for t in terms])
    return -F, -g


def co2_fused_spec(kernel, likelihood, prior_tree):
    """(noise_comp, 11-leaf prior spec) when (kernel, likelihood, priors)
    match the CO2 composite target, else None: the kernel must have
    ``kernels.composite.co2_kernel``'s structure (a Sum of Scale(Periodic
    (period 1) x RBF), Scale(RBF), Scale(RationalQuadratic) and
    Scale(Matern32 | RBF), none ARD), the likelihood Gaussian, and the prior
    tree ``{"kernel": ..., "log_noise": ...}`` with 11 closed-form leaves."""
    from ..kernels.base import RBF, Matern32, Periodic, Product, RationalQuadratic, Scale, Sum
    from ..likelihoods import GaussianLikelihood
    from ..utils.tree import tree_leaves

    if type(likelihood) is not GaussianLikelihood:
        return None
    if not (isinstance(kernel, Sum) and len(kernel.terms) == 4):
        return None
    seas, trend, med, noise = kernel.terms
    ok = (isinstance(seas, Scale) and isinstance(seas.base, Product)
          and len(seas.base.terms) == 2
          and type(seas.base.terms[0]) is Periodic
          and seas.base.terms[0].fixed_period is not None
          and abs(float(seas.base.terms[0].fixed_period) - 1.0) < 1e-12
          and type(seas.base.terms[1]) is RBF and not seas.base.terms[1].ard
          and isinstance(trend, Scale) and type(trend.base) is RBF and not trend.base.ard
          and isinstance(med, Scale) and type(med.base) is RationalQuadratic
          and not med.base.ard
          and isinstance(noise, Scale) and type(noise.base) in (Matern32, RBF)
          and not noise.base.ard)
    if not ok:
        return None
    try:
        if set(prior_tree) != {"kernel", "log_noise"}:
            return None
        leaves = tree_leaves(prior_tree["kernel"]) + [prior_tree["log_noise"]]
    except (KeyError, TypeError):
        return None
    spec = tuple(leaf_spec(p) for p in leaves)
    if len(spec) != 11 or None in spec:
        return None
    return ("m32" if type(noise.base) is Matern32 else "rbf"), spec


def co2_potential(theta, X, y, Z, jitter, *, noise_comp="m32", prior_spec=None,
                  pivot_floor=None):
    """U and dU/dtheta of :func:`co2_vfe_neg_logpost_vg`: its plain version
    on CPU tensors, the co2 potential kernel (``csrc/vfe_potential.cu``,
    site 1) on CUDA tensors, or it raises."""
    return vfe_potential(theta, X, y, Z, jitter, pivot_floor=pivot_floor,
                         prior_spec=prior_spec, core=f"co2_{noise_comp}")


def make_co2_vfe_potential(X, y, jitter, *, noise_comp="m32", prior_spec=None):
    """``potential_fn(theta, Z) -> (U, grad)`` over the 11 CO2 hypers at the
    data (X (n, 1), y), through :func:`co2_potential`; None when X is not
    1-D."""
    if X.ndim != 2 or X.shape[1] != 1:
        return None

    def potential_fn(theta, Z):
        return co2_potential(theta, X, y, Z, jitter, noise_comp=noise_comp,
                             prior_spec=prior_spec)

    return potential_fn
