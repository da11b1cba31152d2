"""The port's collapsed-bound core against the JAX package, float64 on CPU.

The same numpy inputs go through ``ggp_tpu.ops.fused_bound
._rbf_vfe_neg_logpost_vg`` (XLA level, default blocked Cholesky + inverse,
padded layout) and ``ggp_tpu_torch.ops.vfe_bound.rbf_vfe_neg_logpost_vg``
(unpadded), and through autodiff of -(sgpr_elbo + log_prior) in both
packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggp_tpu.kernels import default_rbf as jax_default_rbf
from ggp_tpu.models.sgpr import sgpr_elbo as jax_sgpr_elbo
from ggp_tpu.ops.fused_bound import _rbf_vfe_neg_logpost_vg, block_chol_u
from ggp_tpu.priors import log_prior as jax_log_prior
from ggp_tpu.priors import prior_tree_rbf as jax_prior_tree_rbf
from ggp_tpu_torch.kernels import default_rbf
from ggp_tpu_torch.models.sgpr import sgpr_elbo
from ggp_tpu_torch.ops.linalg import safe_cholesky
from ggp_tpu_torch.ops.vfe_bound import (_build, chol_upper,
                                         rbf_vfe_neg_logpost_vg, vfe_potential)
from ggp_tpu_torch.priors import log_prior, prior_tree_rbf

F64 = torch.float64
# Both sides run the same f64 algebra on a well-conditioned problem (spread
# inducing points); they differ only in summation order and in blocked vs
# LAPACK factorisations, i.e. at ~1e-13 relative. 1e-9 leaves four orders
# of headroom for conditioning without admitting a wrong term (a wrong
# prior constant or chain-rule factor is >= 1e-3 relative).
RTOL = 1e-9

SPECS = {
    "default": None,
    "lognormal_hc_halfnormal": (("lognormal", 0.2, 1.5), ("hc", 2.0),
                                ("half_normal", 1.5)),
    "gamma_flat_hcstd": (("gamma", 3.0, 0.5), ("flat",), ("hc_std", 0.7)),
}


def _problem(seed=0, n=30, m=6, d=3):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d))
    y = np.sin(X @ r.normal(size=d)) + 0.2 * r.normal(size=n)
    Z = X[np.linspace(0, n - 1, m).astype(int)] + 0.05 * r.normal(size=(m, d))
    theta = np.r_[0.2 * r.normal(size=d), 0.3, -1.5]
    return theta, X, y, Z


def _jax_core(theta, X, y, Z, jitter, *, want_z_grad, want_prior,
              pivot_floor, prior_spec):
    n, d = X.shape
    m = Z.shape[0]
    Np, Mp = -(-n // 8) * 8, 32     # any Mp >= m, multiple of 16
    Xp = np.zeros((Np, 128)); Xp[:n, :d] = X
    yp = np.zeros((Np, 1)); yp[:n, 0] = y
    Zp = np.zeros((Mp, 128)); Zp[:m, :d] = Z
    tp = np.zeros((1, 128)); tp[0, :d + 2] = theta
    fn = jax.jit(lambda t, a, b, c: _rbf_vfe_neg_logpost_vg(
        t, a, b, c, n, m, d, jitter, want_z_grad=want_z_grad,
        want_prior=want_prior,
        pivot_floor=None if pivot_floor is None else jnp.asarray(pivot_floor),
        prior_spec=prior_spec))
    out = fn(*(jnp.asarray(a) for a in (tp, Xp, yp, Zp)))
    res = [float(out[0]), np.asarray(out[1])[0, :d + 2]]
    if want_z_grad:
        res.append(np.asarray(out[2])[:m, :d])
    return res


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("want_prior,pivot_floor",
                         [(True, None), (False, 1e-6), (True, 1e-6)])
def test_bound_matches_jax_core(spec, want_prior, pivot_floor):
    theta, X, y, Z = _problem()
    kw = dict(want_z_grad=True, want_prior=want_prior, pivot_floor=pivot_floor,
              prior_spec=SPECS[spec])
    ref = _jax_core(theta, X, y, Z, 1e-8, **kw)
    out = rbf_vfe_neg_logpost_vg(*(torch.tensor(a, dtype=F64)
                                   for a in (theta, X, y, Z)), 1e-8, **kw)
    for a, b in zip(out, ref):
        assert _rel(a.numpy(), b) <= RTOL, (spec, _rel(a.numpy(), b))


def test_bound_matches_autodiff_of_elbo_plus_prior():
    """Both against jax.value_and_grad of -(sgpr_elbo + log_prior) at a
    point where the lengthscale cap is inactive (the cap is a numerical
    guard the autodiff reference does not have). Tolerance 1e-7: the
    reference differentiates through LAPACK Cholesky and triangular solves,
    the port uses its hand adjoint; they agree to ~1e-12 here, 1e-7 keeps
    headroom without admitting a missing term."""
    theta, X, y, Z = _problem(seed=1)
    d = X.shape[1]
    kern = jax_default_rbf(ard=True)
    tree = jax_prior_tree_rbf()

    def neg(v):
        p = {"kernel": {"base": {"log_lengthscale": v[:d]},
                        "log_outputscale": v[d]}, "log_noise": v[d + 1]}
        return -(jax_sgpr_elbo(kern, {**p, "Z": jnp.asarray(Z)}, jnp.asarray(X),
                               jnp.asarray(y), 1e-8) + jax_log_prior(tree, p))

    U_ref, g_ref = jax.jit(jax.value_and_grad(neg))(jnp.asarray(theta))
    U, g = rbf_vfe_neg_logpost_vg(*(torch.tensor(a, dtype=F64)
                                    for a in (theta, X, y, Z)), 1e-8)
    assert _rel(U.numpy(), float(U_ref)) <= 1e-7
    assert _rel(g.numpy(), np.asarray(g_ref)) <= 1e-7


def test_sgpr_elbo_autograd_matches_jax():
    """The port's plain sgpr_elbo + log_prior and its torch.autograd
    gradient equal JAX's value and jax.grad (same algorithm, f64: 1e-10)."""
    theta, X, y, Z = _problem(seed=2)
    d = X.shape[1]

    def unpack(v):
        return {"kernel": {"base": {"log_lengthscale": v[:d]},
                           "log_outputscale": v[d]}, "log_noise": v[d + 1]}

    kj, tj = jax_default_rbf(ard=True), jax_prior_tree_rbf()
    ref_v, ref_g = jax.jit(jax.value_and_grad(lambda v: jax_sgpr_elbo(
        kj, {**unpack(v), "Z": jnp.asarray(Z)}, jnp.asarray(X), jnp.asarray(y),
        1e-8) + jax_log_prior(tj, unpack(v))))(jnp.asarray(theta))
    kt, tt = default_rbf(ard=True), prior_tree_rbf()
    v = torch.tensor(theta, dtype=F64, requires_grad=True)
    val = sgpr_elbo(kt, {**unpack(v), "Z": torch.tensor(Z, dtype=F64)},
                    torch.tensor(X, dtype=F64), torch.tensor(y, dtype=F64),
                    1e-8) + log_prior(tt, unpack(v))
    val.backward()
    assert _rel(val.item(), float(ref_v)) <= 1e-10
    assert _rel(v.grad.numpy(), np.asarray(ref_g)) <= 1e-10


def test_safe_cholesky_nan_on_non_psd():
    K = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=F64)
    assert torch.isnan(safe_cholesky(K)).all()
    assert torch.isnan(chol_upper(K)).all()
    good = safe_cholesky(torch.tensor([[2.0, 1.0], [1.0, 2.0]], dtype=F64))
    assert torch.isfinite(good).all()


def test_floored_factor_matches_block_chol_u():
    """A rank-deficient matrix (duplicated rows) drives pivots below the
    floor: the port's modified Cholesky equals block_chol_u's, including
    the sqrt(floor) e_i rows (1e-12: same unblocked arithmetic)."""
    r = np.random.default_rng(4)
    A = r.normal(size=(16, 5))
    A[7] = A[3]
    A[11] = A[3]
    K = A @ A.T
    floor = 1e-6
    ref = np.asarray(block_chol_u(jnp.asarray(K), pivot_floor=jnp.asarray(floor)))
    out = chol_upper(torch.tensor(K, dtype=F64), floor).numpy()
    assert np.any(np.isclose(np.diag(out), np.sqrt(floor)))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


def test_cpu_potential_runs_plain_and_counts_no_launch():
    theta, X, y, Z = _problem(seed=3)
    t = [torch.tensor(a, dtype=F64) for a in (theta, X, y, Z)]
    before = dict(_build.LAUNCHES)
    U, g = vfe_potential(*t, 1e-8)
    U2, g2 = rbf_vfe_neg_logpost_vg(*t, 1e-8)
    assert torch.equal(U, U2) and torch.equal(g, g2)
    assert _build.LAUNCHES == before
