"""The port's building blocks against the JAX package, float64 on CPU:
kernels, priors, likelihood, dense linear algebra, metrics, mixture
summaries, sampler diagnostics, data normalisation and the numerics policy.

Both sides evaluate the same closed forms on the same numpy inputs, so the
tolerance is 1e-12 relative (summation order only); the diagnostics are the
same numpy code and must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggp_tpu.priors as jpriors
from ggp_tpu.config import default_jitter as jax_default_jitter
from ggp_tpu.inference import diagnostics as jdiag
from ggp_tpu.kernels import default_rbf as jax_default_rbf
from ggp_tpu.likelihoods import GaussianLikelihood as JaxGaussian
from ggp_tpu.ops import linalg as jlinalg
from ggp_tpu.utils import metrics as jmetrics
from ggp_tpu.utils import posterior_predictive as jpp
from ggp_tpu.utils.datasets import normalize as jax_normalize
from ggp_tpu_torch import config, priors
from ggp_tpu_torch.inference import diagnostics
from ggp_tpu_torch.kernels import default_rbf, sq_dist
from ggp_tpu_torch.likelihoods import GaussianLikelihood
from ggp_tpu_torch.ops import linalg
from ggp_tpu_torch.utils import metrics, posterior_predictive
from ggp_tpu_torch.utils.datasets import normalize

F64 = torch.float64
RTOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=1e-14)


def _moments(seed=0, S=6, n=9):
    r = np.random.default_rng(seed)
    return r.normal(size=(S, n)), 0.1 + r.uniform(size=(S, n)), r.normal(size=n)


@pytest.mark.parametrize("y_std", [1.0, 2.5])
def test_metrics_match_jax(y_std):
    means, vars_, y = _moments()
    _close(metrics.rmse(_t(means[0]), _t(y), y_std), jmetrics.rmse(means[0], y, y_std))
    _close(metrics.nlpd(_t(means[0]), _t(vars_[0]), _t(y), y_std),
           jmetrics.nlpd(means[0], vars_[0], y, y_std))
    _close(metrics.nlpd_mixture(_t(means), _t(vars_), _t(y), y_std),
           jmetrics.nlpd_mixture(means, vars_, y, y_std))


def test_mixture_summaries_match_jax():
    means, vars_, y = _moments(seed=1)
    for a, b in zip(posterior_predictive.get_posterior_predictive_means_stds(_t(means), _t(vars_)),
                    jpp.get_posterior_predictive_means_stds(jnp.asarray(means), jnp.asarray(vars_))):
        _close(a, b)
    _close(posterior_predictive.log_predictive_mixture_density(_t(means), _t(vars_), _t(y)),
           jpp.log_predictive_mixture_density(jnp.asarray(means), jnp.asarray(vars_),
                                              jnp.asarray(y)))


@pytest.mark.parametrize("chains", [1, 3])
def test_diagnostics_equal_jax(chains):
    r = np.random.default_rng(2)
    x = np.zeros((chains, 300))
    for t in range(1, 300):                       # AR(1) chains, rho 0.7
        x[:, t] = 0.7 * x[:, t - 1] + r.normal(size=chains)
    assert diagnostics.effective_sample_size(x) == jdiag.effective_sample_size(x)
    assert diagnostics.split_rhat(x) == jdiag.split_rhat(x)


def test_rbf_gram_and_sq_dist_match_jax():
    r = np.random.default_rng(3)
    X1, X2 = r.normal(size=(7, 4)), r.normal(size=(5, 4))
    jk, tk = jax_default_rbf(ard=True), default_rbf(ard=True)
    p = {"log_outputscale": 0.4, "base": {"log_lengthscale": 0.3 * r.normal(size=4)}}
    pj = {"log_outputscale": jnp.asarray(p["log_outputscale"]),
          "base": {"log_lengthscale": jnp.asarray(p["base"]["log_lengthscale"])}}
    pt = {"log_outputscale": torch.tensor(p["log_outputscale"], dtype=F64),
          "base": {"log_lengthscale": _t(p["base"]["log_lengthscale"])}}
    _close(tk.gram(pt, _t(X1), _t(X2)), jk.gram(pj, jnp.asarray(X1), jnp.asarray(X2)))
    _close(tk.diag(pt, _t(X1)), jk.diag(pj, jnp.asarray(X1)))
    assert float(sq_dist(_t(X1), _t(X1)).min()) >= 0.0     # clamped at 0
    init = tk.init_params(4, dtype=F64, device="cpu")
    assert init["base"]["log_lengthscale"].shape == (4,)


@pytest.mark.parametrize("name,args", [
    ("Gamma", (2.0, 1.0)), ("Gamma", (3.0, 0.5)), ("HalfCauchy", (1.5,)),
    ("HalfNormal", (0.7,)), ("LogNormal", (0.2, 1.3)), ("HalfCauchyOnStd", (1.0,)),
    ("Flat", ()),
])
def test_prior_densities_match_jax(name, args):
    u = np.linspace(-3.0, 3.0, 7)
    _close(getattr(priors, name)(*args).logpdf_unconstrained(_t(u)),
           getattr(jpriors, name)(*args).logpdf_unconstrained(jnp.asarray(u)))


def test_log_prior_tree_matches_jax():
    r = np.random.default_rng(4)
    p = {"kernel": {"base": {"log_lengthscale": r.normal(size=3)},
                    "log_outputscale": np.float64(0.3)}, "log_noise": np.float64(-1.2)}
    pt = {"kernel": {"base": {"log_lengthscale": _t(p["kernel"]["base"]["log_lengthscale"])},
                     "log_outputscale": _t(p["kernel"]["log_outputscale"])},
          "log_noise": _t(p["log_noise"])}
    pj = {"kernel": {"base": {"log_lengthscale": jnp.asarray(p["kernel"]["base"]["log_lengthscale"])},
                     "log_outputscale": jnp.asarray(p["kernel"]["log_outputscale"])},
          "log_noise": jnp.asarray(p["log_noise"])}
    _close(priors.log_prior(priors.prior_tree_rbf(), pt),
           jpriors.log_prior(jpriors.prior_tree_rbf(), pj))


def test_gaussian_likelihood_matches_jax():
    r = np.random.default_rng(5)
    f, y, var = r.normal(size=6), r.normal(size=6), 0.1 + r.uniform(size=6)
    tl, jl = GaussianLikelihood(), JaxGaussian()
    pt, pj = {"log_noise": torch.tensor(-0.7, dtype=F64)}, {"log_noise": jnp.asarray(-0.7)}
    _close(tl.log_prob(pt, _t(f), _t(y)), jl.log_prob(pj, jnp.asarray(f), jnp.asarray(y)))
    for a, b in zip(tl.predictive(pt, _t(f), _t(var)),
                    jl.predictive(pj, jnp.asarray(f), jnp.asarray(var))):
        _close(a, b)
    assert tl.init_params(dtype=F64, device="cpu")["log_noise"].dtype == F64


@pytest.mark.parametrize("lower,trans", [(True, False), (True, True), (False, False)])
def test_linalg_matches_jax(lower, trans):
    r = np.random.default_rng(6)
    A = r.normal(size=(6, 6))
    K = A @ A.T + 0.5 * np.eye(6)
    _close(linalg.add_jitter(_t(K), 1e-3, relative=True),
           jlinalg.add_jitter(jnp.asarray(K), 1e-3, relative=True))
    L = linalg.safe_cholesky(_t(K), 1e-6, relative=True)
    _close(L, jlinalg.safe_cholesky(jnp.asarray(K), 1e-6, relative=True))
    T = L if lower else L.T
    for b in (r.normal(size=6), r.normal(size=(6, 3))):
        _close(linalg.tri_solve(T, _t(b), lower=lower, trans=trans),
               jlinalg.tri_solve(jnp.asarray(T.numpy()), jnp.asarray(b), lower=lower,
                                 trans=trans))


def test_normalize_and_numerics_policy_match_jax():
    A = np.random.default_rng(7).normal(size=(11, 3)) * 3.0 + 1.0
    for a, b in zip(normalize(A), jax_normalize(A)):
        np.testing.assert_array_equal(a, b)
    assert config.BASE_SEED == 173
    assert config.default_jitter(torch.float32) == jax_default_jitter(jnp.float32)
    assert config.default_jitter(torch.float64) == jax_default_jitter(jnp.float64)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
