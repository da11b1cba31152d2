"""BayesianSparseGPR_HMC end to end on CPU: the port against the JAX model
(n=60, d=3, m=10), float64 unless stated."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggp_tpu.models import BayesianSparseGPR_HMC as JaxModel
from ggp_tpu_torch import BayesianSparseGPR_HMC
from ggp_tpu_torch.interop import params_from_jax, params_to_numpy
from ggp_tpu_torch.ops import _build

N, D, M = 60, 3, 10
# Both packages run the same f64 trainer math (autodiff vs hand adjoint,
# ~1e-12 per step); Adam's sqrt(v) normalisation amplifies differences for
# near-zero gradient components over the steps, so 1e-7.
RTOL = 1e-7


def _data(seed=0):
    r = np.random.default_rng(seed)
    X = r.normal(size=(N, D))
    y = np.sin(X @ r.normal(size=D)) + 0.2 * r.normal(size=N)
    Z = X[np.linspace(0, N - 1, M).astype(int)] + 0.05 * r.normal(size=(M, D))
    return X, y, Z


def _trace(S, seed=1):
    r = np.random.default_rng(seed)
    return {"kernel": {"base": {"log_lengthscale": 0.3 + 0.1 * r.normal(size=(S, D))},
                       "log_outputscale": 0.2 + 0.1 * r.normal(size=S)},
            "log_noise": -2.0 + 0.1 * r.normal(size=S)}


def _jax_tree(tr):
    return jax.tree_util.tree_map(jnp.asarray, tr)


def _models(seed=0):
    X, y, Z = _data(seed)
    return (JaxModel(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z)),
            BayesianSparseGPR_HMC(torch.tensor(X), torch.tensor(y), torch.tensor(Z)),
            X, y, Z)


def test_warm_start_matches_jax():
    jm, tm, *_ = _models()
    assert jm.jitter == tm.jitter == 1e-8
    lj = jm.warm_start(num_steps=15, lr=0.01)
    lt = tm.warm_start(num_steps=15, lr=0.01)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL)
    np.testing.assert_allclose(tm.theta.numpy(),
                               params_from_jax(jax.device_get(jm.hypers)).numpy(),
                               rtol=RTOL)
    np.testing.assert_allclose(tm.Z.numpy(), np.asarray(jm.Z), rtol=RTOL)


def test_optimize_z_matches_jax_at_shared_trace():
    jm, tm, *_ = _models(seed=1)
    tr = _trace(6)
    jm.trace = _jax_tree(tr)
    tm.trace = params_from_jax(tr)
    lj = jm.optimize_Z(num_steps=8, lr=0.02)
    lt = tm.optimize_Z(num_steps=8, lr=0.02)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL)
    np.testing.assert_allclose(tm.Z.numpy(), np.asarray(jm.Z), rtol=RTOL)


def test_mixture_predictive_matches_jax_at_shared_trace_and_z():
    """Same algorithm (Cholesky, triangular solves) on both sides: 1e-10."""
    jm, tm, X, *_ = _models(seed=2)
    tr = _trace(5, seed=3)
    tr["log_noise"][2] = 800.0           # exp overflows: component masked out
    jm.trace = _jax_tree(tr)
    tm.trace = params_from_jax(tr)
    Xt = np.random.default_rng(4).normal(size=(7, D))
    mj, vj = jm.mixture_posterior_predictive(jnp.asarray(Xt))
    mt, vt = tm.mixture_posterior_predictive(torch.tensor(Xt))
    assert mt.shape == tuple(mj.shape)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10)


def test_short_train_model_stays_finite_and_counts_no_launch():
    X, y, Z = _data(seed=5)
    tm = BayesianSparseGPR_HMC(torch.tensor(X), torch.tensor(y), torch.tensor(Z))
    before = dict(_build.LAUNCHES)
    losses = tm.train_model(max_steps=30, hmc_scheduler=[20, 25],
                            generator=torch.Generator().manual_seed(0))
    assert _build.LAUNCHES == before
    assert losses.shape == (30,) and torch.isfinite(losses).all()
    assert tm.trace.shape == (20, D + 2) and torch.isfinite(tm.trace).all()
    assert float(tm.stats["diverging"].float().mean()) <= 0.1
    mu, var = tm.mixture_posterior_predictive(torch.tensor(X))
    assert mu.shape == (20, N) and torch.isfinite(mu).all() and (var > 0).all()
    m1, v1 = tm.posterior_predictive(torch.tensor(X))
    assert torch.isfinite(m1).all() and (v1 > 0).all()


def _ks(a, b):
    grid = np.sort(np.concatenate([a, b]))
    fa = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    fb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return float(np.max(np.abs(fa - fb)))


def test_sampler_marginals_match_jax_sampler():
    """One posterior (fixed Z and data), 200 warmup + 200 draws per side
    with fixed seeds: every marginal's two-sample KS statistic < 0.3
    (draws are autocorrelated, so this is a loose test of the same target;
    a wrong potential or adaptation shifts marginals far beyond it)."""
    jm, tm, *_ = _models(seed=6)
    jm.hypers = jax.tree_util.tree_map(
        lambda a: a + 0.0, {"kernel": {"base": {"log_lengthscale": jnp.zeros(D)},
                                       "log_outputscale": jnp.asarray(0.0)},
                            "log_noise": jnp.asarray(-1.0)})
    tm.theta = params_from_jax(jax.device_get(jm.hypers))
    jtr = jm.sample_hypers(200, 200, key=jax.random.PRNGKey(0))
    ttr = tm.sample_hypers(200, 200, torch.Generator().manual_seed(0))
    a = params_from_jax(jax.device_get(jtr)).numpy()
    b = ttr.numpy()
    for j in range(D + 2):
        assert _ks(a[:, j], b[:, j]) < 0.3, (j, _ks(a[:, j], b[:, j]))


def test_interop_round_trip():
    tr = _trace(4, seed=7)
    theta = params_from_jax(tr)
    assert theta.shape == (4, D + 2)
    back = params_to_numpy(theta)
    for path in (("kernel", "base", "log_lengthscale"), ("kernel", "log_outputscale"),
                 ("log_noise",)):
        a, b = tr, back
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b)
    Z = np.arange(6.0).reshape(2, 3)
    t1, Zt = params_from_jax(jax.tree_util.tree_map(lambda v: v[0], tr), Z,
                             dtype=torch.float32)
    h, Zb = params_to_numpy(t1, Zt)
    assert Zt.dtype == torch.float32 and np.array_equal(Zb, Z)
    np.testing.assert_allclose(h["log_noise"], tr["log_noise"][0], rtol=1e-7)


def test_import_leaves_jax_out():
    code = ("import sys, ggp_tpu_torch, ggp_tpu_torch.interop, "
            "ggp_tpu_torch.utils.metrics, ggp_tpu_torch.utils.posterior_predictive, "
            "ggp_tpu_torch.inference.diagnostics; "
            "assert 'jax' not in sys.modules and 'ggp_tpu' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_wrappers_refuse_bad_inputs_without_fallback(dtype):
    """A tensor that is not on the CPU never reaches the plain version: the
    wrappers raise on the meta device (no card here) instead of computing."""
    from ggp_tpu_torch.ops.vfe_bound import vfe_potential
    X = torch.zeros((5, 2), dtype=dtype, device="meta")
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        vfe_potential(torch.zeros(4, dtype=dtype, device="meta"), X,
                      torch.zeros(5, dtype=dtype, device="meta"),
                      torch.zeros((3, 2), dtype=dtype, device="meta"), 1e-6)
