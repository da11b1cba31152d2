"""The port's Adam chunks against the JAX package's trainers.

``sgpr_adam_chunk_plain`` (the warm start's (theta, Z) trainer) against
``bayesian_sgpr_hmc._adam_all`` with the warm start's optax chain
(zero_nans, clip_by_global_norm(10), adam), and ``z_adam_chunk_plain``
(optimize_Z) against ``_adam_Z`` (zero_nans, adam), both float64 at XLA
level; the interpret-mode Pallas kernels they replace in float32 (slow).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggp_tpu.kernels import default_rbf as jax_default_rbf
from ggp_tpu.models.bayesian_sgpr_hmc import _adam_all, _adam_Z
from ggp_tpu_torch.interop import params_from_jax
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.sgpr_adam import (sgpr_adam_chunk, sgpr_adam_chunk_plain,
                                         z_adam_chunk, z_adam_chunk_plain)

F64 = torch.float64
JITTER, LR = 1e-8, 0.05
# f64 on both sides; the reference differentiates -ELBO by autodiff through
# LAPACK, the port uses the hand adjoint (agreement ~1e-12 per step). Adam
# divides by sqrt(v), which turns small gradient differences into larger
# step differences for components near zero gradient; 1e-7 covers 7 steps.
RTOL = 1e-7


def _problem(seed=0, n=30, m=6, d=3):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d))
    y = np.sin(X @ r.normal(size=d)) + 0.2 * r.normal(size=n)
    Z = X[np.linspace(0, n - 1, m).astype(int)] + 0.05 * r.normal(size=(m, d))
    hypers = {"kernel": {"base": {"log_lengthscale": 0.2 * r.normal(size=d)},
                         "log_outputscale": np.float64(0.3)},
              "log_noise": np.float64(-1.0)}
    return hypers, X, y, Z


def _jax_params(hypers, Z):
    return {"kernel": {"base": {"log_lengthscale":
                                jnp.asarray(hypers["kernel"]["base"]["log_lengthscale"])},
                       "log_outputscale": jnp.asarray(hypers["kernel"]["log_outputscale"])},
            "log_noise": jnp.asarray(hypers["log_noise"]), "Z": jnp.asarray(Z)}


def _trace(seed, S, d):
    r = np.random.default_rng(seed)
    return {"kernel": {"base": {"log_lengthscale": 0.2 * r.normal(size=(S, d))},
                       "log_outputscale": 0.3 + 0.1 * r.normal(size=S)},
            "log_noise": -1.0 + 0.1 * r.normal(size=S)}


def test_sgpr_chunk_matches_adam_all():
    hypers, X, y, Z = _problem()
    opt = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(10.0), optax.adam(LR))
    p_ref, l_ref = _adam_all(jax_default_rbf(ard=True), jnp.asarray(X), jnp.asarray(y),
                             JITTER, _jax_params(hypers, Z), opt, 7)
    theta, Zt = params_from_jax(hypers, Z)
    zt, zz = torch.zeros_like(theta), torch.zeros_like(Zt)
    th1, Z1, *_, losses = sgpr_adam_chunk_plain(
        theta, Zt, zt, zt, zz, zz, torch.tensor(X), torch.tensor(y), JITTER,
        t0=0, num_steps=7, lr=LR, clip_norm=10.0, min_noise=1e-4)
    th_ref = params_from_jax({k: v for k, v in p_ref.items() if k != "Z"})
    np.testing.assert_allclose(losses.numpy(), np.asarray(l_ref), rtol=RTOL)
    np.testing.assert_allclose(th1.numpy(), th_ref.numpy(), rtol=RTOL)
    np.testing.assert_allclose(Z1.numpy(), np.asarray(p_ref["Z"]), rtol=RTOL)


def test_z_chunk_matches_adam_z():
    hypers, X, y, Z = _problem(seed=1)
    S, d = 5, X.shape[1]
    tr = _trace(2, S, d)
    Z_ref, l_ref = _adam_Z(jax_default_rbf(ard=True), jnp.asarray(X), jnp.asarray(y),
                           JITTER, jnp.asarray(Z),
                           {"kernel": {"base": {"log_lengthscale":
                                                jnp.asarray(tr["kernel"]["base"]["log_lengthscale"])},
                                       "log_outputscale": jnp.asarray(tr["kernel"]["log_outputscale"])},
                            "log_noise": jnp.asarray(tr["log_noise"])},
                           optax.chain(optax.zero_nans(), optax.adam(LR)), 6)
    thetas = params_from_jax(tr)
    Zt = torch.tensor(Z)
    zz = torch.zeros_like(Zt)
    Z1, _, _, losses = z_adam_chunk_plain(Zt, zz, zz, thetas, torch.tensor(X),
                                          torch.tensor(y), JITTER, t0=0,
                                          num_steps=6, lr=LR)
    np.testing.assert_allclose(losses.numpy(), np.asarray(l_ref), rtol=RTOL)
    np.testing.assert_allclose(Z1.numpy(), np.asarray(Z_ref), rtol=RTOL)


# float32 interpret-mode Pallas against the port in float32: the kernels
# factorise blocked, the port with LAPACK (~1e-6 relative per evaluation);
# Adam's normalised steps keep parameter differences near that level.
F32_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_sgpr_chunk_matches_pallas_interpret():
    from ggp_tpu.ops.fused_sgpr import make_fused_sgpr
    hypers, X, y, Z = _problem(seed=3)
    n, d = X.shape
    m = Z.shape[0]
    theta, Zt = params_from_jax(hypers, Z, dtype=torch.float32)
    Xf, yf = X.astype(np.float32), y.astype(np.float32)
    K = 5
    chunk = make_fused_sgpr(n, m, d, 1e-5, steps_per_call=K, lr=LR,
                            min_noise=1e-4, clip_norm=10.0, interpret=True)
    Np = -(-n // 8) * 8
    tp = np.zeros((1, 128), np.float32); tp[0, :d + 2] = theta.numpy()
    Zp = np.zeros((128, 128), np.float32); Zp[:m, :d] = Zt.numpy()
    Xp = np.zeros((Np, 128), np.float32); Xp[:n, :d] = Xf
    yp = np.zeros((Np, 1), np.float32); yp[:n, 0] = yf
    zero = {"theta": jnp.zeros((1, 128), jnp.float32),
            "Z": jnp.zeros((128, 128), jnp.float32)}
    th_j, Z_j, _, _, l_j = chunk(jnp.asarray(tp), jnp.asarray(Zp), zero, zero,
                                 jnp.asarray(Xp), jnp.asarray(yp), 0.0)
    zt, zz = torch.zeros_like(theta), torch.zeros_like(Zt)
    th1, Z1, *_, losses = sgpr_adam_chunk_plain(
        theta, Zt, zt, zt, zz, zz, torch.tensor(Xf), torch.tensor(yf), 1e-5,
        t0=0, num_steps=K, lr=LR, clip_norm=10.0, min_noise=1e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(l_j), **F32_TOL)
    np.testing.assert_allclose(th1.numpy(), np.asarray(th_j)[0, :d + 2], **F32_TOL)
    np.testing.assert_allclose(Z1.numpy(), np.asarray(Z_j)[:m, :d], **F32_TOL)


@pytest.mark.slow
def test_z_chunk_matches_pallas_interpret():
    from ggp_tpu.ops.fused_sgpr import make_fused_z_adam
    hypers, X, y, Z = _problem(seed=4)
    n, d = X.shape
    m, S, K = Z.shape[0], 3, 4
    thetas = params_from_jax(_trace(5, S, d), dtype=torch.float32)
    Xf, yf, Zf = X.astype(np.float32), y.astype(np.float32), Z.astype(np.float32)
    chunk = make_fused_z_adam(n, m, d, 8, 1e-5, steps_per_call=K, lr=LR,
                              interpret=True)
    Np = -(-n // 8) * 8
    th = np.zeros((S, 128), np.float32); th[:, :d + 2] = thetas.numpy()
    Zp = np.zeros((128, 128), np.float32); Zp[:m, :d] = Zf
    Xp = np.zeros((Np, 128), np.float32); Xp[:n, :d] = Xf
    yp = np.zeros((Np, 1), np.float32); yp[:n, 0] = yf
    zero = jnp.zeros((128, 128), jnp.float32)
    Z_j, _, _, l_j = chunk(jnp.asarray(Zp), zero, zero, jnp.asarray(th),
                           jnp.asarray(Xp), jnp.asarray(yp), 0.0)
    Zt = torch.tensor(Zf)
    zz = torch.zeros_like(Zt)
    Z1, _, _, losses = z_adam_chunk_plain(Zt, zz, zz, thetas, torch.tensor(Xf),
                                          torch.tensor(yf), 1e-5, t0=0,
                                          num_steps=K, lr=LR)
    np.testing.assert_allclose(losses.numpy(), np.asarray(l_j), **F32_TOL)
    np.testing.assert_allclose(Z1.numpy(), np.asarray(Z_j)[:m, :d], **F32_TOL)


def test_cpu_adam_wrappers_run_plain_and_count_no_launch():
    hypers, X, y, Z = _problem(seed=6)
    theta, Zt = params_from_jax(hypers, Z)
    Xt, yt = torch.tensor(X), torch.tensor(y)
    zt, zz = torch.zeros_like(theta), torch.zeros_like(Zt)
    before = dict(_build.LAUNCHES)
    kw = dict(t0=2, num_steps=3, lr=LR, clip_norm=10.0, min_noise=1e-4)
    a = sgpr_adam_chunk(theta, Zt, zt, zt, zz, zz, Xt, yt, JITTER, **kw)
    b = sgpr_adam_chunk_plain(theta, Zt, zt, zt, zz, zz, Xt, yt, JITTER, **kw)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    thetas = torch.stack([theta, theta + 0.1])
    a = z_adam_chunk(Zt, zz, zz, thetas, Xt, yt, JITTER, t0=0, num_steps=2, lr=LR)
    b = z_adam_chunk_plain(Zt, zz, zz, thetas, Xt, yt, JITTER, t0=0, num_steps=2, lr=LR)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert _build.LAUNCHES == before
