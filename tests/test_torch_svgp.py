"""The port's SVI path (SVGP and BayesianSVGP) against the JAX package, on
the CPU.

The likelihoods (``ggp_tpu_torch.likelihoods``), the loss cores with their
hand-written adjoints (``ops.svi``: Gaussian, Bernoulli-probit, Poisson,
softmax, BayesianSVGP), two-epoch Adam trajectories of the chunk functions
on the JAX package's minibatch and eps schedule, the predictives, and the
models (``models.svgp``, ``models.bayesian_svgp``), at small sizes in
float64 unless stated. The interpret-mode Pallas comparisons are ``slow``.

The JAX loss cores (``ops/fused_svi.py``) fix their masks and constants in
float32; :class:`_F64` runs them with float64 in that place, so that the
comparison at XLA level is of the algebra, not of float32 rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

import ggp_tpu.ops.fused_svi as fsvi
from ggp_tpu import likelihoods as jlik
from ggp_tpu.kernels import default_rbf as j_default_rbf
from ggp_tpu.models import StochasticVariationalGP as JaxSVGP
from ggp_tpu.models.bayesian_svgp import BayesianStochasticVariationalGP as JaxBSVGP
from ggp_tpu.models.bayesian_svgp import bsvgp_elbo as j_bsvgp_elbo
from ggp_tpu.models.svgp import svgp_elbo as j_svgp_elbo
from ggp_tpu_torch import BayesianStochasticVariationalGP, StochasticVariationalGP
from ggp_tpu_torch import likelihoods as tlik
from ggp_tpu_torch.interop import tree_from_numpy, tree_to_numpy
from ggp_tpu_torch.kernels import RBF, Scale, default_rbf
from ggp_tpu_torch.models.bayesian_svgp import bsvgp_elbo
from ggp_tpu_torch.models.svgp import pack_svgp, svgp_elbo
from ggp_tpu_torch.ops import svi

F32, F64 = torch.float32, torch.float64
LIKS = ("gauss", "bernoulli_probit", "poisson")
# One f64 evaluation: the same algebra up to summation order and the
# factorisation (~1e-15); two epochs of Adam keep that far below these
# bounds, while a wrong term or branch moves a result by 1e-3 or more.
TOL = 1e-9
TRAJ_TOL = 1e-8


def _rel(a, b):
    """max |a - b| / max |b| (norm-relative)."""
    a = np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach().cpu() if torch.is_tensor(b) else b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


class _F64:
    """``jax.numpy`` with ``float32`` standing for ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture
def f64_cores(monkeypatch):
    monkeypatch.setattr(fsvi, "jnp", _F64())


def _t(a, dt=F64):
    return torch.tensor(np.asarray(a), dtype=dt)


def _targets(lik, r, n, C=3):
    if lik == "gauss":
        return r.normal(size=n)
    if lik == "bernoulli_probit":
        return (r.random(n) < 0.5).astype(np.float64)
    if lik == "poisson":
        return r.poisson(2.0, n).astype(np.float64)
    return r.integers(0, C, n).astype(np.float64)


def _svgp_case(lik, seed=0, nb=40, m=8, d=3, C=3):
    """A minibatch and unpadded SVGP parameters of the kernels' layout."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(nb, d))
    y = _targets(lik, r, nb, C)
    Z = r.normal(size=(m, d))
    Cl = C if lik == "softmax" else 1
    hyp = np.r_[0.3 * r.normal(size=d), 0.3, -1.0][:svi.hyp_dim(d, lik) if lik != "softmax"
                                                   else d + 1]
    params = {"hyp": hyp, "Z": Z, "q_mu": 0.5 * r.normal(size=(m, Cl)),
              "q_raw": 0.1 * r.normal(size=(Cl, m, m))}
    return X, y, params


def _tree(params, d, lik):
    """The models' params tree of a kernels' layout dict (numpy leaves)."""
    hyp = params["hyp"]
    tree = {"kernel": {"base": {"log_lengthscale": hyp[:d]}, "log_outputscale": hyp[d]},
            "lik": {"log_noise": hyp[d + 1]} if lik == "gauss" else {},
            "Z": params["Z"], "q_mu": params["q_mu"], "q_sqrt_raw": params["q_raw"]}
    return tree


def _pad(params, m, d, Mp=64):
    """The JAX cores' padded layout of one latent."""
    hp = np.zeros((1, 128))
    hp[0, :len(params["hyp"])] = params["hyp"]
    Zp = np.zeros((Mp, 128))
    Zp[:m, :d] = params["Z"]
    C = params["q_mu"].shape[1]
    qm = np.zeros((Mp, 128 if C > 1 else 1))
    qm[:m, :C] = params["q_mu"]
    qr = [np.zeros((Mp, Mp)) for _ in range(C)]
    for c in range(C):
        qr[c][:m, :m] = params["q_raw"][c]
    return {"hyp": jnp.asarray(hp), "Z": jnp.asarray(Zp), "q_mu": jnp.asarray(qm),
            "q_raw": jnp.asarray(qr[0]) if C == 1 else tuple(map(jnp.asarray, qr))}


def _slab(X, y, lgam=False, rows=40):
    nb, d = X.shape
    s = np.zeros((rows, 128))
    s[:nb, :d] = X
    s[:nb, 127] = y
    if lgam:
        s[:nb, 126] = gammaln(y + 1.0)
    return jnp.asarray(s)


def _port_loss(lik, X, y, params, N, eps=None):
    tp = {k: _t(v) for k, v in params.items()}
    if lik == "softmax":
        return svi.svgp_softmax_loss_vg(tp, _t(X), _t(y), _t(eps), N, 1e-8)
    return svi.svgp_loss_vg(tp, _t(X), _t(y), N, 1e-8, lik)


# -- likelihoods ---------------------------------------------------------------------------

def test_likelihoods_match_jax():
    """Variational expectations and predictives of the four likelihoods
    against ``ggp_tpu.likelihoods`` (softmax on the JAX draws)."""
    r = np.random.default_rng(1)
    n = 30
    mu, var = r.normal(size=n), np.exp(r.normal(size=n))
    xj, wj = jlik.gauss_hermite()
    xt, wt = tlik.gauss_hermite()
    assert _rel(xt, xj) <= 1e-15 and _rel(wt, wj) <= 1e-15
    cases = [(tlik.GaussianLikelihood(), jlik.GaussianLikelihood(), r.normal(size=n),
              {"log_noise": -0.7}),
             (tlik.BernoulliProbit(), jlik.BernoulliProbit(), _targets("bernoulli_probit", r, n),
              {}),
             (tlik.PoissonLogCox(), jlik.PoissonLogCox(), _targets("poisson", r, n), {})]
    for tl, jl, y, p in cases:
        pt = {k: _t(v) for k, v in p.items()}
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        ve_t = tl.variational_expectation(pt, _t(mu), _t(var), _t(y))
        ve_j = jl.variational_expectation(pj, jnp.asarray(mu), jnp.asarray(var), jnp.asarray(y))
        assert _rel(ve_t, ve_j) <= 1e-12, type(tl).__name__
        for a, b in zip(tl.predictive(pt, _t(mu), _t(var)),
                        jl.predictive(pj, jnp.asarray(mu), jnp.asarray(var))):
            assert _rel(a, b) <= 1e-12, type(tl).__name__
    C = 3
    mu3, var3 = r.normal(size=(n, C)), np.exp(r.normal(size=(n, C)))
    y3 = r.integers(0, C, n)
    key = jax.random.PRNGKey(3)
    jl, tl = jlik.Softmax(num_classes=C, num_mc=8), tlik.Softmax(num_classes=C, num_mc=8)
    ve_j = jl.variational_expectation({}, jnp.asarray(mu3), jnp.asarray(var3),
                                      jnp.asarray(y3), key=key)
    eps = np.asarray(jax.random.normal(key, (4, n, C), jnp.float64))
    ve_t = tl.variational_expectation({}, _t(mu3), _t(var3), torch.tensor(y3), eps=_t(eps))
    assert _rel(ve_t, ve_j) <= 1e-12
    p_j, _ = jl.predictive({}, jnp.asarray(mu3), jnp.asarray(var3), key=key)
    eps = np.asarray(jax.random.normal(key, (8, n, C), jnp.float64))
    p_t, _ = tl.predictive({}, _t(mu3), _t(var3), eps=_t(eps))
    assert _rel(p_t, p_j) <= 1e-12


# -- the loss cores ------------------------------------------------------------------------

@pytest.mark.parametrize("lik,tol", [("gauss", TOL), ("poisson", TOL),
                                     # the JAX core's erfc is a rational fit (1.2e-7)
                                     ("bernoulli_probit", 1e-6)])
def test_svgp_loss_vg_matches_jax_core(f64_cores, lik, tol):
    """``ops.svi.svgp_loss_vg`` against ``fused_svi.svgp_loss_vg`` at XLA
    level (float64, shared inputs)."""
    X, y, params = _svgp_case(lik, seed=2)
    nb, d = X.shape
    m, N = params["Z"].shape[0], 10 * nb
    fn = jax.jit(functools.partial(fsvi.svgp_loss_vg, Xb=_slab(X, y, lik == "poisson"),
                                   yb=None, num_data=N, nb=nb, m=m, d=d, jitter=1e-8,
                                   likelihood=lik, quad=fsvi.quad_table(jnp.float64)))
    loss_j, g_j = fn(_pad(params, m, d))
    loss, g = _port_loss(lik, X, y, params, N)
    hd = len(params["hyp"])
    assert _rel(loss, loss_j) <= tol
    assert _rel(g["hyp"], np.asarray(g_j["hyp"])[0, :hd]) <= tol
    assert _rel(g["Z"], np.asarray(g_j["Z"])[:m, :d]) <= tol
    assert _rel(g["q_mu"], np.asarray(g_j["q_mu"])[:m]) <= tol
    assert _rel(g["q_raw"][0], np.asarray(g_j["q_raw"])[:m, :m]) <= tol


@pytest.mark.parametrize("lik", LIKS + ("softmax",))
def test_svgp_loss_vg_matches_autograd(lik):
    """The hand-written adjoint against torch.autograd of the port's
    ``svgp_elbo`` (the softmax term on shared eps)."""
    X, y, params = _svgp_case(lik, seed=3, nb=24, m=6, d=2)
    nb, d = X.shape
    N = 5 * nb
    eps = np.random.default_rng(4).normal(size=(4, nb, 3)) if lik == "softmax" else None
    loss, g = _port_loss(lik, X, y, params, N, eps)
    leaves = {"hyp": _t(params["hyp"]).requires_grad_(), "Z": _t(params["Z"]).requires_grad_(),
              "q_mu": _t(params["q_mu"]).requires_grad_(),
              "q_raw": _t(params["q_raw"]).requires_grad_()}
    h = leaves["hyp"]
    tree = {"kernel": {"base": {"log_lengthscale": h[:d]}, "log_outputscale": h[d]},
            "lik": {"log_noise": h[d + 1]} if lik == "gauss" else {},
            "Z": leaves["Z"], "q_mu": leaves["q_mu"], "q_sqrt_raw": leaves["q_raw"]}
    likelihood = {"gauss": tlik.GaussianLikelihood(), "bernoulli_probit": tlik.BernoulliProbit(),
                  "poisson": tlik.PoissonLogCox(), "softmax": tlik.Softmax(3, 8)}[lik]
    ref = -svgp_elbo(default_rbf(), likelihood, tree, _t(X),
                     torch.tensor(y).long() if lik == "softmax" else _t(y), N, 1e-8,
                     eps=None if eps is None else _t(eps))
    ref.backward()
    assert _rel(loss, ref) <= TOL
    for k in svi.SVI_NAMES:
        assert _rel(g[k], leaves[k].grad) <= TOL, k


def test_softmax_loss_vg_matches_jax(f64_cores):
    """``svgp_softmax_loss_vg`` against the JAX core (float64) and against
    jax.grad of the JAX ``svgp_elbo`` with a Softmax(3, 8) likelihood, whose
    key draws the shared eps."""
    X, y, params = _svgp_case("softmax", seed=5, nb=24, m=8, d=2)
    nb, d = X.shape
    m, C, N, n_half = 8, 3, 10 * nb, 4
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(key, (n_half, nb, C), jnp.float64))
    loss, g = _port_loss("softmax", X, y, params, N, eps)
    eblk = np.zeros((C, 8, 24))
    eblk[:, :n_half, :nb] = np.transpose(eps, (2, 0, 1))
    fn = jax.jit(lambda p: fsvi.svgp_softmax_loss_vg(p, _slab(X, y, rows=24), N, nb, m, d, C,
                                                     n_half, lambda c: jnp.asarray(eblk[c]),
                                                     1e-8))
    loss_j, g_j = fn(_pad(params, m, d))
    assert _rel(loss, loss_j) <= TOL
    assert _rel(g["hyp"], np.asarray(g_j["hyp"])[0, :d + 1]) <= TOL
    assert _rel(g["Z"], np.asarray(g_j["Z"])[:m, :d]) <= TOL
    assert _rel(g["q_mu"], np.asarray(g_j["q_mu"])[:m, :C]) <= TOL
    for c in range(C):
        assert _rel(g["q_raw"][c], np.asarray(g_j["q_raw"][c])[:m, :m]) <= TOL
    tree = jax.tree_util.tree_map(jnp.asarray, _tree(params, d, "softmax"))
    val, gt = jax.jit(jax.value_and_grad(lambda p: -j_svgp_elbo(
        j_default_rbf(ard=True), jlik.Softmax(C, 2 * n_half), p, jnp.asarray(X),
        jnp.asarray(y.astype(np.int32)), N, 1e-8, key=key)))(tree)
    assert _rel(loss, val) <= TOL
    ref_hyp = np.r_[gt["kernel"]["base"]["log_lengthscale"], gt["kernel"]["log_outputscale"]]
    assert _rel(g["hyp"], ref_hyp) <= TOL
    assert _rel(g["Z"], gt["Z"]) <= TOL and _rel(g["q_mu"], gt["q_mu"]) <= TOL
    assert _rel(g["q_raw"], gt["q_sqrt_raw"]) <= TOL


def _bsvgp_case(seed, nb=24, m=8, d=2, S=3):
    r = np.random.default_rng(seed)
    h = d + 2
    X, y = r.normal(size=(nb, d)), r.normal(size=nb)
    Lraw = np.tril(0.2 * r.normal(size=(h, h)))
    params = {"hmu": 0.2 * r.normal(size=h), "Lraw": Lraw, "Z": r.normal(size=(m, d)),
              "q_mu": 0.3 * r.normal(size=(m, 1)), "q_raw": 0.1 * r.normal(size=(1, m, m))}
    return X, y, params, r.normal(size=(S, h))


def test_bsvgp_loss_vg_matches_jax(f64_cores):
    """``bsvgp_loss_vg`` on shared eps against the JAX core (float64) and
    against jax.grad of the JAX ``bsvgp_elbo``."""
    X, y, params, eps = _bsvgp_case(6)
    nb, d = X.shape
    m, h, S, N, pv = 8, d + 2, eps.shape[0], 10 * nb, 0.01
    tp = {k: _t(v) for k, v in params.items()}
    loss, g = svi.bsvgp_loss_vg(tp, _t(X), _t(y), _t(eps), N, 1e-8, pv)
    pp = _pad({"hyp": np.zeros(h), **{k: params[k] for k in ("Z", "q_mu", "q_raw")}}, m, d)
    del pp["hyp"]
    hm = np.zeros((1, 128))
    hm[0, :h] = params["hmu"]
    Lp = np.zeros((128, 128))
    Lp[:h, :h] = params["Lraw"]
    ep = np.zeros((8, 128))
    ep[:S, :h] = eps
    fn = jax.jit(lambda p: fsvi.bsvgp_loss_vg(p, _slab(X, y, rows=24), jnp.asarray(ep), N, nb,
                                              m, d, S, pv, 1e-8))
    loss_j, g_j = fn({"hmu": jnp.asarray(hm), "Lraw": jnp.asarray(Lp), **pp})
    assert _rel(loss, loss_j) <= TOL
    assert _rel(g["hmu"], np.asarray(g_j["hmu"])[0, :h]) <= TOL
    assert _rel(g["Lraw"], np.asarray(g_j["Lraw"])[:h, :h]) <= TOL
    assert _rel(g["Z"], np.asarray(g_j["Z"])[:m, :d]) <= TOL
    assert _rel(g["q_mu"], np.asarray(g_j["q_mu"])[:m]) <= TOL
    assert _rel(g["q_raw"][0], np.asarray(g_j["q_raw"])[:m, :m]) <= TOL
    il = np.tril_indices(h)
    tree = {"kernel": {}, "Z": params["Z"], "q_mu": params["q_mu"],
            "q_sqrt_raw": params["q_raw"], "hyper_mu": params["hmu"],
            "hyper_L_vec": params["Lraw"][il]}
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    val, gt = jax.jit(jax.value_and_grad(lambda p: -j_bsvgp_elbo(
        j_default_rbf(ard=True), jlik.GaussianLikelihood(), p, jnp.asarray(X), jnp.asarray(y),
        N, None, S, pv, 1e-8, eps=jnp.asarray(eps))))(tree)
    assert _rel(loss, val) <= TOL
    assert _rel(g["hmu"], gt["hyper_mu"]) <= TOL
    assert _rel(g["Lraw"].numpy()[il], gt["hyper_L_vec"]) <= TOL
    assert _rel(g["Z"], gt["Z"]) <= TOL and _rel(g["q_raw"], gt["q_sqrt_raw"]) <= TOL
    # and the port's own autograd ground truth
    leaves = {k: _t(v).requires_grad_() for k, v in (("hyper_mu", params["hmu"]),
                                                     ("hyper_L_vec", params["Lraw"][il]),
                                                     ("Z", params["Z"]),
                                                     ("q_mu", params["q_mu"]),
                                                     ("q_sqrt_raw", params["q_raw"]))}
    ref = -bsvgp_elbo(default_rbf(), tlik.GaussianLikelihood(), leaves, _t(X), _t(y), N, S, pv,
                      1e-8, eps=_t(eps))
    ref.backward()
    assert _rel(loss, ref) <= TOL
    assert _rel(g["Lraw"].numpy()[il], leaves["hyper_L_vec"].grad) <= TOL


# -- two-epoch trajectories on the JAX schedule -------------------------------------------

N_TR, BS, M_TR, D_TR, EPOCHS, LR = 48, 16, 8, 2, 2, 0.02


def _train_data(lik, seed=11):
    r = np.random.default_rng(seed)
    X = r.normal(size=(N_TR, D_TR))
    f = np.sin(X @ r.normal(size=D_TR))
    y = {"gauss": f + 0.3 * r.normal(size=N_TR),
         "bernoulli_probit": (f + 0.3 * r.normal(size=N_TR) > 0).astype(np.float64),
         "poisson": r.poisson(np.exp(f)).astype(np.float64),
         "softmax": np.digitize(f, [-0.3, 0.3]).astype(np.float64)}[lik]
    Z = X[r.choice(N_TR, M_TR, replace=False)]
    return X, y, Z


def _schedule(key, bayes=False, draw=None):
    """Per-step row indices (EPOCHS * steps, BS), and the per-step keys'
    draws ``draw(key)``, of ``_run_svi`` / ``_run_bsvi``."""
    steps = N_TR // BS
    idx, eps = [], []
    for ekey in jax.random.split(key, EPOCHS):
        if bayes:
            pkey, skey = jax.random.split(ekey)
            skeys = jax.random.split(skey, steps)
        else:
            pkey = ekey
            skeys = jax.random.split(jax.random.fold_in(ekey, 1), steps)
        idx.append(np.asarray(jax.random.permutation(pkey, N_TR)[:steps * BS]).reshape(steps, BS))
        if draw is not None:
            eps += [np.asarray(draw(k)) for k in skeys]
    return np.concatenate(idx), (np.stack(eps) if draw is not None else None)


_JLIK = {"gauss": jlik.GaussianLikelihood, "bernoulli_probit": jlik.BernoulliProbit,
         "poisson": jlik.PoissonLogCox}
_TLIK = {"gauss": tlik.GaussianLikelihood, "bernoulli_probit": tlik.BernoulliProbit,
         "poisson": tlik.PoissonLogCox}


@pytest.mark.parametrize("lik", LIKS + ("softmax",))
def test_svgp_trajectory_matches_jax_train_model(lik):
    """Two epochs of the chunk functions on the JAX key schedule against the
    JAX package's ``train_model`` (its XLA ``_run_svi`` with optax.adam)."""
    X, y, Z = _train_data(lik)
    key = jax.random.PRNGKey(4)
    jl = jlik.Softmax(3, 8) if lik == "softmax" else _JLIK[lik]()
    jm = JaxSVGP(jnp.asarray(X), jnp.asarray(y.astype(np.int32) if lik == "softmax" else y),
                 likelihood=jl, Z_init=jnp.asarray(Z))
    p0 = tree_to_numpy(tree_from_numpy(jax.device_get(jm.params)))
    losses_j = jm.train_model(num_epochs=EPOCHS, batch_size=BS, lr=LR, key=key)
    draw = ((lambda k: jax.random.normal(k, (4, BS, 3), jnp.float64)) if lik == "softmax"
            else None)
    idx, eps = _schedule(key, draw=draw)
    tag = "softmax" if lik == "softmax" else lik
    p = pack_svgp(tree_from_numpy(p0), tag)
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    args = (p, zeros, dict(zeros), _t(X), _t(y), torch.tensor(idx))
    if lik == "softmax":
        out, _, _, losses = svi.svi_softmax_chunk(*args, _t(eps), 1e-8, t0=0, lr=LR)
    else:
        out, _, _, losses = svi.svi_chunk(*args, 1e-8, likelihood=lik, t0=0, lr=LR)
    ref = pack_svgp(tree_from_numpy(jax.device_get(jm.params)), tag)
    for k in svi.SVI_NAMES:
        assert _rel(out[k], ref[k]) <= TRAJ_TOL, k
    assert _rel(losses.reshape(EPOCHS, -1).mean(1), losses_j) <= TRAJ_TOL


def test_bsvgp_trajectory_matches_jax_train_model():
    """The BayesianSVGP chunk function over two epochs on the JAX key
    schedule (S = 3 draws per step) against ``train_model``'s XLA
    ``_run_bsvi``."""
    X, y, Z = _train_data("gauss")
    key = jax.random.PRNGKey(6)
    S, h = 3, D_TR + 2
    jm = JaxBSVGP(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z), prior_var=1.0,
                  num_hyper_samples=S)
    p0 = tree_from_numpy(jax.device_get(jm.params))
    losses_j = jm.train_model(num_epochs=EPOCHS, batch_size=BS, lr=LR, key=key)
    idx, eps = _schedule(key, bayes=True,
                         draw=lambda k: jax.random.normal(k, (S, h), jnp.float64))
    il = torch.tril_indices(h, h)
    p = {"hmu": p0["hyper_mu"], "Lraw": torch.zeros((h, h), dtype=F64).index_put(
        (il[0], il[1]), p0["hyper_L_vec"]), "Z": p0["Z"], "q_mu": p0["q_mu"],
        "q_raw": p0["q_sqrt_raw"]}
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    out, _, _, losses = svi.bsvgp_chunk(p, zeros, dict(zeros), _t(X), _t(y), torch.tensor(idx),
                                        _t(eps), 1e-8, prior_var=1.0, t0=0, lr=LR)
    ref = tree_from_numpy(jax.device_get(jm.params))
    assert _rel(out["hmu"], ref["hyper_mu"]) <= TRAJ_TOL
    assert _rel(out["Lraw"][il[0], il[1]], ref["hyper_L_vec"]) <= TRAJ_TOL
    assert _rel(out["Z"], ref["Z"]) <= TRAJ_TOL
    assert _rel(out["q_mu"], ref["q_mu"]) <= TRAJ_TOL
    assert _rel(out["q_raw"], ref["q_sqrt_raw"]) <= TRAJ_TOL
    assert _rel(losses.reshape(EPOCHS, -1).mean(1), losses_j) <= TRAJ_TOL


# -- predictives ---------------------------------------------------------------------------

def _perturbed(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.2 * r.normal(size=np.shape(a)),
                                  jax.device_get(tree))


@pytest.mark.parametrize("lik", LIKS + ("softmax",))
def test_posterior_predictive_matches_jax(lik):
    """``posterior_predictive`` (latent and y-space; softmax on the JAX
    model's fixed-key draws) at shared parameters."""
    X, y, Z = _train_data(lik)
    Xt = np.random.default_rng(2).normal(size=(10, D_TR))
    jl = jlik.Softmax(3, 8) if lik == "softmax" else _JLIK[lik]()
    jm = JaxSVGP(jnp.asarray(X), jnp.asarray(y), likelihood=jl, Z_init=jnp.asarray(Z))
    jm.params = jax.tree_util.tree_map(jnp.asarray, _perturbed(jm.params, 3))
    tl = tlik.Softmax(3, 8) if lik == "softmax" else _TLIK[lik]()
    tm = StochasticVariationalGP(X, y, likelihood=tl, Z_init=Z, device="cpu")
    tm.params = tree_from_numpy(jax.device_get(jm.params))
    eps = (_t(jax.random.normal(jax.random.PRNGKey(0), (8, 10, 3), jnp.float64))
           if lik == "softmax" else None)
    for a, b in zip(tm.posterior_predictive(Xt, eps=eps),
                    jm.posterior_predictive(jnp.asarray(Xt))):
        assert _rel(a, b) <= TOL
    for a, b in zip(tm.posterior_predictive(Xt, include_likelihood=False),
                    jm.posterior_predictive(jnp.asarray(Xt), include_likelihood=False)):
        assert _rel(a, b) <= TOL
    if lik == "gauss":
        for a, b in zip(tm.posterior_predictive(Xt, full_cov=True),
                        jm.posterior_predictive(jnp.asarray(Xt), full_cov=True)):
            assert _rel(a, b) <= TOL


@pytest.mark.parametrize("transform", ["exp", "ref_softplus"])
def test_mixture_posterior_predictive_matches_jax(transform):
    """The BayesianSVGP mixture on the JAX default key's hyper draws, and
    the probit model's ``mixture_predictive_proba``."""
    X, y, Z = _train_data("gauss")
    Xt = np.random.default_rng(2).normal(size=(10, D_TR))
    jm = JaxBSVGP(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z))
    jm.params = jax.tree_util.tree_map(jnp.asarray, _perturbed(jm.params, 5))
    tm = BayesianStochasticVariationalGP(X, y, Z_init=Z, device="cpu")
    tm.params = tree_from_numpy(jax.device_get(jm.params))
    eps = _t(jax.random.normal(jax.random.PRNGKey(1), (20, D_TR + 2), jnp.float64))
    mt, vt = tm.mixture_posterior_predictive(Xt, 20, eps=eps, transform=transform)
    mj, vj = jm.mixture_posterior_predictive(jnp.asarray(Xt), 20, transform=transform)
    assert mt.shape == mj.shape and _rel(mt, mj) <= TOL and _rel(vt, vj) <= TOL
    yb = (y > 0).astype(np.float64)
    jp = JaxBSVGP(jnp.asarray(X), jnp.asarray(yb), likelihood=jlik.BernoulliProbit(),
                  Z_init=jnp.asarray(Z))
    jp.params = jax.tree_util.tree_map(jnp.asarray, _perturbed(jp.params, 6))
    tp = BayesianStochasticVariationalGP(X, yb, likelihood=tlik.BernoulliProbit(), Z_init=Z,
                                         device="cpu")
    tp.params = tree_from_numpy(jax.device_get(jp.params))
    eps = _t(jax.random.normal(jax.random.PRNGKey(1), (20, D_TR + 1), jnp.float64))
    assert _rel(tp.mixture_predictive_proba(Xt, 20, eps=eps),
                jp.mixture_predictive_proba(jnp.asarray(Xt), 20)) <= TOL


# -- models, wrappers, interop -------------------------------------------------------------

def test_interop_round_trip():
    X, y, Z = _train_data("gauss")
    for jm in (JaxSVGP(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z)),
               JaxBSVGP(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z))):
        p = _perturbed(jm.params, 7)
        back = tree_to_numpy(tree_from_numpy(p))
        flat_a, tree_a = jax.tree_util.tree_flatten(p)
        flat_b, tree_b = jax.tree_util.tree_flatten(back)
        assert tree_a == tree_b
        assert all(np.array_equal(np.asarray(a), b) for a, b in zip(flat_a, flat_b))


@pytest.mark.parametrize("lik", LIKS + ("softmax",))
def test_models_train_finite_on_the_cpu(lik):
    """``device="cpu"`` runs the plain chunks: finite losses that fall, and
    a finite predictive; the BayesianSVGP with the Gaussian likelihood."""
    X, y, Z = _train_data(lik)
    tl = tlik.Softmax(3, 8) if lik == "softmax" else _TLIK[lik]()
    m = StochasticVariationalGP(X, y, likelihood=tl, Z_init=Z, device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = m.train_model(num_epochs=6, batch_size=BS, lr=0.05, generator=gen)
    assert losses.shape == (6,) and torch.isfinite(losses).all()
    assert float(losses[-1]) < float(losses[0])
    assert all(torch.isfinite(a).all() for a in m.posterior_predictive(X[:5]))
    if lik == "gauss":
        b = BayesianStochasticVariationalGP(X, y, Z_init=Z, prior_var=1.0, device="cpu")
        bl = b.train_model(num_epochs=4, batch_size=BS, lr=0.05, generator=gen)
        assert torch.isfinite(bl).all() and float(bl[-1]) < float(bl[0])
        mm, vv = b.mixture_posterior_predictive(X[:5], 10)
        assert mm.shape == (10, 5) and torch.isfinite(vv).all()


def test_wrappers_on_the_cpu_run_the_plain_chunks():
    """A CPU tensor takes the plain version, the inputs stay unmodified and
    no launch is counted."""
    from ggp_tpu_torch.ops import _build
    X, y, Z = _train_data("poisson")
    m = StochasticVariationalGP(X, y, likelihood=tlik.PoissonLogCox(), Z_init=Z, device="cpu")
    p = pack_svgp(m.params, "poisson")
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    idx = torch.stack([torch.randperm(N_TR, generator=torch.Generator().manual_seed(s))[:BS]
                       for s in range(3)])
    before = {k: v.clone() for k, v in p.items()}
    n0 = dict(_build.LAUNCHES)
    a = svi.svi_chunk(p, zeros, zeros, m.train_x, m.train_y, idx, 1e-8, likelihood="poisson",
                      t0=0, lr=0.01)
    b = svi.svi_chunk_plain(p, zeros, zeros, m.train_x, m.train_y, idx, 1e-8,
                            likelihood="poisson", t0=0, lr=0.01)
    assert all(torch.equal(a[0][k], b[0][k]) for k in svi.SVI_NAMES)
    assert all(torch.equal(p[k], before[k]) for k in p) and _build.LAUNCHES == n0
    with pytest.raises(ValueError, match="likelihood"):
        svi.svi_chunk(p, zeros, zeros, m.train_x, m.train_y, idx, 1e-8, likelihood="softmax",
                      t0=0, lr=0.01)


def test_not_implemented_cases():
    X, y, Z = _train_data("gauss")
    with pytest.raises(NotImplementedError, match="RBF"):
        StochasticVariationalGP(X, y, Z_init=Z, kernel=Scale(RBF(ard=False)), device="cpu")
    with pytest.raises(NotImplementedError, match="custom likelihoods"):
        StochasticVariationalGP(X, y, likelihood=tlik.Likelihood(), Z_init=Z, device="cpu")
    m = StochasticVariationalGP(X, y, Z_init=Z, device="cpu")
    with pytest.raises(NotImplementedError, match="optimizer"):
        m.train_model(optimizer=object(), num_epochs=1)
    with pytest.raises(NotImplementedError, match="RBF"):
        BayesianStochasticVariationalGP(X, y, Z_init=Z, kernel=Scale(RBF(ard=False)),
                                        device="cpu")
    b = BayesianStochasticVariationalGP(X, (y > 0) * 1.0, likelihood=tlik.BernoulliProbit(),
                                        Z_init=Z, device="cpu")
    with pytest.raises(NotImplementedError, match="non-Gaussian"):
        b.train_model(num_epochs=1)
    with pytest.raises(NotImplementedError, match="optimizer"):
        BayesianStochasticVariationalGP(X, y, Z_init=Z, device="cpu").train_model(
            optimizer=object())


def test_default_device_is_the_card():
    """Without a card the models' default device raises; there is no
    quiet CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is then valid")
    X, y, Z = _train_data("gauss")
    for cls in (StochasticVariationalGP, BayesianStochasticVariationalGP):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(X, y, Z_init=Z)


# -- interpret-mode Pallas kernels (slow) --------------------------------------------------

def _f32_chunk_case(lik, seed):
    """K=3 steps of a small problem: data, row indices, unpadded f32 params."""
    X, y, Z = _train_data(lik, seed)
    r = np.random.default_rng(seed)
    idx = np.stack([r.choice(N_TR, BS, replace=False) for _ in range(3)])
    C = 3 if lik == "softmax" else 1
    hd = D_TR + 1 if lik != "gauss" else D_TR + 2
    params = {"hyp": np.r_[np.zeros(D_TR), 0.1, -1.0][:hd], "Z": Z,
              "q_mu": 0.3 * r.normal(size=(M_TR, C)), "q_raw": 0.1 * r.normal(size=(C, M_TR, M_TR))}
    return X.astype(np.float32), y.astype(np.float32), idx, params


def _slabs(X, y, idx, lgam=False):
    nbp = BS
    s = np.zeros((len(idx) * nbp, 128), np.float32)
    for t, rows in enumerate(idx):
        s[t * nbp:t * nbp + BS, :D_TR] = X[rows]
        s[t * nbp:t * nbp + BS, 127] = y[rows]
        if lgam:
            s[t * nbp:t * nbp + BS, 126] = gammaln(y[rows] + 1.0)
    return jnp.asarray(s)


def _pad32(params):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  _pad(params, M_TR, D_TR, Mp=128))


@pytest.mark.slow
@pytest.mark.parametrize("lik", LIKS)
def test_svi_chunk_matches_pallas_interpret(lik):
    """Site 17: ``make_fused_svi(interpret=True)`` (f32) against the plain
    chunk in f32 over K=3 steps."""
    X, y, idx, params = _f32_chunk_case(lik, 21)
    K = len(idx)
    chunk = fsvi.make_fused_svi(N_TR, BS, M_TR, D_TR, 1e-5, steps_per_call=K, lr=LR,
                                interpret=True, likelihood=lik)
    pp = _pad32(params)
    zeros = {k: jnp.zeros_like(v) for k, v in pp.items()}
    p_j, _, _, losses_j = chunk(pp, dict(zeros), dict(zeros),
                                _slabs(X, y, idx, lik == "poisson"), 0.0)
    tp = {k: _t(v, F32) for k, v in params.items()}
    tz = {k: torch.zeros_like(v) for k, v in tp.items()}
    p_t, _, _, losses = svi.svi_chunk_plain(tp, tz, dict(tz), _t(X, F32), _t(y, F32),
                                            torch.tensor(idx), 1e-5, likelihood=lik, t0=0, lr=LR)
    hd = len(params["hyp"])
    assert _rel(losses, losses_j) <= 1e-3
    assert _rel(p_t["hyp"], np.asarray(p_j["hyp"])[0, :hd]) <= 1e-3
    assert _rel(p_t["Z"], np.asarray(p_j["Z"])[:M_TR, :D_TR]) <= 1e-3
    assert _rel(p_t["q_raw"][0], np.asarray(p_j["q_raw"])[:M_TR, :M_TR]) <= 1e-3


@pytest.mark.slow
def test_bsvgp_chunk_matches_pallas_interpret():
    """Site 19: ``make_fused_bsvgp(interpret=True)`` (f32) against the plain
    chunk in f32 over K=3 steps of S=3 draws."""
    X, y, idx, params = _f32_chunk_case("gauss", 22)
    K, S, h = len(idx), 3, D_TR + 2
    r = np.random.default_rng(3)
    eps = r.normal(size=(K, S, h)).astype(np.float32)
    hmu = 0.1 * r.normal(size=h)
    Lraw = np.tril(0.2 * r.normal(size=(h, h)))
    chunk = fsvi.make_fused_bsvgp(N_TR, BS, M_TR, D_TR, S, 1.0, 1e-5, steps_per_call=K, lr=LR,
                                  interpret=True)
    pp = _pad32({"hyp": np.zeros(h), **{k: params[k] for k in ("Z", "q_mu", "q_raw")}})
    del pp["hyp"]
    hm = np.zeros((1, 128), np.float32)
    hm[0, :h] = hmu
    Lp = np.zeros((128, 128), np.float32)
    Lp[:h, :h] = Lraw
    pp = {"hmu": jnp.asarray(hm), "Lraw": jnp.asarray(Lp), **pp}
    ep = np.zeros((K * 8, 128), np.float32)
    for t in range(K):
        ep[t * 8:t * 8 + S, :h] = eps[t]
    zeros = {k: jnp.zeros_like(v) for k, v in pp.items()}
    p_j, _, _, losses_j = chunk(pp, dict(zeros), dict(zeros), _slabs(X, y, idx),
                                jnp.asarray(ep), 0.0)
    tp = {"hmu": _t(hmu, F32), "Lraw": _t(Lraw, F32),
          **{k: _t(params[k], F32) for k in ("Z", "q_mu", "q_raw")}}
    tz = {k: torch.zeros_like(v) for k, v in tp.items()}
    p_t, _, _, losses = svi.bsvgp_chunk_plain(tp, tz, dict(tz), _t(X, F32), _t(y, F32),
                                              torch.tensor(idx), _t(eps, F32), 1e-5,
                                              prior_var=1.0, t0=0, lr=LR)
    assert _rel(losses, losses_j) <= 1e-3
    assert _rel(p_t["hmu"], np.asarray(p_j["hmu"])[0, :h]) <= 1e-3
    assert _rel(p_t["Lraw"], np.asarray(p_j["Lraw"])[:h, :h]) <= 1e-3
    assert _rel(p_t["Z"], np.asarray(p_j["Z"])[:M_TR, :D_TR]) <= 1e-3


@pytest.mark.slow
def test_svi_softmax_chunk_matches_pallas_interpret():
    """Site 18: ``make_fused_svi_softmax(interpret=True)`` (f32, C=3,
    n_half=4) against the plain chunk in f32 over K=3 steps."""
    X, y, idx, params = _f32_chunk_case("softmax", 23)
    K, C, n_half = len(idx), 3, 4
    eps = np.random.default_rng(4).normal(size=(K, n_half, BS, C)).astype(np.float32)
    chunk = fsvi.make_fused_svi_softmax(N_TR, BS, M_TR, D_TR, C, n_half, 1e-5,
                                        steps_per_call=K, lr=LR, interpret=True)
    pp = _pad32(params)
    erows = np.zeros((K * C * 8, BS), np.float32)
    for t in range(K):
        for c in range(C):
            erows[(t * C + c) * 8:(t * C + c) * 8 + n_half, :] = eps[t, :, :, c]
    zeros = jax.tree_util.tree_map(jnp.zeros_like, pp)
    p_j, _, _, losses_j = chunk(pp, zeros, jax.tree_util.tree_map(jnp.zeros_like, pp),
                                _slabs(X, y, idx), jnp.asarray(erows), 0.0)
    tp = {k: _t(v, F32) for k, v in params.items()}
    tz = {k: torch.zeros_like(v) for k, v in tp.items()}
    p_t, _, _, losses = svi.svi_softmax_chunk_plain(tp, tz, dict(tz), _t(X, F32), _t(y, F32),
                                                    torch.tensor(idx), _t(eps, F32), 1e-5,
                                                    t0=0, lr=LR)
    assert _rel(losses, losses_j) <= 1e-3
    assert _rel(p_t["hyp"], np.asarray(p_j["hyp"])[0, :D_TR + 1]) <= 1e-3
    assert _rel(p_t["q_mu"], np.asarray(p_j["q_mu"])[:M_TR, :C]) <= 1e-3
    for c in range(C):
        assert _rel(p_t["q_raw"][c], np.asarray(p_j["q_raw"][c])[:M_TR, :M_TR]) <= 1e-3
