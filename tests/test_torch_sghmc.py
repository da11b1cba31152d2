"""The port's big-N path against the JAX package, on the CPU: SGHMC over the
collapsed bound from minibatch VFE statistics (``inference.sghmc``),
``SparseGPR``, the synthetic data sets and the SGHMC experiment; and the two
constructor faults repaired with them (the passed kernel's initial
outputscale, the JAX argument order).

SGHMC runs on the JAX key schedule's draws, injected (``draws=``), so both
packages make the same moves; float64 unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggp_tpu import kernels as jk
from ggp_tpu import priors as jpriors
from ggp_tpu.inference.sghmc import SGHMCConfig as JConfig
from ggp_tpu.inference.sghmc import run_sghmc as j_run_sghmc
from ggp_tpu.models import GPR_HMC as JaxGPR
from ggp_tpu.models import SGPMC as JaxSGPMC
from ggp_tpu.models import SparseGPR as JaxSparseGPR
from ggp_tpu.models import StochasticVariationalGP as JaxSVGP
from ggp_tpu.models.sgpr import _run_adam as j_run_adam
from ggp_tpu.models.sgpr import sgpr_elbo_from_stats as j_elbo_from_stats
from ggp_tpu.models.sgpr import vfe_stats as j_vfe_stats
from ggp_tpu.utils.datasets import get_regression_data as j_get_regression_data
from ggp_tpu_torch import GPR_HMC, SGPMC, BayesianSparseGPR_HMC, StochasticVariationalGP
from ggp_tpu_torch.experiments.large_scale_regression_sghmc import main as sghmc_main
from ggp_tpu_torch.inference.sghmc import SGHMCConfig, ravel_tree, run_sghmc
from ggp_tpu_torch.interop import tree_from_numpy
from ggp_tpu_torch.kernels import RBF, Scale, default_rbf
from ggp_tpu_torch.likelihoods import PoissonLogCox
from ggp_tpu_torch.models.sgpr import SparseGPR, sgpr_elbo_from_stats, vfe_stats
from ggp_tpu_torch.models.svgp import pack_svgp
from ggp_tpu_torch.ops import _build, svi
from ggp_tpu_torch.priors import Normal, log_prior, prior_tree_rbf
from ggp_tpu_torch.utils.datasets import get_regression_data

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of small CPU ops, which
    a thread pool only slows when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# f64: one step's gradient agrees to ~1e-14; 50 SGHMC steps (and 20 Adam
# steps) keep the trajectories within these bounds, while a wrong term or
# draw moves them by 1e-3 or more.
TRAJ_TOL = 1e-8


def _rel(a, b):
    a = np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach().cpu() if torch.is_tensor(b) else b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _data(seed=0, n=300, d=3, m=8):
    r = np.random.default_rng(seed)
    X = r.uniform(-2, 2, size=(n, d))
    y = np.sin(X @ r.normal(size=d)) + 0.1 * r.normal(size=n)
    Z = X[r.choice(n, m, replace=False)] + 0.05 * r.normal(size=(m, d))
    return X, y, Z


def _jax_draws(key, C, T, B, N, dim):
    """The draws ``ggp_tpu.inference.sghmc.run_sghmc`` makes from ``key``:
    per chain and step t = 1..T the minibatch rows, the friction noise and
    the refresh normals, and the initial jitter."""
    keys = jax.random.split(key, C)
    jkeys = jax.random.split(jax.random.fold_in(key, 7), C)
    init = jnp.stack([jax.random.normal(k, (dim,), jnp.float64) for k in jkeys])

    def chain(k):
        def step(k, _):
            k, kb, kn, km = jax.random.split(k, 4)
            return k, (jax.random.randint(kb, (B,), 0, N),
                       jax.random.normal(kn, (dim,), jnp.float64),
                       jax.random.normal(km, (dim,), jnp.float64))
        return jax.lax.scan(step, k, None, length=T)[1]

    idx, noise, refresh = jax.vmap(chain)(keys)
    return {k: torch.tensor(np.asarray(v)) for k, v in
            dict(idx=idx, noise=noise, refresh=refresh, init=init).items()}


def _sghmc_pair(X, y, Z, cfg_kw, sample_z=False, C=2, seed=3):
    """(JAX samples, JAX stats, port samples, port stats) of the same run."""
    N = X.shape[0]
    jitter = 1e-6
    jkern, kern = jk.Scale(jk.RBF(ard=True)), default_rbf(ard=True)
    jX, jy, jZ = (jnp.asarray(a) for a in (X, y, Z))
    tX, ty, tZ = (torch.tensor(a) for a in (X, y, Z))
    hyp = {"kernel": {"base": {"log_lengthscale": 0.1 * np.arange(X.shape[1])},
                      "log_outputscale": np.float64(0.2)}, "log_noise": np.float64(-2.0)}
    jprior, prior = jpriors.prior_tree_rbf(), prior_tree_rbf()
    if sample_z:
        jprior, prior = {**jprior, "Z": jpriors.Normal(0.0, 1.0)}, {**prior, "Z": Normal(0.0, 1.0)}
        hyp = {**hyp, "Z": Z}
    jinit = jax.tree_util.tree_map(jnp.asarray, hyp)
    tinit = tree_from_numpy(hyp)

    def jlp(state, idx=None):
        Z_ = state["Z"] if sample_z else jZ
        xb, yb = (jX, jy) if idx is None else (jX[idx], jy[idx])
        st = j_vfe_stats(jkern, state["kernel"], Z_, xb, yb)
        if idx is not None:
            st = jax.tree_util.tree_map(lambda s: s * (N / idx.shape[0]), st)
        ll = j_elbo_from_stats(jkern, {**state, "Z": Z_}, st, N, jitter)
        return ll + jpriors.log_prior(jprior, state)

    def tlp(state, idx=None):
        Z_ = state["Z"] if sample_z else tZ
        st = vfe_stats(kern, state["kernel"], Z_, tX, ty, idx)
        if idx is not None:
            st = {k: v * (N / idx.shape[1]) for k, v in st.items()}
        ll = sgpr_elbo_from_stats(kern, {**state, "Z": Z_}, st, N, jitter)
        return ll.sum() + log_prior(prior, state)

    cv = cfg_kw.get("control_variate", False)
    key = jax.random.PRNGKey(seed)
    js, jst = j_run_sghmc(jlp, jinit, key, N, JConfig(**cfg_kw), num_chains=C,
                          full_logpost_fn=jlp if cv else None)
    dim = ravel_tree(tinit)[0].shape[0]
    draws = _jax_draws(key, C, cfg_kw["num_steps"], cfg_kw["batch_size"], N, dim)
    ts, tst = run_sghmc(tlp, tinit, None, N, SGHMCConfig(**cfg_kw), num_chains=C,
                        full_logpost_fn=tlp if cv else None, draws=draws)
    return js, jst, ts, tst


BASE = dict(step_size=3e-3, final_step_size=1.5e-3, friction=0.05, num_steps=50,
            batch_size=32, thin=5, num_warmup=20, resample_momentum_every=10,
            anchor_refresh_every=20)


@pytest.mark.parametrize("variant", ["plain", "control_variate", "adapt_mass", "sample_z"])
def test_sghmc_matches_jax_on_shared_draws(variant):
    X, y, Z = _data(seed=1, n=300, d=3, m=6 if variant == "sample_z" else 8)
    cfg = dict(BASE)
    if variant in ("control_variate", "adapt_mass"):
        cfg[variant] = True
    js, jst, ts, tst = _sghmc_pair(X, y, Z, cfg, sample_z=variant == "sample_z")
    jflat = np.asarray(jax.vmap(jax.vmap(lambda t: jax.flatten_util.ravel_pytree(t)[0]))(js))
    got = _flat_samples(ts)
    assert tst["num_kept"] == jst["num_kept"] == 6 and got.shape == jflat.shape
    assert _rel(got, jflat) <= TRAJ_TOL
    assert _rel(tst["inv_mass"], jst["inv_mass"]) <= TRAJ_TOL
    # the JAX samples convert to the port's tree, in the same ravel order
    assert _rel(_flat_samples(tree_from_numpy(jax.device_get(js))), jflat) == 0.0
    # the chains moved, so a wrong draw or term would show
    assert float(np.abs(jflat[:, -1] - jflat[:, 0]).max()) > 1e-3
    if variant == "adapt_mass":
        assert float(tst["inv_mass"].min()) < 0.9


def _flat_samples(tree):
    """(C, kept, dim) rows in ravel order from a samples tree."""
    leaves = []

    def walk(t):
        for k in sorted(t):
            walk(t[k]) if isinstance(t[k], dict) else leaves.append(t[k])
    walk(tree)
    C, K = leaves[0].shape[:2]
    return torch.cat([v.reshape(C, K, -1) for v in leaves], -1)


def test_sghmc_generator_runs_are_reproducible_and_finite():
    X, y, Z = _data(seed=2)
    tX, ty, tZ = (torch.tensor(a) for a in (X, y, Z))
    kern = default_rbf(ard=True)

    def lp(state, idx):
        st = vfe_stats(kern, state["kernel"], tZ, tX, ty, idx)
        st = {k: v * (X.shape[0] / idx.shape[1]) for k, v in st.items()}
        return sgpr_elbo_from_stats(kern, {**state, "Z": tZ}, st, X.shape[0], 1e-6).sum()

    init = {"kernel": kern.init_params(3, dtype=F64, device="cpu"),
            "log_noise": torch.tensor(-1.0, dtype=F64)}
    cfg = SGHMCConfig(**{**BASE, "num_steps": 30})
    a, _ = run_sghmc(lp, init, torch.Generator().manual_seed(4), X.shape[0], cfg, 3)
    b, _ = run_sghmc(lp, init, torch.Generator().manual_seed(4), X.shape[0], cfg, 3)
    u, v = _flat_samples(a), _flat_samples(b)
    assert torch.equal(u, v) and torch.isfinite(u).all() and u.shape == (3, 2, 5)
    with pytest.raises(ValueError, match="full_logpost_fn"):
        run_sghmc(lp, init, None, X.shape[0], SGHMCConfig(control_variate=True))


def test_sparse_gpr_matches_jax_run_adam():
    """20 Adam steps (clip 100, box, noise floor) in float64 at
    well-conditioned data, where neither the lengthscale cap nor the masking
    binds; then the predictive and the optimal q(u)."""
    X, y, Z = _data(seed=5, n=80, d=3, m=6)
    jm = JaxSparseGPR(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z), jitter=1e-8)
    opt = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(100.0), optax.adam(0.02))
    jp, jl = j_run_adam(jm.kernel, jm.train_x, jm.train_y, 1e-8, jm.params, opt, 20)
    jm.params = jp
    tm = SparseGPR(X, y, Z_init=Z, jitter=1e-8, device="cpu")
    before = dict(_build.LAUNCHES)
    tl = tm.train_model(max_steps=20, lr=0.02, verbose=False)
    assert _build.LAUNCHES == before
    assert _rel(tl, jl) <= TRAJ_TOL
    ref = tree_from_numpy(jax.device_get(jp))
    assert _rel(ravel_tree(tm.params)[0], ravel_tree(ref)[0]) <= TRAJ_TOL
    Xt = np.random.default_rng(6).normal(size=(7, 3))
    for full in (False, True):
        jmu, jv = jm.posterior_predictive(jnp.asarray(Xt), full_cov=full)
        tmu, tv = tm.posterior_predictive(Xt, full_cov=full)
        assert _rel(tmu, jmu) <= TRAJ_TOL and _rel(tv, jv) <= TRAJ_TOL
    for a, b in zip(tm.optimal_q_u(), jm.optimal_q_u()):
        assert _rel(a, b) <= TRAJ_TOL
    assert _rel(tm.noise, jm.noise) <= TRAJ_TOL and torch.equal(tm.Z, tm.params["Z"])


def test_sparse_gpr_chunks_and_refusals():
    """A run longer than one chunk continues the Adam schedule across
    launches (200 + remainder equals one long plain run); unsupported
    options raise NotImplementedError naming the ROADMAP item."""
    X, y, Z = _data(seed=7, n=40, d=2, m=4)
    tm = SparseGPR(X, y, Z_init=Z, device="cpu")
    losses = tm.train_model(max_steps=230, lr=0.01, verbose=False)
    assert losses.shape == (230,) and torch.isfinite(losses).all()
    assert float(losses[-1]) < float(losses[0])
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        tm.train_model(optimizer=object())
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        SparseGPR(X, y, kernel=Scale(RBF(ard=False)), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        SparseGPR(X, y, likelihood=PoissonLogCox(), device="cpu")
    if not torch.cuda.is_available():        # the model defaults to the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SparseGPR(X, y)


@pytest.mark.parametrize("name", ["synthetic-small", "synthetic-mid", "synthetic-large"])
def test_synthetic_data_equal_jax(name):
    a, b = get_regression_data(name, split=1), j_get_regression_data(name, split=1)
    for k in ("X_train", "Y_train", "X_test", "Y_test"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.Y_std == b.Y_std
    with pytest.raises(ValueError, match="not in the repository"):
        get_regression_data("boston")


def test_experiment_runs_small():
    out = sghmc_main(n_rows=None, M=16, warm_iters=20, num_steps=60, device="cpu",
                     control_variate=True)
    assert out["finite"] and out["N"] == 13279 and out["components"] == 8
    assert np.isfinite(out["rmse"]) and np.isfinite(out["nlpd"])


# -- F1: the passed kernel's initial outputscale ------------------------------------------

def _f1_data(seed=8, n=60, d=3, m=5):
    X, y, Z = _data(seed=seed, n=n, d=d, m=m)
    return X, y, Z


def test_models_take_the_kernels_initial_outputscale():
    """Each model built with Scale(RBF-ARD, init_log_outputscale=0.5) starts
    where the JAX package's does."""
    X, y, Z = _f1_data()
    jkern, kern = jk.Scale(jk.RBF(ard=True), init_log_outputscale=0.5), \
        Scale(RBF(ard=True), init_log_outputscale=0.5)
    js = JaxSVGP(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z), kernel=jkern)
    ts = StochasticVariationalGP(X, y, Z_init=Z, kernel=kern, device="cpu")
    assert float(ts.params["kernel"]["log_outputscale"]) == 0.5
    assert float(js.params["kernel"]["log_outputscale"]) == 0.5
    jg = JaxGPR(jnp.asarray(X), jnp.asarray(y), kernel=jkern)
    tg = GPR_HMC(X, y, kernel=kern, device="cpu")
    assert torch.equal(tg.params, torch.tensor(np.r_[np.zeros(3), 0.5, 0.0]))
    assert float(jg.params["kernel"]["log_outputscale"]) == 0.5
    jp = JaxSGPMC(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z), kernel=jkern)
    tp = SGPMC(X, y, Z_init=Z, kernel=kern, device="cpu")
    assert float(tp.flat[3]) == float(jp.state["kernel"]["log_outputscale"]) == 0.5
    tb = BayesianSparseGPR_HMC(X, y, Z_init=Z, kernel=kern, device="cpu")
    assert float(tb.theta[3]) == 0.5


def test_f1_first_chunk_matches_jax_at_outputscale_half():
    """One SGPMC warm-start chunk and one SVGP epoch (on the JAX key
    schedule's minibatches) from the kernel's initial outputscale 0.5,
    against the JAX package in float64."""
    X, y, Z = _f1_data(n=40)
    jkern, kern = jk.Scale(jk.RBF(ard=True), init_log_outputscale=0.5), \
        Scale(RBF(ard=True), init_log_outputscale=0.5)
    jp = JaxSGPMC(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z), kernel=jkern)
    jp.warm_start(num_steps=10, lr=0.01)
    tp = SGPMC(X, y, Z_init=Z, kernel=kern, device="cpu")
    tp.warm_start(num_steps=10, lr=0.01)
    jflat = np.concatenate([np.asarray(jp.state["kernel"]["base"]["log_lengthscale"]),
                            [jp.state["kernel"]["log_outputscale"],
                             jp.state["lik"]["log_noise"]], np.asarray(jp.state["v"])])
    assert _rel(tp.flat, jflat) <= TRAJ_TOL and _rel(tp.Z, jp.Z) <= TRAJ_TOL

    key, bs, lr = jax.random.PRNGKey(4), 10, 0.02
    js = JaxSVGP(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z), kernel=jkern)
    ts = StochasticVariationalGP(X, y, Z_init=Z, kernel=kern, device="cpu")
    p = pack_svgp(ts.params, "gauss")
    losses_j = js.train_model(num_epochs=1, batch_size=bs, lr=lr, key=key)
    steps = X.shape[0] // bs
    idx = np.asarray(jax.random.permutation(jax.random.split(key, 1)[0], X.shape[0])
                     [:steps * bs]).reshape(steps, bs)
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    out, _, _, losses = svi.svi_chunk(p, zeros, dict(zeros), torch.tensor(X), torch.tensor(y),
                                      torch.tensor(idx), 1e-8, likelihood="gauss", t0=0, lr=lr)
    ref = pack_svgp(tree_from_numpy(jax.device_get(js.params)), "gauss")
    for k in svi.SVI_NAMES:
        assert _rel(out[k], ref[k]) <= TRAJ_TOL, k
    assert _rel(losses.mean(), np.asarray(losses_j)[0]) <= TRAJ_TOL


# -- F2: the JAX constructor order -------------------------------------------------------

def test_constructors_take_the_jax_argument_order():
    X, y, Z = _f1_data()
    lik = None
    kern = Scale(RBF(ard=True))
    b = BayesianSparseGPR_HMC(X, y, lik, Z, kern, prior_tree_rbf(), 1e-6, None, device="cpu")
    assert torch.equal(b.Z, torch.tensor(Z)) and b.jitter == 1e-6
    s = SGPMC(X, y, lik, Z, kern, None, 1e-6, None, None, None, device="cpu")
    assert torch.equal(s.Z, torch.tensor(Z)) and s.jitter == 1e-6
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        BayesianSparseGPR_HMC(X, y, None, Z, None, None, None, object(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        BayesianSparseGPR_HMC(X, y, PoissonLogCox(), Z, device="cpu")
    with pytest.raises(NotImplementedError, match="Scale\\(RBF-ARD\\)"):
        BayesianSparseGPR_HMC(X, y, Z_init=Z, kernel=Scale(RBF(ard=False)), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        SGPMC(X, y, None, Z, None, None, None, object(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        SGPMC(X, y, Z_init=Z, mean_prior_tree={}, device="cpu")
