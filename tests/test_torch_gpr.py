"""The port's GPR+HMC path (the dense "gpr" core) against the JAX package,
on the CPU.

The plain potential (``ggp_tpu_torch.ops.gpr_bound``) against the JAX
core's factory ``make_gpr_potential`` and against jax.value_and_grad of the
model's log posterior; the plain NUTS warm chunk on the gpr core against
``make_fused_nuts(target="gpr", interpret=True)`` on shared slabs; the
model (``ggp_tpu_torch.models.gpr_hmc``) against ``ggp_tpu.models.GPR_HMC``:
the mixture predictive on a shared trace, C-chain marginals by KS, and the
trace interop. n=40, d=3 (state dim 5), float64 unless stated. The
interpret-mode sample chunk is ``slow``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ggp_tpu import priors as jpriors
from ggp_tpu.inference import hmc as jhmc
from ggp_tpu.models import GPR_HMC as JaxGPR
from ggp_tpu.ops.fused_bound import make_gpr_potential as jax_make_gpr_potential
from ggp_tpu.ops.fused_bound import prior_spec_of_tree as jax_spec_of_tree
from ggp_tpu.ops.fused_nuts import make_fused_nuts
from ggp_tpu_torch import GPR_HMC, gp_marginal_loglik
from ggp_tpu_torch import priors as tpriors
from ggp_tpu_torch.interop import params_from_jax, params_to_numpy
from ggp_tpu_torch.kernels import RBF, Scale, default_rbf
from ggp_tpu_torch.likelihoods import GaussianLikelihood
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.gpr_bound import gpr_neg_logpost_vg, make_gpr_potential
from ggp_tpu_torch.ops.linalg import capped_inv_ls
from ggp_tpu_torch.ops.multichain import hmc_chunk, make_multichain, mc_potential
from ggp_tpu_torch.ops.nuts_chunk import ChainState, nuts_chunk, nuts_chunk_plain
from ggp_tpu_torch.ops.vfe_bound import prior_spec_of_tree, vfe_potential

F32, F64 = torch.float32, torch.float64
N, D, JITTER = 40, 3, 1e-8
DIM = D + 2
# One f64 evaluation: the same algebra on both sides up to summation order
# and factorisation (~1e-14 relative); a wrong term moves a result by
# O(1e-3) or more.
TOL64 = 1e-10
# Against jax.value_and_grad of the model's log posterior: autodiff through
# LAPACK's Cholesky, and the kernel gram formed as sq_dist(x / ls) rather
# than from x * exp(-log_ls): a few ulps of cond(K) ~ 1e3 more.
GRAD_TOL = 1e-8


def _rel(a, b):
    """max |a - b| / max |b| (norm-relative)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _problem(seed=0, n=N):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, D))
    y = np.sin(X @ r.normal(size=D)) + 0.2 * r.normal(size=n)
    return X, y


# rows [log_ls (d), log_os, log_noise]; the last has lengthscale 0 capped:
# exp(8) > 1024 / max|X|. At the cap the largest scaled coordinate is 1024,
# and the lengthscale gradient sums terms of size P_ij |x_i|^2 that cancel
# (its diagonal ones exactly): summation order then shows at ~1e-10 of the
# gradient when max|X| is a typical entry. That row's data carries one
# outlier in another input, so the capped input's scaled entries are ~50,
# not ~400, and the check keeps its 1e-10.
ROWS = [np.r_[np.zeros(D), 0.0, 0.0],
        np.r_[0.3, -0.4, 0.8, 0.5, -2.0],
        np.r_[-1.0, 0.7, 0.2, -0.6, -3.5],
        np.r_[-8.0, 0.1, 0.4, 0.2, -1.5]]


def _trees():
    """The default tree and one of other closed-form families, in both
    packages."""
    other_t = {"kernel": {"log_outputscale": tpriors.LogNormal(0.1, 1.5),
                          "base": {"log_lengthscale": tpriors.HalfNormal(2.0)}},
               "log_noise": tpriors.Gamma(3.0, 2.0)}
    other_j = {"kernel": {"log_outputscale": jpriors.LogNormal(0.1, 1.5),
                          "base": {"log_lengthscale": jpriors.HalfNormal(2.0)}},
               "log_noise": jpriors.Gamma(3.0, 2.0)}
    return [(tpriors.prior_tree_rbf(), jpriors.prior_tree_rbf()), (other_t, other_j)]


# -- the potential ------------------------------------------------------------------

@pytest.mark.parametrize("tree", [0, 1])
@pytest.mark.parametrize("row", range(len(ROWS)))
def test_potential_matches_fused_core(row, tree):
    """The plain potential against the JAX core's factory (XLA level, rows
    padded to 128) under the default and another prior tree: value and
    gradient to 1e-10 relative, the capped row included."""
    X, y = _problem()
    tree_t, tree_j = _trees()[tree]
    theta = ROWS[row]
    if row == len(ROWS) - 1:
        X[0, 2] = 20.0
    Uj, gj = jax_make_gpr_potential(jnp.asarray(X), jnp.asarray(y), JITTER,
                                    prior_spec=jax_spec_of_tree(tree_j))(jnp.asarray(theta))
    Ut, gt = gpr_neg_logpost_vg(*(torch.tensor(a) for a in (theta, X, y)), JITTER,
                                prior_spec=prior_spec_of_tree(tree_t))
    assert _rel(Ut, Uj) <= TOL64 and _rel(gt, gj) <= TOL64
    if row == len(ROWS) - 1:        # the cap is active there and only there
        il = capped_inv_ls(torch.tensor(theta[:D]), torch.tensor(X))
        assert float(il[0]) < np.exp(8.0) and torch.equal(il[1:], torch.exp(-torch.tensor(theta[1:D])))


@pytest.mark.parametrize("row", range(len(ROWS) - 1))
def test_potential_matches_jax_grad_of_logpost(row):
    """U and dU/dtheta against jax.value_and_grad of -(gp_marginal_loglik +
    log_prior) of the JAX model (no cap there; these rows are below it)."""
    X, y = _problem(1)
    jm = JaxGPR(jnp.asarray(X), jnp.asarray(y))
    _, unravel = ravel_pytree(jm.params)
    data = (jnp.asarray(X), jnp.asarray(y))
    Uj, gj = jax.value_and_grad(lambda z: -jm._logpost(unravel(z), data))(
        jnp.asarray(ROWS[row]))
    t = [torch.tensor(a) for a in (ROWS[row], X, y)]
    Ut, gt = gpr_neg_logpost_vg(*t, jm.jitter)
    assert _rel(Ut, Uj) <= GRAD_TOL and _rel(gt, gj) <= GRAD_TOL
    # and the port's own marginal at that row
    tm = GPR_HMC(X, y, device="cpu")
    tm.params = t[0]
    ll = gp_marginal_loglik(tm.kernel, tm.hypers, t[1], t[2], tm.jitter)
    assert _rel(ll, jm._logpost(unravel(jnp.asarray(ROWS[row])), data)
                - jpriors.log_prior(jm.prior_tree, unravel(jnp.asarray(ROWS[row])))) <= GRAD_TOL


def test_non_psd_gives_nan_and_does_not_raise():
    """A diagonal shift that makes K indefinite: NaN value and gradient
    (the samplers' divergence), through the plain version and the wrapper."""
    X, y = _problem(2)
    theta = torch.tensor(np.r_[np.zeros(D), -3.0, 0.0])
    U, g = gpr_neg_logpost_vg(theta, torch.tensor(X), torch.tensor(y), -1.5)
    assert torch.isnan(U) and torch.isnan(g).all()
    U2, g2 = make_gpr_potential(torch.tensor(X), torch.tensor(y), -1.5)(theta)
    assert torch.isnan(U2) and torch.isnan(g2).all()


def test_wrappers_take_the_gpr_core_and_refuse_what_it_lacks():
    """The wrappers run the plain version on CPU tensors without a launch;
    the gpr core takes an empty Z, none of the trainers' options, and has no
    HMC chunk (no model runs one); the build module lists no such entry."""
    X, y = (torch.tensor(a) for a in _problem(3))
    Z = X.new_empty((0, D))
    theta = torch.tensor(ROWS[1])
    before = dict(_build.LAUNCHES)
    a = vfe_potential(theta, X, y, Z, JITTER, core="gpr")
    b = gpr_neg_logpost_vg(theta, X, y, JITTER)
    c = mc_potential(torch.stack([theta, theta + 0.1]), X, y, Z, JITTER, core="gpr")
    assert _build.LAUNCHES == before
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(c[0][0], b[0]) and torch.equal(c[1][0], b[1])
    with pytest.raises(ValueError, match="empty Z"):
        vfe_potential(theta, X, y, X[:4], JITTER, core="gpr")
    with pytest.raises(ValueError, match="empty Z"):
        vfe_potential(theta, X, y, Z, JITTER)                  # vfe needs m >= 1
    with pytest.raises(ValueError, match="sampler target"):
        vfe_potential(theta, X, y, Z, JITTER, core="gpr", want_prior=False)
    with pytest.raises(ValueError, match="hmc_chunk"):
        make_multichain(X, y, Z, JITTER, num_chains=2, algo="hmc", core="gpr")
    zero = torch.zeros((), dtype=F64)
    st = ChainState(z=theta, U=b[0], g=b[1], inv_mass=torch.ones(DIM, dtype=F64),
                    log_eps=zero, log_eps_avg=zero, h_avg=zero, mu=zero, t_da=zero,
                    wf_mean=torch.zeros(DIM, dtype=F64), wf_m2=torch.zeros(DIM, dtype=F64),
                    wf_count=zero)
    with pytest.raises(ValueError, match="hmc_chunk"):
        hmc_chunk(st, X, y, Z, JITTER, mom=torch.zeros((2, DIM), dtype=F64),
                  mh=torch.zeros(2, dtype=F64), n_active=2, adapt=False, eps=0.1,
                  core="gpr")
    assert "ggp_hmc_chunk_gpr" not in _build._SIGS and "gpr_hmc_chunk" not in _build.LAUNCHES
    assert {"ggp_potential_gpr", "ggp_nuts_chunk_gpr"} <= set(_build._SIGS)
    assert {"gpr_potential", "gpr_nuts_chunk", "gpr_mc_potential",
            "gpr_mc_nuts_chunk"} <= set(_build.LAUNCHES)
    for core, kinds in _build.CORE_KINDS.items():   # every kind has its entry
        for k in kinds:
            assert f"ggp_{k.removeprefix('mc_')}_{core}" in _build._SIGS


# -- the NUTS warm chunk on the gpr core ---------------------------------------------

K, MAX_DEPTH = 4, 4
# f32 on both sides; the JAX kernel factorises the row-padded (128, 128) K
# with a blocked Cholesky and inverse, the port with LAPACK: per-evaluation
# differences of ~1e-6 relative grow along a few leapfrogs; 1e-4 holds them
# while any wrong branch (another leaf or tree) moves z by O(eps) = O(0.1).
CHUNK_TOL = 1e-4


def _slabs(key, k_steps=K):
    """``_rand`` of make_fused_nuts, then the compact slices the port reads."""
    k1, k2, k3 = jax.random.split(key, 3)
    mom = np.asarray(jax.random.normal(k1, (k_steps, 128), jnp.float32))
    treeu = np.asarray(jax.random.uniform(k2, (k_steps * MAX_DEPTH, 128), jnp.float32))
    leafu = np.asarray(jax.random.uniform(k3, (k_steps, 128), jnp.float32))
    return (torch.tensor(mom[:, :DIM]),
            torch.tensor(treeu.reshape(k_steps, MAX_DEPTH, 128)[:, :, :2].copy()),
            torch.tensor(leafu[:, :1 << MAX_DEPTH].copy()))


def _f32_problem():
    X, y = (a.astype(np.float32) for a in _problem(4))
    theta = np.r_[np.zeros(D), 0.3, -1.0].astype(np.float32)
    return theta, X, y


def _fused_gpr(X, y):
    return make_fused_nuts(X, y, 1e-5, max_depth=MAX_DEPTH, chunk=K, interpret=True,
                           target="gpr")(jnp.zeros((1, D), jnp.float32))


def test_warm_chunk_matches_pallas_interpret():
    """Warm chunk with a window inside (in-window steps 1-3, window end at
    step 2): state, dual averaging, Welford and inverse mass after the
    chunk, plus the summed accept and divergence counts."""
    theta, X, y = _f32_problem()
    th, Xt, yt = (torch.tensor(a) for a in (theta, X, y))
    U0, g0 = gpr_neg_logpost_vg(th, Xt, yt, 1e-5)
    key = jax.random.PRNGKey(11)
    mom, treeu, leafu = _slabs(key)
    le = np.float32(np.log(0.25))
    in_w = np.array([False, True, True, True])
    w_end = np.array([False, False, True, False])
    da = jhmc.DAState(*(jnp.asarray(v, jnp.float32) for v in
                        (le, le, 0.0, np.log(10.0) + le, 0.0)))
    zj, Uj, gj, daj, wfj, imj, acc_j, div_j = _fused_gpr(X, y).warm_chunk(
        jnp.asarray(theta), jnp.asarray(U0.item(), jnp.float32),
        jnp.asarray(g0.numpy()), key, da, jhmc.welford_init(DIM, jnp.float32),
        jnp.ones(DIM, jnp.float32), jnp.asarray(in_w), jnp.asarray(w_end), K)

    f = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    st = ChainState(z=th, U=U0, g=g0, inv_mass=torch.ones(DIM), log_eps=f(le),
                    log_eps_avg=f(le), h_avg=f(0.0), mu=f(np.log(10.0) + le),
                    t_da=f(0.0), wf_mean=torch.zeros(DIM), wf_m2=torch.zeros(DIM),
                    wf_count=f(0.0))
    before = dict(_build.LAUNCHES)
    s, _, stats = nuts_chunk(st, Xt, yt, Xt.new_empty((0, D)), 1e-5, mom=mom,
                             treeu=treeu, leafu=leafu, n_active=K, adapt=True,
                             in_window=torch.tensor(in_w), window_end=torch.tensor(w_end),
                             max_depth=MAX_DEPTH, core="gpr")
    assert _build.LAUNCHES == before
    assert float(stats[:, 4].sum()) > K                  # trees of more than one leaf
    assert float(stats[:, 2].sum()) == float(div_j)
    np.testing.assert_allclose(float(stats[:, 1].sum()), float(acc_j), rtol=CHUNK_TOL,
                               atol=CHUNK_TOL)
    for a, b in ((s.z, zj), (s.U, Uj), (s.g, gj), (s.inv_mass, imj),
                 (s.wf_mean, wfj.mean), (s.wf_m2, wfj.m2), (s.wf_count, wfj.count),
                 (s.log_eps, daj.log_eps), (s.log_eps_avg, daj.log_eps_avg),
                 (s.h_avg, daj.h_avg), (s.mu, daj.mu), (s.t_da, daj.t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=CHUNK_TOL, atol=CHUNK_TOL)


@pytest.mark.slow
def test_sample_chunk_matches_pallas_interpret():
    """Fixed-step chunk: per-draw z and accept to 1e-4; tree depth,
    leapfrog count and divergence flags exactly."""
    theta, X, y = _f32_problem()
    th, Xt, yt = (torch.tensor(a) for a in (theta, X, y))
    U0, g0 = gpr_neg_logpost_vg(th, Xt, yt, 1e-5)
    key = jax.random.PRNGKey(3)
    eps = np.float32(0.2)
    zs, _, ufin, gfin, stj = _fused_gpr(X, y).sample_chunk(
        jnp.asarray(theta), jnp.asarray(U0.item(), jnp.float32), jnp.asarray(g0.numpy()),
        key, jnp.asarray(eps), jnp.ones(DIM, jnp.float32), K)
    mom, treeu, leafu = _slabs(key)
    zero = torch.zeros(())
    st = ChainState(z=th, U=U0, g=g0, inv_mass=torch.ones(DIM), log_eps=zero,
                    log_eps_avg=zero, h_avg=zero, mu=zero, t_da=zero,
                    wf_mean=torch.zeros(DIM), wf_m2=torch.zeros(DIM), wf_count=zero)
    s, draws, stats = nuts_chunk_plain(st, Xt, yt, Xt.new_empty((0, D)), 1e-5, mom=mom,
                                       treeu=treeu, leafu=leafu, n_active=K, adapt=False,
                                       eps=torch.tensor(eps), max_depth=MAX_DEPTH,
                                       core="gpr")
    np.testing.assert_array_equal(stats[:, 3].numpy(), np.asarray(stj["depth"]))
    np.testing.assert_array_equal(stats[:, 4].numpy(), np.asarray(stj["n_leapfrog"]))
    np.testing.assert_array_equal(stats[:, 2].numpy() > 0.5, np.asarray(stj["diverging"]))
    np.testing.assert_allclose(draws.numpy(), np.asarray(zs), rtol=CHUNK_TOL, atol=CHUNK_TOL)
    np.testing.assert_allclose(stats[:, 1].numpy(), np.asarray(stj["accept_prob"]),
                               rtol=CHUNK_TOL, atol=CHUNK_TOL)
    np.testing.assert_allclose(s.U.numpy(), float(ufin), rtol=CHUNK_TOL, atol=CHUNK_TOL)
    np.testing.assert_allclose(s.g.numpy(), np.asarray(gfin), rtol=CHUNK_TOL, atol=CHUNK_TOL)


# -- the model -------------------------------------------------------------------------

def _trace(S=12, seed=8):
    """Trace rows near a plausible posterior; row 3 has a sampled noise
    variance below 1e-4 (clamped to 0.01), row 7 an outputscale that
    overflows (a component the predictive masks out)."""
    r = np.random.default_rng(seed)
    tr = np.r_[0.2, -0.1, 0.3, 0.1, -2.5] + 0.2 * r.normal(size=(S, DIM))
    tr[3, D + 1] = -11.0
    tr[7, D] = 800.0
    return tr


@pytest.mark.parametrize("noise_floor", [True, False])
def test_full_mixture_predictive_matches_jax(noise_floor):
    """At a shared trace (set through the interop): every component's
    mean and variance to 1e-9, the clamp and the mask included."""
    X, y = _problem(9)
    Xt = np.random.default_rng(10).normal(size=(15, D))
    tr = _trace()
    jm = JaxGPR(jnp.asarray(X), jnp.asarray(y))
    jm.trace = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(torch.tensor(tr)))
    tm = GPR_HMC(X, y, device="cpu")
    tm.trace = params_from_jax(jax.device_get(jm.trace))
    mj, vj = jm.full_mixture_posterior_predictive(jnp.asarray(Xt), noise_floor=noise_floor)
    mt, vt = tm.full_mixture_posterior_predictive(Xt, noise_floor=noise_floor)
    assert mt.shape == (11, 15) == mj.shape                # row 7 masked
    assert _rel(mt, mj) <= 1e-9 and _rel(vt, vj) <= 1e-9
    if noise_floor:                                        # row 3's noise is 0.01
        assert bool((vt[3] >= 0.01).all())


@pytest.fixture(scope="module")
def jax_two_chains():
    """The JAX model's C-chain run (its vmapped XLA sampler): 2 chains x
    (100 warmup + 200 draws) from params 0."""
    X, y = _problem(6)
    jm = JaxGPR(jnp.asarray(X), jnp.asarray(y))
    tr = jm.train_model(num_warmup=100, num_samples=200, num_chains=2,
                        key=jax.random.PRNGKey(0))
    return X, y, jax.device_get(tr)


def _ks(a, b):
    grid = np.sort(np.concatenate([a, b]))
    fa = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    fb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return float(np.max(np.abs(fa - fb)))


def test_model_two_chains_marginals_match_jax(jax_two_chains):
    """2 chains x (100 + 200) of NUTS per side, f64, one posterior: every
    marginal's two-sample KS statistic < 0.2. Between two seeds of one
    package it is 0.08-0.13 at 400 draws (the noise floor); a wrong
    potential or adaptation moves marginals far beyond."""
    X, y, jtr = jax_two_chains
    tm = GPR_HMC(X, y, device="cpu")
    before = dict(_build.LAUNCHES)
    ttr = tm.train_model(100, 200, num_chains=2, generator=torch.Generator().manual_seed(0))
    assert _build.LAUNCHES == before
    a = params_from_jax(jtr).numpy()
    assert ttr.shape == a.shape == (400, DIM)
    assert tm.stats["accept_prob"].shape == (2, 200) and tm.stats["step_size"].shape == (2,)
    assert tm.stats["warmup_n_leapfrog"].shape == (2, 100)
    assert float(tm.stats["diverging"].float().mean()) <= 0.1
    for j in range(DIM):
        assert _ks(a[:, j], ttr[:, j].numpy()) < 0.2, (j, _ks(a[:, j], ttr[:, j].numpy()))


def test_interop_round_trip(jax_two_chains):
    """A JAX GPR_HMC trace converts to the port's (S, d+2) rows in the
    ravel order of its params and back, unchanged."""
    _, _, jtr = jax_two_chains
    rows = params_from_jax(jtr)
    flat0, _ = ravel_pytree(jax.tree_util.tree_map(lambda v: jnp.asarray(v[0]), jtr))
    np.testing.assert_array_equal(np.asarray(flat0), rows[0].numpy())
    back = params_to_numpy(rows)
    for u, v in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jtr)):
        np.testing.assert_array_equal(u, np.asarray(v))
    assert torch.equal(params_from_jax(back), rows)


def test_model_one_chain_runs_plain_on_cpu():
    """bench.py's protocol shape at a small size: one chain of NUTS, finite
    draws of the state's width, stats per draw, no kernel launched."""
    X, y = _problem(11)
    tm = GPR_HMC(X, y, device="cpu")
    before = dict(_build.LAUNCHES)
    tr = tm.train_model(20, 6, generator=torch.Generator().manual_seed(2), max_depth=5)
    assert _build.LAUNCHES == before
    assert tr.shape == (6, DIM) and torch.isfinite(tr).all()
    assert tm.stats["n_leapfrog"].shape == (6,) and float(tm.stats["depth"].max()) <= 5
    assert tm.stats["warmup_n_leapfrog"].shape == (20,)
    assert bool((tm.stats["warmup_n_leapfrog"] >= 1).all())
    means, vars_ = tm.full_mixture_posterior_predictive(X[:5])
    assert means.shape == (6, 5) and (vars_ > 0).all()


def test_model_refuses_what_the_port_does_not_carry():
    X, y = _problem()

    class Other(GaussianLikelihood):
        pass

    for kw, what in ((dict(kernel=Scale(RBF(ard=False))), "RBF-ARD"),
                     (dict(likelihood=Other()), "likelihoods"),
                     (dict(prior_tree={"kernel": tpriors.Gamma(2.0, 1.0)}), "prior"),
                     (dict(mesh=object()), "mesh")):
        with pytest.raises(NotImplementedError, match=what):
            GPR_HMC(X, y, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="128"):
        GPR_HMC(np.zeros((5, 127)), np.zeros(5), device="cpu")
    GPR_HMC(X, y, kernel=default_rbf(), likelihood=GaussianLikelihood(), device="cpu")


def test_model_default_device_is_the_card():
    """Without ``device`` the model's tensors go to the card; where there is
    none (this suite's machine) construction raises instead of running the
    plain versions."""
    X, y = _problem()
    if torch.cuda.is_available():
        assert GPR_HMC(X, y).train_x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GPR_HMC(X, y)
    m = GPR_HMC(X, y, device="cpu")
    assert m.train_x.device.type == "cpu" and m.params.shape == (DIM,)
    assert m.jitter == 1e-8 and GPR_HMC(X.astype(np.float32), y, device="cpu").jitter == 1e-5
