"""The port's Mauna Loa CO2 path against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through both packages: the
kernel classes and ``co2_kernel``'s grams; the plain co2 potential against
``make_co2_vfe_potential`` and autograd; ``co2_fused_spec``; the 11-lane
ravel order and the parameter exchange; the one-transition and warm-chunk
plain versions and the chunked driver against the interpret-mode
``make_fused_nuts(target="co2_m32")`` on slabs rebuilt from the JAX keys;
the autograd warm start against ``_adam_all``; the mixture predictive; the
experiment's data. The chunked driver's interpret-mode comparison (~30 s,
most of it JAX compiles) is marked ``slow``; unmarked, the driver is held
to the plain warm chunk, which is held to the interpret-mode one. The
``cuda``-marked counterparts are in ``tests/test_torch_cuda.py``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ggp_tpu import kernels as jk
from ggp_tpu.inference import hmc as jhmc
from ggp_tpu.likelihoods import BernoulliProbit as JBernoulliProbit
from ggp_tpu.likelihoods import GaussianLikelihood as JGaussian
from ggp_tpu.models import BayesianSparseGPR_HMC as JModel
from ggp_tpu.models.bayesian_sgpr_hmc import _adam_all
from ggp_tpu.ops.fused_bound import co2_fused_spec as j_co2_fused_spec
from ggp_tpu.ops.fused_bound import make_co2_vfe_potential as j_make_co2_potential
from ggp_tpu.ops.fused_nuts import make_fused_nuts
from ggp_tpu.priors import Gamma as JGamma
from ggp_tpu.priors import LogNormal as JLogNormal
from ggp_tpu_torch import kernels as tk
from ggp_tpu_torch.experiments.co2_bayesian_sgpr_hmc import co2_prior_tree, init_co2_params
from ggp_tpu_torch.experiments.co2_data import load_co2_dataset
from ggp_tpu_torch.inference import hmc as thmc
from ggp_tpu_torch.interop import params_from_jax, params_to_numpy, tree_from_numpy
from ggp_tpu_torch.likelihoods import BernoulliProbit, GaussianLikelihood
from ggp_tpu_torch.models import BayesianSparseGPR_HMC
from ggp_tpu_torch.models.sgpr import sgpr_elbo
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.co2_bound import (co2_fused_spec, co2_potential,
                                         co2_vfe_neg_logpost_vg, make_co2_vfe_potential)
from ggp_tpu_torch.ops.nuts_chunk import (ChainState, nuts_chunk_plain, nuts_transition,
                                          nuts_transition_plain)
from ggp_tpu_torch.priors import Gamma, LogNormal, log_prior
from ggp_tpu_torch.utils.tree import ravel, tree_map, unravel

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "experiments"))

F32, F64 = torch.float32, torch.float64
N, M, JITTER = 40, 8, 1e-6
# f32 on both sides of a NUTS comparison (the JAX kernel's blocked
# factorisation against LAPACK), at the experiment's jitter: per-evaluation
# differences of ~1e-6 relative grow along a few leapfrogs; a wrong branch
# moves z by O(eps). Vectors are held norm-relative (the largest entry's
# error), as chip_smoke.py holds them.
NUTS_TOL, NUTS_JITTER = 1e-4, 1e-4
F32_EVAL_TOL = 1e-3
MD = 4                       # max tree depth of the NUTS comparisons


def _data(seed=3):
    """1-D inputs in years around 0 (the experiment's axis), y with a
    seasonal cycle and a trend; Z a subset of X (coincident points, as the
    experiment's Z = X[:480])."""
    r = np.random.default_rng(seed)
    X = np.sort(r.uniform(-3.0, 3.0, N))[:, None]
    y = np.sin(2 * np.pi * X[:, 0]) + 0.05 * X[:, 0] ** 2 + 0.1 * r.normal(size=N)
    return X, y, X[::N // M][:M].copy()


def _like(kernel, dt=F64):
    return {"kernel": kernel.init_params(1, dtype=dt, device="cpu"),
            "log_noise": torch.zeros((), dtype=dt)}


def _jtree(flat, kernel):
    """The JAX hyper tree (numpy leaves) of a flat 11-lane vector."""
    _, unr = ravel_pytree({"kernel": kernel.init_params(1), "log_noise": jnp.zeros(())})
    return jax.tree_util.tree_map(np.asarray, unr(jnp.asarray(flat)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- kernels ------------------------------------------------------------------------------

KERNEL_PAIRS = {
    "matern32": (jk.Matern32(ard=False), tk.Matern32(ard=False)),
    "matern32_ard": (jk.Matern32(), tk.Matern32()),
    "rq": (jk.RationalQuadratic(ard=False), tk.RationalQuadratic(ard=False)),
    "periodic_fixed": (jk.Periodic(fixed_period=1.0), tk.Periodic(fixed_period=1.0)),
    "periodic": (jk.Periodic(), tk.Periodic()),
    "sum": (jk.Scale(jk.RBF(ard=False)) + jk.Scale(jk.Matern32(ard=False)),
            tk.Scale(tk.RBF(ard=False)) + tk.Scale(tk.Matern32(ard=False))),
    "product": (jk.Periodic(fixed_period=1.0) * jk.RBF(ard=False),
                tk.Periodic(fixed_period=1.0) * tk.RBF(ard=False)),
    "co2_m32": (jk.co2_kernel("matern32"), tk.co2_kernel("matern32")),
    "co2_rbf": (jk.co2_kernel("rbf"), tk.co2_kernel("rbf")),
}


@pytest.mark.parametrize("name", list(KERNEL_PAIRS))
def test_kernel_grams_match_jax(name):
    """gram and diag of each new kernel class, and of co2_kernel, at random
    parameters, with coincident points (Z rows are X rows): <= 1e-12."""
    jkern, tkern = KERNEL_PAIRS[name]
    X, _, Z = _data()
    r = np.random.default_rng(5)
    jp = jax.tree_util.tree_map(lambda a: np.asarray(0.4 * r.normal(size=np.shape(a))),
                                jkern.init_params(1))
    tp = tree_from_numpy(jp)
    for a, b in ((X, Z), (Z, Z), (X, X)):
        want = np.asarray(jkern.gram(jp, jnp.asarray(a), jnp.asarray(b)))
        got = tkern.gram(tp, torch.tensor(a), torch.tensor(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tkern.diag(tp, torch.tensor(X)).numpy(),
                               np.asarray(jkern.diag(jp, jnp.asarray(X))), rtol=1e-12)


def test_kernel_grams_broadcast_over_leading_parameter_rows():
    """S rows of parameters give S grams (the batched ELBO of optimize_Z)."""
    X, _, Z = _data()
    kern = tk.co2_kernel("matern32")
    like = _like(kern)
    rows = torch.tensor(np.random.default_rng(1).normal(size=(3, 11)) * 0.3)
    batched = kern.gram(unravel(rows, like)["kernel"], torch.tensor(Z), torch.tensor(X))
    for s in range(3):
        one = kern.gram(unravel(rows[s], like)["kernel"], torch.tensor(Z), torch.tensor(X))
        torch.testing.assert_close(batched[s], one, rtol=1e-14, atol=1e-14)


# -- the plain potential --------------------------------------------------------------------

@pytest.mark.parametrize("nc,kname", [("m32", "matern32"), ("rbf", "rbf")])
@pytest.mark.parametrize("seed", [0, 1])
def test_co2_potential_matches_jax_and_autograd(nc, kname, seed):
    """U and the 11-lane gradient against the JAX package's
    make_co2_vfe_potential and against torch autograd of -(sgpr_elbo +
    log_prior) on co2_kernel: <= 1e-9 relative."""
    X, y, Z = _data()
    th = np.random.default_rng(seed).normal(size=11) * 0.5
    Uj, gj = j_make_co2_potential(jnp.asarray(X), jnp.asarray(y), JITTER,
                                  noise_comp=nc)(jnp.asarray(th), jnp.asarray(Z))
    t = [torch.tensor(a) for a in (th, X, y, Z)]
    U, g = co2_vfe_neg_logpost_vg(*t, JITTER, noise_comp=nc)
    assert _rel(U, Uj) <= 1e-9 and _rel(g, gj) <= 1e-9

    kern = tk.co2_kernel(kname)
    like = _like(kern)
    prior = {"kernel": tree_map(lambda _: LogNormal(0.0, 3.0), like["kernel"]),
             "log_noise": LogNormal(0.0, 3.0)}
    tt = t[0].clone().requires_grad_(True)
    tree = unravel(tt, like)
    Ua = -(sgpr_elbo(kern, {**tree, "Z": t[3]}, t[1], t[2], JITTER) + log_prior(prior, tree))
    (ga,) = torch.autograd.grad(Ua, tt)
    assert _rel(U, Ua.detach()) <= 1e-9 and _rel(g, ga) <= 1e-9


def test_co2_potential_floor_and_prior_options():
    """The modified Cholesky with a floor far below the pivots is the plain
    factorisation; without the prior the gradient is the ELBO's."""
    X, y, Z = _data()
    t = [torch.tensor(a) for a in (np.random.default_rng(2).normal(size=11) * 0.3, X, y, Z)]
    U, g = co2_vfe_neg_logpost_vg(*t, JITTER)
    Uf, gf = co2_vfe_neg_logpost_vg(*t, JITTER, floor=1e-12)
    assert _rel(Uf, U) <= 1e-12 and _rel(gf, g) <= 1e-10
    U0, g0 = co2_vfe_neg_logpost_vg(*t, JITTER, want_prior=False)
    lp = sum(float(-0.5 * (u / 3.0) ** 2 - np.log(3.0) - 0.5 * np.log(2 * np.pi))
             for u in t[0])
    assert abs(float(U0 - U) - lp) <= 1e-9 * abs(float(U))
    pot = make_co2_vfe_potential(t[1], t[2], JITTER)
    assert all(torch.equal(a, b) for a, b in zip(pot(t[0], t[3]), (U, g)))
    assert make_co2_vfe_potential(torch.zeros(5, 2), torch.zeros(5), JITTER) is None


# -- the structure gate, ravel order, exchange ----------------------------------------------

def test_co2_fused_spec_accepts_and_refuses_as_the_jax_package():
    """The cases of tests/test_fused_bound.py's gate test, both packages."""
    jkern, tkern = jk.co2_kernel("matern32"), tk.co2_kernel("matern32")
    jtree = {"kernel": jax.tree_util.tree_map(lambda _: JLogNormal(0.0, 3.0),
                                              jkern.init_params(1)),
             "log_noise": JGamma(2.0, 1.0)}
    ttree = {"kernel": tree_map(lambda _: LogNormal(0.0, 3.0), _like(tkern)["kernel"]),
             "log_noise": Gamma(2.0, 1.0)}
    want = j_co2_fused_spec(jkern, JGaussian(), jtree)
    assert co2_fused_spec(tkern, GaussianLikelihood(), ttree) == want
    assert want[0] == "m32" and want[1][10] == ("gamma", 2.0, 1.0)
    assert co2_fused_spec(tkern, BernoulliProbit(), ttree) is None
    assert j_co2_fused_spec(jkern, JBernoulliProbit(), jtree) is None
    assert co2_fused_spec(tk.default_rbf(), GaussianLikelihood(), ttree) is None
    assert co2_fused_spec(tkern, GaussianLikelihood(), {"log_noise": None}) is None
    rbf_noise = tk.co2_kernel("rbf")
    assert co2_fused_spec(rbf_noise, GaussianLikelihood(), ttree)[0] == "rbf"
    wrong = tk.Sum(tkern.terms[:3] + (tk.Scale(tk.RBF()),))          # an ARD noise term
    assert co2_fused_spec(wrong, GaussianLikelihood(), ttree) is None
    X, y, Z = _data()
    with pytest.raises(NotImplementedError, match="CO2 composite"):
        BayesianSparseGPR_HMC(X, y, Z_init=Z, kernel=wrong, prior_tree=ttree, device="cpu")


def test_ravel_order_and_exchange_match_ravel_pytree():
    """The 11 lanes in jax.flatten_util.ravel_pytree order ([log lp, log ld,
    log s1, log lt, log s2, log alpha, log lm, log s3, log ln, log s4, log
    noise]); the exchange round trip, with a leading sample axis too."""
    jkern = jk.co2_kernel("matern32")
    jtree = jax.tree_util.tree_map(np.asarray, {"kernel": jkern.init_params(1),
                                                "log_noise": jnp.zeros(())})
    leaves, treedef = jax.tree_util.tree_flatten(jtree)
    jtree = jax.tree_util.tree_unflatten(treedef, [np.asarray(float(i + 1)) for i in
                                                   range(len(leaves))])
    want, _ = ravel_pytree(jtree)
    got = params_from_jax(jtree)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tkern = tk.co2_kernel("matern32")
    tree = tree_from_numpy(jtree)
    np.testing.assert_array_equal(ravel(tree).numpy(), np.asarray(want))
    assert float(tree["kernel"]["terms"][2]["base"]["log_alpha"]) == float(want[5])
    back = params_to_numpy(got, kernel=tkern)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jtree)
    np.testing.assert_array_equal(ravel_pytree(back)[0], want)
    rows = torch.tensor(np.random.default_rng(0).normal(size=(5, 11)))
    trace = params_to_numpy(rows, kernel=tkern)
    assert trace["log_noise"].shape == (5,)
    np.testing.assert_array_equal(params_from_jax(trace).numpy(), rows.numpy())
    theta, Z = params_from_jax(jtree, np.zeros((3, 1)))
    assert Z.shape == (3, 1) and theta.shape == (11,)


# -- NUTS: the transition, the warm chunk, the chunked driver --------------------------------

def _jax_slabs(key, K, dim=11):
    """``_rand`` of make_fused_nuts (max depth MD), as the port's slabs."""
    k1, k2, k3 = jax.random.split(key, 3)
    mom = np.asarray(jax.random.normal(k1, (K, 128), jnp.float32))
    treeu = np.asarray(jax.random.uniform(k2, (K * MD, 128), jnp.float32))
    leafu = np.asarray(jax.random.uniform(k3, (K, 128), jnp.float32))
    return (torch.tensor(mom[:, :dim].copy()),
            torch.tensor(treeu.reshape(K, MD, 128)[:, :, :2].copy()),
            torch.tensor(leafu[:, :1 << MD].copy()))


def _f32_problem():
    X, y, Z = _data()
    th = (np.random.default_rng(4).normal(size=11) * 0.3).astype(np.float32)
    return th, X.astype(np.float32), y.astype(np.float32), Z.astype(np.float32)


@pytest.fixture(scope="module")
def fused_co2():
    th, X, y, Z = _f32_problem()
    return make_fused_nuts(X, y, NUTS_JITTER, max_depth=MD, chunk=3, target="co2_m32",
                           interpret=True)(jnp.asarray(Z))


def test_transition_matches_pallas_interpret(fused_co2):
    """One transition (site 4) of the port's plain version against the
    interpret-mode trans_call of target co2_m32, on the key's slabs."""
    th, X, y, Z = _f32_problem()
    t = [torch.tensor(a) for a in (th, X, y, Z)]
    U0, g0 = co2_vfe_neg_logpost_vg(*t, NUTS_JITTER)
    key, eps = jax.random.PRNGKey(7), np.float32(0.05)
    zj, Uj, gj, stj = fused_co2.transition(None, jnp.asarray(th), jnp.asarray(U0.item()),
                                           jnp.asarray(g0.numpy()), key, jnp.asarray(eps),
                                           jnp.ones(11, jnp.float32))
    mom, treeu, leafu = _jax_slabs(key, 1)
    z, U, g, acc, div, depth, nl, H0 = nuts_transition(
        t[0], U0, g0, torch.tensor(eps), torch.ones(11), *t[1:], NUTS_JITTER, mom=mom[0],
        treeu=treeu[0], leafu=leafu[0], max_depth=MD, core="co2_m32")
    assert int(depth) == int(stj["depth"]) and int(nl) == int(stj["n_leapfrog"])
    assert bool(div) == bool(stj["diverging"])
    for a, b in ((z, zj), (U, Uj), (g, gj), (acc, stj["accept_prob"]), (H0, stj["energy"])):
        assert _rel(a.numpy(), b) <= NUTS_TOL


def test_warm_chunk_matches_pallas_interpret(fused_co2):
    """A warm chunk of the co2 core (a window inside) of the port's plain
    version against the interpret-mode warm_call of target co2_m32."""
    th, X, y, Z = _f32_problem()
    t = [torch.tensor(a) for a in (th, X, y, Z)]
    U0, g0 = co2_vfe_neg_logpost_vg(*t, NUTS_JITTER)
    K, key = 3, jax.random.PRNGKey(11)
    le = np.float32(np.log(0.05))
    in_w, w_end = np.array([False, True, True]), np.array([False, False, True])
    da = jhmc.DAState(*(jnp.asarray(v, jnp.float32) for v in
                        (le, le, 0.0, np.log(10.0) + le, 0.0)))
    zj, Uj, gj, daj, wfj, imj, acc_j, div_j = fused_co2.warm_chunk(
        jnp.asarray(th), jnp.asarray(U0.item(), jnp.float32), jnp.asarray(g0.numpy()), key,
        da, jhmc.welford_init(11, jnp.float32), jnp.ones(11, jnp.float32),
        jnp.asarray(in_w), jnp.asarray(w_end), K)
    mom, treeu, leafu = _jax_slabs(key, K)
    f = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    st = ChainState(z=t[0], U=U0, g=g0, inv_mass=torch.ones(11), log_eps=f(le),
                    log_eps_avg=f(le), h_avg=f(0.0), mu=f(np.log(10.0) + le), t_da=f(0.0),
                    wf_mean=torch.zeros(11), wf_m2=torch.zeros(11), wf_count=f(0.0))
    s, _, stats = nuts_chunk_plain(st, *t[1:], NUTS_JITTER, mom=mom, treeu=treeu,
                                   leafu=leafu, n_active=K, adapt=True,
                                   in_window=torch.tensor(in_w), window_end=torch.tensor(w_end),
                                   max_depth=MD, core="co2_m32")
    assert float(stats[:, 2].sum()) == float(div_j)
    assert _rel(stats[:, 1].sum(), acc_j) <= NUTS_TOL
    for a, b in ((s.z, zj), (s.U, Uj), (s.inv_mass, imj), (s.log_eps, daj.log_eps),
                 (s.log_eps_avg, daj.log_eps_avg), (s.wf_count, wfj.count)):
        assert _rel(a.numpy(), b) <= NUTS_TOL
    # the gradient at the final state: its terms cancel to ~1e-2 of their
    # size, so float32 resolves it to one evaluation's tolerance (chip_smoke
    # TOL), not NUTS_TOL
    assert _rel(s.g.numpy(), gj) <= F32_EVAL_TOL


class _JaxKeyDraws:
    """The JAX chunked driver's key schedule as the port's draws: the init
    jitter from fold_in(key, 1), the step-size search's momentum from the
    chain key's first split, then per transition ``_rand`` of a split."""

    def __init__(self, key):
        self.key = key

    def init_jitter(self):
        k = jax.random.split(jax.random.fold_in(self.key, 1), 1)[0]
        return torch.tensor(np.asarray(jax.random.normal(k, (11,), jnp.float32)))

    def search_momentum(self):
        k, k_eps = jax.random.split(jax.random.split(self.key, 1)[0])
        self.key = k
        return torch.tensor(np.asarray(jax.random.normal(k_eps, (11,), jnp.float32)))

    def slabs(self):
        self.key, k_step = jax.random.split(self.key)
        mom, treeu, leafu = _jax_slabs(k_step, 1)
        return mom[0], treeu[0], leafu[0]


def _port_sampler(t, cfg, K, core="co2_m32", jitter=JITTER):
    X, y, Z = t[1:]

    def pot(z):
        return co2_potential(z, X, y, Z, jitter)

    def trans(z, U, g, eps, im, mom, treeu, leafu):
        return nuts_transition(z, U, g, eps, im, X, y, Z, jitter, mom=mom, treeu=treeu,
                               leafu=leafu, max_depth=cfg.max_depth, core=core)

    return thmc.build_sampler_chunked(pot, trans, cfg, chunk_size=K)


@pytest.mark.slow
def test_chunked_driver_matches_jax_on_its_keys():
    """One warm chunk and one sample chunk of the port's
    build_sampler_chunked against the JAX package's, whose fused builder is
    the interpret-mode make_fused_nuts(target="co2_m32"), on the slabs of
    the same keys: draws, step size and inverse mass to NUTS_TOL."""
    th, X, y, Z = _f32_problem()
    K = 3
    cfg_j = jhmc.NUTSConfig(num_warmup=K, num_samples=K, max_depth=MD)
    builder = make_fused_nuts(X, y, NUTS_JITTER, max_depth=MD, target="co2_m32",
                              interpret=True)
    jkern = jk.co2_kernel("matern32")
    flat = jnp.asarray(th)
    _, unr = ravel_pytree({"kernel": jkern.init_params(1), "log_noise": jnp.zeros(())})
    sampler = jhmc.build_sampler_chunked(None, unr(flat), cfg_j, 1, chunk_size=K,
                                         fused_builder=builder)
    key = jax.random.PRNGKey(5)
    samples, stj = sampler(unr(flat), key, jnp.asarray(Z))
    zj = np.asarray(jax.vmap(lambda tr: ravel_pytree(tr)[0])(
        jax.tree_util.tree_map(lambda a: a[0], samples)))
    t = [torch.tensor(a) for a in (th, X, y, Z)]
    cfg = thmc.NUTSConfig(num_warmup=K, num_samples=K, max_depth=MD)
    zs, st = _port_sampler(t, cfg, K, jitter=NUTS_JITTER)(t[0], draws=_JaxKeyDraws(key))
    np.testing.assert_array_equal(st["depth"].numpy(), np.asarray(stj["depth"][0]))
    assert _rel(zs.numpy(), zj) <= NUTS_TOL
    assert _rel(st["step_size"], stj["step_size"][0]) <= NUTS_TOL
    assert _rel(st["inv_mass"].numpy(), stj["inv_mass"][0]) <= NUTS_TOL


def test_chunked_driver_adapts_as_the_warm_chunk():
    """The chunked driver's warmup (one transition per call, dual averaging
    and the Welford windows in torch between calls) walks the same chain as
    the plain warm chunk on the same slabs, and its sampling the same as
    the plain sample chunk at the adapted step size (f64)."""
    X, y, Z = _data()
    t = [torch.tensor(a) for a in (np.random.default_rng(4).normal(size=11) * 0.3, X, y, Z)]
    Kw, Ks = 12, 4
    cfg = thmc.NUTSConfig(num_warmup=Kw, num_samples=Ks, max_depth=MD)
    gen = torch.Generator().manual_seed(3)
    draws = thmc.GeneratorDraws(gen, 11, MD, dtype=F64, device="cpu")
    jit0, mom0 = draws.init_jitter(), draws.search_momentum()
    slabs = [draws.slabs() for _ in range(2 * Kw)]     # sampling runs a whole chunk

    class Replay:
        def __init__(self):
            self.i = -1

        def init_jitter(self):
            return jit0

        def search_momentum(self):
            return mom0

        def slabs(self):
            self.i += 1
            return slabs[self.i]

    zs, st = _port_sampler(t, cfg, Kw)(t[0], draws=Replay())
    z0 = t[0] + 0.1 * jit0
    U0, g0 = co2_vfe_neg_logpost_vg(z0, *t[1:], JITTER)
    eps = thmc.find_reasonable_step_size(
        lambda z: co2_vfe_neg_logpost_vg(z, *t[1:], JITTER), z0, U0, g0, mom0,
        torch.ones(11, dtype=F64), cfg.init_step_size)
    da = thmc.da_init(eps)
    zero = torch.zeros((), dtype=F64)
    s = ChainState(z=z0, U=U0, g=g0, inv_mass=torch.ones(11, dtype=F64), log_eps=da.log_eps,
                   log_eps_avg=da.log_eps_avg, h_avg=da.h_avg, mu=da.mu, t_da=da.t,
                   wf_mean=torch.zeros(11, dtype=F64), wf_m2=torch.zeros(11, dtype=F64),
                   wf_count=zero)
    in_w, w_end = thmc.warmup_schedule(Kw)
    stack = [torch.stack([sl[i] for sl in slabs]) for i in range(3)]
    s, _, _ = nuts_chunk_plain(s, *t[1:], JITTER, mom=stack[0][:Kw], treeu=stack[1][:Kw],
                               leafu=stack[2][:Kw], n_active=Kw, adapt=True, max_depth=MD,
                               in_window=torch.tensor(in_w), window_end=torch.tensor(w_end),
                               core="co2_m32")
    torch.testing.assert_close(st["inv_mass"], s.inv_mass, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(st["step_size"], torch.exp(s.log_eps_avg), rtol=1e-10,
                               atol=0)
    _, d2, x2 = nuts_chunk_plain(s, *t[1:], JITTER, mom=stack[0][Kw:Kw + Ks],
                                 treeu=stack[1][Kw:Kw + Ks], leafu=stack[2][Kw:Kw + Ks],
                                 n_active=Ks, adapt=False,
                                 eps=st["step_size"], max_depth=MD, core="co2_m32")
    torch.testing.assert_close(zs, d2, rtol=1e-10, atol=1e-12)
    assert torch.equal(st["n_leapfrog"].double(), x2[:, 4])
    assert st["warmup_n_leapfrog"].shape == (Kw,)


def test_transition_plain_equals_the_chunk_row():
    """nuts_transition on CPU tensors is the plain transition, the row a
    sample chunk of one step writes, and counts no launch."""
    X, y, Z = _data()
    t = [torch.tensor(a) for a in (np.random.default_rng(6).normal(size=11) * 0.3, X, y, Z)]
    U0, g0 = co2_vfe_neg_logpost_vg(*t, JITTER)
    mom, treeu, leafu = (a[0] for a in _jax_slabs(jax.random.PRNGKey(2), 1))
    mom, treeu, leafu = mom.double(), treeu.double(), leafu.double()
    eps, im = torch.tensor(0.05, dtype=F64), torch.ones(11, dtype=F64)
    before = dict(_build.LAUNCHES)
    out = nuts_transition(t[0], U0, g0, eps, im, *t[1:], JITTER, mom=mom, treeu=treeu,
                          leafu=leafu, max_depth=MD, core="co2_m32")
    assert _build.LAUNCHES == before
    ref = nuts_transition_plain(t[0], U0, g0, eps, im, *t[1:], JITTER, mom=mom, treeu=treeu,
                                leafu=leafu, max_depth=MD, core="co2_m32")
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b)) for a, b in zip(out, ref))
    zero = torch.zeros((), dtype=F64)
    st = ChainState(z=t[0], U=U0, g=g0, inv_mass=im, log_eps=zero, log_eps_avg=zero,
                    h_avg=zero, mu=zero, t_da=zero, wf_mean=im * 0, wf_m2=im * 0, wf_count=zero)
    _, d, x = nuts_chunk_plain(st, *t[1:], JITTER, mom=mom[None], treeu=treeu[None],
                               leafu=leafu[None], n_active=1, adapt=False, eps=eps,
                               max_depth=MD, core="co2_m32")
    assert torch.equal(d[0], out[0]) and float(x[0, 4]) == int(out[6])


# -- the model ----------------------------------------------------------------------------

def _models(dt=F64):
    X, y, Z = _data()
    jkern = jk.co2_kernel("matern32")
    jtree = {"kernel": jax.tree_util.tree_map(lambda _: JLogNormal(0.0, 3.0),
                                              jkern.init_params(1)),
             "log_noise": JLogNormal(0.0, 3.0)}
    jm = JModel(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z), kernel=jkern,
                prior_tree=jtree, jitter=1e-4)
    tkern = tk.co2_kernel("matern32")
    tm = BayesianSparseGPR_HMC(torch.tensor(X, dtype=dt), torch.tensor(y, dtype=dt),
                               Z_init=torch.tensor(Z, dtype=dt), kernel=tkern,
                               prior_tree=co2_prior_tree(tkern), jitter=1e-4, device="cpu")
    return jm, tm


def test_warm_start_matches_adam_all_step_for_step():
    """10 steps of the autograd warm start against the JAX package's
    _adam_all (zero_nans, clip by global norm 10, Adam, the box and the
    noise floor): losses, hypers and Z <= 1e-8."""
    jm, tm = _models()
    tm.hypers = init_co2_params()
    theta0 = tm.theta.clone()
    opt = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(10.0), optax.adam(0.01))
    params = {**_jtree(theta0.numpy(), jm.kernel), "Z": jm.Z}
    pj, lj = _adam_all(jm.kernel, jm.train_x, jm.train_y, jm.jitter,
                       jax.tree_util.tree_map(jnp.asarray, params), opt, 10)
    lt = tm.warm_start(num_steps=10, lr=0.01)
    assert _rel(lt.numpy(), np.asarray(lj)) <= 1e-8
    Zj = pj.pop("Z")
    assert _rel(tm.theta.numpy(), np.asarray(ravel_pytree(pj)[0])) <= 1e-8
    assert _rel(tm.Z.numpy(), np.asarray(Zj)) <= 1e-8


def test_optimize_z_is_adam_on_the_trace_mean_elbo():
    """The autograd optimize_Z against the JAX package's _adam_Z on one
    trace: losses and Z <= 1e-8."""
    from ggp_tpu.models.bayesian_sgpr_hmc import _adam_Z
    jm, tm = _models()
    rows = torch.tensor(np.random.default_rng(8).normal(size=(4, 11)) * 0.3)
    tm.trace = rows
    zl = tm.optimize_Z(num_steps=5, lr=0.01)
    trace = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(rows, kernel=tm.kernel))
    Zj, lj = _adam_Z(jm.kernel, jm.train_x, jm.train_y, jm.jitter, jm.Z, trace,
                     optax.chain(optax.zero_nans(), optax.adam(0.01)), 5)
    assert _rel(zl.numpy(), np.asarray(lj)) <= 1e-8
    assert _rel(tm.Z.numpy(), np.asarray(Zj)) <= 1e-8


def test_mixture_predictive_matches_jax():
    """At a shared trace and Z: every component's mean and variance <= 1e-9."""
    jm, tm = _models()
    rows = np.random.default_rng(9).normal(size=(3, 11)) * 0.3 + np.r_[[0.0] * 10, -2.0]
    Xt = np.linspace(3.0, 4.0, 7)[:, None]
    tm.trace = torch.tensor(rows)
    jm.trace = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tm.trace, kernel=tm.kernel))
    mj, vj = jm.mixture_posterior_predictive(jnp.asarray(Xt))
    mt, vt = tm.mixture_posterior_predictive(torch.tensor(Xt))
    assert mt.shape == (3, 7)
    assert _rel(mt.numpy(), np.asarray(mj)) <= 1e-9 and _rel(vt.numpy(), np.asarray(vj)) <= 1e-9


def test_train_fixed_model_runs_plain_on_cpu_and_counts_no_launch():
    """The experiment's fixed-Z protocol at a small size: the chunked
    driver from the seeded hypers, finite draws and predictive, no launch."""
    _, tm = _models()
    tm.hypers = init_co2_params()
    before = dict(_build.LAUNCHES)
    tm.warm_start(num_steps=5)
    tr = tm.train_fixed_model(num_warmup=6, num_samples=4, chunk_size=4,
                              generator=torch.Generator().manual_seed(0))
    assert _build.LAUNCHES == before
    assert tr.shape == (4, 11) and torch.isfinite(tr).all()
    assert tm.stats["warmup_n_leapfrog"].shape == (6,)
    torch.testing.assert_close(tm.theta, tr.mean(0))
    mu, var = tm.mixture_posterior_predictive(tm.train_x)
    assert mu.shape == (4, N) and torch.isfinite(mu).all() and (var > 0).all()
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        tm.sample_hypers(4, 2, num_chains=2)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        thmc.build_sampler_chunked(None, None, thmc.NUTSConfig(), num_chains=2)
    sampler = thmc.build_sampler_chunked(None, None, thmc.NUTSConfig())
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        sampler(tm.theta, ckpt_manager=object())


def test_co2_data_equals_the_jax_loader():
    from co2_data import load_co2_dataset as jload
    for a, b in zip(load_co2_dataset(2003), jload(2003)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    Xtr, ytr, Xte, *_ = load_co2_dataset(2003)
    assert Xtr.shape == (541, 1) and Xte.shape == (143, 1)


# -- no fallback --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, F64])
def test_co2_wrappers_refuse_bad_inputs(dtype):
    """A tensor that is not on the CPU never reaches a plain version; the
    co2 cores take 1-D inputs and no Z gradient; the transition kernel
    exists for the vfe and co2 cores only."""
    X, y, Z = _data()
    kw = dict(dtype=dtype, device="meta")
    th, Xm, ym, Zm = (torch.zeros(s, **kw) for s in ((11,), (N, 1), (N,), (M, 1)))
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        co2_potential(th, Xm, ym, Zm, JITTER)
    one = torch.zeros((), **kw)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        nuts_transition(th, one, th, one, th, Xm, ym, Zm, JITTER, mom=th,
                        treeu=torch.zeros((3, 2), **kw), leafu=torch.zeros(8, **kw),
                        max_depth=3, core="co2_m32")
    t = [torch.tensor(a, dtype=dtype) for a in (np.zeros(11), X, y, Z)]
    with pytest.raises(ValueError, match="1-D inputs"):
        co2_potential(t[0], torch.cat([t[1], t[1]], 1), t[2], torch.cat([t[3], t[3]], 1),
                      JITTER)
    from ggp_tpu_torch.ops.vfe_bound import vfe_potential
    with pytest.raises(ValueError, match="no Z gradient"):
        vfe_potential(t[0], t[1], t[2], t[3], JITTER, want_z_grad=True, core="co2_m32")
    with pytest.raises(ValueError, match="no nuts_transition kernel"):
        nuts_transition(t[0], t[0][0], t[0], 0.1, t[0], *t[1:], JITTER, mom=t[0],
                        treeu=torch.zeros((3, 2), dtype=dtype), leafu=torch.zeros(8, dtype=dtype),
                        max_depth=3, core="sgpmc")
    with pytest.raises(ValueError, match="shapes"):
        nuts_transition(t[0], t[0][0], t[0], 0.1, t[0], *t[1:], JITTER, mom=t[0],
                        treeu=torch.zeros((4, 2), dtype=dtype), leafu=torch.zeros(8, dtype=dtype),
                        max_depth=3, core="co2_m32")
