"""The port's JointHMC (SGPMC) path against the JAX package, on the CPU.

The whitened potential (``ggp_tpu_torch.ops.sgpmc_bound``), the warm start
(``ops.sgpmc_warm``), the one-chain fixed-leapfrog HMC chunk with the sgpmc
core (``ops.multichain.hmc_chunk``), the C-chain potential, and the model
(``ggp_tpu_torch.models.sgpmc``), at n=40, d=3, m=8 (state dim 13), in
float64 unless stated. The interpret-mode Pallas comparisons are ``slow``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ggp_tpu.inference import hmc as jhmc
from ggp_tpu.models import SGPMC as JaxSGPMC
from ggp_tpu.ops.fused_bound import _sgpmc_neg_logpost_vg, block_chol_u, block_ut_inv
from ggp_tpu.ops.fused_multichain import _sgpmc_batched_vg
from ggp_tpu.ops.fused_nuts import _hmc_transition_inkernel, make_fused_nuts
from ggp_tpu.ops.fused_sgpmc import make_fused_sgpmc_warm
from ggp_tpu_torch import SGPMC
from ggp_tpu_torch.interop import sgpmc_state_from_jax, sgpmc_state_to_numpy
from ggp_tpu_torch.kernels import RBF, Scale
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.multichain import hmc_chunk, mc_potential
from ggp_tpu_torch.ops.nuts_chunk import ChainState, nuts_chunk_plain
from ggp_tpu_torch.ops.sgpmc_bound import sgpmc_neg_logpost_vg
from ggp_tpu_torch.ops.sgpmc_warm import sgpmc_warm_chunk, sgpmc_warm_chunk_plain
from ggp_tpu_torch.ops.vfe_bound import vfe_potential
from ggp_tpu_torch.priors import HalfCauchy

F32, F64 = torch.float32, torch.float64
N, D, M, JITTER = 40, 3, 8, 1e-8
DIM = D + 2 + M
# One f64 evaluation: the same algebra on both sides up to summation order
# and factorisation (~1e-15); a chunk of a few HMC steps or 20 Adam steps
# keeps that to well below these bounds, while a wrong term, branch or
# decision moves a result by O(1e-3) or more.
TOL64 = 1e-10
WARM_TOL = 1e-9


def _rel(a, b):
    """max |a - b| / max |b| (norm-relative)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _problem(seed=0):
    """X (n, d), y (n,), Z (m, d) with distinct rows near data points, and a
    state row [log_ls (d), log_os, log_noise, v (m)]."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(N, D))
    y = np.sin(X @ r.normal(size=D)) + 0.2 * r.normal(size=N)
    Z = X[np.linspace(0, N - 1, M).astype(int)] + 0.05 * r.normal(size=(M, D))
    st = np.r_[0.2 * r.normal(size=D), 0.3, -1.5, 0.5 * r.normal(size=M)]
    return X, y, Z, st


def _padded(X, y, Z, st, dt=np.float64):
    """The JAX cores' lane-padded layout: X (Np, 128), y (1, Np), Z (128,
    128), state (1, 128)."""
    Np = -(-N // 128) * 128
    Xp = np.zeros((Np, 128), dt)
    Xp[:N, :D] = X
    yr = np.zeros((1, Np), dt)
    yr[0, :N] = y
    Zp = np.zeros((128, 128), dt)
    Zp[:M, :D] = Z
    sp = np.zeros((1, 128), dt)
    sp[0, :DIM] = st
    return [jnp.asarray(a) for a in (Xp, yr, Zp, sp)]


def _jax_model(X, y, Z):
    return JaxSGPMC(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z))


def _jax_potential(model, X, y, Z):
    """value_and_grad of -SGPMC._logpost over the flat ravel_pytree row."""
    flat0, unravel = ravel_pytree(model.state)
    data = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(Z))
    return jax.jit(jax.value_and_grad(lambda z: -model._logpost(unravel(z), data)))


# -- the potential ----------------------------------------------------------------

@pytest.mark.parametrize("pivot_floor", [None, 1e-6])
@pytest.mark.parametrize("want_z_grad", [True, False])
@pytest.mark.parametrize("want_prior", [True, False])
def test_potential_matches_fused_core(want_prior, want_z_grad, pivot_floor):
    """The plain potential against ``_sgpmc_neg_logpost_vg`` (XLA level, on
    padded arrays): value, gradient and dU/dZ to 1e-10 relative."""
    X, y, Z, st = _problem()
    Xp, yr, Zp, sp = _padded(X, y, Z, st)
    out_j = _sgpmc_neg_logpost_vg(
        sp, Xp, yr, Zp, N, M, D, JITTER, want_z_grad=want_z_grad,
        want_prior=want_prior,
        pivot_floor=None if pivot_floor is None else jnp.asarray(pivot_floor))
    out_t = sgpmc_neg_logpost_vg(*(torch.tensor(a) for a in (st, X, y, Z)), JITTER,
                                 want_z_grad=want_z_grad, want_prior=want_prior,
                                 pivot_floor=pivot_floor)
    assert len(out_t) == (3 if want_z_grad else 2)
    assert _rel(out_t[0], out_j[0]) <= TOL64
    assert _rel(out_t[1], np.asarray(out_j[1])[0, :DIM]) <= TOL64
    if want_z_grad:
        assert _rel(out_t[2], np.asarray(out_j[2])[:M, :D]) <= TOL64


def test_potential_matches_jax_grad_of_logpost():
    """U and dU/dstate against jax.value_and_grad of -SGPMC._logpost, and
    dU/dZ without the prior against jax.grad of the warm start's loss."""
    X, y, Z, st = _problem(1)
    model = _jax_model(X, y, Z)
    U_j, g_j = _jax_potential(model, X, y, Z)(jnp.asarray(st))
    t = [torch.tensor(a) for a in (st, X, y, Z)]
    U_t, g_t = sgpmc_neg_logpost_vg(*t, JITTER)
    assert _rel(U_t, U_j) <= TOL64 and _rel(g_t, g_j) <= TOL64
    _, unravel = ravel_pytree(model.state)

    def warm_loss(Zj):
        s = unravel(jnp.asarray(st))
        return -(model._loglik(s, (jnp.asarray(X), jnp.asarray(y), Zj))
                 - 0.5 * jnp.sum(s["v"] ** 2))

    _, _, dZ_t = sgpmc_neg_logpost_vg(*t, JITTER, want_z_grad=True, want_prior=False)
    assert _rel(dZ_t, jax.grad(warm_loss)(jnp.asarray(Z))) <= TOL64


def test_mc_potential_f32_matches_batched_vg():
    """f32: the C-chain sgpmc potential against ``_sgpmc_batched_vg`` with
    the blocked factorisation (blocked vs LAPACK f32 Cholesky): 1e-4."""
    X, y, Z, st = _problem(2)
    C = 3
    rows = (st + 0.2 * np.random.default_rng(3).normal(size=(C, DIM))).astype(np.float32)
    Xp, yr, Zp, _ = _padded(X, y, Z, st, np.float32)
    sp = jnp.zeros((C, 128), jnp.float32).at[:, :DIM].set(rows)

    def chol(K_list):
        out = []
        for Kj in K_list:
            U = block_chol_u(Kj, block=32)
            out.append((U, block_ut_inv(U, block=32)))
        return out

    Uj, gj = _sgpmc_batched_vg(sp, Xp, yr, Zp, N, M, D, 1e-5, C, chol)
    Ut, gt = mc_potential(torch.tensor(rows), *(torch.tensor(a, dtype=F32) for a in (X, y, Z)),
                          1e-5, core="sgpmc")
    assert Ut.shape == (C,) and gt.shape == (C, DIM)
    assert _rel(Ut, np.asarray(Uj)[:, 0]) <= 1e-4
    assert _rel(gt, np.asarray(gj)[:, :DIM]) <= 1e-4


def test_potential_wrapper_runs_plain_on_cpu_and_checks_shapes():
    X, y, Z, st = _problem()
    t = [torch.tensor(a) for a in (st, X, y, Z)]
    before = dict(_build.LAUNCHES)
    a = vfe_potential(*t, JITTER, core="sgpmc")
    b = sgpmc_neg_logpost_vg(*t, JITTER)
    assert _build.LAUNCHES == before
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError):
        vfe_potential(t[0][:D + 2], *t[1:], JITTER, core="sgpmc")
    with pytest.raises(ValueError):
        vfe_potential(*t, JITTER, core="gpr")


# -- the warm start -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_warm():
    """The JAX package's warm start (its XLA path: optax zero_nans ->
    clip_by_global_norm(10) -> adam) over 20 steps from its initial state."""
    X, y, Z, _ = _problem(4)
    model = _jax_model(X, y, Z)
    losses = model.warm_start(num_steps=20, lr=0.01)
    flat, _ = ravel_pytree(model.state)
    return (X, y, Z), np.asarray(flat), np.asarray(model.Z), np.asarray(losses)


def test_warm_chunk_matches_jax_warm_start(jax_warm):
    (X, y, Z), flat_j, Z_j, losses_j = jax_warm
    t = [torch.tensor(a) for a in (X, y, Z)]
    st0 = torch.zeros(DIM, dtype=F64)
    zs, zz = torch.zeros_like(st0), torch.zeros_like(t[2])
    st, Zt, *_, losses = sgpmc_warm_chunk_plain(st0, t[2], zs, zs, zz, zz, t[0], t[1],
                                                JITTER, t0=0, num_steps=20, lr=0.01)
    assert _rel(st, flat_j) <= WARM_TOL
    assert _rel(Zt, Z_j) <= WARM_TOL
    assert _rel(losses, losses_j) <= WARM_TOL


def test_model_warm_start_matches_jax(jax_warm):
    (X, y, Z), flat_j, Z_j, losses_j = jax_warm
    model = SGPMC(X, y, Z_init=Z, device="cpu")
    before = dict(_build.LAUNCHES)
    losses = model.warm_start(num_steps=20, lr=0.01)
    assert _build.LAUNCHES == before
    assert _rel(model.flat, flat_j) <= WARM_TOL and _rel(model.Z, Z_j) <= WARM_TOL
    assert _rel(losses, losses_j) <= WARM_TOL
    tree = sgpmc_state_to_numpy(model.flat, D)
    assert _rel(tree["v"], flat_j[D + 2:]) <= WARM_TOL


def test_warm_chunk_wrapper_splits_into_chunks_and_leaves_inputs():
    """Two chunks of 5 steps (t0 continuing) equal one chunk of 10; the
    inputs are not modified."""
    X, y, Z, st = _problem(5)
    t = [torch.tensor(a) for a in (st, X, y, Z)]
    zs, zz = torch.zeros_like(t[0]), torch.zeros_like(t[3])
    Z_in = t[3].clone()
    one = sgpmc_warm_chunk(t[0], t[3], zs, zs, zz, zz, t[1], t[2], JITTER, t0=0,
                           num_steps=10, lr=0.01)
    a = sgpmc_warm_chunk(t[0], t[3], zs, zs, zz, zz, t[1], t[2], JITTER, t0=0,
                         num_steps=5, lr=0.01)
    b = sgpmc_warm_chunk(*a[:6], t[1], t[2], JITTER, t0=5, num_steps=5, lr=0.01)
    for u, v in zip(b[:6], one[:6]):
        assert _rel(u, v) <= 1e-13
    assert torch.equal(t[3], Z_in) and torch.equal(zs, torch.zeros_like(zs))
    assert _rel(torch.cat([a[6], b[6]]), one[6]) <= 1e-13


# -- the one-chain HMC chunk --------------------------------------------------------

def _jax_hmc_steps(pot, z, U, g, le, im, mom, mh, L, in_w, w_end, adapt, eps=None,
                   target=0.8):
    """The single-chain fused HMC chunk's steps (``_warm_chunk_kernel_body``
    with algorithm="hmc"), composed in JAX: ``_hmc_transition_inkernel``,
    then ``da_update`` and the Welford helpers; a window end sets the
    inverse mass, restarts the window and dual averaging (``da_init``)."""
    da = jhmc.da_init(jnp.exp(jnp.asarray(le)))
    wf = jhmc.welford_init(z.shape[0], jnp.float64)
    draws, acc = [], []
    for t in range(mom.shape[0]):
        e = jnp.exp(da.log_eps) if adapt else eps
        z, U, g, a, _, _, _, _ = _hmc_transition_inkernel(
            z, U, g, e, im, pot, jnp.asarray(mom[t]), jnp.asarray(mh[t]),
            num_leapfrog=L)
        if adapt:
            da = jhmc.da_update(da, a, target)
            if in_w[t]:
                wf = jhmc.welford_update(wf, z)
            if w_end[t]:
                im = jhmc.welford_variance(wf)
                wf = jhmc.welford_init(z.shape[0], jnp.float64)
                da = jhmc.da_init(jnp.exp(da.log_eps))
        draws.append(z)
        acc.append(a)
    return z, U, g, da, im, jnp.stack(draws), jnp.stack(acc)


def _chain_state(st, U, g, le):
    f = lambda v: torch.tensor(float(v), dtype=F64)  # noqa: E731
    z = torch.zeros(DIM, dtype=F64)
    return ChainState(z=st, U=U, g=g, inv_mass=torch.ones(DIM, dtype=F64),
                      log_eps=f(le), log_eps_avg=f(le), h_avg=f(0.0),
                      mu=f(np.log(10.0) + le), t_da=f(0.0), wf_mean=z, wf_m2=z.clone(),
                      wf_count=f(0.0))


@pytest.mark.parametrize("adapt", [True, False])
def test_hmc_chunk_matches_jax_composition(adapt):
    """K=6 steps of L=5 on the sgpmc core, warm (a Welford window over steps
    1-3 ending at 3) and at a fixed step: identical accept decisions,
    draws, potential and adaptation state to 1e-10."""
    X, y, Z, st = _problem(6)
    K, L, le = 6, 5, float(np.log(0.12 if adapt else 0.15))
    r = np.random.default_rng(7)
    mom, mh = r.normal(size=(K, DIM)), r.uniform(size=K)
    in_w, w_end = (np.arange(K) >= 1) & (np.arange(K) <= 3), np.arange(K) == 3
    jpot = _jax_potential(_jax_model(X, y, Z), X, y, Z)
    z0 = jnp.asarray(st)
    U0, g0 = jpot(z0)
    zj, Uj, gj, daj, imj, dj, accj = _jax_hmc_steps(
        jpot, z0, U0, g0, le, jnp.ones(DIM), mom, mh, L, in_w, w_end, adapt,
        eps=np.exp(le))
    t = [torch.tensor(a) for a in (st, X, y, Z)]
    U_t, g_t = sgpmc_neg_logpost_vg(*t, JITTER)
    before = dict(_build.LAUNCHES)
    s, draws, stats = hmc_chunk(
        _chain_state(t[0], U_t, g_t, le), *t[1:], JITTER, mom=torch.tensor(mom),
        mh=torch.tensor(mh), n_active=K, adapt=adapt,
        eps=None if adapt else torch.tensor(np.exp(le)),
        in_window=torch.tensor(in_w), window_end=torch.tensor(w_end),
        num_leapfrog=L, core="sgpmc")
    assert _build.LAUNCHES == before
    acc_t = stats[:, 1].numpy()
    np.testing.assert_array_equal(mh < acc_t, mh < np.asarray(accj))
    assert 0 < int((mh < acc_t).sum()) < K                # both decisions occur
    assert _rel(draws, dj) <= TOL64 and _rel(acc_t, accj) <= TOL64
    assert _rel(s.z, zj) <= TOL64 and _rel(s.U, Uj) <= TOL64 and _rel(s.g, gj) <= TOL64
    np.testing.assert_array_equal(stats[:, 4].numpy(), np.full(K, L))
    if adapt:
        assert _rel(s.inv_mass, imj) <= TOL64 and not np.allclose(np.asarray(imj), 1.0)
        for f, v in (("log_eps", daj.log_eps), ("log_eps_avg", daj.log_eps_avg),
                     ("h_avg", daj.h_avg), ("mu", daj.mu), ("t_da", daj.t)):
            np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(v),
                                       rtol=TOL64, atol=TOL64)


# -- the model --------------------------------------------------------------------

def _trace(st, S=120, seed=8):
    r = np.random.default_rng(seed)
    return st + 0.1 * r.normal(size=(S, DIM))


@pytest.mark.parametrize("num_components", [50, 7])
def test_mixture_predictive_matches_jax(num_components):
    """At a shared trace and Z: the thinned latent mixture and its
    observation-space twin to 1e-10."""
    X, y, Z, st = _problem(9)
    tr = _trace(st)
    Xt = np.random.default_rng(10).normal(size=(15, D))
    jm = _jax_model(X, y, Z)
    jm.trace = jax.tree_util.tree_map(jnp.asarray, sgpmc_state_to_numpy(torch.tensor(tr), D))
    tm = SGPMC(X, y, Z_init=Z, device="cpu")
    tm.trace = torch.tensor(tr)
    for jfn, tfn in ((jm.mixture_posterior_predictive, tm.mixture_posterior_predictive),
                     (jm.mixture_posterior_predictive_y, tm.mixture_posterior_predictive_y)):
        mj, vj = jfn(jnp.asarray(Xt), num_components)
        mt, vt = tfn(Xt, num_components)
        assert mt.shape == (min(num_components, 120), 15) == mj.shape
        assert _rel(mt, mj) <= TOL64 and _rel(vt, vj) <= TOL64


@pytest.mark.parametrize("num_chains,algorithm", [(1, "hmc"), (1, "nuts"), (2, "hmc"),
                                                  (2, "nuts")])
def test_model_train_runs_plain_on_cpu(num_chains, algorithm):
    """A short warm start and sampler run on CPU tensors: finite draws of
    the state's width, pooled chain-major, no kernel launched."""
    X, y, Z, _ = _problem(11)
    model = SGPMC(X, y, Z_init=Z, device="cpu")
    before = dict(_build.LAUNCHES)
    model.warm_start(num_steps=5)
    tr = model.train_model(10, 6, num_chains=num_chains, algorithm=algorithm,
                           num_leapfrog=3, generator=torch.Generator().manual_seed(2))
    assert _build.LAUNCHES == before
    assert tr.shape == (6 * num_chains, DIM) and torch.isfinite(tr).all()
    assert model.trace_tree["v"].shape == (6 * num_chains, M)
    assert model.stats["accept_prob"].shape == ((6,) if num_chains == 1 else (num_chains, 6))
    means, vars_ = model.mixture_posterior_predictive(X[:5])
    assert torch.isfinite(means).all() and (vars_ > 0).all()


def test_interop_round_trip():
    X, y, Z, st = _problem(12)
    tr = torch.tensor(_trace(st, S=4))
    tree, Zn = sgpmc_state_to_numpy(tr, D, torch.tensor(Z))
    assert sorted(tree) == ["kernel", "lik", "mean", "v"] and tree["mean"] == {}
    flat_j, _ = ravel_pytree(jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree))
    np.testing.assert_array_equal(np.asarray(flat_j), tr[0].numpy())   # ravel order
    back, Zb = sgpmc_state_from_jax(tree, Zn)
    assert torch.equal(back, tr) and torch.equal(Zb, torch.tensor(Z))


def test_model_refuses_what_the_port_does_not_carry():
    X, y, Z, _ = _problem()
    with pytest.raises(NotImplementedError, match="Gamma"):
        SGPMC(X, y, Z_init=Z, device="cpu",
              hyper_prior_tree={"kernel": HalfCauchy(1.0), "lik": HalfCauchy(1.0)})
    with pytest.raises(NotImplementedError, match="RBF"):
        SGPMC(X, y, Z_init=Z, device="cpu", kernel=Scale(RBF(ard=False)))
    with pytest.raises(NotImplementedError, match="128"):
        SGPMC(np.zeros((200, 3)), np.zeros(200), Z_init=np.zeros((130, 3)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SGPMC(X, y, Z_init=Z)


# -- interpret-mode Pallas kernels (slow) -----------------------------------------------

@pytest.mark.slow
def test_warm_chunk_matches_pallas_interpret():
    """Site 9: ``make_fused_sgpmc_warm(interpret=True)`` (f32, blocked
    Cholesky) against the plain chunk in f32 over 5 steps."""
    X, y, Z, st = _problem(13)
    Xp, yr, Zp, sp = _padded(X, y, Z, st, np.float32)
    chunk = make_fused_sgpmc_warm(N, M, D, 1e-5, steps_per_call=5, interpret=True)
    zeros = {"state": jnp.zeros_like(sp), "Z": jnp.zeros_like(Zp)}
    st_j, Z_j, _, _, losses_j = chunk(sp, Zp, zeros, dict(zeros), Xp, yr,
                                      jnp.asarray(0.0, jnp.float32))
    t = [torch.tensor(a, dtype=F32) for a in (st, X, y, Z)]
    zs, zz = torch.zeros_like(t[0]), torch.zeros_like(t[3])
    s, Zt, *_, losses = sgpmc_warm_chunk_plain(t[0], t[3], zs, zs, zz, zz, t[1], t[2],
                                               1e-5, t0=0, num_steps=5, lr=0.01)
    assert _rel(s, np.asarray(st_j)[0, :DIM]) <= 1e-3
    assert _rel(Zt, np.asarray(Z_j)[:M, :D]) <= 1e-3
    assert _rel(losses, np.asarray(losses_j)) <= 1e-4


def _fused_slabs(key, K, md):
    """``_rand`` of make_fused_nuts, then the compact slices the port reads."""
    k1, k2, k3 = jax.random.split(key, 3)
    rows = max(1, (1 << md) // 128)
    mom = np.asarray(jax.random.normal(k1, (K, 128), jnp.float32))
    treeu = np.asarray(jax.random.uniform(k2, (K * md, 128), jnp.float32))
    leafu = np.asarray(jax.random.uniform(k3, (K * rows, 128), jnp.float32))
    return (torch.tensor(mom[:, :DIM]),
            torch.tensor(treeu.reshape(K, md, 128)[:, :, :2].copy()),
            torch.tensor(leafu.reshape(K, rows * 128)[:, :1 << md].copy()))


@pytest.mark.slow
@pytest.mark.parametrize("algorithm", ["hmc", "nuts"])
def test_sample_chunk_matches_pallas_interpret(algorithm):
    """Sites 2/3 with target="sgpmc" (f32, interpret mode): a fixed-step
    sample chunk of K=3 against the port's plain chunk on the same slabs."""
    X, y, Z, st = (a.astype(np.float32) for a in _problem(14))
    K, md, L, eps = 3, 4, 4, np.float32(0.05)
    fused = make_fused_nuts(X, y, 1e-5, max_depth=md, chunk=K, interpret=True,
                            target="sgpmc", algorithm=algorithm,
                            num_leapfrog=L)(jnp.asarray(Z))
    t = [torch.tensor(a) for a in (st, X, y, Z)]
    U0, g0 = sgpmc_neg_logpost_vg(*t, 1e-5)
    key = jax.random.PRNGKey(5)
    zs_j, _, _, _, stj = fused.sample_chunk(jnp.asarray(st), jnp.asarray(float(U0)),
                                            jnp.asarray(g0.numpy()), key, jnp.asarray(eps),
                                            jnp.ones(DIM, jnp.float32), K)
    mom, treeu, leafu = _fused_slabs(key, K, md)
    zero = torch.zeros(())
    cs = ChainState(z=t[0], U=U0, g=g0, inv_mass=torch.ones(DIM), log_eps=zero,
                    log_eps_avg=zero, h_avg=zero, mu=zero, t_da=zero,
                    wf_mean=torch.zeros(DIM), wf_m2=torch.zeros(DIM), wf_count=zero)
    kw = dict(n_active=K, adapt=False, eps=torch.tensor(eps), core="sgpmc")
    if algorithm == "hmc":
        _, draws, stats = hmc_chunk(cs, *t[1:], 1e-5, mom=mom,
                                    mh=treeu[:, 0, 0].contiguous(), num_leapfrog=L, **kw)
    else:
        _, draws, stats = nuts_chunk_plain(cs, *t[1:], 1e-5, mom=mom, treeu=treeu,
                                           leafu=leafu, max_depth=md, **kw)
    np.testing.assert_array_equal(stats[:, 4].numpy(), np.asarray(stj["n_leapfrog"]))
    np.testing.assert_array_equal(stats[:, 2].numpy() > 0.5, np.asarray(stj["diverging"]))
    assert _rel(draws, zs_j) <= 1e-3
    assert _rel(stats[:, 1], stj["accept_prob"]) <= 1e-3
