"""C-chain sampling of the port (``ggp_tpu_torch.ops.multichain``,
``inference.hmc.multichain_fused``, ``sample_hypers(num_chains=...)``)
against the JAX package's XLA-level functions on CPU.

The chain-batched Pallas kernels are too slow in interpret mode for this
suite, so the port is held against what they compose:
``_rbf_vfe_batched_vg`` (the batched bound), ``_hmc_transition_batched``
with ``_stan_adapt_rows`` (the HMC chunk bodies), ``_nuts_transition_batched``
(the NUTS chunk bodies), ``_find_reasonable_step_size_batched`` and
``_multichain_fused_hmc`` (the sampler loop). Inputs and random slabs are made
with numpy or JAX and handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggp_tpu.inference import hmc as jhmc
from ggp_tpu.models import BayesianSparseGPR_HMC as JaxModel
from ggp_tpu.ops.fused_bound import (block_chol_u, block_ut_inv,
                                     make_rbf_vfe_potential)
from ggp_tpu.ops.fused_multichain import (FusedMultichainHMC,
                                          _hmc_transition_batched,
                                          _nuts_transition_batched,
                                          _rbf_vfe_batched_vg,
                                          _stan_adapt_rows)
from ggp_tpu_torch import BayesianSparseGPR_HMC
from ggp_tpu_torch.inference import hmc as thmc
from ggp_tpu_torch.interop import params_from_jax
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.multichain import (MultichainKernels, hmc_chunk_rows,
                                          make_multichain, mc_hmc_chunk,
                                          mc_nuts_chunk, mc_potential,
                                          nuts_chunk_rows)
from ggp_tpu_torch.ops.nuts_chunk import ChainState

F32, F64 = torch.float32, torch.float64
# Quadratic-target comparisons: the same arithmetic on both sides up to the
# summation order (and the JAX adaptation rows, which it stores in float32),
# i.e. ~1e-8 in f64 over a chunk; a wrong step, decision or window moves a
# draw by O(eps) = O(0.1).
TOL = 1e-6
CURV = np.array([0.5, 1.5, 2.5, 3.5, 4.5])          # quadratic target's curvatures


def _problem(n=48, m=8, d=2):
    """tests/test_fused_multichain.py's problem: n=48, m=8, d=2."""
    r = np.random.default_rng(7)
    X = r.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(X @ r.normal(size=(d,))) + 0.3 * r.normal(size=n)).astype(np.float32)
    return X, y, X[:m].copy()


def _quad_jax(dim, dt=jnp.float64, lanes=None):
    a = np.zeros(lanes or dim)
    a[:dim] = CURV[:dim]
    a = jnp.asarray(a, dt)

    def pot(z):
        return 0.5 * jnp.sum(a * z * z, axis=1, keepdims=True), a * z
    return pot


def _quad_torch(dim, dt=F64):
    a = torch.tensor(CURV[:dim], dtype=dt)

    def pot(z):
        return 0.5 * (a * z * z).sum(1), a * z
    return pot


def _state(z, U, g, le, dt=F64):
    C, dim = z.shape
    zc = torch.zeros(C, dtype=dt)
    zv = torch.zeros((C, dim), dtype=dt)
    return ChainState(z=z, U=U, g=g, inv_mass=torch.ones((C, dim), dtype=dt),
                      log_eps=le, log_eps_avg=le, h_avg=zc, mu=np.log(10.0) + le,
                      t_da=zc, wf_mean=zv, wf_m2=zv, wf_count=zc)


# -- potential --------------------------------------------------------------------

def test_mc_potential_f32_matches_batched_vg():
    """f32: the port's C-chain potential against ``_rbf_vfe_batched_vg``
    with ``block_chol_u``/``block_ut_inv`` factorising (as
    tests/test_fused_multichain.py holds it against the single potential):
    U to rtol 1e-5, g to 1e-3 (blocked vs LAPACK f32 factorisations)."""
    X, y, Z = _problem()
    n, d = X.shape
    m, C = Z.shape[0], 3
    thetas = (np.random.default_rng(3).normal(size=(C, d + 2)) * 0.4).astype(np.float32)
    Np = -(-n // 8) * 8
    Xp = jnp.zeros((Np, 128), jnp.float32).at[:n, :d].set(X)
    yp = jnp.zeros((Np, 1), jnp.float32).at[:n, 0].set(y)
    Zp = jnp.zeros((128, 128), jnp.float32).at[:m, :d].set(Z)
    tp = jnp.zeros((C, 128), jnp.float32).at[:, :d + 2].set(thetas)

    def val_chol(K_list):
        out = []
        for Kj in K_list:
            U = block_chol_u(Kj, block=32)
            out.append((U, block_ut_inv(U, block=32)))
        return out

    Uj, gj = _rbf_vfe_batched_vg(tp, Xp, yp, Zp, n, m, d, 1e-6, C, val_chol)
    Ut, gt = mc_potential(*(torch.tensor(a) for a in (thetas, X, y, Z)), 1e-6)
    assert Ut.shape == (C,) and gt.shape == (C, d + 2)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj)[:, 0], rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj)[:, :d + 2], rtol=1e-3, atol=1e-3)


def test_mc_potential_f64_matches_single_potential_per_chain():
    X, y, Z = (a.astype(np.float64) for a in _problem())
    C, d = 3, X.shape[1]
    thetas = np.random.default_rng(4).normal(size=(C, d + 2)) * 0.4
    pot = make_rbf_vfe_potential(jnp.asarray(X), jnp.asarray(y), 1e-6)
    Ut, gt = mc_potential(*(torch.tensor(a) for a in (thetas, X, y, Z)), 1e-6)
    for c in range(C):
        u1, g1 = pot(jnp.asarray(thetas[c]), jnp.asarray(Z))
        np.testing.assert_allclose(float(Ut[c]), float(u1), rtol=1e-10)
        np.testing.assert_allclose(gt[c].numpy(), np.asarray(g1), rtol=1e-10, atol=1e-10)


# -- HMC chunk ----------------------------------------------------------------------

def _jax_hmc_chunk(pot, z, U, g, da, im, wfm, wfm2, mom, mh, in_w, w_end,
                   n_active, adapt, eps, L, target=0.8, adapt_mass=True):
    """``_mc_warm_chunk_body``/``_mc_sample_chunk_body``'s step, unrolled:
    ``_hmc_transition_batched`` then ``_stan_adapt_rows`` per step."""
    lane8 = jnp.arange(8)[None, :]

    def pick(rows8, i):
        return jnp.sum(rows8 * (lane8 == i), axis=1, keepdims=True)

    draws, acc, div = [], [], []
    for t in range(n_active):
        e = jnp.exp(pick(da, 0)) if adapt else eps[:, None]
        zp, Up, gp, accept, dv = _hmc_transition_batched(
            z, U[:, None], g, e, im, pot, mom[t], mh[t][:, None], L)
        if adapt:
            da, im, wfm, wfm2 = _stan_adapt_rows(zp, accept, da, wfm, wfm2, im,
                                                 bool(in_w[t]), bool(w_end[t]),
                                                 target, adapt_mass, pick, lane8)
        z, U, g = zp, Up[:, 0], gp
        draws.append(zp)
        acc.append(accept[:, 0])
        div.append(dv[:, 0])
    return z, U, g, da, im, wfm, wfm2, jnp.stack(draws), jnp.stack(acc), jnp.stack(div)


def _hmc_case():
    """C=3 chains, K=8 steps of L=5 on a quadratic target, f64; the warm
    window opens at step 1 and ends at step 5."""
    C, dim, K, L = 3, 5, 8, 5
    r = np.random.default_rng(11)
    z0 = r.normal(size=(C, dim))
    mom, mh = r.normal(size=(K, C, dim)), r.uniform(size=(K, C))
    in_w, w_end = np.arange(K) >= 1, np.arange(K) == 5
    le = np.log([0.2, 0.5, 0.85])
    return C, dim, K, L, z0, mom, mh, in_w, w_end, le


def _da_rows(le):
    da = np.zeros((le.shape[0], 8))
    da[:, 0] = da[:, 1] = le
    da[:, 3] = np.log(10.0) + le
    return da


def test_hmc_sample_chunk_matches_jax_composition():
    """Sample chunk (fixed per-chain eps): identical accept decisions and
    divergences, draws and final state to 1e-6."""
    C, dim, K, L, z0, mom, mh, in_w, w_end, le = _hmc_case()
    eps = np.exp(le)
    jpot, tpot = _quad_jax(dim), _quad_torch(dim)
    U0, g0 = jpot(jnp.asarray(z0))
    out_j = _jax_hmc_chunk(jpot, jnp.asarray(z0), U0[:, 0], g0, jnp.asarray(_da_rows(le)),
                           jnp.ones((C, dim)), jnp.zeros((C, dim)), jnp.zeros((C, dim)),
                           jnp.asarray(mom), jnp.asarray(mh), in_w, w_end, K, False,
                           jnp.asarray(eps), L)
    zt = torch.tensor(z0)
    s, draws, stats = hmc_chunk_rows(
        tpot, _state(zt, *tpot(zt), torch.tensor(le)), mom=torch.tensor(mom),
        mh=torch.tensor(mh), n_active=K, adapt=False, eps=torch.tensor(eps),
        num_leapfrog=L)
    zj, Uj, gj, _, _, _, _, dj, accj, divj = (np.asarray(a) for a in out_j)
    moved_j = np.any(dj[1:] != dj[:-1], axis=2)
    moved_t = (draws[1:] != draws[:-1]).any(2).numpy()
    np.testing.assert_array_equal(moved_t, moved_j)              # accept decisions
    np.testing.assert_array_equal(mh < stats[:, :, 1].numpy(), mh < accj)
    np.testing.assert_array_equal(stats[:, :, 2].numpy() > 0.5, divj > 0.5)
    assert 0 < moved_j.sum() < moved_j.size                   # both kinds occur
    np.testing.assert_array_equal(stats[:, :, 4].numpy(), np.full((K, C), L))
    for a, b in ((draws, dj), (stats[:, :, 1], accj), (s.z, zj), (s.U, Uj), (s.g, gj)):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)


def test_hmc_warm_steps_match_jax_composition():
    """Warm chunk: every step (transition, dual averaging, Welford window,
    window end) from the JAX side's state, against the JAX step: identical
    accept decisions, state and adaptation rows to 1e-6. Step by step,
    because ``_stan_adapt_rows`` keeps its rows in float32: over a whole
    chunk that rounding (~1e-7 in log eps) grows along trajectories near the
    leapfrog's stability edge, where dual averaging drives eps."""
    C, dim, K, L, z0, mom, mh, in_w, w_end, le = _hmc_case()
    jpot, tpot = _quad_jax(dim), _quad_torch(dim)
    z = jnp.asarray(z0)
    U, g = jpot(z)
    U = U[:, 0]
    da, im = jnp.asarray(_da_rows(le)), jnp.ones((C, dim))
    wfm = wfm2 = jnp.zeros((C, dim))
    moved = 0
    for t in range(K):
        st = ChainState(
            z=torch.tensor(np.asarray(z)), U=torch.tensor(np.asarray(U)),
            g=torch.tensor(np.asarray(g)), inv_mass=torch.tensor(np.asarray(im)),
            **{f: torch.tensor(np.asarray(da[:, i], np.float64)) for i, f in enumerate(
                ("log_eps", "log_eps_avg", "h_avg", "mu", "t_da", "wf_count"))},
            wf_mean=torch.tensor(np.asarray(wfm)), wf_m2=torch.tensor(np.asarray(wfm2)))
        out_j = _jax_hmc_chunk(jpot, z, U, g, da, im, wfm, wfm2, mom[t:t + 1],
                               mh[t:t + 1], in_w[t:t + 1], w_end[t:t + 1], 1, True,
                               None, L)
        s, draws, stats = hmc_chunk_rows(
            tpot, st, mom=torch.tensor(mom[t:t + 1]), mh=torch.tensor(mh[t:t + 1]),
            n_active=1, adapt=True, in_window=torch.tensor(in_w[t:t + 1]),
            window_end=torch.tensor(w_end[t:t + 1]), num_leapfrog=L)
        z, U, g, da, im, wfm, wfm2, dj, accj, _ = out_j
        np.testing.assert_array_equal(mh[t] < stats[0, :, 1].numpy(), mh[t] < np.asarray(accj[0]))
        moved += int((draws[0] != st.z).any(1).sum())
        for a, b in ((draws[0], dj[0]), (stats[0, :, 1], accj[0]), (s.z, z), (s.U, U),
                     (s.g, g), (s.inv_mass, im), (s.wf_mean, wfm), (s.wf_m2, wfm2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
        for i, f in enumerate(("log_eps", "log_eps_avg", "h_avg", "mu", "t_da", "wf_count")):
            np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(da[:, i]),
                                       rtol=TOL, atol=TOL)
    assert 0 < moved < K * C
    assert not np.allclose(np.asarray(im), 1.0)              # the window ended


# -- NUTS chunk -----------------------------------------------------------------------

def test_nuts_chunk_matches_batched_transition():
    """f64, C=3 chains at spread step sizes (so their trees differ), K=4
    transitions of max depth 5 on a quadratic target: depth, leapfrog
    count and divergence identical, draws to 1e-6. The JAX side takes its
    slabs in the lane layout (TR lanes 2*depth+{0,1}, LU lane k)."""
    C, dim, K, md = 3, 5, 4, 5
    r = np.random.default_rng(21)
    z0 = r.normal(size=(C, dim))
    mom = r.normal(size=(K, C, dim))
    treeu = r.uniform(size=(K, C, md, 2))
    leafu = r.uniform(size=(K, C, 1 << md))
    eps = np.array([0.1, 0.45, 0.9])
    jpot = _quad_jax(dim, lanes=128)
    pad = lambda a: jnp.zeros((C, 128)).at[:, :a.shape[1]].set(a)  # noqa: E731
    z, (U, g) = pad(z0), jpot(pad(z0))
    dj, stj = [], []
    for t in range(K):
        zp, Up, gp, acc, dv, dep, nl, _ = _nuts_transition_batched(
            z, U, g, jnp.asarray(eps)[:, None], jnp.ones((C, 128)), jpot, pad(mom[t]),
            pad(treeu[t].reshape(C, 2 * md)), pad(leafu[t]), C=C, max_depth=md,
            leaf_rows=1)
        z, U, g = zp, Up, gp
        dj.append(np.asarray(zp)[:, :dim])
        stj.append(np.stack([np.asarray(a)[:, 0] for a in (acc, dv, dep, nl)], 1))
    dj, stj = np.stack(dj), np.stack(stj)
    tpot = _quad_torch(dim)
    zt = torch.tensor(z0)
    st = _state(zt, *tpot(zt), torch.tensor(np.log(eps)))
    s, draws, stats = nuts_chunk_rows(
        tpot, st, mom=torch.tensor(mom), treeu=torch.tensor(treeu),
        leafu=torch.tensor(leafu), n_active=K, adapt=False, eps=torch.tensor(eps),
        max_depth=md)
    np.testing.assert_array_equal(stats[:, :, 2:5].numpy(), stj[:, :, 1:4])
    assert len(set(stj[:, :, 2].ravel().tolist())) > 1      # trees really differ
    np.testing.assert_allclose(draws.numpy(), dj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(stats[:, :, 1].numpy(), stj[:, :, 0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.z.numpy(), dj[-1], rtol=TOL, atol=TOL)


# -- step-size search and sampler loop --------------------------------------------------

def test_step_size_search_matches_jax():
    """f64, C=4 chains from spread starts, some doubling and some halving."""
    C, dim = 4, 5
    r = np.random.default_rng(5)
    z0 = r.normal(size=(C, dim)) * np.array([[0.1], [1.0], [3.0], [6.0]])
    key = jax.random.PRNGKey(9)
    jpot = _quad_jax(dim)
    jp = lambda z: tuple(a[:, 0] if a.shape[1] == 1 else a for a in jpot(z))  # noqa: E731
    U0, g0 = jp(jnp.asarray(z0))
    for init in (0.1, 1.0):
        ej = jhmc._find_reasonable_step_size_batched(
            jp, jnp.asarray(z0), U0, g0, key, jnp.ones((C, dim)), init)
        r0 = np.asarray(jax.random.normal(key, (C, dim), jnp.float64))
        tpot = _quad_torch(dim)
        zt = torch.tensor(z0)
        et = thmc.find_reasonable_step_size_batched(
            tpot, zt, *tpot(zt), torch.tensor(r0), torch.ones((C, dim), dtype=F64), init)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=TOL)
        assert len(set(np.asarray(ej).tolist())) > 1


def _jax_quad_fused(C, dim, K, L, algo, md, slabs):
    """A ``FusedMultichainHMC`` on the quadratic target whose chunks are the
    compositions above. Each chunk draws its slabs from its key (as
    ``_rand``/``_rand_nuts`` do) and records them for the port's side."""
    pot = _quad_jax(dim, jnp.float32, lanes=128 if algo == "nuts" else None)
    def pad(a, fill=0.0):                  # _pad_rows of make_fused_hmc_multichain
        return jnp.full((C, 128), fill, jnp.float32).at[:, :a.shape[1]].set(a)

    def potential(z):
        U, g = pot(z if algo == "hmc" else pad(z))
        return U[:, 0], g[:, :dim]

    def draw(key):
        k1, k2, k3 = jax.random.split(key, 3)
        sl = {"mom": jax.random.normal(k1, (K, C, dim), jnp.float32)}
        if algo == "hmc":
            sl["mh"] = jax.random.uniform(k2, (K, C), jnp.float32)
        else:
            sl["treeu"] = jax.random.uniform(k2, (K, C, md, 2), jnp.float32)
            sl["leafu"] = jax.random.uniform(k3, (K, C, 1 << md), jnp.float32)
        slabs.append({k: np.asarray(v) for k, v in sl.items()})
        return sl

    nuts_step = jax.jit(lambda z, U, g, e, im, m, tr, lu: _nuts_transition_batched(
        z, U, g, e, im, pot, m, tr, lu, C=C, max_depth=md, leaf_rows=1))

    def steps(z, U, g, sl, eps_of, im, n_active, adapt_fn):
        zs, acc, div, dep, nlv = [], [], [], [], []
        for t in range(int(n_active)):
            e = eps_of()
            if algo == "hmc":
                zp, Up, gp, a, dv = _hmc_transition_batched(
                    z, U[:, None], g, e, im, pot, sl["mom"][t], sl["mh"][t][:, None], L)
                dp, nl = jnp.zeros_like(a), jnp.full_like(a, L)
            else:                 # its inner fori_loop needs tracing
                with jax.disable_jit(False):
                    zp, Up, gp, a, dv, dp, nl, _ = nuts_step(
                        pad(z), U[:, None], pad(g), e, pad(im, 1.0), pad(sl["mom"][t]),
                        pad(sl["treeu"][t].reshape(C, 2 * md)), pad(sl["leafu"][t]))
                zp, gp = zp[:, :dim], gp[:, :dim]
            im = adapt_fn(zp, a, t, im)
            z, U, g = zp, Up[:, 0], gp
            for lst, v in zip((zs, acc, div, dep, nlv), (zp, a, dv, dp, nl)):
                lst.append(v if v.ndim == 2 and v.shape[1] > 1 else v[:, 0])
        for _ in range(K - int(n_active)):
            for lst, v in zip((zs, acc, div, dep, nlv), (jnp.zeros((C, dim)),) + (jnp.zeros(C),) * 4):
                lst.append(v)
        return z, U, g, im, [jnp.stack(v) for v in (zs, acc, div, dep, nlv)]

    lane8 = jnp.arange(8)[None, :]

    def pick(rows8, i):
        return jnp.sum(rows8 * (lane8 == i), axis=1, keepdims=True)

    def warm_chunk(z, U, g, key, da_cols, wf, inv_mass, in_w, w_end, n_active):
        sl = draw(key)
        box = {"da": jnp.zeros((C, 8), jnp.float32)
               .at[:, :5].set(jnp.stack(da_cols, 1)).at[:, 5].set(wf[2]),
               "wfm": wf[0], "wfm2": wf[1]}

        def adapt_fn(zp, a, t, im):
            da, im, box["wfm"], box["wfm2"] = _stan_adapt_rows(
                zp, a, box["da"], box["wfm"], box["wfm2"], im, bool(in_w[t]),
                bool(w_end[t]), 0.8, True, pick, lane8)
            box["da"] = da
            return im

        z, U, g, im, outs = steps(z, U, g, sl, lambda: jnp.exp(pick(box["da"], 0)),
                                  inv_mass, n_active, adapt_fn)
        da = box["da"]
        return (z, U, g, tuple(da[:, i] for i in range(5)),
                (box["wfm"], box["wfm2"], da[:, 5]), im, outs[1].sum(0), outs[2].sum(0))

    def sample_chunk(z, U, g, key, eps, inv_mass, n_active):
        sl = draw(key)
        z, U, g, _, (zs, acc, div, dep, nlv) = steps(
            z, U, g, sl, lambda: eps[:, None], inv_mass, n_active,
            lambda zp, a, t, im: im)
        if algo == "nuts":
            return zs, z, U, g, acc, div, dep, nlv
        return zs, z, U, g, acc, div

    return FusedMultichainHMC(potential, warm_chunk, sample_chunk, K, C, L, 0.8,
                              True, algo, md if algo == "nuts" else 0)


@pytest.mark.parametrize("algo", ["hmc", "nuts"])
def test_multichain_sampler_matches_jax(algo, monkeypatch):
    """``multichain_fused`` against ``_multichain_fused_hmc`` driving the
    compositions above (f32, as the JAX sampler casts): tune=12, n=8, C=2,
    chunk=4, so the last chunk of each phase is partly inactive. The port
    takes the JAX side's random numbers: its step-size search gets JAX's
    momenta and its chunks the slabs each JAX chunk drew. Shapes,
    trimming, statistics and per-chain step sizes agree to f32 roundoff
    (1e-5 over 20 transitions of a contracting quadratic flow)."""
    C, dim, K, L, md = 2, 5, 4, 3, 4
    cfg_kw = dict(num_warmup=12, num_samples=8, algorithm=algo, num_leapfrog=L,
                  max_depth=md)
    z0 = np.random.default_rng(2).normal(size=(C, dim)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    slabs = []
    fused = _jax_quad_fused(C, dim, K, L, algo, md, slabs)
    in_w, w_end = jhmc.warmup_schedule(12)
    with jax.disable_jit():
        zj, stj = jhmc._multichain_fused_hmc(fused, jnp.asarray(z0), key,
                                              jhmc.NUTSConfig(**cfg_kw), in_w, w_end)
    assert len(slabs) == 3 + 2

    r0 = torch.tensor(np.asarray(jax.random.normal(jax.random.split(key)[1],
                                                   (C, dim), jnp.float32)))
    search = thmc.find_reasonable_step_size_batched
    monkeypatch.setattr(thmc, "find_reasonable_step_size_batched",
                        lambda pot, z, U, g, _r0, im, e: search(pot, z, U, g, r0, im, e))
    queue = [{k: torch.tensor(v) for k, v in sl.items()} for sl in slabs]
    monkeypatch.setattr(thmc, "draw_mc_slabs", lambda *a, **k: queue.pop(0))
    tpot = _quad_torch(dim, F32)
    rows = hmc_chunk_rows if algo == "hmc" else nuts_chunk_rows
    extra = dict(num_leapfrog=L) if algo == "hmc" else dict(max_depth=md)
    mk = MultichainKernels(tpot, lambda st, **kw: rows(tpot, st, **extra, **kw),
                           K, C, L, 0.8, True, algo, md if algo == "nuts" else 0)
    zt, stt = thmc.multichain_fused(mk, torch.tensor(z0), torch.Generator(),
                                    thmc.NUTSConfig(**cfg_kw))
    assert not queue
    assert zt.shape == tuple(zj.shape) == (C, 8, dim)
    for k in ("accept_prob", "diverging", "depth", "n_leapfrog"):
        assert stt[k].shape == tuple(stj[k].shape) == (C, 8), k
    for k in ("diverging", "depth", "n_leapfrog"):
        np.testing.assert_array_equal(stt[k].numpy(), np.asarray(stj[k]), err_msg=k)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **tol)
    np.testing.assert_allclose(stt["accept_prob"].numpy(), np.asarray(stj["accept_prob"]), **tol)
    np.testing.assert_allclose(stt["step_size"].numpy(), np.asarray(stj["step_size"]), **tol)
    np.testing.assert_allclose(stt["inv_mass"].numpy(), np.asarray(stj["inv_mass"]), **tol)
    assert stt["step_size"].shape == (C,) and float(stt["step_size"][0]) != float(stt["step_size"][1])


def test_validate_multichain_cfg_refuses_mismatch():
    mk = MultichainKernels(None, None, 8, 2, 10, 0.8, True, "hmc", 0)
    cfg = thmc.NUTSConfig(algorithm="hmc", num_leapfrog=10)
    assert thmc.validate_multichain_cfg(mk, cfg) == "hmc"
    for bad in (dict(algorithm="nuts"), dict(num_leapfrog=5), dict(target_accept=0.9),
                dict(adapt_mass=False)):
        with pytest.raises(ValueError):
            thmc.validate_multichain_cfg(mk, thmc.NUTSConfig(**{**dict(
                algorithm="hmc", num_leapfrog=10), **bad}))


# -- model ----------------------------------------------------------------------------

def _ks(a, b):
    grid = np.sort(np.concatenate([a, b]))
    fa = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    fb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return float(np.max(np.abs(fa - fb)))


def _model_data(seed=6, N=60, D=3, M=10):
    r = np.random.default_rng(seed)
    X = r.normal(size=(N, D))
    y = np.sin(X @ r.normal(size=D)) + 0.2 * r.normal(size=N)
    Z = X[np.linspace(0, N - 1, M).astype(int)] + 0.05 * r.normal(size=(M, D))
    return X, y, Z


def test_model_multichain_hmc_marginals_match_jax():
    """4 chains x (100 warmup + 100 draws) of HMC (L=10) per side, f64, one
    posterior: every marginal's two-sample KS statistic < 0.2. Between two
    seeds of one package it is 0.04-0.13 at these 400 draws (the noise
    floor); a wrong potential or adaptation moves marginals far beyond."""
    X, y, Z = _model_data()
    D = X.shape[1]
    h0 = {"kernel": {"base": {"log_lengthscale": jnp.zeros(D)},
                     "log_outputscale": jnp.asarray(0.0)}, "log_noise": jnp.asarray(-1.0)}
    jm = JaxModel(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z))
    jm.hypers = h0
    jtr = jm.sample_hypers(100, 100, num_chains=4, key=jax.random.PRNGKey(0),
                           algorithm="hmc")
    tm = BayesianSparseGPR_HMC(torch.tensor(X), torch.tensor(y), Z_init=torch.tensor(Z),
                               device="cpu")
    tm.theta = params_from_jax(jax.device_get(h0))
    ttr = tm.sample_hypers(100, 100, torch.Generator().manual_seed(0), num_chains=4,
                           algorithm="hmc")
    a = params_from_jax(jax.device_get(jtr)).numpy()
    assert ttr.shape == a.shape == (400, D + 2)
    assert tm.stats["accept_prob"].shape == (4, 100) and tm.stats["step_size"].shape == (4,)
    assert torch.equal(tm.stats["n_leapfrog"], torch.full((4, 100), 10.0, dtype=F64))
    torch.testing.assert_close(tm.theta, ttr.mean(0))
    for j in range(D + 2):
        assert _ks(a[:, j], ttr[:, j].numpy()) < 0.2, (j, _ks(a[:, j], ttr[:, j].numpy()))


def test_model_multichain_nuts_train_model_runs_plain_on_cpu():
    """train_model passes num_chains through; C-chain NUTS rounds pool the
    chains chain-major, and the CPU run launches no kernel."""
    X, y, Z = _model_data(seed=8)
    tm = BayesianSparseGPR_HMC(torch.tensor(X), torch.tensor(y), Z_init=torch.tensor(Z),
                               device="cpu")
    before = dict(_build.LAUNCHES)
    losses = tm.train_model(max_steps=24, hmc_scheduler=[20, 22], num_chains=2,
                            generator=torch.Generator().manual_seed(1))
    assert _build.LAUNCHES == before
    assert losses.shape == (24,) and torch.isfinite(losses).all()
    assert tm.trace.shape == (40, X.shape[1] + 2) and torch.isfinite(tm.trace).all()
    assert tm.stats["depth"].shape == (2, 20) and float(tm.stats["depth"].max()) >= 1
    mu, var = tm.mixture_posterior_predictive(torch.tensor(X))
    assert mu.shape == (40, X.shape[0]) and torch.isfinite(mu).all()


def test_multichain_refuses_m_beyond_the_envelope():
    X, y, _ = _model_data()
    Z = torch.zeros((129, X.shape[1]), dtype=F64)
    with pytest.raises(ValueError, match="M <= 128"):
        make_multichain(torch.tensor(X), torch.tensor(y), Z, 1e-6, num_chains=2)


# -- no fallback ------------------------------------------------------------------------

def test_model_default_device_is_the_card():
    """Without ``device`` the model's tensors go to the card; where there is
    none (this suite's machine) construction raises instead of running the
    plain versions."""
    X, y, Z = _model_data()
    if torch.cuda.is_available():
        assert BayesianSparseGPR_HMC(X, y, Z_init=Z).train_x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BayesianSparseGPR_HMC(X, y, Z_init=Z)
    assert BayesianSparseGPR_HMC(X, y, Z_init=Z, device="cpu").train_x.device.type == "cpu"


@pytest.mark.parametrize("dtype", [F32, F64])
def test_mc_wrappers_refuse_meta_tensors(dtype):
    """A tensor that is not on the CPU never reaches a plain version."""
    C, n, m, d = 2, 5, 3, 2
    kw = dict(dtype=dtype, device="meta")
    X, y, Z = torch.zeros((n, d), **kw), torch.zeros(n, **kw), torch.zeros((m, d), **kw)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        mc_potential(torch.zeros((C, d + 2), **kw), X, y, Z, 1e-6)
    zc, zv = torch.zeros(C, **kw), torch.zeros((C, d + 2), **kw)
    st = ChainState(z=zv, U=zc, g=zv, inv_mass=zv, log_eps=zc, log_eps_avg=zc,
                    h_avg=zc, mu=zc, t_da=zc, wf_mean=zv, wf_m2=zv, wf_count=zc)
    mom = torch.zeros((4, C, d + 2), **kw)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        mc_hmc_chunk(st, X, y, Z, 1e-6, mom=mom, mh=torch.zeros((4, C), **kw),
                     n_active=4, adapt=False, eps=zc)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        mc_nuts_chunk(st, X, y, Z, 1e-6, mom=mom, treeu=torch.zeros((4, C, 3, 2), **kw),
                      leafu=torch.zeros((4, C, 8), **kw), n_active=4, adapt=False,
                      eps=zc, max_depth=3)
