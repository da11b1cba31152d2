"""The port's NUTS chunk and adaptation helpers against the JAX package.

The plain warm and sample chunks (``ggp_tpu_torch.ops.nuts_chunk``) run on
the same random slabs as ``ggp_tpu.ops.fused_nuts.make_fused_nuts(...,
interpret=True)``: the test rebuilds the slabs from the JAX key exactly as
``_rand`` does and hands the port the compact slices it reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggp_tpu.inference import hmc as jhmc
from ggp_tpu.ops.fused_nuts import make_fused_nuts
from ggp_tpu_torch.inference import hmc as thmc
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.nuts_chunk import (ChainState, draw_slabs, nuts_chunk,
                                          nuts_chunk_plain)
from ggp_tpu_torch.ops.vfe_bound import rbf_vfe_neg_logpost_vg

F32 = torch.float32
N, M, D, K, MAX_DEPTH, JITTER = 40, 8, 3, 4, 4, 1e-5
# f32 on both sides, but the JAX kernel factorises with a blocked
# Cholesky + inverse and the port with LAPACK: per-evaluation differences
# of ~1e-6 relative grow along a few leapfrogs; 1e-4 holds them while any
# wrong branch (a different leaf or tree) moves z by O(eps) = O(0.1).
TOL = 1e-4


def _problem():
    r = np.random.default_rng(7)
    X = r.normal(size=(N, D)).astype(np.float32)
    y = (np.sin(X @ r.normal(size=D)) + 0.3 * r.normal(size=N)).astype(np.float32)
    Z = X[:M].copy()
    theta = np.r_[np.zeros(D), 0.3, -1.0].astype(np.float32)
    return theta, X, y, Z


def _slabs(key):
    """``_rand`` of make_fused_nuts, then the compact slices the port reads."""
    k1, k2, k3 = jax.random.split(key, 3)
    mom = np.asarray(jax.random.normal(k1, (K, 128), jnp.float32))
    treeu = np.asarray(jax.random.uniform(k2, (K * MAX_DEPTH, 128), jnp.float32))
    leafu = np.asarray(jax.random.uniform(k3, (K, 128), jnp.float32))
    dim = D + 2
    return (torch.tensor(mom[:, :dim]),
            torch.tensor(treeu.reshape(K, MAX_DEPTH, 128)[:, :, :2].copy()),
            torch.tensor(leafu[:, :1 << MAX_DEPTH].copy()))


def _start(theta, X, y, Z):
    t = [torch.tensor(a) for a in (theta, X, y, Z)]
    U0, g0 = rbf_vfe_neg_logpost_vg(*t, JITTER)
    return t, U0, g0


def test_warmup_schedule_da_and_welford_match_jax():
    for nw in (10, 25, 100, 150, 500, 1000):
        a = thmc.warmup_schedule(nw)
        b = jhmc.warmup_schedule(nw)
        assert np.array_equal(a[0], np.asarray(b[0]))
        assert np.array_equal(a[1], np.asarray(b[1]))
    eps = 0.37
    da_t = thmc.da_init(torch.tensor(eps, dtype=torch.float64))
    da_j = jhmc.da_init(jnp.asarray(eps, jnp.float64))
    for acc in (0.9, 0.2, 0.75, 1.0, 0.0):
        da_t = thmc.da_update(da_t, acc, 0.8)
        da_j = jhmc.da_update(da_j, acc, 0.8)
    for a, b in zip(da_t, da_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)
    r = np.random.default_rng(0)
    wt = thmc.welford_init(4, dtype=torch.float64, device="cpu")
    wj = jhmc.welford_init(4, jnp.float64)
    for _ in range(7):
        x = r.normal(size=4)
        wt = thmc.welford_update(wt, torch.tensor(x))
        wj = jhmc.welford_update(wj, jnp.asarray(x))
    np.testing.assert_allclose(thmc.welford_variance(wt).numpy(),
                               np.asarray(jhmc.welford_variance(wj)), rtol=1e-14)


def test_warm_chunk_matches_pallas_interpret():
    """Warm chunk with a window inside (in-window steps 1-3, window end at
    step 2): state, dual averaging, Welford and inverse mass after the
    chunk, plus the summed accept and divergence counts."""
    theta, X, y, Z = _problem()
    (th, Xt, yt, Zt), U0, g0 = _start(theta, X, y, Z)
    key = jax.random.PRNGKey(11)
    mom, treeu, leafu = _slabs(key)
    le = np.float32(np.log(0.25))
    in_w = np.array([False, True, True, True])
    w_end = np.array([False, False, True, False])
    dim = D + 2

    fused = make_fused_nuts(X, y, JITTER, max_depth=MAX_DEPTH, chunk=K,
                            interpret=True)(jnp.asarray(Z))
    da = jhmc.DAState(*(jnp.asarray(v, jnp.float32) for v in
                        (le, le, 0.0, np.log(10.0) + le, 0.0)))
    wf = jhmc.welford_init(dim, jnp.float32)
    zj, Uj, gj, daj, wfj, imj, acc_j, div_j = fused.warm_chunk(
        jnp.asarray(theta), jnp.asarray(U0.item(), jnp.float32),
        jnp.asarray(g0.numpy()), key, da, wf, jnp.ones(dim, jnp.float32),
        jnp.asarray(in_w), jnp.asarray(w_end), K)

    f = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    st = ChainState(z=th, U=U0, g=g0, inv_mass=torch.ones(dim), log_eps=f(le),
                    log_eps_avg=f(le), h_avg=f(0.0), mu=f(np.log(10.0) + le),
                    t_da=f(0.0), wf_mean=torch.zeros(dim), wf_m2=torch.zeros(dim),
                    wf_count=f(0.0))
    s, _, stats = nuts_chunk_plain(st, Xt, yt, Zt, JITTER, mom=mom, treeu=treeu,
                                   leafu=leafu, n_active=K, adapt=True,
                                   in_window=torch.tensor(in_w),
                                   window_end=torch.tensor(w_end),
                                   max_depth=MAX_DEPTH)
    assert float(stats[:, 2].sum()) == float(div_j)
    np.testing.assert_allclose(float(stats[:, 1].sum()), float(acc_j), rtol=TOL, atol=TOL)
    for a, b in ((s.z, zj), (s.U, Uj), (s.g, gj), (s.inv_mass, imj),
                 (s.wf_mean, wfj.mean), (s.wf_m2, wfj.m2), (s.wf_count, wfj.count),
                 (s.log_eps, daj.log_eps), (s.log_eps_avg, daj.log_eps_avg),
                 (s.h_avg, daj.h_avg), (s.mu, daj.mu), (s.t_da, daj.t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


@pytest.mark.slow
def test_sample_chunk_matches_pallas_interpret():
    """Fixed-step chunk: per-draw z, potential and accept to 1e-4; tree
    depth, leapfrog count and divergence flags exactly."""
    theta, X, y, Z = _problem()
    (th, Xt, yt, Zt), U0, g0 = _start(theta, X, y, Z)
    key = jax.random.PRNGKey(3)
    mom, treeu, leafu = _slabs(key)
    dim, eps = D + 2, np.float32(0.2)
    fused = make_fused_nuts(X, y, JITTER, max_depth=MAX_DEPTH, chunk=K,
                            interpret=True)(jnp.asarray(Z))
    zs, zfin, ufin, gfin, stj = fused.sample_chunk(
        jnp.asarray(theta), jnp.asarray(U0.item(), jnp.float32),
        jnp.asarray(g0.numpy()), key, jnp.asarray(eps), jnp.ones(dim, jnp.float32), K)
    zero = torch.zeros(())
    st = ChainState(z=th, U=U0, g=g0, inv_mass=torch.ones(dim), log_eps=zero,
                    log_eps_avg=zero, h_avg=zero, mu=zero, t_da=zero,
                    wf_mean=torch.zeros(dim), wf_m2=torch.zeros(dim), wf_count=zero)
    s, draws, stats = nuts_chunk_plain(st, Xt, yt, Zt, JITTER, mom=mom, treeu=treeu,
                                       leafu=leafu, n_active=K, adapt=False,
                                       eps=torch.tensor(eps), max_depth=MAX_DEPTH)
    np.testing.assert_array_equal(stats[:, 3].numpy(), np.asarray(stj["depth"]))
    np.testing.assert_array_equal(stats[:, 4].numpy(), np.asarray(stj["n_leapfrog"]))
    np.testing.assert_array_equal(stats[:, 2].numpy() > 0.5, np.asarray(stj["diverging"]))
    np.testing.assert_allclose(draws.numpy(), np.asarray(zs), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(stats[:, 1].numpy(), np.asarray(stj["accept_prob"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.U.numpy(), float(ufin), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.g.numpy(), np.asarray(gfin), rtol=TOL, atol=TOL)


def test_cpu_nuts_chunk_runs_plain_and_counts_no_launch():
    theta, X, y, Z = _problem()
    (th, Xt, yt, Zt), U0, g0 = _start(theta, X, y, Z)
    dim = D + 2
    mom, treeu, leafu = draw_slabs(K, dim, MAX_DEPTH, torch.Generator().manual_seed(1),
                                   dtype=F32, device="cpu")
    zero = torch.zeros(())
    st = ChainState(z=th, U=U0, g=g0, inv_mass=torch.ones(dim), log_eps=zero,
                    log_eps_avg=zero, h_avg=zero, mu=zero, t_da=zero,
                    wf_mean=torch.zeros(dim), wf_m2=torch.zeros(dim), wf_count=zero)
    kw = dict(mom=mom, treeu=treeu, leafu=leafu, n_active=3, adapt=False,
              eps=torch.tensor(0.2), max_depth=MAX_DEPTH)
    before = dict(_build.LAUNCHES)
    a = nuts_chunk(st, Xt, yt, Zt, JITTER, **kw)
    b = nuts_chunk_plain(st, Xt, yt, Zt, JITTER, **kw)
    assert _build.LAUNCHES == before
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert torch.equal(a[1][3], torch.zeros(dim))      # inactive step row
    assert torch.equal(st.z, th)                       # input state untouched
