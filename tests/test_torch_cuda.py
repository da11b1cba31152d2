"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; every test skips (with its reason) where there is no
CUDA device. On a machine with one: ``python -m pytest --noconftest -m
cuda tests/test_torch_cuda.py`` (``--noconftest``: tests/conftest.py
imports jax, which this file does not need). The kernels build from
``ggp_tpu_torch/csrc`` at first use.
"""

import numpy as np
import pytest
import torch

from ggp_tpu_torch import BayesianSparseGPR_HMC
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.multichain import (draw_mc_slabs, mc_hmc_chunk,
                                          mc_hmc_chunk_plain, mc_nuts_chunk,
                                          mc_nuts_chunk_plain, mc_potential,
                                          mc_potential_plain)
from ggp_tpu_torch.ops.nuts_chunk import (ChainState, draw_slabs, nuts_chunk,
                                          nuts_chunk_plain)
from ggp_tpu_torch.ops.sgpr_adam import (sgpr_adam_chunk, sgpr_adam_chunk_plain,
                                         z_adam_chunk, z_adam_chunk_plain)
from ggp_tpu_torch.ops.vfe_bound import rbf_vfe_neg_logpost_vg, vfe_potential

pytestmark = pytest.mark.cuda

# One evaluation: same algebra, different summation order and factorisation
# (LAPACK vs the kernel's unblocked one): ~1e-12 relative in f64, ~1e-6 in
# f32. Adam chunks of 10 steps keep that level; a NUTS chunk integrates a
# chaotic trajectory, so its draws get a looser bound.
TOL = {torch.float64: 1e-9, torch.float32: 1e-3}
CHUNK_TOL = {torch.float64: 1e-6, torch.float32: 1e-2}
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _build.build()
    return torch.device("cuda")


def _problem(dev, dt, n=120, m=24, d=5, seed=0):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d))
    y = np.sin(X @ r.normal(size=d)) + 0.2 * r.normal(size=n)
    Z = X[np.linspace(0, n - 1, m).astype(int)]
    theta = np.r_[0.3 * r.normal(size=d), 0.2, -1.5]
    return [torch.tensor(a, dtype=dt, device=dev) for a in (theta, X, y, Z)]


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-300))


def _agreeing_prefix(d_k, d_p, x_k, x_p, tol):
    """Leading transitions with identical depth, leapfrog count and
    divergence and draws within ``tol`` of the largest draw entry."""
    scale = float(d_p.abs().max())
    for t in range(d_p.shape[0]):
        if not torch.equal(x_k[t, 2:5], x_p[t, 2:5]) \
                or float((d_k[t] - d_p[t]).abs().max()) > tol * scale:
            return t
    return d_p.shape[0]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("opts", [dict(), dict(want_z_grad=True, want_prior=False,
                                               pivot_floor=1e-6)])
def test_potential_kernel_matches_plain(dev, dt, opts):
    th, X, y, Z = _problem(dev, dt)
    before = _build.LAUNCHES["vfe_potential"]
    out = vfe_potential(th, X, y, Z, 1e-6, **opts)
    assert _build.LAUNCHES["vfe_potential"] == before + 1
    ref = rbf_vfe_neg_logpost_vg(th, X, y, Z, 1e-6, **opts)
    for a, b in zip(out, ref):
        assert _rel(a, b) <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_nuts_chunk_kernel_matches_plain(dev, dt):
    th, X, y, Z = _problem(dev, dt, seed=1)
    dim, K, md = th.shape[0], 6, 6
    U0, g0 = rbf_vfe_neg_logpost_vg(th, X, y, Z, 1e-6)
    zero = torch.zeros((), dtype=dt, device=dev)
    le = torch.log(torch.tensor(0.1, dtype=dt, device=dev))
    st = ChainState(z=th, U=U0, g=g0, inv_mass=torch.ones_like(th), log_eps=le,
                    log_eps_avg=le, h_avg=zero, mu=le + np.log(10.0), t_da=zero,
                    wf_mean=torch.zeros_like(th), wf_m2=torch.zeros_like(th),
                    wf_count=zero)
    gen = torch.Generator(device=dev).manual_seed(0)
    mom, treeu, leafu = draw_slabs(K, dim, md, gen, dtype=dt, device=dev)
    kw = dict(mom=mom, treeu=treeu, leafu=leafu, n_active=5, adapt=True,
              in_window=torch.arange(K, device=dev) >= 1,
              window_end=torch.arange(K, device=dev) == 3, max_depth=md)
    s_k, d_k, x_k = nuts_chunk(st, X, y, Z, 1e-6, **kw)
    s_p, d_p, x_p = nuts_chunk_plain(st, X, y, Z, 1e-6, **kw)
    p = _agreeing_prefix(d_k[:5], d_p[:5], x_k[:5], x_p[:5], CHUNK_TOL[dt])
    # f64: one path through the whole chunk. f32: the paths may part where
    # grown roundoff reaches a decision's margin, but not at the first step.
    assert p == 5 if dt == torch.float64 else p >= 1
    assert _rel(x_k[:p][:, [0, 1, 5]], x_p[:p][:, [0, 1, 5]]) <= CHUNK_TOL[dt]
    if p == 5:
        assert _rel(s_k.inv_mass, s_p.inv_mass) <= CHUNK_TOL[dt]
        assert _rel(s_k.log_eps, s_p.log_eps) <= CHUNK_TOL[dt]
    assert torch.equal(d_k[5], torch.zeros_like(d_k[5]))


def _mc_start(dev, dt, C=8, seed=4, log_eps=-2.0):
    """C chains around a common theta: state with per-chain step sizes."""
    th, X, y, Z = _problem(dev, dt, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = th + 0.1 * torch.randn((C, th.shape[0]), generator=gen, dtype=dt, device=dev)
    U, g = mc_potential_plain(z, X, y, Z, 1e-6)
    le = log_eps + 0.1 * torch.arange(C, dtype=dt, device=dev)
    zc, zv = torch.zeros(C, dtype=dt, device=dev), torch.zeros_like(z)
    st = ChainState(z=z, U=U, g=g, inv_mass=torch.ones_like(z), log_eps=le,
                    log_eps_avg=le, h_avg=zc, mu=le + np.log(10.0), t_da=zc,
                    wf_mean=zv, wf_m2=zv, wf_count=zc)
    return st, X, y, Z, gen


@pytest.mark.parametrize("dt", DTYPES)
def test_mc_potential_kernel_matches_plain(dev, dt):
    st, X, y, Z, _ = _mc_start(dev, dt)
    before = _build.LAUNCHES["mc_potential"]
    out = mc_potential(st.z, X, y, Z, 1e-6)
    assert _build.LAUNCHES["mc_potential"] == before + 1
    ref = mc_potential_plain(st.z, X, y, Z, 1e-6)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and _rel(a, b) <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("adapt", [True, False])
def test_mc_hmc_chunk_kernel_matches_plain(dev, dt, adapt):
    """C=8 chains, K=6 steps (5 active) of L=4: the same accept decisions
    in every chain and step, draws within the chunk tolerance."""
    st, X, y, Z, gen = _mc_start(dev, dt)
    C, dim = st.z.shape
    K = 6
    sl = draw_mc_slabs(K, C, dim, algorithm="hmc", max_depth=0, generator=gen,
                       dtype=dt, device=dev)
    kw = dict(n_active=5, adapt=adapt, eps=torch.exp(st.log_eps), num_leapfrog=4,
              in_window=torch.arange(K, device=dev) >= 1,
              window_end=torch.arange(K, device=dev) == 3, **sl)
    before = _build.LAUNCHES["mc_hmc_chunk"]
    s_k, d_k, x_k = mc_hmc_chunk(st, X, y, Z, 1e-6, **kw)
    assert _build.LAUNCHES["mc_hmc_chunk"] == before + 1
    s_p, d_p, x_p = mc_hmc_chunk_plain(st, X, y, Z, 1e-6, **kw)
    mh = sl["mh"][:5]
    assert torch.equal(mh < x_k[:5, :, 1], mh < x_p[:5, :, 1])
    assert torch.equal(x_k[:, :, 2:5], x_p[:, :, 2:5])
    assert _rel(d_k, d_p) <= CHUNK_TOL[dt] and _rel(x_k[:, :, 1], x_p[:, :, 1]) <= CHUNK_TOL[dt]
    for f in ("z", "U", "inv_mass", "log_eps", "log_eps_avg", "wf_m2"):
        assert _rel(getattr(s_k, f), getattr(s_p, f)) <= CHUNK_TOL[dt], f
    assert torch.equal(d_k[5], torch.zeros_like(d_k[5]))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("adapt", [True, False])
def test_mc_nuts_chunk_kernel_matches_plain(dev, dt, adapt):
    """C=8 chains, K=4 steps of max depth 6: per chain, f64 stays on one
    path for the whole chunk; f32 at least for its first transition."""
    st, X, y, Z, gen = _mc_start(dev, dt, seed=5)
    C, dim = st.z.shape
    K, md = 4, 6
    sl = draw_mc_slabs(K, C, dim, algorithm="nuts", max_depth=md, generator=gen,
                       dtype=dt, device=dev)
    kw = dict(n_active=K, adapt=adapt, eps=torch.exp(st.log_eps), max_depth=md,
              in_window=torch.arange(K, device=dev) >= 1,
              window_end=torch.arange(K, device=dev) == 2, **sl)
    before = _build.LAUNCHES["mc_nuts_chunk"]
    s_k, d_k, x_k = mc_nuts_chunk(st, X, y, Z, 1e-6, **kw)
    assert _build.LAUNCHES["mc_nuts_chunk"] == before + 1
    s_p, d_p, x_p = mc_nuts_chunk_plain(st, X, y, Z, 1e-6, **kw)
    for c in range(C):
        p = _agreeing_prefix(d_k[:, c], d_p[:, c], x_k[:, c], x_p[:, c], CHUNK_TOL[dt])
        assert p == K if dt == torch.float64 else p >= 1, (c, p)
        assert _rel(x_k[:p, c][:, [0, 1, 5]], x_p[:p, c][:, [0, 1, 5]]) <= CHUNK_TOL[dt]
    if dt == torch.float64:
        for f in ("z", "U", "inv_mass", "log_eps"):
            assert _rel(getattr(s_k, f), getattr(s_p, f)) <= CHUNK_TOL[dt], f


@pytest.mark.parametrize("algorithm", ["hmc", "nuts"])
def test_model_multichain_runs_on_the_card(dev, algorithm):
    """The C-chain sampler through the model's entry point: every chunk
    launch takes the state the previous launch returned."""
    th, X, y, Z = _problem(dev, torch.float32, seed=6)
    model = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    before = dict(_build.LAUNCHES)
    tr = model.sample_hypers(20, 12, torch.Generator(device=dev).manual_seed(0),
                             num_chains=3, algorithm=algorithm, num_leapfrog=5)
    assert tr.shape == (36, th.shape[0]) and torch.isfinite(tr).all()
    name = f"mc_{algorithm}_chunk"
    assert _build.LAUNCHES[name] - before[name] == 3 + 2     # chunks of 8
    assert _build.LAUNCHES["mc_potential"] > before["mc_potential"]
    assert model.stats["step_size"].shape == (3,)


@pytest.mark.parametrize("dt", DTYPES)
def test_adam_chunk_kernels_match_plain(dev, dt):
    th, X, y, Z = _problem(dev, dt, seed=2)
    zt, zz = torch.zeros_like(th), torch.zeros_like(Z)
    kw = dict(t0=3, num_steps=10, lr=0.01, clip_norm=10.0, min_noise=1e-4)
    a = sgpr_adam_chunk(th, Z, zt, zt, zz, zz, X, y, 1e-6, **kw)
    b = sgpr_adam_chunk_plain(th, Z, zt, zt, zz, zz, X, y, 1e-6, **kw)
    for u, v in zip(a, b):
        assert _rel(u, v) <= 10 * TOL[dt]
    thetas = th + 0.1 * torch.randn((4, th.shape[0]), dtype=dt, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(1))
    a = z_adam_chunk(Z, zz, zz, thetas, X, y, 1e-6, t0=0, num_steps=5, lr=0.01)
    b = z_adam_chunk_plain(Z, zz, zz, thetas, X, y, 1e-6, t0=0, num_steps=5, lr=0.01)
    for u, v in zip(a, b):
        assert _rel(u, v) <= 10 * TOL[dt]


def test_wrappers_raise_on_wrong_inputs(dev):
    th, X, y, Z = _problem(dev, torch.float64)
    with pytest.raises(TypeError):
        vfe_potential(th.half(), X.half(), y.half(), Z.half(), 1e-6)
    with pytest.raises(ValueError):
        vfe_potential(th, X.t(), y, Z, 1e-6)
    with pytest.raises(ValueError):
        vfe_potential(th, X, y, Z.cpu(), 1e-6)
    with pytest.raises(TypeError):
        vfe_potential(th, X, y, Z.float(), 1e-6)
