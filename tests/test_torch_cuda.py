"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; every test skips (with its reason) where there is no
CUDA device. On a machine with one: ``python -m pytest --noconftest -m
cuda tests/test_torch_cuda.py`` (``--noconftest``: tests/conftest.py
imports jax, which this file does not need). The kernels build from
``ggp_tpu_torch/csrc`` at first use.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ggp_tpu_torch import (GPR_HMC, SGPMC, BayesianSparseGPR_HMC,
                           BayesianStochasticVariationalGP, StochasticVariationalGP)
from ggp_tpu_torch.likelihoods import BernoulliProbit, PoissonLogCox, Softmax
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.gpr_bound import gpr_neg_logpost_vg
from ggp_tpu_torch.ops.multichain import (draw_mc_slabs, hmc_chunk, mc_hmc_chunk,
                                          mc_hmc_chunk_plain, mc_nuts_chunk,
                                          mc_nuts_chunk_plain, mc_potential,
                                          mc_potential_plain)
from ggp_tpu_torch.ops.sgpmc_bound import sgpmc_neg_logpost_vg
from ggp_tpu_torch.ops.sgpmc_warm import sgpmc_warm_chunk, sgpmc_warm_chunk_plain
from ggp_tpu_torch.ops.nuts_chunk import (ChainState, as_batch, draw_slabs,
                                          first_chain, nuts_chunk, nuts_chunk_plain,
                                          nuts_transition, nuts_transition_plain)
from ggp_tpu_torch.ops.sgpr_adam import (call_sgpr_adam, sgpr_adam_chunk,
                                         sgpr_adam_chunk_plain, z_adam_chunk, z_adam_chunk_plain,
                                         z_adam_stream, z_adam_stream_plain)
from ggp_tpu_torch.ops import svi
from ggp_tpu_torch.ops.vfe_bound import neg_logpost_vg, rbf_vfe_neg_logpost_vg, vfe_potential
from ggp_tpu_torch.ops.vfe_stats import (vfe_stats_bwd, vfe_stats_bwd_plain, vfe_stats_fwd,
                                         vfe_stats_fwd_plain)
from ggp_tpu_torch.experiments.co2_bayesian_sgpr_hmc import co2_prior_tree
from ggp_tpu_torch.experiments.large_scale_regression_sghmc import main as sghmc_main
from ggp_tpu_torch.kernels import co2_kernel
from ggp_tpu_torch.ops.co2_bound import co2_potential, co2_vfe_neg_logpost_vg

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


@pytest.mark.parametrize("dt", DTYPES)
def test_z_adam_stream_matches_plain(dev, dt):
    """Kernel 12 (the streamed Z chunk) against its plain version at n=2300,
    where z_adam_chunk runs it as at every n on the card: 9 row blocks of
    256, the last one partial; S=3 trace rows, 5 steps from t0=2."""
    th, X, y, Z = _problem(dev, dt, n=2300, m=24, d=5, seed=3)
    thetas = th + 0.1 * torch.randn((3, th.shape[0]), dtype=dt, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(2))
    zz = torch.zeros_like(Z)
    kw = dict(t0=2, num_steps=5, lr=0.01)
    before = dict(_build.LAUNCHES)
    a = z_adam_chunk(Z, zz, zz, thetas, X, y, 1e-6, **kw)
    assert _build.LAUNCHES["z_adam_stream"] == before["z_adam_stream"] + 1
    assert {k: v for k, v in _build.LAUNCHES.items() if k != "z_adam_stream"} \
        == {k: v for k, v in before.items() if k != "z_adam_stream"}
    b = z_adam_stream_plain(Z, zz, zz, thetas, X, y, 1e-6, **kw)
    for u, v in zip(a, b):
        assert _rel(u, v) <= 10 * TOL[dt]


def test_z_adam_stream_failures_raise(dev, monkeypatch, tmp_path):
    """A launch that fails, and a build that fails, raise: nothing falls
    back to the plain version."""
    th, X, y, Z = _problem(dev, torch.float64, n=300, m=8, d=3)
    zz = torch.zeros_like(Z)
    args = (Z, zz, zz, th[None], X, y, 1e-6)
    with monkeypatch.context() as mp:
        mp.setattr(_build, "kernel_fn", lambda base, dtype: (lambda *a: 1))
        with pytest.raises(RuntimeError, match="z_adam_stream: CUDA launch failed"):
            z_adam_stream(*args, t0=0, num_steps=1, lr=0.01)
    with monkeypatch.context() as mp:
        mp.setattr(_build, "_LIB", None)
        mp.setattr(_build, "_BUILD", str(tmp_path))
        mp.setattr(_build, "_nvcc", lambda: "/bin/false")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            z_adam_stream(*args, t0=0, num_steps=1, lr=0.01)


@pytest.mark.parametrize("dt", DTYPES)
def test_z_adam_chunk_runs_kernel_12_at_n404(dev, dt):
    """Site 7's function at the slice's shape (N=404, S=10 trace rows, 20
    steps) through z_adam_chunk: kernel 12, against z_adam_chunk_plain."""
    th, X, y, Z = _problem(dev, dt, n=404, m=40, d=13, seed=8)
    thetas = th + 0.1 * torch.randn((10, th.shape[0]), dtype=dt, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(7))
    zz = torch.zeros_like(Z)
    kw = dict(t0=0, num_steps=20, lr=0.01)
    before = _build.LAUNCHES["z_adam_stream"]
    a = z_adam_chunk(Z, zz, zz, thetas, X, y, 1e-6, **kw)
    assert _build.LAUNCHES["z_adam_stream"] == before + 1
    b = z_adam_chunk_plain(Z, zz, zz, thetas, X, y, 1e-6, **kw)
    for u, v in zip(a, b):
        assert _rel(u, v) <= 10 * TOL[dt]


# -- the vfe core on a group of blocks per chain (csrc/vfe_group.cuh) ----------------

def test_group_scratch_layout_matches_the_kernels(dev):
    """The C side's count of a grouped launch's scratch
    (``ggp_group_scratch_elems``) against the layout the kernel's pointers
    walk (``VfeGroupCore::work``): per chain a 128-byte barrier line; per
    chain the G blocks' double partials (B - I packed, u, yy, the max |X|,
    |alpha|^2, sum Pnm, d QnmX sums, GnmZ) then the T area (the M x M work
    of ``work_elems(0, m, d)``, 8 + 128 scalars, G block areas of Knm_b,
    An_b, xn, zn and QnmX rows), its bytes rounded up to 16."""
    lib = _build.build()
    for n, m, d, C, G in [(13279, 100, 18, 2, 66), (1025, 24, 5, 8, 33), (3000, 7, 13, 1, 264)]:
        nb = -(-n // G)
        partial = [m * (m + 1) // 2, m, 1, 1, 1, 1, d, m * d]
        work0 = [m * m] * 11 + [m] * 7 + [m * d] * 3
        block = [nb * m, nb * m, nb, m, nb * d]
        t_area = sum(work0) + 8 + 128 + G * sum(block)
        for dt in DTYPES:
            itemsize = torch.empty(0, dtype=dt).element_size()
            chain = G * sum(partial) * 8 + -(-t_area * itemsize // 16) * 16
            assert chain % 8 == 0       # every chain's doubles start 8-byte aligned
            want = -(-(C * 128 + C * chain) // itemsize)
            assert lib.ggp_group_scratch_elems(n, m, d, C, G, int(dt == torch.float64)) == want


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", [4096, 13279])
def test_group_potential_matches_plain(dev, dt, n):
    """Past both thresholds the vfe potential runs on the grouped core, at
    one chain (vfe_potential) and two (mc_potential): U and dU/dtheta
    against the plain version, dU/dZ too in float64; two launches on the
    same inputs give the same bits."""
    th, X, y, Z = _problem(dev, dt, n=n, m=100, d=18, seed=9)
    rows = th + 0.05 * torch.randn((2, th.shape[0]), dtype=dt, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(9))
    before = dict(_build.LAUNCHES)
    one = vfe_potential(rows[0], X, y, Z, 1e-6)
    two = mc_potential(rows, X, y, Z, 1e-6)
    assert _build.LAUNCHES["vfe_group_potential"] == before["vfe_group_potential"] + 1
    assert _build.LAUNCHES["vfe_group_mc_potential"] == before["vfe_group_mc_potential"] + 1
    assert _build.LAUNCHES["vfe_potential"] == before["vfe_potential"]
    assert _build.LAUNCHES["mc_potential"] == before["mc_potential"]
    ref = mc_potential_plain(rows, X, y, Z, 1e-6)
    for a, b in zip(two, ref):
        assert _rel(a, b) <= TOL[dt]
    for a, b in zip(one, (ref[0][0], ref[1][0])):
        assert _rel(a, b) <= TOL[dt]
    again = mc_potential(rows, X, y, Z, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(two, again))
    if dt == torch.float64:
        opts = dict(want_z_grad=True, want_prior=False, pivot_floor=1e-6)
        out = vfe_potential(rows[0], X, y, Z, 1e-6, **opts)
        for a, b in zip(out, rbf_vfe_neg_logpost_vg(rows[0], X, y, Z, 1e-6, **opts)):
            assert _rel(a, b) <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_group_nuts_chunk_matches_plain(dev, dt):
    """Two chains of NUTS at n=4096 on the grouped core (K=3, max depth 5):
    per chain, f64 on one path for the whole chunk, f32 at least for its
    first transition; two launches on the same inputs give the same bits."""
    th, X, y, Z = _problem(dev, dt, n=4096, m=32, d=6, seed=10)
    gen = torch.Generator(device=dev).manual_seed(10)
    z = th + 0.05 * torch.randn((2, th.shape[0]), generator=gen, dtype=dt, device=dev)
    U, g = mc_potential_plain(z, X, y, Z, 1e-6)
    le = torch.full((2,), -3.0, dtype=dt, device=dev)
    zc, zv = torch.zeros(2, dtype=dt, device=dev), torch.zeros_like(z)
    st = ChainState(z=z, U=U, g=g, inv_mass=torch.ones_like(z), log_eps=le, log_eps_avg=le,
                    h_avg=zc, mu=le + np.log(10.0), t_da=zc, wf_mean=zv, wf_m2=zv, wf_count=zc)
    K, md = 3, 5
    sl = draw_mc_slabs(K, 2, th.shape[0], algorithm="nuts", max_depth=md, generator=gen,
                       dtype=dt, device=dev)
    kw = dict(n_active=K, adapt=True, max_depth=md, in_window=torch.arange(K, device=dev) >= 1,
              window_end=torch.arange(K, device=dev) == 2, **sl)
    before = dict(_build.LAUNCHES)
    s_k, d_k, x_k = mc_nuts_chunk(st, X, y, Z, 1e-6, **kw)
    assert _build.LAUNCHES["vfe_group_mc_nuts_chunk"] == before["vfe_group_mc_nuts_chunk"] + 1
    assert _build.LAUNCHES["mc_nuts_chunk"] == before["mc_nuts_chunk"]
    s_p, d_p, x_p = mc_nuts_chunk_plain(st, X, y, Z, 1e-6, **kw)
    for c in range(2):
        p = _agreeing_prefix(d_k[:, c], d_p[:, c], x_k[:, c], x_p[:, c], CHUNK_TOL[dt])
        assert p == K if dt == torch.float64 else p >= 1, (c, p)
        assert _rel(x_k[:p, c][:, [0, 1, 5]], x_p[:p, c][:, [0, 1, 5]]) <= CHUNK_TOL[dt]
    s_2, d_2, x_2 = mc_nuts_chunk(st, X, y, Z, 1e-6, **kw)
    assert torch.equal(d_k, d_2) and torch.equal(x_k, x_2) and torch.equal(s_k.z, s_2.z)


def test_group_grid_that_does_not_fit_raises(dev, monkeypatch):
    """A cooperative grid larger than the card holds is refused by the
    launch and raises; nothing falls back to the one-block kernel."""
    from ggp_tpu_torch.ops import vfe_group
    th, X, y, Z = _problem(dev, torch.float64, n=4096, m=16, d=5, seed=11)
    monkeypatch.setattr(vfe_group, "geometry",
                        lambda kind, dtype, chains, device, core="vfe_group": 100000)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        vfe_potential(th, X, y, Z, 1e-6)
    assert _build.LAUNCHES == before


def test_gpr_and_trainer_grids_that_do_not_fit_raise(dev, monkeypatch):
    """The grouped gpr core (one chain and C chains) and the grouped
    warm-start trainer refuse a cooperative grid larger than the card holds
    and raise; nothing falls back to a one-block kernel."""
    from ggp_tpu_torch.ops import vfe_group
    th, X, y, Z = _problem(dev, torch.float64, n=2500, m=16, d=5, seed=11)
    Ze = X.new_empty((0, X.shape[1]))
    monkeypatch.setattr(vfe_group, "geometry",
                        lambda kind, dtype, chains, device, core="vfe_group": 100000)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        vfe_potential(th, X[:300].contiguous(), y[:300].contiguous(), Ze, 1e-6, core="gpr")
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        mc_potential(torch.stack([th, th]), X[:300].contiguous(), y[:300].contiguous(), Ze,
                     1e-6, core="gpr")
    zt, zz = torch.zeros_like(th), torch.zeros_like(Z)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        sgpr_adam_chunk(th, Z, zt, zt, zz, zz, X, y, 1e-6, t0=0, num_steps=2, lr=0.01,
                        clip_norm=10.0)
    assert _build.LAUNCHES == before


# -- the warm start's grouped trainer (kernel 3g, csrc/sgpr_adam.cu) ------------------

@pytest.mark.parametrize("dt", DTYPES)
def test_group_trainer_matches_plain(dev, dt):
    """Past 2048 rows sgpr_adam_chunk runs the grouped trainer: 10 steps from
    t0=3 against the plain version (the one-block kernel's tolerance);
    two launches on the same inputs give the same bits. The same kernel
    below the threshold (called directly) holds too."""
    th, X, y, Z = _problem(dev, dt, n=2500, m=24, d=5, seed=12)
    zt, zz = torch.zeros_like(th), torch.zeros_like(Z)
    kw = dict(t0=3, num_steps=10, lr=0.01, clip_norm=10.0, min_noise=1e-4)
    before = dict(_build.LAUNCHES)
    a = sgpr_adam_chunk(th, Z, zt, zt, zz, zz, X, y, 1e-6, **kw)
    assert _build.LAUNCHES["sgpr_adam_group"] == before["sgpr_adam_group"] + 1
    assert _build.LAUNCHES["sgpr_adam_chunk"] == before["sgpr_adam_chunk"]
    b = sgpr_adam_chunk_plain(th, Z, zt, zt, zz, zz, X, y, 1e-6, **kw)
    for u, v in zip(a, b):
        assert _rel(u, v) <= 10 * TOL[dt]
    again = sgpr_adam_chunk(th, Z, zt, zt, zz, zz, X, y, 1e-6, **kw)
    assert all(torch.equal(u, v) for u, v in zip(a, again))
    Xs, ys = X[:120].contiguous(), y[:120].contiguous()
    a = call_sgpr_adam("group", th, Z, zt, zt, zz, zz, Xs, ys, 1e-6, **kw)
    b = sgpr_adam_chunk_plain(th, Z, zt, zt, zz, zz, Xs, ys, 1e-6, **kw)
    for u, v in zip(a, b):
        assert _rel(u, v) <= 10 * TOL[dt]


def test_trainer_scratch_fits_the_group_core(dev):
    """The grouped trainer's scratch: the grouped core's of one chain (its
    bytes rounded to 16), then G doubles, dU/dZ and G copies of Z."""
    lib = _build.build()
    for n, m, d, G in [(13279, 100, 18, 132), (2049, 24, 5, 7)]:
        for dt in DTYPES:
            f64 = int(dt == torch.float64)
            item = 8 if f64 else 4
            core = -(-lib.ggp_group_scratch_elems(n, m, d, 1, G, f64) * item // 16) * 16
            want = -(-(core + G * 8 + m * d * (1 + G) * item) // item)
            assert lib.ggp_sgpr_adam_group_elems(n, m, d, G, f64) == want


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


# -- the sgpmc core: the whitened JointHMC target over d+2+m ---------------------

def _sgpmc_problem(dev, dt, n=120, m=24, d=5, seed=0):
    """Distinct inducing rows; a state row [log_ls, log_os, log_noise, v]."""
    th, X, y, Z = _problem(dev, dt, n=n, m=m, d=d, seed=seed)
    v = 0.3 * torch.randn(m, dtype=dt, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed))
    return torch.cat([th, v]), X, y, Z


def _sgpmc_start(dev, dt, C, seed=4, log_eps=-3.0):
    st0, X, y, Z = _sgpmc_problem(dev, dt, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = st0 + 0.05 * torch.randn((C, st0.shape[0]), generator=gen, dtype=dt, device=dev)
    U, g = mc_potential_plain(z, X, y, Z, 1e-6, core="sgpmc")
    le = log_eps + 0.1 * torch.arange(C, dtype=dt, device=dev)
    zc, zv = torch.zeros(C, dtype=dt, device=dev), torch.zeros_like(z)
    st = ChainState(z=z, U=U, g=g, inv_mass=torch.ones_like(z), log_eps=le,
                    log_eps_avg=le, h_avg=zc, mu=le + np.log(10.0), t_da=zc,
                    wf_mean=zv, wf_m2=zv, wf_count=zc)
    return st, X, y, Z, gen


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("opts", [dict(), dict(want_z_grad=True, want_prior=False,
                                               pivot_floor=1e-6)])
def test_sgpmc_potential_kernel_matches_plain(dev, dt, opts):
    st, X, y, Z = _sgpmc_problem(dev, dt)
    before = _build.LAUNCHES["sgpmc_potential"]
    out = vfe_potential(st, X, y, Z, 1e-6, core="sgpmc", **opts)
    assert _build.LAUNCHES["sgpmc_potential"] == before + 1
    ref = sgpmc_neg_logpost_vg(st, X, y, Z, 1e-6, **opts)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and _rel(a, b) <= TOL[dt]
    rows = st + 0.1 * torch.randn((8, st.shape[0]), dtype=dt, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(2))
    before = _build.LAUNCHES["sgpmc_mc_potential"]
    out = mc_potential(rows, X, y, Z, 1e-6, core="sgpmc")
    assert _build.LAUNCHES["sgpmc_mc_potential"] == before + 1
    ref = mc_potential_plain(rows, X, y, Z, 1e-6, core="sgpmc")
    for a, b in zip(out, ref):
        assert a.shape == b.shape and _rel(a, b) <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_sgpmc_warm_chunk_kernel_matches_plain(dev, dt):
    st, X, y, Z = _sgpmc_problem(dev, dt, seed=3)
    zs, zz = torch.zeros_like(st), torch.zeros_like(Z)
    kw = dict(t0=2, num_steps=10, lr=0.01)
    before = _build.LAUNCHES["sgpmc_warm_chunk"]
    a = sgpmc_warm_chunk(st, Z, zs, zs, zz, zz, X, y, 1e-6, **kw)
    assert _build.LAUNCHES["sgpmc_warm_chunk"] == before + 1
    b = sgpmc_warm_chunk_plain(st, Z, zs, zs, zz, zz, X, y, 1e-6, **kw)
    for u, v in zip(a, b):
        assert _rel(u, v) <= 10 * TOL[dt]
    assert a[1].is_contiguous() and not torch.equal(a[1], Z)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("adapt", [True, False])
def test_sgpmc_hmc_chunk_kernel_matches_plain(dev, dt, C, adapt):
    """K=6 steps (5 active) of L=4 at grid 1 (``hmc_chunk``) and grid C:
    identical accept decisions, draws within the chunk tolerance."""
    st, X, y, Z, gen = _sgpmc_start(dev, dt, C)
    dim, K = st.z.shape[1], 6
    sl = draw_mc_slabs(K, C, dim, algorithm="hmc", max_depth=0, generator=gen,
                       dtype=dt, device=dev)
    kw = dict(n_active=5, adapt=adapt, num_leapfrog=4, core="sgpmc",
              in_window=torch.arange(K, device=dev) >= 1,
              window_end=torch.arange(K, device=dev) == 3)
    ref = mc_hmc_chunk_plain(st, X, y, Z, 1e-6, eps=torch.exp(st.log_eps), **kw, **sl)
    if C == 1:
        key = "sgpmc_hmc_chunk"
        before = _build.LAUNCHES[key]
        s1, d1, x1 = hmc_chunk(first_chain(st), X, y, Z, 1e-6, mom=sl["mom"][:, 0],
                               mh=sl["mh"][:, 0], eps=torch.exp(st.log_eps[0]), **kw)
        s_k, d_k, x_k = as_batch(s1), d1[:, None], x1[:, None]
    else:
        key = "sgpmc_mc_hmc_chunk"
        before = _build.LAUNCHES[key]
        s_k, d_k, x_k = mc_hmc_chunk(st, X, y, Z, 1e-6, eps=torch.exp(st.log_eps),
                                     **kw, **sl)
    assert _build.LAUNCHES[key] == before + 1
    s_p, d_p, x_p = ref
    mh = sl["mh"][:5]
    assert torch.equal(mh < x_k[:5, :, 1], mh < x_p[:5, :, 1])
    assert _rel(d_k, d_p) <= CHUNK_TOL[dt]
    for f in ("z", "U", "inv_mass", "log_eps"):
        assert _rel(getattr(s_k, f), getattr(s_p, f)) <= CHUNK_TOL[dt], f


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("C", [1, 8])
def test_sgpmc_nuts_chunk_kernel_matches_plain(dev, dt, C):
    """K=3 warm steps of max depth 5 at grid 1 (``nuts_chunk``) and grid
    C: per chain, f64 on one path for the whole chunk, f32 at least for
    its first transition."""
    st, X, y, Z, gen = _sgpmc_start(dev, dt, C, seed=5)
    dim, K, md = st.z.shape[1], 3, 5
    sl = draw_mc_slabs(K, C, dim, algorithm="nuts", max_depth=md, generator=gen,
                       dtype=dt, device=dev)
    kw = dict(n_active=K, adapt=True, max_depth=md, core="sgpmc",
              in_window=torch.arange(K, device=dev) >= 1,
              window_end=torch.arange(K, device=dev) == 1)
    if C == 1:
        key = "sgpmc_nuts_chunk"
        before = _build.LAUNCHES[key]
        slabs = dict(mom=sl["mom"][:, 0], treeu=sl["treeu"][:, 0], leafu=sl["leafu"][:, 0])
        s1, d1, x1 = nuts_chunk(first_chain(st), X, y, Z, 1e-6, **slabs, **kw)
        s2, d2, x2 = nuts_chunk_plain(first_chain(st), X, y, Z, 1e-6, **slabs, **kw)
        d_k, x_k, d_p, x_p = d1[:, None], x1[:, None], d2[:, None], x2[:, None]
    else:
        key = "sgpmc_mc_nuts_chunk"
        before = _build.LAUNCHES[key]
        _, d_k, x_k = mc_nuts_chunk(st, X, y, Z, 1e-6, **kw, **sl)
        _, d_p, x_p = mc_nuts_chunk_plain(st, X, y, Z, 1e-6, **kw, **sl)
    assert _build.LAUNCHES[key] == before + 1
    for c in range(C):
        p = _agreeing_prefix(d_k[:, c], d_p[:, c], x_k[:, c], x_p[:, c], CHUNK_TOL[dt])
        assert p == K if dt == torch.float64 else p >= 1, (c, p)


@pytest.mark.parametrize("num_chains,algorithm", [(1, "hmc"), (1, "nuts"), (3, "hmc")])
def test_sgpmc_model_runs_on_the_card(dev, num_chains, algorithm):
    """Warm start, then sampling through the model's entry point: every
    launch after the warm start reads the Z it returned."""
    st, X, y, Z = _sgpmc_problem(dev, torch.float32, seed=6)
    model = SGPMC(X, y, Z_init=Z)
    before = dict(_build.LAUNCHES)
    losses = model.warm_start(num_steps=20)
    assert torch.isfinite(losses).all() and model.Z.is_contiguous()
    tr = model.train_model(20, 12, num_chains=num_chains, algorithm=algorithm,
                           num_leapfrog=5)
    assert tr.shape == (12 * num_chains, st.shape[0]) and torch.isfinite(tr).all()
    kind = ("" if num_chains == 1 else "mc_") + f"{algorithm}_chunk"
    pot = "potential" if num_chains == 1 else "mc_potential"
    for k in ("sgpmc_warm_chunk", f"sgpmc_{kind}", f"sgpmc_{pot}"):
        assert _build.LAUNCHES[k] > before[k], k
    means, vars_ = model.mixture_posterior_predictive(X[:10])
    assert torch.isfinite(means).all() and (vars_ > 0).all()


# -- the gpr core: the dense GP marginal over d+2 --------------------------------

def _gpr_problem(dev, dt, n=150, d=5, seed=0):
    """GPR_HMC's inputs: theta, X, y and the empty Z the gpr core takes."""
    th, X, y, _ = _problem(dev, dt, n=n, d=d, seed=seed)
    return th, X, y, X.new_empty((0, d))


@pytest.mark.parametrize("dt", DTYPES)
def test_gpr_potential_kernel_matches_plain(dev, dt):
    """One row and C=8 rows (a group of blocks each) against the plain
    version."""
    th, X, y, Z = _gpr_problem(dev, dt)
    before = _build.LAUNCHES["gpr_potential"]
    out = vfe_potential(th, X, y, Z, 1e-6, core="gpr")
    assert _build.LAUNCHES["gpr_potential"] == before + 1
    ref = gpr_neg_logpost_vg(th, X, y, 1e-6)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and _rel(a, b) <= TOL[dt]
    rows = th + 0.2 * torch.randn((8, th.shape[0]), dtype=dt, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(2))
    before = _build.LAUNCHES["gpr_mc_potential"]
    out = mc_potential(rows, X, y, Z, 1e-6, core="gpr")
    assert _build.LAUNCHES["gpr_mc_potential"] == before + 1
    ref = mc_potential_plain(rows, X, y, Z, 1e-6, core="gpr")
    for a, b in zip(out, ref):
        assert a.shape == b.shape and _rel(a, b) <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_gpr_nuts_chunk_grid_c_equals_grid_1(dev, dt):
    """Chain c of a grid-C launch (``mc_nuts_chunk``) equals a grid-1 launch
    (``nuts_chunk``) on chain c's state and slabs, bit for bit (each block
    runs its chain alone); and in f64 both stay on the plain version's path."""
    th, X, y, Z = _gpr_problem(dev, dt, seed=3)
    C, K, md = 4, 3, 5
    gen = torch.Generator(device=dev).manual_seed(3)
    z = th + 0.1 * torch.randn((C, th.shape[0]), generator=gen, dtype=dt, device=dev)
    U, g = mc_potential_plain(z, X, y, Z, 1e-6, core="gpr")
    le = -2.0 + 0.1 * torch.arange(C, dtype=dt, device=dev)
    zc, zv = torch.zeros(C, dtype=dt, device=dev), torch.zeros_like(z)
    st = ChainState(z=z, U=U, g=g, inv_mass=torch.ones_like(z), log_eps=le,
                    log_eps_avg=le, h_avg=zc, mu=le + np.log(10.0), t_da=zc,
                    wf_mean=zv, wf_m2=zv, wf_count=zc)
    sl = draw_mc_slabs(K, C, z.shape[1], algorithm="nuts", max_depth=md, generator=gen,
                       dtype=dt, device=dev)
    kw = dict(n_active=K, adapt=True, max_depth=md, core="gpr",
              in_window=torch.arange(K, device=dev) >= 1,
              window_end=torch.arange(K, device=dev) == 1)
    before = dict(_build.LAUNCHES)
    s_c, d_c, x_c = mc_nuts_chunk(st, X, y, Z, 1e-6, **kw, **sl)
    for c in range(C):
        one = {k: v[:, c].contiguous() for k, v in sl.items()}
        chain_c = ChainState(**{f.name: getattr(st, f.name)[c] for f in dataclasses.fields(st)})
        s1, d1, x1 = nuts_chunk(chain_c, X, y, Z, 1e-6, **one, **kw)
        assert torch.equal(d1, d_c[:, c]) and torch.equal(x1, x_c[:, c]), c
        assert torch.equal(s1.z, s_c.z[c]) and torch.equal(s1.log_eps, s_c.log_eps[c]), c
    assert _build.LAUNCHES["gpr_mc_nuts_chunk"] == before["gpr_mc_nuts_chunk"] + 1
    assert _build.LAUNCHES["gpr_nuts_chunk"] == before["gpr_nuts_chunk"] + C
    if dt == torch.float64:
        _, d_p, x_p = mc_nuts_chunk_plain(st, X, y, Z, 1e-6, **kw, **sl)
        for c in range(C):
            assert _agreeing_prefix(d_c[:, c], d_p[:, c], x_c[:, c], x_p[:, c],
                                    CHUNK_TOL[dt]) == K, c


def test_gpr_scratch_layout_matches_the_kernels(dev):
    """The C side's count of the grouped gpr core's scratch
    (``ggp_gpr_scratch_elems``) against the layout ``GprGroupCore::work``
    walks: per chain a 128-byte barrier line; per chain the doubles (nt (nt
    + 1) / 2 tiles of d + 2 partials, G blocks' per-warp sums of 8 max(d +
    2, 32), G maxima of |X|), then the elements (A and L, np x np with np =
    32 nt; t, a and the log diagonal, np; G blocks' three 32 x 32 tiles),
    the chain's bytes rounded up to 16."""
    lib = _build.build()
    for n, d, C, G in [(404, 13, 1, 132), (1279, 11, 4, 33), (20, 2, 8, 16)]:
        nt = -(-n // 32)
        npad = 32 * nt
        dbl = nt * (nt + 1) // 2 * (d + 2) + G * 8 * max(d + 2, 32) + G
        for dt in DTYPES:
            item = torch.empty(0, dtype=dt).element_size()
            chain = -(-(dbl * 8 + (2 * npad * npad + 3 * npad + 3 * G * 1024) * item) // 16) * 16
            want = -(-(C * (128 + chain)) // item)
            assert lib.ggp_gpr_scratch_elems(n, d, C, G, int(item == 8)) == want


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n,d", [(1279, 11), (33, 3)])
def test_gpr_potential_at_winered_and_one_row_past_a_tile(dev, dt, n, d):
    """The grouped gpr core at bench.py's winered shape (40 tiles a side) and
    at n = 33 (a second tile of one row): one row and three rows against the
    plain version; two launches give the same bits, and a chain of the
    three-row launch the bits of the one-row launch (every sum runs over
    tiles, so the result does not depend on G)."""
    th, X, y, Z = _gpr_problem(dev, dt, n=n, d=d, seed=13)
    out = vfe_potential(th, X, y, Z, 1e-6, core="gpr")
    ref = gpr_neg_logpost_vg(th, X, y, 1e-6)
    for a, b in zip(out, ref):
        assert _rel(a, b) <= TOL[dt]
    again = vfe_potential(th, X, y, Z, 1e-6, core="gpr")
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    rows = torch.stack([th, th + 0.1, th - 0.1])
    three = mc_potential(rows, X, y, Z, 1e-6, core="gpr")
    assert torch.equal(three[0][0], out[0]) and torch.equal(three[1][0], out[1])
    for a, b in zip(three, mc_potential_plain(rows, X, y, Z, 1e-6, core="gpr")):
        assert _rel(a, b) <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_gpr_potential_non_pd_gives_nan(dev, dt):
    """A negative jitter that makes K indefinite: a non-positive pivot in a
    diagonal tile gives NaN value and gradient for one row and for each of
    C rows (the samplers' divergence), as the plain version does; the
    launch does not raise or hang."""
    th, X, y, Z = _gpr_problem(dev, dt, n=150, seed=14)
    th = th.clone()
    th[-2], th[-1] = -3.0, 0.0
    U0, _ = gpr_neg_logpost_vg(th, X, y, -1.5)
    U, g = vfe_potential(th, X, y, Z, -1.5, core="gpr")
    Uc, gc = mc_potential(torch.stack([th, th]), X, y, Z, -1.5, core="gpr")
    assert torch.isnan(U0) and torch.isnan(U) and torch.isnan(g).all()
    assert torch.isnan(Uc).all() and torch.isnan(gc).all()


@pytest.mark.parametrize("num_chains", [1, 3])
def test_gpr_model_runs_on_the_card(dev, num_chains):
    """The GPR+HMC protocol through the model's entry point: 20 warmup
    transitions and 12 draws take more than one chunk launch, so a chunk
    takes the state the previous launch returned."""
    th, X, y, _ = _gpr_problem(dev, torch.float32, seed=6)
    model = GPR_HMC(X, y)
    before = dict(_build.LAUNCHES)
    tr = model.train_model(20, 12, num_chains=num_chains)
    assert tr.shape == (12 * num_chains, th.shape[0]) and torch.isfinite(tr).all()
    pot, chunk = (("gpr_potential", "gpr_nuts_chunk") if num_chains == 1
                  else ("gpr_mc_potential", "gpr_mc_nuts_chunk"))
    per = 16 if num_chains == 1 else 8                 # transitions per launch
    assert _build.LAUNCHES[chunk] - before[chunk] == -(-20 // per) + -(-12 // per)
    assert _build.LAUNCHES[pot] > before[pot]
    assert float(model.stats["diverging"].float().mean()) <= 0.1
    means, vars_ = model.full_mixture_posterior_predictive(X[:10])
    assert means.shape == (12 * num_chains, 10) and (vars_ > 0).all()


# -- the SVI kernels: SVGP (Gaussian, probit, Poisson, softmax) and BayesianSVGP ---------
# A chunk of Adam steps: f64 to one evaluation's tolerance; f32 to Adam's
# (a coordinate whose gradient is 1e-3 of the largest carries 1e-3 times the
# roundoff of the largest into its normalised step).
SVI_TOL = {torch.float64: 1e-9, torch.float32: 1e-2}


def _svi_problem(dev, dt, lik, n=120, m=24, d=5, nb=40, K=6, C=3, seed=0):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d))
    f = np.sin(X @ r.normal(size=d))
    y = {"gauss": f + 0.2 * r.normal(size=n), "bernoulli_probit": (f > 0) * 1.0,
         "poisson": r.poisson(np.exp(f)) * 1.0, "softmax": np.digitize(f, [-0.3, 0.3]) * 1.0,
         "bsvgp": f + 0.2 * r.normal(size=n)}[lik]
    Cl = C if lik == "softmax" else 1
    hd = {"gauss": d + 2, "bsvgp": d + 2}.get(lik, d + 1)
    params = {"hyp": np.r_[0.2 * r.normal(size=d), 0.1, -1.0][:hd],
              "Z": X[r.choice(n, m, replace=False)], "q_mu": 0.3 * r.normal(size=(m, Cl)),
              "q_raw": 0.1 * r.normal(size=(Cl, m, m))}
    if lik == "bsvgp":
        h = d + 2
        params = {"hmu": 0.1 * r.normal(size=h), "Lraw": np.tril(0.2 * r.normal(size=(h, h))),
                  **{k: params[k] for k in ("Z", "q_mu", "q_raw")}}
    idx = torch.tensor(np.stack([r.choice(n, nb, replace=False) for _ in range(K)]),
                       device=dev)
    T = lambda a: torch.tensor(a, dtype=dt, device=dev)      # noqa: E731
    p = {k: T(v) for k, v in params.items()}
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    return p, zeros, T(X), T(y), idx, r


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("lik", ["gauss", "bernoulli_probit", "poisson"])
def test_svi_chunk_kernel_matches_plain(dev, dt, lik):
    p, z, X, y, idx, _ = _svi_problem(dev, dt, lik)
    before = _build.LAUNCHES["svi_chunk"]
    kw = dict(likelihood=lik, t0=2, lr=0.01)
    a = svi.svi_chunk(p, z, dict(z), X, y, idx, 1e-5, **kw)
    assert _build.LAUNCHES["svi_chunk"] == before + 1
    b = svi.svi_chunk_plain(p, z, dict(z), X, y, idx, 1e-5, **kw)
    for u, v in zip(a[:3], b[:3]):
        for k in svi.SVI_NAMES:
            assert _rel(u[k], v[k]) <= SVI_TOL[dt], (k, _rel(u[k], v[k]))
    assert _rel(a[3], b[3]) <= SVI_TOL[dt]


@pytest.mark.parametrize("nb", [256, 300])
@pytest.mark.parametrize("lik", ["bernoulli_probit", "softmax"])
def test_svi_batch_at_and_past_the_block_width(dev, lik, nb):
    """Batches of one block's 256 threads (svgp-probit's) and more, at D=2
    and M=32 (the banana shape), float64."""
    dt = torch.float64
    p, z, X, y, idx, r = _svi_problem(dev, dt, lik, n=320, m=32, d=2, nb=nb, K=4)
    if lik == "softmax":
        eps = torch.tensor(r.normal(size=(4, 4, nb, 3)), dtype=dt, device=dev)
        a = svi.svi_softmax_chunk(p, z, dict(z), X, y, idx, eps, 1e-5, t0=0, lr=0.03)
        b = svi.svi_softmax_chunk_plain(p, z, dict(z), X, y, idx, eps, 1e-5, t0=0, lr=0.03)
    else:
        kw = dict(likelihood=lik, t0=0, lr=0.03)
        a = svi.svi_chunk(p, z, dict(z), X, y, idx, 1e-5, **kw)
        b = svi.svi_chunk_plain(p, z, dict(z), X, y, idx, 1e-5, **kw)
    for k in svi.SVI_NAMES:
        assert _rel(a[0][k], b[0][k]) <= SVI_TOL[dt], k
    assert _rel(a[3], b[3]) <= SVI_TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_svi_softmax_chunk_kernel_matches_plain(dev, dt):
    p, z, X, y, idx, r = _svi_problem(dev, dt, "softmax")
    eps = torch.tensor(r.normal(size=(idx.shape[0], 8, idx.shape[1], 3)), dtype=dt, device=dev)
    before = _build.LAUNCHES["svi_softmax_chunk"]
    a = svi.svi_softmax_chunk(p, z, dict(z), X, y, idx, eps, 1e-5, t0=0, lr=0.01)
    assert _build.LAUNCHES["svi_softmax_chunk"] == before + 1
    b = svi.svi_softmax_chunk_plain(p, z, dict(z), X, y, idx, eps, 1e-5, t0=0, lr=0.01)
    for k in svi.SVI_NAMES:
        assert _rel(a[0][k], b[0][k]) <= SVI_TOL[dt], k
    assert _rel(a[3], b[3]) <= SVI_TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_bsvgp_chunk_kernel_matches_plain(dev, dt):
    p, z, X, y, idx, r = _svi_problem(dev, dt, "bsvgp")
    eps = torch.tensor(r.normal(size=(idx.shape[0], 5, X.shape[1] + 2)), dtype=dt, device=dev)
    before = _build.LAUNCHES["bsvgp_chunk"]
    kw = dict(prior_var=1.0, t0=0, lr=0.01)
    a = svi.bsvgp_chunk(p, z, dict(z), X, y, idx, eps, 1e-5, **kw)
    assert _build.LAUNCHES["bsvgp_chunk"] == before + 1
    b = svi.bsvgp_chunk_plain(p, z, dict(z), X, y, idx, eps, 1e-5, **kw)
    for k in svi.BSVGP_NAMES:
        assert _rel(a[0][k], b[0][k]) <= SVI_TOL[dt], k
    assert _rel(a[3], b[3]) <= SVI_TOL[dt]


@pytest.mark.parametrize("lik", ["gauss", "bernoulli_probit", "poisson", "softmax", "bsvgp"])
def test_svi_models_run_on_the_card(dev, lik):
    """30 epochs of N // 40 = 3 steps through each model's entry point: two
    launches of whole epochs (21 and 9), so the second launch takes the
    parameters and moments the first returned."""
    _, _, X, y, _, _ = _svi_problem(dev, torch.float32, lik)
    key = "bsvgp_chunk" if lik == "bsvgp" else (
        "svi_softmax_chunk" if lik == "softmax" else "svi_chunk")
    before = _build.LAUNCHES[key]
    if lik == "bsvgp":
        m = BayesianStochasticVariationalGP(X, y, Z_init=X[:16], prior_var=1.0)
    else:
        lk = {"gauss": None, "bernoulli_probit": BernoulliProbit(), "poisson": PoissonLogCox(),
              "softmax": Softmax(3, 16)}[lik]
        m = StochasticVariationalGP(X, y, likelihood=lk, Z_init=X[:16])
    losses = m.train_model(num_epochs=30, batch_size=40, lr=0.02)
    assert losses.shape == (30,) and torch.isfinite(losses).all()
    assert float(losses[-1]) < float(losses[0])
    assert _build.LAUNCHES[key] - before == 2
    out = (m.mixture_posterior_predictive(X[:10], 20) if lik == "bsvgp"
           else m.posterior_predictive(X[:10]))
    assert all(torch.isfinite(a).all() for a in out)


# -- the big-N statistics (csrc/vfe_stats.cu) ---------------------------------------------

STATS_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def _stats_problem(dev, dt, n, C, m=20, d=5, B=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, dtype=dt, device=dev)
    X, y = torch.randn((n, d), **kw), torch.randn(n, **kw)
    il = torch.exp(0.2 * torch.randn((C, d), **kw))
    Zs = (X[torch.randint(0, n, (C, m), generator=g, device=dev)] * il[:, None, :]).contiguous()
    os = torch.exp(0.1 * torch.randn(C, **kw))
    idx = None if B is None else torch.randint(0, n, (C, B), generator=g, device=dev)
    gk = torch.randn((C, m, m), **kw)
    return X, y, Zs, il, os, idx, (gk + gk.transpose(-1, -2)).contiguous(), torch.randn((C, m), **kw)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("fam", ["rbf", "matern12", "matern32", "matern52"])
@pytest.mark.parametrize("C,B", [(1, None), (4, None), (1, 77), (4, 77)])
def test_vfe_stats_kernels_match_plain(dev, dt, fam, C, B):
    """Forward and backward against the plain versions; n = 1000 and B = 77
    are not multiples of the row tiles (32 forward, 16 backward), so the
    tail tile is masked; Z rows are taken from X (coincident points)."""
    X, y, Zs, il, os, idx, gsym, dsky = _stats_problem(dev, dt, 1000, C, B=B)
    before = dict(_build.LAUNCHES)
    out = vfe_stats_fwd(X, y, Zs, il, os, idx, fam)
    ref = vfe_stats_fwd_plain(X, y, Zs, il, os, idx, fam)
    for a, b in zip(out, ref):
        assert _rel(a, b) <= STATS_TOL[dt]
    outb = vfe_stats_bwd(X, y, Zs, il, os, idx, gsym, dsky, fam)
    refb = vfe_stats_bwd_plain(X, y, Zs, il, os, idx, gsym, dsky, fam)
    for a, b in zip(outb, refb):
        assert _rel(a, b) <= STATS_TOL[dt]
    assert _build.LAUNCHES["vfe_stats_fwd"] == before["vfe_stats_fwd"] + 1
    assert _build.LAUNCHES["vfe_stats_bwd"] == before["vfe_stats_bwd"] + 1


@pytest.mark.parametrize("dt", DTYPES)
def test_vfe_stats_kernels_beyond_one_tile_and_bf16(dev, dt):
    """M = 150 spans two 128-wide S_kk tiles; bf16 rounds the forward's
    product inputs as the plain version does."""
    X, y, Zs, il, os, idx, gsym, dsky = _stats_problem(dev, dt, 700, 3, m=150, d=7, B=300)
    for bf16 in (False, True):
        for a, b in zip(vfe_stats_fwd(X, y, Zs, il, os, idx, "rbf", bf16),
                        vfe_stats_fwd_plain(X, y, Zs, il, os, idx, "rbf", bf16)):
            assert _rel(a, b) <= STATS_TOL[dt]
    for a, b in zip(vfe_stats_bwd(X, y, Zs, il, os, idx, gsym, dsky),
                    vfe_stats_bwd_plain(X, y, Zs, il, os, idx, gsym, dsky)):
        assert _rel(a, b) <= STATS_TOL[dt]


def test_sghmc_experiment_runs_on_the_card(dev):
    """The SGHMC experiment at a small size on the card: warm start on 4096
    rows, which sgpr_adam_chunk runs on the grouped trainer (past 2048
    rows), SGHMC with the anchor on the statistics kernels."""
    before = dict(_build.LAUNCHES)
    out = sghmc_main(n_rows=None, M=16, warm_iters=20, num_steps=40, control_variate=True)
    assert out["finite"] and np.isfinite(out["rmse"]) and np.isfinite(out["nlpd"])
    for k in ("sgpr_adam_group", "vfe_stats_fwd", "vfe_stats_bwd"):
        assert _build.LAUNCHES[k] > before[k], k


# -- the co2 cores and the one-transition kernel ---------------------------------

def _co2_problem(dev, dt, n=80, m=16, seed=0):
    """1-D inputs around 0 (years), a seasonal y; Z a subset of X."""
    r = np.random.default_rng(seed)
    X = np.sort(r.uniform(-4.0, 4.0, n))[:, None]
    y = np.sin(2 * np.pi * X[:, 0]) + 0.05 * X[:, 0] ** 2 + 0.1 * r.normal(size=n)
    th = 0.3 * r.normal(size=11)
    return [torch.tensor(a, dtype=dt, device=dev) for a in (th, X, y, X[::n // m][:m])]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nc", ["m32", "rbf"])
def test_co2_potential_kernel_matches_plain(dev, dt, nc):
    th, X, y, Z = _co2_problem(dev, dt)
    before = _build.LAUNCHES["co2_potential"]
    out = co2_potential(th, X, y, Z, 1e-4, noise_comp=nc)
    assert _build.LAUNCHES["co2_potential"] == before + 1
    ref = co2_vfe_neg_logpost_vg(th, X, y, Z, 1e-4, noise_comp=nc)
    for a, b in zip(out, ref):
        assert _rel(a, b) <= TOL[dt]


def _transition_chain(step, z, U, g, eps, slabs):
    draws, stats = [], []
    for mom, treeu, leafu in zip(*slabs):
        z, U, g, acc, div, depth, nl, H0 = step(z, U, g, eps, torch.ones_like(z), mom=mom,
                                                treeu=treeu, leafu=leafu)
        draws.append(z)
        stats.append(torch.stack([U, acc, div.to(z.dtype), depth.to(z.dtype),
                                  nl.to(z.dtype), H0]))
    return torch.stack(draws), torch.stack(stats)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("core", ["vfe", "co2_m32"])
def test_nuts_transition_kernel_matches_plain(dev, dt, core):
    """Four chained one-transition launches against the plain transition on
    shared slabs: f64 on one path, f32 agreeing on the first transition."""
    if core == "vfe":
        th, X, y, Z = _problem(dev, dt, seed=3)
        jit = 1e-6
    else:
        th, X, y, Z = _co2_problem(dev, dt, seed=3)
        jit = 1e-4
    K, md = 4, 6
    U0, g0 = neg_logpost_vg(core, th, X, y, Z, jit)
    gen = torch.Generator(device=dev).manual_seed(2)
    slabs = draw_slabs(K, th.shape[0], md, gen, dtype=dt, device=dev)
    eps = torch.tensor(0.05, dtype=dt, device=dev)
    key = _build.launch_key(core, "nuts_transition")
    before = _build.LAUNCHES[key]
    d_k, x_k = _transition_chain(
        lambda *a, **k: nuts_transition(*a, X, y, Z, jit, max_depth=md, core=core, **k),
        th, U0, g0, eps, slabs)
    assert _build.LAUNCHES[key] == before + K
    d_p, x_p = _transition_chain(
        lambda *a, **k: nuts_transition_plain(*a, X, y, Z, jit, max_depth=md, core=core, **k),
        th, U0, g0, eps, slabs)
    p = _agreeing_prefix(d_k, d_p, x_k, x_p, CHUNK_TOL[dt])
    assert p == K if dt == torch.float64 else p >= 1
    assert _rel(x_k[:p][:, [0, 1, 5]], x_p[:p][:, [0, 1, 5]]) <= CHUNK_TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_co2_nuts_chunk_kernel_matches_plain(dev, dt):
    th, X, y, Z = _co2_problem(dev, dt, seed=1)
    K, md = 4, 6
    U0, g0 = co2_vfe_neg_logpost_vg(th, X, y, Z, 1e-4)
    zero = torch.zeros((), dtype=dt, device=dev)
    le = torch.log(torch.tensor(0.05, dtype=dt, device=dev))
    st = ChainState(z=th, U=U0, g=g0, inv_mass=torch.ones_like(th), log_eps=le,
                    log_eps_avg=le, h_avg=zero, mu=le + np.log(10.0), t_da=zero,
                    wf_mean=torch.zeros_like(th), wf_m2=torch.zeros_like(th), wf_count=zero)
    gen = torch.Generator(device=dev).manual_seed(0)
    mom, treeu, leafu = draw_slabs(K, 11, md, gen, dtype=dt, device=dev)
    kw = dict(mom=mom, treeu=treeu, leafu=leafu, n_active=K, adapt=True,
              in_window=torch.arange(K, device=dev) >= 1,
              window_end=torch.arange(K, device=dev) == 2, max_depth=md, core="co2_m32")
    before = _build.LAUNCHES["co2_nuts_chunk"]
    s_k, d_k, x_k = nuts_chunk(st, X, y, Z, 1e-4, **kw)
    assert _build.LAUNCHES["co2_nuts_chunk"] == before + 1
    s_p, d_p, x_p = nuts_chunk_plain(st, X, y, Z, 1e-4, **kw)
    p = _agreeing_prefix(d_k, d_p, x_k, x_p, CHUNK_TOL[dt])
    assert p == K if dt == torch.float64 else p >= 1
    assert _rel(x_k[:p][:, [0, 1, 5]], x_p[:p][:, [0, 1, 5]]) <= CHUNK_TOL[dt]


def test_co2_model_runs_on_the_card(dev):
    """The CO2 composite through the model's entry points: the chunked
    driver (site 1 and one transition launch per transition) and the
    alternating trainer (the co2 NUTS chunk)."""
    th, X, y, Z = _co2_problem(dev, torch.float32, seed=5)
    kern = co2_kernel("matern32")
    model = BayesianSparseGPR_HMC(X, y, Z_init=Z, kernel=kern, prior_tree=co2_prior_tree(kern),
                                  jitter=1e-4)
    before = dict(_build.LAUNCHES)
    model.warm_start(num_steps=20)
    tr = model.train_fixed_model(num_warmup=6, num_samples=4, chunk_size=3,
                                 generator=torch.Generator(device=dev).manual_seed(0))
    assert tr.shape == (4, 11) and torch.isfinite(tr).all()
    assert _build.LAUNCHES["nuts_transition_co2"] - before["nuts_transition_co2"] == 6 + 6
    assert _build.LAUNCHES["co2_potential"] > before["co2_potential"]
    losses = model.train_model(max_steps=8, hmc_scheduler=[4, 8],
                               generator=torch.Generator(device=dev).manual_seed(1))
    assert torch.isfinite(losses).all() and torch.isfinite(model.trace).all()
    assert _build.LAUNCHES["co2_nuts_chunk"] > before["co2_nuts_chunk"]
    mu, var = model.mixture_posterior_predictive(X)
    assert torch.isfinite(mu).all() and (var > 0).all()
