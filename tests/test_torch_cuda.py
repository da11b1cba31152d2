"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; every test skips (with its reason) where there is no
CUDA device. On a machine with one: ``python -m pytest -m cuda
tests/test_torch_cuda.py``. The kernels build from ``ggp_tpu_torch/csrc``
at first use.
"""

import numpy as np
import pytest
import torch

from ggp_tpu_torch.ops import _build
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
