"""The benchmark's plain reference against the port's plain PyTorch twin in
float64 at a small size (only this test imports both): the potential and its
gradient, both trainers, the predictive, the replayed HMC and NUTS
transitions, and the replayed random slabs."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import adam, bound, sampler
from portbench.reference.slabs import sampling_slabs

N, D, M = 50, 3, 6
JIT = 1e-8


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.normal(size=(N, D)))
    y = torch.as_tensor(np.sin(X.numpy() @ rng.normal(size=D)) + 0.1 * rng.normal(size=N))
    Z = X[:M].clone()
    thetas = torch.as_tensor(rng.normal(scale=0.3, size=(4, D + 2)))
    return X, y, Z, thetas


def test_potential_and_gradient(problem):
    from ggp_tpu_torch.ops.vfe_bound import SPEC_RBF_DEFAULT, rbf_vfe_neg_logpost_vg
    X, y, Z, thetas = problem
    U, g = bound.neg_logpost_vg(thetas, X, y, Z, JIT)
    for i, th in enumerate(thetas):
        Up, gp = rbf_vfe_neg_logpost_vg(th, X, y, Z, JIT, prior_spec=SPEC_RBF_DEFAULT)
        assert abs(float(U[i] - Up)) < 1e-9 * max(1.0, abs(float(Up)))
        assert torch.allclose(g[i], gp, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("duplicates", [False, True])
def test_warm_start(problem, duplicates):
    from ggp_tpu_torch.ops.sgpr_adam import sgpr_adam_chunk_plain
    X, y, Z, _ = problem
    if duplicates:          # a singular Kmm: the trainers' pivot floor takes over
        Z = torch.cat([Z[:3], Z[:3]])
    th0 = torch.zeros(D + 2, dtype=torch.float64)
    zt, zz = torch.zeros_like(th0), torch.zeros_like(Z)
    th, Zp, *_, losses = sgpr_adam_chunk_plain(th0, Z, zt, zt, zz, zz, X, y, JIT, t0=0,
                                               num_steps=12, lr=0.01, clip_norm=10.0,
                                               min_noise=1e-4)
    th2, Z2, losses2 = adam.warm_start(th0, Z, X, y, JIT, steps=12, lr=0.01, clip=10.0,
                                       min_noise=1e-4)
    assert torch.allclose(losses, losses2, rtol=1e-10)
    assert torch.allclose(th, th2, atol=1e-9) and torch.allclose(Zp, Z2, atol=1e-9)


@pytest.mark.parametrize("duplicates", [False, True])
def test_z_steps(problem, duplicates):
    from ggp_tpu_torch.ops.sgpr_adam import z_adam_chunk_plain
    X, y, Z, thetas = problem
    if duplicates:
        Z = torch.cat([Z[:3], Z[:3]])
    zz = torch.zeros_like(Z)
    Zp, _, _, losses = z_adam_chunk_plain(Z, zz, zz, thetas, X, y, JIT, t0=0, num_steps=8,
                                          lr=0.01)
    Z2, losses2 = adam.z_steps(Z, thetas, X, y, JIT, steps=8, lr=0.01)
    # floored, the factor is eliminated column by column (LAPACK's order otherwise)
    rtol = 1e-8 if duplicates else 1e-10
    assert torch.allclose(losses, losses2, rtol=rtol) and torch.allclose(Zp, Z2, atol=1e-8)


def test_predict(problem):
    from ggp_tpu_torch.kernels import default_rbf
    from ggp_tpu_torch.models.bayesian_sgpr_hmc import theta_to_hypers
    from ggp_tpu_torch.models.sgpr import sgpr_predict
    X, y, Z, thetas = problem
    mu, var = bound.predict(thetas, X, y, Z, JIT, X[:7])
    for i, th in enumerate(thetas):
        m, v = sgpr_predict(default_rbf(ard=True), {**theta_to_hypers(th), "Z": Z}, X, y, X[:7], JIT)
        assert torch.allclose(mu[i], m, atol=1e-9) and torch.allclose(var[i], v, atol=1e-9)


@pytest.mark.parametrize("mode,bits", [("tf32", 10), ("bf16", 7)])
def test_products_in_lower_precision(mode, bits):
    a = torch.randn(4, 6, 5)
    b = torch.randn(4, 5, 3)
    r = bound._round(a, 23 - bits)
    assert (r.view(torch.int32) & ((1 << (23 - bits)) - 1) == 0).all()
    assert float(((r - a) / a).abs().max()) <= 2.0 ** -(bits + 1)
    with bound.precision(mode):
        got = bound.mm(a, b)
    assert torch.allclose(got, bound._round(a, 23 - bits) @ bound._round(b, 23 - bits))
    assert not torch.equal(got, a @ b)


def _vg(X, y, Z):
    def vg(z, rows=None):
        return bound.neg_logpost_vg(z, X, y, Z, JIT)
    return vg


def test_hmc_replay(problem):
    from ggp_tpu_torch.ops.multichain import hmc_transition_rows
    from ggp_tpu_torch.ops.vfe_bound import SPEC_RBF_DEFAULT, rbf_vfe_neg_logpost_vg
    X, y, Z, thetas = problem

    def pot(zs):
        outs = [rbf_vfe_neg_logpost_vg(z, X, y, Z, JIT, prior_spec=SPEC_RBF_DEFAULT) for z in zs]
        return torch.stack([u for u, _ in outs]), torch.stack([g for _, g in outs])

    gen = torch.Generator().manual_seed(3)
    mom = torch.randn(thetas.shape, generator=gen, dtype=torch.float64)
    mh = torch.rand(4, generator=gen, dtype=torch.float64)
    eps = torch.full((4,), 0.05, dtype=torch.float64)
    im = torch.ones_like(thetas)
    U0, g0 = pot(thetas)
    zp, _, _, acc, *_ = hmc_transition_rows(pot, thetas, U0, g0, eps, im, mom, mh, 10)
    pts, acc2 = sampler.hmc_trajectories(thetas, eps, im, mom, 10, _vg(X, y, Z))
    assert torch.allclose(acc, acc2, atol=1e-9)
    target = torch.where((mh < acc2)[:, None], pts[:, 1], pts[:, 0])
    assert torch.allclose(zp, target, atol=1e-9)


def test_nuts_replay(problem):
    from ggp_tpu_torch.ops.nuts_chunk import _transition
    from ggp_tpu_torch.ops.vfe_bound import SPEC_RBF_DEFAULT, rbf_vfe_neg_logpost_vg
    X, y, Z, thetas = problem

    def pot(z):
        return rbf_vfe_neg_logpost_vg(z, X, y, Z, JIT, prior_spec=SPEC_RBF_DEFAULT)

    gen = torch.Generator().manual_seed(5)
    R, dim, md = 4, D + 2, 6
    mom = torch.randn((R, dim), generator=gen, dtype=torch.float64)
    treeu = torch.rand((R, md, 2), generator=gen, dtype=torch.float64)
    leafu = torch.rand((R, 1 << md), generator=gen, dtype=torch.float64)
    eps = torch.full((R,), 0.2, dtype=torch.float64)
    im = torch.ones((R, dim), dtype=torch.float64)
    outs = []
    for j in range(R):
        U0, g0 = pot(thetas[j])
        outs.append(_transition(pot, thetas[j], U0, g0, eps[j], im[j], mom[j], treeu[j],
                                leafu[j], md))
    depths = [o[5] for o in outs]
    U0, r0, leaves = sampler.nuts_trajectories(thetas, eps, im, mom, treeu, depths, _vg(X, y, Z))
    sure = sampler.first_leaf_accepted(r0, U0, leaves, treeu, im, 0.0)
    assert any(sure)
    for j, o in enumerate(outs):
        pts = torch.cat([thetas[j][None]] + [lv[0] for lv in leaves[j]])
        assert float((pts - o[0]).abs().amax(-1).min()) < 1e-9
        if sure[j]:
            assert not bool((o[0] == thetas[j]).all())


@pytest.mark.parametrize("chains,algorithm", [(1, "nuts"), (2, "nuts"), (8, "hmc")])
def test_slabs_are_the_samplers(chains, algorithm):
    from ggp_tpu_torch.models import BayesianSparseGPR_HMC
    from ggp_tpu_torch.ops import multichain, nuts_chunk
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(30, 2)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=30), dtype=torch.float32)
    seen = []
    real = (nuts_chunk.nuts_chunk, multichain.mc_hmc_chunk, multichain.mc_nuts_chunk)

    def spy(fn):
        def wrapped(*a, **kw):
            seen.append({k: kw[k] for k in ("mom", "mh", "treeu", "leafu") if k in kw})
            return fn(*a, **kw)
        return wrapped

    import ggp_tpu_torch.inference.hmc as hmc
    mp = pytest.MonkeyPatch()
    mp.setattr(hmc, "nuts_chunk", spy(real[0]))
    mp.setattr(multichain, "mc_hmc_chunk", spy(real[1]))
    mp.setattr(multichain, "mc_nuts_chunk", spy(real[2]))
    try:
        m = BayesianSparseGPR_HMC(X, y, Z_init=X[:4], device="cpu")
        m.sample_hypers(5, 11, torch.Generator().manual_seed(9), num_chains=chains,
                        algorithm=algorithm)
    finally:
        mp.undo()
    K = 16 if chains == 1 else 8
    n_w = math.ceil(5 / K)
    got = {k: torch.cat([s[k] for s in seen[n_w:]])[:11] for k in seen[0]}
    want = sampling_slabs(9, chains=chains, dim=4, warmup=5, samples=11, algorithm=algorithm,
                          max_depth=8, dtype=torch.float32, device="cpu")
    for k, v in want.items():
        assert torch.equal(got[k].reshape(v.shape), v)
