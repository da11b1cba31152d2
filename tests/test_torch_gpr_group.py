"""The grouped gpr core's algorithm and host side, on the CPU.

``csrc/gpr_bound.cuh`` spreads one evaluation of the dense GP marginal
(GPR_HMC's potential) over a group of blocks per chain: 32 x 32 tiles, a
right-looking blocked Cholesky fused with a right-looking blocked inverse
(one step a tile column), per-tile partials summed in tile order.
``ops.gpr_bound.gpr_group_neg_logpost_vg`` is a plain model of it that runs
each step's tile tasks block by block, in place in the kernel's two arrays.
It is held in float64 against the JAX package's core
(``fused_bound._gpr_neg_logpost_vg`` through ``make_gpr_potential``) and
against the port's plain potential, at a row count that is a multiple of
the tile and at ragged ones, at several G; its bits must not depend on G
(no task reads what another task of its step writes). The launch geometry
and the scratch sizing of the grouped gpr launch are checked here too; the
kernel itself, and the scratch layout its pointers walk, are held on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggp_tpu.ops.fused_bound import make_gpr_potential as jax_make_gpr_potential
from ggp_tpu.ops.fused_bound import prior_spec_of_tree as jax_spec_of_tree
from ggp_tpu import priors as jpriors
from ggp_tpu_torch import priors as tpriors
from ggp_tpu_torch.ops import _build, vfe_group
from ggp_tpu_torch.ops.gpr_bound import gpr_group_neg_logpost_vg, gpr_neg_logpost_vg
from ggp_tpu_torch.ops.vfe_bound import prior_spec_of_tree

F64 = torch.float64
D = 5
# The model factorises by 32 x 32 tiles with explicit inverses of the
# diagonal tiles, the plain potential with LAPACK: the same algebra in
# another order, ~1e-15 relative in float64 at these condition numbers
# (~1e3); the JAX core's blocked factorisation of its 128-row padding adds
# its own ~1e-14.
TOL_PLAIN = 1e-12
TOL_JAX = 1e-9
GS = [1, 2, 3, 7, 64]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _problem(n, seed=0):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, D))
    y = np.sin(X @ r.normal(size=D)) + 0.2 * r.normal(size=n)
    theta = np.r_[0.3 * r.normal(size=D), 0.2, -1.5]
    return theta, X, y


@pytest.mark.parametrize("n", [150, 203, 128])
def test_model_matches_the_jax_core(n):
    """The model at several G against the JAX core's factory (rows padded to
    128 lanes, its own blocked Cholesky and inverse) in float64, under the
    default prior tree and another closed-form one; 203 leaves a ragged last
    tile, 128 fills its tiles exactly."""
    theta, X, y = _problem(n)
    other_t = {"kernel": {"log_outputscale": tpriors.LogNormal(0.1, 1.5),
                          "base": {"log_lengthscale": tpriors.HalfNormal(2.0)}},
               "log_noise": tpriors.Gamma(3.0, 2.0)}
    other_j = {"kernel": {"log_outputscale": jpriors.LogNormal(0.1, 1.5),
                          "base": {"log_lengthscale": jpriors.HalfNormal(2.0)}},
               "log_noise": jpriors.Gamma(3.0, 2.0)}
    for tree_t, tree_j in ((None, None), (other_t, other_j)):
        spec_j = None if tree_j is None else jax_spec_of_tree(tree_j)
        spec_t = None if tree_t is None else prior_spec_of_tree(tree_t)
        Uj, gj = jax_make_gpr_potential(jnp.asarray(X), jnp.asarray(y), 1e-6,
                                        prior_spec=spec_j)(jnp.asarray(theta))
        for G in (1, 7):
            U, g = gpr_group_neg_logpost_vg(*(torch.tensor(a) for a in (theta, X, y)), 1e-6, G,
                                            prior_spec=spec_t)
            assert _rel(U, Uj) <= TOL_JAX and _rel(g, gj) <= TOL_JAX


@pytest.mark.parametrize("n", [20, 32, 150, 203])
def test_model_matches_the_plain_potential_for_every_g(n):
    """U and dU/dtheta equal the plain potential to TOL_PLAIN, and are the
    same bits for every G (tasks of a step run block by block, in place):
    one tile (n = 20, 32), several, a ragged last tile."""
    theta, X, y = (torch.tensor(a) for a in _problem(n, seed=1))
    ref = gpr_neg_logpost_vg(theta, X, y, 1e-6)
    outs = [gpr_group_neg_logpost_vg(theta, X, y, 1e-6, G) for G in GS]
    for U, g in outs:
        assert _rel(U, ref[0]) <= TOL_PLAIN and _rel(g, ref[1]) <= TOL_PLAIN
        assert torch.equal(U, outs[0][0]) and torch.equal(g, outs[0][1])


def test_model_at_a_capped_lengthscale():
    """A log-lengthscale past the cap (exp(8) > 1024 / max|X|) with one
    outlier in another input: the capped inverse lengthscale, as the plain
    potential forms it."""
    theta, X, y = _problem(150, seed=2)
    theta[0] = -8.0
    X[0, 2] = 20.0
    args = [torch.tensor(a) for a in (theta, X, y)]
    ref = gpr_neg_logpost_vg(*args, 1e-6)
    U, g = gpr_group_neg_logpost_vg(*args, 1e-6, 3)
    assert _rel(U, ref[0]) <= TOL_PLAIN and _rel(g, ref[1]) <= 1e-10


def test_non_pd_gives_nan():
    """A negative jitter that makes K indefinite: a non-positive pivot in
    some diagonal tile, NaN value and gradient (the samplers' divergence),
    as the plain potential gives."""
    theta, X, y = (torch.tensor(a) for a in _problem(150, seed=3))
    theta[D] = -3.0
    theta[D + 1] = 0.0
    U0, g0 = gpr_neg_logpost_vg(theta, X, y, -1.5)
    U, g = gpr_group_neg_logpost_vg(theta, X, y, -1.5, 7)
    assert torch.isnan(U0) and torch.isnan(U) and torch.isnan(g).all()


@pytest.mark.parametrize("n,C,bps", [(1, 1, 1), (404, 1, 1), (404, 4, 1), (1279, 8, 2),
                                     (2049, 3, 1)])
def test_geometry_and_scratch(n, C, bps, monkeypatch):
    """The gpr core is grouped at every n and chain count: a launch takes G
    = the card's resident blocks of its kernel shared among the C chains
    (here 132 SMs of ``bps``), passes it as cfg GROUP and sizes its scratch
    by the C side's count for (n, d, C, G) in the dtype's elements, the C
    barriers zeroed."""
    assert vfe_group.route("gpr", n, C) == "gpr"
    assert "gpr" in _build.GROUPED and "gpr" not in _build._CORE_ID
    calls = []

    class Lib:
        def ggp_gpr_scratch_elems(self, n_, d_, C_, G_, f64):
            calls.append((n_, d_, C_, G_, f64))
            return 64 * C_ + n_ + d_ + G_

    monkeypatch.setattr(_build, "build", lambda: Lib())
    monkeypatch.setattr(vfe_group, "blocks_per_sm", lambda kind, dtype, core: bps)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("P", (), {"multi_processor_count": 132})())
    G = vfe_group.group_size(C, 132, bps)
    assert G == 132 * bps // C >= 1
    for dt in (torch.float32, F64):
        like = torch.ones(2, dtype=dt)
        work, cfg = vfe_group.launch_work("nuts_chunk", "gpr", n, 0, 13, C, like)
        assert cfg == {"GROUP": G} and calls[-1] == (n, 13, C, G, int(dt == F64))
        assert work.dtype == dt and work.numel() == 64 * C + n + 13 + G
        assert not work[:C * 128 // like.element_size()].any()


def test_cpu_wrappers_run_plain_without_a_launch():
    """On CPU tensors the gpr wrappers run the plain potential and launch
    nothing, past the JAX package's 512-row envelope too."""
    from ggp_tpu_torch.ops.multichain import mc_potential
    from ggp_tpu_torch.ops.vfe_bound import vfe_potential
    theta, X, y = (torch.tensor(a) for a in _problem(600, seed=4))
    Z = X.new_empty((0, D))
    before = dict(_build.LAUNCHES)
    a = vfe_potential(theta, X, y, Z, 1e-6, core="gpr")
    c = mc_potential(torch.stack([theta, theta]), X, y, Z, 1e-6, core="gpr")
    assert _build.LAUNCHES == before
    ref = gpr_neg_logpost_vg(theta, X, y, 1e-6)
    assert torch.equal(a[0], ref[0]) and torch.equal(c[1][1], ref[1])
