"""The grouped vfe core's host side and summation order, on the CPU.

``ops/vfe_group.py`` holds what a launch of the grouped core
(``csrc/vfe_group.cuh``) needs and the CPU can check: the routing rule, the
launch geometry (G from the SM count, the kernel's occupancy and the chain
count; contiguous row blocks), a launch's scratch, and a plain model of the
kernel's order of summation (row-block partials summed p = 0 .. G-1, then
the M x M part). The model is held in float64 against the port's plain
potential and against the JAX package's resident core
(``fused_bound._rbf_vfe_neg_logpost_vg``) and its streamed C-chain core
(``fused_multichain._rbf_vfe_batched_vg_streaming``), which the grouped
core replaces on the card. ``z_adam_chunk``'s routing (kernel 12 for every
CUDA tensor) is checked on the ``meta`` device, which is not the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggp_tpu.ops.fused_bound import _default_chol_inv, _rbf_vfe_neg_logpost_vg
from ggp_tpu.ops.fused_multichain import _rbf_vfe_batched_vg_streaming
from ggp_tpu_torch.ops import _build, sgpr_adam, vfe_group
from ggp_tpu_torch.ops.multichain import mc_potential
from ggp_tpu_torch.ops.sgpmc_bound import sgpmc_neg_logpost_vg
from ggp_tpu_torch.ops.vfe_bound import rbf_vfe_neg_logpost_vg, vfe_potential
from ggp_tpu_torch.ops.vfe_group import group_neg_logpost_vg, group_size, route, row_blocks

F64 = torch.float64
# The model sums the same terms as the plain potential in another order
# (row blocks, double partials): ~1e-15 relative in float64 on this
# well-conditioned problem; the JAX cores factorise with their own blocked
# Cholesky (~1e-13).
TOL_MODEL = 1e-12
TOL_JAX = 1e-10
N, M, D, JITTER = 600, 10, 4, 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _problem(seed=0, n=N, m=M, d=D):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d))
    y = np.sin(X @ r.normal(size=d)) + 0.2 * r.normal(size=n)
    Z = X[np.linspace(0, n - 1, m).astype(int)] + 0.05 * r.normal(size=(m, d))
    thetas = np.c_[0.2 * r.normal(size=(2, d)), 0.3 + 0.1 * r.normal(size=2),
                   -1.5 + 0.1 * r.normal(size=2)]
    return X, y, Z, thetas


# -- the launch geometry -----------------------------------------------------------

@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("n", [1, 404, 1025, 2049, 13279])
def test_geometry_covers_the_rows_once(n, C):
    """G = the card's resident blocks shared equally among C chains (132
    SMs of an H100; one and two blocks per SM); the row blocks are
    contiguous, within one row of each other, cover [0, n) exactly once, and
    none exceeds the scratch's ceil(n / G) rows."""
    for bps in (1, 2):
        G = group_size(C, 132, bps)
        assert G == 132 * bps // C and G * C <= 132 * bps
        blocks = row_blocks(n, G)
        assert len(blocks) == G
        covered = []
        for r0, nr in blocks:
            assert nr >= 0 and nr <= -(-n // G)
            covered.extend(range(r0, r0 + nr))
        assert covered == list(range(n))
        sizes = [nr for _, nr in blocks]
        assert max(sizes) - min(sizes) <= 1


def test_group_size_raises_without_a_block_per_chain():
    """More chains than resident blocks: no grid fits, and nothing falls
    back to a smaller group."""
    with pytest.raises(RuntimeError, match="block per chain"):
        group_size(300, 132, 2)


class _CountingLib:
    """Stands in for the built library: the C side's scratch counts, as a
    fixed function of their arguments, and a record of the calls."""

    def __init__(self):
        self.calls = []

    def ggp_group_scratch_elems(self, n, m, d, C, G, f64):
        self.calls.append(("group", n, m, d, C, G, f64))
        return 1000 + n + m + d + C + G + f64

    def ggp_sgpmc_group_scratch_elems(self, n, m, d, C, G, f64):
        self.calls.append(("sgpmc_group", n, m, d, C, G, f64))
        return 4000 + n + m + d + C + G + f64

    def ggp_gpr_scratch_elems(self, n, d, C, G, f64):
        self.calls.append(("gpr", n, d, C, G, f64))
        return 2000 + n + d + C + G + f64

    def ggp_scratch_elems(self, core_id, n, m, d):
        self.calls.append(("core", core_id, n, m, d))
        return 500 + n + m + d + core_id


@pytest.mark.parametrize("dt", [torch.float32, F64])
@pytest.mark.parametrize("kind,core,n,m,d,C", [
    ("potential", "vfe_group", 13279, 100, 18, 1), ("nuts_chunk", "vfe_group", 1025, 24, 5, 8),
    ("potential", "vfe", 404, 100, 2, 2), ("nuts_chunk", "co2_m32", 541, 480, 1, 4),
    ("potential", "gpr", 404, 0, 13, 1), ("nuts_chunk", "gpr", 1279, 0, 11, 4),
    ("potential", "sgpmc_group", 13279, 100, 18, 1), ("nuts_chunk", "sgpmc_group", 2049, 24, 5, 2),
    ("hmc_chunk", "sgpmc_group", 13279, 100, 18, 8), ("hmc_chunk", "vfe_group", 1025, 24, 5, 8)])
def test_launch_work(kind, core, n, m, d, C, dt, monkeypatch):
    """A grouped launch (the vfe core past its threshold, the sgpmc and gpr
    cores at every n) takes G from the geometry of its core's kernel kind,
    the chain count and n, passes it as cfg GROUP, and sizes its scratch
    by the C side's count for that core (for the sgpmc group, with G full
    M x M partials a chain) with each chain's 128-byte barrier zeroed; any
    other core takes one evaluation's area per chain and no GROUP."""
    lib = _CountingLib()
    monkeypatch.setattr(_build, "build", lambda: lib)
    seen = []
    monkeypatch.setattr(vfe_group, "geometry", lambda k, t, chains, device, core, n:
                        seen.append((k, t, chains, core, n)) or 7 * chains)
    like = torch.ones(3, dtype=dt)
    work, cfg = vfe_group.launch_work(kind, core, n, m, d, C, like)
    assert work.dtype == dt and work.device == like.device
    f64 = int(dt == F64)
    if core in ("vfe_group", "sgpmc_group", "gpr"):
        G = 7 * C
        assert seen == [(kind, dt, C, core, n)] and cfg == {"GROUP": G}
        if core == "gpr":
            assert lib.calls == [("gpr", n, d, C, G, f64)]
            assert work.numel() == lib.ggp_gpr_scratch_elems(n, d, C, G, f64)
        elif core == "sgpmc_group":
            assert lib.calls == [("sgpmc_group", n, m, d, C, G, f64)]
            assert work.numel() == lib.ggp_sgpmc_group_scratch_elems(n, m, d, C, G, f64)
        else:
            assert lib.calls == [("group", n, m, d, C, G, f64)]
            assert work.numel() == lib.ggp_group_scratch_elems(n, m, d, C, G, f64)
        assert torch.equal(work[:C * 128 // like.element_size()],
                           torch.zeros(C * 128 // like.element_size(), dtype=dt))
    else:
        assert seen == [] and cfg == {}
        (call,) = lib.calls
        assert call[0] == "core" and call[2:] == (n, m, d)
        assert work.numel() == C * lib.ggp_scratch_elems(*call[1:])


# -- the routing rule --------------------------------------------------------------

@pytest.mark.parametrize("core,n,C,want", [
    ("vfe", 404, 1, "vfe"), ("vfe", 2048, 1, "vfe"), ("vfe", 2049, 1, "vfe_group"),
    ("vfe", 1024, 2, "vfe"), ("vfe", 1025, 2, "vfe_group"), ("vfe", 1025, 8, "vfe_group"),
    ("vfe", 13279, 2, "vfe_group"), ("sgpmc", 13279, 2, "sgpmc_group"), ("gpr", 1279, 4, "gpr"),
    ("co2_m32", 4096, 1, "co2_m32"), ("sgpmc", 2048, 1, "sgpmc_group"),
    ("sgpmc", 2049, 1, "sgpmc_group"), ("sgpmc", 1024, 2, "sgpmc_group"),
    ("sgpmc", 1025, 2, "sgpmc_group"), ("sgpmc", 1025, 1, "sgpmc_group"),
    ("sgpmc", 13279, 8, "sgpmc_group")])
def test_route(core, n, C, want):
    """The grouped vfe core where the JAX package streams the vfe core:
    past 1024 rows for C >= 2 chains (MAX_N_MULTICHAIN), past 2048 for one
    (MAX_N_RESIDENT); the grouped sgpmc core at every n (it has no one-block
    kernel); the co2 cores keep their one-block kernels, the gpr core is
    grouped at every n under its own name."""
    assert route(core, n, C) == want


@pytest.mark.parametrize("core", ["vfe", "sgpmc"])
def test_cpu_wrappers_above_the_threshold_run_plain(core):
    """On CPU tensors the routed wrappers run the plain versions and
    launch nothing, at n past both thresholds."""
    X, y, Z, thetas = _problem(seed=1, n=2100, m=6, d=3)
    if core == "sgpmc":
        thetas = np.c_[thetas, 0.3 * np.random.default_rng(1).normal(size=(2, 6))]
    Xt, yt, Zt, tt = (torch.tensor(a) for a in (X, y, Z, thetas))
    before = dict(_build.LAUNCHES)
    U, g = mc_potential(tt, Xt, yt, Zt, JITTER, core=core)
    U1, g1 = vfe_potential(tt[0], Xt, yt, Zt, JITTER, core=core)
    assert _build.LAUNCHES == before
    ref = (rbf_vfe_neg_logpost_vg if core == "vfe" else sgpmc_neg_logpost_vg)(
        tt[0], Xt, yt, Zt, JITTER)
    assert torch.equal(U[0], ref[0]) and torch.equal(U1, ref[0]) and torch.equal(g1, ref[1])


@pytest.mark.parametrize("n", [404, 2049])
def test_z_chunk_routes_to_kernel_12_off_the_cpu(n, monkeypatch):
    """z_adam_chunk sends every tensor that is not on the CPU (on the card:
    CUDA) to z_adam_stream, kernel 12's wrapper, at any n; on the CPU it
    keeps the JAX package's size routing."""
    calls = []
    monkeypatch.setattr(sgpr_adam, "z_adam_stream",
                        lambda *a, **kw: calls.append(a[4].device.type) or a[:3])
    Z = torch.zeros((4, 2), device="meta", dtype=F64)
    X = torch.zeros((n, 2), device="meta", dtype=F64)
    y = torch.zeros(n, device="meta", dtype=F64)
    th = torch.zeros((3, 4), device="meta", dtype=F64)
    sgpr_adam.z_adam_chunk(Z, Z, Z, th, X, y, JITTER, t0=0, num_steps=1, lr=0.01)
    assert calls == ["meta"]
    Xc, yc, Zc, tc = (torch.tensor(a) for a in _problem(seed=2, n=n, m=4, d=2))
    zz = torch.zeros_like(Zc)
    sgpr_adam.z_adam_chunk(Zc, zz, zz, tc, Xc, yc, JITTER, t0=0, num_steps=1, lr=0.01)
    assert calls == ["meta"] + (["cpu"] if n > sgpr_adam.STREAM_MIN_N else [])


# -- the plain model of the kernel's summation order --------------------------------

@pytest.mark.parametrize("opts", [dict(), dict(want_z_grad=True, want_prior=False,
                                                pivot_floor=1e-6)])
@pytest.mark.parametrize("G", [1, 7, 66, 601])
def test_group_model_matches_the_plain_potential(G, opts):
    """Row-block partials summed p = 0 .. G-1 (G = 601 leaves a block
    empty), then the M x M part: U, dU/dtheta (and dU/dZ) equal the plain
    potential to TOL_MODEL in float64."""
    X, y, Z, thetas = _problem()
    args = [torch.tensor(a) for a in (thetas[0], X, y, Z)]
    got = group_neg_logpost_vg(*args, JITTER, G, **opts)
    ref = rbf_vfe_neg_logpost_vg(*args, JITTER, **opts)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= TOL_MODEL


def test_group_model_matches_the_jax_resident_core():
    """The model at G = 66 against ``_rbf_vfe_neg_logpost_vg`` (padded
    layout, the prior and the trainers' pivot floor off, Z gradient on)."""
    X, y, Z, thetas = _problem(seed=3)
    n, d = X.shape
    m = Z.shape[0]
    Np, Mp = -(-n // 8) * 8, 32
    Xp = np.zeros((Np, 128)); Xp[:n, :d] = X
    yp = np.zeros((Np, 1)); yp[:n, 0] = y
    Zp = np.zeros((Mp, 128)); Zp[:m, :d] = Z
    tp = np.zeros((1, 128)); tp[0, :d + 2] = thetas[0]
    out = jax.jit(lambda t, a, b, c: _rbf_vfe_neg_logpost_vg(
        t, a, b, c, n, m, d, JITTER, want_z_grad=True, want_prior=True, pivot_floor=None,
        prior_spec=None))(*(jnp.asarray(a) for a in (tp, Xp, yp, Zp)))
    got = group_neg_logpost_vg(*(torch.tensor(a) for a in (thetas[0], X, y, Z)), JITTER, 66,
                               want_z_grad=True)
    assert _rel(got[0], float(out[0])) <= TOL_JAX
    assert _rel(got[1], np.asarray(out[1])[0, :d + 2]) <= TOL_JAX
    assert _rel(got[2], np.asarray(out[2])[:m, :d]) <= TOL_JAX


def test_group_model_matches_the_jax_streamed_chain_core():
    """Two chains of the model at G = 132 (every block a handful of rows)
    against ``_rbf_vfe_batched_vg_streaming`` at C=2 (row blocks of 64, the
    default priors), the core the grouped kernels replace."""
    X, y, Z, thetas = _problem(seed=4)
    n, d = X.shape
    m, nb = Z.shape[0], 64
    Np = -(-n // nb) * nb
    slab = jnp.zeros((Np, 128), jnp.float64).at[:n, :d].set(X).at[:n, 127].set(y)

    def loop_blocks(body, carry):
        for t in range(Np // nb):
            carry = body(jnp.asarray(t, jnp.int32), slab[t * nb:(t + 1) * nb], carry)
        return carry

    rows = jnp.zeros((2, 128), jnp.float64).at[:, :d + 2].set(thetas)
    Zp = jnp.zeros((128, 128), jnp.float64).at[:m, :d].set(Z)
    U_j, g_j = _rbf_vfe_batched_vg_streaming(
        rows, Zp, n, m, d, JITTER, 2, lambda Ks: [_default_chol_inv(K) for K in Ks],
        loop_blocks, nb, data_scale=float(np.abs(X).max()))
    for c in range(2):
        U, g = group_neg_logpost_vg(*(torch.tensor(a) for a in (thetas[c], X, y, Z)), JITTER,
                                    132)
        assert _rel(U, np.asarray(U_j).reshape(-1)[c]) <= TOL_JAX
        assert _rel(g, np.asarray(g_j)[c, :d + 2]) <= TOL_JAX
