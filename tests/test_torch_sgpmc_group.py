"""The grouped sgpmc core's host side and summation order, and the JointHMC
driver, on the CPU.

``ops/vfe_group.py`` routes the sgpmc core to its grouped kernels
(``csrc/sgpmc_group.cuh``, ``SgpmcGroupCore``) at every n (the rule and the
scratch: ``tests/test_torch_group.py``; the group's size at small n here) and
holds a plain model of the kernel's order of summation (``sgpmc_group_neg_logpost_vg``: row-block
partials in float64 summed p = 0 .. G-1, then the M x M epilogue). The
model is held against the port's plain potential, against the JAX
package's resident core (``fused_bound._sgpmc_neg_logpost_vg``), its
streamed cores (``_sgpmc_neg_logpost_vg_streaming`` and
``fused_multichain._sgpmc_batched_vg_streaming``, which the grouped kernels
replace) and ``jax.value_and_grad`` of ``SGPMC._logpost``, at n=300, d=4,
m=16 (state dim 22). Every sampler wrapper's routing of both cores is
checked on the ``meta`` device (not the CPU) with the launches stubbed. The regression driver's
JointHMC branch runs on the CPU at synthetic-small, its warm start held to
the JAX package's; and the warm start's float64 sensitivity at the path's
start, on a cut of synthetic-large, is shown in both packages.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ggp_tpu.models import SGPMC as JaxSGPMC
from ggp_tpu.ops.fused_bound import (_default_chol_inv, _sgpmc_neg_logpost_vg,
                                     _sgpmc_neg_logpost_vg_streaming)
from ggp_tpu.ops.fused_multichain import _sgpmc_batched_vg_streaming
from ggp_tpu_torch import SGPMC
from ggp_tpu_torch.experiments import regression
from ggp_tpu_torch.ops import _build, multichain, nuts_chunk, vfe_bound, vfe_group
from ggp_tpu_torch.ops.nuts_chunk import ChainState
from ggp_tpu_torch.ops.sgpmc_bound import sgpmc_neg_logpost_vg
from ggp_tpu_torch.ops.sgpmc_warm import CLIP_NORM
from ggp_tpu_torch.ops.sgpr_adam import PIVOT_FLOOR
from ggp_tpu_torch.ops.vfe_group import sgpmc_group_neg_logpost_vg
from ggp_tpu_torch.utils.datasets import get_regression_data

F32, F64 = torch.float32, torch.float64
N, D, M, JITTER = 300, 4, 16, 1e-6
DIM = D + 2 + M
# The model sums the plain potential's terms in another order (row blocks,
# double partials): ~1e-15 relative in float64 on this well-conditioned
# problem, ~1e-13 against the JAX cores' blocked factorisation; in float32
# ~3e-7 against the plain version (the partials in double). A wrong term,
# mask or index moves a result by 1e-3 or more.
TOL64 = 1e-12
TOL32 = 1e-5
GS = [1, 2, 5, 13]
D_LARGE = 18                    # synthetic-large's width


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _problem(seed=0, n=N):
    """X (n, d), y (n,), Z (m, d) near data rows, and two state rows
    [log_ls (d), log_os, log_noise, v (m)]."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, D))
    y = np.sin(X @ r.normal(size=D)) + 0.2 * r.normal(size=n)
    Z = X[np.linspace(0, n - 1, M).astype(int)] + 0.05 * r.normal(size=(M, D))
    sts = np.c_[0.2 * r.normal(size=(2, D)), 0.3 + 0.1 * r.normal(size=2),
                -1.5 + 0.1 * r.normal(size=2), 0.5 * r.normal(size=(2, M))]
    return X, y, Z, sts


def _padded(st, X, y, Z):
    """The JAX resident core's lane-padded layout."""
    Np = -(-N // 128) * 128
    Xp = np.zeros((Np, 128)); Xp[:N, :D] = X
    yr = np.zeros((1, Np)); yr[0, :N] = y
    Zp = np.zeros((128, 128)); Zp[:M, :D] = Z
    sp = np.zeros((1, 128)); sp[0, :DIM] = st
    return [jnp.asarray(a) for a in (sp, Xp, yr, Zp)]


def _streamed_blocks(X, y, nb=64):
    """The JAX streamed cores' packed slab (X in lanes [0, d), y in lane
    127) and their row-block iterator."""
    Np = -(-N // nb) * nb
    slab = jnp.zeros((Np, 128), jnp.float64).at[:N, :D].set(X).at[:N, 127].set(y)

    def loop_blocks(body, carry):
        for t in range(Np // nb):
            carry = body(jnp.asarray(t, jnp.int32), slab[t * nb:(t + 1) * nb], carry)
        return carry
    return loop_blocks, nb


# -- the plain model of the kernel's summation order --------------------------------

@pytest.mark.parametrize("opts", [dict(), dict(want_prior=False, pivot_floor=1e-6)])
@pytest.mark.parametrize("dt", [F64, F32])
@pytest.mark.parametrize("G", GS)
def test_group_model_matches_the_plain_potential(G, dt, opts):
    """Row-block partials summed p = 0 .. G-1, then the M x M epilogue: U
    and dU/dstate equal ``sgpmc_neg_logpost_vg`` to TOL64 in float64, TOL32
    in float32."""
    X, y, Z, sts = _problem()
    args = [torch.tensor(a, dtype=dt) for a in (sts[0], X, y, Z)]
    got = sgpmc_group_neg_logpost_vg(*args, JITTER, G, **opts)
    ref = sgpmc_neg_logpost_vg(*args, JITTER, **opts)
    assert len(got) == len(ref) == 2 and got[1].shape == (DIM,)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= (TOL64 if dt == F64 else TOL32)


@pytest.mark.parametrize("G", GS)
def test_group_model_matches_the_jax_resident_core(G):
    """Against ``_sgpmc_neg_logpost_vg`` (padded layout, the prior on)."""
    X, y, Z, sts = _problem(seed=1)
    U_j, g_j = _sgpmc_neg_logpost_vg(*_padded(sts[0], X, y, Z), N, M, D, JITTER)
    U, g = sgpmc_group_neg_logpost_vg(*(torch.tensor(a) for a in (sts[0], X, y, Z)), JITTER, G)
    assert _rel(U, float(U_j)) <= TOL64
    assert _rel(g, np.asarray(g_j)[0, :DIM]) <= TOL64


@pytest.mark.parametrize("G", GS)
def test_group_model_matches_jax_grad_of_logpost(G):
    """Against ``jax.value_and_grad`` of -SGPMC._logpost over the flat
    ravel_pytree row (the JAX model's own target)."""
    X, y, Z, sts = _problem(seed=2)
    model = JaxSGPMC(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z))
    _, unravel = ravel_pytree(model.state)
    data = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(Z))
    U_j, g_j = jax.jit(jax.value_and_grad(lambda z: -model._logpost(unravel(z), data)))(
        jnp.asarray(sts[0]))
    U, g = sgpmc_group_neg_logpost_vg(*(torch.tensor(a) for a in (sts[0], X, y, Z)),
                                      model.jitter, G)
    assert _rel(U, float(U_j)) <= TOL64 and _rel(g, g_j) <= TOL64


def test_group_model_matches_the_jax_streamed_cores():
    """One chain against ``_sgpmc_neg_logpost_vg_streaming`` and two against
    ``_sgpmc_batched_vg_streaming`` (row blocks of 64, the cap's max |X| as
    ``data_scale``): the cores the grouped kernels replace, at G = 13."""
    X, y, Z, sts = _problem(seed=3)
    loop_blocks, nb = _streamed_blocks(X, y)
    Zp = jnp.zeros((128, 128), jnp.float64).at[:M, :D].set(Z)
    rows = jnp.zeros((2, 128), jnp.float64).at[:, :DIM].set(sts)
    scale = float(np.abs(X).max())
    U1, g1 = _sgpmc_neg_logpost_vg_streaming(rows[:1], Zp, N, M, D, JITTER, _default_chol_inv,
                                             loop_blocks, nb, data_scale=scale)
    U2, g2 = _sgpmc_batched_vg_streaming(rows, Zp, N, M, D, JITTER, 2,
                                         lambda Ks: [_default_chol_inv(K) for K in Ks],
                                         loop_blocks, nb, data_scale=scale)
    for c in range(2):
        U, g = sgpmc_group_neg_logpost_vg(*(torch.tensor(a) for a in (sts[c], X, y, Z)),
                                          JITTER, 13)
        assert _rel(U, np.asarray(U2).reshape(-1)[c]) <= TOL64
        assert _rel(g, np.asarray(g2)[c, :DIM]) <= TOL64
        if c == 0:
            assert _rel(U, float(np.asarray(U1).reshape(-1)[0])) <= TOL64
            assert _rel(g, np.asarray(g1)[0, :DIM]) <= TOL64


@pytest.mark.parametrize("G", [1, 5, 13])
def test_group_model_where_the_variance_clamp_binds(G):
    """Data rows on the inducing rows at a tiny jitter: their conditional
    variance sf2 - ||A_i||^2 falls below the 1e-12 clamp (mask 0, the
    clamp's zero adjoint), on some rows and not others; the model still
    equals the plain potential and the JAX resident core."""
    X, y, Z, sts = _problem(seed=4)
    X[:M] = Z                                  # rows 0 .. m-1 on the inducing rows
    jitter = 1e-14
    st = sts[0].copy()
    st[:D] = 1.0                               # long lengthscales: a smooth, exact Kmm
    t = [torch.tensor(a) for a in (st, X, y, Z)]
    sf2 = np.exp(st[D])
    Kmm = np.exp(-0.5 * ((Z[:, None] - Z[None]) ** 2 / np.exp(2 * st[:D])).sum(-1)) * sf2
    Kms = np.exp(-0.5 * ((Z[:, None] - X[None]) ** 2 / np.exp(2 * st[:D])).sum(-1)) * sf2
    L = np.linalg.cholesky(Kmm + jitter * max(sf2, 1.0) * np.eye(M))
    A = np.linalg.solve(L, Kms)
    var_raw = sf2 - (A * A).sum(0)
    clamped = var_raw <= 1e-12
    assert 0 < clamped.sum() < N and clamped[:M].all()
    got = sgpmc_group_neg_logpost_vg(*t, jitter, G)
    ref = sgpmc_neg_logpost_vg(*t, jitter)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= TOL64
    U_j, g_j = _sgpmc_neg_logpost_vg(*_padded(st, X, y, Z), N, M, D, jitter)
    assert _rel(got[0], float(U_j)) <= 1e-10 and _rel(got[1], np.asarray(g_j)[0, :DIM]) <= 1e-10


# -- the wrappers' routing -------------------------------------------------------------

def _meta_state(C, dim):
    z = torch.zeros((C, dim), device="meta", dtype=F64)
    c = torch.zeros(C, device="meta", dtype=F64)
    return ChainState(z=z, U=c, g=z, inv_mass=z, log_eps=c, log_eps_avg=c, h_avg=c, mu=c,
                      t_da=c, wf_mean=z, wf_m2=z, wf_count=c)


@pytest.mark.parametrize("core", ["sgpmc", "vfe"])
@pytest.mark.parametrize("n", [1024, 1025, 2048, 2049])
def test_wrappers_route_both_cores_at_both_thresholds(core, n, monkeypatch):
    """Every sampler wrapper (potential, NUTS and HMC chunks; one chain and
    C=2) sends a tensor that is not on the CPU to the grouped kernel: the
    vfe core's past its threshold and the one-block kernel at or below it,
    the sgpmc core's at every n; and counts the launch under the kernel it
    ran (stubbed launches on the ``meta`` device)."""
    launched = []

    def fake_chunk(kind, kernel, state, X, y, Z, jitter, slabs, **kw):
        launched.append((kind, kernel, state.z.shape[0]))
        K, C, dim = slabs[0].shape
        return (state, torch.zeros((K, C, dim), device="meta", dtype=F64),
                torch.zeros((K, C, 6), device="meta", dtype=F64))

    def fake_potential(kernel, zs, X, y, Z, jitter, **kw):
        launched.append(("potential", kernel, zs.shape[0]))
        return torch.zeros(zs.shape[0], device="meta", dtype=F64), torch.zeros_like(zs)

    monkeypatch.setattr(_build, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(multichain, "launch_chunk", fake_chunk)
    monkeypatch.setattr(nuts_chunk, "launch_chunk", fake_chunk)
    monkeypatch.setattr(multichain, "call_potential", fake_potential)
    monkeypatch.setattr(vfe_bound, "call_potential", fake_potential)
    m = 8
    dim = D + 2 + (m if core == "sgpmc" else 0)
    X = torch.zeros((n, D), device="meta", dtype=F64)
    y = torch.zeros(n, device="meta", dtype=F64)
    Z = torch.zeros((m, D), device="meta", dtype=F64)
    K, md = 3, 4
    slab = dict(dtype=F64, device="meta")
    st2, st1 = _meta_state(2, dim), nuts_chunk.first_chain(_meta_state(1, dim))
    kw = dict(n_active=K, adapt=False, eps=torch.ones(2, **slab), core=core)
    before = dict(_build.LAUNCHES)
    vfe_bound.vfe_potential(st1.z, X, y, Z, JITTER, core=core)
    multichain.mc_potential(st2.z, X, y, Z, JITTER, core=core)
    nuts_chunk.nuts_chunk(st1, X, y, Z, JITTER, mom=torch.zeros((K, dim), **slab),
                          treeu=torch.zeros((K, md, 2), **slab),
                          leafu=torch.zeros((K, 1 << md), **slab), max_depth=md,
                          **dict(kw, eps=torch.ones((), **slab)))
    multichain.mc_nuts_chunk(st2, X, y, Z, JITTER, mom=torch.zeros((K, 2, dim), **slab),
                             treeu=torch.zeros((K, 2, md, 2), **slab),
                             leafu=torch.zeros((K, 2, 1 << md), **slab), max_depth=md, **kw)
    multichain.hmc_chunk(st1, X, y, Z, JITTER, mom=torch.zeros((K, dim), **slab),
                         mh=torch.zeros(K, **slab), **dict(kw, eps=torch.ones((), **slab)))
    multichain.mc_hmc_chunk(st2, X, y, Z, JITTER, mom=torch.zeros((K, 2, dim), **slab),
                            mh=torch.zeros((K, 2), **slab), **kw)
    one = f"{core}_group" if n > 2048 or core == "sgpmc" else core
    two = f"{core}_group" if n > 1024 or core == "sgpmc" else core
    assert launched == [("potential", one, 1), ("potential", two, 2), ("nuts_chunk", one, 1),
                        ("nuts_chunk", two, 2), ("hmc_chunk", one, 1), ("hmc_chunk", two, 2)]
    grew = {k for k in _build.LAUNCHES if _build.LAUNCHES[k] != before[k]}
    assert grew == {_build.launch_key(one, k) for k in ("potential", "nuts_chunk", "hmc_chunk")} \
        | {_build.launch_key(two, k) for k in ("mc_potential", "mc_nuts_chunk", "mc_hmc_chunk")}


def test_grouped_sgpmc_core_has_no_z_gradient(monkeypatch):
    """The grouped sgpmc core's sampler launches (the NUTS and HMC chunks)
    ask for no dU/dZ (cfg WANT_ZGRAD 0, no dZ buffer), as the JAX package's
    sampler cores form none; the potential kernel forms it on request, the
    warm start's options (WANT_ZGRAD 1 and a (C, m, d) buffer, three
    outputs). Launches stubbed on the ``meta`` device."""
    seen = []

    def fake_kernel(name, dt):
        def run(cfg, *ptrs):
            arr = ctypes.cast(cfg, ctypes.POINTER(ctypes.c_double))
            seen.append((name, arr[_build.CFG["WANT_ZGRAD"]], len(ptrs)))
            return 0
        return run

    monkeypatch.setattr(_build, "kernel_fn", fake_kernel)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(vfe_group, "launch_work",
                        lambda *a, **kw: (torch.zeros(0, device="meta"), {"GROUP": 3}))
    meta = dict(device="meta", dtype=F64)
    n, C, K, md = 404, 2, 2, 3
    X, y, Z = torch.zeros((n, D), **meta), torch.zeros(n, **meta), torch.zeros((M, D), **meta)
    st = _meta_state(C, DIM)
    kw = dict(n_active=K, adapt=True, eps=None, in_window=None, window_end=None,
              prior_spec=None, stream=None)
    nuts_chunk.launch_chunk("nuts_chunk", "sgpmc_group", st, X, y, Z, JITTER,
                            (torch.zeros((K, C, DIM), **meta), torch.zeros((K, C, md, 2), **meta),
                             torch.zeros((K, C, 1 << md), **meta)), MAX_DEPTH=md, **kw)
    nuts_chunk.launch_chunk("hmc_chunk", "sgpmc_group", st, X, y, Z, JITTER,
                            (torch.zeros((K, C, DIM), **meta), torch.zeros((K, C), **meta)),
                            LEAPFROG=2, **kw)
    out = vfe_bound.call_potential("sgpmc_group", st.z, X, y, Z, JITTER, want_z_grad=True,
                                   want_prior=False, pivot_floor=PIVOT_FLOOR)
    assert [(s[0], s[1]) for s in seen] == [("ggp_nuts_chunk_sgpmc_group", 0.0),
                                            ("ggp_hmc_chunk_sgpmc_group", 0.0),
                                            ("ggp_potential_sgpmc_group", 1.0)]
    assert len(out) == 3 and out[2].shape == (C, M, D)


@pytest.mark.parametrize("n,bps,want", [(404, 2, 264), (13279, 1, 132), (100, 2, 100), (1, 1, 1)])
def test_sgpmc_group_size_at_small_n(n, bps, want, monkeypatch):
    """The grouped sgpmc core takes the blocks the card holds (132 SMs of
    ``bps``), but no more than its n rows, so that no block is left without
    rows; the vfe group's G is not cut."""
    monkeypatch.setattr(vfe_group, "blocks_per_sm", lambda kind, dt, core: bps)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("P", (), {"multi_processor_count": 132})())
    assert vfe_group.geometry("nuts_chunk", F64, 1, "meta", core="sgpmc_group", n=n) == want
    assert vfe_group.geometry("nuts_chunk", F64, 1, "meta", core="vfe_group", n=n) == 132 * bps
    assert vfe_group.geometry("nuts_chunk", F64, 1, "meta", core="sgpmc_group") == 132 * bps


# -- the regression driver's JointHMC branch ---------------------------------------------

def test_driver_jointhmc_warm_start_matches_jax(monkeypatch, tmp_path):
    """``single_run("synthetic-small", 0, "JointHMC", device="cpu")`` in
    float64 at M=16 and a tiny cut: one chain (the JAX driver passes no
    num_chains to train_sgp_hmc), the warm start's 100 losses equal the JAX
    package's ``SGPMC.warm_start`` from the same Z_init to 1e-9, and the
    RMSE and NLPD are finite."""
    monkeypatch.chdir(tmp_path)
    rec = {}
    orig_warm, orig_train = SGPMC.warm_start, SGPMC.train_model

    def warm(self, *a, **kw):
        rec["losses"] = orig_warm(self, *a, **kw)
        return rec["losses"]

    def train(self, *a, **kw):
        rec["chains"] = kw.get("num_chains", 1)
        return orig_train(self, *a, **kw)

    monkeypatch.setattr(SGPMC, "warm_start", warm)
    monkeypatch.setattr(SGPMC, "train_model", train)
    before = dict(_build.LAUNCHES)
    out = regression.single_run("synthetic-small", 0, "JointHMC", M=16, tune=4, num_samples=3,
                                dtype=F64, device="cpu", verbose=False)
    assert _build.LAUNCHES == before and rec["chains"] == 1
    assert np.isfinite(out["test_rmse"]) and np.isfinite(out["test_nlpd"])
    data, Zi = regression.run_data("synthetic-small", 0, M=16)
    jm = JaxSGPMC(jnp.asarray(data.X_train), jnp.asarray(data.Y_train), Z_init=jnp.asarray(Zi))
    losses_j = jm.warm_start(num_steps=100)
    assert rec["losses"].shape == (100,)
    assert _rel(rec["losses"], losses_j) <= 1e-9


def test_warm_start_amplifies_roundoff_at_the_path_start():
    """The JointHMC warm start in float64 on the first 300 rows of
    synthetic-large (D=18) with 16 Z rows drawn from them (the driver's
    RandomState(45) rule), from SGPMC's initial state. There the clipped
    gradient of many Z coordinates lies below Adam's eps (1e-8), where a
    step multiplies the gradient's absolute error by lr x clip scale / eps
    (> 1e4 here), and the next gradient carries the moved Z. So the port's
    plain warm start and the JAX package's (XLA autodiff, optax) agree to
    ~1e-11 after one step and part by ~1e-8 after five, while five steps
    from the state 100 steps on agree to ~1e-15. This is why the warm-start
    kernel is held to its plain version one step at a time from the path's
    start, and over a chunk only away from it (chip_smoke.py)."""
    n, m, steps = 300, 16, 5
    data = get_regression_data("synthetic-large", 0, 0.8)
    X, y = data.X_train[:n].astype(np.float64), data.Y_train[:n].astype(np.float64)
    Zi = X[np.random.RandomState(45).randint(0, n, m)]

    def port(Z, steps, flat=None):
        mod = SGPMC(X, y, Z_init=Z, dtype=F64, device="cpu")
        if flat is not None:
            mod.flat = torch.tensor(flat)
        mod.warm_start(num_steps=steps)
        return np.concatenate([mod.flat.numpy(), mod.Z.numpy().ravel()])

    def jax_run(Z, steps, flat=None):
        jm = JaxSGPMC(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z))
        if flat is not None:
            jm.state = ravel_pytree(jm.state)[1](jnp.asarray(flat))
        jm.warm_start(num_steps=steps)
        return np.concatenate([np.asarray(ravel_pytree(jm.state)[0]), np.asarray(jm.Z).ravel()])

    start = SGPMC(X, y, Z_init=Zi, dtype=F64, device="cpu")
    _, gs, gZ = sgpmc_neg_logpost_vg(start.flat, start.train_x, start.train_y, start.Z,
                                     start.jitter, want_z_grad=True, want_prior=False,
                                     pivot_floor=PIVOT_FLOOR)
    sc = min(1.0, CLIP_NORM / float(torch.sqrt((gs * gs).sum() + (gZ * gZ).sum())))
    assert int((sc * gZ.abs() < 1e-8).sum()) > 0 and 0.01 * sc / 1e-8 > 1e4
    one = _rel(port(Zi, 1), jax_run(Zi, 1))
    five = _rel(port(Zi, steps), jax_run(Zi, steps))
    assert one <= 1e-9 and 1e-9 < five <= 1e-6 and five >= 100 * one, (one, five)
    later = jax_run(Zi, 100)
    flat, Z100 = later[:D_LARGE + 2 + m], later[D_LARGE + 2 + m:].reshape(m, D_LARGE)
    assert _rel(port(Z100, steps, flat), jax_run(Z100, steps, flat)) <= 1e-12
