"""The streamed Z chunk, the streamed cores' pass structure and the regression
driver of the port against the JAX package, on the CPU in float64.

``z_adam_stream_plain`` (the plain version of kernel 12, site 8's function)
against ``bayesian_sgpr_hmc._adam_Z`` and against the resident
``z_adam_chunk_plain``; the port's streamed evaluation ``stream_neg_elbo_vg``
against ``fused_bound._rbf_vfe_neg_logpost_vg_streaming`` driven by a host
``loop_blocks``; ``_rbf_vfe_batched_vg_streaming`` and
``_sgpmc_neg_logpost_vg_streaming`` against the port's plain potentials; the
driver ``experiments/regression.py`` ``single_run`` on synthetic-small; the
summary table; the grouped warm-start trainer's plain model
(``sgpr_adam_group_plain``, kernel 3g's order) against the one-block
trainer's plain version and its routing at 2048 / 2049 rows. The
interpret-mode streamed Pallas chunks are ``slow``.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggp_tpu.inference.diagnostics import summary as jax_summary
from ggp_tpu.inference.diagnostics import trace_to_named_dict as jax_named
from ggp_tpu.kernels import default_rbf as jax_default_rbf
from ggp_tpu.models.bayesian_sgpr_hmc import _adam_Z
from ggp_tpu.ops.fused_bound import (_default_chol_inv, _rbf_vfe_neg_logpost_vg_streaming,
                                     _sgpmc_neg_logpost_vg_streaming)
from ggp_tpu.ops.fused_multichain import _rbf_vfe_batched_vg_streaming
from ggp_tpu.utils.datasets import get_regression_data as jax_regression_data
from ggp_tpu_torch.experiments import regression as reg
from ggp_tpu_torch.inference.diagnostics import summary, summary_to_csv, trace_to_named_dict
from ggp_tpu_torch.ops import _build, sgpr_adam
from ggp_tpu_torch.ops.multichain import mc_potential_plain
from ggp_tpu_torch.ops.sgpmc_bound import sgpmc_neg_logpost_vg
from ggp_tpu_torch.ops.sgpr_adam import (sgpr_adam_chunk, sgpr_adam_chunk_plain,
                                         sgpr_adam_group_plain, stream_neg_elbo_vg,
                                         trainer_route, z_adam_chunk, z_adam_chunk_plain,
                                         z_adam_stream_plain)
from ggp_tpu_torch.utils import experiment_tools
from ggp_tpu_torch.utils.datasets import DataNotInRepository

JITTER, LR = 1e-8, 0.05
N, M, D, S, NB = 200, 8, 3, 3, 64
# The two passes against the resident algebra: the same sums split over row
# blocks (~1e-15 in f64). Adam steps carry gradient differences into the
# step sizes of components near zero gradient: 1e-7 over a few steps
# against the autodiff reference (tests/test_torch_sgpr_adam.py), 1e-12
# against the port's resident twin (the same hand adjoint).
TOL_CORE = 1e-10
RTOL_ADAM = 1e-7
TOL_TWIN = 1e-12
# The grouped trainer's model against the one-block trainer's plain version:
# the same function summed over row blocks and slices (~1e-15 per
# evaluation), carried through 20 Adam steps.
TOL_ADAM_GROUP = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _problem(seed=0, n=N, m=M, d=D):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d))
    y = np.sin(X @ r.normal(size=d)) + 0.2 * r.normal(size=n)
    Z = X[np.linspace(0, n - 1, m).astype(int)] + 0.05 * r.normal(size=(m, d))
    thetas = np.c_[0.2 * r.normal(size=(S, d)), 0.3 + 0.1 * r.normal(size=S),
                   -1.0 + 0.1 * r.normal(size=S)]
    return X, y, Z, thetas


def _slab(X, y, nb=NB):
    """The streamed cores' HBM layout: X in lanes [0, d), y in lane 127, rows
    padded to whole blocks; and the host iterator over its blocks."""
    n, d = X.shape
    Np = -(-n // nb) * nb
    slab = jnp.zeros((Np, 128), jnp.float64).at[:n, :d].set(X).at[:n, 127].set(y)

    def loop_blocks(body, carry):
        for t in range(Np // nb):
            carry = body(jnp.asarray(t, jnp.int32), slab[t * nb:(t + 1) * nb], carry)
        return carry

    return loop_blocks


def _pad_rows(rows, lanes=128):
    rows = np.atleast_2d(rows)
    return jnp.zeros((rows.shape[0], lanes), jnp.float64).at[:, :rows.shape[1]].set(rows)


def _pad_Z(Z):
    """Z on the cores' (128, 128) tile."""
    return jnp.zeros((128, 128), jnp.float64).at[:Z.shape[0], :Z.shape[1]].set(Z)


def _trace_tree(thetas, d):
    return {"kernel": {"base": {"log_lengthscale": jnp.asarray(thetas[:, :d])},
                       "log_outputscale": jnp.asarray(thetas[:, d])},
            "log_noise": jnp.asarray(thetas[:, d + 1])}


# -- the streamed Z chunk ----------------------------------------------------------

def test_z_adam_stream_plain_matches_adam_Z(monkeypatch):
    """z_adam_chunk past a lowered STREAM_MIN_N (row blocks of NB=64) runs
    the streamed plain version on the CPU: losses and Z after 5 steps within
    RTOL_ADAM of the JAX package's ``_adam_Z`` (zero_nans, adam), within
    TOL_TWIN of the resident twin, and no kernel launch."""
    monkeypatch.setattr(sgpr_adam, "STREAM_MIN_N", 100)
    monkeypatch.setattr(sgpr_adam, "STREAM_NB", NB)
    X, y, Z, thetas = _problem()
    opt = optax.chain(optax.zero_nans(), optax.adam(LR))
    Z_j, l_j = _adam_Z(jax_default_rbf(ard=True), jnp.asarray(X), jnp.asarray(y), JITTER,
                       jnp.asarray(Z), _trace_tree(thetas, D), opt, 5)
    Xt, yt, Zt, tt = (torch.tensor(a) for a in (X, y, Z, thetas))
    zz = torch.zeros_like(Zt)
    before = dict(_build.LAUNCHES)
    out = z_adam_chunk(Zt, zz, zz, tt, Xt, yt, JITTER, t0=0, num_steps=5, lr=LR)
    assert _build.LAUNCHES == before
    np.testing.assert_allclose(out[3].numpy(), np.asarray(l_j), rtol=RTOL_ADAM)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(Z_j), rtol=RTOL_ADAM, atol=1e-12)
    twin = z_adam_chunk_plain(Zt, zz, zz, tt, Xt, yt, JITTER, t0=0, num_steps=5, lr=LR)
    for a, b in zip(out, twin):
        assert _rel(a, b) <= TOL_TWIN


def test_z_adam_chunk_routes_by_size():
    """Up to STREAM_MIN_N rows z_adam_chunk runs the resident version, past
    it the streamed one (the JAX package's threshold, n > 2048)."""
    assert sgpr_adam.STREAM_MIN_N == 2048
    X, y, Z, thetas = _problem(seed=1, n=2050, m=4, d=2)
    Xt, yt, Zt = (torch.tensor(a) for a in (X, y, Z))
    tt = torch.tensor(thetas[:2])
    zz = torch.zeros_like(Zt)
    a = z_adam_chunk(Zt, zz, zz, tt, Xt, yt, JITTER, t0=0, num_steps=1, lr=LR)
    b = z_adam_stream_plain(Zt, zz, zz, tt, Xt, yt, JITTER, t0=0, num_steps=1, lr=LR)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# -- the warm start's grouped trainer (kernel 3g) ----------------------------------

@pytest.mark.parametrize("G", [1, 5, 66])
def test_group_trainer_model_matches_the_one_block_trainer(G):
    """20 float64 Adam steps of the grouped trainer's plain model (each
    evaluation over G row blocks, the norm's squares summed per slice of
    dU/dZ and then over slices) against ``sgpr_adam_chunk_plain``: every
    output within TOL_ADAM_GROUP."""
    X, y, Z, _ = _problem(seed=7, n=300, m=12, d=4)
    Xt, yt, Zt = (torch.tensor(a) for a in (X, y, Z))
    th = torch.zeros(6, dtype=torch.float64)
    zt, zz = torch.zeros_like(th), torch.zeros_like(Zt)
    kw = dict(t0=0, num_steps=20, lr=0.02, clip_norm=100.0, min_noise=1e-4)
    a = sgpr_adam_chunk_plain(th, Zt, zt, zt, zz, zz, Xt, yt, 1e-6, **kw)
    b = sgpr_adam_group_plain(th, Zt, zt, zt, zz, zz, Xt, yt, 1e-6, G, **kw)
    for u, v in zip(b, a):
        assert _rel(u, v) <= TOL_ADAM_GROUP


@pytest.mark.parametrize("n,want", [(404, "block"), (2048, "block"), (2049, "group"),
                                    (13279, "group")])
def test_sgpr_adam_chunk_routes_at_2048_rows(n, want, monkeypatch):
    """Off the CPU sgpr_adam_chunk takes kernel 3 (one block) up to 2048
    rows and kernel 3g (the grouped vfe core) past them, the JAX package's
    streaming threshold, and counts the launch under that kernel's name; on
    the CPU it runs the plain version and launches nothing."""
    assert sgpr_adam.GROUP_MIN_N == 2048 and trainer_route(n) == want
    calls = []
    monkeypatch.setattr(sgpr_adam, "call_sgpr_adam",
                        lambda kernel, *a, **kw: calls.append(kernel) or a[:6])
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    meta = dict(device="meta", dtype=torch.float64)
    Z, X, y = torch.zeros((4, 2), **meta), torch.zeros((n, 2), **meta), torch.zeros(n, **meta)
    th = torch.zeros(4, **meta)
    kw = dict(t0=0, num_steps=1, lr=0.01, clip_norm=10.0)
    before = dict(_build.LAUNCHES)
    sgpr_adam_chunk(th, Z, th, th, Z, Z, X, y, JITTER, **kw)
    key = "sgpr_adam_group" if want == "group" else "sgpr_adam_chunk"
    assert calls == [want] and _build.LAUNCHES[key] == before[key] + 1
    Xc, yc, Zc, _ = (torch.tensor(a) for a in _problem(seed=8, n=n, m=4, d=2))
    tc = torch.zeros(4, dtype=torch.float64)
    zz = torch.zeros_like(Zc)
    before = dict(_build.LAUNCHES)
    out = sgpr_adam_chunk(tc, Zc, tc, tc, zz, zz, Xc, yc, JITTER, **kw)
    ref = sgpr_adam_chunk_plain(tc, Zc, tc, tc, zz, zz, Xc, yc, JITTER, **kw)
    assert _build.LAUNCHES == before and all(torch.equal(u, v) for u, v in zip(out, ref))


@pytest.mark.slow
def test_group_trainer_model_matches_interpret_streamed_chunk():
    """The interpret-mode streamed ``make_fused_sgpr`` at n=2304 (past its
    resident cap), float32, 2 steps of (theta, Z) against the grouped
    trainer's plain model at G = 9: losses, theta and Z to 1e-3 (float32
    blocked factorisations against LAPACK)."""
    from ggp_tpu.ops.fused_sgpr import make_fused_sgpr

    n, m, d, K = 2304, 16, 4, 2
    X, y, Z, _ = _problem(seed=9, n=n, m=m, d=d)
    f32 = jnp.float32
    chunk = make_fused_sgpr(n, m, d, 1e-5, steps_per_call=K, lr=LR, min_noise=1e-4,
                            clip_norm=10.0, interpret=True, data_scale=float(np.abs(X).max()))
    tp = jnp.zeros((1, 128), f32)
    Zp = jnp.zeros((128, 128), f32).at[:m, :d].set(Z)
    Xp = jnp.zeros((n, 128), f32).at[:, :d].set(X)
    yp = jnp.asarray(y, f32)[:, None]
    zero = {"theta": jnp.zeros((1, 128), f32), "Z": jnp.zeros((128, 128), f32)}
    th_j, Z_j, _, _, l_j = chunk(tp, Zp, zero, zero, Xp, yp, 0.0)
    Xt, yt, Zt = (torch.tensor(a, dtype=torch.float32) for a in (X, y, Z))
    th = torch.zeros(d + 2)
    zt, zz = torch.zeros_like(th), torch.zeros_like(Zt)
    out = sgpr_adam_group_plain(th, Zt, zt, zt, zz, zz, Xt, yt, 1e-5, 9, t0=0, num_steps=K,
                                lr=LR, clip_norm=10.0, min_noise=1e-4)
    np.testing.assert_allclose(out[6].numpy(), np.asarray(l_j), rtol=1e-3)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(th_j)[0, :d + 2], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(Z_j)[:m, :d], rtol=1e-3, atol=1e-3)


# -- the streamed cores' pass structure ---------------------------------------------

def test_stream_passes_match_jax_streaming_core():
    """stream_neg_elbo_vg (two passes over row blocks of 64, the trainers'
    pivot floor) against ``_rbf_vfe_neg_logpost_vg_streaming`` (host
    loop_blocks, NB=64, want_z_grad, no prior) per trace row: U and dU/dZ
    to TOL_CORE."""
    X, y, Z, thetas = _problem(seed=2)
    loop_blocks = _slab(X, y)
    Zp = _pad_Z(Z)
    U, dZ = stream_neg_elbo_vg(*(torch.tensor(a) for a in (thetas, X, y, Z)), JITTER, nb=NB)
    for s in range(S):
        U_j, _, dZ_j = _rbf_vfe_neg_logpost_vg_streaming(
            _pad_rows(thetas[s]), Zp, N, M, D, JITTER, chol_inv=_default_chol_inv,
            loop_blocks=loop_blocks, NB=NB, want_z_grad=True, want_prior=False,
            pivot_floor=1e-6, data_scale=float(np.abs(X).max()))
        assert _rel(U[s], U_j) <= TOL_CORE
        assert _rel(dZ[s], np.asarray(dZ_j)[:M, :D]) <= TOL_CORE


def test_batched_streaming_core_matches_mc_potential():
    """``_rbf_vfe_batched_vg_streaming`` at C=2 (host loop_blocks, NB=64)
    against the port's plain C-chain potential: U and dU/dtheta (with the
    default priors) to TOL_CORE."""
    X, y, Z, thetas = _problem(seed=3)
    th = thetas[:2]

    def batched_chol(K_list):
        return [_default_chol_inv(K) for K in K_list]

    U_j, g_j = _rbf_vfe_batched_vg_streaming(
        _pad_rows(th), _pad_Z(Z), N, M, D, JITTER, 2, batched_chol, _slab(X, y), NB,
        data_scale=float(np.abs(X).max()))
    U, g = mc_potential_plain(*(torch.tensor(a) for a in (th, X, y, Z)), JITTER)
    assert _rel(U, np.asarray(U_j).reshape(-1)) <= TOL_CORE
    assert _rel(g, np.asarray(g_j)[:, :D + 2]) <= TOL_CORE


def test_sgpmc_streaming_core_matches_plain_potential():
    """``_sgpmc_neg_logpost_vg_streaming`` (host loop_blocks, NB=64) against
    the port's plain whitened JointHMC potential: U and dU/dstate to
    TOL_CORE."""
    X, y, Z, thetas = _problem(seed=4)
    st = np.r_[thetas[0], 0.5 * np.random.default_rng(4).normal(size=M)]
    U_j, g_j = _sgpmc_neg_logpost_vg_streaming(
        _pad_rows(st), _pad_Z(Z), N, M, D, JITTER, chol_inv=_default_chol_inv,
        loop_blocks=_slab(X, y), NB=NB, data_scale=float(np.abs(X).max()))
    U, g = sgpmc_neg_logpost_vg(*(torch.tensor(a) for a in (st, X, y, Z)), JITTER)
    assert _rel(U, U_j) <= TOL_CORE
    assert _rel(g, np.asarray(g_j)[0, :st.shape[0]]) <= TOL_CORE


# -- the regression driver ------------------------------------------------------------

@pytest.mark.parametrize("model", ["BayesianSGPR_HMC_FixedZ", "SGPR"])
def test_single_run_synthetic_small(model, monkeypatch, tmp_path):
    """The port's driver on synthetic-small (split 0, M=8; FixedZ: tune 4,
    draws 4, 2 chains; SGPR: max_iters 8) runs on the CPU with no kernel
    launch, logs its JSON (and the sampler's trace CSV), and reads the JAX
    driver's rows: X_train and Z_init (RandomState(45).randint, with
    replacement) equal. (train_model's rounds are fixed at (100, 20) and
    (25, 10): tests/test_torch_multichain.py runs them on the CPU.)"""
    monkeypatch.setattr(experiment_tools, "LOG_DIR", str(tmp_path))
    data, Z_init = reg.run_data("synthetic-small", 0, M=8)
    j = jax_regression_data("synthetic-small", split=0, prop=0.8)
    assert np.array_equal(data.X_train, j.X_train)
    assert np.array_equal(Z_init, j.X_train[np.random.RandomState(45).randint(
        0, j.X_train.shape[0], 8)])
    before = dict(_build.LAUNCHES)
    out = reg.single_run("synthetic-small", 0, model, M=8, max_iters=8, tune=4,
                         num_samples=4, num_chains=2, verbose=False, device="cpu")
    assert _build.LAUNCHES == before
    assert np.isfinite(out["test_rmse"]) and np.isfinite(out["test_nlpd"])
    assert len(list(tmp_path.rglob("*.json"))) == 1
    sampled = model != "SGPR"
    assert ("trace_summary" in out) == sampled
    assert len(list(tmp_path.rglob("*_trace.csv"))) == int(sampled)
    if sampled:
        assert out["trace_summary"]["log_noise"]["ess"] > 0


def test_driver_raises_on_what_the_port_lacks():
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        reg.single_run("synthetic-small", 0, "AllInHMC", device="cpu")
    with pytest.raises(NotImplementedError, match="not in the repository"):
        reg.single_run("boston", 0, "SGPR", device="cpu")
    assert issubclass(DataNotInRepository, ValueError)


def test_summary_matches_jax(tmp_path):
    """summary and trace_to_named_dict against the JAX functions on one
    numpy trace (2 chains x 50 draws) and divergence flags."""
    r = np.random.default_rng(5)
    trace = {"kernel": {"base": {"log_lengthscale": r.normal(size=(2, 50, 3))},
                        "log_outputscale": r.normal(size=(2, 50))},
             "log_noise": r.normal(size=(2, 50))}
    stats = {"diverging": r.random(size=(2, 50)) < 0.1}
    named = trace_to_named_dict(trace)
    named_j = jax_named(trace)
    assert list(named) == list(named_j)
    assert all(np.array_equal(named[k], named_j[k]) for k in named)
    assert summary(named, stats) == jax_summary(named_j, stats)
    path = summary_to_csv(summary(named, stats), str(tmp_path / "s.csv"))
    assert open(path).read().count("\n") == 1 + 3 + 1 + 1 + 1


@pytest.mark.slow
def test_z_adam_stream_plain_matches_interpret_streamed_chunk():
    """The interpret-mode streamed ``make_fused_z_adam`` at n=2304 (past its
    resident cap: 3 DMA blocks of 1024, the last partial), float32, 2 steps
    against z_adam_stream_plain: losses and Z to 1e-3 (float32 blocked
    factorisations against LAPACK)."""
    from ggp_tpu.ops.fused_sgpr import make_fused_z_adam

    n, m, d, K = 2304, 16, 4, 2
    X, y, Z, _ = _problem(seed=6, n=n, m=m, d=d)
    thetas = np.c_[0.2 * np.random.default_rng(6).normal(size=(2, d)), [[0.3, -1.0]] * 2]
    f32 = jnp.float32
    chunk = make_fused_z_adam(n, m, d, 8, 1e-5, steps_per_call=K, lr=LR, interpret=True,
                              data_scale=float(np.abs(X).max()))
    Zp = jnp.zeros((128, 128), f32).at[:m, :d].set(Z)
    Xp = jnp.zeros((n, 128), f32).at[:, :d].set(X)
    yp = jnp.asarray(y, f32)[:, None]
    mz = jnp.zeros((128, 128), f32)
    Z_j, _, _, l_j = chunk(Zp, mz, mz, _pad_rows(thetas).astype(f32), Xp, yp, 0.0)
    Xt, yt, Zt, tt = (torch.tensor(a, dtype=torch.float32) for a in (X, y, Z, thetas))
    zz = torch.zeros_like(Zt)
    out = z_adam_stream_plain(Zt, zz, zz, tt, Xt, yt, 1e-5, t0=0, num_steps=K, lr=LR)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(l_j), rtol=1e-3)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(Z_j)[:m, :d], rtol=1e-3, atol=1e-3)



def test_port_and_chip_smoke_leave_jax_out():
    """Every module of ggp_tpu_torch, and chip_smoke.py, imports without
    jax or the JAX package."""
    code = ("import sys, importlib, pkgutil, ggp_tpu_torch\n"
            "for m in pkgutil.walk_packages(ggp_tpu_torch.__path__, 'ggp_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ggp_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
