"""The grouped JointHMC warm start's plain models on the CPU.

On the card the warm start (``ops/sgpmc_warm.py`` ``sgpmc_warm_chunk``,
counterpart of ``ggp_tpu/ops/fused_sgpmc.py`` ``_warm_chunk_body``) runs
kernel 6g, ``sgpmc_warm_group_kernel`` (``csrc/sgpmc_warm.cu``): each Adam
step one evaluation of the grouped sgpmc core with dU/dZ. Its plain models
are held here: the grouped evaluation's dU/dZ
(``vfe_group.sgpmc_group_neg_logpost_vg(want_z_grad=True)``) against the
port's plain potential and the JAX package's resident core
(``fused_bound._sgpmc_neg_logpost_vg``); the grouped chunk
(``sgpmc_warm_group_chunk_plain``) against the plain chunk and the JAX
package's ``SGPMC.warm_start``; and the wrapper's routing of tensors that
are not on the CPU, on the ``meta`` device with the launch stubbed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ggp_tpu.models import SGPMC as JaxSGPMC
from ggp_tpu.ops.fused_bound import _sgpmc_neg_logpost_vg
from ggp_tpu_torch import SGPMC
from ggp_tpu_torch.experiments import regression
from ggp_tpu_torch.ops import _build, sgpmc_warm
from ggp_tpu_torch.ops.sgpmc_bound import sgpmc_neg_logpost_vg
from ggp_tpu_torch.ops.sgpmc_warm import (sgpmc_warm_chunk, sgpmc_warm_chunk_plain,
                                          sgpmc_warm_group_chunk_plain)
from ggp_tpu_torch.ops.sgpr_adam import PIVOT_FLOOR
from ggp_tpu_torch.ops.vfe_group import sgpmc_group_neg_logpost_vg

F64 = torch.float64
N, D, M, JITTER = 300, 4, 16, 1e-6
DIM = D + 2 + M
# The grouped model sums the plain potential's terms in another order (row
# blocks, double partials): ~1e-15 relative in float64 on this
# well-conditioned problem; a wrong term, sign or index of dU/dZ moves it by
# 1e-3 or more.
TOL64 = 1e-12
WARM = dict(want_z_grad=True, want_prior=False, pivot_floor=PIVOT_FLOOR)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _problem(seed=0, n=N):
    """X (n, d), y (n,), Z (m, d) near data rows, and a state row [log_ls
    (d), log_os, log_noise, v (m)] away from SGPMC's initial state."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, D))
    y = np.sin(X @ r.normal(size=D)) + 0.2 * r.normal(size=n)
    Z = X[np.linspace(0, n - 1, M).astype(int)] + 0.05 * r.normal(size=(M, D))
    st = np.r_[0.2 * r.normal(size=D), 0.3, -1.5, 0.5 * r.normal(size=M)]
    return X, y, Z, st


@pytest.mark.parametrize("G", [1, 3, 7])
def test_group_model_z_gradient_matches_the_plain_potential(G):
    """With ``want_z_grad`` and the warm start's options the grouped model's
    U, dU/dstate and dU/dZ equal ``sgpmc_neg_logpost_vg``'s to TOL64."""
    X, y, Z, st = _problem()
    t = [torch.tensor(a) for a in (st, X, y, Z)]
    got = sgpmc_group_neg_logpost_vg(*t, JITTER, G, **WARM)
    ref = sgpmc_neg_logpost_vg(*t, JITTER, **WARM)
    assert len(got) == len(ref) == 3 and got[2].shape == (M, D)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= TOL64


@pytest.mark.parametrize("G", [1, 7])
def test_group_model_z_gradient_matches_the_jax_resident_core(G):
    """dU/dZ against ``fused_bound._sgpmc_neg_logpost_vg(want_z_grad=True)``
    (the core of the JAX package's fused warm start; padded layout, no
    hyperprior, the trainers' pivot floor)."""
    X, y, Z, st = _problem(seed=1)
    Np = -(-N // 128) * 128
    Xp = np.zeros((Np, 128)); Xp[:N, :D] = X
    yr = np.zeros((1, Np)); yr[0, :N] = y
    Zp = np.zeros((128, 128)); Zp[:M, :D] = Z
    sp = np.zeros((1, 128)); sp[0, :DIM] = st
    U_j, g_j, gZ_j = _sgpmc_neg_logpost_vg(*(jnp.asarray(a) for a in (sp, Xp, yr, Zp)), N, M,
                                           D, JITTER, **WARM)
    U, g, gZ = sgpmc_group_neg_logpost_vg(*(torch.tensor(a) for a in (st, X, y, Z)), JITTER, G,
                                          **WARM)
    assert _rel(U, float(U_j)) <= TOL64
    assert _rel(g, np.asarray(g_j)[0, :DIM]) <= TOL64
    assert _rel(gZ, np.asarray(gZ_j)[:M, :D]) <= TOL64


@pytest.mark.parametrize("G", [1, 4, 9])
def test_group_warm_chunk_matches_the_plain_chunk(G):
    """25 Adam steps from a state away from the path's start: the grouped
    chunk's state, Z, moments and losses equal the plain chunk's to TOL64
    (the same function; only the order of the sums differs)."""
    X, y, Z, st = _problem(seed=2)
    X, y, Z, st = (torch.tensor(a) for a in (X, y, Z, st))
    zs, zz = torch.zeros_like(st), torch.zeros_like(Z)
    kw = dict(t0=3, num_steps=25, lr=0.01)
    got = sgpmc_warm_group_chunk_plain(st, Z, zs, zs, zz, zz, X, y, JITTER, G, **kw)
    ref = sgpmc_warm_chunk_plain(st, Z, zs, zs, zz, zz, X, y, JITTER, **kw)
    assert len(got) == len(ref) == 7 and got[6].shape == (25,)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= TOL64


def test_group_warm_chunk_matches_jax_warm_start():
    """100 steps of the grouped chunk at G = 5 from SGPMC's initial state at
    synthetic-small (M=16, the driver's Z_init): the losses equal the JAX
    package's ``SGPMC.warm_start`` (XLA autodiff, optax) to 1e-9, and so do
    the state and Z it ends at."""
    data, Zi = regression.run_data("synthetic-small", 0, M=16)
    X, y = data.X_train.astype(np.float64), data.Y_train.astype(np.float64)
    model = SGPMC(X, y, Z_init=Zi, dtype=F64, device="cpu")
    zs, zz = torch.zeros_like(model.flat), torch.zeros_like(model.Z)
    st, Z, *_, losses = sgpmc_warm_group_chunk_plain(
        model.flat, model.Z, zs, zs, zz, zz, model.train_x, model.train_y, model.jitter, 5,
        t0=0, num_steps=100, lr=0.01)
    jm = JaxSGPMC(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Zi))
    losses_j = jm.warm_start(num_steps=100)
    assert _rel(losses, losses_j) <= 1e-9
    assert _rel(Z, np.asarray(jm.Z)) <= 1e-9
    assert _rel(st, np.asarray(ravel_pytree(jm.state)[0])) <= 1e-9


@pytest.mark.parametrize("n", [404, 13279])
def test_warm_wrapper_sends_device_tensors_to_the_grouped_kernel(n, monkeypatch):
    """A tensor that is not on the CPU goes to kernel 6, the grouped warm
    start, at every n (its geometry from the card), and the launch counts
    under ``sgpmc_warm_group`` (launch stubbed on the ``meta`` device); on
    the CPU the wrapper runs the plain chunk and launches nothing."""
    calls = []
    monkeypatch.setattr(sgpmc_warm, "call_sgpmc_warm",
                        lambda *a, **kw: calls.append((a[6].shape[0], kw.get("group"))) or a[:6])
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    meta = dict(device="meta", dtype=F64)
    d, m = 3, 4
    st, Z = torch.zeros(d + 2 + m, **meta), torch.zeros((m, d), **meta)
    X, y = torch.zeros((n, d), **meta), torch.zeros(n, **meta)
    kw = dict(t0=0, num_steps=2, lr=0.01)
    before = dict(_build.LAUNCHES)
    sgpmc_warm_chunk(st, Z, st, st, Z, Z, X, y, JITTER, **kw)
    grew = {k for k in _build.LAUNCHES if _build.LAUNCHES[k] != before[k]}
    assert calls == [(n, None)] and grew == {"sgpmc_warm_group"}
    assert _build.LAUNCHES["sgpmc_warm_group"] == before["sgpmc_warm_group"] + 1
    Xc, yc, Zc, stc = (torch.tensor(a) for a in _problem(seed=3, n=40))
    zs, zz = torch.zeros_like(stc), torch.zeros_like(Zc)
    before = dict(_build.LAUNCHES)
    out = sgpmc_warm_chunk(stc, Zc, zs, zs, zz, zz, Xc, yc, JITTER, **kw)
    ref = sgpmc_warm_chunk_plain(stc, Zc, zs, zs, zz, zz, Xc, yc, JITTER, **kw)
    assert _build.LAUNCHES == before and all(torch.equal(u, v) for u, v in zip(out, ref))
