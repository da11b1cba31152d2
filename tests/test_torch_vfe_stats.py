"""The port's VFE statistics (``ggp_tpu_torch.ops.vfe_stats``) and the
collapsed bound from them (``models.sgpr.sgpr_elbo_from_stats``) against the
JAX package, on the CPU.

The plain versions against the JAX ``vfe_stats`` (its XLA branch on the
CPU) in float64, in value and in the gradient of a random linear functional
of all four statistics; against the interpret-mode Pallas kernels
(``pallas_vfe.stationary_vfe_stats``, two row blocks of 128) in float32 for
each stationary family, with Z rows taken from X; the chain dimension and
the in-kernel row gather against per-chain calls; the bound in value and
gradient, with and without the float64 epilogue.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggp_tpu import kernels as jk
from ggp_tpu.models.sgpr import sgpr_elbo_from_stats as j_elbo_from_stats
from ggp_tpu.models.sgpr import vfe_stats as j_vfe_stats
from ggp_tpu.ops.pallas_vfe import stationary_vfe_stats as j_pallas_stats
from ggp_tpu_torch.kernels import RBF, Scale, default_rbf
from ggp_tpu_torch.models.sgpr import sgpr_elbo_from_stats, vfe_stats
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.vfe_stats import (FAMILIES, stationary_vfe_stats, vfe_stats_bwd,
                                         vfe_stats_bwd_plain, vfe_stats_fwd, vfe_stats_fwd_plain)

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of small CPU ops, which
    a thread pool only slows when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
KEYS = ("S_kk", "S_ky", "s_kdiag", "s_yy")
# f64: the same sums in another order (~1e-15 relative); a wrong term moves
# a statistic or a gradient by 1e-3 or more.
TOL64 = 1e-10
# f32 against the interpret-mode Pallas kernel: float32 sums over 256 rows
# in another order (~1e-6 relative).
TOL32 = 1e-4
J_FAM = {"rbf": jk.RBF, "matern12": jk.Matern12, "matern32": jk.Matern32,
         "matern52": jk.Matern52}


def _rel(a, b):
    a = np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach().cpu() if torch.is_tensor(b) else b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _problem(seed=0, n=200, m=12, d=4, ard=True, z_from_x=False):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d))
    y = np.sin(X @ r.normal(size=d)) + 0.1 * r.normal(size=n)
    Z = X[r.choice(n, m, replace=False)] if z_from_x else r.normal(size=(m, d))
    log_ls = 0.3 * r.normal(size=d) if ard else np.float64(0.2)
    return X, y, Z, log_ls, np.float64(0.3)


def _functional(seed, m):
    r = np.random.default_rng(seed)
    return r.normal(size=(m, m)), r.normal(size=m), r.normal(), r.normal()


def _tcoef(coef, dtype=F64):
    return [torch.tensor(np.asarray(a), dtype=dtype) for a in coef]


def _apply(stats, coef, lib):
    A, b, c, e = coef
    return (lib.sum(stats["S_kk"] * A) + lib.sum(stats["S_ky"] * b)
            + stats["s_kdiag"] * c + stats["s_yy"] * e)


@pytest.mark.parametrize("ard", [True, False])
def test_plain_stats_match_jax_xla_f64(ard):
    X, y, Z, log_ls, log_os = _problem(ard=ard)
    coef = _functional(1, Z.shape[0])
    jkern = jk.Scale(jk.RBF(ard=ard))

    def jf(Z_, lls, los):
        kp = {"log_outputscale": los, "base": {"log_lengthscale": lls}}
        return _apply(j_vfe_stats(jkern, kp, Z_, jnp.asarray(X), jnp.asarray(y)),
                      [jnp.asarray(a) for a in coef], jnp)

    jargs = (jnp.asarray(Z), jnp.asarray(log_ls), jnp.asarray(log_os))
    kp = {"log_outputscale": jargs[2], "base": {"log_lengthscale": jargs[1]}}
    jstats = j_vfe_stats(jkern, kp, jargs[0], jnp.asarray(X), jnp.asarray(y))
    jgrads = jax.grad(jf, argnums=(0, 1, 2))(*jargs)

    targs = [torch.tensor(np.asarray(a), dtype=F64, requires_grad=True)
             for a in (Z, log_ls, log_os)]
    tkp = {"log_outputscale": targs[2], "base": {"log_lengthscale": targs[1]}}
    tstats = vfe_stats(Scale(RBF(ard=ard)), tkp, targs[0], torch.tensor(X), torch.tensor(y))
    for k in KEYS:
        assert _rel(tstats[k], jstats[k]) <= TOL64, k
    _apply(tstats, _tcoef(coef), torch).backward()
    for t, j in zip(targs, jgrads):
        assert t.grad.shape == j.shape
        assert _rel(t.grad, j) <= TOL64


@pytest.mark.parametrize("fam", FAMILIES)
def test_plain_stats_match_jax_xla_families_f64(fam):
    """Each family against the JAX package's Scale(<family>) gram. Z rows
    are not taken from X here: at a coincident point the JAX gram's norm
    expansion leaves d2 ~ 1e-16, whose square root the Matern-1/2 kernel
    turns into ~1e-8 of k (the interpret-mode test below holds coincident
    points)."""
    X, y, Z, log_ls, log_os = _problem(seed=2)
    coef = _functional(3, Z.shape[0])
    jkern = jk.Scale(J_FAM[fam](ard=True))

    def jf(Z_, lls, los):
        kp = {"log_outputscale": los, "base": {"log_lengthscale": lls}}
        return _apply(j_vfe_stats(jkern, kp, Z_, jnp.asarray(X), jnp.asarray(y)),
                      [jnp.asarray(a) for a in coef], jnp)

    jargs = (jnp.asarray(Z), jnp.asarray(log_ls), jnp.asarray(log_os))
    jval, jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2))(*jargs)
    targs = [torch.tensor(np.asarray(a), dtype=F64, requires_grad=True)
             for a in (Z, log_ls, log_os)]
    val = _apply(stationary_vfe_stats(torch.tensor(X), torch.tensor(y), *targs, fam=fam),
                 _tcoef(coef), torch)
    val.backward()
    assert _rel(val, jval) <= TOL64
    for t, j in zip(targs, jgrads):
        assert _rel(t.grad, j) <= TOL64, fam


@pytest.mark.parametrize("fam", FAMILIES)
def test_plain_stats_match_pallas_interpret_f32(fam):
    """Value and VJP of a random functional against the interpret-mode
    Pallas kernels (N=256: two blocks of 128), float32, Z rows from X."""
    X, y, Z, log_ls, log_os = _problem(seed=4, n=256, m=16, d=5, z_from_x=True)
    X, y, Z, log_ls = (a.astype(np.float32) for a in (X, y, Z, log_ls))
    log_os = np.float32(log_os)
    coef = [np.asarray(a, np.float32) for a in _functional(5, Z.shape[0])]
    jX, jy = jnp.asarray(X), jnp.asarray(y)

    def jf(Z_, lls, los):
        return _apply(j_pallas_stats(jX, jy, Z_, lls, los, 128, fam, False),
                      [jnp.asarray(a) for a in coef], jnp)

    jargs = (jnp.asarray(Z), jnp.asarray(log_ls), jnp.asarray(log_os))
    jstats = j_pallas_stats(jX, jy, *jargs, 128, fam, False)
    jgrads = jax.grad(jf, argnums=(0, 1, 2))(*jargs)
    targs = [torch.tensor(np.asarray(a), requires_grad=True) for a in (Z, log_ls, log_os)]
    tstats = stationary_vfe_stats(torch.tensor(X), torch.tensor(y), *targs, fam=fam)
    for k in KEYS:
        assert _rel(tstats[k], jstats[k]) <= TOL32, (fam, k)
    _apply(tstats, _tcoef(coef, torch.float32), torch).backward()
    for t, j in zip(targs, jgrads):
        assert _rel(t.grad, j) <= TOL32, fam


def test_bf16_rounds_the_skk_inputs_only():
    """bf16 moves S_kk by bfloat16 rounding (~1e-3) and leaves S_ky exact,
    as the TPU kernel's single-pass option; against the interpret-mode
    kernel with bf16 in float32."""
    X, y, Z, log_ls, log_os = _problem(seed=6, n=256, m=16, d=5)
    X, y, Z, log_ls = (a.astype(np.float32) for a in (X, y, Z, log_ls))
    t = [torch.tensor(a) for a in (X, y, Z, log_ls, np.float32(log_os))]
    exact = stationary_vfe_stats(*t)
    rounded = stationary_vfe_stats(*t, bf16=True)
    assert 1e-5 < _rel(rounded["S_kk"], exact["S_kk"]) < 1e-2
    assert torch.equal(rounded["S_ky"], exact["S_ky"])
    ref = j_pallas_stats(*(jnp.asarray(a) for a in (X, y, Z, log_ls, np.float32(log_os))),
                         128, "rbf", True)
    assert _rel(rounded["S_kk"], ref["S_kk"]) <= TOL32


@pytest.mark.parametrize("scalar_ls", [False, True])
def test_chain_batch_and_gather_equal_per_chain_calls(scalar_ls):
    """C chains in one call equal C one-chain calls, value and gradient; an
    index array equals the gathered rows; a shared Z or idx broadcasts."""
    r = np.random.default_rng(7)
    C, n, m, d, B = 3, 150, 10, 4, 40
    X, y = torch.tensor(r.normal(size=(n, d))), torch.tensor(r.normal(size=n))
    Z = torch.tensor(r.normal(size=(C, m, d)), requires_grad=True)
    lls = torch.tensor(0.2 * r.normal(size=(C,) if scalar_ls else (C, d)), requires_grad=True)
    los = torch.tensor(0.1 * r.normal(size=C), requires_grad=True)
    idx = torch.tensor(r.integers(0, n, size=(C, B)))
    coef = _tcoef(_functional(8, m))
    out = stationary_vfe_stats(X, y, Z, lls, los, idx=idx)
    sum(_apply({k: v[c] for k, v in out.items()}, coef, torch) for c in range(C)).backward()
    for c in range(C):
        z1, l1, o1 = (a.detach()[c].clone().requires_grad_(True) for a in (Z, lls, los))
        one = stationary_vfe_stats(X[idx[c]], y[idx[c]], z1, l1, o1)
        for k in KEYS:
            torch.testing.assert_close(out[k][c], one[k], rtol=0, atol=0)
        _apply(one, coef, torch).backward()
        for a, b in ((Z, z1), (lls, l1), (los, o1)):
            torch.testing.assert_close(a.grad[c], b.grad, rtol=1e-13, atol=1e-13)
    shared = stationary_vfe_stats(X, y, Z.detach()[0], lls.detach(), los.detach(),
                                  idx=idx[0])
    for c in range(C):
        one = stationary_vfe_stats(X, y, Z.detach()[0], lls.detach()[c], los.detach()[c],
                                   idx=idx[0])
        for k in KEYS:
            torch.testing.assert_close(shared[k][c], one[k], rtol=0, atol=0)


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """vfe_stats_bwd_plain equals autograd of vfe_stats_fwd_plain in the
    scaled coordinates (dzs, the lengthscale term via inv_ls, dos)."""
    r = np.random.default_rng(9)
    C, n, m, d = 2, 90, 7, 3
    X, y = torch.tensor(r.normal(size=(n, d))), torch.tensor(r.normal(size=n))
    Z = torch.tensor(r.normal(size=(C, m, d)), requires_grad=True)
    inv_ls = torch.tensor(np.exp(0.2 * r.normal(size=(C, d))), requires_grad=True)
    os = torch.tensor(np.exp(0.1 * r.normal(size=C)), requires_grad=True)
    g_kk, g_ky = torch.tensor(r.normal(size=(C, m, m))), torch.tensor(r.normal(size=(C, m)))
    for fam in FAMILIES:
        Zs = Z * inv_ls[:, None, :]
        S_kk, S_ky = vfe_stats_fwd_plain(X, y, Zs, inv_ls, os, None, fam)
        dZ, dil, dos = torch.autograd.grad((S_kk * g_kk).sum() + (S_ky * g_ky).sum(),
                                           (Z, inv_ls, os))
        il = inv_ls.detach()
        dzs, term, dos_k = vfe_stats_bwd_plain(X, y, Zs.detach(), il, os.detach(), None,
                                               g_kk + g_kk.transpose(-1, -2), g_ky, fam)
        torch.testing.assert_close(dzs * il[:, None, :], dZ, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(dos_k, dos, rtol=1e-10, atol=1e-10)
        # d2 scales as inv_ls^2 along each dimension
        torch.testing.assert_close(2.0 * term / il, dil, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("f64_core", [False, True])
def test_elbo_from_stats_matches_jax(f64_core):
    """The bound from the statistics, value and gradient in (Z, hypers), one
    chain against the JAX package and C chains against C one-chain calls."""
    X, y, Z, log_ls, log_os = _problem(seed=10, n=120, m=8, d=3)
    ln = np.float64(-1.3)
    jkern = jk.Scale(jk.RBF(ard=True))

    def jf(Z_, lls, los, lnz):
        kp = {"log_outputscale": los, "base": {"log_lengthscale": lls}}
        st = j_vfe_stats(jkern, kp, Z_, jnp.asarray(X), jnp.asarray(y))
        return j_elbo_from_stats(jkern, {"kernel": kp, "log_noise": lnz, "Z": Z_}, st,
                                 X.shape[0], 1e-8, f64_core=f64_core)

    jargs = tuple(jnp.asarray(a) for a in (Z, log_ls, log_os, ln))
    jval, jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2, 3))(*jargs)
    targs = [torch.tensor(np.asarray(a), requires_grad=True) for a in (Z, log_ls, log_os, ln)]
    kern = default_rbf(ard=True)

    def tf(Z_, lls, los, lnz, Xt=torch.tensor(X), yt=torch.tensor(y)):
        kp = {"log_outputscale": los, "base": {"log_lengthscale": lls}}
        st = vfe_stats(kern, kp, Z_, Xt, yt)
        return sgpr_elbo_from_stats(kern, {"kernel": kp, "log_noise": lnz, "Z": Z_}, st,
                                    Xt.shape[0], 1e-8, f64_core=f64_core)

    val = tf(*targs)
    val.backward()
    assert _rel(val, jval) <= TOL64
    for t, j in zip(targs, jgrads):
        assert _rel(t.grad, j) <= 1e-9
    # two chains at once: a second hyper row, Z shared
    rows = [torch.stack([a.detach(), a.detach() + 0.1]) for a in targs[1:]]
    both = tf(targs[0].detach(), *rows)
    for c in range(2):
        torch.testing.assert_close(both[c], tf(targs[0].detach(), *(r[c] for r in rows)),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("ard", [True, False])
def test_gram_broadcasts_over_chains(ard):
    """Scale(RBF).gram with a leading chain dimension on the parameters (Z
    shared or per chain) equals C one-chain calls (batched products sum in
    another order: ~1e-15), and one chain equals the
    JAX package's gram."""
    X, _, Z, log_ls, log_os = _problem(seed=12, n=30, m=6, d=3, ard=ard)
    kern = Scale(RBF(ard=ard))
    kp = {"log_outputscale": torch.tensor(log_os), "base": {"log_lengthscale":
                                                           torch.tensor(log_ls)}}
    jkp = {"log_outputscale": jnp.asarray(log_os),
           "base": {"log_lengthscale": jnp.asarray(log_ls)}}
    Zt, Xt = torch.tensor(Z), torch.tensor(X)
    ref = jk.Scale(jk.RBF(ard=ard)).gram(jkp, jnp.asarray(Z), jnp.asarray(X))
    assert _rel(kern.gram(kp, Zt, Xt), ref) <= TOL64
    shift = torch.tensor([0.0, 0.2, -0.3], dtype=F64)
    kpc = {"log_outputscale": kp["log_outputscale"] + shift,
           "base": {"log_lengthscale": (kp["base"]["log_lengthscale"][None]
                                        + shift.reshape((3,) + (1,) * ard))}}
    Zc = Zt[None] + shift[:, None, None]
    for Z_ in (Zt, Zc):
        both = kern.gram(kpc, Z_, Z_)
        assert both.shape == (3, 6, 6)
        for c in range(3):
            one = {"log_outputscale": kpc["log_outputscale"][c],
                   "base": {"log_lengthscale": kpc["base"]["log_lengthscale"][c]}}
            Zo = Z_ if Z_.dim() == 2 else Z_[c]
            torch.testing.assert_close(both[c], kern.gram(one, Zo, Zo), rtol=1e-13, atol=0)


def test_cpu_wrappers_run_plain_and_count_no_launch():
    r = np.random.default_rng(11)
    X, y = torch.tensor(r.normal(size=(50, 3))), torch.tensor(r.normal(size=50))
    Zs, il = torch.tensor(r.normal(size=(2, 5, 3))), torch.ones((2, 3), dtype=F64)
    os = torch.ones(2, dtype=F64)
    before = dict(_build.LAUNCHES)
    S_kk, S_ky = vfe_stats_fwd(X, y, Zs, il, os)
    ref = vfe_stats_fwd_plain(X, y, Zs, il, os)
    assert torch.equal(S_kk, ref[0]) and torch.equal(S_ky, ref[1])
    g = torch.eye(5, dtype=F64).expand(2, 5, 5).contiguous()
    out = vfe_stats_bwd(X, y, Zs, il, os, None, g, S_ky)
    for a, b in zip(out, vfe_stats_bwd_plain(X, y, Zs, il, os, None, g, S_ky)):
        assert torch.equal(a, b)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="family"):
        vfe_stats_fwd(X, y, Zs, il, os, fam="periodic")
    with pytest.raises(ValueError, match="idx"):
        vfe_stats_fwd(X, y, Zs, il, os, idx=torch.zeros(7, dtype=torch.int64))
