"""SVGP and BayesianSVGP by SVI: the loss cores with their hand-written
adjoints, and whole chunks of minibatch Adam steps, plain PyTorch beside the
CUDA kernels ``svi_chunk``, ``bsvgp_chunk`` and ``svi_softmax_chunk``
(``csrc/svi_chunk.cu``).

Counterparts of ``ggp_tpu/ops/fused_svi.py``: ``svgp_loss_vg`` (the core of
``_svi_chunk_body``, Gaussian, Bernoulli-probit and Poisson data terms),
``svgp_softmax_loss_vg`` (``_svi_softmax_chunk_body``: C latents sharing
Kmm's factor and A = Lk^-1 Kms, antithetic Monte Carlo data term) and
``bsvgp_loss_vg`` (``_bsvgp_chunk_body``: S hyper draws theta_s = mu + L
eps_s, the Gaussian core per draw, the reparameterisation chain and the
hyper KL). The gradients are the JAX cores' hand-written adjoints, not
autograd, so that kernel and plain version compute one function; the tests
hold them against autograd of ``models.svgp.svgp_elbo`` and
``models.bayesian_svgp.bsvgp_elbo``.

Inputs are unpadded. SVGP parameters are a dict ``{"hyp", "Z", "q_mu",
"q_raw"}``: ``hyp`` is ``[log_lengthscale (d), log_outputscale,
log_noise]`` (d+2) for the Gaussian likelihood and without the noise (d+1)
otherwise, Z (m, d), q_mu (m, C), q_raw (C, m, m) (lower triangle direct,
diagonal through exp). BayesianSVGP parameters are ``{"hmu", "Lraw", "Z",
"q_mu", "q_raw"}`` with hmu (h,) and Lraw (h, h), h = d+2, in the hyper
layout ``[log_outputscale, log_lengthscale (d), log_noise_std]``.
Minibatches are index arrays ``idx`` (K, nb) into the resident X and y,
one row per step. Random numbers are inputs: the softmax eps (K, n_half,
nb, C) and the BayesianSVGP eps (K, S, h).

Training semantics of the JAX kernels: the jitter on Kmm is jitter *
max(sf2, 1), the Cholesky is the modified one with pivot floor 1e-6 *
max(sf2, 1), the latent variance is clamped at 1e-12 (the clamp masks its
adjoint), and Adam (``ops.sgpr_adam.adam_update``) zeroes non-finite
gradient entries.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..likelihoods import gauss_hermite
from . import _build
from .linalg import chol_upper
from .sgpr_adam import PIVOT_FLOOR, adam_update

__all__ = ["svgp_loss_vg", "svgp_softmax_loss_vg", "bsvgp_loss_vg",
           "svi_chunk_plain", "svi_chunk", "svi_softmax_chunk_plain",
           "svi_softmax_chunk", "bsvgp_chunk_plain", "bsvgp_chunk", "LIKELIHOODS",
           "SVI_NAMES", "BSVGP_NAMES", "hyp_dim"]

LIKELIHOODS = ("gauss", "bernoulli_probit", "poisson")
_LIK_ID = {"gauss": 0, "bernoulli_probit": 1, "poisson": 2, "softmax": 3}  # csrc SviLik
SVI_NAMES = ("hyp", "Z", "q_mu", "q_raw")
BSVGP_NAMES = ("hmu", "Lraw", "Z", "q_mu", "q_raw")
_VAR_FLOOR = 1e-12
_MAX_LATENTS = 16            # csrc kMaxLatents
_MAX_DRAWS = 8               # csrc kMaxDraws
_LOG_2PI = math.log(2.0 * math.pi)


def hyp_dim(d: int, likelihood: str) -> int:
    """Length of the SVGP ``hyp`` row: d+2 with the Gaussian noise, else d+1."""
    return d + 2 if likelihood == "gauss" else d + 1


def _data_term(lik, mean, var, clamp, yb, scale, s2, eps):
    """(ve_sum, alpha (nb, C), bv (C, nb), g_noise): the summed expected log
    likelihood, and scale x its derivatives in the mean, in the variance
    (masked by the clamp) and in log_noise (Gaussian only)."""
    nb = yb.shape[0]
    if lik == "gauss":
        e = yb - mean[:, 0]
        see, svar = (e * e).sum(), var[0].sum()
        ve = -0.5 * nb * torch.log(2.0 * math.pi * s2) - 0.5 * (see + svar) / s2
        d_s2 = -0.5 * nb / s2 + 0.5 * (see + svar) / (s2 * s2)
        return ve, (scale * e / s2)[:, None], (-0.5 * scale / s2) * clamp, scale * d_s2 * s2
    if lik == "bernoulli_probit":
        x, w = (a.to(dtype=mean.dtype, device=mean.device) for a in gauss_hermite())
        sgn = 2.0 * yb - 1.0
        sig = torch.sqrt(var[0])
        z = sgn * (mean[:, 0] + x[:, None] * sig)                  # (Q, nb)
        lp = torch.special.log_ndtr(z)
        r = torch.exp(-0.5 * z * z - 0.5 * _LOG_2PI - lp)           # pdf / cdf
        ve = (w[:, None] * lp).sum(0).sum()
        dmu = sgn * (w[:, None] * r).sum(0)
        dvar = sgn * (w[:, None] * x[:, None] * r).sum(0) / (2.0 * sig)
        return ve, (scale * dmu)[:, None], scale * dvar * clamp, None
    if lik == "poisson":
        rate = torch.exp(mean[:, 0] + 0.5 * var[0])
        ve = (yb * mean[:, 0] - rate - torch.lgamma(yb + 1.0)).sum()
        return ve, (scale * (yb - rate))[:, None], scale * (-0.5 * rate) * clamp, None
    # softmax: 2 n_half antithetic draws per point, exact per-point max
    C = mean.shape[1]
    E = torch.cat([eps, -eps], dim=0)                               # (S, nb, C)
    S = E.shape[0]
    sig = torch.sqrt(var).T                                         # (nb, C)
    f = mean[None] + sig[None] * E
    oh = torch.nn.functional.one_hot(yb.long(), C).to(mean.dtype)
    mx = f.max(-1, keepdim=True).values
    ex = torch.exp(f - mx)
    se = ex.sum(-1, keepdim=True)
    lp = (oh[None] * f).sum(-1) - (mx + torch.log(se))[..., 0]
    gy = oh[None] - ex / se
    dmu = gy.sum(0) / S
    dvar = (gy * E).sum(0) / S
    return lp.sum() / S, scale * dmu, (scale * dvar / (2.0 * sig)).T * clamp, None


def _core(lik, hyp, Z, q_mu, q_raw, Xb, yb, num_data, jitter, eps=None):
    """Loss -ELBO of one minibatch and its gradient in (hyp, Z, q_mu,
    q_raw), by the adjoint of ``fused_svi.svgp_loss_vg`` (C latents)."""
    nb, d = Xb.shape
    m = Z.shape[0]
    dt, dev = Xb.dtype, Xb.device
    eye = torch.eye(m, dtype=dt, device=dev)
    strict = torch.tril(torch.ones((m, m), dtype=dt, device=dev), -1)
    inv_ls = torch.exp(-hyp[:d])
    sf2 = torch.exp(hyp[d])
    s2 = torch.exp(hyp[d + 1]) if lik == "gauss" else None
    scale = num_data / nb

    Zs, Xs = Z * inv_ls, Xb * inv_ls
    Zs2, Xs2 = Zs * Zs, Xs * Xs
    zn, xn = Zs2.sum(1), Xs2.sum(1)
    Kmm = sf2 * torch.exp(-0.5 * torch.clamp(zn[:, None] + zn[None] - 2.0 * Zs @ Zs.T, min=0.0))
    Kms = sf2 * torch.exp(-0.5 * torch.clamp(zn[:, None] + xn[None] - 2.0 * Zs @ Xs.T, min=0.0))
    jit_scale = torch.clamp(sf2, min=1.0)
    U = chol_upper(Kmm + (jitter * jit_scale) * eye, PIVOT_FLOOR * jit_scale)
    A = torch.linalg.solve_triangular(U.T, Kms, upper=False)       # Lk^-1 Kms

    diag_raw = torch.diagonal(q_raw, dim1=-2, dim2=-1)              # (C, m)
    qL = q_raw * strict + torch.diag_embed(torch.exp(diag_raw))
    mean = A.T @ q_mu                                               # (nb, C)
    SA = qL.transpose(-1, -2) @ A                                   # (C, m, nb)
    var_raw = sf2 - (A * A).sum(0) + (SA * SA).sum(1)               # (C, nb)
    clamp = (var_raw > _VAR_FLOOR).to(dt)
    var = torch.clamp(var_raw, min=_VAR_FLOOR)
    ve, alpha, bv, g_noise = _data_term(lik, mean, var, clamp, yb, scale, s2, eps)

    diag_qL = torch.diagonal(qL, dim1=-2, dim2=-1)
    klq = 0.5 * ((qL * qL).sum() + (q_mu * q_mu).sum() - q_mu.numel()
                 - 2.0 * torch.log(diag_qL).sum())
    loss = -(scale * ve - klq)

    # adjoints of the ELBO
    G = (q_mu @ alpha.T + 2.0 * ((qL @ SA) * bv[:, None, :]).sum(0)
         - 2.0 * A * bv.sum(0))                                     # dELBO/dA
    g_qmu = A @ alpha - q_mu
    g_qL = 2.0 * A @ (SA * bv[:, None, :]).transpose(-1, -2) - qL + torch.diag_embed(1.0 / diag_qL)
    g_qraw = g_qL * strict + torch.diag_embed(torch.diagonal(g_qL, dim1=-2, dim2=-1)
                                              * torch.exp(diag_raw))
    Kms_b = torch.linalg.solve_triangular(U, G, upper=True)         # Lk^-T G
    V = torch.linalg.solve_triangular(U, eye, upper=True)           # Lk^-T
    Phi = (G @ A.T) * (strict + 0.5 * eye)
    Kmm_b = -(V @ Phi) @ V.T
    Kmm_b = 0.5 * (Kmm_b + Kmm_b.T)
    g_os = ((Kmm_b * Kmm).sum() + (Kms_b * Kms).sum()
            + jitter * sf2 * (sf2 > 1.0).to(dt) * torch.diagonal(Kmm_b).sum()
            + bv.sum() * sf2)
    Pmm, Pms = Kmm_b * Kmm, Kms_b * Kms
    rs_mm, cs_mm, rs_ms, cs_ms = Pmm.sum(1), Pmm.sum(0), Pms.sum(1), Pms.sum(0)
    PmmZs, PmsXs = Pmm @ Zs, Pms @ Xs
    g_ls = (rs_mm @ Zs2 + cs_mm @ Zs2 - 2.0 * (Zs * PmmZs).sum(0)
            + rs_ms @ Zs2 + cs_ms @ Xs2 - 2.0 * (Zs * PmsXs).sum(0))
    dZs = -2.0 * (rs_mm[:, None] * Zs - PmmZs) - (rs_ms[:, None] * Zs - PmsXs)
    g_hyp = [g_ls, g_os[None]] + ([g_noise[None]] if lik == "gauss" else [])
    return loss, {"hyp": -torch.cat(g_hyp), "Z": -(dZs * inv_ls), "q_mu": -g_qmu,
                  "q_raw": -g_qraw}


def _check_svgp(name, X, Z, q_mu, q_raw, C, hyp_len=None, hyp=None):
    d = X.shape[1]
    m = Z.shape[0]
    if (Z.shape != (m, d) or q_mu.shape != (m, C) or q_raw.shape != (C, m, m)
            or (hyp is not None and hyp.shape != (hyp_len,))):
        raise ValueError(f"{name}: Z {tuple(Z.shape)}, q_mu {tuple(q_mu.shape)}, q_raw "
                         f"{tuple(q_raw.shape)}" + ("" if hyp is None else f", hyp "
                         f"{tuple(hyp.shape)}") + f" do not fit (m, {d}), (m, {C}), "
                         f"({C}, m, m)" + ("" if hyp is None else f", ({hyp_len},)"))
    if d + 2 > 128:
        raise ValueError(f"{name}: d + 2 = {d + 2} exceeds 128")


def svgp_loss_vg(params, X_b, y_b, num_data, jitter, likelihood="gauss"):
    """(loss, grads) of one minibatch of the single-latent SVGP: loss =
    -(num_data / nb) sum_i E_q[log p(y_i | f_i)] + KL, grads a dict like
    ``params``. ``likelihood`` is "gauss" (closed form, noise in hyp[d+1]),
    "bernoulli_probit" (20-node Gauss-Hermite of log Phi) or "poisson"
    (closed form y mu - exp(mu + var/2) - log y!)."""
    if likelihood not in LIKELIHOODS:
        raise ValueError(f"likelihood must be one of {LIKELIHOODS}, got {likelihood!r}")
    _check_svgp("svgp_loss_vg", X_b, *(params[k] for k in SVI_NAMES[1:]), 1,
                hyp_dim(X_b.shape[1], likelihood), params["hyp"])
    return _core(likelihood, *(params[k] for k in SVI_NAMES), X_b, y_b, num_data, jitter)


def svgp_softmax_loss_vg(params, X_b, y_b, eps, num_data, jitter):
    """(loss, grads) of one minibatch of the C-latent softmax SVGP; ``eps``
    (n_half, nb, C) standard normals, used with their negatives (the
    antithetic draws of ``likelihoods.Softmax``); y_b holds class labels."""
    _check_svgp("svgp_softmax_loss_vg", X_b, *(params[k] for k in SVI_NAMES[1:]),
                params["q_mu"].shape[1], X_b.shape[1] + 1, params["hyp"])
    return _core("softmax", *(params[k] for k in SVI_NAMES), X_b, y_b, num_data, jitter,
                 eps=eps)


def _bsvgp_parts(hmu, Lraw):
    diag_raw = torch.diagonal(Lraw)
    return diag_raw, torch.tril(Lraw, -1) + torch.diag(torch.exp(diag_raw))


def bsvgp_loss_vg(params, X_b, y_b, eps, num_data, jitter, prior_var):
    """(loss, grads) of one BayesianSVGP minibatch (Gaussian likelihood):
    the SVGP loss averaged over the S hyper draws theta_s = hmu + L_h eps_s
    (eps (S, h)), plus KL(N(hmu, L_h L_h^T) || N(0, prior_var I))."""
    hmu, Lraw, Z, q_mu, q_raw = (params[k] for k in BSVGP_NAMES)
    d = X_b.shape[1]
    h = d + 2
    if hmu.shape != (h,) or Lraw.shape != (h, h) or eps.ndim != 2 or eps.shape[1] != h:
        raise ValueError(f"bsvgp_loss_vg: hmu {tuple(hmu.shape)}, Lraw {tuple(Lraw.shape)}, "
                         f"eps {tuple(eps.shape)} do not fit ({h},), ({h}, {h}), (S, {h})")
    S = eps.shape[0]
    inv_s = 1.0 / S
    diag_raw, L_h = _bsvgp_parts(hmu, Lraw)
    thetas = hmu + eps @ L_h.T
    loss = torch.zeros((), dtype=X_b.dtype, device=X_b.device)
    acc = {k: torch.zeros_like(params[k]) for k in ("Z", "q_mu", "q_raw")}
    G_theta = []
    for s in range(S):
        th = thetas[s]
        hyp = torch.cat([th[1:d + 1], th[:1], 2.0 * th[d + 1:]])
        loss_s, g = _core("gauss", hyp, Z, q_mu, q_raw, X_b, y_b, num_data, jitter)
        loss = loss + inv_s * loss_s
        for k in acc:
            acc[k] = acc[k] + inv_s * g[k]
        gh = g["hyp"]
        G_theta.append(torch.cat([gh[d:d + 1], gh[:d], 2.0 * gh[d + 1:]]))
    G_theta = torch.stack(G_theta)                                  # (S, h)
    pv = prior_var
    klh = 0.5 * ((L_h * L_h).sum() / pv + (hmu * hmu).sum() / pv - h
                 - 2.0 * diag_raw.sum() + h * math.log(pv))
    g_hmu = inv_s * G_theta.sum(0) + hmu / pv
    g_L = inv_s * (G_theta.T @ eps) + L_h / pv
    g_Lraw = torch.tril(g_L, -1) + torch.diag(torch.diagonal(g_L) * torch.exp(diag_raw) - 1.0)
    return loss + klh, {"hmu": g_hmu, "Lraw": g_Lraw, **acc}


# -- chunks of Adam steps -------------------------------------------------------------

def _adam_chunk(step_loss_vg, names, params, adam_m, adam_v, t0, lr, K):
    p, mm, vv = dict(params), dict(adam_m), dict(adam_v)
    losses = []
    for t in range(K):
        loss, g = step_loss_vg(p, t)
        ta = torch.as_tensor(t0 + t + 1.0, dtype=loss.dtype, device=loss.device)
        for k in names:
            p[k], mm[k], vv[k] = adam_update(p[k], g[k], mm[k], vv[k], ta, lr)
        losses.append(loss)
    return p, mm, vv, torch.stack(losses)


def svi_chunk_plain(params, adam_m, adam_v, X, y, idx, jitter, *, likelihood, t0, lr):
    """K = idx.shape[0] Adam steps of the single-latent SVGP, step t on the
    rows ``idx[t]`` of (X, y), num_data = X.shape[0]. Returns (params,
    adam_m, adam_v, losses (K,))."""
    N = X.shape[0]

    def step(p, t):
        return svgp_loss_vg(p, X[idx[t]], y[idx[t]], N, jitter, likelihood)
    return _adam_chunk(step, SVI_NAMES, params, adam_m, adam_v, t0, lr, idx.shape[0])


def svi_softmax_chunk_plain(params, adam_m, adam_v, X, y, idx, eps, jitter, *, t0, lr):
    """K Adam steps of the softmax SVGP; step t draws eps[t] (n_half, nb,
    C) and their negatives."""
    N = X.shape[0]

    def step(p, t):
        return svgp_softmax_loss_vg(p, X[idx[t]], y[idx[t]], eps[t], N, jitter)
    return _adam_chunk(step, SVI_NAMES, params, adam_m, adam_v, t0, lr, idx.shape[0])


def bsvgp_chunk_plain(params, adam_m, adam_v, X, y, idx, eps, jitter, *, prior_var, t0, lr):
    """K Adam steps of the BayesianSVGP; step t takes the S hyper draws
    eps[t] (S, h)."""
    N = X.shape[0]

    def step(p, t):
        return bsvgp_loss_vg(p, X[idx[t]], y[idx[t]], eps[t], N, jitter, prior_var)
    return _adam_chunk(step, BSVGP_NAMES, params, adam_m, adam_v, t0, lr, idx.shape[0])


# -- the kernels ----------------------------------------------------------------------

def _check_chunk(name, X, y, idx):
    N = X.shape[0]
    if y.shape != (N,) or idx.ndim != 2 or idx.shape[0] < 1 or idx.shape[1] < 1:
        raise ValueError(f"{name}: X {tuple(X.shape)}, y {tuple(y.shape)}, idx "
                         f"{tuple(idx.shape)} do not fit (N, d), (N,), (K, nb)")


def _launch(name, entry, names, params, adam_m, adam_v, X, y, idx, eps, *, C, lik, t0,
            lr, jitter, **extra):
    """One launch of ``entry`` on copies of the parameters and moments.
    Returns (params, adam_m, adam_v, losses)."""
    N, d = X.shape
    K, nb = idx.shape
    m = params["Z"].shape[0]
    tensors = [params[k] for k in names] + [adam_m[k] for k in names] + [adam_v[k] for k in names]
    _build.require_cuda(name, X.dtype, X, y, *tensors, *([eps] if eps is not None else []))
    lo, hi = int(idx.min()), int(idx.max())            # an index out of range faults the card
    if lo < 0 or hi >= N:
        raise ValueError(f"{name}: indices span [{lo}, {hi}], outside [0, {N})")
    idx32 = idx.to(device=X.device, dtype=torch.int32).contiguous()
    outs = [a.clone() for a in tensors]
    losses = torch.empty(K, dtype=X.dtype, device=X.device)
    work = torch.empty(int(_build.build().ggp_svi_scratch_elems(m, nb, d, C)),
                       dtype=X.dtype, device=X.device)
    x, w = gauss_hermite()
    cfg = _build.cfg_array(N=N, M=m, D=d, NB=nb, K=K, LIK=_LIK_ID[lik], LATENTS=C,
                           JITTER=jitter, NUM_DATA=N, LR=lr, T0=t0,
                           QUAD=list(x.tolist()) + list(w.tolist()), **extra)
    P = _build.ptr
    err = _build.kernel_fn(entry, X.dtype)(
        ctypes.cast(cfg, ctypes.c_void_p), *[P(a) for a in outs], P(X), P(y), P(idx32),
        *([P(eps)] if eps is not None else []), P(losses), P(work),
        _build.stream_ptr(X.device))
    _build.check(err, name)
    P3 = len(names)
    return (dict(zip(names, outs[:P3])), dict(zip(names, outs[P3:2 * P3])),
            dict(zip(names, outs[2 * P3:])), losses)


def svi_chunk(params, adam_m, adam_v, X, y, idx, jitter, *, likelihood, t0, lr):
    """:func:`svi_chunk_plain` on CPU tensors; on CUDA tensors the whole
    chunk is one launch of ``csrc/svi_chunk.cu`` (site 17,
    ``fused_svi.py:1012``), or a raise. Inputs are not modified."""
    if likelihood not in LIKELIHOODS:
        raise ValueError(f"likelihood must be one of {LIKELIHOODS}, got {likelihood!r}")
    _check_chunk("svi_chunk", X, y, idx)
    _check_svgp("svi_chunk", X, *(params[k] for k in SVI_NAMES[1:]), 1,
                hyp_dim(X.shape[1], likelihood), params["hyp"])
    kw = dict(likelihood=likelihood, t0=t0, lr=lr)
    if X.device.type == "cpu":
        return svi_chunk_plain(params, adam_m, adam_v, X, y, idx, jitter, **kw)
    out = _launch("svi_chunk", "ggp_svi_chunk", SVI_NAMES, params, adam_m, adam_v, X, y,
                  idx, None, C=1, lik=likelihood, t0=float(t0), lr=lr, jitter=jitter)
    _build.LAUNCHES["svi_chunk"] += 1
    return out


def svi_softmax_chunk(params, adam_m, adam_v, X, y, idx, eps, jitter, *, t0, lr):
    """:func:`svi_softmax_chunk_plain` on CPU tensors; one launch of
    ``csrc/svi_chunk.cu`` (site 18, ``fused_svi.py:660``) on CUDA tensors.
    Takes 2 <= C <= 16 latents; eps (K, n_half, nb, C)."""
    _check_chunk("svi_softmax_chunk", X, y, idx)
    _check_svgp("svi_softmax_chunk", X, *(params[k] for k in SVI_NAMES[1:]),
                params["q_mu"].shape[1], X.shape[1] + 1, params["hyp"])
    K, nb = idx.shape
    C = params["q_mu"].shape[1]
    if not 2 <= C <= _MAX_LATENTS or eps.ndim != 4 or eps.shape[0] != K \
            or eps.shape[2:] != (nb, C) or eps.shape[1] < 1:
        raise ValueError(f"svi_softmax_chunk: C = {C} (2 <= C <= {_MAX_LATENTS}) and eps "
                         f"{tuple(eps.shape)} must fit ({K}, n_half, {nb}, {C})")
    if X.device.type == "cpu":
        return svi_softmax_chunk_plain(params, adam_m, adam_v, X, y, idx, eps, jitter,
                                       t0=t0, lr=lr)
    out = _launch("svi_softmax_chunk", "ggp_svi_softmax_chunk", SVI_NAMES, params, adam_m,
                  adam_v, X, y, idx, eps, C=C, lik="softmax", t0=float(t0), lr=lr,
                  jitter=jitter, NHALF=eps.shape[1])
    _build.LAUNCHES["svi_softmax_chunk"] += 1
    return out


def bsvgp_chunk(params, adam_m, adam_v, X, y, idx, eps, jitter, *, prior_var, t0, lr):
    """:func:`bsvgp_chunk_plain` on CPU tensors; one launch of
    ``csrc/svi_chunk.cu`` (site 19, ``fused_svi.py:873``) on CUDA tensors.
    Takes 1 <= S <= 8 draws per step; eps (K, S, h)."""
    _check_chunk("bsvgp_chunk", X, y, idx)
    d = X.shape[1]
    h = d + 2
    _check_svgp("bsvgp_chunk", X, *(params[k] for k in BSVGP_NAMES[2:]), 1)
    K = idx.shape[0]
    if params["hmu"].shape != (h,) or params["Lraw"].shape != (h, h) or eps.ndim != 3 \
            or eps.shape[0] != K or eps.shape[2] != h or not 1 <= eps.shape[1] <= _MAX_DRAWS:
        raise ValueError(f"bsvgp_chunk: hmu {tuple(params['hmu'].shape)}, Lraw "
                         f"{tuple(params['Lraw'].shape)}, eps {tuple(eps.shape)} must fit "
                         f"({h},), ({h}, {h}), ({K}, S <= {_MAX_DRAWS}, {h})")
    if X.device.type == "cpu":
        return bsvgp_chunk_plain(params, adam_m, adam_v, X, y, idx, eps, jitter,
                                 prior_var=prior_var, t0=t0, lr=lr)
    out = _launch("bsvgp_chunk", "ggp_bsvgp_chunk", BSVGP_NAMES, params, adam_m, adam_v, X,
                  y, idx, eps, C=1, lik="gauss", t0=float(t0), lr=lr, jitter=jitter,
                  S_ACT=eps.shape[1], PRIOR_VAR=prior_var)
    _build.LAUNCHES["bsvgp_chunk"] += 1
    return out
