"""Whole chunks of Adam steps on the collapsed bound: plain PyTorch beside
the CUDA kernels ``sgpr_adam_chunk`` (kernel 3), ``z_adam_chunk`` (kernel
4) and ``z_adam_stream`` (kernel 12).

Counterparts of ``ggp_tpu/ops/fused_sgpr.py`` ``_sgpr_chunk_body`` (the
warm start's (theta, Z) trainer) and ``_zadam_chunk_body`` (optimize_Z's
Z-only trainer over a hyper trace; resident up to ``STREAM_MIN_N`` rows,
streamed over row blocks past it, as the JAX package's two pallas_calls),
and of ``ops/fused_svi.py`` ``_adam_update``. They train -ELBO without the
prior, with the trainers' modified Cholesky (pivot floor 1e-6). Inputs are
unpadded: ``theta`` (d+2,), ``Z`` (m, d), a trace ``thetas`` (S, d+2).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .linalg import capped_inv_ls, chol_upper
from .vfe_bound import _check_shapes, bound_cfg, rbf_vfe_neg_logpost_vg

__all__ = ["adam_update", "sgpr_adam_chunk_plain", "sgpr_adam_chunk",
           "z_adam_chunk_plain", "z_adam_resident", "z_adam_chunk", "stream_neg_elbo_vg",
           "z_adam_stream_plain", "z_adam_stream", "PIVOT_FLOOR", "STREAM_MIN_N",
           "STREAM_NB"]

PIVOT_FLOOR = 1e-6
_BOX = 15.0
# optimize_Z streams past this many rows (``make_fused_z_adam``: n > 2048),
# in row blocks of STREAM_NB
STREAM_MIN_N = 2048
STREAM_NB = 256


def _finite(g):
    """optax.zero_nans extended to inf: ``abs(g) <= 3e38`` else 0."""
    return torch.where(g.abs() <= 3.0e38, g, torch.zeros_like(g))


def adam_update(p, g, mm, vv, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam defaults (bias-corrected moments, eps_root=0) after
    zeroing non-finite gradient entries; ``t`` is the 1-based step."""
    g = _finite(g)
    mm1 = b1 * mm + (1.0 - b1) * g
    vv1 = b2 * vv + (1.0 - b2) * g * g
    bc1 = 1.0 - torch.exp(t * torch.log(torch.as_tensor(b1, dtype=p.dtype)))
    bc2 = 1.0 - torch.exp(t * torch.log(torch.as_tensor(b2, dtype=p.dtype)))
    return p - lr * (mm1 / bc1) / (torch.sqrt(vv1 / bc2) + eps), mm1, vv1


def _loss_vg(theta, X, y, Z, jitter):
    return rbf_vfe_neg_logpost_vg(theta, X, y, Z, jitter, want_z_grad=True,
                                  want_prior=False, pivot_floor=PIVOT_FLOOR)


def sgpr_adam_chunk_plain(theta, Z, m_th, v_th, m_z, v_z, X, y, jitter, *,
                          t0, num_steps, lr, clip_norm, min_noise=1e-4):
    """``num_steps`` full-batch Adam steps on (theta, Z): masked gradient,
    clip by global norm ``clip_norm``, Adam from step ``t0 + 1``, +-15 box
    on the log-hypers, log-noise floor log(min_noise). Returns (theta, Z,
    m_th, v_th, m_z, v_z, losses (num_steps,))."""
    d = X.shape[1]
    dev, dt = X.device, X.dtype
    is_noise = torch.arange(d + 2, device=dev) == d + 1
    log_floor = math.log(min_noise)
    losses = []
    for t in range(int(num_steps)):
        loss, gt, gZ = _loss_vg(theta, X, y, Z, jitter)
        gt, gZ = _finite(gt), _finite(gZ)
        gn = torch.sqrt((gt * gt).sum() + (gZ * gZ).sum())
        sc = torch.clamp(clip_norm / gn, max=1.0)
        ta = torch.as_tensor(t0 + t + 1.0, dtype=dt, device=dev)
        theta, m_th, v_th = adam_update(theta, gt * sc, m_th, v_th, ta, lr)
        Z, m_z, v_z = adam_update(Z, gZ * sc, m_z, v_z, ta, lr)
        theta = torch.clamp(theta, -_BOX, _BOX)
        theta = torch.where(is_noise, torch.clamp(theta, min=log_floor), theta)
        losses.append(loss)
    return theta, Z, m_th, v_th, m_z, v_z, torch.stack(losses)


def z_adam_chunk_plain(Z, m_z, v_z, thetas, X, y, jitter, *, t0, num_steps,
                       lr):
    """``num_steps`` Adam steps on Z of the mean over the rows of
    ``thetas`` of -ELBO(theta_s, Z). Returns (Z, m_z, v_z, losses)."""
    S = thetas.shape[0]
    inv_s = 1.0 / S
    losses = []
    for t in range(int(num_steps)):
        lacc = torch.zeros((), dtype=X.dtype, device=X.device)
        gacc = torch.zeros_like(Z)
        for s in range(S):
            loss, _, gZ = _loss_vg(thetas[s], X, y, Z, jitter)
            lacc = lacc + inv_s * loss
            gacc = gacc + inv_s * gZ
        ta = torch.as_tensor(t0 + t + 1.0, dtype=X.dtype, device=X.device)
        Z, m_z, v_z = adam_update(Z, gacc, m_z, v_z, ta, lr)
        losses.append(lacc)
    return Z, m_z, v_z, torch.stack(losses)


def _call_sgpr_adam(theta, Z, m_th, v_th, m_z, v_z, X, y, jitter, t0,
                    num_steps, lr, clip_norm, min_noise, stream):
    n, d = X.shape
    m = Z.shape[0]
    outs = [a.clone() for a in (theta, Z, m_th, v_th, m_z, v_z)]
    losses = torch.empty(num_steps, dtype=X.dtype, device=X.device)
    work = _build.scratch(n, m, d, m * d, X)
    cfg = bound_cfg(n, m, d, jitter, want_z_grad=True, want_prior=False,
                    pivot_floor=PIVOT_FLOOR, prior_spec=None, K=num_steps,
                    LR=lr, CLIP=clip_norm, MIN_NOISE=min_noise, T0=t0)
    P = _build.ptr
    err = _build.kernel_fn("ggp_sgpr_adam", X.dtype)(
        ctypes.cast(cfg, ctypes.c_void_p), *[P(a) for a in outs], P(X), P(y),
        P(losses), P(work), stream)
    _build.check(err, "sgpr_adam_chunk")
    return (*outs, losses)


def sgpr_adam_chunk(theta, Z, m_th, v_th, m_z, v_z, X, y, jitter, *, t0,
                    num_steps, lr, clip_norm, min_noise=1e-4):
    """:func:`sgpr_adam_chunk_plain` on CPU tensors; kernel 3
    (``csrc/sgpr_adam.cu``) on CUDA tensors, where the whole chunk is one
    launch. Inputs are not modified."""
    _check_shapes("sgpr_adam_chunk", theta, X, y, Z)
    if X.device.type == "cpu":
        return sgpr_adam_chunk_plain(theta, Z, m_th, v_th, m_z, v_z, X, y,
                                     jitter, t0=t0, num_steps=num_steps,
                                     lr=lr, clip_norm=clip_norm,
                                     min_noise=min_noise)
    _build.require_cuda("sgpr_adam_chunk", X.dtype, theta, Z, m_th, v_th,
                        m_z, v_z, X, y)
    out = _call_sgpr_adam(theta, Z, m_th, v_th, m_z, v_z, X, y, jitter,
                          float(t0), int(num_steps), lr, clip_norm, min_noise,
                          _build.stream_ptr(X.device))
    _build.LAUNCHES["sgpr_adam_chunk"] += 1
    return out


def _call_z_adam(Z, m_z, v_z, thetas, X, y, jitter, t0, num_steps, lr,
                 stream):
    n, d = X.shape
    m = Z.shape[0]
    outs = [a.clone() for a in (Z, m_z, v_z)]
    losses = torch.empty(num_steps, dtype=X.dtype, device=X.device)
    work = _build.scratch(n, m, d, 2 * m * d, X)
    cfg = bound_cfg(n, m, d, jitter, want_z_grad=True, want_prior=False,
                    pivot_floor=PIVOT_FLOOR, prior_spec=None, K=num_steps,
                    LR=lr, T0=t0, S_ACT=thetas.shape[0])
    P = _build.ptr
    err = _build.kernel_fn("ggp_z_adam", X.dtype)(
        ctypes.cast(cfg, ctypes.c_void_p), P(thetas), *[P(a) for a in outs],
        P(X), P(y), P(losses), P(work), stream)
    _build.check(err, "z_adam_chunk")
    return (*outs, losses)


def _check_trace(name, thetas, X, y, Z):
    _check_shapes(name, thetas[0], X, y, Z)
    if thetas.ndim != 2 or thetas.shape[0] < 1:
        raise ValueError(f"{name}: thetas must be (S >= 1, d+2)")


def z_adam_resident(Z, m_z, v_z, thetas, X, y, jitter, *, t0, num_steps, lr):
    """:func:`z_adam_chunk_plain` on CPU tensors; kernel 4
    (``csrc/sgpr_adam.cu``, one block, site 7's function) on CUDA tensors.
    Inputs are not modified."""
    _check_trace("z_adam_chunk", thetas, X, y, Z)
    if X.device.type == "cpu":
        return z_adam_chunk_plain(Z, m_z, v_z, thetas, X, y, jitter, t0=t0,
                                  num_steps=num_steps, lr=lr)
    _build.require_cuda("z_adam_chunk", X.dtype, Z, m_z, v_z, thetas, X, y)
    out = _call_z_adam(Z, m_z, v_z, thetas, X, y, jitter, float(t0),
                       int(num_steps), lr, _build.stream_ptr(X.device))
    _build.LAUNCHES["z_adam_chunk"] += 1
    return out


def z_adam_chunk(Z, m_z, v_z, thetas, X, y, jitter, *, t0, num_steps, lr):
    """optimize_Z's chunk, routed by size as the JAX package routes it: up to
    ``STREAM_MIN_N`` rows :func:`z_adam_resident` (kernel 4 on the card),
    past it :func:`z_adam_stream` (kernel 12). Inputs are not modified."""
    if X.shape[0] > STREAM_MIN_N:
        return z_adam_stream(Z, m_z, v_z, thetas, X, y, jitter, t0=t0,
                             num_steps=num_steps, lr=lr)
    return z_adam_resident(Z, m_z, v_z, thetas, X, y, jitter, t0=t0,
                           num_steps=num_steps, lr=lr)


def _chol_rows(K, floor):
    """:func:`chol_upper` of each matrix of the batch K (S, m, m), floor[s]
    on the pivots of K[s]."""
    return torch.stack([chol_upper(K[s], floor[s]) for s in range(K.shape[0])])


def stream_neg_elbo_vg(thetas, X, y, Z, jitter, nb=None):
    """U_s = -ELBO(theta_s, Z) (no prior) and dU_s/dZ for each row of
    ``thetas`` (S, d+2), batched over the rows, with the trainers' modified
    Cholesky: the JAX streamed core's structure
    (``_rbf_vfe_neg_logpost_vg_streaming``), two additive passes over row
    blocks of ``nb`` rows (default STREAM_NB) with the M x M part between.
    Pass 1 sums B - I = sum An_b^T An_b, u = sum An_b^T y_b and y^T y; pass
    2 recomputes Knm_b and An_b and sums the Knm half of the Z adjoint.
    Returns (U (S,), dU/dZ (S, m, d))."""
    nb = STREAM_NB if nb is None else int(nb)
    n, d = X.shape
    m = Z.shape[0]
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    inv_ls = capped_inv_ls(thetas[:, :d], X, Z)                  # (S, d)
    sf2, s2 = torch.exp(thetas[:, d]), torch.exp(thetas[:, d + 1])
    sigma = torch.sqrt(s2)
    jit_scale = torch.clamp(sf2, min=1.0)
    Zs = Z * inv_ls[:, None, :]                                 # (S, m, d)
    zn = (Zs * Zs).sum(-1)
    Kmm = sf2[:, None, None] * torch.exp(-0.5 * torch.clamp(
        zn[:, :, None] + zn[:, None, :] - 2.0 * Zs @ Zs.transpose(1, 2), min=0.0))
    U = _chol_rows(Kmm + (jitter * jit_scale)[:, None, None] * eye,
                   PIVOT_FLOOR * jit_scale)
    V = torch.linalg.solve_triangular(U, eye.expand_as(U), upper=True)   # L^-T

    def block(b0):
        Xs = X[b0:b0 + nb] * inv_ls[:, None, :]                 # (S, nb, d)
        xn = (Xs * Xs).sum(-1)
        Knm = sf2[:, None, None] * torch.exp(-0.5 * torch.clamp(
            xn[:, :, None] + zn[:, None, :] - 2.0 * Xs @ Zs.transpose(1, 2), min=0.0))
        return Xs, y[b0:b0 + nb], Knm, Knm @ V / sigma[:, None, None]

    Bacc = torch.zeros_like(Kmm)
    u = torch.zeros_like(zn)
    yy = torch.zeros((), dtype=X.dtype, device=X.device)
    for b0 in range(0, n, nb):
        _, yb, _, An = block(b0)
        Bacc = Bacc + An.transpose(1, 2) @ An
        u = u + (An.transpose(1, 2) @ yb)
        yy = yy + (yb * yb).sum()
    B = Bacc + eye
    UB = _chol_rows(B, torch.full_like(sf2, PIVOT_FLOOR))
    VB = torch.linalg.solve_triangular(UB, eye.expand_as(UB), upper=True)
    Binv = VB @ VB.transpose(1, 2)
    c = torch.linalg.solve_triangular(UB.transpose(1, 2), u[..., None], upper=False)
    v = torch.linalg.solve_triangular(UB, c, upper=True)
    w = torch.linalg.solve_triangular(U, v, upper=True)[..., 0]         # (S, m)
    c, v = c[..., 0], v[..., 0]
    logdetB = 2.0 * torch.log(torch.diagonal(UB, dim1=1, dim2=2)).sum(-1)
    t_term = n * sf2 - s2 * (torch.diagonal(B, dim1=1, dim2=2).sum(-1) - m)
    F = (-0.5 * n * torch.log(2.0 * math.pi * s2) - 0.5 * logdetB
         - 0.5 * (yy - (c * c).sum(-1)) / s2 - 0.5 * t_term / s2)
    Y1 = (eye - Binv) @ V.transpose(1, 2)
    T0 = 2.0 * eye - B - Binv
    dKmm = (-(w[:, :, None] * w[:, None, :]) / (2.0 * s2[:, None, None])
            + 0.5 * V @ T0 @ V.transpose(1, 2))
    Pmm = dKmm * Kmm
    GnmZ = torch.zeros_like(Zs)
    for b0 in range(0, n, nb):
        Xs, yb, Knm, An = block(b0)
        alpha = (yb - (An @ v[..., None])[..., 0]) / s2[:, None]          # (S, nb)
        Pnm = (An @ Y1 + alpha[..., None] * w[:, None, :]) / sigma[:, None, None] * Knm
        GnmZ = GnmZ + Pnm.sum(1)[..., None] * Zs - Pnm.transpose(1, 2) @ Xs
    GmmZ = Pmm.sum(-1)[..., None] * Zs - Pmm @ Zs
    return -F, (2.0 * GmmZ + GnmZ) * inv_ls[:, None, :]


def z_adam_stream_plain(Z, m_z, v_z, thetas, X, y, jitter, *, t0, num_steps, lr,
                        nb=None):
    """:func:`z_adam_chunk_plain`'s function, each step's S evaluations
    batched through :func:`stream_neg_elbo_vg` (row blocks of ``nb``).
    Returns (Z, m_z, v_z, losses)."""
    inv_s = 1.0 / thetas.shape[0]
    losses = []
    for t in range(int(num_steps)):
        U, dZ = stream_neg_elbo_vg(thetas, X, y, Z, jitter, nb)
        ta = torch.as_tensor(t0 + t + 1.0, dtype=X.dtype, device=X.device)
        Z, m_z, v_z = adam_update(Z, (inv_s * dZ).sum(0), m_z, v_z, ta, lr)
        losses.append((inv_s * U).sum())
    return Z, m_z, v_z, torch.stack(losses)


def _call_z_adam_stream(Z, m_z, v_z, thetas, X, y, jitter, t0, num_steps, lr, stream):
    n, d = X.shape
    m, S = Z.shape[0], thetas.shape[0]
    outs = [a.clone() for a in (Z, m_z, v_z)]
    losses = torch.empty(num_steps, dtype=X.dtype, device=X.device)
    elems = _build.build().ggp_z_adam_stream_elems
    work = torch.empty(elems(n, m, d, S, STREAM_NB, 0), dtype=X.dtype, device=X.device)
    part = torch.empty(elems(n, m, d, S, STREAM_NB, 1), dtype=torch.float64,
                       device=X.device)
    cfg = bound_cfg(n, m, d, jitter, want_z_grad=True, want_prior=False,
                    pivot_floor=PIVOT_FLOOR, prior_spec=None, K=num_steps,
                    LR=lr, T0=t0, S_ACT=S, NB=STREAM_NB)
    P = _build.ptr
    err = _build.kernel_fn("ggp_z_adam_stream", X.dtype)(
        ctypes.cast(cfg, ctypes.c_void_p), P(thetas), *[P(a) for a in outs],
        P(X), P(y), P(losses), P(work), P(part), stream)
    _build.check(err, "z_adam_stream")
    return (*outs, losses)


def z_adam_stream(Z, m_z, v_z, thetas, X, y, jitter, *, t0, num_steps, lr):
    """The streamed Z chunk (site 8's function) at any n:
    :func:`z_adam_stream_plain` on CPU tensors; kernel 12
    (``csrc/z_adam_stream.cu``: per step five launches over the trace rows
    and row blocks) on CUDA tensors. :func:`z_adam_chunk` calls it past
    STREAM_MIN_N rows. Inputs are not modified."""
    _check_trace("z_adam_stream", thetas, X, y, Z)
    if X.device.type == "cpu":
        return z_adam_stream_plain(Z, m_z, v_z, thetas, X, y, jitter, t0=t0,
                                   num_steps=num_steps, lr=lr)
    _build.require_cuda("z_adam_stream", X.dtype, Z, m_z, v_z, thetas, X, y)
    out = _call_z_adam_stream(Z, m_z, v_z, thetas, X, y, jitter, float(t0),
                              int(num_steps), lr, _build.stream_ptr(X.device))
    _build.LAUNCHES["z_adam_stream"] += 1
    return out
