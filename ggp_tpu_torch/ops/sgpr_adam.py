"""Whole chunks of Adam steps on the collapsed bound: plain PyTorch beside
the CUDA kernels ``sgpr_adam_chunk`` (kernel 3) and ``z_adam_chunk``
(kernel 4).

Counterparts of ``ggp_tpu/ops/fused_sgpr.py`` ``_sgpr_chunk_body`` (the
warm start's (theta, Z) trainer) and ``_zadam_chunk_body`` (optimize_Z's
Z-only trainer over a hyper trace), and of ``ops/fused_svi.py``
``_adam_update``. Both train -ELBO without the prior, with the trainers'
modified Cholesky (pivot floor 1e-6). Inputs are unpadded: ``theta``
(d+2,), ``Z`` (m, d), a trace ``thetas`` (S, d+2).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .vfe_bound import _check_shapes, bound_cfg, rbf_vfe_neg_logpost_vg

__all__ = ["adam_update", "sgpr_adam_chunk_plain", "sgpr_adam_chunk",
           "z_adam_chunk_plain", "z_adam_chunk", "PIVOT_FLOOR"]

PIVOT_FLOOR = 1e-6
_BOX = 15.0


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


def z_adam_chunk(Z, m_z, v_z, thetas, X, y, jitter, *, t0, num_steps, lr):
    """:func:`z_adam_chunk_plain` on CPU tensors; kernel 4
    (``csrc/sgpr_adam.cu``) on CUDA tensors. Inputs are not modified."""
    _check_shapes("z_adam_chunk", thetas[0], X, y, Z)
    if thetas.ndim != 2 or thetas.shape[0] < 1:
        raise ValueError("z_adam_chunk: thetas must be (S >= 1, d+2)")
    if X.device.type == "cpu":
        return z_adam_chunk_plain(Z, m_z, v_z, thetas, X, y, jitter, t0=t0,
                                  num_steps=num_steps, lr=lr)
    _build.require_cuda("z_adam_chunk", X.dtype, Z, m_z, v_z, thetas, X, y)
    out = _call_z_adam(Z, m_z, v_z, thetas, X, y, jitter, float(t0),
                       int(num_steps), lr, _build.stream_ptr(X.device))
    _build.LAUNCHES["z_adam_chunk"] += 1
    return out
