"""Whole chunks of Adam steps on the collapsed bound: plain PyTorch beside
the CUDA kernels ``sgpr_adam_chunk`` (kernel 3: one block; kernel 3g: the
grouped vfe core, which ``sgpr_adam_chunk`` runs past ``GROUP_MIN_N`` rows)
and ``z_adam_stream`` (kernel 12), which ``z_adam_chunk`` runs on the card at
every n.

Counterparts of ``ggp_tpu/ops/fused_sgpr.py`` ``_sgpr_chunk_body`` and
``_sgpr_stream_chunk_body`` (the warm start's (theta, Z) trainer, resident
and streamed past 2048 rows) and ``_zadam_chunk_body`` (optimize_Z's
Z-only trainer over a hyper trace; the JAX package's two pallas_calls are
resident up to ``STREAM_MIN_N`` rows and streamed over row blocks past it;
on the card kernel 12 computes both),
and of ``ops/fused_svi.py`` ``_adam_update``. They train -ELBO without the
prior, with the trainers' modified Cholesky (pivot floor 1e-6). Inputs are
unpadded: ``theta`` (d+2,), ``Z`` (m, d), a trace ``thetas`` (S, d+2).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, vfe_group
from .linalg import capped_inv_ls, chol_upper
from .vfe_bound import _check_shapes, bound_cfg, rbf_vfe_neg_logpost_vg

__all__ = ["adam_update", "sgpr_adam_chunk_plain", "sgpr_adam_chunk", "sgpr_adam_group_plain",
           "trainer_route", "call_sgpr_adam", "GROUP_MIN_N",
           "z_adam_chunk_plain", "z_adam_chunk", "stream_neg_elbo_vg",
           "z_adam_stream_plain", "z_adam_stream", "PIVOT_FLOOR", "STREAM_MIN_N",
           "STREAM_NB"]

PIVOT_FLOOR = 1e-6
_BOX = 15.0
# the JAX package streams optimize_Z past this many rows (``make_fused_z_adam``:
# n > 2048); the plain versions here route by it; kernel 12 takes row
# blocks of STREAM_NB
STREAM_MIN_N = 2048
STREAM_NB = 256
# the JAX package streams the warm start past this many rows (``make_fused_sgpr``:
# n > 2048); on the card ``sgpr_adam_chunk`` takes the grouped trainer there
GROUP_MIN_N = 2048


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


def sgpr_adam_group_plain(theta, Z, m_th, v_th, m_z, v_z, X, y, jitter, G, *,
                          t0, num_steps, lr, clip_norm, min_noise=1e-4):
    """The grouped trainer (kernel 3g, ``csrc/sgpr_adam.cu``) in plain
    PyTorch, step for step in its order: each step's evaluation is
    ``vfe_group.group_neg_logpost_vg`` on G row blocks; the masked squares
    of dU/dZ summed in double per slice (block p's entries m d p / G .. m d
    (p + 1) / G - 1), the G slice sums in the order p = 0 .. G-1, then
    theta's; the same clip, Adam step, box and noise floor as
    :func:`sgpr_adam_chunk_plain`, which it computes. Returns what that
    does."""
    d = X.shape[1]
    dev, dt = X.device, X.dtype
    md = Z.numel()
    is_noise = torch.arange(d + 2, device=dev) == d + 1
    log_floor = math.log(min_noise)
    losses = []
    for t in range(int(num_steps)):
        loss, gt, gZ = vfe_group.group_neg_logpost_vg(
            theta, X, y, Z, jitter, G, want_z_grad=True, want_prior=False,
            pivot_floor=PIVOT_FLOOR)
        gt, gZ = _finite(gt), _finite(gZ)
        flat = gZ.reshape(-1).to(torch.float64)
        gn2 = torch.zeros((), dtype=torch.float64, device=dev)
        for p in range(G):
            sl = flat[md * p // G:md * (p + 1) // G]
            gn2 = gn2 + (sl * sl).sum()
        gn2 = gn2 + (gt.to(torch.float64) ** 2).sum()
        sc = torch.clamp(clip_norm / torch.sqrt(gn2).to(dt), max=1.0)
        ta = torch.as_tensor(t0 + t + 1.0, dtype=dt, device=dev)
        theta, m_th, v_th = adam_update(theta, gt * sc, m_th, v_th, ta, lr)
        Z, m_z, v_z = adam_update(Z, gZ * sc, m_z, v_z, ta, lr)
        theta = torch.clamp(theta, -_BOX, _BOX)
        theta = torch.where(is_noise, torch.clamp(theta, min=log_floor), theta)
        losses.append(loss)
    return theta, Z, m_th, v_th, m_z, v_z, torch.stack(losses)


def trainer_route(n: int) -> str:
    """The warm-start kernel for n rows on the card: ``"group"`` (kernel 3g,
    the grouped vfe core) past ``GROUP_MIN_N``, where the JAX package
    streams its trainer, else ``"block"`` (kernel 3, one block)."""
    return "group" if n > GROUP_MIN_N else "block"


def trainer_scratch(n, m, d, G, like):
    """The grouped trainer's scratch (the count from the C side), its
    barrier zeroed."""
    elems = int(_build.build().ggp_sgpr_adam_group_elems(n, m, d, G,
                                                         int(like.dtype == torch.float64)))
    work = torch.empty(elems, dtype=like.dtype, device=like.device)
    work[:128 // like.element_size()].zero_()
    return work


def call_sgpr_adam(kernel, theta, Z, m_th, v_th, m_z, v_z, X, y, jitter, *, t0,
                   num_steps, lr, clip_norm, min_noise=1e-4):
    """One launch of the warm-start kernel ``kernel`` ("block": kernel 3 on
    one block; "group": kernel 3g, launched cooperatively on G blocks, all
    the card holds) on CUDA tensors; counts no launch (the wrapper
    :func:`sgpr_adam_chunk` does). Returns (theta, Z, m_th, v_th, m_z, v_z,
    losses); the inputs are not modified."""
    n, d = X.shape
    m = Z.shape[0]
    outs = [a.clone() for a in (theta, Z, m_th, v_th, m_z, v_z)]
    losses = torch.empty(int(num_steps), dtype=X.dtype, device=X.device)
    extra = {}
    if kernel == "group":
        G = vfe_group.geometry("sgpr_adam", X.dtype, 1, X.device)
        work, extra = trainer_scratch(n, m, d, G, X), {"GROUP": G}
    else:
        work = _build.scratch(n, m, d, m * d, X)
    cfg = bound_cfg(n, m, d, jitter, want_z_grad=True, want_prior=False,
                    pivot_floor=PIVOT_FLOOR, prior_spec=None, K=int(num_steps),
                    LR=lr, CLIP=clip_norm, MIN_NOISE=min_noise, T0=float(t0), **extra)
    P = _build.ptr
    name = "ggp_sgpr_adam_group" if kernel == "group" else "ggp_sgpr_adam"
    err = _build.kernel_fn(name, X.dtype)(
        ctypes.cast(cfg, ctypes.c_void_p), *[P(a) for a in outs], P(X), P(y),
        P(losses), P(work), _build.stream_ptr(X.device))
    _build.check(err, name)
    return (*outs, losses)


def sgpr_adam_chunk(theta, Z, m_th, v_th, m_z, v_z, X, y, jitter, *, t0,
                    num_steps, lr, clip_norm, min_noise=1e-4):
    """:func:`sgpr_adam_chunk_plain` on CPU tensors; on CUDA tensors the
    whole chunk in one launch of the kernel :func:`trainer_route` names
    (``csrc/sgpr_adam.cu``: kernel 3 on one block up to ``GROUP_MIN_N``
    rows, kernel 3g on the grouped vfe core past it). Inputs are not
    modified."""
    _check_shapes("sgpr_adam_chunk", theta, X, y, Z)
    if X.device.type == "cpu":
        return sgpr_adam_chunk_plain(theta, Z, m_th, v_th, m_z, v_z, X, y,
                                     jitter, t0=t0, num_steps=num_steps,
                                     lr=lr, clip_norm=clip_norm,
                                     min_noise=min_noise)
    _build.require_cuda("sgpr_adam_chunk", X.dtype, theta, Z, m_th, v_th,
                        m_z, v_z, X, y)
    kernel = trainer_route(X.shape[0])
    out = call_sgpr_adam(kernel, theta, Z, m_th, v_th, m_z, v_z, X, y, jitter, t0=t0,
                         num_steps=num_steps, lr=lr, clip_norm=clip_norm,
                         min_noise=min_noise)
    _build.LAUNCHES["sgpr_adam_group" if kernel == "group" else "sgpr_adam_chunk"] += 1
    return out


def _check_trace(name, thetas, X, y, Z):
    _check_shapes(name, thetas[0], X, y, Z)
    if thetas.ndim != 2 or thetas.shape[0] < 1:
        raise ValueError(f"{name}: thetas must be (S >= 1, d+2)")


def z_adam_chunk(Z, m_z, v_z, thetas, X, y, jitter, *, t0, num_steps, lr):
    """optimize_Z's chunk (sites 7 and 8 compute one function): on CUDA
    tensors :func:`z_adam_stream` (kernel 12) at every n; on CPU tensors
    :func:`z_adam_chunk_plain` up to ``STREAM_MIN_N`` rows and the streamed
    plain version past it, as the JAX package routes its two pallas_calls.
    Inputs are not modified."""
    if X.device.type != "cpu" or X.shape[0] > STREAM_MIN_N:
        return z_adam_stream(Z, m_z, v_z, thetas, X, y, jitter, t0=t0,
                             num_steps=num_steps, lr=lr)
    _check_trace("z_adam_chunk", thetas, X, y, Z)
    return z_adam_chunk_plain(Z, m_z, v_z, thetas, X, y, jitter, t0=t0,
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
    """The streamed Z chunk (sites 7 and 8's function) at any n:
    :func:`z_adam_stream_plain` on CPU tensors; kernel 12
    (``csrc/z_adam_stream.cu``: per step five launches over the trace rows
    and row blocks) on CUDA tensors. :func:`z_adam_chunk` calls it for every
    CUDA tensor and past STREAM_MIN_N rows on the CPU. Inputs are not
    modified."""
    _check_trace("z_adam_stream", thetas, X, y, Z)
    if X.device.type == "cpu":
        return z_adam_stream_plain(Z, m_z, v_z, thetas, X, y, jitter, t0=t0,
                                   num_steps=num_steps, lr=lr)
    _build.require_cuda("z_adam_stream", X.dtype, Z, m_z, v_z, thetas, X, y)
    out = _call_z_adam_stream(Z, m_z, v_z, thetas, X, y, jitter, float(t0),
                              int(num_steps), lr, _build.stream_ptr(X.device))
    _build.LAUNCHES["z_adam_stream"] += 1
    return out
