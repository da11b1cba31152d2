"""The collapsed Titsias bound of Scale(RBF-ARD) x Gaussian, in plain torch.

A frozen statement of the model the cells run, written from its equations
and batched over hyper rows:

    F(theta, Z) = log N(y | 0, Qnn + s2 I) - tr(Knn - Qnn) / (2 s2),
    Qnn = Knm (Kmm + jitter max(sf2, 1) I)^-1 Kmn,

with theta = [log lengthscales (d), log outputscale, log noise] and the
inverse lengthscales capped at 1024 / max(1e-3, max|X|, max|Z|). The sampler's
potential is U = -(F + log prior): Gamma(2, 1) on each lengthscale and
HalfCauchy(1) on the standard deviations sqrt(sf2) and sqrt(s2), each with its
log-Jacobian to the log scale. The trainers minimise -F. Gradients come from
autograd.
"""

from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["neg_elbo", "neg_logpost", "neg_logpost_vg", "log_prior", "predict", "precision",
           "mm"]

_INV_LS_CAP = 1024.0


# the precision of the matrix products: None (the tensors' own), "tf32" or
# "bf16" (the control's); set by ``precision``
_PRODUCTS = {"mode": None}
_DROPPED_BITS = {"tf32": 13, "bf16": 16}     # of float32's 23 mantissa bits


@contextlib.contextmanager
def precision(mode):
    """Every matrix product with its float32 factors rounded to TF32's
    10-bit (``"tf32"``) or bfloat16's 7-bit (``"bf16"``) mantissa and summed
    in float32, as tensor cores do, or (None) in the tensors' own precision.
    The rounding is done here, so it holds whatever kernel the library picks."""
    was = _PRODUCTS["mode"]
    _PRODUCTS["mode"] = mode
    try:
        yield
    finally:
        _PRODUCTS["mode"] = was


def _round(x, bits):
    """float32 x with its mantissa rounded to 23 - bits bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    half = (1 << (bits - 1)) - 1
    i = (i + half + ((i >> bits) & 1)) & ~((1 << bits) - 1)
    return i.view(torch.float32)


class _RoundedMM(torch.autograd.Function):
    """a @ b with both factors rounded, and so the products of its backward."""

    @staticmethod
    def forward(ctx, a, b, bits):
        ctx.save_for_backward(a, b)
        ctx.bits = bits
        return _round(a, bits) @ _round(b, bits)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round(g, ctx.bits)
        return (g @ _round(b, ctx.bits).transpose(-1, -2),
                _round(a, ctx.bits).transpose(-1, -2) @ g, None)


def mm(a, b):
    """a @ b in the precision ``precision`` sets."""
    mode = _PRODUCTS["mode"]
    if mode:
        return _RoundedMM.apply(a, b, _DROPPED_BITS[mode])
    return a @ b


def _chol(K, floor=None):
    """Lower Cholesky factor of each matrix of K. Without ``floor`` (R,), NaN
    where one is not positive definite (a sampler reads that as a
    divergence). With it, the trainers' modified Cholesky: a pivot below its
    matrix's floor becomes sqrt(floor) and its column is not eliminated."""
    L, info = torch.linalg.cholesky_ex(K)
    if floor is None:
        return torch.where((info > 0)[:, None, None], torch.full_like(L, math.nan), L)
    d2 = torch.diagonal(L, dim1=1, dim2=2) ** 2
    if not bool(((info == 0) & (d2 >= floor[:, None]).all(-1)).all()):
        L = _floored_chol(K, floor)
    return L


def _floored_chol(K, floor):
    m = K.shape[-1]
    P, cols = K, []
    for i in range(m):
        dp = P[:, 0, 0]
        good = dp >= floor
        root = torch.sqrt(torch.where(good, dp, floor))
        col = torch.where(good[:, None], P[:, :, 0] / root[:, None],
                          torch.nn.functional.pad(root[:, None], (0, m - i - 1)))
        P = P[:, 1:, 1:] - torch.where(good[:, None, None],
                                       col[:, 1:, None] * col[:, None, 1:], 0.0)
        cols.append(torch.nn.functional.pad(col, (i, 0)))
    return torch.stack(cols, -1)


def _grams(theta, X, Z):
    """(Knm (R, n, m), Kmm (R, m, m), sf2 (R,), s2 (R,)) for hyper rows
    theta (R, d+2) and inducing points Z (R, m, d)."""
    d = X.shape[1]
    scale = torch.maximum(X.abs().max(), Z.abs().amax(dim=(1, 2)))
    inv_ls = torch.minimum(torch.exp(-theta[:, :d]),
                           _INV_LS_CAP / torch.clamp(scale, min=1e-3)[:, None])
    sf2, s2 = torch.exp(theta[:, d]), torch.exp(theta[:, d + 1])
    Xs = X[None] * inv_ls[:, None, :]
    Zs = Z * inv_ls[:, None, :]
    xn, zn = (Xs * Xs).sum(-1), (Zs * Zs).sum(-1)

    def rbf(an, bn, A, B):
        r2 = an[:, :, None] + bn[:, None, :] - 2.0 * mm(A, B.transpose(1, 2))
        return sf2[:, None, None] * torch.exp(-0.5 * torch.clamp(r2, min=0.0))

    return rbf(xn, zn, Xs, Zs), rbf(zn, zn, Zs, Zs), sf2, s2


def neg_elbo(theta, X, y, Z, jitter, pivot_floor=None):
    """-F for each hyper row: theta (R, d+2), Z (R, m, d) or (m, d). With
    ``pivot_floor`` (the trainers'), the factorisations are the modified
    Cholesky with that floor (on Kmm relative to max(sf2, 1))."""
    n = X.shape[0]
    if Z.ndim == 2:
        Z = Z.expand(theta.shape[0], *Z.shape)
    Knm, Kmm, sf2, s2 = _grams(theta, X, Z)
    m = Kmm.shape[-1]
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    scale = torch.clamp(sf2, min=1.0)
    floors = (None, None) if pivot_floor is None else (pivot_floor * scale,
                                                       torch.full_like(scale, pivot_floor))
    L = _chol(Kmm + (jitter * scale)[:, None, None] * eye, floors[0])
    sigma = torch.sqrt(s2)[:, None, None]
    A = torch.linalg.solve_triangular(L, Knm.transpose(1, 2), upper=False) / sigma
    LB = _chol(eye + mm(A, A.transpose(1, 2)), floors[1])
    c = torch.linalg.solve_triangular(LB, mm(A, y[None, :, None].expand(A.shape[0], -1, 1)),
                                   upper=False)[..., 0] / sigma[..., 0]
    F = (-0.5 * n * torch.log(2.0 * math.pi * s2)
         - torch.log(torch.diagonal(LB, dim1=1, dim2=2)).sum(-1)
         - 0.5 * ((y * y).sum() / s2 - (c * c).sum(-1))
         - 0.5 * (n * sf2 - s2 * (A * A).sum((1, 2))) / s2)
    return -F


def _half_cauchy_std(u, scale=1.0):
    """log density of u = log(std^2) when std ~ HalfCauchy(scale)."""
    sd = torch.exp(0.5 * u)
    return (math.log(2.0 / (math.pi * scale)) - torch.log1p((sd / scale) ** 2)
            + 0.5 * u + math.log(0.5))


def log_prior(theta):
    """log p(theta) of the default prior tree, log-Jacobians included."""
    d = theta.shape[1] - 2
    u = theta[:, :d]
    alpha, beta = 2.0, 1.0
    lp_ls = (alpha * math.log(beta) - math.lgamma(alpha) + alpha * u - beta * torch.exp(u)).sum(1)
    return lp_ls + _half_cauchy_std(theta[:, d]) + _half_cauchy_std(theta[:, d + 1])


def neg_logpost(theta, X, y, Z, jitter):
    """The sampler's potential U = -(F + log prior) per hyper row."""
    return neg_elbo(theta, X, y, Z, jitter) - log_prior(theta)


def neg_logpost_vg(theta, X, y, Z, jitter):
    """(U (R,), dU/dtheta (R, d+2)) by autograd."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        U = neg_logpost(th, X, y, Z, jitter)
        (g,) = torch.autograd.grad(U.sum(), th)
    return U.detach(), g


def predict(theta, X, y, Z, jitter, X_test):
    """The SGPR predictive of each hyper row at X_test: means and marginal
    variances with the observation noise, (R, n_test) each."""
    R = theta.shape[0]
    d = X.shape[1]
    Zr = Z.expand(R, *Z.shape)
    m = Z.shape[0]
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    inv_ls = torch.exp(-theta[:, :d])
    sf2, s2 = torch.exp(theta[:, d]), torch.exp(theta[:, d + 1])

    def rbf(A, B):
        As, Bs = A * inv_ls[:, None, :], B * inv_ls[:, None, :]
        r2 = ((As * As).sum(-1)[:, :, None] + (Bs * Bs).sum(-1)[:, None, :]
              - 2.0 * mm(As, Bs.transpose(1, 2)))
        return sf2[:, None, None] * torch.exp(-0.5 * torch.clamp(r2, min=0.0))

    Xr, Xt = X.expand(R, *X.shape), X_test.expand(R, *X_test.shape)
    Kmm = rbf(Zr, Zr) + (jitter * torch.clamp(sf2, min=1.0))[:, None, None] * eye
    L = _chol(Kmm)
    sigma = torch.sqrt(s2)[:, None, None]
    A = torch.linalg.solve_triangular(L, rbf(Zr, Xr), upper=False) / sigma
    LB = _chol(eye + mm(A, A.transpose(1, 2)))
    c = torch.linalg.solve_triangular(LB, mm(A, y[None, :, None].expand(R, -1, 1)),
                                   upper=False) / sigma
    t1 = torch.linalg.solve_triangular(L, rbf(Zr, Xt), upper=False)
    t2 = torch.linalg.solve_triangular(LB, t1, upper=False)
    mean = (t2 * c).sum(1)
    var = sf2[:, None] - (t1 * t1).sum(1) + (t2 * t2).sum(1)
    return mean, torch.clamp(var, min=1e-12) + s2[:, None]
