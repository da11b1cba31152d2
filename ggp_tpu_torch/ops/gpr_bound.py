"""Dense GP marginal potential of the Scale(RBF-ARD) x Gaussian model (the
GPR_HMC target): value and analytic gradient, plain PyTorch beside the
``"gpr"`` core of the CUDA kernels (``csrc/gpr_bound.cuh``), which spreads
one evaluation over a group of thread blocks per chain;
:func:`gpr_group_neg_logpost_vg` is a plain model of that core's algorithm.

Counterpart of ``ggp_tpu/ops/fused_bound.py`` ``_gpr_neg_logpost_vg`` (the
core the fused sampler kernels run with ``target="gpr"``) and of
``make_gpr_potential``, on unpadded inputs: ``theta`` (d+2,) in ravel order
``[log_lengthscale (d), log_outputscale, log_noise]``, ``X`` (n, d), ``y``
(n,). The JAX core pads rows to a multiple of 128 for the TPU's lanes; the
port does not pad.

With K = Kcore + (s2 + jitter) I, the jitter ABSOLUTE (``add_jitter(...,
relative=False)``, as ``gp_marginal_loglik`` adds it), U = chol(K)^T, t =
U^-T y and a = K^-1 y = U^-1 t:

  F    = -(t.t + 2 sum log diag U + n log 2 pi) / 2
  Kbar = dF/dK = (a a^T - K^-1) / 2,   K^-1 = V V^T with V = U^-1
  dF/dlog_noise = s2 tr(Kbar),  P = Kbar o Kcore,  dF/dlog_os = sum P

then the RBF-ARD chain rule to the lengthscales and the closed-form priors
(``ops/vfe_bound.prior_terms``). A factorisation that meets a non-positive
pivot gives NaN, which the samplers read as a divergence.
"""

from __future__ import annotations

import math

import torch

from .linalg import capped_inv_ls, chol_upper

__all__ = ["gpr_neg_logpost_vg", "make_gpr_potential", "gpr_group_neg_logpost_vg", "TILE"]

_DIM_MAX = 128               # state row of the kernels (csrc kMaxDim)
TILE = 32                    # csrc/gpr_bound.cuh kGT: the tile edge b


def gpr_neg_logpost_vg(theta, X, y, jitter, *, prior_spec=None):
    """Plain PyTorch potential U = -(dense GP marginal log-likelihood + log
    prior) and dU/dtheta under the static prior spec (the default tree
    when None)."""
    from .vfe_bound import prior_terms
    n, d = X.shape
    dt, dev = X.dtype, X.device
    eye = torch.eye(n, dtype=dt, device=dev)
    inv_ls = capped_inv_ls(theta[:d], X)
    sf2 = torch.exp(theta[d])
    s2 = torch.exp(theta[d + 1])

    Xs = X * inv_ls
    Xs2 = Xs * Xs
    xn = Xs2.sum(1)
    Kcore = sf2 * torch.exp(-0.5 * torch.clamp(xn[:, None] + xn[None, :]
                                               - 2.0 * Xs @ Xs.T, min=0.0))
    U = chol_upper(Kcore + (s2 + jitter) * eye)                   # NaN if not PD
    V = torch.linalg.solve_triangular(U, eye, upper=True)         # U^-1
    t = torch.linalg.solve_triangular(U.T, y[:, None], upper=False)[:, 0]
    a = torch.linalg.solve_triangular(U, t[:, None], upper=True)[:, 0]
    logdet = 2.0 * torch.log(torch.diagonal(U)).sum()
    F = -0.5 * ((t * t).sum() + logdet + n * math.log(2.0 * math.pi))

    Kbar = 0.5 * (torch.outer(a, a) - V @ V.T)
    dlog_noise = s2 * torch.diagonal(Kbar).sum()
    P = Kbar * Kcore
    dlog_os = P.sum()
    dls = P.sum(1) @ Xs2 + P.sum(0) @ Xs2 - 2.0 * (Xs * (P @ Xs)).sum(0)

    lp, gp = prior_terms(theta, d, prior_spec)
    g = torch.cat([dls, dlog_os[None], dlog_noise[None]]) + gp
    return -(F + lp), -g


def make_gpr_potential(X, y, jitter: float, prior_spec=None):
    """Factory: ``potential_fn(theta) -> (U, dU/dtheta)`` for the dense
    GPR_HMC target (counterpart of ``fused_bound.make_gpr_potential``):
    the plain version on CPU tensors, the ``"gpr"`` potential kernel on
    CUDA tensors (``ops.vfe_bound.vfe_potential(core="gpr")``). Returns None
    when the state row d + 2 exceeds the kernels' 128 entries. Unlike the
    JAX package there is no row cap: the kernel's scratch is 3 n^2 values
    per chain in device memory."""
    from .vfe_bound import vfe_potential
    d = X.shape[1]
    if d + 2 > _DIM_MAX:
        return None
    Z = X.new_empty((0, d))
    jitter = float(jitter)

    def potential_fn(theta):
        return vfe_potential(theta, X, y, Z, jitter, prior_spec=prior_spec,
                             core="gpr")

    return potential_fn


def _tasks_by_block(total: int, G: int):
    """Task indices in the order the group runs them: block p = 0 .. G-1
    takes q = p, p + G, ... (the kernel runs the blocks at once)."""
    return [q for p in range(G) for q in range(p, total, G)]


def gpr_group_neg_logpost_vg(theta, X, y, jitter, G, tile=TILE, *, prior_spec=None):
    """The grouped gpr core's evaluation (``csrc/gpr_bound.cuh``) in plain
    PyTorch, step for step: the lower b x b tiles of K padded with the
    identity to nt b; steps s = 0 .. nt of the blocked right-looking
    Cholesky fused with the right-looking blocked inverse, each step's tile
    tasks run block by block (block p takes tasks p, p + G, ...) in place in
    the kernel's two arrays (A: K, then the inverse's work W in its consumed
    columns; L: the factor's columns, Linv(s, s) on its diagonal slots,
    then Linv's finished rows), so a task that read what another task of
    its step writes would make the result depend on G; t = Linv y and a =
    Linv^T t in double; per lower tile the partials of sum P, tr Kbar and
    the lengthscale sums (difference form) in double; the partials summed
    in tile order. Every sum runs over tiles in a fixed order, never over
    blocks, so U and dU/dtheta are the same for every G. Returns them as
    :func:`gpr_neg_logpost_vg` does."""
    from .vfe_bound import prior_terms
    n, d = X.shape
    dt, dev, f64 = X.dtype, X.device, torch.float64
    b = int(tile)
    nt = -(-n // b)
    npad = nt * b
    inv_ls = capped_inv_ls(theta[:d], X)
    sf2, s2 = torch.exp(theta[d]), torch.exp(theta[d + 1])
    Xs = X * inv_ls
    xn = (Xs * Xs).sum(1)
    Kcore = sf2 * torch.exp(-0.5 * torch.clamp(xn[:, None] + xn[None] - 2.0 * Xs @ Xs.T,
                                               min=0.0))
    A = torch.eye(npad, dtype=dt, device=dev)
    A[:n, :n] = Kcore + (s2 + jitter) * torch.eye(n, dtype=dt, device=dev)
    L = torch.zeros_like(A)
    ld = torch.zeros(npad, dtype=dt, device=dev)

    def T(M, i, j):
        return M[i * b:(i + 1) * b, j * b:(j + 1) * b]

    def factor(D):
        """The diagonal tile's factor (NaN on a non-positive pivot) and its
        inverse."""
        Lf = chol_upper(D).T
        return Lf, torch.linalg.solve_triangular(Lf, torch.eye(b, dtype=dt, device=dev),
                                                 upper=False)

    for s in range(nt + 1):
        nf = nt - s if s < nt else 0
        rr = nt - s - 1 if s < nt else 0
        ntr = rr * (rr + 1) // 2 if s >= 1 else 0
        k = s - 1
        nfin = k if s >= 1 else 0
        nupd = (nt - 1 - k) * (k + 1) if s >= 1 else 0
        total = nf + ntr + nfin + nupd
        if total == 0:
            break
        if nf:
            D = T(A, s, s) - (T(L, s, s - 1) @ T(L, s, s - 1).T if s >= 1 else 0.0)
            Lf, Li = factor(D)
        for q in _tasks_by_block(total, G):
            if q < nf:
                if q == 0:
                    T(L, s, s).copy_(Li)
                    ld[s * b:(s + 1) * b] = torch.log(torch.diagonal(Lf))
                    continue
                i = s + q
                U = T(A, i, s) - (T(L, i, s - 1) @ T(L, s, s - 1).T if s >= 1 else 0.0)
                T(L, i, s).copy_(U @ Li.T)
            elif q < nf + ntr:
                e = q - nf
                ii = int(((8 * e + 1) ** 0.5 - 1) / 2)
                while ii * (ii + 1) // 2 > e:
                    ii -= 1
                while (ii + 1) * (ii + 2) // 2 <= e:
                    ii += 1
                i, j = s + 1 + ii, s + 1 + e - ii * (ii + 1) // 2
                T(A, i, j).copy_(T(A, i, j) - T(L, i, s - 1) @ T(L, j, s - 1).T)
            elif q < nf + ntr + nfin:
                j = q - nf - ntr
                T(L, k, j).copy_(T(L, k, k) @ T(A, k, j))
            else:
                e = q - nf - ntr - nfin
                i, j = k + 1 + e // (k + 1), e % (k + 1)
                lkj = T(L, k, k) @ T(A, k, j) if j < k else T(L, k, k)
                W = T(A, i, j) if j < k else 0.0
                T(A, i, j).copy_(W - T(L, i, k) @ lkj)
    Linv = torch.tril(L)[:n, :n]          # L's lower tiles now hold Linv

    yp = y.to(f64)
    t = Linv.to(f64) @ yp
    a = Linv.to(f64).T @ t
    logdet = 2.0 * ld[:n].to(f64).sum()
    F = -0.5 * ((t * t).sum() + logdet + n * math.log(2.0 * math.pi))
    t, a = t.to(dt), a.to(dt)

    Kinv = Linv.T @ Linv
    Kbar = 0.5 * (torch.outer(a, a) - Kinv)
    P = Kbar * Kcore
    parts = []                            # per lower tile (I, J), in tile order
    for I in range(nt):
        for J in range(I + 1):
            ri, rj = slice(I * b, min((I + 1) * b, n)), slice(J * b, min((J + 1) * b, n))
            w = 2.0 if I > J else 1.0
            Pt = P[ri, rj].to(f64)
            tr = torch.diagonal(Kbar[ri, rj]).sum().to(f64) if I == J else Pt.new_zeros(())
            df = Xs[ri, None, :] - Xs[None, rj, :]
            parts.append(torch.cat([(w * Pt.sum())[None], tr[None],
                                    w * (Pt[..., None] * (df * df).to(f64)).sum((0, 1))]))
    tot = torch.zeros(d + 2, dtype=f64, device=dev)
    for v in parts:
        tot = tot + v
    tot = tot.to(dt)
    lp, gp = prior_terms(theta, d, prior_spec)
    g = torch.cat([tot[2:], tot[:1], (s2 * tot[1])[None]]) + gp
    return -(F.to(dt) + lp), -g
