"""Sufficient statistics of the collapsed VFE bound for stationary kernels:
plain PyTorch beside the CUDA kernels ``vfe_stats_fwd`` (kernel 10) and
``vfe_stats_bwd`` (kernel 11).

Counterpart of ``ggp_tpu/ops/pallas_vfe.py``. For Scale(<family>) with
outputscale os and lengthscales ls, over the rows of X (or the rows ``idx``
of X):

    S_kk = Kmn Knm (M, M),  S_ky = Kmn y (M),  s_kdiag = os n,  s_yy = y^T y.

Every function carries a leading chain dimension C on Z, the lengthscales
and the outputscale; X and y are shared, and ``idx`` (C, B) picks each
chain's minibatch rows, gathered inside the kernel. The kernels work in
scaled coordinates (``Zs = Z / ls``, ``inv_ls = 1 / ls``; the rows of X are
scaled inside them); :func:`stationary_vfe_stats` applies the chain rules
back to (Z, log_ls, log_os) as the JAX package's ``_stats_bwd`` does:
dZ = dzs / ls, dlog_ls = -2 term (summed for a scalar lengthscale),
dlog_os = (dos + ct[s_kdiag] n) os.

CPU tensors run the plain versions; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["FAMILIES", "stationary_vfe_stats", "vfe_stats_fwd", "vfe_stats_fwd_plain",
           "vfe_stats_bwd", "vfe_stats_bwd_plain", "stats_ops"]

FAMILIES = ("rbf", "matern12", "matern32", "matern52")
_TILE, _ROWS_FWD, _ROWS_BWD = 128, 32, 16      # csrc/vfe_stats.cu
_PLAIN_ROWS = 1024                              # rows per block of the plain versions
_SMEM_MAX = 227 * 1024                          # opt-in shared memory of one block (sm_90)


def _k_of_d2(d2, os, fam):
    if fam == "rbf":
        return os * torch.exp(-0.5 * d2)
    r = torch.sqrt(d2)
    if fam == "matern12":
        return os * torch.exp(-r)
    if fam == "matern32":
        s = math.sqrt(3.0) * r
        return os * (1.0 + s) * torch.exp(-s)
    if fam == "matern52":
        s = math.sqrt(5.0) * r
        return os * (1.0 + s + (5.0 / 3.0) * d2) * torch.exp(-s)
    raise ValueError(fam)


def _dk_dd2(d2, k, os, fam):
    """dk / d(d2); the Matern gradients are zero at d2 == 0 (coincident
    points), as the JAX package's grad-safe distance makes them."""
    if fam == "rbf":
        return -0.5 * k
    r = torch.sqrt(d2)
    pos = (d2 > 0.0).to(d2.dtype)
    if fam == "matern12":
        return -os * torch.exp(-r) / (2.0 * torch.clamp(r, min=1e-12)) * pos
    if fam == "matern32":
        return -1.5 * os * torch.exp(-math.sqrt(3.0) * r) * pos
    if fam == "matern52":
        s = math.sqrt(5.0) * r
        return -(5.0 / 6.0) * os * (1.0 + s) * torch.exp(-s) * pos
    raise ValueError(fam)


def _blocks(X, y, Zs, inv_ls, os, idx, c, fam, rows):
    """(xs, y, d2, k) of chain c over blocks of ``rows`` rows. d2 sums the
    squared differences, so it is exactly 0 at coincident points (the norm
    expansion leaves roundoff there, which the Matern-1/2 square root
    amplifies to ~1e-3 of k in float32)."""
    n = X.shape[0] if idx is None else idx.shape[1]
    for r0 in range(0, n, rows):
        sel = slice(r0, r0 + rows) if idx is None else idx[c, r0:r0 + rows]
        xs = X[sel] * inv_ls[c]
        d2 = ((xs[:, None, :] - Zs[c][None, :, :]) ** 2).sum(-1)
        yield xs, y[sel], d2, _k_of_d2(d2, os[c], fam)


def vfe_stats_fwd_plain(X, y, Zs, inv_ls, os, idx=None, fam="rbf", bf16=False):
    """(S_kk (C, M, M), S_ky (C, M)): the gram of each row block, then the
    products; with ``bf16`` the S_kk product's inputs are rounded to
    bfloat16."""
    C, M, _ = Zs.shape
    S_kk = Zs.new_zeros((C, M, M))
    S_ky = Zs.new_zeros((C, M))
    for c in range(C):
        for _, yb, _, k in _blocks(X, y, Zs, inv_ls, os, idx, c, fam, _PLAIN_ROWS):
            kr = k.to(torch.bfloat16).to(k.dtype) if bf16 else k
            S_kk[c] += kr.T @ kr
            S_ky[c] += k.T @ yb
    return S_kk, S_ky


def vfe_stats_bwd_plain(X, y, Zs, inv_ls, os, idx, gsym, dsky, fam="rbf"):
    """The scaled-coordinate cotangents (dzs (C, M, D), term (C, D), dos
    (C,)) of a functional with dS_kk + dS_kk^T = ``gsym`` and dS_ky =
    ``dsky``: dk = y dsky^T + k gsym, w = dk/dd2 * dk, dzs = -2 sum_r w
    (xs_r - zs), term = sum w (xs_r - zs)^2, dos = sum k dk / os."""
    C, M, D = Zs.shape
    dzs = Zs.new_zeros((C, M, D))
    term = Zs.new_zeros((C, D))
    dos = Zs.new_zeros(C)
    for c in range(C):
        for xs, yb, d2, k in _blocks(X, y, Zs, inv_ls, os, idx, c, fam, _PLAIN_ROWS):
            dk = yb[:, None] * dsky[c][None, :] + k @ gsym[c]
            dos[c] += (k * dk).sum() / os[c]
            w = _dk_dd2(d2, k, os[c], fam) * dk
            diff = xs[:, None, :] - Zs[c][None, :, :]
            wd = w[..., None] * diff
            dzs[c] += -2.0 * wd.sum(0)
            term[c] += (wd * diff).sum((0, 1))
    return dzs, term, dos


def _grid(X, C, n, per_chain_tiles, rows):
    """Blocks per chain: about four per SM over the C (x tiles) grids, at
    most one per row tile."""
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    ntiles = max(1, -(-n // rows))
    return max(1, min(ntiles, -(-4 * sms // (C * per_chain_tiles))))


def _cfg(X, n, M, D, C, G, fam, idx, T, bf16):
    return (ctypes.c_longlong * 10)(X.shape[0], n, M, D, C, G, FAMILIES.index(fam),
                                    int(idx is not None), T, int(bf16))


def _check(name, X, y, Zs, inv_ls, os, idx, fam):
    if fam not in FAMILIES:
        raise ValueError(f"{name}: family {fam!r} is not one of {FAMILIES}")
    C, M, D = Zs.shape
    if X.ndim != 2 or X.shape[1] != D or y.shape != (X.shape[0],) \
            or inv_ls.shape != (C, D) or os.shape != (C,):
        raise ValueError(f"{name}: shapes X {tuple(X.shape)}, y {tuple(y.shape)}, Zs "
                         f"{tuple(Zs.shape)}, inv_ls {tuple(inv_ls.shape)}, os "
                         f"{tuple(os.shape)} do not agree")
    if idx is not None and (idx.ndim != 2 or idx.shape[0] != C):
        raise ValueError(f"{name}: idx must be (C, B), got {tuple(idx.shape)}")


def _require(name, X, y, Zs, inv_ls, os, idx, *more):
    _build.require_cuda(name, X.dtype, X, y, Zs, inv_ls, os, *more)
    if idx is not None:
        if idx.dtype != torch.int64 or idx.device != X.device or not idx.is_contiguous():
            raise ValueError(f"{name}: idx must be a contiguous int64 tensor on {X.device}")


def vfe_stats_fwd(X, y, Zs, inv_ls, os, idx=None, fam="rbf", bf16=False):
    """:func:`vfe_stats_fwd_plain` on CPU tensors; kernel 10
    (``csrc/vfe_stats.cu``) on CUDA tensors."""
    _check("vfe_stats_fwd", X, y, Zs, inv_ls, os, idx, fam)
    if X.device.type == "cpu":
        return vfe_stats_fwd_plain(X, y, Zs, inv_ls, os, idx, fam, bf16)
    _require("vfe_stats_fwd", X, y, Zs, inv_ls, os, idx)
    C, M, D = Zs.shape
    n = X.shape[0] if idx is None else idx.shape[1]
    T = -(-M // _TILE)
    smem = X.element_size() * (_ROWS_FWD * D + _ROWS_FWD + 2 * _ROWS_FWD * _TILE)
    if smem > _SMEM_MAX:
        raise NotImplementedError(f"vfe_stats_fwd: D={D} needs {smem} B of shared memory")
    G = _grid(X, C, n, T * T, _ROWS_FWD)
    part = torch.empty(C * G * (M * M + M), dtype=X.dtype, device=X.device)
    S_kk = torch.empty((C, M, M), dtype=X.dtype, device=X.device)
    S_ky = torch.empty((C, M), dtype=X.dtype, device=X.device)
    P = _build.ptr
    err = _build.kernel_fn("ggp_vfe_stats_fwd", X.dtype)(
        ctypes.cast(_cfg(X, n, M, D, C, G, fam, idx, T, bf16), ctypes.c_void_p), P(X), P(y),
        P(Zs), P(inv_ls), P(os), P(idx), P(part), P(S_kk), P(S_ky),
        _build.stream_ptr(X.device))
    _build.check(err, "vfe_stats_fwd")
    _build.LAUNCHES["vfe_stats_fwd"] += 1
    return S_kk, S_ky


def vfe_stats_bwd(X, y, Zs, inv_ls, os, idx, gsym, dsky, fam="rbf"):
    """:func:`vfe_stats_bwd_plain` on CPU tensors; kernel 11
    (``csrc/vfe_stats.cu``) on CUDA tensors."""
    _check("vfe_stats_bwd", X, y, Zs, inv_ls, os, idx, fam)
    if X.device.type == "cpu":
        return vfe_stats_bwd_plain(X, y, Zs, inv_ls, os, idx, gsym, dsky, fam)
    _require("vfe_stats_bwd", X, y, Zs, inv_ls, os, idx, gsym, dsky)
    C, M, D = Zs.shape
    n = X.shape[0] if idx is None else idx.shape[1]
    smem = X.element_size() * (_ROWS_BWD * D + _ROWS_BWD + 2 * _ROWS_BWD * M)
    if smem > _SMEM_MAX:
        raise NotImplementedError(f"vfe_stats_bwd: M={M}, D={D} need {smem} B of shared "
                                  "memory")
    G = _grid(X, C, n, 1, _ROWS_BWD)
    part = torch.empty(C * G * (2 * M * D + 1 + D), dtype=X.dtype, device=X.device)
    dzs = torch.empty((C, M, D), dtype=X.dtype, device=X.device)
    term = torch.empty((C, D), dtype=X.dtype, device=X.device)
    dos = torch.empty(C, dtype=X.dtype, device=X.device)
    P = _build.ptr
    err = _build.kernel_fn("ggp_vfe_stats_bwd", X.dtype)(
        ctypes.cast(_cfg(X, n, M, D, C, G, fam, idx, 1, False), ctypes.c_void_p), P(X),
        P(y), P(Zs), P(inv_ls), P(os), P(idx), P(gsym), P(dsky), P(part), P(dzs), P(term),
        P(dos), _build.stream_ptr(X.device))
    _build.check(err, "vfe_stats_bwd")
    _build.LAUNCHES["vfe_stats_bwd"] += 1
    return dzs, term, dos


class _Stats(torch.autograd.Function):
    """(S_kk, S_ky) of (Z (C, M, D), log_ls (C, D), log_os (C,)); the
    backward launches kernel 11 and applies the chain rules."""

    @staticmethod
    def forward(ctx, Z, log_ls, log_os, X, y, idx, fam, bf16):
        inv_ls = torch.exp(-log_ls).contiguous()
        os = torch.exp(log_os).contiguous()
        Zs = (Z * inv_ls[:, None, :]).contiguous()
        ctx.save_for_backward(X, y, Zs, inv_ls, os, idx)
        ctx.fam = fam
        return vfe_stats_fwd(X, y, Zs, inv_ls, os, idx, fam, bf16)

    @staticmethod
    def backward(ctx, g_kk, g_ky):
        X, y, Zs, inv_ls, os, idx = ctx.saved_tensors
        if g_kk is None:
            g_kk = Zs.new_zeros((Zs.shape[0], Zs.shape[1], Zs.shape[1]))
        if g_ky is None:
            g_ky = Zs.new_zeros(Zs.shape[:2])
        gsym = (g_kk + g_kk.transpose(-1, -2)).contiguous()
        dzs, term, dos = vfe_stats_bwd(X, y, Zs, inv_ls, os, idx, gsym, g_ky.contiguous(),
                                       ctx.fam)
        return (dzs * inv_ls[:, None, :], -2.0 * term, dos * os,
                None, None, None, None, None)


def stationary_vfe_stats(X, y, Z, log_ls, log_os, *, fam="rbf", bf16=False, idx=None):
    """The VFE statistics of Scale(<fam>) over the rows of X, or the rows
    ``idx`` of X: a dict of ``S_kk``, ``S_ky``, ``s_kdiag = os n`` and
    ``s_yy``, as the JAX package's ``vfe_stats`` returns, differentiable in
    Z, log_ls and log_os (X and y are data).

    One chain: log_os (), log_ls () or (D,), Z (M, D), idx (B,). C chains:
    log_os (C,), log_ls (C,) or (C, D), Z (M, D) shared or (C, M, D), idx
    (B,) shared or (C, B); every statistic gains the leading C."""
    batched = log_os.ndim == 1
    los = log_os if batched else log_os.reshape(1)
    C = los.shape[0]
    D = X.shape[1]
    lls = log_ls if batched else log_ls.reshape(1, *log_ls.shape)
    lls = lls[:, None].expand(C, D) if lls.ndim == 1 else lls
    Zb = Z if Z.ndim == 3 else Z.expand(C, *Z.shape)
    ib = idx
    if idx is not None:
        ib = (idx if idx.ndim == 2 else idx.expand(C, idx.shape[-1])).contiguous()
    S_kk, S_ky = _Stats.apply(Zb.contiguous(), lls, los, X, y, ib, fam, bf16)
    n = X.shape[0] if idx is None else ib.shape[1]
    s_yy = (y * y).sum().expand(C) if idx is None else (y[ib] ** 2).sum(-1)
    out = {"S_kk": S_kk, "S_ky": S_ky, "s_kdiag": torch.exp(los) * n, "s_yy": s_yy}
    return out if batched else {k: v[0] for k, v in out.items()}


def stats_ops(n, m, d, fam="rbf", backward=False):
    """The least floating-point operations of one chain's forward (or
    backward) statistics over n rows, M = m, D = d: a multiply-add is 2,
    exp/sqrt/divide 1 each, a symmetric result counted once per pair.
    Forward: the scaled rows and their norms (3 n d), the cross products
    and d2 (n m (2 d + 3)), k (n m (2 + family)), the upper triangle of
    Kmn Knm (n m (m + 1)) and Kmn y (2 n m). Backward: the same k, dk =
    y dS_ky^T + k g (n m (2 m + 2)), w (n m (2 + family)), k dk (2 n m), and
    per (row, column, dim) the difference, w (xs - zs) and its square into
    dzs and term (5 n m d)."""
    per = {"rbf": 2, "matern12": 2, "matern32": 5, "matern52": 8}[fam]
    k = 3 * n * d + n * m * (2 * d + 3) + n * m * (2 + per)
    if not backward:
        return float(k + n * m * (m + 1) + 2 * n * m)
    return float(k + n * m * (2 * m + 2) + n * m * (2 + per) + 2 * n * m + 5 * n * m * d)
