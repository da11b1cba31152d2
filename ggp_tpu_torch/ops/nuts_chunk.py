"""K transitions of iterative multinomial NUTS on a sampler potential (the
collapsed bound, ``core="vfe"``, the whitened JointHMC target,
``core="sgpmc"``, the dense GP marginal, ``core="gpr"``, or the CO2
composite bound, ``core="co2_m32" | "co2_rbf"``): plain PyTorch beside the
CUDA kernel ``nuts_chunk`` (kernel 2); and one transition,
:func:`nuts_transition` (kernel 2b, cores "vfe" and "co2_*").

Counterpart of ``ggp_tpu/ops/fused_nuts.py`` ``_warm_chunk_kernel_body``
(``adapt=True``: dual averaging and Welford windows in the chunk) and
``_sample_chunk_kernel_body`` (``adapt=False``: fixed step size), both
built on ``_transition_inkernel``. Randomness comes in as slabs indexed
per step the way the JAX kernel indexes its own: momentum row t, tree
uniforms (t, depth, {direction, swap}), leaf uniforms (t, global leaf
index). :func:`draw_slabs` draws them from a ``torch.Generator``.
:func:`nuts_transition` is the counterpart of ``_nuts_kernel_body`` (the
``trans_call`` of ``make_fused_nuts``), which the JAX package's chunked
sampler driver calls once per transition.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import _build
from .vfe_bound import _check_shapes, bound_cfg, neg_logpost_vg

__all__ = ["ChainState", "draw_slabs", "nuts_chunk_plain", "nuts_chunk",
           "nuts_transition", "nuts_transition_plain", "launch_chunk", "as_batch",
           "first_chain",
           "DIVERGENCE_THRESHOLD", "MAX_DEPTH"]

DIVERGENCE_THRESHOLD = 1000.0
MAX_DEPTH = 10               # checkpoint slots of the kernel (csrc kMaxDepth)
STAT_FIELDS = ("potential", "accept_prob", "diverging", "depth",
               "n_leapfrog", "energy")


@dataclasses.dataclass
class ChainState:
    """Sampler state carried between chunks: position, potential and
    gradient, diagonal inverse mass, dual-averaging state (inference/hmc.py
    DAState) and Welford state. For one chain the scalars are 0-dim tensors
    and the vectors (dim,); for C chains (ops/multichain.py) every field
    has a leading chain axis: scalars (C,), vectors (C, dim)."""
    z: torch.Tensor
    U: torch.Tensor
    g: torch.Tensor
    inv_mass: torch.Tensor
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    t_da: torch.Tensor
    wf_mean: torch.Tensor
    wf_m2: torch.Tensor
    wf_count: torch.Tensor

    def clone(self) -> "ChainState":
        return ChainState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})


def as_batch(state: ChainState) -> ChainState:
    """One chain's state as a batch of one (a leading chain axis of 1)."""
    return ChainState(**{f.name: getattr(state, f.name).unsqueeze(0)
                         for f in dataclasses.fields(state)})


def first_chain(state: ChainState) -> ChainState:
    """Chain 0 of a batched state, without the chain axis."""
    return ChainState(**{f.name: getattr(state, f.name)[0]
                         for f in dataclasses.fields(state)})


def draw_slabs(K, dim, max_depth, generator, *, dtype, device):
    """(mom (K, dim), treeu (K, max_depth, 2), leafu (K, 2**max_depth))."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    return (torch.randn((K, dim), **kw),
            torch.rand((K, max_depth, 2), **kw),
            torch.rand((K, 1 << max_depth), **kw))


def _lae(a, b):
    mx = torch.maximum(a, b)
    return mx + torch.log1p(torch.exp(-torch.abs(a - b)))


def _log_unif(u):
    return torch.log(torch.clamp(u, min=1e-12))


def _trailing_ones(x: int) -> int:
    n = 0
    while x & 1:
        x >>= 1
        n += 1
    return n


def _transition(pot, z0, U0, g0, eps, inv_mass, mom, treeu, leafu, max_depth):
    """One NUTS transition (port of ``_transition_inkernel``). Returns
    (z, U, g, accept_prob, diverging, depth, n_leaves, H0)."""
    dt = z0.dtype

    def kinetic(r):
        return 0.5 * (inv_mass * r * r).sum()

    r0 = mom / torch.sqrt(inv_mass)
    H0 = U0 + kinetic(r0)
    left = [z0, r0, U0, g0]
    right = [z0, r0, U0, g0]
    zp, Up, gp = z0, U0, g0
    logw = torch.zeros((), dtype=dt, device=z0.device)
    acc = torch.zeros((), dtype=dt, device=z0.device)
    depth, nl, turning, diverging = 0, 0, False, False
    while not turning and not diverging and depth < max_depth:
        dirf = 1.0 if bool(treeu[depth, 0] < 0.5) else -1.0
        fwd = dirf > 0
        z, r, U, g = right if fwd else left
        qz, qU, qg = z, U, g
        eps_s = dirf * eps
        zc, vc = {}, {}
        slogw = torch.full((), -math.inf, dtype=dt, device=z0.device)
        sacc = torch.zeros((), dtype=dt, device=z0.device)
        i, sturn, sdiv = 0, False, False
        while i < (1 << depth) and not sturn and not sdiv:
            r_half = r - 0.5 * eps_s * g
            z = z + eps_s * inv_mass * r_half
            U, g = pot(z)
            r = r_half - 0.5 * eps_s * g
            v = inv_mass * r
            delta = U + kinetic(r) - H0
            delta = torch.where(torch.isnan(delta),
                                torch.full_like(delta, math.inf), delta)
            sdiv = bool(delta > DIVERGENCE_THRESHOLD)
            sacc = sacc + torch.clamp(torch.exp(-delta), max=1.0)
            lwn = _lae(slogw, -delta)
            if bool(_log_unif(leafu[nl + i]) < (-delta - lwn)):
                qz, qU, qg = z, U, g
            if i % 2 == 0:
                slot = bin(i).count("1")
                zc[slot], vc[slot] = z, v
            else:
                for mm in range(1, min(_trailing_ones(i), max_depth) + 1):
                    sj = bin(i - (1 << mm) + 1).count("1")
                    dz = dirf * (z - zc[sj])
                    if bool((dz * vc[sj]).sum() < 0) or bool((dz * v).sum() < 0):
                        sturn = True
            slogw = lwn
            i += 1
        ok = not sturn and not sdiv
        if ok and bool(_log_unif(treeu[depth, 1]) < (slogw - logw)):
            zp, Up, gp = qz, qU, qg
        if ok:
            logw = _lae(logw, slogw)
            if fwd:
                right = [z, r, U, g]
            else:
                left = [z, r, U, g]
        dz = right[0] - left[0]
        full_turn = bool((dz * inv_mass * left[1]).sum() < 0) or \
            bool((dz * inv_mass * right[1]).sum() < 0)
        turning = sturn or (ok and full_turn)
        diverging = sdiv
        acc = acc + sacc
        nl += i
        depth += 1
    accept = acc / max(nl, 1)
    return zp, Up, gp, accept, diverging, depth, nl, H0


def nuts_chunk_plain(state: ChainState, X, y, Z, jitter, *, mom, treeu, leafu,
                     n_active, adapt, eps=None, in_window=None,
                     window_end=None, max_depth=8, target_accept=0.8,
                     adapt_mass=True, prior_spec=None, core="vfe"):
    """``n_active`` (<= K) NUTS transitions from ``state`` on the potential
    of ``core``. With ``adapt``,
    the step size is exp(log_eps) and dual averaging plus the Welford
    windows (``in_window``/``window_end`` (K,) bools) run after each
    transition; otherwise the step size is ``eps``. Returns (new state,
    draws (K, dim), stats (K, 6) in the order of ``STAT_FIELDS``); rows of
    inactive steps are zero."""
    from ..inference.hmc import (DAState, WelfordState, da_update,
                                 welford_init, welford_update, welford_variance)
    K = mom.shape[0]
    dim = state.z.shape[0]
    s = state.clone()
    draws = torch.zeros((K, dim), dtype=X.dtype, device=X.device)
    stats = torch.zeros((K, 6), dtype=X.dtype, device=X.device)

    def pot(z):
        return neg_logpost_vg(core, z, X, y, Z, jitter, prior_spec=prior_spec)

    for t in range(int(n_active)):
        step = torch.exp(s.log_eps) if adapt else eps
        zp, Up, gp, accept, div, depth, nl, H0 = _transition(
            pot, s.z, s.U, s.g, step, s.inv_mass, mom[t], treeu[t], leafu[t],
            max_depth)
        s.z, s.U, s.g = zp, Up, gp
        if adapt:
            da = da_update(DAState(s.log_eps, s.log_eps_avg, s.h_avg, s.mu, s.t_da),
                           accept, target_accept)
            s.log_eps, s.log_eps_avg, s.h_avg, s.mu, s.t_da = da
            if adapt_mass:
                wf = WelfordState(s.wf_mean, s.wf_m2, s.wf_count)
                if bool(in_window[t]):
                    wf = welford_update(wf, zp)
                if bool(window_end[t]):       # window end: new mass, fresh DA
                    s.inv_mass = welford_variance(wf)
                    wf = welford_init(dim, dtype=X.dtype, device=X.device)
                    s.log_eps_avg = da.log_eps
                    s.mu = math.log(10.0) + da.log_eps
                    s.h_avg = torch.zeros_like(da.h_avg)
                    s.t_da = torch.zeros_like(da.t)
                s.wf_mean, s.wf_m2, s.wf_count = wf
        draws[t] = zp
        stats[t] = torch.stack([Up, accept, torch.as_tensor(float(div), dtype=X.dtype,
                                                            device=X.device),
                                torch.as_tensor(float(depth), dtype=X.dtype, device=X.device),
                                torch.as_tensor(float(nl), dtype=X.dtype, device=X.device),
                                H0])
    return s, draws, stats


_STATE = ("U", "log_eps", "log_eps_avg", "h_avg", "mu", "t_da", "wf_count")
S_LEN = 11                   # per-chain scalar state (csrc/stan_adapt.cuh S_LEN)


def launch_chunk(kind, core, state, X, y, Z, jitter, slabs, *, n_active, adapt,
                 eps, in_window, window_end, prior_spec, stream, **cfg_extra):
    """One launch of the sampler chunk kernel ``kind`` ("nuts_chunk",
    ``csrc/nuts_chunk.cu``, or "hmc_chunk", ``csrc/mc_hmc_chunk.cu``) of
    ``core`` on C chains, one block each: every field of ``state`` has a
    leading chain axis, ``slabs`` are the random slabs in the kernel's
    argument order, each (K, C, ...). Returns (new state, draws (K, C,
    dim), stats (K, C, 6)); ``state`` is not modified."""
    n, d = X.shape
    m = Z.shape[0]
    C, dim = state.z.shape
    K = slabs[0].shape[0]
    dev, dt = X.device, X.dtype
    scal = torch.zeros((C, S_LEN), dtype=dt, device=dev)
    scal[:, :7] = torch.stack([getattr(state, k).reshape(C) for k in _STATE], 1)
    scal[:, 7] = float(n_active)
    if eps is not None:
        scal[:, 8] = eps
    vecs = [v.clone(memory_format=torch.contiguous_format) for v in
            (state.z, state.g, state.inv_mass, state.wf_mean, state.wf_m2)]
    if in_window is None:
        flags = torch.zeros(2 * K, dtype=torch.int32, device=dev)
    else:
        flags = torch.cat([in_window, window_end]).to(device=dev, dtype=torch.int32)
    draws = torch.empty((K, C, dim), dtype=dt, device=dev)
    stats = torch.empty((K, C, 6), dtype=dt, device=dev)
    work = _build.scratch(n, m, d, 0, X, chains=C, core=core)
    cfg = bound_cfg(n, m, d, jitter, want_z_grad=False, want_prior=True,
                    pivot_floor=None, prior_spec=prior_spec, core=core, DIM=dim, K=K,
                    ADAPT=int(adapt), CHAINS=C, **cfg_extra)
    P = _build.ptr
    name = f"ggp_{kind}_{core}"
    err = _build.kernel_fn(name, dt)(
        ctypes.cast(cfg, ctypes.c_void_p), P(scal), *[P(v) for v in vecs],
        P(flags), *[P(s) for s in slabs], P(X), P(y), P(Z), P(draws),
        P(stats), P(work), stream)
    _build.check(err, name)
    cols = scal.T.contiguous()          # each field contiguous for the next launch
    new = ChainState(z=vecs[0], U=cols[0], g=vecs[1], inv_mass=vecs[2],
                     log_eps=cols[1], log_eps_avg=cols[2], h_avg=cols[3],
                     mu=cols[4], t_da=cols[5], wf_mean=vecs[3],
                     wf_m2=vecs[4], wf_count=cols[6])
    return new, draws, stats


def nuts_chunk(state: ChainState, X, y, Z, jitter, *, mom, treeu, leafu,
               n_active, adapt, eps=None, in_window=None, window_end=None,
               max_depth=8, target_accept=0.8, adapt_mass=True,
               prior_spec=None, core="vfe"):
    """:func:`nuts_chunk_plain` on CPU tensors; kernel 2
    (``csrc/nuts_chunk.cu``, the whole chunk in one launch, grid 1) on CUDA
    tensors. ``state`` is not modified."""
    K, dim = mom.shape
    _check_shapes(f"{core} nuts_chunk", state.z, X, y, Z, core)
    if dim != state.z.shape[0] or treeu.shape != (K, max_depth, 2) \
            or leafu.shape != (K, 1 << max_depth):
        raise ValueError("nuts_chunk: slab shapes do not fit (K, dim), "
                         "(K, max_depth, 2), (K, 2**max_depth)")
    if not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"nuts_chunk: max_depth must be in [1, {MAX_DEPTH}]")
    if adapt and adapt_mass and (in_window is None or window_end is None):
        raise ValueError("nuts_chunk: adapt_mass needs in_window and window_end")
    kw = dict(n_active=n_active, adapt=adapt, eps=eps, in_window=in_window,
              window_end=window_end, prior_spec=prior_spec)
    if X.device.type == "cpu":
        return nuts_chunk_plain(state, X, y, Z, jitter, mom=mom, treeu=treeu,
                                leafu=leafu, max_depth=max_depth,
                                target_accept=target_accept,
                                adapt_mass=adapt_mass, core=core, **kw)
    _build.require_cuda("nuts_chunk", X.dtype, state.z, state.g,
                        state.inv_mass, state.wf_mean, state.wf_m2, X, y, Z,
                        mom, treeu, leafu)
    new, draws, stats = launch_chunk(
        "nuts_chunk", core, as_batch(state), X, y, Z, jitter,
        (mom[:, None], treeu[:, None], leafu[:, None]),
        stream=_build.stream_ptr(X.device), MAX_DEPTH=max_depth,
        TARGET=target_accept, ADAPT_MASS=int(adapt_mass), **kw)
    _build.LAUNCHES[_build.launch_key(core, "nuts_chunk")] += 1
    return first_chain(new), draws[:, 0], stats[:, 0]


def nuts_transition_plain(z, U, g, eps, inv_mass, X, y, Z, jitter, *, mom, treeu, leafu,
                          max_depth=8, prior_spec=None, core="vfe"):
    """:func:`nuts_transition`'s plain version (:func:`_transition` on the
    plain potential of ``core``), its outputs as tensors."""
    def pot(zz):
        return neg_logpost_vg(core, zz, X, y, Z, jitter, prior_spec=prior_spec)

    zp, Up, gp, acc, div, depth, nl, H0 = _transition(
        pot, z, U, g, eps, inv_mass, mom, treeu, leafu, max_depth)
    dev = X.device
    return (zp, Up, gp, acc, torch.as_tensor(div, device=dev),
            torch.as_tensor(depth, device=dev), torch.as_tensor(nl, device=dev),
            torch.as_tensor(H0, dtype=X.dtype, device=dev))


def nuts_transition(z, U, g, eps, inv_mass, X, y, Z, jitter, *, mom, treeu, leafu,
                    max_depth=8, prior_spec=None, core="vfe"):
    """One NUTS transition from (z, U, g) at step size ``eps`` and inverse
    mass ``inv_mass`` on the potential of ``core`` ("vfe", "co2_m32" or
    "co2_rbf"), with the slabs of one step: ``mom`` (dim,), ``treeu``
    (max_depth, 2), ``leafu`` (2**max_depth,). Returns (z, U, g,
    accept_prob, diverging, depth, n_leapfrog, energy) as tensors, energy
    the initial Hamiltonian.

    CPU tensors run the plain version (:func:`nuts_transition_plain`); CUDA
    tensors launch kernel 2b (``csrc/nuts_chunk.cu`` ``nuts_transition_kernel``,
    grid 1) or raise."""
    _build.require_kind(core, "nuts_transition")
    _check_shapes(f"{core} nuts_transition", z, X, y, Z, core)
    dim = z.shape[0]
    if not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"nuts_transition: max_depth must be in [1, {MAX_DEPTH}]")
    if g.shape != (dim,) or inv_mass.shape != (dim,) or mom.shape != (dim,) \
            or treeu.shape != (max_depth, 2) or leafu.shape != (1 << max_depth,):
        raise ValueError("nuts_transition: shapes do not fit g, inv_mass, mom (dim,), "
                         "treeu (max_depth, 2), leafu (2**max_depth,)")
    dt, dev = X.dtype, X.device
    if X.device.type == "cpu":
        return nuts_transition_plain(z, U, g, eps, inv_mass, X, y, Z, jitter, mom=mom,
                                     treeu=treeu, leafu=leafu, max_depth=max_depth,
                                     prior_spec=prior_spec, core=core)
    scal = torch.stack([torch.as_tensor(eps, dtype=dt, device=dev).reshape(()),
                        torch.as_tensor(U, dtype=dt, device=dev).reshape(())])
    _build.require_cuda("nuts_transition", dt, z, g, inv_mass, X, y, Z, mom, treeu,
                        leafu, scal)
    n, d = X.shape
    m = Z.shape[0]
    zout = torch.empty(dim, dtype=dt, device=dev)
    gout = torch.empty(dim, dtype=dt, device=dev)
    stats = torch.empty(6, dtype=dt, device=dev)
    work = _build.scratch(n, m, d, 0, X, core=core)
    cfg = bound_cfg(n, m, d, jitter, want_z_grad=False, want_prior=True,
                    pivot_floor=None, prior_spec=prior_spec, core=core, DIM=dim,
                    MAX_DEPTH=max_depth, CHAINS=1)
    P = _build.ptr
    name = f"ggp_nuts_transition_{core}"
    err = _build.kernel_fn(name, dt)(
        ctypes.cast(cfg, ctypes.c_void_p), P(scal), P(z), P(g), P(inv_mass), P(mom),
        P(treeu), P(leafu), P(X), P(y), P(Z), P(zout), P(gout), P(stats), P(work),
        _build.stream_ptr(dev))
    _build.check(err, name)
    _build.LAUNCHES[_build.launch_key(core, "nuts_transition")] += 1
    return (zout, stats[0], gout, stats[1], stats[2] > 0.5, stats[3].long(),
            stats[4].long(), stats[5])
