"""C chains at once on a sampler potential (``core="vfe"``, the collapsed
bound, ``"sgpmc"``, the whitened JointHMC target, or ``"gpr"``, the dense
GP marginal, which has no HMC chunk): plain PyTorch beside
the CUDA kernels ``mc_potential`` (kernel 1 at grid C), ``mc_hmc_chunk``
(kernel 5, ``csrc/mc_hmc_chunk.cu``) and ``mc_nuts_chunk`` (kernel 2 at
grid C, ``csrc/nuts_chunk.cu``), one thread block per chain on the card;
and :func:`hmc_chunk`, one chain of fixed-leapfrog HMC on kernel 5 at
grid 1.

Counterpart of ``ggp_tpu/ops/fused_multichain.py`` for the ``"vfe"`` and
``"sgpmc"`` cores (``_rbf_vfe_batched_vg``, ``_sgpmc_batched_vg``):
``_mc_potential_body``, ``_mc_warm_chunk_body``/``_mc_sample_chunk_body``
(``_hmc_transition_batched`` with ``_stan_adapt_rows``) and
``_mc_nuts_warm_chunk_body``/``_mc_nuts_sample_chunk_body``
(``_nuts_transition_batched``); for ``"gpr"``, which the JAX package
samples at C chains with its vmapped XLA sampler, the same kernels run the
single-chain gpr core of ``fused_nuts.py`` one block per chain; and of the
fixed-leapfrog HMC chunks of
``ggp_tpu/ops/fused_nuts.py`` (``_hmc_transition_inkernel``). The JAX kernels advance C chains in lock
step inside one program; per chain that changes nothing (the JAX package's
tests show the batched NUTS transition equal, bit for bit, to each chain run
alone), so the plain NUTS chunk here runs the single-chain transition of
``ops/nuts_chunk.py`` chain by chain.

State is a :class:`~ggp_tpu_torch.ops.nuts_chunk.ChainState` whose fields
carry a leading chain axis C. The random slabs of a chunk of K steps keep
the JAX kernels' per-step layout, stored compactly (``draw_mc_slabs``):

* ``mom`` (K, C, dim): momentum, row t*C+c of ``_rand``'s slab;
* ``mh`` (K, C): HMC Metropolis uniforms, (t, lane c) of ``_rand``'s slab;
* ``treeu`` (K, C, max_depth, 2): NUTS direction and subtree-swap
  uniforms, row t*C+c, lanes 2*depth+{0,1} of ``_rand_nuts``'s slab;
* ``leafu`` (K, C, 2**max_depth): NUTS leaf uniforms; leaf k of chain c
  at step t is row (t*C+c)*leaf_rows + k>>7, lane k&127 of ``_rand_nuts``'s.

Per-step outputs are draws (K, C, dim) and stats (K, C, 6) in the order of
``nuts_chunk.STAT_FIELDS``; an HMC step reports depth 0 and L leapfrogs.
Semantics kept from the JAX kernels: accept iff u < min(1, exp(-dH)); a NaN
H counts as dH = +inf; a divergence is dH > 1000; the Welford count lives
with the dual-averaging state, and a window end restarts dual averaging at
the current step size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from . import _build
from .nuts_chunk import (DIVERGENCE_THRESHOLD, MAX_DEPTH, ChainState,
                         _transition, as_batch, first_chain, launch_chunk)
from .vfe_bound import _check_shapes, call_potential, neg_logpost_vg

__all__ = ["draw_mc_slabs", "mc_potential_plain", "mc_potential",
           "hmc_transition_rows", "stan_adapt_rows", "hmc_chunk_rows",
           "nuts_chunk_rows", "mc_hmc_chunk_plain", "mc_hmc_chunk",
           "hmc_chunk", "mc_nuts_chunk_plain", "mc_nuts_chunk",
           "MultichainKernels", "make_multichain", "MAX_M", "CHUNK"]

# Inducing points of the JAX package's chain-batched kernels
# (fused_multichain_supported); beyond it the JAX package samples C chains
# with its vmapped XLA sampler, which the port does not have yet.
MAX_M = 128
# Transitions per chunk launch (make_fused_hmc_multichain's default).
CHUNK = 8


def draw_mc_slabs(K, C, dim, *, algorithm, max_depth, generator, dtype,
                  device) -> dict:
    """The random slabs of one chunk, in this order from ``generator``:
    ``mom``, then ``mh`` ("hmc") or ``treeu`` and ``leafu`` ("nuts")."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    mom = torch.randn((K, C, dim), **kw)
    if algorithm == "hmc":
        return {"mom": mom, "mh": torch.rand((K, C), **kw)}
    return {"mom": mom, "treeu": torch.rand((K, C, max_depth, 2), **kw),
            "leafu": torch.rand((K, C, 1 << max_depth), **kw)}


# -- potential -----------------------------------------------------------------

def mc_potential_plain(thetas, X, y, Z, jitter, *, prior_spec=None, core="vfe"):
    """U (C,) and dU/dz (C, dim) of the potential of ``core``
    (:func:`~ggp_tpu_torch.ops.vfe_bound.neg_logpost_vg`) per row."""
    outs = [neg_logpost_vg(core, th, X, y, Z, jitter, prior_spec=prior_spec)
            for th in thetas]
    return torch.stack([u for u, _ in outs]), torch.stack([g for _, g in outs])


def mc_potential(thetas, X, y, Z, jitter, *, prior_spec=None, core="vfe"):
    """:func:`mc_potential_plain` on CPU tensors; on CUDA tensors one launch
    of kernel 1 (``csrc/vfe_potential.cu``) with one block per row, or a
    raise."""
    if thetas.ndim != 2:
        raise ValueError("mc_potential: thetas must be (C, dim)")
    _check_shapes(f"{core} mc_potential", thetas[0], X, y, Z, core)
    if X.device.type == "cpu":
        return mc_potential_plain(thetas, X, y, Z, jitter, prior_spec=prior_spec,
                                  core=core)
    _build.require_cuda("mc_potential", X.dtype, thetas, X, y, Z)
    out = call_potential(core, thetas, X, y, Z, jitter, prior_spec=prior_spec)
    _build.LAUNCHES[_build.launch_key(core, "mc_potential")] += 1
    return out


# -- transitions and adaptation on chain rows -----------------------------------

def hmc_transition_rows(pot, z0, U0, g0, eps, inv_mass, mom, mh_u,
                        num_leapfrog):
    """One fixed-leapfrog HMC transition of C chains (port of
    ``_hmc_transition_batched``). ``pot``: (C, dim) -> (U (C,), g (C, dim));
    z0, g0, inv_mass, mom (C, dim); U0, eps, mh_u (C,). Returns (z, U, g,
    accept_prob, diverging, depth, n_leapfrog, H0), each with a leading C."""
    e = eps[:, None]

    def kinetic(r):
        return 0.5 * (inv_mass * r * r).sum(1)

    r = mom / torch.sqrt(inv_mass)
    H0 = U0 + kinetic(r)
    z, U, g = z0, U0, g0
    for _ in range(num_leapfrog):
        r_half = r - 0.5 * e * g
        z = z + e * inv_mass * r_half
        U, g = pot(z)
        r = r_half - 0.5 * e * g
    H1 = U + kinetic(r)
    delta = torch.where(torch.isnan(H1), torch.full_like(H1, math.inf), H1 - H0)
    accept = torch.clamp(torch.exp(-delta), max=1.0)
    take = mh_u < accept
    zp = torch.where(take[:, None], z, z0)
    Up = torch.where(take, U, U0)
    gp = torch.where(take[:, None], g, g0)
    div = (delta > DIVERGENCE_THRESHOLD).to(z0.dtype)
    return (zp, Up, gp, accept, div, torch.zeros_like(U0),
            torch.full_like(U0, float(num_leapfrog)), H0)


def nuts_transition_rows(pot, z0, U0, g0, eps, inv_mass, mom, treeu, leafu,
                         max_depth):
    """One multinomial-NUTS transition of each of C chains, chain by chain
    (the single-chain transition of ``ops/nuts_chunk.py``); ``pot`` as in
    :func:`hmc_transition_rows`, slabs (C, ...) of one step. Returns the
    same fields as :func:`hmc_transition_rows`."""
    outs = []
    for c in range(z0.shape[0]):
        def pot1(z):
            U, g = pot(z[None])
            return U[0], g[0]
        outs.append(_transition(pot1, z0[c], U0[c], g0[c], eps[c], inv_mass[c],
                                mom[c], treeu[c], leafu[c], max_depth))
    return tuple(torch.stack([torch.as_tensor(o[i], dtype=z0.dtype, device=z0.device)
                              for o in outs]) for i in range(8))


def stan_adapt_rows(s: ChainState, zp, accept, in_w: bool, w_end: bool,
                    target_accept, adapt_mass) -> None:
    """Per-chain Stan warmup adaptation after one transition (port of
    ``_stan_adapt_rows``/``_da_update_rows``), in place on ``s``: dual
    averaging of log eps; with ``adapt_mass`` the Welford window (``in_w``:
    add zp; ``w_end``: new inverse mass, fresh window, dual averaging
    restarted at the current step size)."""
    t1 = s.t_da + 1.0
    h1 = (1.0 - 1.0 / (t1 + 10.0)) * s.h_avg + (target_accept - accept) / (t1 + 10.0)
    le1 = s.mu - torch.sqrt(t1) / 0.05 * h1
    w = torch.exp(-0.75 * torch.log(t1))
    lea1 = w * le1 + (1.0 - w) * s.log_eps_avg
    mu1, tda1 = s.mu, t1
    if adapt_mass:
        if in_w:
            cnt1 = s.wf_count + 1.0
            delta = zp - s.wf_mean
            mean1 = s.wf_mean + delta / cnt1[:, None]
            s.wf_m2 = s.wf_m2 + delta * (zp - mean1)
            s.wf_mean, s.wf_count = mean1, cnt1
        if w_end:
            n = s.wf_count[:, None]
            var = s.wf_m2 / torch.clamp(n - 1.0, min=1.0)
            s.inv_mass = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
            s.wf_mean = torch.zeros_like(s.wf_mean)
            s.wf_m2 = torch.zeros_like(s.wf_m2)
            s.wf_count = torch.zeros_like(s.wf_count)
            lea1 = le1
            mu1 = math.log(10.0) + le1
            h1 = torch.zeros_like(h1)
            tda1 = torch.zeros_like(tda1)
    s.log_eps, s.log_eps_avg, s.h_avg, s.mu, s.t_da = le1, lea1, h1, mu1, tda1


def _chunk_rows(step, state, K, *, n_active, adapt, eps, in_window,
                window_end, target_accept, adapt_mass):
    """``n_active`` (<= K) transitions ``step(t, state, eps)`` of C chains
    with per-chain adaptation when ``adapt``. Rows of inactive steps are
    zero."""
    C, dim = state.z.shape
    s = state.clone()
    draws = torch.zeros((K, C, dim), dtype=s.z.dtype, device=s.z.device)
    stats = torch.zeros((K, C, 6), dtype=s.z.dtype, device=s.z.device)
    for t in range(int(n_active)):
        e = torch.exp(s.log_eps) if adapt else eps
        zp, Up, gp, accept, div, depth, nl, H0 = step(t, s, e)
        s.z, s.U, s.g = zp, Up, gp
        if adapt:
            stan_adapt_rows(s, zp, accept, bool(in_window[t]),
                            bool(window_end[t]), target_accept, adapt_mass)
        draws[t] = zp
        stats[t] = torch.stack([Up, accept, div, depth, nl, H0], 1)
    return s, draws, stats


def hmc_chunk_rows(pot, state: ChainState, *, mom, mh, n_active, adapt,
                   eps=None, in_window=None, window_end=None, num_leapfrog=10,
                   target_accept=0.8, adapt_mass=True):
    """``n_active`` fixed-leapfrog HMC transitions of C chains on the
    batched potential ``pot``, as ``_mc_warm_chunk_body`` (``adapt``) and
    ``_mc_sample_chunk_body`` compose them. Returns (state, draws (K, C,
    dim), stats (K, C, 6)); ``state`` is not modified."""
    def step(t, s, e):
        return hmc_transition_rows(pot, s.z, s.U, s.g, e, s.inv_mass, mom[t],
                                   mh[t], num_leapfrog)
    return _chunk_rows(step, state, mom.shape[0], n_active=n_active,
                       adapt=adapt, eps=eps, in_window=in_window,
                       window_end=window_end, target_accept=target_accept,
                       adapt_mass=adapt_mass)


def nuts_chunk_rows(pot, state: ChainState, *, mom, treeu, leafu, n_active,
                    adapt, eps=None, in_window=None, window_end=None,
                    max_depth=8, target_accept=0.8, adapt_mass=True):
    """``n_active`` multinomial-NUTS transitions of C chains on the batched
    potential ``pot``, as ``_mc_nuts_warm_chunk_body`` (``adapt``) and
    ``_mc_nuts_sample_chunk_body`` compose them. Returns as
    :func:`hmc_chunk_rows`."""
    def step(t, s, e):
        return nuts_transition_rows(pot, s.z, s.U, s.g, e, s.inv_mass, mom[t],
                                    treeu[t], leafu[t], max_depth)
    return _chunk_rows(step, state, mom.shape[0], n_active=n_active,
                       adapt=adapt, eps=eps, in_window=in_window,
                       window_end=window_end, target_accept=target_accept,
                       adapt_mass=adapt_mass)


# -- chunks on the collapsed bound: plain versions and wrappers -----------------

def mc_hmc_chunk_plain(state, X, y, Z, jitter, *, prior_spec=None, core="vfe",
                       **kw):
    """:func:`hmc_chunk_rows` on :func:`mc_potential_plain`."""
    def pot(z):
        return mc_potential_plain(z, X, y, Z, jitter, prior_spec=prior_spec,
                                  core=core)
    return hmc_chunk_rows(pot, state, **kw)


def mc_nuts_chunk_plain(state, X, y, Z, jitter, *, prior_spec=None, core="vfe",
                        **kw):
    """:func:`nuts_chunk_rows` on :func:`mc_potential_plain`."""
    def pot(z):
        return mc_potential_plain(z, X, y, Z, jitter, prior_spec=prior_spec,
                                  core=core)
    return nuts_chunk_rows(pot, state, **kw)


def _check_chunk(name, state, X, y, Z, mom, adapt, adapt_mass, in_window,
                 window_end, eps, core):
    if state.z.ndim != 2 or mom.ndim != 3 or mom.shape[1:] != state.z.shape:
        raise ValueError(f"{name}: state.z must be (C, dim) and mom (K, C, dim)")
    _check_shapes(name, state.z[0], X, y, Z, core)
    if adapt and adapt_mass and (in_window is None or window_end is None):
        raise ValueError(f"{name}: adapt_mass needs in_window and window_end")
    if not adapt and eps is None:
        raise ValueError(f"{name}: a sample chunk needs eps")


def _state_tensors(state):
    return [getattr(state, f.name) for f in dataclasses.fields(state)]


def _hmc_launch(key, state, X, y, Z, jitter, *, mom, mh, num_leapfrog,
                target_accept, adapt_mass, prior_spec, core, **kw):
    """Kernel 5 on the C chains of ``state``, counted under ``key``."""
    _build.require_cuda("hmc_chunk", X.dtype, *_state_tensors(state), X, y, Z,
                        mom, mh)
    out = launch_chunk("hmc_chunk", core, state, X, y, Z, jitter, (mom, mh),
                       prior_spec=prior_spec, stream=_build.stream_ptr(X.device),
                       LEAPFROG=num_leapfrog, TARGET=target_accept,
                       ADAPT_MASS=int(adapt_mass), **kw)
    _build.LAUNCHES[key] += 1
    return out


def mc_hmc_chunk(state: ChainState, X, y, Z, jitter, *, mom, mh, n_active,
                 adapt, eps=None, in_window=None, window_end=None,
                 num_leapfrog=10, target_accept=0.8, adapt_mass=True,
                 prior_spec=None, core="vfe"):
    """:func:`mc_hmc_chunk_plain` on CPU tensors; on CUDA tensors kernel 5
    (``csrc/mc_hmc_chunk.cu``, the whole chunk of all C chains in one
    launch, one block per chain), or a raise. ``eps`` (C,) is the fixed
    per-chain step size of a sample chunk."""
    _build.require_kind(core, "mc_hmc_chunk")
    _check_chunk(f"{core} mc_hmc_chunk", state, X, y, Z, mom, adapt, adapt_mass,
                 in_window, window_end, eps, core)
    if mh.shape != mom.shape[:2]:
        raise ValueError("mc_hmc_chunk: mh must be (K, C)")
    kw = dict(n_active=n_active, adapt=adapt, eps=eps, in_window=in_window,
              window_end=window_end, mom=mom, mh=mh, num_leapfrog=num_leapfrog,
              target_accept=target_accept, adapt_mass=adapt_mass,
              prior_spec=prior_spec, core=core)
    if X.device.type == "cpu":
        return mc_hmc_chunk_plain(state, X, y, Z, jitter, **kw)
    return _hmc_launch(_build.launch_key(core, "mc_hmc_chunk"), state, X, y, Z,
                       jitter, **kw)


def hmc_chunk(state: ChainState, X, y, Z, jitter, *, mom, mh, n_active, adapt,
              eps=None, in_window=None, window_end=None, num_leapfrog=10,
              target_accept=0.8, adapt_mass=True, prior_spec=None, core="vfe"):
    """One chain of fixed-leapfrog HMC (the single-chain HMC chunks of
    ``fused_nuts.make_fused_nuts(algorithm="hmc")``): ``state`` without a
    chain axis, ``mom`` (K, dim), Metropolis uniforms ``mh`` (K,), ``eps``
    a scalar. :func:`mc_hmc_chunk_plain` on a batch of one for CPU tensors;
    kernel 5 at grid 1 for CUDA tensors. Returns (state, draws (K, dim),
    stats (K, 6))."""
    _build.require_kind(core, "hmc_chunk")
    _check_shapes(f"{core} hmc_chunk", state.z, X, y, Z, core)
    if mom.shape[1:] != state.z.shape or mh.shape != mom.shape[:1]:
        raise ValueError("hmc_chunk: slabs must be mom (K, dim) and mh (K,)")
    if not adapt and eps is None:
        raise ValueError("hmc_chunk: a sample chunk needs eps")
    kw = dict(n_active=n_active, adapt=adapt,
              eps=None if eps is None else torch.as_tensor(eps).reshape(1),
              in_window=in_window, window_end=window_end, mom=mom[:, None],
              mh=mh[:, None], num_leapfrog=num_leapfrog,
              target_accept=target_accept, adapt_mass=adapt_mass,
              prior_spec=prior_spec, core=core)
    if X.device.type == "cpu":
        new, draws, stats = mc_hmc_chunk_plain(as_batch(state), X, y, Z, jitter, **kw)
    else:
        new, draws, stats = _hmc_launch(_build.launch_key(core, "hmc_chunk"),
                                        as_batch(state), X, y, Z, jitter, **kw)
    return first_chain(new), draws[:, 0], stats[:, 0]


def mc_nuts_chunk(state: ChainState, X, y, Z, jitter, *, mom, treeu, leafu,
                  n_active, adapt, eps=None, in_window=None, window_end=None,
                  max_depth=8, target_accept=0.8, adapt_mass=True,
                  prior_spec=None, core="vfe"):
    """:func:`mc_nuts_chunk_plain` on CPU tensors; on CUDA tensors kernel 2
    (``csrc/nuts_chunk.cu``) at grid C, one block per chain, or a raise."""
    _check_chunk(f"{core} mc_nuts_chunk", state, X, y, Z, mom, adapt, adapt_mass,
                 in_window, window_end, eps, core)
    K, C, _ = mom.shape
    if treeu.shape != (K, C, max_depth, 2) or leafu.shape != (K, C, 1 << max_depth):
        raise ValueError("mc_nuts_chunk: slab shapes do not fit (K, C, "
                         "max_depth, 2) and (K, C, 2**max_depth)")
    if not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"mc_nuts_chunk: max_depth must be in [1, {MAX_DEPTH}]")
    kw = dict(n_active=n_active, adapt=adapt, eps=eps, in_window=in_window,
              window_end=window_end)
    if X.device.type == "cpu":
        return mc_nuts_chunk_plain(state, X, y, Z, jitter, prior_spec=prior_spec,
                                   mom=mom, treeu=treeu, leafu=leafu,
                                   max_depth=max_depth,
                                   target_accept=target_accept,
                                   adapt_mass=adapt_mass, core=core, **kw)
    _build.require_cuda("mc_nuts_chunk", X.dtype, *_state_tensors(state), X, y,
                        Z, mom, treeu, leafu)
    out = launch_chunk("nuts_chunk", core, state, X, y, Z, jitter,
                       (mom, treeu, leafu), prior_spec=prior_spec,
                       stream=_build.stream_ptr(X.device), MAX_DEPTH=max_depth,
                       TARGET=target_accept, ADAPT_MASS=int(adapt_mass), **kw)
    _build.LAUNCHES[_build.launch_key(core, "mc_nuts_chunk")] += 1
    return out


# -- the sampler's view: potential and chunk with their build settings ----------

class MultichainKernels(NamedTuple):
    """What ``inference.hmc.multichain_fused`` drives (counterpart of the
    JAX package's ``FusedMultichainHMC``): ``potential`` (C, dim) -> (U
    (C,), g (C, dim)); ``chunk(state, *, n_active, adapt, eps, in_window,
    window_end, **slabs)`` -> (state, draws (K, C, dim), stats (K, C, 6));
    and the settings the chunk was built with."""
    potential: Callable
    chunk: Callable
    chunk_len: int
    num_chains: int
    num_leapfrog: int
    target_accept: float
    adapt_mass: bool
    algo: str = "hmc"
    max_depth: int = 0


def make_multichain(X, y, Z, jitter, *, num_chains, algo="hmc",
                    num_leapfrog=10, max_depth=8, target_accept=0.8,
                    adapt_mass=True, prior_spec=None,
                    core="vfe") -> MultichainKernels:
    """The C-chain potential and chunk of ``core`` on (X, y, Z) (counterpart
    of ``make_fused_hmc_multichain(..., target=core)(Z)``). Raises for M >
    :data:`MAX_M`, the JAX package's envelope for these kernels."""
    if Z.shape[0] > MAX_M:
        raise ValueError(f"multichain sampling takes M <= {MAX_M} inducing "
                         f"points, got {Z.shape[0]}")
    if algo not in ("hmc", "nuts"):
        raise ValueError(f"algo must be 'hmc' or 'nuts', got {algo!r}")
    _build.require_kind(core, f"mc_{algo}_chunk")
    common = dict(target_accept=target_accept, adapt_mass=adapt_mass,
                  prior_spec=prior_spec, core=core)

    def potential(zs):
        return mc_potential(zs, X, y, Z, jitter, prior_spec=prior_spec, core=core)

    if algo == "hmc":
        def run(state, **kw):
            return mc_hmc_chunk(state, X, y, Z, jitter,
                                num_leapfrog=num_leapfrog, **common, **kw)
    else:
        def run(state, **kw):
            return mc_nuts_chunk(state, X, y, Z, jitter, max_depth=max_depth,
                                 **common, **kw)
    return MultichainKernels(potential, run, CHUNK, num_chains, num_leapfrog,
                             target_accept, adapt_mass, algo,
                             max_depth if algo == "nuts" else 0)
