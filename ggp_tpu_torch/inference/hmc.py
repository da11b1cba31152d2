"""Single-chain NUTS driver with Stan warmup, run in chunks of K
transitions through :func:`ggp_tpu_torch.ops.nuts_chunk.nuts_chunk`.

Counterpart of ``ggp_tpu/inference/hmc.py``: ``NUTSConfig``,
``warmup_schedule``, ``da_init``/``da_update``, the Welford helpers,
``find_reasonable_step_size`` and ``_single_chain_fused``. Randomness comes
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.nuts_chunk import STAT_FIELDS, ChainState, draw_slabs, nuts_chunk

__all__ = ["NUTSConfig", "warmup_schedule", "DAState", "da_init", "da_update",
           "WelfordState", "welford_init", "welford_update",
           "welford_variance", "find_reasonable_step_size",
           "single_chain_fused"]


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    num_warmup: int = 500
    num_samples: int = 500
    max_depth: int = 8
    target_accept: float = 0.8
    adapt_mass: bool = True
    init_step_size: float = 0.1
    chunk: int = 16


class DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def da_init(eps0: torch.Tensor) -> DAState:
    return DAState(torch.log(eps0), torch.log(eps0), torch.zeros_like(eps0),
                   torch.log(10.0 * eps0), torch.zeros_like(eps0))


def da_update(s: DAState, accept_prob, target=0.8, gamma=0.05, t0=10.0,
              kappa=0.75) -> DAState:
    t = s.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * s.h_avg + (target - accept_prob) / (t + t0)
    log_eps = s.mu - torch.sqrt(t) / gamma * h_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * s.log_eps_avg
    return DAState(log_eps, log_eps_avg, h_avg, s.mu, t)


class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(dim, *, dtype, device) -> WelfordState:
    z = torch.zeros(dim, dtype=dtype, device=device)
    return WelfordState(z, z.clone(), torch.zeros((), dtype=dtype, device=device))


def welford_update(s: WelfordState, x) -> WelfordState:
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count
    return WelfordState(mean, s.m2 + delta * (x - mean), count)


def welford_variance(s: WelfordState):
    """Stan-regularised diagonal variance estimate."""
    var = s.m2 / torch.clamp(s.count - 1.0, min=1.0)
    n = s.count
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))


def warmup_schedule(num_warmup: int, init_buffer: int = 75,
                    term_buffer: int = 50, base_window: int = 25):
    """(in_window, window_end) numpy bool arrays: Stan's expanding windows."""
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.10 * num_warmup))
        base_window = max(1, num_warmup - init_buffer - term_buffer)
    in_window = np.zeros(num_warmup, bool)
    window_end = np.zeros(num_warmup, bool)
    t, w = init_buffer, base_window
    while t < num_warmup - term_buffer:
        end = t + w
        if end + 2 * w > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        in_window[t:end] = True
        window_end[end - 1] = True
        t = end
        w *= 2
    return in_window, window_end


def find_reasonable_step_size(potential_vg: Callable, z, U_z, g_z, r0,
                              inv_mass, init_eps=1.0):
    """Hoffman & Gelman Algorithm 4 with a given standard-normal draw
    ``r0``: double or halve eps until the one-step accept probability
    crosses 0.5; one potential evaluation per step."""
    r0 = r0 / torch.sqrt(inv_mass)
    H0 = U_z + 0.5 * (inv_mass * r0 * r0).sum()
    log_half = math.log(0.5)

    def accept_at(eps):
        r_half = r0 - 0.5 * eps * g_z
        U, g = potential_vg(z + eps * inv_mass * r_half)
        r = r_half - 0.5 * eps * g
        H = U + 0.5 * (inv_mass * r * r).sum()
        return -math.inf if bool(torch.isnan(H)) else float(H0 - H)

    eps = torch.as_tensor(init_eps, dtype=z.dtype, device=z.device)
    la = accept_at(eps)
    direction = 1.0 if la > log_half else -1.0
    i = 0
    while i < 64 and 1e-10 < float(eps) < 1e7:
        crossed = la <= log_half if direction > 0 else la > log_half
        if crossed:
            break
        eps = eps * (2.0 if direction > 0 else 0.5)
        la = accept_at(eps)
        i += 1
    return eps * 0.5 if direction > 0 else eps


def single_chain_fused(potential_vg: Callable, X, y, Z, jitter, z0,
                       generator: torch.Generator, cfg: NUTSConfig,
                       prior_spec=None):
    """Warmup then sampling of one chain in chunks of ``cfg.chunk``
    transitions, each chunk one call of :func:`nuts_chunk` (one kernel
    launch on the card). Returns (draws (num_samples, dim), stats dict)."""
    dim = z0.shape[0]
    dt, dev = z0.dtype, z0.device
    K = cfg.chunk
    U0, g0 = potential_vg(z0)
    inv_mass = torch.ones(dim, dtype=dt, device=dev)
    r0 = torch.randn(dim, generator=generator, dtype=dt, device=dev)
    eps = find_reasonable_step_size(potential_vg, z0, U0, g0, r0, inv_mass,
                                    cfg.init_step_size)
    da = da_init(eps)
    wf = welford_init(dim, dtype=dt, device=dev)
    state = ChainState(z=z0, U=U0, g=g0, inv_mass=inv_mass,
                       log_eps=da.log_eps, log_eps_avg=da.log_eps_avg,
                       h_avg=da.h_avg, mu=da.mu, t_da=da.t, wf_mean=wf.mean,
                       wf_m2=wf.m2, wf_count=wf.count)
    common = dict(max_depth=cfg.max_depth, target_accept=cfg.target_accept,
                  adapt_mass=cfg.adapt_mass, prior_spec=prior_spec)

    in_w, w_end = warmup_schedule(cfg.num_warmup)
    n_wchunks = -(-cfg.num_warmup // K)
    pad = n_wchunks * K - cfg.num_warmup
    in_w = torch.as_tensor(np.concatenate([in_w, np.zeros(pad, bool)]), device=dev)
    w_end = torch.as_tensor(np.concatenate([w_end, np.zeros(pad, bool)]), device=dev)
    for c in range(n_wchunks):
        mom, treeu, leafu = draw_slabs(K, dim, cfg.max_depth, generator,
                                       dtype=dt, device=dev)
        state, _, _ = nuts_chunk(
            state, X, y, Z, jitter, mom=mom, treeu=treeu, leafu=leafu,
            n_active=min(K, cfg.num_warmup - c * K), adapt=True,
            in_window=in_w[c * K:(c + 1) * K],
            window_end=w_end[c * K:(c + 1) * K], **common)
    eps = torch.exp(state.log_eps_avg)

    draws, stats = [], []
    for c in range(-(-cfg.num_samples // K)):
        mom, treeu, leafu = draw_slabs(K, dim, cfg.max_depth, generator,
                                       dtype=dt, device=dev)
        state, zs, st = nuts_chunk(
            state, X, y, Z, jitter, mom=mom, treeu=treeu, leafu=leafu,
            n_active=min(K, cfg.num_samples - c * K), adapt=False, eps=eps,
            **common)
        draws.append(zs)
        stats.append(st)
    zs = torch.cat(draws)[:cfg.num_samples]
    st = torch.cat(stats)[:cfg.num_samples]
    out = {k: st[:, i] for i, k in enumerate(STAT_FIELDS)}
    out["diverging"] = out["diverging"] > 0.5
    out["step_size"] = eps
    out["inv_mass"] = state.inv_mass
    return zs, out
