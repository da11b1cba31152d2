"""NUTS and HMC samplers with Stan warmup, run in chunks of K transitions:
one chain through :func:`ggp_tpu_torch.ops.nuts_chunk.nuts_chunk` or
:func:`ggp_tpu_torch.ops.multichain.hmc_chunk`, C chains through the chunk
of :func:`ggp_tpu_torch.ops.multichain.make_multichain`; or one launch per
transition (:func:`ggp_tpu_torch.ops.nuts_chunk.nuts_transition`) with the
adaptation between launches, :func:`build_sampler_chunked`.

Counterpart of ``ggp_tpu/inference/hmc.py``: ``NUTSConfig``,
``warmup_schedule``, ``da_init``/``da_update``, the Welford helpers,
``find_reasonable_step_size`` and ``_single_chain_fused``;
``_find_reasonable_step_size_batched``, ``_validate_multichain_cfg`` and
``_multichain_fused_hmc``; ``build_sampler_chunked`` (one chain) with
``_make_warm_step``. Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.multichain import MultichainKernels, draw_mc_slabs, hmc_chunk
from ..ops.nuts_chunk import STAT_FIELDS, ChainState, draw_slabs, nuts_chunk

__all__ = ["NUTSConfig", "warmup_schedule", "DAState", "da_init", "da_update",
           "WelfordState", "welford_init", "welford_update",
           "welford_variance", "find_reasonable_step_size",
           "single_chain_fused", "find_reasonable_step_size_batched",
           "validate_multichain_cfg", "multichain_fused", "GeneratorDraws",
           "build_sampler_chunked"]


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    num_warmup: int = 500
    num_samples: int = 500
    max_depth: int = 8
    target_accept: float = 0.8
    algorithm: str = "nuts"          # "nuts" | "hmc"
    num_leapfrog: int = 10           # hmc only
    adapt_mass: bool = True
    init_step_size: float = 0.1
    chunk: int = 16                  # transitions per single-chain launch


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
                       prior_spec=None, core="vfe"):
    """Warmup then sampling of one chain on the potential of ``core`` in
    chunks of ``cfg.chunk`` transitions, each chunk one kernel launch on
    the card: :func:`nuts_chunk` for ``cfg.algorithm == "nuts"``,
    :func:`~ggp_tpu_torch.ops.multichain.hmc_chunk` (L = ``cfg.num_leapfrog``)
    for ``"hmc"``. Both draw the same slabs per chunk (``draw_slabs``); HMC
    takes its momenta from ``mom`` and its Metropolis uniform of step t
    from ``treeu[t, 0, 0]``, the JAX kernels' single-chain layout.
    Returns (draws (num_samples, dim), stats dict: per draw the fields of
    ``STAT_FIELDS``, ``step_size``, ``inv_mass``, and the leapfrogs of each
    warmup transition, ``warmup_n_leapfrog``)."""
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
    if cfg.algorithm not in ("nuts", "hmc"):
        raise ValueError(f"algorithm must be 'nuts' or 'hmc', got {cfg.algorithm!r}")
    common = dict(target_accept=cfg.target_accept, adapt_mass=cfg.adapt_mass,
                  prior_spec=prior_spec, core=core)

    def chunk(state, **kw):
        mom, treeu, leafu = draw_slabs(K, dim, cfg.max_depth, generator,
                                       dtype=dt, device=dev)
        if cfg.algorithm == "hmc":
            return hmc_chunk(state, X, y, Z, jitter, mom=mom,
                             mh=treeu[:, 0, 0].contiguous(),
                             num_leapfrog=cfg.num_leapfrog, **common, **kw)
        return nuts_chunk(state, X, y, Z, jitter, mom=mom, treeu=treeu,
                          leafu=leafu, max_depth=cfg.max_depth, **common, **kw)

    in_w, w_end = warmup_schedule(cfg.num_warmup)
    n_wchunks = -(-cfg.num_warmup // K)
    pad = n_wchunks * K - cfg.num_warmup
    in_w = torch.as_tensor(np.concatenate([in_w, np.zeros(pad, bool)]), device=dev)
    w_end = torch.as_tensor(np.concatenate([w_end, np.zeros(pad, bool)]), device=dev)
    wstats = []
    for c in range(n_wchunks):
        state, _, st = chunk(state, n_active=min(K, cfg.num_warmup - c * K),
                             adapt=True, in_window=in_w[c * K:(c + 1) * K],
                             window_end=w_end[c * K:(c + 1) * K])
        wstats.append(st)
    eps = torch.exp(state.log_eps_avg)

    draws, stats = [], []
    for c in range(-(-cfg.num_samples // K)):
        state, zs, st = chunk(state, n_active=min(K, cfg.num_samples - c * K),
                              adapt=False, eps=eps)
        draws.append(zs)
        stats.append(st)
    zs = torch.cat(draws)[:cfg.num_samples]
    st = torch.cat(stats)[:cfg.num_samples]
    out = {k: st[:, i] for i, k in enumerate(STAT_FIELDS)}
    out["diverging"] = out["diverging"] > 0.5
    out["step_size"] = eps
    out["inv_mass"] = state.inv_mass
    out["warmup_n_leapfrog"] = torch.cat(wstats)[:cfg.num_warmup, 4]
    return zs, out


def find_reasonable_step_size_batched(potential: Callable, z0s, U0s, g0s, r0,
                                      inv_mass, init_eps=1.0):
    """Per-chain Hoffman & Gelman Algorithm 4 on a batched potential ((C,
    dim) -> ((C,), (C, dim))) with given standard-normal draws ``r0`` (C,
    dim). Unlike :func:`find_reasonable_step_size` there are no eps bounds:
    every iteration evaluates all chains, chains that have crossed the
    one-step accept probability 0.5 freeze their eps, and the loop ends when
    all have crossed or after 64 iterations."""
    C = z0s.shape[0]
    r0 = r0 / torch.sqrt(inv_mass)
    H0 = U0s + 0.5 * (inv_mass * r0 * r0).sum(1)
    log_half = math.log(0.5)

    def accept_at(eps):
        e = eps[:, None]
        r_half = r0 - 0.5 * e * g0s
        U, g = potential(z0s + e * inv_mass * r_half)
        r = r_half - 0.5 * e * g
        H = U + 0.5 * (inv_mass * r * r).sum(1)
        return torch.where(torch.isnan(H), torch.full_like(H, -math.inf), H0 - H)

    eps = torch.full((C,), init_eps, dtype=z0s.dtype, device=z0s.device)
    la = accept_at(eps)
    up = la > log_half

    def crossed(la):
        return torch.where(up, la <= log_half, la > log_half)

    for _ in range(64):
        done = crossed(la)
        if bool(done.all()):
            break
        eps1 = torch.where(done, eps, eps * torch.where(up, 2.0, 0.5))
        la = torch.where(done, la, accept_at(eps1))
        eps = eps1
    return torch.where(up, eps * 0.5, eps)


def validate_multichain_cfg(mk: MultichainKernels, cfg: NUTSConfig) -> str:
    """Raise unless the chunk was built with the config's algorithm and
    adaptation settings (they are fixed when the chunk is built, so a
    mismatch would silently run another sampler). Returns the algorithm."""
    if cfg.algorithm != mk.algo:
        raise ValueError(f"multichain chunk built for algorithm={mk.algo!r}; "
                         f"config asks for {cfg.algorithm!r}")
    if mk.algo == "nuts":
        if mk.max_depth != cfg.max_depth:
            raise ValueError(f"chunk built with max_depth={mk.max_depth}, "
                             f"config has {cfg.max_depth}")
    elif mk.num_leapfrog != cfg.num_leapfrog:
        raise ValueError(f"chunk built with num_leapfrog={mk.num_leapfrog}, "
                         f"config has {cfg.num_leapfrog}")
    if abs(mk.target_accept - cfg.target_accept) > 1e-9:
        raise ValueError(f"chunk built with target_accept={mk.target_accept}, "
                         f"config has {cfg.target_accept}")
    if mk.adapt_mass != cfg.adapt_mass:
        raise ValueError(f"chunk built with adapt_mass={mk.adapt_mass}, "
                         f"config has {cfg.adapt_mass}")
    return mk.algo


def multichain_fused(mk: MultichainKernels, z0s, generator: torch.Generator,
                     cfg: NUTSConfig):
    """Warmup then sampling of C chains at once, in chunks of
    ``mk.chunk_len`` transitions, each chunk one call of ``mk.chunk`` (one
    kernel launch of all chains on the card). Per chain the semantics are
    the single chain's: its own dual averaging, Welford windows and step
    size.

    Randomness, in this order from ``generator``: the step-size search's
    momenta (C, dim); then for each warmup chunk and then each sampling
    chunk its slabs (:func:`~ggp_tpu_torch.ops.multichain.draw_mc_slabs`).

    Returns (draws (C, S, dim), stats): ``accept_prob``, ``diverging``,
    ``depth``, ``n_leapfrog``, ``potential`` and ``energy`` (C, S) (for HMC,
    depth 0 and n_leapfrog L), ``step_size`` (C,), ``inv_mass`` (C, dim) and
    ``warmup_n_leapfrog`` (C, num_warmup).
    """
    C, dim = z0s.shape
    dt, dev = z0s.dtype, z0s.device
    K = mk.chunk_len
    algo = validate_multichain_cfg(mk, cfg)
    if C != mk.num_chains:
        raise ValueError(f"chunk built for {mk.num_chains} chains, got {C}")
    U0, g0 = mk.potential(z0s)
    inv_mass = torch.ones((C, dim), dtype=dt, device=dev)
    r0 = torch.randn((C, dim), generator=generator, dtype=dt, device=dev)
    eps = find_reasonable_step_size_batched(mk.potential, z0s, U0, g0, r0,
                                            inv_mass, cfg.init_step_size)
    le = torch.log(eps)
    zc = torch.zeros(C, dtype=dt, device=dev)
    zv = torch.zeros((C, dim), dtype=dt, device=dev)
    state = ChainState(z=z0s, U=U0, g=g0, inv_mass=inv_mass, log_eps=le,
                       log_eps_avg=le, h_avg=zc, mu=math.log(10.0) + le,
                       t_da=zc, wf_mean=zv, wf_m2=zv, wf_count=zc)

    def slabs():
        return draw_mc_slabs(K, C, dim, algorithm=algo,
                             max_depth=cfg.max_depth, generator=generator,
                             dtype=dt, device=dev)

    in_w, w_end = warmup_schedule(cfg.num_warmup)
    n_wchunks = -(-cfg.num_warmup // K)
    pad = n_wchunks * K - cfg.num_warmup
    in_w = torch.as_tensor(np.concatenate([in_w, np.zeros(pad, bool)]), device=dev)
    w_end = torch.as_tensor(np.concatenate([w_end, np.zeros(pad, bool)]), device=dev)
    wstats = []
    for c in range(n_wchunks):
        state, _, st = mk.chunk(state, n_active=min(K, cfg.num_warmup - c * K),
                                adapt=True, eps=None,
                                in_window=in_w[c * K:(c + 1) * K],
                                window_end=w_end[c * K:(c + 1) * K], **slabs())
        wstats.append(st)
    eps = torch.exp(state.log_eps_avg)

    draws, stats = [], []
    for c in range(-(-cfg.num_samples // K)):
        state, zs, st = mk.chunk(state, n_active=min(K, cfg.num_samples - c * K),
                                 adapt=False, eps=eps, in_window=None,
                                 window_end=None, **slabs())
        draws.append(zs)
        stats.append(st)
    S = cfg.num_samples
    zs = torch.cat(draws)[:S].transpose(0, 1)                 # (C, S, dim)
    st = torch.cat(stats)[:S].transpose(0, 1)                 # (C, S, 6)
    out = {k: st[..., i] for i, k in enumerate(STAT_FIELDS)}
    out["diverging"] = out["diverging"] > 0.5
    out["step_size"] = eps
    out["inv_mass"] = state.inv_mass
    out["warmup_n_leapfrog"] = torch.cat(wstats)[:cfg.num_warmup, :, 4].transpose(0, 1)
    return zs, out


class GeneratorDraws:
    """The randomness of :func:`build_sampler_chunked` from a
    ``torch.Generator``, in the order the sampler asks for it: the initial
    jitter (dim,), the step-size search's momentum (dim,), then each
    transition's slabs (:func:`~ggp_tpu_torch.ops.nuts_chunk.draw_slabs` of
    one step). Any object with these three methods can stand in for it (the
    tests replay the JAX package's key schedule)."""

    def __init__(self, generator: torch.Generator, dim: int, max_depth: int, *,
                 dtype, device):
        self.gen, self.dim, self.max_depth = generator, dim, max_depth
        self.kw = dict(dtype=dtype, device=device)

    def init_jitter(self):
        return torch.randn(self.dim, generator=self.gen, **self.kw)

    def search_momentum(self):
        return torch.randn(self.dim, generator=self.gen, **self.kw)

    def slabs(self):
        mom, treeu, leafu = draw_slabs(1, self.dim, self.max_depth, self.gen, **self.kw)
        return mom[0], treeu[0], leafu[0]


def build_sampler_chunked(potential_vg: Callable, transition: Callable, cfg: NUTSConfig, *,
                          num_chains: int = 1, jitter_init: float = 0.1,
                          chunk_size: int = 100):
    """Warmup and sampling of one chain of NUTS in chunks of ``chunk_size``
    transitions, each transition one call of ``transition(z, U, g, eps,
    inv_mass, mom, treeu, leafu)`` (one kernel launch on the card,
    :func:`~ggp_tpu_torch.ops.nuts_chunk.nuts_transition`), with dual
    averaging and the Welford windows done in torch on the device between
    calls; ``potential_vg(z) -> (U, grad)`` serves the initial state and
    the step-size search.

    Counterpart of the JAX package's ``build_sampler_chunked`` given a
    ``fused_builder`` (its ``_init``, ``_warm_chunk``, ``_sample_chunk``): warmup
    rounds up to a multiple of ``chunk_size`` (the padded steps adapt the
    step size outside any window), and the draws are trimmed to
    ``cfg.num_samples``. Returns ``sample(flat0, generator=None, *,
    draws=None, ckpt_manager=None) -> (draws (num_samples, dim), stats)``:
    the chain starts at flat0 + jitter_init N(0, 1); ``draws`` replaces the
    generator as the source of randomness (:class:`GeneratorDraws`)."""
    if num_chains != 1:
        raise NotImplementedError("build_sampler_chunked runs one chain; C chains of the "
                                  "chunked driver are ROADMAP queue 1 item 9")
    if cfg.algorithm != "nuts":
        raise ValueError(f"build_sampler_chunked runs NUTS, got {cfg.algorithm!r}")
    K = int(chunk_size)
    n_wchunks = -(-cfg.num_warmup // K)
    in_w, w_end = warmup_schedule(cfg.num_warmup)
    pad = n_wchunks * K - cfg.num_warmup
    in_w = np.concatenate([in_w, np.zeros(pad, bool)])
    w_end = np.concatenate([w_end, np.zeros(pad, bool)])

    def step(c, eps, draws):
        z, U, g, acc, div, depth, nl, energy = transition(
            c["z"], c["U"], c["g"], eps, c["inv_mass"], *draws.slabs())
        return {**c, "z": z, "U": U, "g": g}, (U, acc, div, depth, nl, energy)

    def sample(flat0, generator=None, *, draws=None, ckpt_manager=None):
        if ckpt_manager is not None:
            raise NotImplementedError("sampler checkpoints are ROADMAP queue 1 item 5")
        dim = flat0.shape[0]
        dt, dev = flat0.dtype, flat0.device
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            draws = GeneratorDraws(generator, dim, cfg.max_depth, dtype=dt, device=dev)
        z0 = flat0 + jitter_init * draws.init_jitter()
        U0, g0 = potential_vg(z0)
        inv_mass = torch.ones(dim, dtype=dt, device=dev)
        eps0 = find_reasonable_step_size(potential_vg, z0, U0, g0, draws.search_momentum(),
                                         inv_mass, cfg.init_step_size)
        c = dict(z=z0, U=U0, g=g0, da=da_init(eps0),
                 wf=welford_init(dim, dtype=dt, device=dev), inv_mass=inv_mass)
        wstats = []
        for t in range(n_wchunks * K):           # _make_warm_step, one transition each
            c, st = step(c, torch.exp(c["da"].log_eps), draws)
            da = da_update(c["da"], st[1], cfg.target_accept)
            if cfg.adapt_mass:
                if in_w[t]:
                    c["wf"] = welford_update(c["wf"], c["z"])
                if w_end[t]:                      # new mass, fresh window, DA restarted
                    c["inv_mass"] = welford_variance(c["wf"])
                    c["wf"] = welford_init(dim, dtype=dt, device=dev)
                    da = da_init(torch.exp(da.log_eps))
            c["da"] = da
            wstats.append(st[4])
        eps = torch.exp(c["da"].log_eps_avg)
        zs, stats = [], []
        for _ in range(-(-cfg.num_samples // K) * K):
            c, st = step(c, eps, draws)
            zs.append(c["z"])
            stats.append(st)
        S = cfg.num_samples
        out = {k: torch.stack([torch.as_tensor(st[i]) for st in stats[:S]])
               for i, k in enumerate(STAT_FIELDS)}
        out["diverging"] = out["diverging"].bool()
        out["step_size"] = eps
        out["inv_mass"] = c["inv_mass"]
        out["warmup_n_leapfrog"] = torch.stack([torch.as_tensor(v) for v in wstats])[
            :cfg.num_warmup]
        return torch.stack(zs[:S]), out

    return sample
