"""The JointHMC (SGPMC) warm start: whole chunks of Adam steps on (state,
Z), plain PyTorch beside the CUDA kernel of ``csrc/sgpmc_warm.cu``.

Counterpart of ``ggp_tpu/ops/fused_sgpmc.py`` ``_warm_chunk_body`` (the
pallas_call of ``make_fused_sgpmc_warm``), which replicates the optax chain
of ``SGPMC.warm_start`` (zero_nans, clip_by_global_norm(10), adam). Each
step takes the loss -(loglik - ||v||^2 / 2), with no hyperprior, and its
gradient in (state, Z) (``sgpmc_neg_logpost_vg`` with ``want_z_grad``,
``want_prior=False`` and the trainers' pivot floor 1e-6); zeroes the
non-finite entries one by one; scales by min(1, clip_norm / ||g||) over
(state, Z) together; and takes the Adam step at t = t0 + step + 1. Unlike
the SGPR trainers there is no box on the log-hypers and no noise floor.

On the card the chunk runs on kernel 6 (``sgpmc_warm_group_kernel``) at
every n, each step one evaluation of the grouped sgpmc core over G blocks
of one cooperative launch; :func:`sgpmc_warm_group_chunk_plain` is the plain
model of its order.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, vfe_group
from .sgpmc_bound import sgpmc_neg_logpost_vg
from .sgpr_adam import PIVOT_FLOOR, _finite, adam_update
from .vfe_bound import _check_shapes, bound_cfg

__all__ = ["sgpmc_warm_chunk_plain", "sgpmc_warm_group_chunk_plain", "sgpmc_warm_chunk",
           "call_sgpmc_warm", "CLIP_NORM"]

CLIP_NORM = 10.0


def sgpmc_warm_chunk_plain(state, Z, m_st, v_st, m_z, v_z, X, y, jitter, *, t0,
                           num_steps, lr, clip_norm=CLIP_NORM):
    """``num_steps`` Adam steps on (state (d+2+m,), Z (m, d)). Returns
    (state, Z, m_st, v_st, m_z, v_z, losses (num_steps,))."""
    dt, dev = X.dtype, X.device
    losses = []
    for t in range(int(num_steps)):
        loss, gs, gZ = sgpmc_neg_logpost_vg(state, X, y, Z, jitter,
                                            want_z_grad=True, want_prior=False,
                                            pivot_floor=PIVOT_FLOOR)
        gs, gZ = _finite(gs), _finite(gZ)
        gn = torch.sqrt((gs * gs).sum() + (gZ * gZ).sum())
        sc = torch.clamp(clip_norm / gn, max=1.0)
        ta = torch.as_tensor(t0 + t + 1.0, dtype=dt, device=dev)
        state, m_st, v_st = adam_update(state, gs * sc, m_st, v_st, ta, lr)
        Z, m_z, v_z = adam_update(Z, gZ * sc, m_z, v_z, ta, lr)
        losses.append(loss)
    return state, Z, m_st, v_st, m_z, v_z, torch.stack(losses)


def sgpmc_warm_group_chunk_plain(state, Z, m_st, v_st, m_z, v_z, X, y, jitter, G, *, t0,
                                 num_steps, lr, clip_norm=CLIP_NORM):
    """The grouped warm start (kernel 6, ``csrc/sgpmc_warm.cu``) in plain
    PyTorch, step for step in its order: each step's evaluation is
    ``vfe_group.sgpmc_group_neg_logpost_vg`` on G row blocks with dU/dZ; the
    masked squares summed in float64, dU/dZ's and then the state's; the
    clip factor in the working type from that norm; the same Adam step as
    :func:`sgpmc_warm_chunk_plain`, whose function it computes. Returns what
    that does."""
    dt, dev = X.dtype, X.device
    losses = []
    for t in range(int(num_steps)):
        loss, gs, gZ = vfe_group.sgpmc_group_neg_logpost_vg(
            state, X, y, Z, jitter, G, want_z_grad=True, want_prior=False,
            pivot_floor=PIVOT_FLOOR)
        gs, gZ = _finite(gs), _finite(gZ)
        gn2 = (gZ.to(torch.float64) ** 2).sum() + (gs.to(torch.float64) ** 2).sum()
        sc = torch.clamp(clip_norm / torch.sqrt(gn2).to(dt), max=1.0)
        ta = torch.as_tensor(t0 + t + 1.0, dtype=dt, device=dev)
        state, m_st, v_st = adam_update(state, gs * sc, m_st, v_st, ta, lr)
        Z, m_z, v_z = adam_update(Z, gZ * sc, m_z, v_z, ta, lr)
        losses.append(loss)
    return state, Z, m_st, v_st, m_z, v_z, torch.stack(losses)


def warm_scratch(n, m, d, G, like):
    """The grouped warm start's scratch (the count from the C side), its
    barrier zeroed."""
    elems = int(_build.build().ggp_sgpmc_warm_group_elems(n, m, d, G,
                                                          int(like.dtype == torch.float64)))
    work = torch.empty(elems, dtype=like.dtype, device=like.device)
    work[:128 // like.element_size()].zero_()
    return work


def call_sgpmc_warm(state, Z, m_st, v_st, m_z, v_z, X, y, jitter, *, t0, num_steps, lr,
                    clip_norm=CLIP_NORM, group=None):
    """One launch of kernel 6, cooperative on G blocks (``group``, or
    ``vfe_group.geometry``'s), on CUDA tensors; counts no launch (the
    wrapper :func:`sgpmc_warm_chunk` does). Returns (state, Z, m_st, v_st,
    m_z, v_z, losses); the inputs are not modified, and the returned Z is
    contiguous, ready for the sampler's launches."""
    n, d = X.shape
    m = Z.shape[0]
    outs = [a.clone(memory_format=torch.contiguous_format)
            for a in (state, Z, m_st, v_st, m_z, v_z)]
    losses = torch.empty(int(num_steps), dtype=X.dtype, device=X.device)
    G = group or vfe_group.geometry("sgpmc_warm", X.dtype, 1, X.device, core="sgpmc_group", n=n)
    cfg = bound_cfg(n, m, d, jitter, want_z_grad=True, want_prior=False,
                    pivot_floor=PIVOT_FLOOR, prior_spec=None, K=int(num_steps),
                    LR=lr, CLIP=clip_norm, T0=float(t0), GROUP=G)
    P = _build.ptr
    err = _build.kernel_fn("ggp_sgpmc_warm_group", X.dtype)(
        ctypes.cast(cfg, ctypes.c_void_p), *[P(a) for a in outs], P(X), P(y),
        P(losses), P(warm_scratch(n, m, d, G, X)), _build.stream_ptr(X.device))
    _build.check(err, "ggp_sgpmc_warm_group")
    return (*outs, losses)


def sgpmc_warm_chunk(state, Z, m_st, v_st, m_z, v_z, X, y, jitter, *, t0,
                     num_steps, lr, clip_norm=CLIP_NORM):
    """:func:`sgpmc_warm_chunk_plain` on CPU tensors; on CUDA tensors the
    whole chunk in one launch of kernel 6 (:func:`call_sgpmc_warm`), at every
    n, or a raise. Inputs are not modified; the returned Z is contiguous,
    ready for the sampler's launches."""
    _check_shapes("sgpmc_warm_chunk", state, X, y, Z, "sgpmc")
    kw = dict(t0=t0, num_steps=num_steps, lr=lr, clip_norm=clip_norm)
    if X.device.type == "cpu":
        return sgpmc_warm_chunk_plain(state, Z, m_st, v_st, m_z, v_z, X, y,
                                      jitter, **kw)
    _build.require_cuda("sgpmc_warm_chunk", X.dtype, state, Z, m_st, v_st, m_z,
                        v_z, X, y)
    out = call_sgpmc_warm(state, Z, m_st, v_st, m_z, v_z, X, y, jitter, **kw)
    _build.LAUNCHES["sgpmc_warm_group"] += 1
    return out
