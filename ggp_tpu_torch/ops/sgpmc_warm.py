"""The JointHMC (SGPMC) warm start: whole chunks of Adam steps on (state,
Z), plain PyTorch beside the CUDA kernel ``sgpmc_warm_chunk``
(``csrc/sgpmc_warm.cu``).

Counterpart of ``ggp_tpu/ops/fused_sgpmc.py`` ``_warm_chunk_body`` (the
pallas_call of ``make_fused_sgpmc_warm``), which replicates the optax chain
of ``SGPMC.warm_start`` (zero_nans, clip_by_global_norm(10), adam). Each
step takes the loss -(loglik - ||v||^2 / 2), with no hyperprior, and its
gradient in (state, Z) (``sgpmc_neg_logpost_vg`` with ``want_z_grad``,
``want_prior=False`` and the trainers' pivot floor 1e-6); zeroes the
non-finite entries one by one; scales by min(1, clip_norm / ||g||) over
(state, Z) together; and takes the Adam step at t = t0 + step + 1. Unlike
the SGPR trainers there is no box on the log-hypers and no noise floor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sgpmc_bound import sgpmc_neg_logpost_vg
from .sgpr_adam import PIVOT_FLOOR, _finite, adam_update
from .vfe_bound import _check_shapes, bound_cfg

__all__ = ["sgpmc_warm_chunk_plain", "sgpmc_warm_chunk", "CLIP_NORM"]

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


def sgpmc_warm_chunk(state, Z, m_st, v_st, m_z, v_z, X, y, jitter, *, t0,
                     num_steps, lr, clip_norm=CLIP_NORM):
    """:func:`sgpmc_warm_chunk_plain` on CPU tensors; on CUDA tensors the
    whole chunk is one launch of ``csrc/sgpmc_warm.cu``, or a raise. Inputs
    are not modified; the returned Z is contiguous, ready for the
    sampler's launches."""
    _check_shapes("sgpmc_warm_chunk", state, X, y, Z, "sgpmc")
    kw = dict(t0=t0, num_steps=num_steps, lr=lr, clip_norm=clip_norm)
    if X.device.type == "cpu":
        return sgpmc_warm_chunk_plain(state, Z, m_st, v_st, m_z, v_z, X, y,
                                      jitter, **kw)
    _build.require_cuda("sgpmc_warm_chunk", X.dtype, state, Z, m_st, v_st, m_z,
                        v_z, X, y)
    n, d = X.shape
    m = Z.shape[0]
    outs = [a.clone(memory_format=torch.contiguous_format)
            for a in (state, Z, m_st, v_st, m_z, v_z)]
    losses = torch.empty(int(num_steps), dtype=X.dtype, device=X.device)
    work = _build.scratch(n, m, d, m * d, X, core="sgpmc")
    cfg = bound_cfg(n, m, d, jitter, want_z_grad=True, want_prior=False,
                    pivot_floor=PIVOT_FLOOR, prior_spec=None, K=int(num_steps),
                    LR=lr, CLIP=clip_norm, T0=float(t0))
    P = _build.ptr
    err = _build.kernel_fn("ggp_sgpmc_warm", X.dtype)(
        ctypes.cast(cfg, ctypes.c_void_p), *[P(a) for a in outs], P(X), P(y),
        P(losses), P(work), _build.stream_ptr(X.device))
    _build.check(err, "sgpmc_warm_chunk")
    _build.LAUNCHES["sgpmc_warm_chunk"] += 1
    return (*outs, losses)
