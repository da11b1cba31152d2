"""Smoke run of the PyTorch/CUDA port (``ggp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one or more lines; any failure is a traceback and a
non-zero exit:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
2. build: compile the CUDA kernels from ``ggp_tpu_torch/csrc`` (one nvcc
   per source, all at once);
3. kernel parity: each kernel against its plain PyTorch version on the
   card, at the shapes of the flagship path (bench.py's boston-shaped data:
   N=404 train rows, D=13, M=100; the chain-batched kernels at C=8 chains),
   in float64 and float32, with the time per call of both;
4. the main paths through the model's entry points, in float32, each with
   the launch counters set to 0 just before it and read just after:
   a. slice: BayesianSparseGPR_HMC as bench.py's headline cell drives it
      (warm start 500 steps, single-chain NUTS rounds (100,20),(25,10),
      (25,10),(100,20) with 100 Z steps between rounds, mixture predictive);
   b. HMC-C8: bench.py's ``cell_hmc_throughput`` (warm start 500 steps,
      then 8 chains of HMC, L=10, 500 warmup + 500 draws), timed once;
   c. multichain NUTS: the slice's rounds with 4 chains;
5. mc_potential's time at C = 1, 8 and 32 chains (do blocks slow each
   other?);
6. a JSON line of per-kernel results, then the final status line.

Every kernel's ``bound_ms`` is the least time the card could take for the
work of the timed call: the larger of its operations over the float32 peak
and its bytes (inputs read once, outputs written once) over the memory
rate. The operations are the least the call's bound evaluations need
(:func:`bound_ops`), not those the kernel happens to do.

    python3 chip_smoke.py --profile [slice] [hmc-c8] [mc-nuts]

runs the main paths instead (default: all three) once each under
``torch.profiler`` after a short warm-up, and prints where the device time
goes: time and launches by kernel, and the device busy share.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ggp_tpu_torch import BayesianSparseGPR_HMC
from ggp_tpu_torch.inference.diagnostics import effective_sample_size, split_rhat
from ggp_tpu_torch.inference.hmc import (find_reasonable_step_size,
                                         find_reasonable_step_size_batched)
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.multichain import (draw_mc_slabs, mc_hmc_chunk,
                                          mc_hmc_chunk_plain, mc_nuts_chunk,
                                          mc_nuts_chunk_plain, mc_potential,
                                          mc_potential_plain)
from ggp_tpu_torch.ops.nuts_chunk import (ChainState, draw_slabs, nuts_chunk,
                                          nuts_chunk_plain)
from ggp_tpu_torch.ops.sgpr_adam import (sgpr_adam_chunk, sgpr_adam_chunk_plain,
                                         z_adam_chunk, z_adam_chunk_plain)
from ggp_tpu_torch.ops.vfe_bound import rbf_vfe_neg_logpost_vg, vfe_potential
from ggp_tpu_torch.utils.datasets import normalize
from ggp_tpu_torch.utils.metrics import nlpd_mixture, rmse

# name: (source, the pallas_call it replaces, the other one it replaces)
KERNELS = {
    "vfe_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                      "ggp_tpu/ops/fused_nuts.py:807", None),
    "nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                   "ggp_tpu/ops/fused_nuts.py:780", "ggp_tpu/ops/fused_nuts.py:792"),
    "sgpr_adam_chunk": ("ggp_tpu_torch/csrc/sgpr_adam.cu",
                        "ggp_tpu/ops/fused_sgpr.py:434", None),
    "z_adam_chunk": ("ggp_tpu_torch/csrc/sgpr_adam.cu",
                     "ggp_tpu/ops/fused_sgpr.py:352", None),
    "mc_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                     "ggp_tpu/ops/fused_multichain.py:1933", None),
    "mc_hmc_chunk": ("ggp_tpu_torch/csrc/mc_hmc_chunk.cu",
                     "ggp_tpu/ops/fused_multichain.py:1985",
                     "ggp_tpu/ops/fused_multichain.py:1997"),
    "mc_nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                      "ggp_tpu/ops/fused_multichain.py:1954",
                      "ggp_tpu/ops/fused_multichain.py:1966"),
}
# Max relative error (norm-relative, see ``rel``). One evaluation: same
# algebra, another summation order and factorisation, ~1e-13 in float64 and
# ~1e-6 in float32.
TOL = {torch.float64: 1e-9, torch.float32: 1e-3}
# Adam divides each coordinate by its own RMS gradient, so a coordinate
# whose gradient is 1e-3 of the largest carries 1e-3 times the float32
# roundoff of the largest into its moments and step: ~1e-3 in float32 after
# 20 steps. In float64 the same effect stays below 1e-12.
ADAM_TOL = {torch.float64: 1e-8, torch.float32: 1e-2}
# A NUTS chunk integrates hundreds of leapfrog steps of a chaotic
# trajectory: the per-evaluation roundoff difference of the two versions
# (~1e-13 relative in f64, ~1e-6 in f32) grows along it, so draws are held
# to a looser bound than one evaluation. In f64 every tree decision of the
# chunk must agree. In f32 the grown difference reaches the margin of some
# multinomial or U-turn decision within a chunk, after which the two chains
# follow different (equally valid) paths; the check there is the leading
# run of transitions before the paths part, which must be non-empty. An
# HMC chunk (8 transitions of L=10) is held to the same draw tolerance and
# to identical accept decisions.
NUTS_TOL = {torch.float64: 1e-6, torch.float32: 1e-2}
# NVIDIA H100 SXM data sheet (at 700 W): float32 outside the tensor cores,
# and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
T_START = time.perf_counter()


def make_data(seed=173):
    """bench.py ``_make_data("boston")`` in numpy: (X, y, Z) float64."""
    N, D = 506, 13
    rng = np.random.default_rng(seed)
    X_raw = rng.normal(size=(N, D))
    w = rng.normal(size=(D, 8)) / np.sqrt(D)
    f = np.cos(X_raw @ w + rng.uniform(0, 2 * np.pi, 8)).sum(1)
    y_raw = f + 0.3 * rng.normal(size=N)
    Xn, _, _ = normalize(X_raw)
    yn, _, _ = normalize(y_raw[:, None])
    n_train = int(0.8 * N)
    X = Xn[:n_train].astype(np.float32).astype(np.float64)
    y = yn[:n_train, 0].astype(np.float32).astype(np.float64)
    Z = X[rng.integers(0, n_train, 100)]
    return X, y, Z


def rel(a, b):
    """max |a - b| / max |b| (norm-relative: small entries of a gradient
    carry the absolute error of its largest ones)."""
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def abs_err(a, b):
    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().max())


def agreeing_prefix(d_k, d_p, x_k, x_p, tol):
    """Number of leading transitions of a NUTS chunk on which kernel and
    plain version agree: identical depth, leapfrog count and divergence,
    and draws within ``tol`` of the largest draw entry."""
    scale = float(d_p.abs().max())
    for t in range(d_p.shape[0]):
        if not torch.equal(x_k[t, 2:5], x_p[t, 2:5]) \
                or float((d_k[t] - d_p[t]).abs().max()) > tol * scale:
            return t
    return d_p.shape[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def once_ms(fn):
    """(result, milliseconds) of one call, on the host clock between two
    synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound_ops(n, m, d, want_z=False):
    """The least floating-point operations one evaluation of the collapsed
    bound with its gradient needs at (n, m, d): the function's count, not
    that of ``csrc/vfe_bound.cuh``, which forms full symmetric products and
    rescales X inside its loops. A multiply-add is 2, exp/log/sqrt/divide 1
    each. A symmetric result is counted once per pair, and a product with a
    triangular factor at its triangular count (LAPACK's: potrf, trtri and
    lauum m^3/3 each, trmm and syrk n m^2, sygst m^3). Leading terms: dKnm
    (2 n m^2), An and B (n m^2 each), L^-T T0 L^-1 and Y1 (m^3 each), two
    factorisations and two triangular inverses (m^3/3 each), B^-1 (m^3/3)."""
    ops = (3 * (n + m) * d                     # scaled inputs, their norms
           + n * m * (2 * d + 6)               # Knm: cross products, r2, exp
           + m * (m + 1) / 2 * (2 * d + 6)     # Kmm (symmetric)
           + 4 * m ** 3 / 3                    # potrf + trtri of Kmm and of B
           + n * m * m + n * m                 # An = Knm L^-T / sigma (trmm)
           + n * m * m + n * m                 # B = An^T An + I (syrk)
           + m ** 3 / 3                        # B^-1 = VB VB^T (lauum)
           + 4 * n * m + 3 * m * m + 3 * n     # u, alpha; three substitutions
           + m ** 3 + m * m                    # Y1 = (I - B^-1) L^-1 (trmm)
           + 2 * m * m + m ** 3                # T0 = 2I - B - B^-1 (symmetric); L^-T T0 L^-1 (sygst)
           + 2 * m * m                         # dKmm, Pmm (symmetric)
           + 2 * n * m * m + 5 * n * m         # dKnm = (An Y1 + alpha w^T) / sigma, Pnm
           + m * m + 2 * n * m                 # sums of Pmm (rows = columns) and of Pnm
           + 2 * m * m * d + 2 * n * m * d     # Pmm Zs, Pnm Zs
           + 6 * (n + m) * d)                  # chain rule to the lengthscales
    if want_z:
        ops += 2 * n * m * d + 6 * m * d       # Pnm^T Xs, dU/dZ
    return float(ops)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(evals, n, m, d, in_bytes, out_bytes, want_z=False):
    """(bound_ms, bound_by) of a call that makes ``evals`` bound evaluations
    and reads ``in_bytes``, writes ``out_bytes`` (float32 peak)."""
    t_ops = evals * bound_ops(n, m, d, want_z) / PEAK_F32_OPS
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def state_tensors(s):
    return [getattr(s, f.name) for f in dataclasses.fields(s)]


def new_res():
    return {k: {"rel": {}, "abs32": 0.0, "ms": None, "plain_ms": None,
                "bound": (None, None)} for k in KERNELS}


def phase_parity(Xd, yd, Zd, res):
    """Kernel against plain version. ``Zd`` holds distinct rows: bench.py's
    Z (drawn with replacement) repeats 8 rows, which puts Kmm pivots at the
    jitter level; there the Z-gradient along a duplicate pair's separation
    is roundoff, and Adam's normalised steps turn roundoff into lr-sized,
    implementation-dependent moves. The slice runs on bench.py's Z."""
    for dt in (torch.float64, torch.float32):
        tag = "f64" if dt == torch.float64 else "f32"
        f32 = dt == torch.float32
        X, y, Z = Xd.to(dt), yd.to(dt), Zd.to(dt)
        n, d = X.shape
        m = Z.shape[0]
        xyz = nbytes(X, y, Z)
        jit = 1e-5                     # the float32 default jitter the slice runs
        thetas = [torch.zeros(d + 2, dtype=dt, device="cuda"),
                  torch.tensor([0.5] * d + [0.0, -2.0], dtype=dt, device="cuda")]

        # kernel 1: U and dU/dtheta (and dU/dZ under the trainers' options)
        errs, aerr = [], []
        for th in thetas:
            for kw in (dict(), dict(want_z_grad=True, want_prior=False, pivot_floor=1e-6)):
                out = vfe_potential(th, X, y, Z, jit, **kw)
                ref = rbf_vfe_neg_logpost_vg(th, X, y, Z, jit, **kw)
                errs += [rel(a, b) for a, b in zip(out, ref)]
                aerr += [abs_err(a, b) for a, b in zip(out, ref)]
        e = max(errs)
        print(f"parity vfe_potential {tag}: max rel err {e:.3e}")
        assert e <= TOL[dt], f"vfe_potential {tag} rel err {e}"
        th = thetas[0]
        ms = cuda_ms(lambda: vfe_potential(th, X, y, Z, jit), 20)
        pms = cuda_ms(lambda: rbf_vfe_neg_logpost_vg(th, X, y, Z, jit), 20)
        print(f"timing vfe_potential {tag}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        res["vfe_potential"]["rel"][tag] = e
        if f32:
            res["vfe_potential"].update(
                abs32=max(aerr), ms=ms, plain_ms=pms,
                bound=roofline(1, n, m, d, xyz + nbytes(th), (d + 3) * 4))

        # kernel 2: one warm chunk and one sample chunk on shared slabs
        dim, K, md = d + 2, 16, 8
        gen = torch.Generator(device="cuda").manual_seed(5)
        U0, g0 = rbf_vfe_neg_logpost_vg(th, X, y, Z, jit)
        pot = lambda z: rbf_vfe_neg_logpost_vg(z, X, y, Z, jit)  # noqa: E731
        eps0 = find_reasonable_step_size(pot, th, U0, g0,
                                         torch.randn(dim, generator=gen, dtype=dt,
                                                     device="cuda"),
                                         torch.ones(dim, dtype=dt, device="cuda"), 0.1)
        zero = torch.zeros((), dtype=dt, device="cuda")
        st = ChainState(z=th, U=U0, g=g0, inv_mass=torch.ones(dim, dtype=dt, device="cuda"),
                        log_eps=torch.log(eps0), log_eps_avg=torch.log(eps0), h_avg=zero,
                        mu=torch.log(10.0 * eps0), t_da=zero,
                        wf_mean=torch.zeros(dim, dtype=dt, device="cuda"),
                        wf_m2=torch.zeros(dim, dtype=dt, device="cuda"), wf_count=zero)
        in_w = torch.arange(K, device="cuda") >= 4
        w_end = torch.arange(K, device="cuda") == 11
        errs, aerr, prefixes = [], [], []
        for adapt in (True, False):
            mom, treeu, leafu = draw_slabs(K, dim, md, gen, dtype=dt, device="cuda")
            kw = dict(mom=mom, treeu=treeu, leafu=leafu, n_active=K, adapt=adapt,
                      eps=torch.exp(st.log_eps_avg), in_window=in_w, window_end=w_end,
                      max_depth=md)
            (s_k, d_k, x_k), t_k = once_ms(lambda: nuts_chunk(st, X, y, Z, jit, **kw))
            (s_p, d_p, x_p), t_p = once_ms(lambda: nuts_chunk_plain(st, X, y, Z, jit, **kw))
            p = agreeing_prefix(d_k, d_p, x_k, x_p, NUTS_TOL[dt])
            prefixes.append(p)
            if p:
                errs += [rel(d_k[:p], d_p[:p]),
                         rel(x_k[:p][:, [0, 1, 5]], x_p[:p][:, [0, 1, 5]])]
                aerr += [abs_err(d_k[:p], d_p[:p]),
                         abs_err(x_k[:p][:, [0, 5]], x_p[:p][:, [0, 5]])]
            if p == K:          # same path to the end: the final state too
                errs += [rel(s_k.g, s_p.g), rel(s_k.U, s_p.U)]
                aerr += [abs_err(s_k.U, s_p.U), abs_err(s_k.g, s_p.g)]
            leaves = int(x_k[:, 4].sum())
            st_b = nbytes(*state_tensors(st))
            bound = roofline(leaves, n, m, d,
                             xyz + st_b + nbytes(mom, treeu, leafu) + 2 * K * 4,
                             st_b + nbytes(d_k, x_k))
            print(f"parity nuts_chunk {tag} adapt={adapt}: transitions on one path "
                  f"{p}/{K} (depth/n_leapfrog/diverging identical and draws within "
                  f"{NUTS_TOL[dt]:g}), leapfrogs {leaves}, max rel err over them "
                  f"{max(errs, default=float('nan')):.3e}, kernel {t_k:.2f} ms, plain "
                  f"{t_p:.2f} ms per chunk" + (f", bound {bound[0]:.4f} ms" if f32 else ""))
            if adapt and f32:
                res["nuts_chunk"].update(ms=t_k, plain_ms=t_p, bound=bound)
            st = s_p
        e = max(errs)
        if dt == torch.float64:
            assert prefixes == [K, K], f"nuts_chunk f64: paths part at {prefixes}"
        else:
            assert min(prefixes) >= 1, f"nuts_chunk f32: first transition differs {prefixes}"
        assert e <= NUTS_TOL[dt], f"nuts_chunk {tag} rel err {e}"
        res["nuts_chunk"]["rel"][tag] = e
        if f32:
            res["nuts_chunk"]["abs32"] = max(aerr)

        # kernels 3 and 4: parameters and losses after 20 steps
        zt, zz = torch.zeros_like(th), torch.zeros_like(Z)
        akw = dict(t0=0, num_steps=20, lr=0.01, clip_norm=10.0, min_noise=1e-4)
        out = sgpr_adam_chunk(th, Z, zt, zt, zz, zz, X, y, jit, **akw)
        ref = sgpr_adam_chunk_plain(th, Z, zt, zt, zz, zz, X, y, jit, **akw)
        e = max(rel(a, b) for a, b in zip(out, ref))
        print(f"parity sgpr_adam_chunk {tag}: max rel err {e:.3e}")
        assert e <= ADAM_TOL[dt], f"sgpr_adam_chunk {tag} rel err {e}"
        res["sgpr_adam_chunk"]["rel"][tag] = e
        ms = cuda_ms(lambda: sgpr_adam_chunk(th, Z, zt, zt, zz, zz, X, y, jit, **akw), 3)
        pms = cuda_ms(lambda: sgpr_adam_chunk_plain(th, Z, zt, zt, zz, zz, X, y, jit,
                                                    **akw), 1)
        print(f"timing sgpr_adam_chunk {tag} (20 steps): kernel {ms:.3f} ms, plain {pms:.3f} ms")
        if f32:
            res["sgpr_adam_chunk"].update(
                abs32=max(abs_err(a, b) for a, b in zip(out, ref)), ms=ms, plain_ms=pms,
                bound=roofline(20, n, m, d, xyz + 3 * nbytes(th, Z), nbytes(*out),
                               want_z=True))

        tgen = torch.Generator(device="cuda").manual_seed(7)
        trace = th + 0.1 * torch.randn((10, d + 2), generator=tgen, dtype=dt, device="cuda")
        zkw = dict(t0=0, num_steps=20, lr=0.01)
        out = z_adam_chunk(Z, zz, zz, trace, X, y, jit, **zkw)
        ref = z_adam_chunk_plain(Z, zz, zz, trace, X, y, jit, **zkw)
        e = max(rel(a, b) for a, b in zip(out, ref))
        print(f"parity z_adam_chunk {tag}: max rel err {e:.3e}")
        assert e <= ADAM_TOL[dt], f"z_adam_chunk {tag} rel err {e}"
        res["z_adam_chunk"]["rel"][tag] = e
        ms = cuda_ms(lambda: z_adam_chunk(Z, zz, zz, trace, X, y, jit, **zkw), 2)
        pms = cuda_ms(lambda: z_adam_chunk_plain(Z, zz, zz, trace, X, y, jit, **zkw), 1)
        print(f"timing z_adam_chunk {tag} (20 steps x 10 rows): kernel {ms:.3f} ms, "
              f"plain {pms:.3f} ms")
        if f32:
            res["z_adam_chunk"].update(
                abs32=max(abs_err(a, b) for a, b in zip(out, ref)), ms=ms, plain_ms=pms,
                bound=roofline(200, n, m, d, nbytes(X, y, trace) + 3 * nbytes(Z),
                               nbytes(*out), want_z=True))


def mc_start(X, y, Z, jit, C, seed):
    """C chains at theta 0 + 0.1 N(0, 1) with per-chain step sizes from the
    batched search (plain potential), as the C-chain sampler starts them."""
    dt, dim = X.dtype, X.shape[1] + 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, dtype=dt, device="cuda")
    z = 0.1 * torch.randn((C, dim), **kw)
    U, g = mc_potential_plain(z, X, y, Z, jit)
    im = torch.ones_like(z)
    eps = find_reasonable_step_size_batched(
        lambda zs: mc_potential_plain(zs, X, y, Z, jit), z, U, g,
        torch.randn((C, dim), **kw), im, 0.1)
    le = torch.log(eps)
    zc, zv = torch.zeros(C, dtype=dt, device="cuda"), torch.zeros_like(z)
    st = ChainState(z=z, U=U, g=g, inv_mass=im, log_eps=le, log_eps_avg=le, h_avg=zc,
                    mu=math.log(10.0) + le, t_da=zc, wf_mean=zv, wf_m2=zv, wf_count=zc)
    return st, gen


def phase_parity_mc(Xd, yd, Zd, res, C=8, K=8, L=10, md=8):
    """The chain-batched kernels against their plain versions at C chains:
    one evaluation of C rows; a warm and a sample chunk of K transitions
    each, HMC (L leapfrogs) and NUTS (max depth md), on shared slabs."""
    for dt in (torch.float64, torch.float32):
        tag = "f64" if dt == torch.float64 else "f32"
        f32 = dt == torch.float32
        X, y, Z = Xd.to(dt), yd.to(dt), Zd.to(dt)
        n, d = X.shape
        m, dim = Z.shape[0], d + 2
        xyz = nbytes(X, y, Z)
        jit = 1e-5

        st0, gen = mc_start(X, y, Z, jit, C, seed=11)
        th = st0.z + 0.3 * torch.randn(st0.z.shape, generator=gen, dtype=dt, device="cuda")
        out = mc_potential(th, X, y, Z, jit)
        ref = mc_potential_plain(th, X, y, Z, jit)
        e = max(rel(a, b) for a, b in zip(out, ref))
        print(f"parity mc_potential {tag} (C={C}): max rel err {e:.3e}")
        assert e <= TOL[dt], f"mc_potential {tag} rel err {e}"
        res["mc_potential"]["rel"][tag] = e
        ms = cuda_ms(lambda: mc_potential(th, X, y, Z, jit), 20)
        pms = cuda_ms(lambda: mc_potential_plain(th, X, y, Z, jit), 5)
        print(f"timing mc_potential {tag} (C={C}): kernel {ms:.4f} ms, plain {pms:.4f} ms")
        if f32:
            res["mc_potential"].update(
                abs32=max(abs_err(a, b) for a, b in zip(out, ref)), ms=ms, plain_ms=pms,
                bound=roofline(C, n, m, d, xyz + nbytes(th), nbytes(*out)))

        in_w = torch.arange(K, device="cuda") >= 2
        w_end = torch.arange(K, device="cuda") == 5
        for algo, kern, plain in (("hmc", mc_hmc_chunk, mc_hmc_chunk_plain),
                                  ("nuts", mc_nuts_chunk, mc_nuts_chunk_plain)):
            name = f"mc_{algo}_chunk"
            st = st0
            errs, aerr = [], []
            for adapt in (True, False):
                sl = draw_mc_slabs(K, C, dim, algorithm=algo, max_depth=md,
                                   generator=gen, dtype=dt, device="cuda")
                kw = dict(n_active=K, adapt=adapt, eps=torch.exp(st.log_eps_avg),
                          in_window=in_w, window_end=w_end, **sl)
                if algo == "hmc":
                    kw["num_leapfrog"] = L
                else:
                    kw["max_depth"] = md
                (s_k, d_k, x_k), t_k = once_ms(lambda: kern(st, X, y, Z, jit, **kw))
                (s_p, d_p, x_p), t_p = once_ms(lambda: plain(st, X, y, Z, jit, **kw))
                leaves = int(x_k[:, :, 4].sum())
                mode = "warm" if adapt else "sample"
                st_b = nbytes(*state_tensors(st))
                bound = roofline(leaves, n, m, d,
                                 xyz + st_b + nbytes(*sl.values()) + 2 * K * 4,
                                 st_b + nbytes(d_k, x_k))
                bound_txt = f", bound {bound[0]:.4f} ms" if f32 else ""
                if algo == "hmc":
                    same = torch.equal(sl["mh"] < x_k[:, :, 1], sl["mh"] < x_p[:, :, 1])
                    acc = int((sl["mh"] < x_p[:, :, 1]).sum())
                    errs += [rel(d_k, d_p), rel(x_k[..., [0, 1, 5]], x_p[..., [0, 1, 5]]),
                             rel(s_k.z, s_p.z)]
                    aerr += [abs_err(d_k, d_p), abs_err(x_k[..., [0, 5]], x_p[..., [0, 5]])]
                    print(f"parity {name} {tag} {mode} (C={C}, K={K}, L={L}): accept "
                          f"decisions identical {same} ({acc}/{K * C} accepted), max rel "
                          f"err {max(errs):.3e}, kernel {t_k:.2f} ms, plain {t_p:.2f} ms "
                          f"per chunk{bound_txt}")
                    assert same, f"{name} {tag} {mode}: accept decisions differ"
                    assert max(errs) <= NUTS_TOL[dt], f"{name} {tag} rel err {max(errs)}"
                else:
                    prefixes = [agreeing_prefix(d_k[:, c], d_p[:, c], x_k[:, c], x_p[:, c],
                                                NUTS_TOL[dt]) for c in range(C)]
                    for c, p in enumerate(prefixes):
                        if p:
                            errs += [rel(d_k[:p, c], d_p[:p, c]),
                                     rel(x_k[:p, c][:, [0, 1, 5]], x_p[:p, c][:, [0, 1, 5]])]
                            aerr += [abs_err(d_k[:p, c], d_p[:p, c]),
                                     abs_err(x_k[:p, c][:, [0, 5]], x_p[:p, c][:, [0, 5]])]
                    print(f"parity {name} {tag} {mode} (C={C}, K={K}): transitions on one "
                          f"path per chain {prefixes}, leapfrogs {leaves}, max rel err over "
                          f"them {max(errs, default=float('nan')):.3e}, kernel {t_k:.2f} ms, "
                          f"plain {t_p:.2f} ms per chunk{bound_txt}")
                    if dt == torch.float64:
                        assert min(prefixes) == K, f"{name} f64 {mode}: paths part {prefixes}"
                    else:
                        assert min(prefixes) >= 1, f"{name} f32 {mode}: first step differs"
                    assert max(errs) <= NUTS_TOL[dt], f"{name} {tag} rel err {max(errs)}"
                if adapt and f32:
                    res[name].update(ms=t_k, plain_ms=t_p, bound=bound)
                st = s_p
            res[name]["rel"][tag] = max(errs)
            if f32:
                res[name]["abs32"] = max(aerr)


def min_ess_per_s(trace: np.ndarray, seconds: float) -> float:
    """bench.py ``_min_ess_per_s`` for a (S, dim) trace."""
    idx = np.unique(np.linspace(0, trace.shape[1] - 1,
                                min(trace.shape[1], 32)).astype(int))
    return min(effective_sample_size(trace[None, :, j]) for j in idx) / seconds


def check_launches(label, launches, expected):
    print(f"{label} launches: {json.dumps(launches)}")
    missing = [k for k in expected if launches[k] == 0]
    assert not missing, f"{label}: kernels of the path never launched: {missing}"


def phase_rounds(Xd, yd, Zd, num_chains, label):
    """bench.py's headline protocol through the port (float32): warm start,
    NUTS rounds of ``num_chains`` chains with optimize_Z(100) between,
    mixture predictive. Returns the launch counts of the run."""
    X, y, Z = (a.to(torch.float32) for a in (Xd, yd, Zd))
    rounds = [(100, 20), (25, 10), (25, 10), (100, 20)]
    torch.cuda.synchronize()
    _build.reset_launches()
    model = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses, t_warm = once_ms(lambda: model.warm_start(num_steps=500, lr=0.01))
    print(f"{label} warm_start: {t_warm / 1e3:.3f} s, loss {float(losses[0]):.3f} -> "
          f"{float(losses[-1]):.3f}")
    assert torch.isfinite(losses).all() and float(losses[-1]) < float(losses[0])
    sampling, divs, accs, t_z = 0.0, [], [], 0.0
    for i, (tune, n) in enumerate(rounds):
        _, ms = once_ms(lambda: model.sample_hypers(tune, n, gen, num_chains=num_chains))
        sampling += ms / 1e3
        div = float(model.stats["diverging"].float().mean())
        acc = float(model.stats["accept_prob"].mean())
        divs.append(div)
        accs.append(acc)
        eps = model.stats["step_size"].reshape(-1).tolist()
        print(f"{label} round {i} (tune={tune}, n={n}, chains={num_chains}): "
              f"{ms / 1e3:.3f} s, divergence fraction {div:.3f}, mean accept {acc:.3f}, "
              f"step size {', '.join(f'{e:.4g}' for e in eps)}, mean leapfrogs/draw "
              f"{float(model.stats['n_leapfrog'].mean()):.1f}")
        if i < len(rounds) - 1:
            zl, ms = once_ms(lambda: model.optimize_Z(num_steps=100, lr=0.01))
            t_z += ms / 1e3
            assert torch.isfinite(zl).all()
    (means, vars_), t_pred = once_ms(lambda: model.mixture_posterior_predictive(X))
    launches = dict(_build.LAUNCHES)
    print(f"{label} optimize_Z total: {t_z:.3f} s; predictive: {t_pred / 1e3:.3f} s; "
          f"sampling total: {sampling:.3f} s")
    ess = min_ess_per_s(model.trace.double().cpu().numpy(), sampling)
    r = float(rmse(means.mean(0), y))
    nl = float(nlpd_mixture(means, vars_, y))
    print(f"{label} min-ESS/s (last trace): {ess:.3f}; RMSE {r:.4f}; NLPD {nl:.4f}; "
          f"mixture components {means.shape[0]}")
    expected = (["vfe_potential", "nuts_chunk"] if num_chains == 1
                else ["mc_potential", "mc_nuts_chunk"]) + ["sgpr_adam_chunk", "z_adam_chunk"]
    check_launches(label, launches, expected)
    assert max(divs) <= 0.1, f"divergence fraction {max(divs)}"
    assert float(np.mean(accs)) >= 0.5, f"mean accept {np.mean(accs)}"
    assert means.shape == (20 * num_chains, X.shape[0]) and vars_.shape == means.shape
    assert torch.isfinite(means).all() and torch.isfinite(vars_).all()
    assert math.isfinite(r) and math.isfinite(nl) and r < 1.0
    return launches


def phase_hmc_c8(Xd, yd, Zd, C=8):
    """bench.py ``cell_hmc_throughput`` (bench.py:261-284) through the
    port, float32, timed once: warm start 500 steps, then C chains of HMC
    (L=10) with 500 warmup and 500 draws each."""
    X, y, Z = (a.to(torch.float32) for a in (Xd, yd, Zd))
    torch.cuda.synchronize()
    _build.reset_launches()
    model = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    losses, t_warm = once_ms(lambda: model.warm_start(num_steps=500, lr=0.01))
    assert torch.isfinite(losses).all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tr, ms = once_ms(lambda: model.sample_hypers(500, 500, gen, num_chains=C,
                                                 algorithm="hmc", num_leapfrog=10))
    launches = dict(_build.LAUNCHES)
    secs = ms / 1e3
    st = model.stats
    div = float(st["diverging"].float().mean())
    acc = float(st["accept_prob"].mean())
    trace = tr.double().cpu().numpy()
    dim = trace.shape[1]
    chains = trace.reshape(C, -1, dim)
    rhat = max(split_rhat(chains[:, :, j]) for j in range(dim))
    ess = min_ess_per_s(trace, secs)
    print(f"hmc-c8 warm_start: {t_warm / 1e3:.3f} s; sampling ({C} chains x (500 warmup "
          f"+ 500 draws), L=10): {secs:.3f} s; divergence fraction {div:.4f}; mean accept "
          f"{acc:.4f}; min-ESS/s (pooled trace {trace.shape[0]} x {dim}) {ess:.3f}; max "
          f"split-R-hat {rhat:.4f}; step sizes "
          f"{', '.join(f'{e:.4g}' for e in st['step_size'].tolist())}; "
          f"{ms / 10000:.3f} ms per leapfrog of a chain (1000 transitions x 10)")
    check_launches("hmc-c8", launches, ["sgpr_adam_chunk", "mc_potential", "mc_hmc_chunk"])
    assert trace.shape == (C * 500, dim) and np.isfinite(trace).all()
    assert div <= 0.1, f"hmc-c8 divergence fraction {div}"
    assert acc >= 0.5, f"hmc-c8 mean accept {acc}"
    assert math.isfinite(rhat), rhat
    return launches


def phase_scaling(Xd, yd, Zd):
    """mc_potential (float32) at C = 1, 8, 32: equal times mean the blocks
    do not slow one another."""
    X, y, Z = (a.to(torch.float32) for a in (Xd, yd, Zd))
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for C in (1, 8, 32):
        th = 0.1 * torch.randn((C, X.shape[1] + 2), generator=gen, device="cuda")
        out.append((C, cuda_ms(lambda: mc_potential(th, X, y, Z, 1e-5), 30)))
    print("timing mc_potential f32 by chains: "
          + ", ".join(f"C={C} {ms:.4f} ms" for C, ms in out))


def device_breakdown(prof, wall_s, label, top=8):
    """Device time by kernel of one profiled run, from the events the
    profiler traced on the card (kernels and copies; the host-side operator
    rows, which repeat their kernels' time, are left out). Busy time is the
    union of those events' intervals, so nothing is counted twice."""
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += (t1 - t0) / 1e3
        spans.append((t0, t1))
    busy_us, end = 0.0, -math.inf
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    rows = sorted(by_name.items(), key=lambda r: -r[1][1])
    total = sum(ms for _, (_, ms) in rows)
    print(f"profile {label}: wall {wall_s:.3f} s, kernel time {total / 1e3:.3f} s, "
          f"busy {busy_us / 1e6:.3f} s, busy share {100 * busy_us / 1e6 / wall_s:.2f} %")
    for name, (count, ms) in rows[:top]:
        print(f"profile {label}:   {ms:12.1f} ms  {100 * ms / total:6.2f} %  "
              f"{count:6d} launches  {name[:90]}")
    rest = rows[top:]
    if rest:
        ms = sum(r[1][1] for r in rest)
        print(f"profile {label}:   {ms:12.1f} ms  {100 * ms / total:6.2f} %  "
              f"{sum(r[1][0] for r in rest):6d} launches  ({len(rest)} other kernels)")


def profile_paths(X, y, Z, names):
    """Each named main path once under torch.profiler (CPU and CUDA
    activities), after a warm-up of the kernels and library handles."""
    paths = {"slice": lambda: phase_rounds(X, y, Z, 1, "slice"),
             "hmc-c8": lambda: phase_hmc_c8(X, y, Z),
             "mc-nuts": lambda: phase_rounds(X, y, Z, 4, "mc-nuts")}
    Xf, yf, Zf = (a.float() for a in (X, y, Z))
    mc_potential(torch.zeros((2, X.shape[1] + 2), device="cuda"), Xf, yf, Zf, 1e-5)
    torch.linalg.cholesky(torch.eye(8, device="cuda"))
    torch.cuda.synchronize()
    for name in names or list(paths):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            paths[name]()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device_breakdown(prof, wall, name)


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    X, y, Z = (torch.tensor(a, dtype=torch.float64, device="cuda") for a in make_data())
    if argv[:1] == ["--profile"]:
        profile_paths(X, y, Z, argv[1:])
        return
    distinct = np.random.default_rng(174).choice(X.shape[0], Z.shape[0], replace=False)
    Zd = X[torch.as_tensor(distinct, device="cuda")]
    res = new_res()
    phase_parity(X, y, Zd, res)
    phase_parity_mc(X, y, Zd, res)
    print(f"parity done at {time.perf_counter() - T_START:.1f} s")
    launches = {k: 0 for k in KERNELS}
    for run in (lambda: phase_rounds(X, y, Z, 1, "slice"),
                lambda: phase_hmc_c8(X, y, Z),
                lambda: phase_rounds(X, y, Z, 4, "mc-nuts")):
        for k, v in run().items():
            launches[k] += v
        print(f"main paths at {time.perf_counter() - T_START:.1f} s")
    phase_scaling(X, y, Z)
    assert all(v > 0 for v in launches.values()), launches
    out = []
    for name, (src, site, also) in KERNELS.items():
        r = res[name]
        bound_ms, bound_by = r["bound"]
        item = {"name": name, "route": "cuda", "source": src, "replaces": site,
                "launches": launches[name], "max_abs_err": r["abs32"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "max_rel_err_f64": r["rel"]["f64"], "max_rel_err_f32": r["rel"]["f32"]}
        if also:
            item["also_replaces"] = also
        out.append(item)
    print(f"total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
