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
   The JointHMC (SGPMC) kernels, the "sgpmc" core of the sampler kernels
   and the warm start, are held the same way at the same shape (state row
   d+2+M = 115), at grid 1 and grid 8; and the GPR+HMC kernels, the dense
   "gpr" core of the potential and NUTS kernels, at N=404, D=13 (state row
   d+2 = 15), at grid 1 and grid 8; and the three SVI kernels (svi_chunk
   with its Gaussian, Bernoulli-probit and Poisson terms, bsvgp_chunk at
   S=5 with q(theta) at spread 0.1 and 1, svi_softmax_chunk at C=3,
   n_half=32), one chunk of 16 Adam steps at M=100, batch 200, and one of
   64 steps at the shapes svgp-softmax (M=68) and svgp-probit (banana,
   M=32, batch 256) launch, beside cholesky_ex of the same Kmm;
4. the main paths through the models' entry points, in float32, each with
   the launch counters set to 0 just before it and read just after:
   a. slice: BayesianSparseGPR_HMC as bench.py's headline cell drives it
      (warm start 500 steps, single-chain NUTS rounds (100,20),(25,10),
      (25,10),(100,20) with 100 Z steps between rounds, mixture predictive);
   b. HMC-C8: bench.py's ``cell_hmc_throughput`` (warm start 500 steps,
      then 8 chains of HMC, L=10, 500 warmup + 500 draws), timed once;
   c. multichain NUTS: the slice's rounds with 4 chains;
   d. joint-hmc: bench.py's ``cell_joint_hmc`` (SGPMC warm start 100
      steps, then one chain of HMC, L=10, 500 warmup + 500 draws), timed
      once, and the 50-component mixture predictive on the held-out 20 %;
   e. joint-nuts: SGPMC, one chain of NUTS, 100 warmup + 50 draws;
   f. joint-c4: SGPMC, 4 chains of HMC, L=10, 100 warmup + 100 draws;
   g. joint-c4-nuts: SGPMC, 4 chains of NUTS, 100 warmup + 50 draws;
   h. gpr-hmc: bench.py's ``cell_gpr_hmc`` (GPR_HMC, one chain of NUTS, 50
      warmup + 10 draws, once untimed, then the min of 2 timed runs), and
      the full mixture predictive on the held-out 20 %;
   i. gpr-c4: GPR_HMC, 4 chains of NUTS, 100 warmup + 25 draws;
   j. svgp: StochasticVariationalGP, Gaussian, experiments/regression.py's
      protocol (M=100, batch 200, 200 epochs), held-out RMSE and NLPD;
   k. svgp-probit: the banana Bernoulli-probit SVGP of
      experiments/classification_banana.py (M=32, batch 256, 800 epochs),
      test accuracy;
   l. svgp-poisson: a Poisson SVGP on counts at the boston-shaped inputs
      (as j), the held-out rate's mean absolute error;
   m. svgp-softmax: a 3-class softmax SVGP on the tertiles of y (Z =
      X[::6], batch 200, 500 epochs, lr 0.05), train accuracy;
   n. bsvgp: BayesianStochasticVariationalGP (as j, prior_var 1, S=5), the
      100-draw mixture predictive's held-out RMSE and NLPD;
5. mc_potential's time at C = 1, 8 and 32 chains (do blocks slow each
   other?); where one gpr evaluation's time goes (its six parts, timed as
   prefixes), beside cholesky_ex + cholesky_inverse of the same K; the gpr
   potential at bench.py's winered shape (N=1279, D=11);
6. a JSON line of per-kernel results, then the final status line.

Every kernel's ``bound_ms`` is the least time the card could take for the
work of the timed call: the larger of its operations over the float32 peak
and its bytes (inputs read once, outputs written once) over the memory
rate. The operations are the least the call's evaluations of its core need
(:func:`bound_ops`, :func:`sgpmc_ops`, :func:`gpr_ops`, :func:`svi_ops`,
:func:`bsvgp_ops`),
not those the kernel happens to do.

    python3 chip_smoke.py --profile [slice] [hmc-c8] [mc-nuts] [joint-hmc] ...
                                    [gpr-hmc] [gpr-c4] [svgp] [svgp-probit]
                                    [svgp-poisson] [svgp-softmax] [bsvgp]

runs the named main paths instead (default: all) once each under
``torch.profiler`` after a short warm-up, and prints where the device time
goes: time and launches by kernel, and the device busy share.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ggp_tpu_torch import (GPR_HMC, SGPMC, BayesianSparseGPR_HMC,
                           BayesianStochasticVariationalGP, StochasticVariationalGP)
from ggp_tpu_torch.inference.diagnostics import effective_sample_size, split_rhat
from ggp_tpu_torch.inference.hmc import (find_reasonable_step_size,
                                         find_reasonable_step_size_batched)
from ggp_tpu_torch.likelihoods import BernoulliProbit, PoissonLogCox, Softmax
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.gpr_bound import gpr_neg_logpost_vg
from ggp_tpu_torch.ops.multichain import (draw_mc_slabs, hmc_chunk, mc_hmc_chunk,
                                          mc_hmc_chunk_plain, mc_nuts_chunk,
                                          mc_nuts_chunk_plain, mc_potential,
                                          mc_potential_plain)
from ggp_tpu_torch.ops.nuts_chunk import (ChainState, as_batch, draw_slabs,
                                          first_chain, nuts_chunk, nuts_chunk_plain)
from ggp_tpu_torch.ops.sgpmc_bound import sgpmc_neg_logpost_vg
from ggp_tpu_torch.ops.sgpmc_warm import sgpmc_warm_chunk, sgpmc_warm_chunk_plain
from ggp_tpu_torch.ops.sgpr_adam import (sgpr_adam_chunk, sgpr_adam_chunk_plain,
                                         z_adam_chunk, z_adam_chunk_plain)
from ggp_tpu_torch.ops.svi import (bsvgp_chunk, bsvgp_chunk_plain, svi_chunk, svi_chunk_plain,
                                   svi_softmax_chunk, svi_softmax_chunk_plain)
from ggp_tpu_torch.ops.vfe_bound import (call_potential, rbf_vfe_neg_logpost_vg, state_dim,
                                         vfe_potential)
from ggp_tpu_torch.utils.datasets import normalize
from ggp_tpu_torch.utils.metrics import nlpd, nlpd_mixture, rmse

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
    # the "sgpmc" core (csrc/sgpmc_bound.cuh) of the same kernels
    "sgpmc_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                        "ggp_tpu/ops/fused_nuts.py:807", None),
    "sgpmc_hmc_chunk": ("ggp_tpu_torch/csrc/mc_hmc_chunk.cu",
                        "ggp_tpu/ops/fused_nuts.py:780", "ggp_tpu/ops/fused_nuts.py:792"),
    "sgpmc_nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                         "ggp_tpu/ops/fused_nuts.py:780", "ggp_tpu/ops/fused_nuts.py:792"),
    "sgpmc_mc_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                           "ggp_tpu/ops/fused_multichain.py:1933", None),
    "sgpmc_mc_hmc_chunk": ("ggp_tpu_torch/csrc/mc_hmc_chunk.cu",
                           "ggp_tpu/ops/fused_multichain.py:1985",
                           "ggp_tpu/ops/fused_multichain.py:1997"),
    "sgpmc_mc_nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                            "ggp_tpu/ops/fused_multichain.py:1954",
                            "ggp_tpu/ops/fused_multichain.py:1966"),
    "sgpmc_warm_chunk": ("ggp_tpu_torch/csrc/sgpmc_warm.cu",
                         "ggp_tpu/ops/fused_sgpmc.py:131", None),
    # the "gpr" core (csrc/gpr_bound.cuh); the JAX package ran C chains of
    # GPR on its XLA sampler, the port runs the same sites' core at grid C
    "gpr_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                      "ggp_tpu/ops/fused_nuts.py:807", None),
    "gpr_nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                       "ggp_tpu/ops/fused_nuts.py:780", "ggp_tpu/ops/fused_nuts.py:792"),
    "gpr_mc_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                         "ggp_tpu/ops/fused_nuts.py:807", None),
    "gpr_mc_nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                          "ggp_tpu/ops/fused_nuts.py:780", "ggp_tpu/ops/fused_nuts.py:792"),
    # the SVI kernels (csrc/svgp_core.cuh)
    "svi_chunk": ("ggp_tpu_torch/csrc/svi_chunk.cu", "ggp_tpu/ops/fused_svi.py:1012", None),
    "bsvgp_chunk": ("ggp_tpu_torch/csrc/svi_chunk.cu", "ggp_tpu/ops/fused_svi.py:873", None),
    "svi_softmax_chunk": ("ggp_tpu_torch/csrc/svi_chunk.cu", "ggp_tpu/ops/fused_svi.py:660",
                          None),
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
# Where Kmm is conditioned past float32 (q(theta) at unit spread draws
# lengthscales of e^±3; 32 inducing points in 2-D), the float32 plain
# version itself departs from the float64 one by more than F32_RESOLVES,
# and two float32 versions differ by as much. An SVI chunk there is held to
# accuracy instead: the kernel's error against float64 within
# F32_AS_ACCURATE times the plain version's. The float64 parity of the same
# case holds the function.
F32_RESOLVES = ADAM_TOL[torch.float32] / 2
F32_AS_ACCURATE = 2.0
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
CARD = ""            # nvidia-smi's name and power limit, printed beside the paths' times


SHAPES = {"boston": (506, 13), "winered": (1599, 11)}      # bench.py SHAPES


def make_data(name="boston", seed=173):
    """bench.py ``_make_data(name)`` in numpy: (X, y, Z) float64, and the
    held-out 20 % (X_test, y_test)."""
    N, D = SHAPES[name]
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
    X_test = Xn[n_train:].astype(np.float32).astype(np.float64)
    y_test = yn[n_train:, 0].astype(np.float32).astype(np.float64)
    return X, y, Z, X_test, y_test


def make_banana():
    """``ggp_tpu/utils/datasets.py`` ``SyntheticBanana`` (800 points, 2-D)
    with its Dataset split: X z-scored, rows permuted by RandomState(173),
    the first 80 % train. Returns (X, y, X_test, y_test) float64."""
    rng = np.random.RandomState(42)
    n = 400
    t = rng.uniform(-3, 3, size=n)
    x1 = np.stack([t, t ** 2 / 3 - 1 + 0.35 * rng.normal(size=n)], axis=1)
    x2 = np.stack([t + 1.0, -(t ** 2) / 3 + 1 + 0.35 * rng.normal(size=n)], axis=1)
    X, _, _ = normalize(np.concatenate([x1, x2]))
    y = np.concatenate([np.zeros(n), np.ones(n)])
    perm = np.random.RandomState(173).permutation(2 * n)
    tr, te = perm[:int(0.8 * 2 * n)], perm[int(0.8 * 2 * n):]
    return X[tr], y[tr], X[te], y[te]


def make_counts(X, X_test, seed=7):
    """Poisson counts at the boston-shaped inputs: y ~ Poisson(exp(f)) with
    f = 1 + 0.8 sin(X w), w (d,) / sqrt(d) from ``seed``. Returns (y,
    y_test, the held-out rate exp(f(X_test)))."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=X.shape[1]) / np.sqrt(X.shape[1])
    rate, rate_test = (np.exp(1.0 + 0.8 * np.sin(A @ w)) for A in (X, X_test))
    return rng.poisson(rate).astype(np.float64), rng.poisson(rate_test).astype(np.float64), rate_test


def make_classes(y):
    """Three classes from the tertiles of y."""
    return np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(np.float64)


def svi_inducing(X, M=100, seed=45):
    """``experiments/regression.py`` ``single_run``'s Z: M rows drawn with
    replacement by RandomState(seed)."""
    return X[np.random.RandomState(seed).randint(0, X.shape[0], M)]


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


def sgpmc_ops(n, m, d, want_z=False):
    """The least floating-point operations one evaluation of the whitened
    JointHMC potential with its gradient needs at (n, m, d), counted as
    :func:`bound_ops` counts the collapsed bound. Leading terms: A = L^-1
    Kms and Kms_b = L^-T Abar (trsm, n m^2 each), S = Abar A^T (symmetric,
    n m (m+1)), L^-T S L^-1 (sygst, m^3), the factorisation (m^3/3)."""
    ops = (3 * (n + m) * d                     # scaled inputs, their norms
           + n * m * (2 * d + 6)               # Kms: cross products, r2, exp
           + m * (m + 1) / 2 * (2 * d + 6)     # Kmm (symmetric)
           + m ** 3 / 3                        # potrf
           + n * m * m                         # A = L^-1 Kms (trsm)
           + 4 * n * m + 6 * n                 # mean = A^T v, var, e, sums
           + 2 * n * m + 3 * n * m             # dF/dv = A e, Abar
           + n * m * (m + 1)                   # S = Abar A^T (symmetric)
           + n * m * m                         # Kms_b = L^-T Abar (trsm)
           + m ** 3                            # Kmm_b = -L^-T S L^-1 / 2 (sygst)
           + m * (m + 1) / 2 + n * m           # Pmm (symmetric), Pms
           + m * m + 2 * n * m                 # sums of Pmm (rows = columns) and of Pms
           + 2 * m * m * d + 2 * n * m * d     # Pmm Zs, Pms Xs
           + 6 * (n + m) * d)                  # chain rule to the lengthscales
    if want_z:
        ops += 6 * m * d                       # dU/dZ
    return float(ops)


def gpr_ops(n, d):
    """The least floating-point operations one evaluation of the dense GP
    marginal with its gradient needs at (n, d), counted as :func:`bound_ops`
    counts the collapsed bound. Leading terms: potrf, trtri and K^-1 = V V^T
    (lauum), n^3/3 each; Kcore and P = Kbar o Kcore (symmetric); P Xs."""
    ops = (3 * n * d                           # scaled inputs, their norms
           + n * (n + 1) / 2 * (2 * d + 6)     # Kcore (symmetric), K
           + n ** 3                            # potrf + trtri + lauum
           + 2 * n * n + 3 * n                 # two substitutions; logdet, quad
           + n * (n + 1) / 2 * 4 + n * n       # Kbar, P (symmetric); its row sums
           + 2 * n * n * d                     # P Xs
           + 6 * n * d)                        # chain rule to the lengthscales
    return float(ops)


def svi_ops(m, nb, d, C=1, lik="gauss", n_half=32, adam=True):
    """The least floating-point operations one SVGP minibatch step (loss,
    hand adjoint and, with ``adam``, the Adam update) needs at (m, nb, d)
    with C latents, counted as :func:`bound_ops` counts the collapsed bound.
    Leading terms: A = L^-1 Kms and Kms_b = L^-T G (trsm, nb m^2 each); per
    latent SA = qL^T A and qL SA (trmm, nb m^2 each) and the lower triangle
    of A (SA bv)^T (nb m (m+1)); the lower triangle of G A^T (nb m (m+1));
    L^-T Phi L^-1 from the factor (sygst, m^3); potrf (m^3/3). The data term
    per point: 10 operations (Gaussian), 12 (Poisson), 16 per node of the
    20-node rule (probit), 11 per class and signed draw (softmax)."""
    data = {"gauss": 10 * nb, "poisson": 12 * nb, "bernoulli_probit": 20 * 16 * nb,
            "softmax": 2 * n_half * nb * C * 11}[lik]
    n_hyp = d + 2 if lik == "gauss" else d + 1
    ops = (3 * (nb + m) * d                              # gather, scaled inputs, norms
           + nb * m * (2 * d + 6)                        # Kms: cross products, r2, exp
           + m * (m + 1) / 2 * (2 * d + 6)               # Kmm (symmetric)
           + m ** 3 / 3                                  # potrf
           + nb * m * m + 2 * nb * m                     # A = L^-1 Kms (trsm); colsum A^2
           + C * (nb * m * m + 6 * nb * m)               # SA = qL^T A (trmm); mean, colsum SA^2
           + data
           + C * (m * (m + 1) + 2 * m) + 2 * m * C       # KL
           + C * (nb * m * m + 4 * nb * m)               # G: qL SA (trmm), alpha and bv terms
           + 2 * C * nb * m                              # dELBO/dq_mu = A alpha
           + C * (nb * m * (m + 1) + nb * m)             # dELBO/dqL, lower triangle
           + nb * m * (m + 1)                            # G A^T, lower triangle
           + nb * m * m                                  # Kms_b = L^-T G (trsm)
           + m ** 3                                      # Kmm_b = -L^-T Phi L^-1 (sygst)
           + m * (m + 1) / 2 + nb * m + m * m + 2 * nb * m   # Pmm (symmetric), Pms, sums
           + 2 * m * m * d + 2 * nb * m * d              # Pmm Zs, Pms Xs
           + 6 * (nb + m) * d + 6 * m * d                # chain rules to the lengthscales, Z
           + (12 * (n_hyp + m * d + m * C + C * m * (m + 1) / 2) if adam else 0))  # Adam
    return float(ops)


def bsvgp_ops(m, nb, d, S):
    """The least operations of one BayesianSVGP step with S hyper draws
    (h = d+2): per draw theta_s = hmu + L_h eps_s (triangular), the Gaussian
    core without Adam (:func:`svi_ops`), its (Z, q_mu, q_raw) gradient added
    into the average and G_theta eps_s^T into the lower triangle of dL_h;
    once a step the hyper KL with its gradient and Adam on the h + h(h+1)/2 +
    m d + m + m(m+1)/2 parameters."""
    h = d + 2
    n_var = m * d + m + m * (m + 1) / 2
    per_draw = (h * (h + 1) + h                          # theta_s (trmv)
                + svi_ops(m, nb, d, adam=False)
                + n_var                                  # gradients into the average
                + h * (h + 1) + 2 * h)                   # dL_h += G eps^T (lower), dhmu
    once = (h * (h + 1) + 3 * h                          # hyper KL
            + h * (h + 1) + 5 * h                        # its gradient, the diagonal's exp chain
            + 12 * (h + h * (h + 1) / 2 + n_var))        # Adam
    return float(S * per_draw + once)


def register_report():
    """One line per kernel instantiation from the build's ``-Xptxas -v``
    output: registers, spill stores and static shared memory."""
    lines, name, spill = [], None, "?"
    for line in _build.ptxas_report().splitlines():
        m = re.search(r"Compiling entry function '_ZN3ggp\d+(\w+?_kernel)I"
                      r"(?:NS_\d+(\w+)E)?([fd])E", line)
        if m:
            core = f"{m.group(2)}, " if m.group(2) else ""
            name = f"{m.group(1)}<{core}{'float' if m.group(3) == 'f' else 'double'}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            lines.append(f"ptxas {name}: {m.group(1)} registers, {spill} B spill stores, "
                         f"{m.group(2)} B static shared memory")
            name, spill = None, "?"
    return lines


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(evals, n, m, d, in_bytes, out_bytes, want_z=False, core="vfe"):
    """(bound_ms, bound_by) of a call that makes ``evals`` evaluations of
    ``core`` and reads ``in_bytes``, writes ``out_bytes`` (float32 peak)."""
    ops = (gpr_ops(n, d) if core == "gpr"
           else (sgpmc_ops if core == "sgpmc" else bound_ops)(n, m, d, want_z))
    t_ops = evals * ops / PEAK_F32_OPS
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


def mc_start(X, y, Z, jit, C, seed, core="vfe"):
    """C chains at state 0 + 0.1 N(0, 1) with per-chain step sizes from the
    batched search (plain potential of ``core``), as the C-chain sampler
    starts them."""
    dt = X.dtype
    dim = state_dim(core, X.shape[1], Z.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, dtype=dt, device="cuda")
    z = 0.1 * torch.randn((C, dim), **kw)
    U, g = mc_potential_plain(z, X, y, Z, jit, core=core)
    im = torch.ones_like(z)
    eps = find_reasonable_step_size_batched(
        lambda zs: mc_potential_plain(zs, X, y, Z, jit, core=core), z, U, g,
        torch.randn((C, dim), **kw), im, 0.1)
    le = torch.log(eps)
    zc, zv = torch.zeros(C, dtype=dt, device="cuda"), torch.zeros_like(z)
    st = ChainState(z=z, U=U, g=g, inv_mass=im, log_eps=le, log_eps_avg=le, h_avg=zc,
                    mu=math.log(10.0) + le, t_da=zc, wf_mean=zv, wf_m2=zv, wf_count=zc)
    return st, gen


def chunk_parity(X, y, Z, jit, st0, gen, res, *, core, algo, grid, K, L=10, md=8):
    """A warm and a sample chunk of K transitions, HMC (L leapfrogs) or
    NUTS (max depth md), of ``core`` from the ``grid`` chains of ``st0``:
    the kernel (through the one-chain wrapper at grid 1, the C-chain one
    otherwise) against the plain C-chain version on shared slabs from
    ``gen``. HMC chunks must take identical accept decisions; NUTS chunks
    must keep every f64 chain on one path and agree on the first
    transition in f32. Records the kernel's row of ``res``."""
    dt = X.dtype
    tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
    n, d = X.shape
    m, dim = Z.shape[0], st0.z.shape[1]
    name = _build.launch_key(core, ("" if grid == 1 else "mc_") + f"{algo}_chunk")
    xyz = nbytes(X, y, Z)
    in_w = torch.arange(K, device="cuda") >= 2
    w_end = torch.arange(K, device="cuda") == 5
    plain = mc_hmc_chunk_plain if algo == "hmc" else mc_nuts_chunk_plain
    st, errs, aerr = st0, [], []
    for adapt in (True, False):
        sl = draw_mc_slabs(K, grid, dim, algorithm=algo, max_depth=md, generator=gen,
                           dtype=dt, device="cuda")
        eps = torch.exp(st.log_eps_avg)
        kw = dict(n_active=K, adapt=adapt, in_window=in_w, window_end=w_end, core=core)
        if algo == "hmc":
            kw["num_leapfrog"] = L
        else:
            kw["max_depth"] = md
        if grid == 1:
            one = {k: v[:, 0] for k, v in sl.items()}
            kern1 = hmc_chunk if algo == "hmc" else nuts_chunk

            def run_k():
                s1, d1, x1 = kern1(first_chain(st), X, y, Z, jit, eps=eps[0], **one, **kw)
                return as_batch(s1), d1[:, None], x1[:, None]
        else:
            kern = mc_hmc_chunk if algo == "hmc" else mc_nuts_chunk

            def run_k():
                return kern(st, X, y, Z, jit, eps=eps, **sl, **kw)
        (s_k, d_k, x_k), t_k = once_ms(run_k)
        (s_p, d_p, x_p), t_p = once_ms(lambda: plain(st, X, y, Z, jit, eps=eps, **sl, **kw))
        leaves = int(x_k[:, :, 4].sum())
        mode = "warm" if adapt else "sample"
        st_b = nbytes(*state_tensors(st))
        bound = roofline(leaves, n, m, d, xyz + st_b + nbytes(*sl.values()) + 2 * K * 4,
                         st_b + nbytes(d_k, x_k), core=core)
        bound_txt = f", bound {bound[0]:.4f} ms" if f32 else ""
        timing = f"kernel {t_k:.2f} ms, plain {t_p:.2f} ms per chunk{bound_txt}"
        if algo == "hmc":
            same = torch.equal(sl["mh"] < x_k[:, :, 1], sl["mh"] < x_p[:, :, 1])
            acc = int((sl["mh"] < x_p[:, :, 1]).sum())
            errs += [rel(d_k, d_p), rel(x_k[..., [0, 1, 5]], x_p[..., [0, 1, 5]]),
                     rel(s_k.z, s_p.z)]
            aerr += [abs_err(d_k, d_p), abs_err(x_k[..., [0, 5]], x_p[..., [0, 5]])]
            print(f"parity {name} {tag} {mode} (grid {grid}, K={K}, L={L}): accept "
                  f"decisions identical {same} ({acc}/{K * grid} accepted), max rel err "
                  f"{max(errs):.3e}, {timing}")
            assert same, f"{name} {tag} {mode}: accept decisions differ"
            tol = NUTS_TOL[dt] if f32 else TOL[dt]
            assert max(errs) <= tol, f"{name} {tag} rel err {max(errs)}"
        else:
            prefixes = [agreeing_prefix(d_k[:, c], d_p[:, c], x_k[:, c], x_p[:, c],
                                        NUTS_TOL[dt]) for c in range(grid)]
            for c, p in enumerate(prefixes):
                if p:
                    errs += [rel(d_k[:p, c], d_p[:p, c]),
                             rel(x_k[:p, c][:, [0, 1, 5]], x_p[:p, c][:, [0, 1, 5]])]
                    aerr += [abs_err(d_k[:p, c], d_p[:p, c]),
                             abs_err(x_k[:p, c][:, [0, 5]], x_p[:p, c][:, [0, 5]])]
            print(f"parity {name} {tag} {mode} (grid {grid}, K={K}): transitions on one "
                  f"path per chain {prefixes}, leapfrogs {leaves}, max rel err over them "
                  f"{max(errs, default=float('nan')):.3e}, {timing}")
            if f32:
                assert min(prefixes) >= 1, f"{name} f32 {mode}: first step differs"
            else:
                assert min(prefixes) == K, f"{name} f64 {mode}: paths part {prefixes}"
            assert max(errs) <= NUTS_TOL[dt], f"{name} {tag} rel err {max(errs)}"
        if adapt and f32:
            res[name].update(ms=t_k, plain_ms=t_p, bound=bound)
        st = s_p
    res[name]["rel"][tag] = max(errs)
    if f32:
        res[name]["abs32"] = max(aerr)


def potential_parity(name, fn, plain, rows, res, reps, bound_args):
    """One call of a C-row potential wrapper against its plain version (max
    over the outputs), and the time of both; records the f32 row of
    ``res`` with the bound of ``roofline(*bound_args(out))``."""
    tag, f32 = ("f32", True) if rows.dtype == torch.float32 else ("f64", False)
    out, ref = fn(rows), plain(rows)
    e = max(rel(a, b) for a, b in zip(out, ref))
    ms = cuda_ms(lambda: fn(rows), 20)
    pms = cuda_ms(lambda: plain(rows), reps)
    print(f"parity {name} {tag} (rows {tuple(rows.shape)}): max rel err {e:.3e}; kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms")
    assert e <= TOL[rows.dtype], f"{name} {tag} rel err {e}"
    res[name]["rel"][tag] = e
    if f32:
        res[name].update(abs32=max(abs_err(a, b) for a, b in zip(out, ref)), ms=ms,
                         plain_ms=pms, bound=roofline(*bound_args(out)))


def phase_parity_mc(Xd, yd, Zd, res, C=8, K=8, L=10, md=8):
    """The chain-batched kernels of the vfe core against their plain
    versions at C chains: one evaluation of C rows; a warm and a sample
    chunk of K transitions each, HMC (L leapfrogs) and NUTS (max depth md),
    on shared slabs."""
    for dt in (torch.float64, torch.float32):
        X, y, Z = Xd.to(dt), yd.to(dt), Zd.to(dt)
        n, d = X.shape
        jit = 1e-5
        st0, gen = mc_start(X, y, Z, jit, C, seed=11)
        th = st0.z + 0.3 * torch.randn(st0.z.shape, generator=gen, dtype=dt, device="cuda")
        potential_parity("mc_potential", lambda r: mc_potential(r, X, y, Z, jit),
                         lambda r: mc_potential_plain(r, X, y, Z, jit), th, res, 5,
                         lambda out: (C, n, Z.shape[0], d, nbytes(X, y, Z, th), nbytes(*out)))
        for algo in ("hmc", "nuts"):
            chunk_parity(X, y, Z, jit, st0, gen, res, core="vfe", algo=algo, grid=C, K=K,
                         L=L, md=md)


def phase_parity_sgpmc(Xd, yd, Zd, res, C=8, L=10, md=8):
    """The sgpmc core of every kernel against its plain version at bench.py's
    shape (state row d+2+M = 115): the potential at grid 1 (sampler and
    warm-start options) and grid C; the warm start over 20 steps; the HMC
    chunk (L leapfrogs) at grid 1 (K=16) and grid C (K=8) and the NUTS
    chunk (max depth md) at grid 1 and grid C (K=8)."""
    for dt in (torch.float64, torch.float32):
        tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
        X, y, Z = Xd.to(dt), yd.to(dt), Zd.to(dt)
        n, d = X.shape
        m = Z.shape[0]
        xyz = nbytes(X, y, Z)
        jit = 1e-5
        st0, gen = mc_start(X, y, Z, jit, C, seed=13, core="sgpmc")
        row = st0.z[0].contiguous()
        errs, aerr = [], []
        for kw in (dict(), dict(want_z_grad=True, want_prior=False, pivot_floor=1e-6)):
            out = vfe_potential(row, X, y, Z, jit, core="sgpmc", **kw)
            ref = sgpmc_neg_logpost_vg(row, X, y, Z, jit, **kw)
            errs += [rel(a, b) for a, b in zip(out, ref)]
            aerr += [abs_err(a, b) for a, b in zip(out, ref)]
        e = max(errs)
        ms = cuda_ms(lambda: vfe_potential(row, X, y, Z, jit, core="sgpmc"), 20)
        pms = cuda_ms(lambda: sgpmc_neg_logpost_vg(row, X, y, Z, jit), 20)
        print(f"parity sgpmc_potential {tag}: max rel err {e:.3e}; kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms")
        assert e <= TOL[dt], f"sgpmc_potential {tag} rel err {e}"
        res["sgpmc_potential"]["rel"][tag] = e
        if f32:
            res["sgpmc_potential"].update(
                abs32=max(aerr), ms=ms, plain_ms=pms,
                bound=roofline(1, n, m, d, xyz + nbytes(row), (row.numel() + 1) * 4,
                               core="sgpmc"))
        rows = st0.z + 0.3 * torch.randn(st0.z.shape, generator=gen, dtype=dt, device="cuda")
        potential_parity(
            "sgpmc_mc_potential", lambda r: mc_potential(r, X, y, Z, jit, core="sgpmc"),
            lambda r: mc_potential_plain(r, X, y, Z, jit, core="sgpmc"), rows, res, 5,
            lambda out: (C, n, m, d, xyz + nbytes(rows), nbytes(*out), False, "sgpmc"))

        zs, zz = torch.zeros_like(row), torch.zeros_like(Z)
        args = (row, Z, zs, zs, zz, zz, X, y)
        akw = dict(t0=0, num_steps=20, lr=0.01)
        out = sgpmc_warm_chunk(*args, jit, **akw)
        ref = sgpmc_warm_chunk_plain(*args, jit, **akw)
        e = max(rel(a, b) for a, b in zip(out, ref))
        ms = cuda_ms(lambda: sgpmc_warm_chunk(*args, jit, **akw), 3)
        pms = cuda_ms(lambda: sgpmc_warm_chunk_plain(*args, jit, **akw), 1)
        txt = ""
        if f32:     # both float32 versions against the float64 run from the same inputs
            r64 = sgpmc_warm_chunk_plain(*(a.double() for a in args), jit, **akw)
            txt = (f"; against float64 from the same inputs: kernel "
                   f"{max(rel(a, b) for a, b in zip(out, r64)):.3e}, plain "
                   f"{max(rel(a, b) for a, b in zip(ref, r64)):.3e}")
        print(f"parity sgpmc_warm_chunk {tag} (20 steps): max rel err {e:.3e}{txt}; kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms")
        # float64 to one evaluation's tolerance; float32 to Adam's (ADAM_TOL)
        tol = ADAM_TOL[dt] if f32 else TOL[dt]
        assert e <= tol, f"sgpmc_warm_chunk {tag} rel err {e}"
        res["sgpmc_warm_chunk"]["rel"][tag] = e
        if f32:
            res["sgpmc_warm_chunk"].update(
                abs32=max(abs_err(a, b) for a, b in zip(out, ref)), ms=ms, plain_ms=pms,
                bound=roofline(20, n, m, d, xyz + 3 * nbytes(row, Z), nbytes(*out),
                               want_z=True, core="sgpmc"))

        for algo, grid in (("hmc", 1), ("hmc", C), ("nuts", 1), ("nuts", C)):
            st = as_batch(first_chain(st0)) if grid == 1 else st0
            chunk_parity(X, y, Z, jit, st, gen, res, core="sgpmc", algo=algo, grid=grid,
                         K=16 if (algo, grid) == ("hmc", 1) else 8, L=L, md=md)


def phase_parity_gpr(Xd, yd, res, C=8, md=8):
    """The gpr core of the potential and NUTS kernels against the plain
    version at bench.py's GPR+HMC shape (N=404, D=13, state row 15): the
    potential at grid 1 (two rows) and grid C; a warm and a sample NUTS
    chunk of K=8 transitions (max depth md) at grid 1 and grid C. In float32 both
    versions are also held against the float64 plain version on the same
    inputs."""
    for dt in (torch.float64, torch.float32):
        tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
        X, y = Xd.to(dt), yd.to(dt)
        n, d = X.shape
        Z = X.new_empty((0, d))
        jit = 1e-5
        st0, gen = mc_start(X, y, Z, jit, C, seed=17, core="gpr")
        rows = [st0.z[0].contiguous(),
                torch.tensor([0.5] * d + [0.0, -2.0], dtype=dt, device="cuda")]
        errs, aerr, e64 = [], [], []
        for row in rows:
            out = vfe_potential(row, X, y, Z, jit, core="gpr")
            ref = gpr_neg_logpost_vg(row, X, y, jit)
            errs += [rel(a, b) for a, b in zip(out, ref)]
            aerr += [abs_err(a, b) for a, b in zip(out, ref)]
            if f32:
                r64 = gpr_neg_logpost_vg(row.double(), X.double(), y.double(), jit)
                e64 += [(rel(a, c), rel(b, c)) for a, b, c in zip(out, ref, r64)]
        e = max(errs)
        row = rows[0]
        ms = cuda_ms(lambda: vfe_potential(row, X, y, Z, jit, core="gpr"), 20)
        pms = cuda_ms(lambda: gpr_neg_logpost_vg(row, X, y, jit), 20)
        txt = ""
        if f32:
            txt = (f"; against float64 from the same inputs: kernel "
                   f"{max(k for k, _ in e64):.3e}, plain {max(p for _, p in e64):.3e}")
        print(f"parity gpr_potential {tag}: max rel err {e:.3e}{txt}; kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms")
        assert e <= TOL[dt], f"gpr_potential {tag} rel err {e}"
        res["gpr_potential"]["rel"][tag] = e
        if f32:
            res["gpr_potential"].update(
                abs32=max(aerr), ms=ms, plain_ms=pms,
                bound=roofline(1, n, 0, d, nbytes(X, y, row), (row.numel() + 1) * 4,
                               core="gpr"))
        th = st0.z + 0.3 * torch.randn(st0.z.shape, generator=gen, dtype=dt, device="cuda")
        potential_parity(
            "gpr_mc_potential", lambda r: mc_potential(r, X, y, Z, jit, core="gpr"),
            lambda r: mc_potential_plain(r, X, y, Z, jit, core="gpr"), th, res, 5,
            lambda out: (C, n, 0, d, nbytes(X, y, th), nbytes(*out), False, "gpr"))
        for grid in (1, C):
            st = as_batch(first_chain(st0)) if grid == 1 else st0
            chunk_parity(X, y, Z, jit, st, gen, res, core="gpr", algo="nuts", grid=grid,
                         K=8, md=md)


def svi_errs(out, ref):
    """({name: rel err} over the parameters and the losses, worst name)."""
    errs = {k: rel(out[0][k], ref[0][k]) for k in ref[0]}
    errs["losses"] = rel(out[3], ref[3])
    return errs, max(errs, key=errs.get)


def phase_parity_svi(Xd, yd, Zd, res, K=16, nb=200, S=5, C=3, n_half=32):
    """The three SVI kernels against their plain versions, one chunk of Adam
    steps on shared row indices and eps, in float64 and float32. At the
    parity shape (N=404, D=13, M=100 distinct rows, batch nb, K steps):
    svi_chunk with each of its three data terms, bsvgp_chunk at S hyper
    draws with q(theta) at the model's initial spread (L_h diagonal 0.1) and
    at unit spread (where the prior_var=1 KL pulls it), svi_softmax_chunk at
    C classes and n_half antithetic pairs. At the shapes the paths launch
    (64 steps): svi_softmax_chunk at svgp-softmax's M=68 (Z = X[::6]), and
    svi_chunk's probit term at svgp-probit's banana shape (N=640, D=2, M=32
    distinct rows, batch 256). Held on losses and parameters; in float32
    both versions are also read against the float64 plain version on the
    same inputs, and a chunk that float32 does not resolve is held to
    accuracy (``F32_AS_ACCURATE``). The time per call of both. Then, as the yardstick of the
    step's factorisation, torch.linalg.cholesky_ex of the same float32 Kmm."""
    n, d = Xd.shape
    m = Zd.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(19)
    kw = dict(generator=gen, dtype=torch.float64, device="cuda")

    def batches(N, b, steps):
        return torch.stack([torch.randperm(N, generator=gen, device="cuda")[:b]
                            for _ in range(steps)])
    idx = batches(n, nb, K)
    targets = {"gauss": yd, "bernoulli_probit": (yd > 0).double(),
               "poisson": torch.poisson(torch.exp(0.5 * yd), generator=gen),
               "softmax": torch.bucketize(yd, torch.quantile(yd, yd.new_tensor([1 / 3, 2 / 3])))
               .double()}
    hyp = torch.tensor([0.5] * d + [0.0, -2.0], dtype=torch.float64, device="cuda")
    q_mu, q_raw = 0.1 * torch.randn((m, C), **kw), 0.05 * torch.randn((C, m, m), **kw)
    eps_soft, eps_b = torch.randn((K, n_half, nb, C), **kw), torch.randn((K, S, d + 2), **kw)
    hmu = 0.1 * torch.randn(d + 2, **kw)
    L_off = torch.tril(0.05 * torch.randn((d + 2, d + 2), **kw), -1)
    L_diag = 0.05 * torch.randn(d + 2, **kw)

    # case: (kernel name, label, wrapper, plain, params, X, y, idx, eps, options,
    #        likelihood, draws, feeds the JSON line)
    cases = []
    for lik in ("gauss", "bernoulli_probit", "poisson"):
        p = {"hyp": hyp[:d + 2 if lik == "gauss" else d + 1], "Z": Zd, "q_mu": q_mu[:, :1],
             "q_raw": q_raw[:1]}
        cases.append(("svi_chunk", lik, svi_chunk, svi_chunk_plain, p, Xd, targets[lik], idx,
                      None, dict(likelihood=lik), lik, 1, lik == "gauss"))
    for spread, first in ((0.1, True), (1.0, False)):
        p = {"hmu": hmu, "Lraw": L_off + torch.diag(math.log(spread) + L_diag), "Z": Zd,
             "q_mu": q_mu[:, :1], "q_raw": q_raw[:1]}
        cases.append(("bsvgp_chunk", f"S={S}, L_h diagonal {spread}", bsvgp_chunk,
                      bsvgp_chunk_plain, p, Xd, yd, idx, eps_b, dict(prior_var=1.0), "gauss", S,
                      first))
    p = {"hyp": hyp[:d + 1], "Z": Zd, "q_mu": q_mu, "q_raw": q_raw}
    cases.append(("svi_softmax_chunk", f"C={C}, n_half={n_half}, M={m}", svi_softmax_chunk,
                  svi_softmax_chunk_plain, p, Xd, targets["softmax"], idx, eps_soft, {},
                  "softmax", 1, False))
    # the paths' own shapes, 64 steps a launch (models.svgp.STEPS_PER_LAUNCH)
    Kp, Zs6 = 64, Xd[::6]
    ms6 = Zs6.shape[0]
    p = {"hyp": hyp[:d + 1], "Z": Zs6, "q_mu": 0.1 * torch.randn((ms6, C), **kw),
         "q_raw": 0.05 * torch.randn((C, ms6, ms6), **kw)}
    cases.append(("svi_softmax_chunk", f"C={C}, n_half={n_half}, M={ms6} (svgp-softmax)",
                  svi_softmax_chunk, svi_softmax_chunk_plain, p, Xd, targets["softmax"],
                  batches(n, nb, Kp), torch.randn((Kp, n_half, nb, C), **kw), {}, "softmax", 1,
                  True))
    Xb, yb = (torch.tensor(a, dtype=torch.float64, device="cuda") for a in make_banana()[:2])
    Zb = Xb[torch.as_tensor(np.random.RandomState(0).choice(Xb.shape[0], 32, replace=False),
                            device="cuda")]
    p = {"hyp": torch.tensor([0.5, 0.5, 0.0], dtype=torch.float64, device="cuda"), "Z": Zb,
         "q_mu": 0.1 * torch.randn((32, 1), **kw), "q_raw": 0.05 * torch.randn((1, 32, 32), **kw)}
    cases.append(("svi_chunk", "bernoulli_probit, banana M=32 (svgp-probit)", svi_chunk,
                  svi_chunk_plain, p, Xb, yb, batches(Xb.shape[0], 256, Kp), None,
                  dict(likelihood="bernoulli_probit"), "bernoulli_probit", 1, False))
    jit = 1e-5
    failed = []
    for dt in (torch.float64, torch.float32):
        tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
        for name, what, kern, plain, p, Xc, yc, ix, eps, extra, lik, draws, js in cases:
            p = {k: v.to(dt).contiguous() for k, v in p.items()}
            zeros = {k: torch.zeros_like(v) for k, v in p.items()}
            X, yt = Xc.to(dt), yc.to(dt)
            args = (p, zeros, dict(zeros), X, yt, ix) + (() if eps is None else (eps.to(dt),))
            akw = dict(t0=0, lr=0.01, **extra)
            out = kern(*args, jit, **akw)
            ref = plain(*args, jit, **akw)
            errs, worst = svi_errs(out, ref)
            e = errs[worst]
            aerr = [abs_err(out[0][k], ref[0][k]) for k in p] + [abs_err(out[3], ref[3])]
            txt, ok = "", e <= (ADAM_TOL[dt] if f32 else TOL[dt])
            if f32:     # both float32 versions against the float64 run from the same inputs
                a64 = tuple({k: v.double() for k, v in a.items()} if isinstance(a, dict)
                            else a.double() if a.is_floating_point() else a for a in args)
                r64 = plain(*a64, jit, **akw)
                (ek, wk), (ep, wp) = svi_errs(out, r64), svi_errs(ref, r64)
                txt = (f"; against float64 from the same inputs: kernel {ek[wk]:.3e} (at "
                       f"{wk}), plain {ep[wp]:.3e} (at {wp})")
                if not ok and ep[wp] > F32_RESOLVES:
                    # float32 cannot resolve this chunk: the kernel must be as
                    # accurate as its plain version, both read against float64
                    ok = ek[wk] <= F32_AS_ACCURATE * ep[wp]
                    txt += (f" (float32 does not resolve this chunk: kernel held to "
                            f"{F32_AS_ACCURATE:g}x the plain version's error)")
            ms = cuda_ms(lambda: kern(*args, jit, **akw), 3)
            pms = cuda_ms(lambda: plain(*args, jit, **akw), 1)
            Kc, nbc = ix.shape
            mc, dc = p["Z"].shape
            ops = Kc * (bsvgp_ops(mc, nbc, dc, draws) if name == "bsvgp_chunk"
                        else svi_ops(mc, nbc, dc, p["q_mu"].shape[1], lik, n_half))
            in_b = nbytes(X, yt, ix, *args[6:]) + 3 * nbytes(*p.values())
            out_b = 3 * nbytes(*p.values()) + nbytes(out[3])
            t_ops, t_b = ops / PEAK_F32_OPS, (in_b + out_b) / PEAK_BYTES
            bound = (max(t_ops, t_b) * 1e3, "operations" if t_ops >= t_b else "bytes")
            print(f"parity {name} {tag} ({what}, K={Kc}, nb={nbc}): max rel err {e:.3e} over "
                  f"losses and parameters (at {worst}){txt}; kernel {ms:.3f} ms, plain "
                  f"{pms:.3f} ms per chunk ({ms / Kc:.4f} ms per step)"
                  + (f", bound {bound[0]:.5f} ms" if f32 else ""))
            if not ok:
                failed.append(f"{name} {tag} {what} rel err {e}{txt}")
            r = res[name]
            r["rel"][tag] = max(r["rel"].get(tag, 0.0), e)
            if f32:
                r["abs32"] = max(r["abs32"], max(aerr))
                if js:                       # the case at its main path's shape
                    r.update(ms=ms, plain_ms=pms, bound=bound)
    assert not failed, "; ".join(failed)
    Zs, hs = Zd.float(), hyp.float()
    Zs = Zs * torch.exp(-hs[:d])
    Kmm = (torch.exp(hs[d]) * torch.exp(-0.5 * torch.cdist(Zs, Zs) ** 2)
           + jit * torch.eye(m, device="cuda"))
    print(f"reference torch.linalg.cholesky_ex f32 of the same Kmm (M={m}): "
          f"{cuda_ms(lambda: torch.linalg.cholesky_ex(Kmm), 20):.4f} ms")


def phase_svi(label, build, train_kw, seed, evaluate, kernel):
    """One SVI main path through a model's entry points, float32: build the
    model, ``train_model(**train_kw)`` with a generator of ``seed``, timed
    once; then ``evaluate(model)`` -> (metric text, gate passed)."""
    torch.cuda.synchronize()
    _build.reset_launches()
    model = build()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    losses, ms = once_ms(lambda: model.train_model(generator=gen, **train_kw))
    (text, ok), t_eval = once_ms(lambda: evaluate(model))
    launches = dict(_build.LAUNCHES)
    n = model.train_x.shape[0]
    steps = train_kw["num_epochs"] * (n // min(train_kw["batch_size"], n))
    print(f"{label} on {CARD}: {ms / 1e3:.3f} s for {steps} Adam steps ({ms / steps:.4f} ms "
          f"per step, {launches[kernel]} launches); epoch loss {float(losses[0]):.4f} -> "
          f"{float(losses[-1]):.4f}; predictive {t_eval / 1e3:.3f} s; {text}")
    check_launches(label, launches, [kernel])
    assert torch.isfinite(losses).all() and float(losses[-1]) < float(losses[0]), label
    assert ok, f"{label}: {text}"
    return launches


def svi_paths(Xd, yd, Xte, yte):
    """The SVI main paths by name, float32, at the protocols of the
    experiments: experiments/regression.py (SVGP, BayesianSVGP: M=100 rows
    drawn by RandomState(45), batch 200, 200 epochs) and
    experiments/classification_banana.py (banana probit SVGP: M=32, batch
    256, 800 epochs, lr 0.03; softmax SVGP: Z = X[::6], batch 200, 500
    epochs, lr 0.05). The gates sit a margin beyond the JAX package's CPU
    run of the same protocols (svi_reference.py: RMSE 0.6152 and NLPD 0.9059
    for svgp, 0.6226 and 0.9266 for bsvgp, test accuracy 0.8875, rate MAE
    0.3097, train accuracy 0.7252), which draws other permutations."""
    X, y, Xt, yt = (a.float() for a in (Xd, yd, Xte, yte))
    Xn, Xtn, yn = X.double().cpu().numpy(), Xt.double().cpu().numpy(), y.double().cpu().numpy()
    Z = svi_inducing(Xn)
    f = dict(dtype=torch.float32, device="cuda")

    def gauss_eval(model):
        mean, var = model.posterior_predictive(Xt)
        r, nl = float(rmse(mean, yt)), float(nlpd(mean, var, yt))
        return f"held-out RMSE {r:.4f}, NLPD {nl:.4f}", r <= 0.70 and nl <= 1.05

    def bsvgp_eval(model):
        means, vars_ = model.mixture_posterior_predictive(Xt, num_samples=100)
        r, nl = float(rmse(means.mean(0), yt)), float(nlpd_mixture(means, vars_, yt))
        vec = model.params["hyper_L_vec"]      # the trained spread of q(theta): L_h's diagonal
        diag = torch.exp(vec[torch.arange(1, model.hyper_dim + 1, device=vec.device).cumsum(0) - 1])
        return (f"mixture ({means.shape[0]} components) held-out RMSE {r:.4f}, NLPD {nl:.4f}; "
                f"trained L_h diagonal {float(diag.min()):.4f}-{float(diag.max()):.4f} "
                f"(median {float(diag.median()):.4f})",
                means.shape[0] == 100 and r <= 0.70 and nl <= 1.05)

    Xb, yb, Xbt, ybt = (torch.tensor(a, **f) for a in make_banana())
    Zb = Xb[torch.as_tensor(np.random.RandomState(0).randint(0, Xb.shape[0], 32), device="cuda")]

    def probit_eval(model):
        p, _ = model.posterior_predictive(Xbt)
        acc = float(((p > 0.5).float() == ybt).float().mean())
        return f"test accuracy {acc:.4f}", acc >= 0.84

    yc, _, rate_t = (torch.tensor(a, **f) for a in make_counts(Xn, Xtn))

    def poisson_eval(model):
        r, _ = model.posterior_predictive(Xt)
        mae = float((r - rate_t).abs().mean())
        return f"held-out rate MAE {mae:.4f}", mae <= 0.45

    ycl = torch.tensor(make_classes(yn), **f)

    def softmax_eval(model):
        p, _ = model.posterior_predictive(X)
        acc = float((p.argmax(-1).float() == ycl).float().mean())
        return f"train accuracy {acc:.4f}", acc >= 0.65

    reg = dict(num_epochs=200, batch_size=200, lr=0.01)
    return {
        "svgp": lambda: phase_svi(
            "svgp", lambda: StochasticVariationalGP(X, y, Z_init=torch.tensor(Z, **f)), reg, 45,
            gauss_eval, "svi_chunk"),
        "svgp-probit": lambda: phase_svi(
            "svgp-probit", lambda: StochasticVariationalGP(Xb, yb, likelihood=BernoulliProbit(),
                                                           Z_init=Zb),
            dict(num_epochs=800, batch_size=256, lr=0.03), 0, probit_eval, "svi_chunk"),
        "svgp-poisson": lambda: phase_svi(
            "svgp-poisson", lambda: StochasticVariationalGP(X, yc, likelihood=PoissonLogCox(),
                                                            Z_init=torch.tensor(Z, **f)),
            reg, 45, poisson_eval, "svi_chunk"),
        "svgp-softmax": lambda: phase_svi(
            "svgp-softmax", lambda: StochasticVariationalGP(X, ycl, likelihood=Softmax(3),
                                                            Z_init=X[::6]),
            dict(num_epochs=500, batch_size=200, lr=0.05), 2, softmax_eval,
            "svi_softmax_chunk"),
        "bsvgp": lambda: phase_svi(
            "bsvgp", lambda: BayesianStochasticVariationalGP(X, y, Z_init=torch.tensor(Z, **f),
                                                             prior_var=1.0),
            reg, 45, bsvgp_eval, "bsvgp_chunk"),
    }


def phase_gpr_parts(Xd, yd):
    """Where one float32 evaluation of the gpr core goes at (N, D) =
    (404, 13): the six parts of csrc/gpr_bound.cuh timed as prefixes (grams;
    + Cholesky; + inverse; + substitutions; + V V^T and P; + the rest of
    the adjoint), and, as the yardstick of a faster factorisation, the time
    of torch.linalg.cholesky_ex + torch.cholesky_inverse on the same K.
    Then the whole evaluation at bench.py's winered shape (N=1279, D=11),
    against the plain version once."""
    X, y = Xd.float(), yd.float()
    n, d = X.shape
    Z = X.new_empty((0, d))
    row = torch.tensor([0.5] * d + [0.0, -2.0], device="cuda")
    prefix = [cuda_ms(lambda: call_potential("gpr", row[None], X, y, Z, 1e-5, stages=s), 20)
              for s in range(1, 7)]
    parts = [prefix[0]] + [b - a for a, b in zip(prefix, prefix[1:])]
    names = ("grams", "Cholesky", "inverse U^-1", "substitutions", "V V^T and P",
             "rest of the adjoint")
    print(f"gpr evaluation parts f32 (N={n}, D={d}, on {CARD}): "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in zip(names, parts))
          + f"; whole {prefix[-1]:.4f} ms")
    ls = torch.exp(-row[:d]).clamp(max=1024.0 / float(X.abs().max()))
    Xs = X * ls
    K = (torch.exp(row[d]) * torch.exp(-0.5 * torch.cdist(Xs, Xs) ** 2)
         + (torch.exp(row[d + 1]) + 1e-5) * torch.eye(n, device="cuda"))

    def lib():
        L, _ = torch.linalg.cholesky_ex(K)
        return torch.cholesky_inverse(L)
    print(f"reference torch.linalg.cholesky_ex + torch.cholesky_inverse f32 on the "
          f"same K: {cuda_ms(lib, 20):.4f} ms")
    Xw, yw, *_ = (torch.tensor(a, dtype=torch.float32, device="cuda")
                  for a in make_data("winered"))
    nw, dw = Xw.shape
    Zw = Xw.new_empty((0, dw))
    th = torch.tensor([0.5] * dw + [0.0, -2.0], device="cuda")
    out = vfe_potential(th, Xw, yw, Zw, 1e-5, core="gpr")
    ref = gpr_neg_logpost_vg(th, Xw, yw, 1e-5)
    e = max(rel(a, b) for a, b in zip(out, ref))
    ms = cuda_ms(lambda: vfe_potential(th, Xw, yw, Zw, 1e-5, core="gpr"), 3)
    print(f"envelope gpr_potential f32 at winered shape (N={nw}, D={dw}): {ms:.3f} ms "
          f"per call (3 calls), max rel err against the plain version {e:.3e}, "
          f"scratch {_build.build().ggp_scratch_elems(2, nw, 0, dw) * 4 / 1e6:.1f} MB")
    assert all(torch.isfinite(a).all() for a in out)


def phase_gpr(Xd, yd, Xte, yte, label, num_chains=1, num_warmup=50, num_samples=10,
              reps=2, untimed_first=True):
    """bench.py ``cell_gpr_hmc`` (bench.py:215-234) through the port, float32:
    GPR_HMC(X, y), ``train_model`` once untimed (generator seed 99) when
    ``untimed_first``, then the min of ``reps`` timed runs (seed 0); then
    the full mixture predictive on the held-out rows."""
    X, y, Xt, yt = (a.to(torch.float32) for a in (Xd, yd, Xte, yte))
    d = X.shape[1]
    torch.cuda.synchronize()
    _build.reset_launches()
    model = GPR_HMC(X, y)

    def run(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return model.train_model(num_warmup, num_samples, num_chains=num_chains,
                                 generator=gen)
    first = (f"; first untimed run {once_ms(lambda: run(99))[1] / 1e3:.3f} s"
             if untimed_first else "")
    times = []
    for _ in range(reps):
        tr, ms = once_ms(lambda: run(0))
        times.append(ms / 1e3)
    (means, vars_), t_pred = once_ms(lambda: model.full_mixture_posterior_predictive(Xt))
    launches = dict(_build.LAUNCHES)
    secs = min(times)
    st = model.stats
    div = float(st["diverging"].float().mean())
    acc = float(st["accept_prob"].mean())
    leaps = float(st["n_leapfrog"].sum() + st["warmup_n_leapfrog"].sum())
    trace = tr.double().cpu().numpy()
    ess = min_ess_per_s(trace, secs)
    r = float(rmse(means.mean(0), yt))
    nl = float(nlpd_mixture(means, vars_, yt))
    rhat = ""
    if num_chains > 1:
        chains = trace.reshape(num_chains, -1, d + 2)
        rhat = (f"; max split-R-hat "
                f"{max(split_rhat(chains[:, :, j]) for j in range(d + 2)):.4f}")
    print(f"{label} sampling on {CARD} ({num_chains} chain(s) x ({num_warmup} warmup + "
          f"{num_samples} draws), NUTS): {secs:.3f} s (min of "
          f"{', '.join(f'{t:.3f}' for t in times)}{first}); "
          f"divergence fraction {div:.4f}; mean accept {acc:.4f}; min-ESS/s {ess:.3f}; "
          f"step size {', '.join(f'{e:.4g}' for e in st['step_size'].reshape(-1).tolist())}; "
          f"mean leapfrogs/draw {float(st['n_leapfrog'].mean()):.1f}; "
          f"{secs * 1e3 * num_chains / leaps:.3f} ms per leapfrog of a chain "
          f"({leaps:.0f} leapfrogs, warmup included){rhat}")
    print(f"{label} predictive ({means.shape[0]} components, {Xt.shape[0]} held-out rows): "
          f"{t_pred / 1e3:.3f} s; RMSE {r:.4f}; NLPD {nl:.4f}")
    pot, chunk = (("gpr_potential", "gpr_nuts_chunk") if num_chains == 1
                  else ("gpr_mc_potential", "gpr_mc_nuts_chunk"))
    check_launches(label, launches, [pot, chunk])
    assert trace.shape == (num_chains * num_samples, d + 2) and np.isfinite(trace).all()
    assert div <= 0.1, f"{label} divergence fraction {div}"
    assert acc >= 0.5, f"{label} mean accept {acc}"
    assert means.shape == (num_chains * num_samples, Xt.shape[0]) == vars_.shape
    assert torch.isfinite(means).all() and torch.isfinite(vars_).all()
    assert math.isfinite(nl) and r < 1.0, (r, nl)
    return launches


def gpr_paths(X, y, Xte, yte):
    """The GPR+HMC main paths by name."""
    return {
        "gpr-hmc": lambda: phase_gpr(X, y, Xte, yte, "gpr-hmc"),
        "gpr-c4": lambda: phase_gpr(X, y, Xte, yte, "gpr-c4", num_chains=4,
                                    num_warmup=100, num_samples=25, reps=1,
                                    untimed_first=False),
    }


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


def phase_joint(Xd, yd, Zd, Xte, yte, label, num_chains=1, algorithm="hmc",
                num_warmup=500, num_samples=500):
    """bench.py ``cell_joint_hmc`` (bench.py:237-258) through the port,
    float32, on bench.py's Z: SGPMC warm start 100 steps, then
    ``train_model`` (``num_chains`` chains, HMC with L=10 or NUTS), timed
    once; then the 50-component mixture predictive on the held-out rows."""
    X, y, Z, Xt, yt = (a.to(torch.float32) for a in (Xd, yd, Zd, Xte, yte))
    d = X.shape[1]
    torch.cuda.synchronize()
    _build.reset_launches()
    model = SGPMC(X, y, Z_init=Z)
    losses, t_warm = once_ms(lambda: model.warm_start(num_steps=100, lr=0.01))
    print(f"{label} warm_start: {t_warm / 1e3:.3f} s, loss {float(losses[0]):.3f} -> "
          f"{float(losses[-1]):.3f}")
    assert torch.isfinite(losses).all() and float(losses[-1]) < float(losses[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    tr, ms = once_ms(lambda: model.train_model(num_warmup, num_samples,
                                               num_chains=num_chains, generator=gen,
                                               algorithm=algorithm, num_leapfrog=10))
    (means, vars_), t_pred = once_ms(lambda: model.mixture_posterior_predictive_y(Xt, 50))
    launches = dict(_build.LAUNCHES)
    secs = ms / 1e3
    st = model.stats
    div = float(st["diverging"].float().mean())
    acc = float(st["accept_prob"].mean())
    trace = tr.double().cpu().numpy()
    ess = min_ess_per_s(trace[:, :d + 2], secs)          # hypers only (bench.py:256)
    r = float(rmse(means.mean(0), yt))
    nl = float(nlpd_mixture(means, vars_, yt))
    rhat = ""
    if num_chains > 1:
        chains = trace.reshape(num_chains, -1, trace.shape[1])
        rhat = (f"; max split-R-hat over the hypers "
                f"{max(split_rhat(chains[:, :, j]) for j in range(d + 2)):.4f}")
    print(f"{label} sampling on {CARD} ({num_chains} chain(s) x ({num_warmup} warmup + {num_samples} "
          f"draws), {algorithm}{', L=10' if algorithm == 'hmc' else ''}): {secs:.3f} s; "
          f"divergence fraction {div:.4f}; mean accept {acc:.4f}; hyper min-ESS/s "
          f"{ess:.3f}; step size {', '.join(f'{e:.4g}' for e in st['step_size'].reshape(-1).tolist())}; "
          f"mean leapfrogs/draw {float(st['n_leapfrog'].float().mean()):.1f}{rhat}")
    print(f"{label} predictive ({means.shape[0]} components, {Xt.shape[0]} held-out rows): "
          f"{t_pred / 1e3:.3f} s; RMSE {r:.4f}; NLPD {nl:.4f}")
    pot, chunk = (("sgpmc_potential", f"sgpmc_{algorithm}_chunk") if num_chains == 1
                  else ("sgpmc_mc_potential", f"sgpmc_mc_{algorithm}_chunk"))
    check_launches(label, launches, ["sgpmc_warm_chunk", pot, chunk])
    assert trace.shape == (num_chains * num_samples, d + 2 + Z.shape[0])
    assert np.isfinite(trace).all()
    assert div <= 0.1, f"{label} divergence fraction {div}"
    assert acc >= 0.5, f"{label} mean accept {acc}"
    assert means.shape == (min(50, trace.shape[0]), Xt.shape[0]) == vars_.shape
    assert torch.isfinite(means).all() and torch.isfinite(vars_).all()
    assert math.isfinite(nl) and r < 1.0, (r, nl)
    return launches


def joint_paths(X, y, Z, Xte, yte):
    """The JointHMC main paths by name."""
    return {
        "joint-hmc": lambda: phase_joint(X, y, Z, Xte, yte, "joint-hmc"),
        "joint-nuts": lambda: phase_joint(X, y, Z, Xte, yte, "joint-nuts",
                                          algorithm="nuts", num_warmup=100,
                                          num_samples=50),
        "joint-c4": lambda: phase_joint(X, y, Z, Xte, yte, "joint-c4", num_chains=4,
                                        num_warmup=100, num_samples=100),
        "joint-c4-nuts": lambda: phase_joint(X, y, Z, Xte, yte, "joint-c4-nuts",
                                             num_chains=4, algorithm="nuts",
                                             num_warmup=100, num_samples=50),
    }


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


def profile_paths(X, y, Z, Xte, yte, names):
    """Each named main path once under torch.profiler (CPU and CUDA
    activities), after a warm-up of the kernels and library handles."""
    paths = {"slice": lambda: phase_rounds(X, y, Z, 1, "slice"),
             "hmc-c8": lambda: phase_hmc_c8(X, y, Z),
             "mc-nuts": lambda: phase_rounds(X, y, Z, 4, "mc-nuts"),
             **joint_paths(X, y, Z, Xte, yte), **gpr_paths(X, y, Xte, yte),
             **svi_paths(X, y, Xte, yte)}
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
    global CARD
    CARD = smi
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in register_report():
        print(line)
    X, y, Z, Xte, yte = (torch.tensor(a, dtype=torch.float64, device="cuda")
                         for a in make_data())
    if argv[:1] == ["--profile"]:
        profile_paths(X, y, Z, Xte, yte, argv[1:])
        return
    distinct = np.random.default_rng(174).choice(X.shape[0], Z.shape[0], replace=False)
    Zd = X[torch.as_tensor(distinct, device="cuda")]
    res = new_res()
    phase_parity(X, y, Zd, res)
    phase_parity_mc(X, y, Zd, res)
    phase_parity_sgpmc(X, y, Zd, res)
    phase_parity_gpr(X, y, res)
    phase_parity_svi(X, y, Zd, res)
    print(f"parity done at {time.perf_counter() - T_START:.1f} s")
    launches = {k: 0 for k in KERNELS}
    for run in (lambda: phase_rounds(X, y, Z, 1, "slice"),
                lambda: phase_hmc_c8(X, y, Z),
                lambda: phase_rounds(X, y, Z, 4, "mc-nuts"),
                *joint_paths(X, y, Z, Xte, yte).values(),
                *gpr_paths(X, y, Xte, yte).values(),
                *svi_paths(X, y, Xte, yte).values()):
        for k, v in run().items():
            if k in launches:
                launches[k] += v
        print(f"main paths at {time.perf_counter() - T_START:.1f} s")
    phase_scaling(X, y, Z)
    phase_gpr_parts(X, y)
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
