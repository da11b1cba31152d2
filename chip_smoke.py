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
   The JointHMC (SGPMC) kernels, the grouped sgpmc core of the sampler
   kernels and of the warm start (csrc/sgpmc_group.cuh, at every n), are
   held the same way at the same shape (state row d+2+M = 115), at one
   chain and 8, the warm start also one step at a time from SGPMC's
   initial state, with a sweep of the group's size G there (the chunks at
   C = 1 and 4, the potential at C = 8, the warm start; in float64 the
   potential's dU/dZ and the warm start at every G); and the GPR+HMC kernels, the dense
   "gpr" core of the potential and NUTS kernels (a group of blocks per
   chain), at N=404, D=13 (state row d+2 = 15), for one chain and for 8,
   each launched twice for bit-identical outputs, and the potential at
   bench.py's winered shape (N=1279, D=11); and the three SVI kernels (svi_chunk
   with its Gaussian, Bernoulli-probit and Poisson terms, bsvgp_chunk at
   S=5 with q(theta) at spread 0.1 and 1, svi_softmax_chunk at C=3,
   n_half=32), one chunk of 16 Adam steps at M=100, batch 200, and one of
   64 steps at the shapes svgp-softmax (M=68) and svgp-probit (banana,
   M=32, batch 256) launch, beside cholesky_ex of the same Kmm; and the
   big-N statistics kernels (vfe_stats_fwd, vfe_stats_bwd) at the SGHMC
   step's shape (C=4, B=2048 rows gathered by index from 1e6, M=100,
   D=18), the anchor's (N=1e6, C=2), each stationary family (N=3000, Z
   rows from X) and bf16 once, with the peak memory of a full-N call and
   cuBLAS's product on a materialised K; the warm start's trainers at N=404
   (sgpr_adam_chunk, one block; sgpr_adam_group, the grouped vfe core,
   which sgpr_adam_chunk takes past 2048 rows) and the grouped one at the
   SGHMC experiment's warm-start shape (n=4096, 200 steps); optimize_Z's chunk
   (z_adam_chunk, kernel 12 at every n) at N=404, S=10 and at the
   reg-large path's shape (synthetic-large: n=13,279, D=18, M=100, 40
   trace rows, 20 steps; in float64 also against the JAX package's Z
   steps, REGRESSION_REF); at that n the grouped vfe core (vfe_potential
   at one chain, mc_potential and an mc_nuts_chunk pair at C=2, each also
   launched twice for bit-identical outputs), a scaling line of both vfe
   designs at n = 1279, 4096, 13,279, and the grouped trainer's 20 steps
   from the path's start, with both trainers' time a step; the grouped
   sgpmc core (sgpmc_group_potential at one chain and C=2, NUTS chunk pairs
   at one chain and C=2, HMC chunk pairs at one chain and C=2) and the
   grouped vfe HMC chunk (C=2 and 8), each launched twice for bit-identical
   outputs, the warm start at that n (from the path's start one step at a
   time, and a chunk from the chains' state), and a scaling line of the
   grouped sgpmc core at n = 404, 1279, 4096, 13,279;
   the co2 cores
   (co2_potential, co2_nuts_chunk) and the one-transition kernel
   (nuts_transition, vfe and co2) at the Mauna Loa experiment's shape
   (N=541, D=1, M=480), in float64 and float32;
4. the main paths through the models' entry points, in float32, each with
   the launch counters set to 0 just before it and read just after:
   a. slice: BayesianSparseGPR_HMC as bench.py's headline cell drives it
      (warm start 500 steps, single-chain NUTS rounds (100,20),(25,10),
      (25,10),(100,20) with 50 Z steps between rounds, mixture predictive);
   b. HMC-C8: bench.py's ``cell_hmc_throughput`` (warm start 500 steps,
      then 8 chains of HMC, L=10, 250 warmup + 250 draws), timed once;
   c. multichain NUTS: the slice's rounds with 4 chains, 25 Z steps
      between rounds;
   d. joint-hmc: bench.py's ``cell_joint_hmc`` (SGPMC warm start 100
      steps, then one chain of HMC, L=10, 250 warmup + 250 draws), timed
      once, and the 50-component mixture predictive on the held-out 20 %;
   e. joint-nuts: SGPMC, one chain of NUTS, 50 warmup + 25 draws;
   f. joint-c4: SGPMC, 4 chains of HMC, L=10, 50 warmup + 50 draws;
   g. joint-c4-nuts: SGPMC, 4 chains of NUTS, 50 warmup + 25 draws;
   h. gpr-hmc: bench.py's ``cell_gpr_hmc`` (GPR_HMC, one chain of NUTS, 50
      warmup + 10 draws, one timed run), and the full mixture predictive
      on the held-out 20 %;
   i. gpr-c4: GPR_HMC, 4 chains of NUTS, 50 warmup + 10 draws;
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
   o. sghmc-1m: bench.py's ``cell_sghmc_1m`` (synthetic-large tiled to
      N=1e6, M=100, 2 chains x 2000 SGHMC steps with the SVRG anchor,
      after an untimed 20-step run), steps/s and finite draws; then the
      same protocol on 100,000 rows, its kept draws' mean log-hypers held
      against the JAX package's CPU run (sghmc_reference.py);
   p. sghmc-exp: the port's experiments/large_scale_regression_sghmc.py
      ``main()`` at N=1e6 (SparseGPR warm start on 4096 rows, SGHMC as o,
      30-component mixture predictive), held-out RMSE and NLPD; then at
      100,000 rows, its warm start's loss and log-noise and the kept
      draws' mean log-hypers held against the JAX package's CPU run;
   q. co2: the Mauna Loa experiment's model (experiments/
      co2_bayesian_sgpr_hmc.py ``co2_model``) at full width in float64
      (warm start 1500 steps, the fixed-Z chunked sampler cut to
      CO2_PROTOCOL's transitions, the mixture predictive), held to health
      gates and to the JAX package's CPU run of the same cut
      (co2_reference.py, CO2_REF); co2-f32: the same in float32 (finite
      outputs); co2-alt: the alternating trainer's NUTS rounds, cut, each
      of which must move;
   r. reg-large: the port's regression driver (experiments/regression.py
      ``single_run("synthetic-large", 0, "BayesianSGPR_HMC")``: 13,279
      rows, D=18, M=100, warm start 500, three NUTS rounds of 2 chains on
      the grouped vfe core, 500 Z steps after each on kernel 12, the
      mixture predictive), held to health gates and to the JAX package's
      CPU run (regression_reference.py, REGRESSION_REF);
   s. joint-large: the same regression driver's JointHMC protocol (``single_run(
      "synthetic-large", 0, "JointHMC")``: warm start 100 steps, one chain
      of NUTS on the grouped sgpmc core, cut to 50 + 25, the 50-component
      predictive), held to health gates and to the JAX package's CPU run
      of the same cut (joint_reference.py, JOINT_REF_FILE);
   t. joint-large-c2: train_sgp_hmc on the same data, 2 chains of HMC
      (L=10), 50 + 50, on the grouped HMC chunk;
   u. hmc-large: bench.py's ``cell_hmc_throughput`` on the same data (8
      chains of HMC, L=10, 50 + 50) on the grouped vfe HMC chunk;
5. mc_potential's time at C = 1, 8 and 32 chains (do blocks slow each
   other?); where one gpr evaluation's time goes (its six parts, timed as
   prefixes), beside cholesky_ex + cholesky_inverse of the same K;
6. a JSON line of per-kernel results, then the final status line.

Every kernel's ``bound_ms`` is the least time the card could take for the
work of the timed call: the larger of its operations over the float32 peak
(for the ``*_f64`` extras, the matrix products over the float64 tensor
cores' peak and the rest over float64's) and its bytes (inputs read once,
outputs written once) over the memory rate. The operations are the least
the call's evaluations of its core need (:func:`bound_ops`,
:func:`sgpmc_ops`, :func:`gpr_ops`, :func:`co2_ops`, :func:`svi_ops`,
:func:`bsvgp_ops`, ``ops.vfe_stats.stats_ops``), not those the kernel
happens to do.

    python3 chip_smoke.py co2
    python3 chip_smoke.py reg-large
    python3 chip_smoke.py gpr
    python3 chip_smoke.py joint-large
    python3 chip_smoke.py sweep

run only the build, the co2 parity and the three co2 paths; or the build,
the parity at the reg-large shape (the grouped trainer held there among
them) and the reg-large path; or the build, the gpr core's parity, the
gpr-hmc and gpr-c4 paths and the gpr core's parts; or the build, the
grouped sgpmc and HMC kernels' parity at the reg-large shape and the
joint-large, joint-large-c2 and hmc-large paths; or the build and the sweep
of the grouped sgpmc core's G at N=404.

    python3 chip_smoke.py --profile [slice] [hmc-c8] [mc-nuts] [joint-hmc] ...
                                    [gpr-hmc] [gpr-c4] [svgp] [svgp-probit]
                                    [svgp-poisson] [svgp-softmax] [bsvgp]
                                    [sghmc-1m] [sghmc-exp] [co2] [co2-f32]
                                    [co2-alt] [reg-large] [joint-large]
                                    [joint-large-c2] [hmc-large]

runs the named main paths instead (default: all) once each under
``torch.profiler`` after a short warm-up, and prints where the device time
goes: time and launches by kernel, and the device busy share.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ggp_tpu_torch import (GPR_HMC, SGPMC, BayesianSparseGPR_HMC,
                           BayesianStochasticVariationalGP, StochasticVariationalGP)
from ggp_tpu_torch.models import train_sgp_hmc
from ggp_tpu_torch.experiments.co2_bayesian_sgpr_hmc import (co2_model, extrapolation,
                                                             init_co2_params)
from ggp_tpu_torch.experiments.co2_data import load_co2_dataset
from ggp_tpu_torch.experiments.large_scale_regression_sghmc import main as sghmc_main
from ggp_tpu_torch.experiments.large_scale_regression_sghmc import tiled_data
from ggp_tpu_torch.experiments.regression import run_data, single_run
from ggp_tpu_torch.inference.diagnostics import effective_sample_size, split_rhat
from ggp_tpu_torch.inference.hmc import (find_reasonable_step_size,
                                         find_reasonable_step_size_batched)
from ggp_tpu_torch.inference.sghmc import SGHMCConfig, ravel_tree, run_sghmc
from ggp_tpu_torch.kernels import default_rbf
from ggp_tpu_torch.likelihoods import BernoulliProbit, PoissonLogCox, Softmax
from ggp_tpu_torch.ops import _build, vfe_group
from ggp_tpu_torch.ops.gpr_bound import gpr_neg_logpost_vg
from ggp_tpu_torch.ops.multichain import (draw_mc_slabs, hmc_chunk, mc_hmc_chunk,
                                          mc_hmc_chunk_plain, mc_nuts_chunk,
                                          mc_nuts_chunk_plain, mc_potential,
                                          mc_potential_plain)
from ggp_tpu_torch.ops.co2_bound import co2_potential, co2_vfe_neg_logpost_vg
from ggp_tpu_torch.ops.nuts_chunk import (ChainState, as_batch, draw_slabs,
                                          first_chain, launch_chunk, nuts_chunk,
                                          nuts_chunk_plain,
                                          nuts_transition, nuts_transition_plain)
from ggp_tpu_torch.ops.sgpmc_bound import sgpmc_neg_logpost_vg
from ggp_tpu_torch.ops.sgpmc_warm import (CLIP_NORM, call_sgpmc_warm, sgpmc_warm_chunk,
                                          sgpmc_warm_chunk_plain)
from ggp_tpu_torch.ops.sgpr_adam import (PIVOT_FLOOR, call_sgpr_adam, sgpr_adam_chunk,
                                         sgpr_adam_chunk_plain, z_adam_chunk, z_adam_chunk_plain,
                                         z_adam_stream, z_adam_stream_plain)
from ggp_tpu_torch.ops.svi import (bsvgp_chunk, bsvgp_chunk_plain, svi_chunk, svi_chunk_plain,
                                   svi_softmax_chunk, svi_softmax_chunk_plain)
from ggp_tpu_torch.models.sgpr import sgpr_elbo_from_stats, vfe_stats
from ggp_tpu_torch.ops.vfe_bound import (call_potential, neg_logpost_vg,
                                         rbf_vfe_neg_logpost_vg, state_dim, vfe_potential)
from ggp_tpu_torch.ops.vfe_stats import (FAMILIES, stats_ops, vfe_stats_bwd,
                                         vfe_stats_bwd_plain, vfe_stats_fwd,
                                         vfe_stats_fwd_plain)
from ggp_tpu_torch.priors import log_prior, prior_tree_rbf
from ggp_tpu_torch.utils.datasets import normalize
from ggp_tpu_torch.utils.metrics import nlpd, nlpd_mixture, rmse
from ggp_tpu_torch.utils.tree import ravel

# name: (source, the pallas_call it replaces, the other one it replaces)
KERNELS = {
    "vfe_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                      "ggp_tpu/ops/fused_nuts.py:807", None),
    "nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                   "ggp_tpu/ops/fused_nuts.py:780", "ggp_tpu/ops/fused_nuts.py:792"),
    "sgpr_adam_chunk": ("ggp_tpu_torch/csrc/sgpr_adam.cu", "ggp_tpu/ops/fused_sgpr.py:434", None),
    # the warm start past 2048 rows (site 6's streamed function) on the grouped
    # vfe core: sgpr_adam_group_kernel, G blocks of one cooperative launch
    "sgpr_adam_group": ("ggp_tpu_torch/csrc/sgpr_adam.cu", "ggp_tpu/ops/fused_sgpr.py:420",
                        None),
    # optimize_Z's chunk at every n on the card: kernel 12, a grid over trace
    # rows and row blocks (site 7's resident and site 8's streamed function)
    "z_adam_chunk": ("ggp_tpu_torch/csrc/z_adam_stream.cu",
                     "ggp_tpu/ops/fused_sgpr.py:352", "ggp_tpu/ops/fused_sgpr.py:338"),
    "mc_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                     "ggp_tpu/ops/fused_multichain.py:1933", None),
    "mc_hmc_chunk": ("ggp_tpu_torch/csrc/mc_hmc_chunk.cu",
                     "ggp_tpu/ops/fused_multichain.py:1985",
                     "ggp_tpu/ops/fused_multichain.py:1997"),
    "mc_nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                      "ggp_tpu/ops/fused_multichain.py:1954",
                      "ggp_tpu/ops/fused_multichain.py:1966"),
    # the JointHMC warm start on the grouped sgpmc core, at every n
    "sgpmc_warm_group": ("ggp_tpu_torch/csrc/sgpmc_warm.cu",
                         "ggp_tpu/ops/fused_sgpmc.py:131", None),
    # the "gpr" core (csrc/gpr_bound.cuh: a group of blocks per chain, a
    # blocked factorisation); the JAX package ran C chains of GPR on its XLA
    # sampler, the port runs the same sites' core for C chains
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
    # the big-N statistics (csrc/vfe_stats.cu), C chains, rows gathered in the kernel
    "vfe_stats_fwd": ("ggp_tpu_torch/csrc/vfe_stats.cu", "ggp_tpu/ops/pallas_vfe.py:152", None),
    "vfe_stats_bwd": ("ggp_tpu_torch/csrc/vfe_stats.cu", "ggp_tpu/ops/pallas_vfe.py:238", None),
    # the co2 cores (csrc/co2_bound.cuh) of the potential and NUTS chunk kernels
    # (ggp_tpu/ops/fused_bound.py:815), and the one-transition kernel (cores vfe, co2)
    "co2_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                      "ggp_tpu/ops/fused_nuts.py:807", None),
    "co2_nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                       "ggp_tpu/ops/fused_nuts.py:780", "ggp_tpu/ops/fused_nuts.py:792"),
    "nuts_transition": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                        "ggp_tpu/ops/fused_nuts.py:770", None),
    # the vfe core on a group of blocks per chain (csrc/vfe_group.cuh), where
    # the JAX package streams it (fused_multichain.py:572, fused_bound.py:1090):
    # past 1024 rows for C >= 2 chains, past 2048 for one
    "vfe_group_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                            "ggp_tpu/ops/fused_multichain.py:1933",
                            ("ggp_tpu/ops/fused_nuts.py:807",)),
    "vfe_group_nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                             "ggp_tpu/ops/fused_multichain.py:1954",
                             ("ggp_tpu/ops/fused_multichain.py:1966",
                              "ggp_tpu/ops/fused_nuts.py:780", "ggp_tpu/ops/fused_nuts.py:792")),
    "vfe_group_hmc_chunk": ("ggp_tpu_torch/csrc/mc_hmc_chunk.cu",
                            "ggp_tpu/ops/fused_multichain.py:1985",
                            ("ggp_tpu/ops/fused_multichain.py:1997",)),
    # the sgpmc core on a group of blocks per chain (csrc/sgpmc_group.cuh) at
    # every n: the JAX package's resident core (fused_bound.py:1435) and its
    # streamed cores (fused_bound.py:1577, fused_multichain.py:907)
    "sgpmc_group_potential": ("ggp_tpu_torch/csrc/sgpmc_group.cu",
                              "ggp_tpu/ops/fused_nuts.py:807",
                              ("ggp_tpu/ops/fused_multichain.py:1933",)),
    "sgpmc_group_nuts_chunk": ("ggp_tpu_torch/csrc/sgpmc_group.cu",
                               "ggp_tpu/ops/fused_nuts.py:780",
                               ("ggp_tpu/ops/fused_nuts.py:792",
                                "ggp_tpu/ops/fused_multichain.py:1954",
                                "ggp_tpu/ops/fused_multichain.py:1966")),
    "sgpmc_group_hmc_chunk": ("ggp_tpu_torch/csrc/sgpmc_group.cu",
                              "ggp_tpu/ops/fused_multichain.py:1985",
                              ("ggp_tpu/ops/fused_multichain.py:1997",
                               "ggp_tpu/ops/fused_nuts.py:780", "ggp_tpu/ops/fused_nuts.py:792")),
}
# a KERNELS entry whose launches are the sum of several counters (one per
# core, or per wrapper of one kernel)
LAUNCH_SUMS = {"nuts_transition": ("nuts_transition_vfe", "nuts_transition_co2"),
               "z_adam_chunk": ("z_adam_stream",),
               "vfe_group_potential": ("vfe_group_potential", "vfe_group_mc_potential"),
               "vfe_group_nuts_chunk": ("vfe_group_nuts_chunk", "vfe_group_mc_nuts_chunk"),
               "vfe_group_hmc_chunk": ("vfe_group_hmc_chunk", "vfe_group_mc_hmc_chunk"),
               **{f"sgpmc_group_{k}": (f"sgpmc_group_{k}", f"sgpmc_group_mc_{k}")
                  for k in ("potential", "nuts_chunk", "hmc_chunk")}}
CO2_KERNELS = ("co2_potential", "co2_nuts_chunk", "nuts_transition")
GPR_KERNELS = ("gpr_potential", "gpr_nuts_chunk", "gpr_mc_potential", "gpr_mc_nuts_chunk")
# the kernels the reg-large path launches
REG_KERNELS = ("sgpr_adam_group", "z_adam_chunk", "vfe_group_potential", "vfe_group_nuts_chunk")
# the kernels the joint-large, joint-large-c2 and hmc-large paths launch
JOINT_KERNELS = ("sgpmc_warm_group", "sgpmc_group_potential", "sgpmc_group_nuts_chunk",
                 "sgpmc_group_hmc_chunk", "sgpr_adam_group", "vfe_group_potential",
                 "vfe_group_hmc_chunk")
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
# The statistics kernels against their plain versions: the same sums in
# another order, over up to 1e6 rows (float32 ~1e-6-1e-5 relative; the
# float32 results are also held against float64 from the same inputs).
STATS_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# The sghmc-exp gates: ~2 % beyond the JAX package's CPU run of the same
# protocol (sghmc_reference.py: test RMSE 2.0418 at 100,000 rows and 2.0482
# at 200,000, mixture NLPD 2.1337 and 2.1365, in the data's units), which
# draws other minibatches and warm-starts on its XLA Adam. On this data set
# the fit explains y as noise in both packages: a predictor of 0 scores
# RMSE 2.0325 (the test y's root mean square) and NLPD ~2.128, so these
# gates check the output's sanity only. What the protocols move is held by
# SGHMC_REF.
SGHMC_EXP_GATES = {"rmse": 2.08, "nlpd": 2.18}
# The JAX package's CPU runs of sghmc-exp and of bench.py's SGHMC-1M
# protocol at 100,000 rows (sghmc_reference.py, float32): the warm start's
# final loss and log-hypers, the kept draws' mean log-hypers pooled and per
# chain, in the order [log_lengthscale (18), log_outputscale, log_noise].
SGHMC_REF = {
    "sghmc-exp": {
        "n_rows": 100000,
        "warm_loss": 5795.9492, "rmse": 2.0418, "nlpd": 2.1337,
        "warm_log_hypers": [
            1.732563, 0.358438, 3.992038, 0.554169, 1.329153, 3.837901, 3.595728, 0.744773,
            0.879128, 3.511023, 4.158322, -0.032983, 3.350976, 0.476800, 3.790990, 3.677514,
            3.433597, 2.717163, -3.546430, -0.024933],
        "draws_mean_log_hypers": [
            1.719018, 0.362686, 3.975774, 0.564875, 1.318211, 3.844060, 3.608223, 0.741066,
            0.876401, 3.513010, 4.163793, -0.051732, 3.346118, 0.481252, 3.804036, 3.656407,
            3.428304, 2.711174, -3.545303, -0.026516],
        "chain_mean_log_hypers": [
            [
                1.726333, 0.359268, 3.966520, 0.565070, 1.306320, 3.855122, 3.599099, 0.745864,
                0.870943, 3.516513, 4.170117, -0.055115, 3.344822, 0.480022, 3.803821,
                3.641549, 3.438143, 2.706612, -3.545100, -0.027936],
            [
                1.711703, 0.366105, 3.985029, 0.564681, 1.330101, 3.832997, 3.617346, 0.736268,
                0.881860, 3.509506, 4.157470, -0.048349, 3.347414, 0.482482, 3.804251,
                3.671266, 3.418464, 2.715737, -3.545506, -0.025096],
        ],
    },
    "sghmc-1m": {
        "n_rows": 100000,
        "draws_mean_log_hypers": [
            -0.016037, 0.001553, -0.018812, 0.008384, -0.013585, 0.003617, 0.010430, -0.006447,
            -0.005234, -0.000323, 0.002837, -0.021695, -0.007457, 0.001602, 0.010407,
            -0.023246, -0.007941, -0.008780, -0.713772, -1.396849],
        "chain_mean_log_hypers": [
            [
                -0.008745, -0.001815, -0.028002, 0.008560, -0.025451, 0.014728, 0.001242,
                -0.001678, -0.010725, 0.003204, 0.009042, -0.024974, -0.008825, 0.000373,
                0.010231, -0.038171, 0.001868, -0.013451, -0.714527, -1.397058],
            [
                -0.023329, 0.004921, -0.009621, 0.008208, -0.001719, -0.007493, 0.019617,
                -0.011216, 0.000256, -0.003849, -0.003368, -0.018416, -0.006089, 0.002830,
                0.010582, -0.008321, -0.017750, -0.004110, -0.713018, -1.396639],
        ],
    },
}
# Per log-hyper, the port's kept draws' mean is held to the JAX run's within
# DRAW_MEAN_TOL plus 3x the JAX run's difference between its two chains:
# each chain starts at its init + 0.01 N(0, 1), and the port draws other
# starts, minibatches and noise (0.05 is five times that jitter). From
# bench.py's start the log-outputscale and log-noise drift by 0.7 and 1.6
# in the 2000 steps. The warm start (a deterministic Adam run on the same
# rows) is held to WARM_LOSS_TOL in relative loss and WARM_NOISE_TOL in
# log-noise; the port's plain version on the CPU lands 6e-7 and 2e-5 from
# the JAX run. Its lengthscales and outputscale are not held: at an
# outputscale of e^-3.5 the bound is flat in them.
DRAW_MEAN_TOL = 0.05
WARM_LOSS_TOL = 1e-4
WARM_NOISE_TOL = 1e-3
# The co2 paths run the Mauna Loa experiment at its full width (N=541,
# M=480, 11 hypers) with the transitions cut: the experiment's fixed-Z
# protocol (tune=500, n=100, chunks of 100) takes ~600 transitions of 30-130
# leapfrogs at ~37 ms each, far beyond this script's time (its uncut run is
# in PERF.md section 4). Each keeps the experiment's 1500-step warm start.
# co2 cuts NUTS to 50 + 10 in chunks of 10 (at 30 warmup transitions the
# last dual-averaging run is 3 steps long, and the JAX package's own run of
# that cut sampled at accept 0.26 with one of two keys). co2-f32 (the
# experiment's dtype) cuts it to 2 + 1. co2-alt runs the alternating
# trainer's rounds (--alternating: train_model's rounds of (100, 20) with
# 1000 Z steps between) as two rounds of 2 + 1 with 20 Z steps between, and
# leaves out train_model's second warm start (1000 steps).
CO2_PROTOCOL = {"co2": dict(warm=1500, tune=50, n_samples=10, chunk_size=10),
                "co2-f32": dict(warm=1500, tune=2, n_samples=1, chunk_size=1),
                "co2-alt": dict(warm=1500, rounds=((2, 1), (2, 1)), z_steps=20)}
# The JAX package's CPU run (float64) of the co2 path's protocol above
# (co2_reference.py: one warm start, then NUTS from it with eight keys):
# the warm start's final loss and -ELBO at its end, and over the keys the
# mean and standard deviation (*_sd) of the extrapolation RMSE (ppm), the
# mixture NLPD and the per-lane posterior means (log units). The warm start
# is a deterministic float64 Adam run: the port's co2 path is held to its
# loss, and to -ELBO at its end from the potential kernel (its U less the
# log prior), within WARM_LOSS_TOL (a wrong kernel term, prior or lane
# order moves it by far more), and to each mean within a fixed slack (CO2_METRIC_TOL,
# CO2_LANE_TOL) plus CO2_SDS standard deviations: one run of 10 draws is one
# more draw from the keys' spread, and with that spread taken from eight
# keys (a Student t of 7 degrees of freedom) it lands beyond 4 standard
# deviations by chance less than 1 % of the time per metric.
CO2_REF = {
    "warm_loss": -1668.889642365729, "warm_neg_elbo": -1668.8900283666298, "seeds": 8,
    "rmse": 1.164092, "rmse_sd": 0.197301, "nlpd": 1.670965, "nlpd_sd": 0.254343,
    "lane_means": [1.31444, 8.899435, -2.219457, 3.726358, -1.844606, 1.951104, 4.419969,
                   -1.695872, 6.395192, -3.824182, -9.169884],
    "lane_sd": [0.202752, 2.001646, 0.610986, 0.556365, 2.162027, 2.376922, 1.512182, 2.017631,
                1.128694, 1.256057, 0.076855]}
CO2_METRIC_TOL = 0.05
CO2_LANE_TOL = 0.1
CO2_SDS = 4
# The reg-large path: the regression driver's BayesianSGPR_HMC protocol on
# synthetic-large (experiments/regression.py single_run, 13,279 train rows,
# D=18, M=100, 2 chains), held to the JAX package's CPU run in float64
# (regression_reference.py, which writes REGRESSION_REF_FILE beside this
# script): (1) the warm start's final loss, within REG_WARM_TOL relative (the
# path runs float32, jitter 1e-5 against 1e-8); (2) 20 Z-Adam steps of the
# JAX package's Z chunk from the warm start's Z and hypers, over 40 trace
# rows drawn around those hypers (seed and spread in the file): kernel 12 in
# float64 at the same inputs must reproduce the losses and the final Z within
# REG_ZSTEP_TOL (norm-relative); (3) the test RMSE and mixture NLPD, within
# REG_METRIC_TOL + REG_SDS standard deviations of the JAX run's keys. On
# synthetic-large both packages fit y as little better than noise, so (3) is
# a sanity gate; (1) and (2) are the tight holds.
REGRESSION_REF_FILE = "regression_reference.json"
# The reg-large path's NUTS rounds (REGRESSION_REF's "rounds", which
# regression_reference.py ran), cut from the driver's (100, 20), (25,
# 10), (100, 20): at this n a warmup transition of the 2-chain sampler takes
# ~85-175 leapfrogs (its unit mass against a posterior whose log-noise is
# known to ~1e-2 and whose lengthscales are barely identified), so on one
# block per chain (~40 ms a leapfrog) the uncut rounds took ~730 s, ~200 s
# and ~730 s; the uncut protocol is the port's driver,
# ``python3 -m ggp_tpu_torch.experiments.regression -m BayesianSGPR_HMC -d
# synthetic-large --n_splits 1``. Ten warmup
# transitions is the least that leaves the draws' step size adapted (after
# five, a draw took ~143 leapfrogs); the draws are halved, so the Z steps'
# trace sizes are S = 20, 10, 20 (kernel 12 is held at the uncut S = 40 in
# the parity phase). The warm start and the 3 x 500 Z steps are the
# driver's.
REG_WARM_TOL = 1e-3
REG_ZSTEP_TOL = 1e-6
REG_METRIC_TOL = 0.05
REG_SDS = 4
# The joint-large path: the regression driver's JointHMC protocol on
# synthetic-large (experiments/regression.py single_run, 13,279 train rows,
# D=18, M=100, one chain of NUTS), held to the JAX package's CPU run in
# float64 (joint_reference.py, which writes JOINT_REF_FILE beside this
# script, its cut included): (1) the warm start's final loss, within
# JOINT_WARM_TOL relative (a deterministic 100-step Adam run on the same
# rows; the path runs float32 at jitter 1e-5 against 1e-8, and on the
# one-block warm-start kernel with the trainers' pivot floor, where the JAX
# package runs its XLA scan); (2) the test RMSE and NLPD, within
# JOINT_METRIC_TOL + JOINT_SDS standard deviations of the JAX run's eight
# keys; (3) each of the d + 2 hyper lanes' trace means, within
# JOINT_LANE_TOL + JOINT_SDS SDs. On synthetic-large both packages fit y
# as little better than noise, so (2) is a sanity gate, and the lengthscale
# lanes are prior-dominated: their chain means move ~1 log unit from the
# warm state over the cut and spread ~0.1-0.3 from key to key, which three
# keys estimate too poorly for a 4 SD gate (Student t of 2 degrees of
# freedom: 5.7 % a lane beyond 4; of 7, 0.5 %). The sampler's cut,
# 50 warmup + 25 draws (joint-nuts' depth) from the regression driver's 500 + 100: a
# NUTS transition at this n takes up to 2^8 - 1 leapfrogs, ~0.2 s each in
# the JAX package's CPU run. Over this cut the chain still drifts
# (log-outputscale from -1 to about -8), so (3) is also held for chains
# started at the JAX run's own warm state and Z, in float32 and in float64
# at its jitter (phase_joint_large's witnesses).
JOINT_REF_FILE = "joint_reference.json"
JOINT_WARM_TOL = 1e-3
JOINT_METRIC_TOL = 0.05
JOINT_LANE_TOL = 0.1
JOINT_SDS = 4
# NVIDIA H100 SXM data sheet (at 700 W): float32 and float64 outside the
# tensor cores, float64 on the tensor cores (DMMA, full IEEE double: the
# matrix products of a float64 bound can run there), and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_F64_OPS = 34e12
PEAK_F64_MMA_OPS = 67e12
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


def co2_ops(n, m):
    """The least floating-point operations one evaluation of the CO2
    composite bound with its 11-lane gradient needs at (n, m), counted as
    :func:`bound_ops` counts the collapsed bound: its factorisations,
    substitutions and adjoints, plus per pair (n m, and m (m+1)/2 of the
    symmetric Kmm) the four component grams (~36: one sin, four exp, one
    log1p, the Matern32 form) and the ten hyper contractions (~40)."""
    pairs = n * m + m * (m + 1) / 2
    ops = (36 * pairs                          # grams of the four components
           + 4 * m ** 3 / 3                    # potrf + trtri of Kmm and of B
           + n * m * m + n * m                 # An = Knm L^-T / sigma (trmm)
           + n * m * m + n * m                 # B = An^T An + I (syrk)
           + m ** 3 / 3                        # B^-1 = VB VB^T (lauum)
           + 4 * n * m + 3 * m * m + 3 * n     # u, alpha; three substitutions
           + m ** 3 + m * m                    # Y1 = (I - B^-1) L^-1 (trmm)
           + 2 * m * m + m ** 3                # T0; L^-T T0 L^-1 (sygst)
           + m * m                             # dKmm (symmetric)
           + 2 * n * m * m + 4 * n * m         # dKnm = (An Y1 + alpha w^T) / sigma
           + 40 * pairs                        # ten contractions sum(Kbar o dK/dtheta_i)
           + 12 * 11)                          # variance lanes, noise lane, priors
    return float(ops)


def gemm_ops(n, m):
    """The matrix-product part of :func:`bound_ops` and :func:`co2_ops` at
    (n, m): the two factorisations and triangular inverses, An, B, B^-1,
    Y1, L^-T T0 L^-1 and dKnm's An Y1, 11 m^3 / 3 + 4 n m^2."""
    return 11 * m ** 3 / 3 + 4 * n * m * m


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
    output: registers, spill stores and static shared memory; and one line
    per source with the seconds nvcc took on it."""
    lines, name, spill = [], None, "?"
    for line in _build.ptxas_report().splitlines():
        m = re.match(r"== (\S+) \(([\d.]+) s\)", line)
        if m:
            lines.append(f"nvcc {m.group(1)}: {m.group(2)} s")
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


def roofline(evals, n, m, d, in_bytes, out_bytes, want_z=False, core="vfe", f64=False):
    """(bound_ms, bound_by) of a call that makes ``evals`` evaluations of
    ``core`` and reads ``in_bytes``, writes ``out_bytes``: the operations
    over PEAK_F32_OPS, or with ``f64`` (the vfe and co2 cores) the matrix
    products (:func:`gemm_ops`) over PEAK_F64_MMA_OPS and the rest over
    PEAK_F64_OPS."""
    if core == "gpr":
        ops = gpr_ops(n, d)
    elif core.startswith("co2"):
        ops = co2_ops(n, m)
    else:
        ops = (sgpmc_ops if core == "sgpmc" else bound_ops)(n, m, d, want_z)
    if f64:
        assert core == "vfe" or core.startswith("co2"), core
        mm = gemm_ops(n, m)
        t_ops = evals * (mm / PEAK_F64_MMA_OPS + (ops - mm) / PEAK_F64_OPS)
    else:
        t_ops = evals * ops / PEAK_F32_OPS
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def state_tensors(s):
    return [getattr(s, f.name) for f in dataclasses.fields(s)]


def new_res():
    """A parity record per kernel of KERNELS, and one for any other name on
    first use (a wrapper's counter whose record is folded into a kernel's
    row)."""
    res = collections.defaultdict(lambda: {"rel": {}, "abs32": 0.0, "ms": None, "plain_ms": None,
                                           "bound": (None, None), "library_ms": None,
                                           "extra": {}})
    for k in KERNELS:
        res[k]
    return res


def fold_row(res, src, dst, pre):
    """Fold the parity record ``res[src]`` into kernel ``dst``'s row: its
    errors into the row's, its float32 time, plain time and bound as the
    row's extras prefixed ``pre``."""
    r = res.pop(src)
    for tag, e in r["rel"].items():
        res[dst]["rel"][tag] = max(res[dst]["rel"].get(tag, 0.0), e)
    res[dst]["abs32"] = max(res[dst]["abs32"], r["abs32"])
    if r["ms"] is not None:
        res[dst]["extra"].update({pre + "ms": r["ms"], pre + "plain_ms": r["plain_ms"],
                                  pre + "bound_ms": r["bound"][0]})


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

        # kernel 3: parameters and losses after 20 steps
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
        # the grouped trainer (kernel 3g) at the same shape, which the wrapper
        # takes past 2048 rows only: held the same way, and timed beside kernel 3
        gargs = (th, Z, zt, zt, zz, zz, X, y, jit)
        outg = call_sgpr_adam("group", *gargs, **akw)
        eg = max(rel(a, b) for a, b in zip(outg, ref))
        gms = cuda_ms(lambda: call_sgpr_adam("group", *gargs, **akw), 3)
        print(f"parity sgpr_adam_group {tag} at n={n} (20 steps): max rel err {eg:.3e}; "
              f"{gms / 20:.4f} ms a step against the one-block kernel's {ms / 20:.4f} ms")
        assert eg <= ADAM_TOL[dt], f"sgpr_adam_group {tag} n={n} rel err {eg}"
        rg = res["sgpr_adam_group"]
        rg["rel"][tag] = max(rg["rel"].get(tag, 0.0), eg)
        if f32:
            rg["extra"].update(n404_ms_per_step=gms / 20, n404_block_ms_per_step=ms / 20)

        # site 7's function (20 steps x 10 trace rows) on kernel 12, where
        # z_adam_chunk sends every CUDA call: against site 7's plain version
        # and against the streamed plain version of the same function
        tgen = torch.Generator(device="cuda").manual_seed(7)
        trace = th + 0.1 * torch.randn((10, d + 2), generator=tgen, dtype=dt, device="cuda")
        zkw = dict(t0=0, num_steps=20, lr=0.01)
        before = _build.LAUNCHES["z_adam_stream"]
        out = z_adam_chunk(Z, zz, zz, trace, X, y, jit, **zkw)
        assert _build.LAUNCHES["z_adam_stream"] == before + 1, "z_adam_chunk ran no kernel 12"
        ref = z_adam_chunk_plain(Z, zz, zz, trace, X, y, jit, **zkw)
        ref_s = z_adam_stream_plain(Z, zz, zz, trace, X, y, jit, **zkw)
        e = max(rel(a, b) for a, b in zip(out, ref))
        es = max(rel(a, b) for a, b in zip(out, ref_s))
        ms = cuda_ms(lambda: z_adam_chunk(Z, zz, zz, trace, X, y, jit, **zkw), 3)
        pms = cuda_ms(lambda: z_adam_chunk_plain(Z, zz, zz, trace, X, y, jit, **zkw), 1)
        bound = roofline(200, n, m, d, nbytes(X, y, trace) + 3 * nbytes(Z), nbytes(*out),
                         want_z=True)
        print(f"parity z_adam_chunk {tag} on kernel 12 (N={n}, 20 steps x 10 rows): max rel "
              f"err {e:.3e} against z_adam_chunk_plain, {es:.3e} against z_adam_stream_plain; "
              f"kernel {ms:.3f} ms ({ms / 20:.3f} ms a step), plain {pms:.3f} ms"
              + (f", bound {bound[0]:.5f} ms" if f32 else ""))
        assert max(e, es) <= ADAM_TOL[dt], f"z_adam_chunk {tag} N={n} rel err {e}, {es}"
        res["z_adam_chunk"]["rel"][tag] = max(e, es)
        if f32:
            res["z_adam_chunk"].update(abs32=max(abs_err(a, b) for a, b in zip(out, ref)),
                                       ms=ms, plain_ms=pms, bound=bound)


def mc_start(X, y, Z, jit, C, seed, core="vfe", z0=0.0):
    """C chains at state z0 + 0.1 N(0, 1) with per-chain step sizes from the
    batched search (plain potential of ``core``), as the C-chain sampler
    starts them."""
    dt = X.dtype
    dim = state_dim(core, X.shape[1], Z.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, dtype=dt, device="cuda")
    z = z0 + 0.1 * torch.randn((C, dim), **kw)
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


def stats_err(what, f32, d_k, d_p, x_k, x_p, p, pot64, run64):
    """The potential, accept probability and energy (stats columns 0, 1, 5)
    of a NUTS run of the kernel and of the plain version over the first p
    transitions, on which both share one path: their norm-relative error,
    which the caller holds to NUTS_TOL, or None where this holds them
    instead. That is where, in float32, they lie beyond NUTS_TOL (a co2
    potential of |U| ~ 1.7e3 is resolved to ~1e-4 of itself, and a draw
    NUTS_TOL from another sits tens of units of U away). Then the stats are
    held over the leading transitions whose draws float32 resolves, where
    the plain version's potential lies within TOL of float64 (``pot64``);
    past them (at the Mauna Loa posterior, noise variance ~1e-4, B's
    condition ~1e7) float32 resolves neither version, and both versions'
    errors against float64 are printed. On the resolved transitions the
    stats must agree to NUTS_TOL, or be as accurate: each column beyond it
    read against float64, the kernel's error within F32_AS_ACCURATE times
    the plain version's; the potential at each version's own draws; the
    accept probability and energy of the first transition, where both
    versions start from the same inputs, against the plain version in
    float64 from those inputs and slabs (``run64()``: its draws and stats),
    which must share that transition's path. (The energy of a later
    transition is the potential at its start, held above, plus the shared
    slab's kinetic term.)"""
    cols, tol = [0, 1, 5], NUTS_TOL[torch.float32]
    e = rel(x_k[:p][:, cols], x_p[:p][:, cols])
    if not f32 or e <= tol:
        return e
    u_p = torch.stack([pot64(z) for z in d_p[:p]])
    r = next((t for t in range(p) if abs(float(x_p[t, 0] - u_p[t]))
              > TOL[torch.float32] * abs(float(u_p[t]))), p)
    txt = []
    if r < p:
        u_k = torch.stack([pot64(z) for z in d_k[r:p]])
        txt.append(f"from transition {r} of {p} float32 resolves neither version: the potential "
                   f"kernel {abs_err(x_k[r:p, 0], u_k):.3e}, plain "
                   f"{abs_err(x_p[r:p, 0], u_p[r:]):.3e} from float64 (printed, not held)")
    e = rel(x_k[:r][:, cols], x_p[:r][:, cols]) if r else 0.0
    if e > tol:
        def held(name, ek, ep):
            txt.append(f"{name} kernel {ek:.3e}, plain {ep:.3e} from float64")
            assert ek <= F32_AS_ACCURATE * max(ep, 1e-300), \
                f"{what} {name}: kernel {ek:.3e} from float64, plain {ep:.3e}"

        if rel(x_k[:r, 0], x_p[:r, 0]) > tol:
            u_kr = torch.stack([pot64(z) for z in d_k[:r]])
            held(f"potential at its {r} draws", rel(x_k[:r, 0], u_kr), rel(x_p[:r, 0], u_p[:r]))
        first = [(c, name) for c, name in ((1, "accept"), (5, "energy"))
                 if rel(x_k[:r, c], x_p[:r, c]) > tol]
        if first:
            d64, x64 = run64()
            assert min(agreeing_prefix(d[:1], d64[:1], x[:1], x64[:1], tol)
                       for d, x in ((d_k, x_k), (d_p, x_p))) == 1, \
                f"{what}: the float64 plain version parts at the first transition"
            for c, name in first:
                held(f"{name} of the first transition", rel(x_k[:1, c], x64[:1, c]),
                     rel(x_p[:1, c], x64[:1, c]))
    else:
        txt.append(f"over the {r} resolved ones {e:.3e} apart")
    print(f"  {what}: potential, accept, energy beyond NUTS_TOL; {'; '.join(txt)}")
    return e if e <= tol else None


def chunk_parity(X, y, Z, jit, st0, gen, res, *, core, algo, grid, K, L=10, md=8,
                 f64_times=False):
    """A warm and a sample chunk of K transitions, HMC (L leapfrogs) or
    NUTS (max depth md), of ``core`` from the ``grid`` chains of ``st0``:
    the kernel (through the one-chain wrapper at grid 1, the C-chain one
    otherwise) against the plain C-chain version on shared slabs from
    ``gen``. HMC chunks must take identical accept decisions; NUTS chunks
    must keep every f64 chain on one path and agree on the first
    transition in f32 (the stats by :func:`stats_err`). Records the
    kernel's row of ``res`` (and with ``f64_times`` its float64 times and
    bound)."""
    dt = X.dtype
    tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
    n, d = X.shape
    m, dim = Z.shape[0], st0.z.shape[1]
    name = _build.launch_key(vfe_group.route(core, n, grid),
                             ("" if grid == 1 else "mc_") + f"{algo}_chunk")
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
            ref64 = []

            def run64():
                if not ref64:      # the plain version in float64 from the same inputs
                    st64 = ChainState(**{k: v.double() for k, v in vars(st).items()})
                    sl64 = {k: v.double() for k, v in sl.items()}
                    ref64.extend(plain(st64, X.double(), y.double(), Z.double(), jit,
                                       eps=eps.double(), **sl64, **kw)[1:])
                return ref64

            def pot64(z):
                return neg_logpost_vg(core, z.double(), X.double(), y.double(), Z.double(),
                                      jit)[0]

            for c, p in enumerate(prefixes):
                if p:
                    errs.append(rel(d_k[:p, c], d_p[:p, c]))
                    e = stats_err(f"{name} {tag} {mode} chain {c}", f32, d_k[:, c], d_p[:, c],
                                  x_k[:, c], x_p[:, c], p, pot64,
                                  lambda c=c: tuple(a[:, c] for a in run64()))
                    if e is not None:
                        errs.append(e)
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
        if adapt and f64_times and not f32:
            b64 = roofline(leaves, n, m, d, xyz + st_b + nbytes(*sl.values()) + 2 * K * 4,
                           st_b + nbytes(d_k, x_k), core=core, f64=True)
            res[name]["extra"].update(ms_f64=t_k, plain_ms_f64=t_p, bound_ms_f64=b64[0])
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
    """The grouped sgpmc core (csrc/sgpmc_group.cuh), which runs the sgpmc
    core of every kernel at every n, against the plain versions at bench.py's
    shape (state row d+2+M = 115): the potential at one row (sampler and
    warm-start options: dU/dZ too) and C rows; the warm start
    (:func:`warm_start_parity`: one step at a time from SGPMC's initial
    state, then 20 steps from a chain's state, repeats bit-identical); the
    HMC chunk (L leapfrogs) at one chain (K=16) and C (K=8) and the NUTS
    chunk (max depth md) at one chain and C (K=8). The C-chain records are
    the extras ``c8_*`` of the kernels' rows."""
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
        G1 = vfe_group.geometry("potential", dt, 1, X.device, core="sgpmc_group", n=n)
        print(f"parity sgpmc_group_potential {tag} (one row, G={G1}; with and without dU/dZ): "
              f"max rel err {e:.3e}; kernel {ms:.4f} ms, plain {pms:.4f} ms")
        assert e <= TOL[dt], f"sgpmc_group_potential {tag} rel err {e}"
        gp = res["sgpmc_group_potential"]
        gp["rel"][tag] = max(gp["rel"].get(tag, 0.0), e)
        if f32:
            gp.update(abs32=max(aerr), ms=ms, plain_ms=pms,
                      bound=roofline(1, n, m, d, xyz + nbytes(row), (row.numel() + 1) * 4,
                                     core="sgpmc"))
            gp["extra"]["group"] = G1
        rows = st0.z + 0.3 * torch.randn(st0.z.shape, generator=gen, dtype=dt, device="cuda")
        potential_parity(
            "sgpmc_group_mc_potential", lambda r: mc_potential(r, X, y, Z, jit, core="sgpmc"),
            lambda r: mc_potential_plain(r, X, y, Z, jit, core="sgpmc"), rows, res, 5,
            lambda out: (C, n, m, d, xyz + nbytes(rows), nbytes(*out), False, "sgpmc"))
        check_repeat(f"mc_potential {tag} (grouped sgpmc core, C={C}, n={n})",
                     lambda: mc_potential(rows, X, y, Z, jit, core="sgpmc"))
        fold_row(res, "sgpmc_group_mc_potential", "sgpmc_group_potential", f"c{C}_")

        warm_start_parity(X, y, Z, jit, res, from_start=5, state=row, steps=20, pre="")

        for algo, grid in (("hmc", 1), ("hmc", C), ("nuts", 1), ("nuts", C)):
            st = as_batch(first_chain(st0)) if grid == 1 else st0
            chunk_parity(X, y, Z, jit, st, gen, res, core="sgpmc", algo=algo, grid=grid,
                         K=16 if (algo, grid) == ("hmc", 1) else 8, L=L, md=md)
        for algo in ("hmc", "nuts"):
            fold_row(res, f"sgpmc_group_mc_{algo}_chunk", f"sgpmc_group_{algo}_chunk", f"c{C}_")


def warm_start_parity(X, y, Z, jit, res, *, from_start, state, steps, pre):
    """The warm start's kernel (sgpmc_warm_chunk: the grouped sgpmc core)
    against its plain version at (X, y, Z): from the path's start (SGPMC's
    initial state at Z) ``from_start`` single steps, each from the plain
    version's state; then ``steps`` steps in one launch from ``state`` (a
    chain's state: v = 0 or near it), timed against the plain version,
    launched twice for bit-identical outputs. Float64 to TOL, float32 to
    ADAM_TOL (:func:`warm_parity`). Records the kernel's row (its extras
    prefixed ``pre`` when ``pre`` is set)."""
    dt = X.dtype
    tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
    n, d = X.shape
    m = Z.shape[0]
    wr = res["sgpmc_warm_group"]
    zz = torch.zeros_like(Z)
    start = SGPMC(X, y, Z_init=Z, jitter=jit, dtype=dt, device="cuda").flat
    S = (start, Z, torch.zeros_like(start), torch.zeros_like(start), zz, zz)
    worst = 0.0
    for t in range(from_start):
        akw = dict(t0=t, num_steps=1, lr=0.01)
        out = sgpmc_warm_chunk(*S, X, y, jit, **akw)
        ref_w = sgpmc_warm_chunk_plain(*S, X, y, jit, **akw)
        e, ok, txt = warm_parity(out, ref_w, S + (X, y), jit, akw, f32)
        assert ok, f"sgpmc_warm_group {tag} n={n} step {t + 1} from the path's start: " \
                   f"rel err {e}{txt}"
        worst, S = max(worst, e), ref_w[:6]
    wr["rel"][tag] = max(wr["rel"].get(tag, 0.0), worst)
    G = vfe_group.geometry("sgpmc_warm", dt, 1, X.device, core="sgpmc_group", n=n)
    print(f"parity sgpmc_warm_group {tag} at n={n} (G={G}) from the path's start, {from_start} "
          f"single steps along the plain version's trajectory: max rel err {worst:.3e}")
    zs = torch.zeros_like(state)
    args = (state, Z, zs, zs, zz, zz, X, y)
    akw = dict(t0=0, num_steps=steps, lr=0.01)
    out = sgpmc_warm_chunk(*args, jit, **akw)
    ref_w = sgpmc_warm_chunk_plain(*args, jit, **akw)
    e, ok, txt = warm_parity(out, ref_w, args, jit, akw, f32)
    ms = cuda_ms(lambda: sgpmc_warm_chunk(*args, jit, **akw), 3)
    pms = cuda_ms(lambda: sgpmc_warm_chunk_plain(*args, jit, **akw), 1)
    bound = roofline(steps, n, m, d, nbytes(X, y, Z) + 3 * nbytes(state, Z), nbytes(*out),
                     want_z=True, core="sgpmc")
    print(f"parity sgpmc_warm_group {tag} at n={n} ({steps} steps from a chain's state): max "
          f"rel err {e:.3e}{txt}; kernel {ms / steps:.4f} ms a step, plain {pms / steps:.4f} ms "
          f"a step, bound {bound[0] / steps:.6f} ms a step")
    assert ok, f"sgpmc_warm_group {tag} n={n} rel err {e}"
    check_repeat(f"sgpmc_warm_chunk {tag} (grouped warm start, n={n})",
                 lambda: sgpmc_warm_chunk(*args, jit, **akw))
    wr["rel"][tag] = max(wr["rel"][tag], e)
    if not f32:
        return
    if pre:
        wr["extra"].update({pre + "ms_per_step": ms / steps, pre + "plain_ms_per_step":
                            pms / steps, pre + "bound_ms_per_step": bound[0] / steps,
                            pre + "group": G})
    else:
        wr.update(abs32=max(abs_err(a, b) for a, b in zip(out, ref_w)), ms=ms, plain_ms=pms,
                  bound=bound)
        wr["extra"].update(steps=steps, group=G)


def phase_parity_gpr(Xd, yd, res, C=8, md=8):
    """The gpr core (csrc/gpr_bound.cuh: a group of blocks per chain) of the
    potential and NUTS kernels against the plain version at bench.py's
    GPR+HMC shape (N=404, D=13, state row 15): the potential for one chain
    (two rows) and C chains; a warm and a sample NUTS chunk of K=8
    transitions (max depth md) for one chain and C chains; two launches of
    the potential (1 and C rows) and of a C-chain warm chunk bit-identical;
    and the potential at bench.py's winered shape (N=1279, D=11), with its
    time. In float32 both versions are also held against the float64 plain
    version on the same inputs."""
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
        check_repeat(f"gpr_potential {tag} (grouped core, one chain)",
                     lambda: vfe_potential(row, X, y, Z, jit, core="gpr"))
        th = st0.z + 0.3 * torch.randn(st0.z.shape, generator=gen, dtype=dt, device="cuda")
        potential_parity(
            "gpr_mc_potential", lambda r: mc_potential(r, X, y, Z, jit, core="gpr"),
            lambda r: mc_potential_plain(r, X, y, Z, jit, core="gpr"), th, res, 5,
            lambda out: (C, n, 0, d, nbytes(X, y, th), nbytes(*out), False, "gpr"))
        check_repeat(f"gpr_mc_potential {tag} (grouped core, C={C})",
                     lambda: mc_potential(th, X, y, Z, jit, core="gpr"))
        for grid in (1, C):
            st = as_batch(first_chain(st0)) if grid == 1 else st0
            chunk_parity(X, y, Z, jit, st, gen, res, core="gpr", algo="nuts", grid=grid,
                         K=8, md=md)
        sl = draw_mc_slabs(2, C, d + 2, algorithm="nuts", max_depth=md, generator=gen, dtype=dt,
                           device="cuda")
        no = torch.zeros(2, dtype=torch.bool, device="cuda")
        check_repeat(f"gpr_mc_nuts_chunk {tag} (grouped core, C={C}, a warm chunk of 2)",
                     lambda: mc_nuts_chunk(st0, X, y, Z, jit, n_active=2, adapt=True,
                                           in_window=no, window_end=no, max_depth=md,
                                           core="gpr", **sl))

        # bench.py's winered shape, where the JAX package leaves the fused core
        Xw, yw, *_ = (torch.tensor(a, dtype=dt, device="cuda") for a in make_data("winered"))
        nw, dw = Xw.shape
        Zw = Xw.new_empty((0, dw))
        tw = torch.tensor([0.5] * dw + [0.0, -2.0], dtype=dt, device="cuda")
        out = vfe_potential(tw, Xw, yw, Zw, jit, core="gpr")
        ew = max(rel(a, b) for a, b in zip(out, gpr_neg_logpost_vg(tw, Xw, yw, jit)))
        wms = cuda_ms(lambda: vfe_potential(tw, Xw, yw, Zw, jit, core="gpr"), 5)
        wpms = cuda_ms(lambda: gpr_neg_logpost_vg(tw, Xw, yw, jit), 3)
        wb = roofline(1, nw, 0, dw, nbytes(Xw, yw, tw), (dw + 3) * Xw.element_size(), core="gpr")
        print(f"parity gpr_potential {tag} at winered shape (N={nw}, D={dw}): max rel err "
              f"{ew:.3e}; kernel {wms:.4f} ms, plain {wpms:.4f} ms, bound {wb[0]:.6f} ms "
              f"({CARD})")
        assert ew <= TOL[dt], f"gpr_potential {tag} winered rel err {ew}"
        gp = res["gpr_potential"]
        gp["rel"][tag] = max(gp["rel"][tag], ew)
        gp["extra"].update({f"winered_ms_{tag}": wms, f"winered_plain_ms_{tag}": wpms})
        if f32:
            gp["extra"]["winered_bound_ms"] = wb[0]


def co2_data(dt):
    """The Mauna Loa CO2 experiment's data on the card: N=541 training rows
    before 2003 and 143 test rows, D=1; Z = X[:480] (every max(1, 541 //
    480)-th row, as the experiment takes it); y_std in ppm."""
    Xtr, ytr, Xte, yte, _, y_std, _ = load_co2_dataset(2003)
    X, y, Xt, yt = (torch.tensor(a, dtype=dt, device="cuda") for a in (Xtr, ytr, Xte, yte))
    return X, y, X[:480].contiguous(), Xt, yt, y_std


def transition_chain(step, z0, U0, g0, eps, slabs):
    """K chained transitions of ``step`` (nuts_transition or its plain
    version) from (z0, U0, g0) on the slabs' rows: draws (K, dim) and
    stats (K, 6) in chunk order (U, accept, diverging, depth, leapfrogs,
    energy)."""
    z, U, g = z0, U0, g0
    im = torch.ones_like(z0)
    draws, stats = [], []
    for mom, treeu, leafu in zip(*slabs):
        z, U, g, acc, div, depth, nl, H0 = step(z, U, g, eps, im, mom=mom, treeu=treeu,
                                                leafu=leafu)
        draws.append(z)
        stats.append(torch.stack([U, acc, div.to(z.dtype), depth.to(z.dtype),
                                  nl.to(z.dtype), H0]))
    return torch.stack(draws), torch.stack(stats)


def transition_parity(label, core, z0, X, y, Z, jit, gen, res, K, md, record):
    """K chained one-transition kernel launches (``nuts_transition``, site
    4) against the plain transition on shared slabs, each version its own
    chain from z0 at the plain step-size search's eps: every f64 transition
    on one path, the first f32 one agreeing (NUTS_TOL; the stats by
    :func:`stats_err`). ``record``: this call's times go to the kernel's row
    (f32; f64 as extras)."""
    dt = X.dtype
    tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
    n, d = X.shape
    m, dim = Z.shape[0], z0.shape[0]

    def pot(z):
        return neg_logpost_vg(core, z, X, y, Z, jit)

    U0, g0 = pot(z0)
    im = torch.ones_like(z0)
    eps = find_reasonable_step_size(pot, z0, U0, g0, torch.randn(dim, generator=gen, dtype=dt,
                                                                 device="cuda"), im, 0.1)
    slabs = draw_slabs(K, dim, md, gen, dtype=dt, device="cuda")
    kw = dict(max_depth=md, core=core)
    args = (X, y, Z, jit)
    (d_k, x_k), t_k = once_ms(lambda: transition_chain(
        lambda *a, **k: nuts_transition(*a[:5], *args, **k, **kw), z0, U0, g0, eps, slabs))
    (d_p, x_p), t_p = once_ms(lambda: transition_chain(
        lambda *a, **k: nuts_transition_plain(*a[:5], *args, **k, **kw), z0, U0, g0, eps,
        slabs))
    p = agreeing_prefix(d_k, d_p, x_k, x_p, NUTS_TOL[dt])

    X64, y64, Z64, z64 = (t.double() for t in (X, y, Z, z0))

    def run64():          # the first transition in float64 from the same inputs
        return transition_chain(
            lambda *a, **k: nuts_transition_plain(*a[:5], X64, y64, Z64, jit, **k, **kw), z64,
            *neg_logpost_vg(core, z64, X64, y64, Z64, jit), eps.double(),
            [t[:1].double() for t in slabs])

    errs = [rel(d_k[:p], d_p[:p])] if p else []
    e = stats_err(f"nuts_transition {label} {tag}", f32, d_k, d_p, x_k, x_p, p,
                  lambda z: neg_logpost_vg(core, z.double(), X64, y64, Z64, jit)[0],
                  run64) if p else None
    if e is not None:
        errs.append(e)
    stat_err = rel(x_k[:p][:, [0, 1, 5]], x_p[:p][:, [0, 1, 5]]) if p else float("nan")
    leaves = int(x_k[:, 4].sum())
    in_b = nbytes(X, y, Z, z0, U0, g0, im, *slabs)
    bound = roofline(leaves, n, m, d, in_b, nbytes(d_k, x_k), core=core, f64=not f32)
    print(f"parity nuts_transition {label} {tag} (K={K} launches, max depth {md}): "
          f"transitions on one path {p}/{K}, leapfrogs {leaves}, max rel err over them "
          f"{max(errs, default=float('nan')):.3e} (potential, accept, energy "
          f"{stat_err:.3e}); kernel "
          f"{t_k / K:.2f} ms, plain "
          f"{t_p / K:.2f} ms per transition ({t_k / max(leaves, 1):.3f} ms per leapfrog), "
          f"bound {bound[0]:.4f} ms")
    if f32:
        assert p >= 1, f"nuts_transition {label} f32: the first transition differs"
    else:
        assert p == K, f"nuts_transition {label} f64: paths part at {p}"
    assert max(errs) <= NUTS_TOL[dt], f"nuts_transition {label} {tag} rel err {max(errs)}"
    row = res["nuts_transition"]
    row["rel"][tag] = max(row["rel"].get(tag, 0.0), max(errs))
    row["extra"][f"max_rel_err_{label}_{tag}"] = max(errs)
    # per launch: the K transitions' times and bound over K
    if record and f32:
        row.update(abs32=max(abs_err(d_k[:p], d_p[:p]), abs_err(x_k[:p][:, [0, 5]],
                                                                  x_p[:p][:, [0, 5]])),
                   ms=t_k / K, plain_ms=t_p / K, bound=(bound[0] / K, bound[1]))
        row["extra"]["leapfrogs_per_launch"] = leaves / K
    elif record:
        row["extra"].update(ms_f64=t_k / K, plain_ms_f64=t_p / K, bound_ms_f64=bound[0] / K)
    else:
        row["extra"][f"ms_{label}_{tag}"] = t_k / K


def phase_parity_co2(Xd, yd, Zd, res, K=3, md=6):
    """The co2 cores at the Mauna Loa experiment's shape (N=541, D=1, M=480,
    jitter 1e-4, LogNormal(0, 3) priors): the potential kernel of both noise
    components against the plain version at init_co2_params and three
    states dispersed from it by 0.5 N(0, 1) (f64 <= 1e-9; f32 <= 1e-3, or
    where float32 does not resolve the difference, the kernel's error
    against float64 within F32_AS_ACCURATE times the plain version's); the
    one-transition kernel (vfe at the slice's shape, co2 at the
    experiment's) and a warm and a sample co2 NUTS chunk of K transitions
    (max depth md) against their plain versions on shared slabs."""
    for dt in (torch.float64, torch.float32):
        tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
        X, y, Z, *_ = co2_data(dt)
        n, m = X.shape[0], Z.shape[0]
        jit = 1e-4
        gen = torch.Generator(device="cuda").manual_seed(19)
        base = ravel(init_co2_params(dtype=dt, device="cuda"))
        states = [base] + [base + 0.5 * torch.randn(11, generator=gen, dtype=dt, device="cuda")
                           for _ in range(3)]
        for nc in ("m32", "rbf"):
            errs, aerr, worst = [], [], []
            for th in states:
                out = co2_potential(th, X, y, Z, jit, noise_comp=nc)
                ref = co2_vfe_neg_logpost_vg(th, X, y, Z, jit, noise_comp=nc)
                for a, b in zip(out, ref):
                    errs.append(rel(a, b))
                    aerr.append(abs_err(a, b))
                if f32:
                    r64 = co2_vfe_neg_logpost_vg(*(t.double() for t in (th, X, y, Z)), jit,
                                                 noise_comp=nc)
                    for what, a, b, c in zip(("U", "g"), out, ref, r64):
                        if rel(a, b) > TOL[dt]:
                            lane = int((a.double() - b.double()).abs().argmax())
                            worst.append((rel(a, c), rel(b, c), f"{what}[{lane}]"))
            e = max(errs)
            txt = ""
            if worst:
                txt = (f"; not resolved in float32 at {[w[2] for w in worst]}, against float64 "
                       f"kernel {max(w[0] for w in worst):.3e}, plain "
                       f"{max(w[1] for w in worst):.3e}")
            th = states[0]
            ms = cuda_ms(lambda: co2_potential(th, X, y, Z, jit, noise_comp=nc), 5)
            pms = cuda_ms(lambda: co2_vfe_neg_logpost_vg(th, X, y, Z, jit, noise_comp=nc), 5)
            b = roofline(1, n, m, 1, nbytes(X, y, Z, th), 12 * X.element_size(), core="co2",
                         f64=not f32)
            print(f"parity co2_potential {nc} {tag} (N={n}, M={m}, {len(states)} states): max "
                  f"rel err {e:.3e}{txt}; kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                  f"{b[0]:.4f} ms ({b[1]})")
            if f32:
                assert all(k <= F32_AS_ACCURATE * max(p, 1e-300) for k, p, _ in worst), \
                    f"co2_potential {nc} f32: kernel less accurate than plain {worst}"
            else:
                assert e <= TOL[dt], f"co2_potential {nc} {tag} rel err {e}"
            row = res["co2_potential"]
            row["rel"][tag] = max(row["rel"].get(tag, 0.0), e)
            row["extra"][f"max_rel_err_{nc}_{tag}"] = e
            if nc == "m32" and f32:
                row.update(abs32=max(aerr), ms=ms, plain_ms=pms, bound=b)
            elif nc == "m32":
                row["extra"].update(ms_f64=ms, plain_ms_f64=pms, bound_ms_f64=b[0])

        # site 4: chained one-transition launches, vfe at the slice's shape, then co2
        Xv, yv, Zv = Xd.to(dt), yd.to(dt), Zd.to(dt)
        transition_parity("vfe", "vfe", torch.zeros(Xv.shape[1] + 2, dtype=dt, device="cuda"),
                          Xv, yv, Zv, 1e-5, gen, res, K=2 * K, md=8, record=False)
        transition_parity("co2_m32", "co2_m32", base, X, y, Z, jit, gen, res, K=K, md=md,
                          record=True)
        # sites 2, 3: the co2 NUTS chunk at grid 1
        st0, cgen = mc_start(X, y, Z, jit, 1, seed=23, core="co2_m32", z0=base)
        chunk_parity(X, y, Z, jit, st0, cgen, res, core="co2_m32", algo="nuts", grid=1, K=K,
                     md=md, f64_times=True)


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
    + the blocked Cholesky; + the inverse fused into its steps; + the solves
    and value; + K^-1, Kbar and P per tile; + the sums of the gradient),
    each a launch of the potential kernel (so each prefix also holds the
    launch and the host's call), and, as the yardstick of the factorisation,
    the time of torch.linalg.cholesky_ex + torch.cholesky_inverse on the
    same K."""
    X, y = Xd.float(), yd.float()
    n, d = X.shape
    Z = X.new_empty((0, d))
    row = torch.tensor([0.5] * d + [0.0, -2.0], device="cuda")
    prefix = [cuda_ms(lambda: call_potential("gpr", row[None], X, y, Z, 1e-5, stages=s), 20)
              for s in range(1, 7)]
    parts = [prefix[0]] + [b - a for a, b in zip(prefix, prefix[1:])]
    names = ("grams", "Cholesky", "inverse", "solves", "K^-1 and P", "gradient sums")
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


def phase_gpr(Xd, yd, Xte, yte, label, num_chains=1, num_warmup=50, num_samples=10):
    """bench.py ``cell_gpr_hmc`` (bench.py:215-234) through the port, float32:
    GPR_HMC(X, y), ``train_model`` timed once (generator seed 0; bench.py
    takes the min of two after an untimed run); then the full mixture
    predictive on the held-out rows."""
    X, y, Xt, yt = (a.to(torch.float32) for a in (Xd, yd, Xte, yte))
    d = X.shape[1]
    torch.cuda.synchronize()
    _build.reset_launches()
    model = GPR_HMC(X, y)

    gen = torch.Generator(device="cuda").manual_seed(0)
    tr, ms = once_ms(lambda: model.train_model(num_warmup, num_samples,
                                               num_chains=num_chains, generator=gen))
    (means, vars_), t_pred = once_ms(lambda: model.full_mixture_posterior_predictive(Xt))
    launches = dict(_build.LAUNCHES)
    secs = ms / 1e3
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
          f"{num_samples} draws), NUTS): {secs:.3f} s; "
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
    """The GPR+HMC main paths by name (cut from bench.py's min of two timed
    runs after an untimed one; PERF.md section 4)."""
    return {
        "gpr-hmc": lambda: phase_gpr(X, y, Xte, yte, "gpr-hmc"),
        "gpr-c4": lambda: phase_gpr(X, y, Xte, yte, "gpr-c4", num_chains=4,
                                    num_samples=10),
    }


def flagship_paths(X, y, Z):
    """The flagship's bench.py paths by name (Z steps cut from 100 to 50 and
    25, hmc-c8's transitions from 500 + 500 to 250 + 250; PERF.md section 4)."""
    return {"slice": lambda: phase_rounds(X, y, Z, 1, "slice", z_steps=50),
            "hmc-c8": lambda: phase_hmc_c8(X, y, Z),
            "mc-nuts": lambda: phase_rounds(X, y, Z, 4, "mc-nuts", z_steps=25)}


def min_ess_per_s(trace: np.ndarray, seconds: float) -> float:
    """bench.py ``_min_ess_per_s`` for a (S, dim) trace."""
    idx = np.unique(np.linspace(0, trace.shape[1] - 1,
                                min(trace.shape[1], 32)).astype(int))
    return min(effective_sample_size(trace[None, :, j]) for j in idx) / seconds


def check_launches(label, launches, expected):
    print(f"{label} launches: {json.dumps(launches)}")
    missing = [k for k in expected if launches[k] == 0]
    assert not missing, f"{label}: kernels of the path never launched: {missing}"


SGPMC_GROUPED = ("sgpmc_group_", "sgpmc_warm_group")


def check_sgpmc_grouped(label, launches):
    """Every sgpmc launch of the path, the warm start's included, ran a
    kernel of the grouped sgpmc core."""
    other = [k for k, v in launches.items()
             if v and k.startswith("sgpmc") and not k.startswith(SGPMC_GROUPED)]
    assert not other, f"{label}: sgpmc launches off the grouped core: {other}"


def phase_rounds(Xd, yd, Zd, num_chains, label, z_steps):
    """bench.py's headline protocol through the port (float32): warm start,
    NUTS rounds of ``num_chains`` chains with optimize_Z(z_steps) between,
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
            zl, ms = once_ms(lambda: model.optimize_Z(num_steps=z_steps, lr=0.01))
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
                else ["mc_potential", "mc_nuts_chunk"]) + ["sgpr_adam_chunk", "z_adam_stream"]
    check_launches(label, launches, expected)
    assert max(divs) <= 0.1, f"divergence fraction {max(divs)}"
    assert float(np.mean(accs)) >= 0.5, f"mean accept {np.mean(accs)}"
    assert means.shape == (20 * num_chains, X.shape[0]) and vars_.shape == means.shape
    assert torch.isfinite(means).all() and torch.isfinite(vars_).all()
    assert math.isfinite(r) and math.isfinite(nl) and r < 1.0
    return launches


def phase_hmc_c8(Xd, yd, Zd, C=8, T=250, label="hmc-c8",
                 kernels=("sgpr_adam_chunk", "mc_potential", "mc_hmc_chunk"), absent=()):
    """bench.py ``cell_hmc_throughput`` (bench.py:261-284) through the
    port, float32, timed once: warm start 500 steps, then C chains of HMC
    (L=10) with T warmup and T draws each (bench.py: 500). The run must
    launch ``kernels`` and none of ``absent``."""
    X, y, Z = (a.to(torch.float32) for a in (Xd, yd, Zd))
    torch.cuda.synchronize()
    _build.reset_launches()
    model = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    losses, t_warm = once_ms(lambda: model.warm_start(num_steps=500, lr=0.01))
    assert torch.isfinite(losses).all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tr, ms = once_ms(lambda: model.sample_hypers(T, T, gen, num_chains=C,
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
    print(f"{label} warm_start: {t_warm / 1e3:.3f} s; sampling on {CARD} ({C} chains x ({T} warmup "
          f"+ {T} draws), L=10): {secs:.3f} s; divergence fraction {div:.4f}; mean accept "
          f"{acc:.4f}; min-ESS/s (pooled trace {trace.shape[0]} x {dim}) {ess:.3f}; max "
          f"split-R-hat {rhat:.4f}; step sizes "
          f"{', '.join(f'{e:.4g}' for e in st['step_size'].tolist())}; "
          f"{ms / (20 * T):.3f} ms per leapfrog of a chain ({2 * T} transitions x 10)")
    check_launches(label, launches, list(kernels))
    assert not any(launches[k] for k in absent), f"{label} launched one of {absent}"
    assert trace.shape == (C * T, dim) and np.isfinite(trace).all()
    assert div <= 0.1, f"{label} divergence fraction {div}"
    assert acc >= 0.5, f"{label} mean accept {acc}"
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
    pre = "sgpmc_group_" + ("" if num_chains == 1 else "mc_")
    check_launches(label, launches, ["sgpmc_warm_group", pre + "potential",
                                     f"{pre}{algorithm}_chunk"])
    check_sgpmc_grouped(label, launches)
    assert trace.shape == (num_chains * num_samples, d + 2 + Z.shape[0])
    assert np.isfinite(trace).all()
    assert div <= 0.1, f"{label} divergence fraction {div}"
    assert acc >= 0.5, f"{label} mean accept {acc}"
    assert means.shape == (min(50, trace.shape[0]), Xt.shape[0]) == vars_.shape
    assert torch.isfinite(means).all() and torch.isfinite(vars_).all()
    assert math.isfinite(nl) and r < 1.0, (r, nl)
    return launches


def joint_paths(X, y, Z, Xte, yte):
    """The JointHMC main paths by name (depths cut from bench.py's 500 + 500;
    PERF.md section 4)."""
    return {
        "joint-hmc": lambda: phase_joint(X, y, Z, Xte, yte, "joint-hmc", num_warmup=250,
                                         num_samples=250),
        "joint-nuts": lambda: phase_joint(X, y, Z, Xte, yte, "joint-nuts",
                                          algorithm="nuts", num_warmup=50,
                                          num_samples=25),
        "joint-c4": lambda: phase_joint(X, y, Z, Xte, yte, "joint-c4", num_chains=4,
                                        num_warmup=50, num_samples=50),
        "joint-c4-nuts": lambda: phase_joint(X, y, Z, Xte, yte, "joint-c4-nuts",
                                             num_chains=4, algorithm="nuts",
                                             num_warmup=50, num_samples=25),
    }


def unique_rows(trace):
    return int(torch.unique(trace, dim=0).shape[0])


def phase_co2(label, dtype):
    """The Mauna Loa CO2 experiment at full width (N=541, M=480, 11 hypers)
    through the port's model (``co2_model``: the experiment's kernel,
    priors, jitter, Z and seeded hypers), its schedule cut to
    CO2_PROTOCOL[label]: the warm start, then the fixed-Z protocol's one
    NUTS run (co2, co2-f32: ``train_fixed_model`` on the chunked driver,
    one transition kernel launch per transition) or the alternating
    trainer's rounds (co2-alt: ``sample_hypers`` on the co2 NUTS chunk,
    ``optimize_Z`` between); then the mixture predictive. Prints the
    phases' seconds, ms per potential evaluation, launches, each round's
    health, per-lane posterior means, the extrapolation RMSE (ppm) and
    mixture NLPD. Every output must be finite; co2-alt's rounds must move
    (accept > 0, divergence fraction < 1); co2 is held to the health gates
    and to CO2_REF. Returns the launch counts of the run."""
    proto = CO2_PROTOCOL[label]
    X, y, _, Xt, yt, y_std = co2_data(dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    model = co2_model(X, y)
    warm = model.warm_start(num_steps=proto["warm"], lr=0.01)
    theta_warm, lp_warm = model.theta.clone(), log_prior(model.prior_tree, model.hypers)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rounds = []
    if "rounds" in proto:
        for i, (tune, n_draws) in enumerate(proto["rounds"]):
            if i:
                model.optimize_Z(num_steps=proto["z_steps"], lr=0.01)
            model.sample_hypers(tune, n_draws, gen)
            rounds.append(model.stats)
    else:
        model.train_fixed_model(proto["tune"], proto["n_samples"], generator=gen,
                                chunk_size=proto["chunk_size"])
        rounds.append(model.stats)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    means, vars_, rmse_ppm, nlpd = extrapolation(model, Xt, yt, y_std)
    launches = dict(_build.LAUNCHES)
    health = [(float(st["accept_prob"].float().mean()), float(st["diverging"].float().mean()),
               int(st["n_leapfrog"].sum()) + int(st["warmup_n_leapfrog"].sum()),
               float(st["step_size"])) for st in rounds]
    leaps = sum(h[2] for h in health)
    post = model.trace.double().mean(0)
    print(f"{label} on {CARD} ({str(dtype)[6:]}, {proto}): warm start {t1 - t0:.3f} s "
          f"(loss {float(warm[0]):.3f} -> {float(warm[-1]):.3f}), sampling {t2 - t1:.3f} s, "
          f"{leaps} leapfrogs ({(t2 - t1) * 1e3 / max(leaps, 1):.3f} ms per evaluation); per "
          f"NUTS run (mean accept, divergence fraction, leapfrogs, step size) {health}; "
          f"unique draws of the last {unique_rows(model.trace)}/{model.trace.shape[0]}")
    print(f"{label} posterior means (11 lanes): {json.dumps([round(float(v), 6) for v in post])}")
    print(f"{label} extrapolation RMSE {rmse_ppm:.4f} ppm, mixture NLPD {nlpd:.4f} "
          f"({means.shape[0]} components, {Xt.shape[0]} test rows)")
    check_launches(label, launches, ["co2_potential", "co2_nuts_chunk" if "rounds" in proto
                                     else "nuts_transition_co2"])
    assert torch.isfinite(warm).all() and torch.isfinite(model.trace).all()
    assert torch.isfinite(means).all() and torch.isfinite(vars_).all()
    assert math.isfinite(rmse_ppm) and math.isfinite(nlpd)
    if label == "co2-alt":
        assert all(acc > 0 and div < 1 for acc, div, *_ in health), \
            f"co2-alt: a NUTS round did not move {health}"
    if label == "co2":
        acc, div = health[0][:2]
        assert div <= 0.1, f"co2 divergence fraction {div}"
        assert acc >= 0.5, f"co2 mean accept {acc}"
        u_warm = vfe_potential(theta_warm, X, y, model.Z, model.jitter,
                               prior_spec=model.prior_spec, core=model.core)[0]
        hold_co2(float(warm[-1]), float(u_warm + lp_warm), rmse_ppm, nlpd, post)
    return launches


def hold_co2(warm, neg_elbo, rmse_ppm, nlpd, post):
    """The co2 path against the JAX package's CPU run of its protocol
    (CO2_REF): the warm start's final loss and -ELBO at its end from the
    potential kernel (``neg_elbo``) within WARM_LOSS_TOL; RMSE and
    NLPD within CO2_METRIC_TOL, each lane mean within CO2_LANE_TOL, plus
    CO2_SDS of the JAX seeds' standard deviation. Prints each margin; a
    lane whose margin exceeds one log unit is named as loosely held."""
    ref = CO2_REF
    print(f"co2 warm start's final loss {warm:.6f} (the JAX run {ref['warm_loss']:.6f}, "
          f"{abs(warm / ref['warm_loss'] - 1):.3e} apart)")
    assert abs(warm / ref["warm_loss"] - 1) <= WARM_LOSS_TOL, "co2 warm start"
    print(f"co2 -ELBO at the warm start's end from the potential kernel {neg_elbo:.6f} (the "
          f"JAX run {ref['warm_neg_elbo']:.6f}, {abs(neg_elbo / ref['warm_neg_elbo'] - 1):.3e} "
          f"apart)")
    assert abs(neg_elbo / ref["warm_neg_elbo"] - 1) <= WARM_LOSS_TOL, "co2 warm -ELBO"
    for key, got in (("rmse", rmse_ppm), ("nlpd", nlpd)):
        tol = CO2_METRIC_TOL + CO2_SDS * ref[f"{key}_sd"]
        print(f"co2 {key} {got:.4f}: the JAX run's {ref[key]:.4f} +- {tol:.4f} "
              f"({abs(got - ref[key]) / tol:.3f} of it)")
        assert abs(got - ref[key]) <= tol, f"co2 {key} {got} beyond {ref[key]} +- {tol}"
    tols = [CO2_LANE_TOL + CO2_SDS * s for s in ref["lane_sd"]]
    share = [abs(float(a) - b) / t for a, b, t in zip(post, ref["lane_means"], tols)]
    print(f"co2 lane means against the JAX run's: share of the margin per lane "
          f"{[round(v, 3) for v in share]}; loosely held (margin > 1 log unit): "
          f"{[i for i, t in enumerate(tols) if t > 1]}")
    assert max(share) <= 1.0, f"co2 lane means beyond tolerance ({share})"


def co2_paths():
    return {"co2": lambda: phase_co2("co2", torch.float64),
            "co2-f32": lambda: phase_co2("co2-f32", torch.float32),
            "co2-alt": lambda: phase_co2("co2-alt", torch.float32)}


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
    paths = {**flagship_paths(X, y, Z), **joint_paths(X, y, Z, Xte, yte),
             **gpr_paths(X, y, Xte, yte), **svi_paths(X, y, Xte, yte), **co2_paths(),
             "reg-large": phase_reg_large, **joint_large_paths()}
    if not names or any(k.startswith("sghmc") for k in names):
        paths.update(sghmc_paths(big_data()))
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


def big_data(n_rows=1_000_000):
    """bench.py ``cell_sghmc_1m``'s data: synthetic-large's train split
    tiled to ``n_rows`` rows, float32 on the card; with the held-out split
    and the data set (for y_std)."""
    data, Xn, yn = tiled_data("synthetic-large", 0, n_rows)
    f = dict(dtype=torch.float32, device="cuda")
    return (torch.tensor(Xn, **f), torch.tensor(yn, **f), torch.tensor(data.X_test, **f),
            torch.tensor(data.Y_test, **f), data)


def stats_inputs(X, C, M, seed, B=None):
    """Inputs of the statistics kernels for C rows at (X, M): Z rows taken
    from X (scaled), per-row lengthscales e^{N(0, 0.2^2)} and outputscales,
    minibatch indices (C, B) when B, and a random symmetric cotangent. A
    function of the dtype ``dt`` that makes them, so that the float64 reading
    of a float32 case scales the same rows in float64 (Z rows coincide with
    X rows in both)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, dtype=torch.float64, device="cuda")
    N, D = X.shape
    il = torch.exp(0.2 * torch.randn((C, D), **kw))
    rows = torch.randint(0, N, (C, M), generator=gen, device="cuda")
    os = torch.exp(0.1 * torch.randn(C, **kw))
    idx = None if B is None else torch.randint(0, N, (C, B), generator=gen, device="cuda")
    g = torch.randn((C, M, M), **kw)
    gsym, dsky = g + g.transpose(-1, -2), torch.randn((C, M), **kw)

    def make(dt):
        il_t = il.to(dt)
        Zs = (X[rows].to(dt) * il_t[:, None, :]).contiguous()
        return Zs, il_t, os.to(dt), idx, gsym.to(dt).contiguous(), dsky.to(dt)
    return make


def stats_bound(kind, X, Zs, idx, outs, fam="rbf"):
    """(bound_ms, bound_by) of one statistics call: C chains of
    :func:`stats_ops` over the call's rows against the bytes it must move
    (X and y, or the gathered rows and their indices, read once; Zs,
    inv_ls, os and, backward, the cotangents read; the outputs written)."""
    C, M, D = Zs.shape
    n = X.shape[0] if idx is None else idx.shape[1]
    es = X.element_size()
    rows = X.shape[0] * (D + 1) * es if idx is None else C * n * ((D + 1) * es + 8)
    ins = rows + C * (M * D + D + 1) * es + (C * (M * M + M) * es if kind == "bwd" else 0)
    t_ops = C * stats_ops(n, M, D, fam, backward=kind == "bwd") / PEAK_F32_OPS
    t_bytes = (ins + nbytes(*outs)) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def stats_case(label, X, y, inputs, fam, res, bf16=False, record=False, reps=5, key=None):
    """Both statistics kernels against their plain versions on
    ``inputs(X.dtype)``; in float32 both versions are also read against the
    float64 plain version on the same inputs. Prints the errors, the times
    of both and the bounds; ``record`` writes the kernels' rows of ``res``
    (ms, plain_ms, bound), ``key`` their float32 times and bound as extras
    ``{key}_ms``, ``{key}_plain_ms``, ``{key}_bound_ms``."""
    dt = X.dtype
    Zs, il, os, idx, gsym, dsky = inputs(dt)
    tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
    fwd_in, bwd_in = (X, y, Zs, il, os, idx), (X, y, Zs, il, os, idx, gsym, dsky)
    out_f, ref_f = vfe_stats_fwd(*fwd_in, fam, bf16), vfe_stats_fwd_plain(*fwd_in, fam, bf16)
    out_b, ref_b = vfe_stats_bwd(*bwd_in, fam), vfe_stats_bwd_plain(*bwd_in, fam)
    errs = {"fwd": max(rel(a, b) for a, b in zip(out_f, ref_f)),
            "bwd": max(rel(a, b) for a, b in zip(out_b, ref_b))}
    txt, e64 = "", {}
    if f32:
        up = (X.double(), y.double(), *inputs(torch.float64))
        r64f = vfe_stats_fwd_plain(*up[:6], fam, bf16)
        r64b = vfe_stats_bwd_plain(*up, fam)
        for k, o, r, r64 in (("fwd", out_f, ref_f, r64f), ("bwd", out_b, ref_b, r64b)):
            e64[k] = (max(rel(a, c) for a, c in zip(o, r64)),
                      max(rel(b, c) for b, c in zip(r, r64)))
        txt = ("; against float64 from the same inputs: kernel fwd {:.3e} bwd {:.3e}, plain "
               "fwd {:.3e} bwd {:.3e}").format(e64["fwd"][0], e64["bwd"][0], e64["fwd"][1],
                                               e64["bwd"][1])
    ms = {"fwd": cuda_ms(lambda: vfe_stats_fwd(*fwd_in, fam, bf16), reps),
          "bwd": cuda_ms(lambda: vfe_stats_bwd(*bwd_in, fam), reps)}
    pms = {"fwd": cuda_ms(lambda: vfe_stats_fwd_plain(*fwd_in, fam, bf16), 1),
           "bwd": cuda_ms(lambda: vfe_stats_bwd_plain(*bwd_in, fam), 1)}
    bnd = {"fwd": stats_bound("fwd", X, Zs, idx, out_f, fam),
           "bwd": stats_bound("bwd", X, Zs, idx, out_b, fam)}
    print(f"parity vfe_stats {tag} {label}: max rel err fwd {errs['fwd']:.3e} bwd "
          f"{errs['bwd']:.3e}{txt}; kernel fwd {ms['fwd']:.4f} ms bwd {ms['bwd']:.4f} ms, plain "
          f"fwd {pms['fwd']:.4f} ms bwd {pms['bwd']:.4f} ms, bound (float32 peak) fwd "
          f"{bnd['fwd'][0]:.5f} ms bwd {bnd['bwd'][0]:.5f} ms")
    for k in ("fwd", "bwd"):
        assert errs[k] <= STATS_TOL[dt], f"vfe_stats_{k} {tag} {label} rel err {errs[k]}"
        if f32:
            assert e64[k][0] <= STATS_TOL[dt], f"vfe_stats_{k} f32 {label} vs f64 {e64[k][0]}"
        r = res[f"vfe_stats_{k}"]
        r["rel"][tag] = max(r["rel"].get(tag, 0.0), errs[k])
    if f32:
        for k, o, ref in (("fwd", out_f, ref_f), ("bwd", out_b, ref_b)):
            r = res[f"vfe_stats_{k}"]
            r["abs32"] = max(r["abs32"], max(abs_err(a, b) for a, b in zip(o, ref)))
            if record:
                r.update(ms=ms[k], plain_ms=pms[k], bound=bnd[k])
            if key:
                r["extra"].update({f"{key}_ms": ms[k], f"{key}_plain_ms": pms[k],
                                   f"{key}_bound_ms": bnd[k][0]})


def phase_parity_stats(Xb, yb, res):
    """The statistics kernels (csrc/vfe_stats.cu) against their plain
    versions, float64 and float32: at the SGHMC step's shape (C=4 rows: 2
    chains at z and at the anchor; B=2048 rows gathered by index from the
    1M-row X; M=100, D=18), at the anchor's shape (N=1,000,000, C=2), each
    family at N=3000 with Z rows taken from X, and bf16 once. At the anchor
    shape: the peak device memory one forward + backward call adds, against
    N M 4 bytes (a materialised Knm), and cuBLAS's products on a materialised
    K of the same shape: K^T K, the library yardstick of the forward, and K g,
    one product of the backward (no single PyTorch call computes the
    backward, whose library_ms stays null). Then the warm start's grouped
    trainer at the sghmc-exp warm start's shape (n=4096, M=100, D=18, 200
    steps)."""
    N = Xb.shape[0]
    M = 100
    for dt in (torch.float64, torch.float32):
        X, y = Xb.to(dt), yb.to(dt)
        stats_case("step shape (C=4, B=2048 by idx, M=100, D=18)", X, y,
                   stats_inputs(X, 4, M, 21, B=2048), "rbf", res, key="step")
        anchor = stats_inputs(X, 2, M, 22)
        stats_case(f"anchor shape (N={N}, C=2, M=100, D=18)", X, y, anchor, "rbf", res,
                   record=True, reps=3)
        Xs, ys = X[:3000].contiguous(), y[:3000].contiguous()
        for i, fam in enumerate(FAMILIES):
            stats_case(f"{fam} (N=3000, C=2, M=100, Z rows from X)", Xs, ys,
                       stats_inputs(Xs, 2, M, 23 + i), fam, res)
        if dt == torch.float32:
            stats_case("bf16 S_kk inputs, step shape", X, y, stats_inputs(X, 4, M, 27, B=2048),
                       "rbf", res, bf16=True)
            Zs, il, os, idx, gsym, dsky = anchor(dt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            vfe_stats_fwd(X, y, Zs, il, os)
            vfe_stats_bwd(X, y, Zs, il, os, None, gsym, dsky)
            torch.cuda.synchronize()
            added = torch.cuda.max_memory_allocated() - base
            knm = N * M * 4
            print(f"memory vfe_stats f32 anchor shape: one forward + backward adds "
                  f"{added / 1e6:.3f} MB of device memory at peak; a materialised Knm of one "
                  f"chain is N M 4 = {knm / 1e6:.1f} MB")
            assert added < knm / 4, f"vfe_stats peak memory {added} B"
            K = torch.rand((2, N, M), device="cuda")
            lib_f = cuda_ms(lambda: torch.matmul(K.transpose(-1, -2), K), 5)
            lib_b = cuda_ms(lambda: torch.matmul(K, gsym), 5)
            del K
            print(f"reference cuBLAS f32 on a materialised K (2, {N}, {M}): K^T K {lib_f:.4f} "
                  f"ms, K g {lib_b:.4f} ms (one product of the backward, not a call that "
                  f"computes it)")
            res["vfe_stats_fwd"]["library_ms"] = lib_f
            res["vfe_stats_bwd"]["extra"]["kg_product_ms"] = lib_b
    phase_parity_warm4096(Xb, yb, res)


def phase_parity_warm4096(Xb, yb, res, steps=200):
    """sgpr_adam_chunk at the sghmc-exp warm start's shape, where it takes
    the grouped trainer (kernel 3g, site 6's streamed function): the
    experiment's Z and 4096-row subsample (RandomState(45)), theta 0,
    SparseGPR's chain (lr 0.02, clip 100, noise floor 1e-4), one chunk of
    200 steps, kernel against plain. Float32 is held to ADAM_TOL, and both
    float32 versions are read against the float64 run from the same inputs;
    where the plain version itself sits more than F32_RESOLVES from
    float64, the kernel is held to F32_AS_ACCURATE times the plain version's
    error instead (as the SVI chunks are). Two launches of 20 steps must be
    bit-identical; the one-block kernel's time for the same chunk is
    printed beside the grouped one's."""
    rng = np.random.RandomState(45)
    N = Xb.shape[0]
    Zi = torch.as_tensor(rng.randint(0, N, 100), device="cuda")
    sub = torch.as_tensor(rng.randint(0, N, 4096), device="cuda")
    akw = dict(t0=0, lr=0.02, clip_norm=100.0, min_noise=1e-4)
    r = res["sgpr_adam_group"]
    ref64 = None
    for dt in (torch.float64, torch.float32):
        tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
        X, y, Z = (Xb[sub].to(dt).contiguous(), yb[sub].to(dt).contiguous(),
                   Xb[Zi].to(dt).contiguous())
        n, d = X.shape
        th = torch.zeros(d + 2, dtype=dt, device="cuda")
        zt, zz = torch.zeros_like(th), torch.zeros_like(Z)
        args = (th, Z, zt, zt, zz, zz, X, y, 1e-5)
        before = _build.LAUNCHES["sgpr_adam_group"]
        out, ms = once_ms(lambda: sgpr_adam_chunk(*args, num_steps=steps, **akw))
        assert _build.LAUNCHES["sgpr_adam_group"] == before + 1, \
            "sgpr_adam_chunk at n=4096 did not run the grouped trainer"
        ref, pms = once_ms(lambda: sgpr_adam_chunk_plain(*args, num_steps=steps, **akw))
        check_repeat(f"sgpr_adam_chunk {tag} (grouped trainer, n={n}, 20 steps)",
                     lambda: sgpr_adam_chunk(*args, num_steps=20, **akw))
        bound = roofline(steps, n, 100, d, nbytes(X, y) + 3 * nbytes(th, Z), nbytes(*out),
                         want_z=True)
        e = max(rel(a, b) for a, b in zip(out, ref))
        head = (f"parity sgpr_adam_group {tag} at the sghmc-exp warm start (n={n}, M=100, "
                f"D={d}), {steps} steps: max rel err {e:.3e}")
        tail = (f"kernel {ms:.3f} ms, plain {pms:.3f} ms per {steps}-step chunk "
                f"({ms / steps:.4f} ms per step), bound {bound[0]:.5f} ms")
        if f32:
            _, bms = once_ms(lambda: call_sgpr_adam("block", *args, num_steps=steps, **akw))
            tail += f"; the one-block kernel {bms:.3f} ms ({bms / steps:.4f} ms per step)"
            r.update(abs32=max(abs_err(a, b) for a, b in zip(out, ref)), ms=ms, plain_ms=pms,
                     bound=bound)
            r["extra"].update(n4096_block_ms=bms)
        ok, txt = e <= ADAM_TOL[dt], ""
        if f32:
            ek = max(rel(a, b) for a, b in zip(out, ref64))
            ep = max(rel(a, b) for a, b in zip(ref, ref64))
            txt = f"; against float64 from the same inputs: kernel {ek:.3e}, plain {ep:.3e}"
            if not ok and ep > F32_RESOLVES:
                ok = ek <= F32_AS_ACCURATE * ep
                txt += (f" (float32 does not resolve this chunk: kernel held to "
                        f"{F32_AS_ACCURATE:g}x the plain version's error)")
            r["extra"].update(n4096_steps=steps, n4096_f32_vs_f64=ek,
                              n4096_f32_plain_vs_f64=ep)
        else:
            ref64 = ref
        print(f"{head}{txt}; {tail}")
        assert ok, f"sgpr_adam_group {tag} n={n} rel err {e}"
        r["rel"][tag] = max(r["rel"].get(tag, 0.0), e)


def regression_ref():
    """REGRESSION_REF: the JAX package's CPU run of the reg-large path
    (regression_reference.py), read from REGRESSION_REF_FILE beside this
    script."""
    with open(Path(__file__).resolve().with_name(REGRESSION_REF_FILE)) as f:
        return json.load(f)


def large_inputs(dt, ref):
    """The reg-large path's data on the card (synthetic-large, split 0), the
    driver's Z_init, the warm start's hypers and Z of the JAX run, and the
    40-row trace drawn around those hypers (regression_reference.py
    ``zstep_trace``)."""
    data, Zi = run_data("synthetic-large", 0)
    f = dict(dtype=dt, device="cuda")
    th = np.asarray(ref["warm_theta"])
    trace = th + ref["zstep_spread"] * np.random.RandomState(ref["zstep_seed"]).randn(
        ref["zstep_rows"], th.shape[0])
    return [torch.tensor(a, **f) for a in (data.X_train, data.Y_train, Zi, th, ref["warm_Z"],
                                           trace)]


def take_row(res, name, tmp, src, tag, f32):
    """Move the parity record ``tmp[src]`` (made through a wrapper that
    routed to kernel ``name``) into the row of ``res[name]``."""
    r = tmp[src]
    res[name]["rel"][tag] = max(res[name]["rel"].get(tag, 0.0), r["rel"][tag])
    if f32:
        res[name].update(abs32=r["abs32"], ms=r["ms"], plain_ms=r["plain_ms"], bound=r["bound"])


def check_repeat(what, fn):
    """Two calls of ``fn`` on the same inputs give bit-identical outputs
    (tensors, or chain states, in tuples)."""
    def flat(out):
        ts = []
        for o in out:
            ts += state_tensors(o) if isinstance(o, ChainState) else [o]
        return ts
    a, b = flat(fn()), flat(fn())
    same = len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))
    print(f"repeat {what}: two launches on the same inputs bit-identical: {same}")
    assert same, f"{what}: two launches on the same inputs differ"


def phase_parity_large(res, steps=20):
    """The kernels at the reg-large path's shape (synthetic-large: n=13,279,
    D=18, M=100), float64 and float32. Kernel 12 (z_adam_chunk's kernel):
    ``steps`` Z steps over the 40-row trace from the JAX run's warm state,
    against its plain version (float64 to TOL, float32 to ADAM_TOL, or where
    float32 does not resolve the chunk, the kernel's error against the
    float64 plain run at the same jitter within F32_AS_ACCURATE times the
    plain version's), and in float64 against REGRESSION_REF's Z steps
    (REG_ZSTEP_TOL). The grouped vfe core (csrc/vfe_group.cuh), where the
    wrappers route the vfe core past 2048 rows (one chain) and 1024 (C >= 2),
    as the JAX package streams it: vfe_potential at one chain, mc_potential
    and one NUTS chunk pair (warm, sample) at C=2, each against its plain
    version, and each launched twice on the same inputs (bit-identical).
    Each with its time and bound (the grouped sgpmc core at this n:
    :func:`phase_parity_joint_large`).
    Then :func:`phase_group_scaling` and :func:`phase_trainer_large` (the
    warm start's grouped trainer held at this n)."""
    ref = regression_ref()
    zr = res["z_adam_chunk"]
    out64 = None
    for dt in (torch.float64, torch.float32):
        tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
        X, y, Zi, th, Zw, trace = large_inputs(dt, ref)
        n, d = X.shape
        m = Zi.shape[0]
        jit = 1e-5 if f32 else 1e-8
        zz = torch.zeros_like(Zw)
        zkw = dict(t0=0, num_steps=steps, lr=0.01)
        out, ms = once_ms(lambda: z_adam_chunk(Zw, zz, zz, trace, X, y, jit, **zkw))
        out, ms = once_ms(lambda: z_adam_chunk(Zw, zz, zz, trace, X, y, jit, **zkw))
        ref_p, pms = once_ms(lambda: z_adam_stream_plain(Zw, zz, zz, trace, X, y, jit, **zkw))
        bound = roofline(steps * trace.shape[0], n, m, d, nbytes(X, y, trace) + 3 * nbytes(Zw),
                         nbytes(*out), want_z=True)
        e = max(rel(a, b) for a, b in zip(out, ref_p))
        txt, ok = "", e <= (ADAM_TOL if f32 else TOL)[dt]
        if f32:
            r64 = z_adam_stream_plain(*(a.double() for a in (Zw, zz, zz, trace, X, y)), jit,
                                      **zkw)
            ek = max(rel(a, b) for a, b in zip(out, r64))
            ep = max(rel(a, b) for a, b in zip(ref_p, r64))
            txt = f"; against float64 from the same inputs: kernel {ek:.3e}, plain {ep:.3e}"
            if not ok and ep > F32_RESOLVES:
                ok = ek <= F32_AS_ACCURATE * ep
                txt += (f" (float32 does not resolve this chunk: kernel held to "
                        f"{F32_AS_ACCURATE:g}x the plain version's error)")
            zr["extra"].update(n13279_ms=ms, n13279_plain_ms=pms, n13279_bound_ms=bound[0],
                               n13279_f32_vs_f64=ek, n13279_f32_plain_vs_f64=ep)
        else:
            out64 = out
            zr["extra"].update(n13279_ms_f64=ms, n13279_plain_ms_f64=pms)
        print(f"parity z_adam_chunk {tag} (kernel 12) at the reg-large shape (n={n}, M={m}, "
              f"D={d}, {steps} steps x {trace.shape[0]} rows): max rel err {e:.3e} against its "
              f"plain version{txt}; kernel {ms:.3f} ms ({ms / steps:.3f} ms a step), plain "
              f"{pms:.3f} ms" + (f", bound {bound[0]:.5f} ms" if f32 else ""))
        assert ok, f"z_adam_chunk {tag} n={n} rel err {e}"
        zr["rel"][tag] = max(zr["rel"].get(tag, 0.0), e)

        # the vfe core at this n: the grouped kernels
        tmp = new_res()
        xyz = nbytes(X, y, Zi)
        gp = res["vfe_group_potential"]
        before = dict(_build.LAUNCHES)
        U, g = vfe_potential(th, X, y, Zi, jit)
        assert _build.LAUNCHES["vfe_group_potential"] == before["vfe_group_potential"] + 1, \
            "vfe_potential at this n did not run the grouped core"
        U0, g0 = rbf_vfe_neg_logpost_vg(th, X, y, Zi, jit)
        ev = max(rel(U, U0), rel(g, g0))
        check_repeat(f"vfe_potential {tag} (grouped core, one chain)",
                     lambda: vfe_potential(th, X, y, Zi, jit))
        vms = cuda_ms(lambda: vfe_potential(th, X, y, Zi, jit), 10)
        vpms = cuda_ms(lambda: rbf_vfe_neg_logpost_vg(th, X, y, Zi, jit), 3)
        vb = roofline(1, n, m, d, xyz + nbytes(th), (d + 3) * X.element_size())
        G1 = vfe_group.geometry("potential", dt, 1, X.device)
        print(f"parity vfe_potential {tag} at n={n}, D={d}, M={m} (grouped core, G={G1}): max "
              f"rel err {ev:.3e}; kernel {vms:.4f} ms, plain {vpms:.4f} ms, bound {vb[0]:.6f} ms")
        assert ev <= TOL[dt], f"vfe_potential {tag} n={n} rel err {ev}"
        gp["rel"][tag] = max(gp["rel"].get(tag, 0.0), ev)
        if f32:
            gp["extra"].update(c1_ms=vms, c1_plain_ms=vpms, c1_bound_ms=vb[0], c1_group=G1)
        st0, gen = mc_start(X, y, Zi, jit, 2, seed=17, z0=th)
        rows = st0.z + 0.05 * torch.randn(st0.z.shape, generator=gen, dtype=dt, device="cuda")
        potential_parity("mc_potential", lambda r: mc_potential(r, X, y, Zi, jit),
                         lambda r: mc_potential_plain(r, X, y, Zi, jit), rows, tmp, 3,
                         lambda o: (2, n, m, d, xyz + nbytes(rows), nbytes(*o)))
        take_row(res, "vfe_group_potential", tmp, "mc_potential", tag, f32)
        check_repeat(f"mc_potential {tag} (grouped core, C=2)",
                     lambda: mc_potential(rows, X, y, Zi, jit))
        before = dict(_build.LAUNCHES)
        chunk_parity(X, y, Zi, jit, st0, gen, tmp, core="vfe", algo="nuts", grid=2, K=2)
        assert _build.LAUNCHES["vfe_group_mc_nuts_chunk"] \
            == before["vfe_group_mc_nuts_chunk"] + 2, "mc_nuts_chunk did not run the grouped core"
        take_row(res, "vfe_group_nuts_chunk", tmp, "vfe_group_mc_nuts_chunk", tag, f32)
        sl = draw_mc_slabs(2, 2, d + 2, algorithm="nuts", max_depth=8, generator=gen, dtype=dt,
                           device="cuda")
        no = torch.zeros(2, dtype=torch.bool, device="cuda")
        check_repeat(f"mc_nuts_chunk {tag} (grouped core, C=2, a warm chunk of 2)",
                     lambda: mc_nuts_chunk(st0, X, y, Zi, jit, n_active=2, adapt=True,
                                           in_window=no, window_end=no, max_depth=8, **sl))
        if f32:
            gp["extra"]["group"] = vfe_group.geometry("potential", dt, 2, X.device)
            res["vfe_group_nuts_chunk"]["extra"]["group"] = vfe_group.geometry(
                "nuts_chunk", dt, 2, X.device)

    # the kernel in float64 against the JAX package's Z steps (REGRESSION_REF)
    e_l = rel(out64[3].cpu(), torch.tensor(ref["zstep_losses"], dtype=torch.float64))
    e_z = rel(out64[0].cpu(), torch.tensor(ref["zstep_Z"], dtype=torch.float64))
    print(f"z_adam_chunk f64 against the JAX package's Z steps (regression_reference.py): "
          f"losses {e_l:.3e}, Z {e_z:.3e} (held to {REG_ZSTEP_TOL:g})")
    assert max(e_l, e_z) <= REG_ZSTEP_TOL, f"z_adam_chunk against REGRESSION_REF {e_l}, {e_z}"
    zr["extra"].update(zstep_vs_jax_losses=e_l, zstep_vs_jax_Z=e_z)
    phase_group_scaling(ref, res)
    phase_trainer_large(ref, res)


def phase_group_scaling(ref, res, sizes=(404, 1279, 4096, 13279)):
    """Milliseconds per float32 evaluation of the vfe core on both designs,
    one block per chain (``call_potential("vfe", ...)``) and a group of
    blocks per chain (``"vfe_group"``), at C = 1 and 2 chains on the first n
    rows of synthetic-large (calls of the kernels, not of the wrappers:
    they count no launch); both designs must agree to TOL. Also the grouped
    kernels' occupancy, which sets G, and each design's float32 dU/dZ (the
    trainers' options) against the float64 plain version at the largest n,
    printed: no path takes dU/dZ from the potential kernel at that n."""
    X, y, Zi, th, _, _ = large_inputs(torch.float32, ref)
    jit = 1e-5
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = th + 0.05 * torch.randn((2, th.numel()), generator=gen, device="cuda")
    parts, table = [], {}
    for C in (1, 2):
        r = rows[:C].contiguous()
        G = vfe_group.geometry("potential", torch.float32, C, X.device)
        for n in sizes:
            Xn, yn = X[:n].contiguous(), y[:n].contiguous()
            one = call_potential("vfe", r, Xn, yn, Zi, jit)
            grp = call_potential("vfe_group", r, Xn, yn, Zi, jit)
            e = max(rel(a, b) for a, b in zip(grp, one))
            assert e <= TOL[torch.float32], f"the two vfe designs at C={C}, n={n}: {e}"
            t1 = cuda_ms(lambda: call_potential("vfe", r, Xn, yn, Zi, jit), 3)
            tg = cuda_ms(lambda: call_potential("vfe_group", r, Xn, yn, Zi, jit), 10)
            table[f"c{C}_n{n}"] = [t1, tg]
            parts.append(f"C={C} n={n}: one block {t1:.4f} ms, group of {G} {tg:.4f} ms "
                         f"({t1 / tg:.2f}x, {e:.1e} apart)")
    occ = {f"{k} {t}": vfe_group.blocks_per_sm(k, dt) for k in ("potential", "nuts_chunk")
           for t, dt in (("f32", torch.float32), ("f64", torch.float64))}
    print("scaling vfe core f32 per evaluation, one block per chain against a group: "
          + "; ".join(parts) + f" ({CARD})")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"vfe_group occupancy, blocks per SM of {sms}: {json.dumps(occ)}")
    opts = dict(want_z_grad=True, want_prior=False, pivot_floor=1e-6)
    z64 = rbf_vfe_neg_logpost_vg(*(a.double() for a in (rows[0], X, y, Zi)), jit, **opts)[2]
    ez = {k: rel(call_potential(k, rows[:1], X, y, Zi, jit, **opts)[2][0], z64)
          for k in ("vfe", "vfe_group")}
    ez["plain"] = rel(rbf_vfe_neg_logpost_vg(rows[0], X, y, Zi, jit, **opts)[2], z64)
    print(f"dU/dZ f32 at n={X.shape[0]} against float64 plain (printed, not held): "
          + ", ".join(f"{k} {v:.3e}" for k, v in ez.items()))
    res["vfe_group_potential"]["extra"].update(scaling_ms=table, blocks_per_sm=occ,
                                               dz_f32_vs_f64=ez)


def phase_trainer_large(ref, res, steps=20):
    """The warm start's kernel at the reg-large shape (synthetic-large:
    n=13,279, D=18, M=100), where sgpr_adam_chunk takes the grouped trainer
    (kernel 3g, site 6's streamed function): ``steps`` steps from the path's
    start (theta 0, the driver's Z_init; lr 0.01, clip 10, as reg-large's
    warm start) against the plain version, float64 (jitter 1e-8) to TOL and
    float32 (jitter 1e-5) to ADAM_TOL, or where float32 does not resolve the
    chunk, the kernel's error against the float64 plain run at the same
    jitter within F32_AS_ACCURATE times the plain version's; two launches
    bit-identical; and the ms a step of both designs (the one-block kernel
    over 2 steps)."""
    r = res["sgpr_adam_group"]
    for dt in (torch.float64, torch.float32):
        tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
        X, y, Zi, th, _, _ = large_inputs(dt, ref)
        n, d = X.shape
        m = Zi.shape[0]
        th0, zz = torch.zeros_like(th), torch.zeros_like(Zi)
        jit = 1e-5 if f32 else 1e-8
        akw = dict(t0=0, num_steps=steps, lr=0.01, clip_norm=10.0, min_noise=1e-4)
        args = (th0, Zi, th0, th0, zz, zz, X, y, jit)
        before = _build.LAUNCHES["sgpr_adam_group"]
        out, ms = once_ms(lambda: sgpr_adam_chunk(*args, **akw))
        assert _build.LAUNCHES["sgpr_adam_group"] == before + 1, \
            "sgpr_adam_chunk at n=13,279 did not run the grouped trainer"
        ref_p, pms = once_ms(lambda: sgpr_adam_chunk_plain(*args, **akw))
        check_repeat(f"sgpr_adam_chunk {tag} (grouped trainer, n={n}, {steps} steps)",
                     lambda: sgpr_adam_chunk(*args, **akw))
        e = max(rel(a, b) for a, b in zip(out, ref_p))
        ok, txt = e <= (ADAM_TOL if f32 else TOL)[dt], ""
        if f32:
            r64 = sgpr_adam_chunk_plain(*(a.double() for a in args[:-1]), jit, **akw)
            ek = max(rel(a, b) for a, b in zip(out, r64))
            ep = max(rel(a, b) for a, b in zip(ref_p, r64))
            txt = f"; against float64 from the same inputs: kernel {ek:.3e}, plain {ep:.3e}"
            if not ok and ep > F32_RESOLVES:
                ok = ek <= F32_AS_ACCURATE * ep
                txt += (f" (float32 does not resolve this chunk: kernel held to "
                        f"{F32_AS_ACCURATE:g}x the plain version's error)")
            _, bms = once_ms(lambda: call_sgpr_adam("block", *args, **dict(akw, num_steps=2)))
            bound = roofline(steps, n, m, d, nbytes(X, y) + 3 * nbytes(th0, Zi), nbytes(*out),
                             want_z=True)
            txt += (f"; {ms / steps:.4f} ms a step (plain {pms / steps:.4f} ms, the one-block "
                    f"kernel {bms / 2:.4f} ms), bound {bound[0] / steps:.6f} ms a step")
            r["extra"].update(n13279_ms_per_step=ms / steps, n13279_plain_ms_per_step=pms / steps,
                              n13279_block_ms_per_step=bms / 2,
                              n13279_bound_ms_per_step=bound[0] / steps,
                              n13279_f32_vs_f64=ek, n13279_f32_plain_vs_f64=ep)
        print(f"parity sgpr_adam_group {tag} at the reg-large shape (n={n}, M={m}, D={d}), "
              f"{steps} steps from the path's start: max rel err {e:.3e}{txt}")
        assert ok, f"sgpr_adam_group {tag} n={n} rel err {e}"
        r["rel"][tag] = max(r["rel"].get(tag, 0.0), e)


def warm_parity(out, ref_w, args, jit, akw, f32):
    """(max rel err, within tolerance, note) of a warm-start chunk against
    its plain version from the same inputs: float64 to TOL; float32 to
    ADAM_TOL, or, where float32 does not resolve the chunk, no further from
    the float64 plain version than F32_AS_ACCURATE times the float32 plain
    version is."""
    dt = torch.float32 if f32 else torch.float64
    e = max(rel(a, b) for a, b in zip(out, ref_w))
    ok = e <= (ADAM_TOL if f32 else TOL)[dt]
    if not f32:
        return e, ok, ""
    r64 = sgpmc_warm_chunk_plain(*(a.double() for a in args), jit, **akw)
    ek = max(rel(a, b) for a, b in zip(out, r64))
    ep = max(rel(a, b) for a, b in zip(ref_w, r64))
    if not ok and ep > F32_RESOLVES:
        ok = ek <= F32_AS_ACCURATE * ep
    return e, ok, f"; against float64 from the same inputs: kernel {ek:.3e}, plain {ep:.3e}"


def chunk_from_start(X, y, jit, S0, steps):
    """Printed, float64: a chunk of ``steps`` warm-start steps from the
    path's start in one launch, against its plain version, beside what the
    plain version alone does there: with the rows in another order, and
    continued from the kernel's first step. At the start the clipped
    gradient of some Z coordinates lies below Adam's epsilon (1e-8), where
    a step multiplies the gradient's absolute error by lr x clip scale /
    eps, and the next gradient carries the moved Z (the float64 CPU test
    test_warm_start_amplifies_roundoff_at_the_path_start)."""
    akw = dict(t0=0, num_steps=steps, lr=0.01)
    _, gs, gZ = sgpmc_neg_logpost_vg(S0[0], X, y, S0[1], jit, want_z_grad=True,
                                     want_prior=False, pivot_floor=PIVOT_FLOOR)
    sc = min(1.0, CLIP_NORM / float(torch.sqrt((gs * gs).sum() + (gZ * gZ).sum())))
    below = int((sc * gZ.abs() < 1e-8).sum())
    out = sgpmc_warm_chunk(*S0, X, y, jit, **akw)
    ref_w = sgpmc_warm_chunk_plain(*S0, X, y, jit, **akw)
    perm = torch.randperm(X.shape[0], generator=torch.Generator().manual_seed(1)).to(X.device)
    ref_p = sgpmc_warm_chunk_plain(*S0, X[perm], y[perm], jit, **akw)
    one = sgpmc_warm_chunk(*S0, X, y, jit, **dict(akw, num_steps=1))
    cont = sgpmc_warm_chunk_plain(*one[:6], X, y, jit, **dict(akw, t0=1, num_steps=steps - 1))
    errs = [max(rel(a, b) for a, b in zip(o[:6], ref_w[:6])) for o in (out, ref_p, cont)]
    print(f"sgpmc_warm_chunk f64 at n={X.shape[0]}, {steps} steps from the path's start in one "
          f"launch: kernel against plain {errs[0]:.3e}; the plain version with the rows in "
          f"another order {errs[1]:.3e}; the plain version continued from the kernel's first "
          f"step {errs[2]:.3e} (state, Z and Adam moments, norm-relative); at the start "
          f"{below} of {gZ.numel()} Z coordinates have a clipped gradient below Adam's eps, "
          f"and a step there multiplies its absolute error by {akw['lr'] * sc / 1e-8:.3g}")


def phase_parity_joint_large(res, C=2, K=4, L=10, md=4, warm_steps=5):
    """The grouped kernels of the joint-large paths at their shape
    (synthetic-large: n=13,279, D=18, M=100; the sgpmc state d+2+M = 120),
    float64 and float32, each against its plain version, from the regression driver's
    Z_init and REGRESSION_REF's warm hypers with v = 0 (chains at + 0.1
    N(0, 1), step sizes from the batched search): the grouped sgpmc core
    (csrc/sgpmc_group.cuh) under vfe_potential (one chain) and mc_potential
    (C chains); a NUTS chunk pair (warm, sample; K=2, max depth ``md``: the
    plain chunk is host-bound at this n) at one chain (nuts_chunk) and C
    (mc_nuts_chunk); HMC chunk pairs (K transitions of L leapfrogs) at one
    chain (hmc_chunk) and C, and for the grouped vfe core (where the JAX
    package streams it) at C and at hmc-large's 8 chains (mc_hmc_chunk).
    Every grouped kernel is launched twice on the same inputs
    (bit-identical). Then the warm start (sgpmc_warm_chunk, the grouped
    core; float32 as the grouped trainer is held at reg-large's shape):
    :func:`warm_start_parity` from the path's start (SGPMC's initial state
    at the driver's Z_init) ``warm_steps`` single steps, in float64 also a
    chunk of those steps in one launch printed beside the plain version's
    own spread there (:func:`chunk_from_start`), and a timed chunk of
    ``warm_steps`` steps from the chains' state (the warm hypers, v = 0).
    The sgpmc rows take these records as their extras ``n13279_*`` where
    the N=404 parity filled them (else as the row). Then
    :func:`phase_sgpmc_scaling`."""
    ref = regression_ref()
    big = "n13279_"

    def put(row, rec, pre, f32, tag, G):
        """rec into the kernel's row: the row itself where nothing filled
        it and pre is empty, else the extras big + pre."""
        r = res[row]
        r["rel"][tag] = max(r["rel"].get(tag, 0.0), rec["rel"][tag])
        if not f32:
            return
        if not pre and r["ms"] is None:
            r.update(abs32=rec["abs32"], ms=rec["ms"], plain_ms=rec["plain_ms"],
                     bound=rec["bound"])
            r["extra"]["group"] = G
        else:
            r["extra"].update({big + pre + "ms": rec["ms"], big + pre + "plain_ms":
                               rec["plain_ms"], big + pre + "bound_ms": rec["bound"][0],
                               big + pre + "group": G})

    for dt in (torch.float64, torch.float32):
        tag, f32 = ("f32", True) if dt == torch.float32 else ("f64", False)
        X, y, Zi, th, _, _ = large_inputs(dt, ref)
        n, d = X.shape
        m = Zi.shape[0]
        jit = 1e-5 if f32 else 1e-8
        xyz = nbytes(X, y, Zi)
        tmp = new_res()
        zs0 = torch.cat([th, torch.zeros(m, dtype=dt, device="cuda")])
        st0, gen = mc_start(X, y, Zi, jit, C, seed=19, core="sgpmc", z0=zs0)
        row = st0.z[0].contiguous()

        # the potential: one chain, and C chains
        before = _build.LAUNCHES["sgpmc_group_potential"]
        out = vfe_potential(row, X, y, Zi, jit, core="sgpmc")
        assert _build.LAUNCHES["sgpmc_group_potential"] == before + 1, \
            "vfe_potential(core='sgpmc') at this n did not run the grouped core"
        ref_p = sgpmc_neg_logpost_vg(row, X, y, Zi, jit)
        e = max(rel(a, b) for a, b in zip(out, ref_p))
        check_repeat(f"vfe_potential {tag} (grouped sgpmc core, one chain)",
                     lambda: vfe_potential(row, X, y, Zi, jit, core="sgpmc"))
        ms = cuda_ms(lambda: vfe_potential(row, X, y, Zi, jit, core="sgpmc"), 20)
        pms = cuda_ms(lambda: sgpmc_neg_logpost_vg(row, X, y, Zi, jit), 5)
        bound = roofline(1, n, m, d, xyz + nbytes(row), (row.numel() + 1) * X.element_size(),
                         core="sgpmc")
        G1 = vfe_group.geometry("potential", dt, 1, X.device, core="sgpmc_group", n=n)
        print(f"parity sgpmc_group_potential {tag} at n={n}, D={d}, M={m} (one chain, G={G1}): "
              f"max rel err {e:.3e}; kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bound[0]:.6f} ms")
        assert e <= TOL[dt], f"sgpmc_group_potential {tag} n={n} rel err {e}"
        put("sgpmc_group_potential", dict(rel={tag: e}, abs32=max(abs_err(a, b) for a, b in
                                                                  zip(out, ref_p)),
                                          ms=ms, plain_ms=pms, bound=bound), "", f32, tag, G1)
        before = _build.LAUNCHES["sgpmc_group_mc_potential"]
        potential_parity("sgpmc_group_mc_potential",
                         lambda r: mc_potential(r, X, y, Zi, jit, core="sgpmc"),
                         lambda r: mc_potential_plain(r, X, y, Zi, jit, core="sgpmc"), st0.z,
                         tmp, 3, lambda o: (C, n, m, d, xyz + nbytes(st0.z), nbytes(*o), False,
                                            "sgpmc"))
        assert _build.LAUNCHES["sgpmc_group_mc_potential"] > before, \
            "mc_potential(core='sgpmc') at this n did not run the grouped core"
        check_repeat(f"mc_potential {tag} (grouped sgpmc core, C={C})",
                     lambda: mc_potential(st0.z, X, y, Zi, jit, core="sgpmc"))
        put("sgpmc_group_potential", tmp["sgpmc_group_mc_potential"], f"c{C}_", f32, tag,
            vfe_group.geometry("potential", dt, C, X.device, core="sgpmc_group", n=n))

        # the chunks: (algorithm, chains, core, the kernel's row, its extras' prefix)
        st_v, gen_v = mc_start(X, y, Zi, jit, C, seed=21, z0=th)
        st_v8, _ = mc_start(X, y, Zi, jit, 8, seed=23, z0=th)
        cases = [("nuts", 1, "sgpmc", "sgpmc_group_nuts_chunk", ""),
                 ("nuts", C, "sgpmc", "sgpmc_group_nuts_chunk", f"c{C}_"),
                 ("hmc", C, "sgpmc", "sgpmc_group_hmc_chunk", f"c{C}_"),
                 ("hmc", 1, "sgpmc", "sgpmc_group_hmc_chunk", ""),
                 ("hmc", C, "vfe", "vfe_group_hmc_chunk", ""),
                 ("hmc", 8, "vfe", "vfe_group_hmc_chunk", "c8_")]
        for algo, grid, core, row_name, pre in cases:
            st = {"sgpmc": st0, "vfe": st_v8 if grid == 8 else st_v}[core]
            st = as_batch(first_chain(st)) if grid == 1 else st
            kind = ("" if grid == 1 else "mc_") + f"{algo}_chunk"
            key = _build.launch_key(vfe_group.route(core, n, grid), kind)
            before = _build.LAUNCHES[key]
            chunk_parity(X, y, Zi, jit, st, gen if core == "sgpmc" else gen_v, tmp, core=core,
                         algo=algo, grid=grid, K=2 if algo == "nuts" else K, L=L, md=md)
            assert key == f"{core}_group_{kind}" and _build.LAUNCHES[key] == before + 2, \
                f"{core} {kind} at n={n}, C={grid} did not run the grouped core"
            G = vfe_group.geometry(algo + "_chunk", dt, grid, X.device, core=f"{core}_group",
                                   n=n)
            if core == "sgpmc":
                put(row_name, tmp[key], pre, f32, tag, G)
            else:                  # the vfe group runs only at this n: the row is its own
                r = tmp[key]
                res[row_name]["rel"][tag] = max(res[row_name]["rel"].get(tag, 0.0),
                                                r["rel"][tag])
                if f32 and not pre:
                    res[row_name].update(abs32=r["abs32"], ms=r["ms"], plain_ms=r["plain_ms"],
                                         bound=r["bound"])
                    res[row_name]["extra"]["group"] = G
                elif f32:
                    res[row_name]["extra"].update({pre + "ms": r["ms"], pre + "plain_ms":
                                                   r["plain_ms"], pre + "bound_ms":
                                                   r["bound"][0]})
            if grid != 8:
                sl = draw_mc_slabs(2, grid, st.z.shape[1], algorithm=algo, max_depth=md,
                                   generator=gen, dtype=dt, device="cuda")
                no = torch.zeros(2, dtype=torch.bool, device="cuda")
                kw = dict(n_active=2, adapt=True, in_window=no, window_end=no, core=core,
                          **({"num_leapfrog": L} if algo == "hmc" else {"max_depth": md}))
                if grid == 1:
                    fn = nuts_chunk if algo == "nuts" else hmc_chunk
                    one = {k: v[:, 0] for k, v in sl.items()}
                    check_repeat(f"{kind} {tag} (grouped {core} core, one chain)",
                                 lambda: fn(first_chain(st), X, y, Zi, jit, **one, **kw))
                else:
                    fn = mc_nuts_chunk if algo == "nuts" else mc_hmc_chunk
                    check_repeat(f"{kind} {tag} (grouped {core} core, C={grid})",
                                 lambda: fn(st, X, y, Zi, jit, **sl, **kw))

        # the warm start (site 9) at this n: from the path's start one step at a
        # time, in float64 a printed chunk there, then a timed chunk from the
        # chains' state
        pre = big if res["sgpmc_warm_group"]["ms"] is not None else ""
        warm_start_parity(X, y, Zi, jit, res, from_start=warm_steps, state=zs0,
                          steps=warm_steps, pre=pre)
        if not f32:
            start = SGPMC(X, y, Z_init=Zi, jitter=jit, dtype=dt, device="cuda").flat
            z0, zz = torch.zeros_like(start), torch.zeros_like(Zi)
            chunk_from_start(X, y, jit, (start, Zi, z0, z0, zz, zz), warm_steps)
    phase_sgpmc_scaling(ref, res)


def phase_sgpmc_scaling(ref, res, sizes=(404, 1279, 4096, 13279)):
    """Milliseconds per float32 evaluation of the grouped sgpmc core
    (``call_potential("sgpmc_group", ...)``, a call of the kernel, not of the
    wrapper: it counts no launch) at C = 1 and 2 chains on the first n rows
    of synthetic-large, at the geometry the wrappers take (G at each n);
    the time should grow little with n once the rows are spread."""
    X, y, Zi, th, _, _ = large_inputs(torch.float32, ref)
    jit = 1e-5
    m = Zi.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    z0 = torch.cat([th, torch.zeros(m, device="cuda")])
    rows = z0 + 0.05 * torch.randn((2, z0.numel()), generator=gen, device="cuda")
    parts, table = [], {}
    for C in (1, 2):
        r = rows[:C].contiguous()
        for n in sizes:
            Xn, yn = X[:n].contiguous(), y[:n].contiguous()
            G = vfe_group.geometry("potential", torch.float32, C, X.device, core="sgpmc_group",
                                   n=n)
            t = cuda_ms(lambda: call_potential("sgpmc_group", r, Xn, yn, Zi, jit), 10)
            table[f"c{C}_n{n}"] = [t, G]
            parts.append(f"C={C} n={n}: G={G} {t:.4f} ms")
    occ = {f"{k} {t}": vfe_group.blocks_per_sm(k, dt, core="sgpmc_group")
           for k in ("potential", "nuts_chunk", "hmc_chunk", "sgpmc_warm")
           for t, dt in (("f32", torch.float32), ("f64", torch.float64))}
    occ.update({f"vfe_group hmc_chunk {t}": vfe_group.blocks_per_sm("hmc_chunk", dt)
                for t, dt in (("f32", torch.float32), ("f64", torch.float64))})
    print("scaling the grouped sgpmc core f32 per evaluation: " + "; ".join(parts)
          + f" ({CARD})")
    print(f"sgpmc_group occupancy, blocks per SM: {json.dumps(occ)}")
    res["sgpmc_group_potential"]["extra"].update(scaling_ms=table, blocks_per_sm=occ)


def sweep_values(G_max):
    """The G of a sweep: 8, 16, 33, 66, 132, 264 up to ``G_max`` (the most the
    card holds for the launch), and ``G_max`` itself."""
    return sorted({g for g in (8, 16, 33, 66, 132, 264) if g < G_max} | {G_max})


def phase_sgpmc_sweep(Xd, yd, Zd, res, K=8, L=10, md=8, warm_steps=20, large_steps=5):
    """The grouped sgpmc core's G at bench.py's shape (N=404, D=13, M=100;
    the sgpmc state 115), float32, through the kernels' launchers (they
    count no launch), G swept over :func:`sweep_values` and at the
    wrappers' geometry (``vfe_group.geometry``, whose rule for small n
    this sweep measures): ms per leapfrog of a chain of the sampler chunks
    the paths run (the NUTS chunk, max depth ``md``, and the HMC chunk, L
    leapfrogs, at C = 1 and 4; K warmup transitions from the same state and
    slabs at every G); the potential at C = 8 rows (``phase_parity_sgpmc``'s
    call); the warm start (site 9) over ``warm_steps`` steps at N=404 and
    ``large_steps`` at n=13,279 (synthetic-large, from the path's start at
    the driver's Z_init). In float64 first, at every G of the warm start's
    sweep: the potential with dU/dZ and a warm chunk against their plain
    versions, and a repeat bit-identical. (The same line with one block per
    chain beside the groups decided the routing: PERF.md.) Prints one line
    per kernel and records the table in the potential's row."""
    sms = torch.cuda.get_device_properties(Xd.device).multi_processor_count

    def gmax(kind, C, dt=torch.float32):
        return sms * vfe_group.blocks_per_sm(kind, dt, core="sgpmc_group") // C

    def rule(kind, C, n, dt=torch.float32):
        return vfe_group.geometry(kind, dt, C, Xd.device, core="sgpmc_group", n=n)

    X, y, Z = Xd.double(), yd.double(), Zd.double()
    jit = 1e-5
    row0 = mc_start(X, y, Z, jit, 1, seed=47, core="sgpmc")[0].z
    wkw = dict(want_z_grad=True, want_prior=False, pivot_floor=PIVOT_FLOOR)
    ref_p = sgpmc_neg_logpost_vg(row0[0], X, y, Z, jit, **wkw)
    zs, zz = torch.zeros_like(row0[0]), torch.zeros_like(Z)
    args = (row0[0], Z, zs, zs, zz, zz, X, y)
    akw = dict(t0=0, num_steps=warm_steps, lr=0.01)
    ref_w = sgpmc_warm_chunk_plain(*args, jit, **akw)
    worst = [0.0, 0.0]
    g64 = sweep_values(min(gmax(k, 1, torch.float64) for k in ("sgpmc_warm", "potential")))
    for G in g64:
        got = [a[0] for a in call_potential("sgpmc_group", row0, X, y, Z, jit, group=G, **wkw)]
        worst[0] = max(worst[0], max(rel(a, b) for a, b in zip(got, ref_p)))
        got = call_sgpmc_warm(*args, jit, group=G, **akw)
        worst[1] = max(worst[1], max(rel(a, b) for a, b in zip(got, ref_w)))
        check_repeat(f"the grouped warm start f64 at G={G}",
                     lambda: call_sgpmc_warm(*args, jit, group=G, **akw))
    print(f"parity f64 at G in {g64}: the grouped sgpmc potential with dU/dZ {worst[0]:.3e}, "
          f"the grouped warm start over {warm_steps} steps {worst[1]:.3e} from their plain "
          f"versions")
    assert max(worst) <= TOL[torch.float64], worst

    dt = torch.float32
    X, y, Z = Xd.to(dt), yd.to(dt), Zd.to(dt)
    n, d = X.shape
    m = Z.shape[0]
    table, lines = {}, []
    stream = _build.stream_ptr(X.device)
    for algo, C in (("nuts", 1), ("nuts", 4), ("hmc", 1), ("hmc", 4)):
        st, gen = mc_start(X, y, Z, jit, C, seed=41, core="sgpmc")
        sl = draw_mc_slabs(K, C, st.z.shape[1], algorithm=algo, max_depth=md, generator=gen,
                           dtype=dt, device="cuda")
        no = torch.zeros(K, dtype=torch.bool, device="cuda")
        kind = f"{algo}_chunk"
        extra = (dict(LEAPFROG=L, TARGET=0.8, ADAPT_MASS=0) if algo == "hmc"
                 else dict(MAX_DEPTH=md, TARGET=0.8, ADAPT_MASS=0))
        slabs = tuple(sl[k] for k in (("mom", "mh") if algo == "hmc"
                                      else ("mom", "treeu", "leafu")))

        def run(G):
            return launch_chunk(kind, "sgpmc_group", st, X, y, Z, jit, slabs, n_active=K,
                                adapt=True, eps=None, in_window=no, window_end=no,
                                prior_spec=None, stream=stream, group=G, **extra)

        row = {}
        for G in sweep_values(gmax(kind, C)):
            run(G)                                             # warm-up
            (_, _, stats), ms = once_ms(lambda: run(G))
            leaps = float(stats[..., 4].sum()) / C            # leapfrogs of a chain
            row[f"G{G}"] = [ms / leaps, leaps]
        best = min(row, key=lambda k: row[k][0])
        table[f"{algo}_c{C}"] = row
        lines.append(f"{algo} chunk C={C} (ms a leapfrog of a chain, leapfrogs): "
                     + ", ".join(f"{k} {v[0]:.4f} ({v[1]:.0f})" for k, v in row.items())
                     + f"; fastest {best}, the wrappers' G={rule(kind, C, n)}")

    C = 8
    st, gen = mc_start(X, y, Z, jit, C, seed=43, core="sgpmc")
    rows = st.z.contiguous()
    ref = mc_potential_plain(rows, X, y, Z, jit, core="sgpmc")
    row = {}
    for G in sweep_values(gmax("potential", C)):
        got = call_potential("sgpmc_group", rows, X, y, Z, jit, group=G)
        e = max(rel(a, b) for a, b in zip(got, ref))
        assert e <= TOL[dt], f"the grouped potential at C={C}, G={G}: {e}"
        row[f"G{G}"] = cuda_ms(lambda: call_potential("sgpmc_group", rows, X, y, Z, jit,
                                                      group=G), 20)
    table[f"potential_c{C}"] = row
    lines.append(f"potential C={C} (ms a call): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                            row.items())
                 + f"; fastest {min(row, key=row.get)}, the wrappers' G="
                 f"{rule('potential', C, n)}")

    big = large_inputs(dt, regression_ref())
    for (Xw, yw, Zw), steps in (((X, y, Z), warm_steps), (big[:3], large_steps)):
        nw = Xw.shape[0]
        start = SGPMC(Xw, yw, Z_init=Zw, jitter=jit, dtype=dt, device="cuda").flat
        zs, zz = torch.zeros_like(start), torch.zeros_like(Zw)
        args = (start, Zw, zs, zs, zz, zz, Xw, yw)
        akw = dict(t0=0, num_steps=steps, lr=0.01)
        row = {f"G{G}": cuda_ms(lambda: call_sgpmc_warm(*args, jit, group=G, **akw), 3) / steps
               for G in sweep_values(gmax("sgpmc_warm", 1))}
        table[f"warm_n{nw}"] = row
        lines.append(f"warm start n={nw}, {steps} steps from the path's start (ms a step): "
                     + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
                     + f"; fastest {min(row, key=row.get)}, the wrappers' G="
                     f"{rule('sgpmc_warm', 1, nw)}")
    print(f"sweep of the grouped sgpmc core's G, f32 at N={n}, D={d}, M={m} ({CARD}):")
    for line in lines:
        print(f"  sweep {line}")
    res["sgpmc_group_potential"]["extra"]["sweep"] = table


def phase_reg_large():
    """The reg-large path: the port's regression driver
    (experiments/regression.py ``single_run("synthetic-large", 0,
    "BayesianSGPR_HMC")``) at the JAX driver's full protocol in float32:
    13,279 train rows, D=18, M=100, warm start 500 steps (sgpr_adam_chunk),
    three NUTS rounds of 2 chains (mc_potential and mc_nuts_chunk on the
    grouped vfe core), cut to REGRESSION_REF's rounds, 500 Z steps after each
    (kernel 12: S = 20, 10, 20), the 20-component mixture predictive on the
    3,320 test rows. The model's phases are timed, and the rounds cut, from
    outside (its methods wrapped for this run).
    Every round is held to the health gates, the warm start's loss and the
    test metrics to REGRESSION_REF. Returns the launch counts of the run."""
    ref = regression_ref()
    rounds = [tuple(r) for r in ref["rounds"]]
    cls = BayesianSparseGPR_HMC
    orig = {k: getattr(cls, k) for k in ("warm_start", "sample_hypers", "optimize_Z")}
    rec = {k: [] for k in orig}

    def timed(name):
        def run(self, *a, **kw):
            if name == "sample_hypers":     # the round's (tune, n), cut to the reference's
                a = rounds[len(rec[name])] + a[2:]
            out, ms = once_ms(lambda: orig[name](self, *a, **kw))
            row = {"s": ms / 1e3}
            if name == "sample_hypers":
                st = self.stats
                row.update(tune=a[0], n=a[1], div=float(st["diverging"].float().mean()),
                           acc=float(st["accept_prob"].mean()),
                           leapfrogs=float(st["n_leapfrog"].float().mean()),
                           warm_leapfrogs=float(st["warmup_n_leapfrog"].float().mean()),
                           eps=st["step_size"].reshape(-1).tolist())
            else:
                row.update(steps=out.numel(), first=float(out[0]), last=float(out[-1]),
                           finite=bool(torch.isfinite(out).all()))
            rec[name].append(row)
            print(f"reg-large {name} {len(rec[name])}: {row} at "
                  f"{time.perf_counter() - T_START:.1f} s", flush=True)
            return out
        return run

    torch.cuda.synchronize()
    _build.reset_launches()
    try:
        for k in orig:
            setattr(cls, k, timed(k))
        metrics, ms = once_ms(lambda: single_run("synthetic-large", 0, "BayesianSGPR_HMC",
                                                 device="cuda"))
    finally:
        for k, f in orig.items():
            setattr(cls, k, f)
    launches = dict(_build.LAUNCHES)
    (w,) = rec["warm_start"]
    print(f"reg-large warm_start: {w['s']:.3f} s, 500 steps, loss {w['first']:.4f} -> "
          f"{w['last']:.4f} (JAX CPU float64 run {ref['warm_loss']:.4f})")
    for i, (r, z) in enumerate(zip(rec["sample_hypers"], rec["optimize_Z"])):
        print(f"reg-large round {i} (tune={r['tune']}, n={r['n']}, chains=2): {r['s']:.3f} s, "
              f"divergence fraction {r['div']:.3f}, mean accept {r['acc']:.3f}, mean leapfrogs "
              f"{r['leapfrogs']:.1f} a draw and {r['warm_leapfrogs']:.1f} a warmup transition, "
              f"step size {', '.join(f'{e:.4g}' for e in r['eps'])}; "
              f"optimize_Z {z['steps']} steps: {z['s']:.3f} s, loss {z['first']:.4f} -> "
              f"{z['last']:.4f}")
    t_s = sum(r["s"] for r in rec["sample_hypers"])
    t_z = sum(z["s"] for z in rec["optimize_Z"])
    print(f"reg-large seconds: warm start {w['s']:.3f}, sampling {t_s:.3f}, Z steps {t_z:.3f}, "
          f"driver total {ms / 1e3:.3f} ({CARD}); test RMSE {metrics['test_rmse']:.4f}, "
          f"NLPD {metrics['test_nlpd']:.4f} (JAX CPU keys: RMSE {ref['rmse']:.4f} +- "
          f"{ref['rmse_sd']:.4f}, NLPD {ref['nlpd']:.4f} +- {ref['nlpd_sd']:.4f})")
    check_launches("reg-large", launches, ["sgpr_adam_group", "vfe_group_mc_potential",
                                           "vfe_group_mc_nuts_chunk", "z_adam_stream"])
    assert launches["mc_nuts_chunk"] == launches["mc_potential"] \
        == launches["sgpr_adam_chunk"] == 0, \
        "reg-large ran a one-block vfe kernel where the grouped one belongs"
    for i, r in enumerate(rec["sample_hypers"]):
        assert r["div"] <= 0.1, f"reg-large round {i} divergence fraction {r['div']}"
        assert r["acc"] >= 0.5, f"reg-large round {i} mean accept {r['acc']}"
    assert all(z["finite"] for z in rec["optimize_Z"]) and w["finite"]
    assert len(rec["sample_hypers"]) == len(rounds) == 3 and len(rec["optimize_Z"]) == 3
    e_w = abs(w["last"] - ref["warm_loss"]) / abs(ref["warm_loss"])
    assert e_w <= REG_WARM_TOL, f"reg-large warm-start loss {w['last']} vs {ref['warm_loss']}"
    for k in ("rmse", "nlpd"):
        got = metrics[f"test_{k}"]
        margin = REG_METRIC_TOL + REG_SDS * ref[f"{k}_sd"]
        assert math.isfinite(got) and abs(got - ref[k]) <= margin, \
            f"reg-large test {k} {got} vs {ref[k]} +- {margin}"
    return launches


def joint_ref():
    """JOINT_REF: the JAX package's CPU run of the joint-large path
    (joint_reference.py), read from JOINT_REF_FILE beside this script."""
    with open(Path(__file__).resolve().with_name(JOINT_REF_FILE)) as f:
        return json.load(f)


def large_data():
    """synthetic-large (split 0) on the card in float32: X, y, the regression driver's
    Z_init, X_test, y_test, and the data's y standard deviation."""
    data, Zi = run_data("synthetic-large", 0)
    f = dict(dtype=torch.float32, device="cuda")
    return ([torch.tensor(a, **f) for a in (data.X_train, data.Y_train, Zi, data.X_test,
                                             data.Y_test)] + [data.Y_std])


@contextlib.contextmanager
def record_methods(cls, names, rec):
    """Wrap methods of ``cls`` for one run: each call's milliseconds, its
    model and its result go to ``rec[name]``."""
    orig = {k: getattr(cls, k) for k in names}

    def wrapped(name, fn):
        def run(model, *a, **kw):
            out, ms = once_ms(lambda: fn(model, *a, **kw))
            rec.setdefault(name, []).append({"model": model, "out": out, "ms": ms})
            return out
        return run

    try:
        for name, fn in orig.items():
            setattr(cls, name, wrapped(name, fn))
        yield rec
    finally:
        for name, fn in orig.items():
            setattr(cls, name, fn)


def sampler_line(label, model, ms, chains, algorithm, d):
    """The health of a JointHMC run (divergence fraction, mean accept) and
    what it printed; returns (div, acc)."""
    st = model.stats
    div = float(st["diverging"].float().mean())
    acc = float(st["accept_prob"].mean())
    nl = float(st["n_leapfrog"].float().mean())
    leapfrogs = float(st["n_leapfrog"].float().sum() + st["warmup_n_leapfrog"].float().sum())
    rhat = ""
    if chains > 1:
        tr = model.trace.double().cpu().numpy().reshape(chains, -1, model.trace.shape[1])
        rhat = (f"; max split-R-hat over the hypers "
                f"{max(split_rhat(tr[:, :, j]) for j in range(d + 2)):.4f}")
    print(f"{label} sampling on {CARD} ({chains} chain(s), {algorithm}): {ms / 1e3:.3f} s; "
          f"divergence fraction {div:.4f}; mean accept {acc:.4f}; mean leapfrogs/draw {nl:.1f}, "
          f"{leapfrogs:.0f} leapfrogs in all ({ms / leapfrogs:.4f} ms each, the chains' "
          f"leapfrogs summed); step size "
          f"{', '.join(f'{e:.4g}' for e in st['step_size'].reshape(-1).tolist())}{rhat}")
    return div, acc


def phase_joint_large():
    """The joint-large path: the port's regression driver
    (experiments/regression.py ``single_run("synthetic-large", 0,
    "JointHMC")``) in float32: 13,279 train rows, D=18, M=100, train_sgp_hmc's
    100-step warm start (sgpmc_warm_chunk, the grouped sgpmc core: the JAX package runs
    its XLA scan at this n), one chain of NUTS on the grouped sgpmc core
    (vfe_potential and nuts_chunk route there past 2048 rows), cut to
    JOINT_REF's warmup and draws, the 50-component observation-space
    mixture predictive on the 3,320 test rows. Held to the health gates and
    to JOINT_REF (joint_reference.py, the JAX package's CPU run of the same
    cut): the warm start's final loss within JOINT_WARM_TOL relative; the
    test RMSE and NLPD within JOINT_METRIC_TOL + JOINT_SDS SDs; each of the
    d + 2 hyper lanes' trace means within JOINT_LANE_TOL + JOINT_SDS SDs.
    Then three witnesses of the lane gate (after the launch counts are
    read), each a chain of the same cut: from the port's own warm state
    with another seed (printed), and from the JAX run's warm state and Z
    (JOINT_REF's warm_state, warm_Z) in float32 and in float64 at the JAX
    run's jitter, both held to the same margin. Over this cut the chain
    still drifts (log-outputscale from -1 to about -8), so one chain's
    lane means spread with its seed and start, and float32's jitter
    (1e-5 against sf2 ~ 2e-4 there) is part of the model it samples.
    Returns the launch counts of the run."""
    ref = joint_ref()
    torch.cuda.synchronize()
    _build.reset_launches()
    with record_methods(SGPMC, ("warm_start", "train_model"), {}) as rec:
        metrics, ms = once_ms(lambda: single_run("synthetic-large", 0, "JointHMC",
                                                 tune=ref["tune"], num_samples=ref["draws"],
                                                 device="cuda"))
    launches = dict(_build.LAUNCHES)
    (w,), (t,) = rec["warm_start"], rec["train_model"]
    model, losses = t["model"], w["out"]
    d = model.train_x.shape[1]
    print(f"joint-large warm_start: {w['ms'] / 1e3:.3f} s, {losses.numel()} steps, loss "
          f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f} (JAX CPU float64 run "
          f"{ref['warm_loss']:.4f})")
    div, acc = sampler_line(f"joint-large ({ref['tune']} warmup + {ref['draws']} draws)",
                            model, t["ms"], 1, "nuts", d)
    lanes = model.trace[:, :d + 2].double().mean(0).cpu()
    lane_ref, lane_sd = torch.tensor(ref["lane_means"]), torch.tensor(ref["lane_sd"])
    lane_gap = (lanes - lane_ref).abs()
    used = float((lane_gap / (JOINT_LANE_TOL + JOINT_SDS * lane_sd)).max())   # of the margin
    print(f"joint-large seconds: warm start {w['ms'] / 1e3:.3f}, sampling {t['ms'] / 1e3:.3f}, "
          f"driver total {ms / 1e3:.3f} ({CARD}); test RMSE {metrics['test_rmse']:.4f}, NLPD "
          f"{metrics['test_nlpd']:.4f} (JAX CPU keys: RMSE {ref['rmse']:.4f} +- "
          f"{ref['rmse_sd']:.4f}, NLPD {ref['nlpd']:.4f} +- {ref['nlpd_sd']:.4f}); hyper lane "
          f"means, max |port - JAX| {float(lane_gap.max()):.4f}, largest margin used {used:.3f}")
    check_launches("joint-large", launches, ["sgpmc_warm_group", "sgpmc_group_potential",
                                             "sgpmc_group_nuts_chunk"])
    check_sgpmc_grouped("joint-large", launches)
    assert torch.isfinite(losses).all() and torch.isfinite(model.trace).all()
    assert div <= 0.1, f"joint-large divergence fraction {div}"
    assert acc >= 0.5, f"joint-large mean accept {acc}"
    e_w = abs(float(losses[-1]) - ref["warm_loss"]) / abs(ref["warm_loss"])
    assert e_w <= JOINT_WARM_TOL, f"joint-large warm-start loss {float(losses[-1])} vs " \
                                  f"{ref['warm_loss']}"
    for k in ("rmse", "nlpd"):
        got = metrics[f"test_{k}"]
        margin = JOINT_METRIC_TOL + JOINT_SDS * ref[f"{k}_sd"]
        assert math.isfinite(got) and abs(got - ref[k]) <= margin, \
            f"joint-large test {k} {got} vs {ref[k]} +- {margin}"
    assert used <= 1.0, f"joint-large hyper lane means {lanes.tolist()}"
    warm_state = torch.tensor(ref["warm_state"], dtype=model.flat.dtype, device="cuda")
    warm_Z = torch.tensor(ref["warm_Z"], dtype=model.Z.dtype, device="cuda")
    gap = (model.flat - warm_state).abs()
    worst = [int(j) for j in (lane_gap / (JOINT_LANE_TOL + JOINT_SDS * lane_sd)).argsort()[-3:]]
    print(f"joint-large warm state, port's float32 run against the JAX float64 run: max |diff| "
          f"over the hyper lanes {float(gap[:d + 2].max()):.4f} (lanes {worst}, the three that "
          f"use most of the sampler gate's margin: "
          f"{[round(float(gap[j]), 4) for j in worst]}), over v {float(gap[d + 2:].max()):.4f}, "
          f"over Z {float((model.Z - warm_Z).abs().max()):.4f}")
    f64 = SGPMC(model.train_x.double(), model.train_y.double(), Z_init=warm_Z.double(),
                dtype=torch.float64, device="cuda")
    witnesses = [("port's warm state, float32, generator seed 46", model, model.flat.clone(),
                  model.Z, 46, False),
                 ("JAX run's warm state and Z, float32, generator seed 45", model, warm_state,
                  warm_Z, 45, True),
                 (f"JAX run's warm state and Z, float64 at jitter {f64.jitter:g}, generator seed "
                  f"45", f64, warm_state.double(), f64.Z, 45, True)]
    for label, mod, flat, Z, seed, held in witnesses:
        mod.flat, mod.Z = flat, Z
        mod.train_model(num_warmup=ref["tune"], num_samples=ref["draws"],
                        generator=torch.Generator(device="cuda").manual_seed(seed))
        got = mod.trace[:, :d + 2].double().mean(0).cpu()
        share = (got - lane_ref).abs() / (JOINT_LANE_TOL + JOINT_SDS * lane_sd)
        print(f"joint-large witness from the {label}: lanes {worst} at "
              f"{[round(float(got[j]), 4) for j in worst]} (JAX keys "
              f"{[round(float(lane_ref[j]), 4) for j in worst]} +- "
              f"{[round(float(lane_sd[j]), 4) for j in worst]}); largest margin used "
              f"{float(share.max()):.3f} (lane {int(share.argmax())}); mean accept "
              f"{float(mod.stats['accept_prob'].mean()):.4f}{'' if held else ' (printed)'}")
        assert torch.isfinite(mod.trace).all()
        assert not held or float(share.max()) <= 1.0, \
            f"joint-large lanes from the {label}: {got.tolist()}"
    return launches


def phase_joint_large_c2(C=2, T=50):
    """The joint-large-c2 path: ``train_sgp_hmc`` on synthetic-large (as
    joint-large) with C chains of the reference gpflow protocol's
    fixed-leapfrog HMC (``algorithm="hmc"``, L=10; experiments/
    regression_sgpmc.py's 2 chains), T warmup and T draws each (500 + 500
    cut), float32: mc_potential and mc_hmc_chunk on the grouped sgpmc core,
    then the 50-component predictive. Health gates and finite outputs.
    Returns the launch counts of the run."""
    X, y, Z, Xt, yt, y_std = large_data()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    _build.reset_launches()
    with record_methods(SGPMC, ("warm_start", "train_model"), {}) as rec:
        model, ms = once_ms(lambda: train_sgp_hmc(
            (X, y), Z, num_warmup=T, num_samples=T, generator=gen, num_chains=C,
            algorithm="hmc", num_leapfrog=10, device="cuda"))
    (means, vars_), t_pred = once_ms(lambda: model.mixture_posterior_predictive_y(Xt, 50))
    launches = dict(_build.LAUNCHES)
    (w,), (t,) = rec["warm_start"], rec["train_model"]
    d = X.shape[1]
    div, acc = sampler_line(f"joint-large-c2 ({T} warmup + {T} draws, L=10)", model, t["ms"],
                            C, "hmc", d)
    r = float(rmse(means.mean(0), yt, y_std))
    nl = float(nlpd_mixture(means, vars_, yt, y_std))
    print(f"joint-large-c2 seconds: warm start {w['ms'] / 1e3:.3f}, sampling "
          f"{t['ms'] / 1e3:.3f} ({t['ms'] / (2 * T * 10):.4f} ms a leapfrog of the {C} chains), "
          f"predictive {t_pred / 1e3:.3f}, total {ms / 1e3:.3f} ({CARD}); test RMSE {r:.4f}, "
          f"NLPD {nl:.4f} ({means.shape[0]} components)")
    check_launches("joint-large-c2", launches, ["sgpmc_warm_group", "sgpmc_group_mc_potential",
                                                "sgpmc_group_mc_hmc_chunk"])
    check_sgpmc_grouped("joint-large-c2", launches)
    assert model.trace.shape == (C * T, d + 2 + Z.shape[0])
    assert torch.isfinite(model.trace).all()
    assert div <= 0.1, f"joint-large-c2 divergence fraction {div}"
    assert acc >= 0.5, f"joint-large-c2 mean accept {acc}"
    assert torch.isfinite(means).all() and torch.isfinite(vars_).all()
    assert math.isfinite(r) and math.isfinite(nl), (r, nl)
    return launches


def joint_large_paths():
    """The paths at synthetic-large's full width (13,279 rows, D=18, M=100)
    on the grouped sgpmc and vfe HMC kernels, by name (depths cut: PERF.md
    section 4)."""
    def hmc_large():
        X, y, Z = large_data()[:3]
        return phase_hmc_c8(X, y, Z, T=50, label="hmc-large",
                            kernels=("sgpr_adam_group", "vfe_group_mc_potential",
                                     "vfe_group_mc_hmc_chunk"),
                            absent=("sgpr_adam_chunk", "mc_potential", "mc_hmc_chunk"))
    return {"joint-large": phase_joint_large, "joint-large-c2": phase_joint_large_c2,
            "hmc-large": hmc_large}


def hyper_means(samples):
    """The kept draws' mean of each log-hyper, pooled over chains:
    [log_ls (d), log_os, log_noise]."""
    k = samples["kernel"]
    return torch.cat([k["base"]["log_lengthscale"].mean((0, 1)),
                      k["log_outputscale"].mean((0, 1))[None],
                      samples["log_noise"].mean((0, 1))[None]])


def sghmc_bench(X, y, cfg, seed):
    """bench.py ``cell_sghmc_1m``'s SGHMC run (bench.py:287-350) on the rows
    (X, y), on their device: M=100 Z rows by RandomState(45), hypers from
    ``init_params`` with log-noise log 0.05, ``prior_tree_rbf``, 2 chains,
    minibatch statistics scaled by N/B, the SVRG anchor on all N rows.
    Returns ``run_sghmc``'s (samples, stats)."""
    N, D = X.shape
    dev = X.device
    Z = X[torch.as_tensor(np.random.RandomState(45).randint(0, N, 100), device=dev)]
    kern = default_rbf(ard=True)
    hypers = {"kernel": kern.init_params(D, dtype=X.dtype, device=dev),
              "log_noise": torch.tensor(math.log(0.05), dtype=X.dtype, device=dev)}
    prior = prior_tree_rbf()

    def logpost(state, idx):
        st = vfe_stats(kern, state["kernel"], Z, X, y, idx)
        st = {k: v * (N / idx.shape[1]) for k, v in st.items()}
        ll = sgpr_elbo_from_stats(kern, {**state, "Z": Z}, st, N, 1e-5)
        return ll.sum() + log_prior(prior, state)

    def logpost_full(state):
        st = vfe_stats(kern, state["kernel"], Z, X, y)
        ll = sgpr_elbo_from_stats(kern, {**state, "Z": Z}, st, N, 1e-5)
        return ll.sum() + log_prior(prior, state)

    return run_sghmc(logpost, hypers, torch.Generator(device=dev).manual_seed(seed), N, cfg,
                     num_chains=2, full_logpost_fn=logpost_full)


def bench_cfg(steps=2000):
    """bench.py's SGHMC-1M settings: step size 2e-5 -> 1e-5, batch 2048,
    warmup steps // 3, thin 10, the SVRG anchor."""
    return SGHMCConfig(step_size=2e-5, final_step_size=1e-5, friction=0.05, num_steps=steps,
                       batch_size=2048, num_warmup=steps // 3, thin=10, control_variate=True)


def hold_to_reference(label, got, ref):
    """Hold what an SGHMC protocol moves against the JAX package's CPU run of
    it at the same rows (SGHMC_REF): the kept draws' mean log-hypers within
    DRAW_MEAN_TOL plus 3x the JAX run's own difference between its two
    chains, dimension by dimension (the port draws other minibatches and
    noise); the warm start's final loss and log-noise where given."""
    jm = torch.tensor(ref["draws_mean_log_hypers"], dtype=torch.float64)
    spread = (torch.tensor(ref["chain_mean_log_hypers"][0], dtype=torch.float64)
              - torch.tensor(ref["chain_mean_log_hypers"][1], dtype=torch.float64)).abs()
    tol = DRAW_MEAN_TOL + 3.0 * spread
    gm = got["draws_mean_log_hypers"].double().cpu()
    dev = (gm - jm).abs()
    worst = int(torch.argmax(dev / tol))
    print(f"{label} against the JAX package's CPU run at N={ref['n_rows']}: kept draws' mean "
          f"log-hypers [log_ls (18), log_os, log_noise] "
          + ", ".join(f"{v:.4f}" for v in gm.tolist())
          + f"; JAX log_os {jm[-2]:.4f}, log_noise {jm[-1]:.4f}; largest |port - JAX| / "
          f"tolerance {float(dev[worst] / tol[worst]):.3f} (dim {worst}: {float(dev[worst]):.4f} "
          f"against {float(tol[worst]):.4f})")
    assert bool((dev <= tol).all()), f"{label}: draws' mean log-hypers {dev.tolist()}"
    if "warm_loss" in ref:
        wl = got["warm_loss"]
        rel_loss = abs(wl - ref["warm_loss"]) / abs(ref["warm_loss"])
        wn = float(got["warm_log_hypers"][-1])
        dn = abs(wn - ref["warm_log_hypers"][-1])
        print(f"{label} warm start: final loss {wl:.4f} (JAX {ref['warm_loss']:.4f}, rel "
              f"{rel_loss:.3e}; gate {WARM_LOSS_TOL:g}), log-noise {wn:.5f} (JAX "
              f"{ref['warm_log_hypers'][-1]:.5f}; gate {WARM_NOISE_TOL:g}), log-outputscale "
              f"{float(got['warm_log_hypers'][-2]):.4f} (JAX {ref['warm_log_hypers'][-2]:.4f})")
        assert rel_loss <= WARM_LOSS_TOL, f"{label}: warm-start loss {wl}"
        assert dn <= WARM_NOISE_TOL, f"{label}: warm-start log-noise {wn}"


def phase_sghmc_1m(big):
    """bench.py ``cell_sghmc_1m`` (bench.py:287-350) through the port,
    float32: synthetic-large tiled to N=1e6 (``sghmc_bench``); an untimed
    20-step run (seed 99), then 2000 timed steps x 2 chains of SGHMC with
    the SVRG anchor (step size 2e-5 -> 1e-5, batch 2048, warmup 666, thin
    10). Then the same protocol on the first 100,000 rows, held against the
    JAX package's CPU run of it (``sghmc_reference.py``)."""
    X, y = big[0], big[1]
    N, D = X.shape
    steps, B = 2000, 2048
    torch.cuda.synchronize()
    _build.reset_launches()
    _, t_first = once_ms(lambda: sghmc_bench(
        X, y, SGHMCConfig(step_size=2e-5, num_steps=20, batch_size=B, num_warmup=5, thin=5,
                          control_variate=True), 99))
    (samples, st), ms = once_ms(lambda: sghmc_bench(X, y, bench_cfg(steps), 0))
    secs = ms / 1e3
    finite = bool(torch.isfinite(ravel_tree(samples)[0]).all())
    means = hyper_means(samples)
    print(f"sghmc-1m on {CARD} (N={N}, D={D}, M=100, 2 chains x {steps} steps, batch {B}, "
          f"SVRG anchor every 200): {secs:.3f} s, {2 * steps / secs:.1f} steps/s "
          f"({secs * 1e3 / steps:.3f} ms per step of both chains; first untimed 20-step run "
          f"{t_first / 1e3:.3f} s); kept {st['num_kept']} x 2 draws, all finite {finite}; "
          f"kept draws' mean log-hypers [log_ls (18), log_os, log_noise] "
          + ", ".join(f"{v:.4f}" for v in means.tolist()))
    assert finite, "sghmc-1m: non-finite samples"
    ref = SGHMC_REF["sghmc-1m"]
    n = ref["n_rows"]
    (samples, st), ms = once_ms(lambda: sghmc_bench(X[:n], y[:n], bench_cfg(steps), 0))
    print(f"sghmc-1m at N={n}: {ms / 1e3:.3f} s, all finite "
          f"{bool(torch.isfinite(ravel_tree(samples)[0]).all())}")
    hold_to_reference("sghmc-1m", {"draws_mean_log_hypers": hyper_means(samples)}, ref)
    launches = dict(_build.LAUNCHES)
    check_launches("sghmc-1m", launches, ["vfe_stats_fwd", "vfe_stats_bwd"])
    return launches


def warm_log_hypers(params):
    """[log_ls (d), log_os, log_noise] of SparseGPR params."""
    k = params["kernel"]
    return torch.cat([k["base"]["log_lengthscale"], k["log_outputscale"][None],
                      params["log_noise"][None]])


def phase_sghmc_exp():
    """The port's ``experiments/large_scale_regression_sghmc.py`` ``main()``
    at n_rows=1e6 with the SVRG anchor, bench.py's step sizes (2e-5 ->
    1e-5), 2000 steps, 2 chains: the SparseGPR warm start (1000 Adam steps
    on 4096 rows), SGHMC, and the 30-component mixture predictive's RMSE
    and NLPD on the held-out split, gated a margin beyond the JAX package's
    CPU run (SGHMC_EXP_GATES). Then the same at n_rows=100,000, where the
    warm start's loss and log-noise and the kept draws' mean log-hypers are
    held against the JAX package's CPU run at those rows (SGHMC_REF)."""
    kw = dict(control_variate=True, step_size=2e-5, final_step_size=1e-5, num_steps=2000,
              num_chains=2, device="cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    out = sghmc_main(n_rows=1_000_000, **kw)
    launches = dict(_build.LAUNCHES)
    print(f"sghmc-exp on {CARD}: warm start {out['warm_seconds']:.3f} s "
          f"({launches['sgpr_adam_group']} sgpr_adam_group launches); SGHMC "
          f"{out['sghmc_seconds']:.3f} s ({out['steps_per_s']:.1f} steps/s), all finite "
          f"{out['finite']}; {out['components']} components: test RMSE {out['rmse']:.4f}, "
          f"mixture NLPD {out['nlpd']:.4f} (gates: RMSE <= {SGHMC_EXP_GATES['rmse']}, NLPD <= "
          f"{SGHMC_EXP_GATES['nlpd']}); mean log-hypers "
          + ", ".join(f"{v:.4f}" for v in hyper_means(out["samples"]).tolist()))
    check_launches("sghmc-exp", launches, ["sgpr_adam_group", "vfe_stats_fwd", "vfe_stats_bwd"])
    assert out["finite"], "sghmc-exp: non-finite samples"
    assert out["rmse"] <= SGHMC_EXP_GATES["rmse"], out["rmse"]
    assert out["nlpd"] <= SGHMC_EXP_GATES["nlpd"], out["nlpd"]
    ref = SGHMC_REF["sghmc-exp"]
    out = sghmc_main(n_rows=ref["n_rows"], **kw)
    print(f"sghmc-exp at N={ref['n_rows']}: warm start {out['warm_seconds']:.3f} s, SGHMC "
          f"{out['sghmc_seconds']:.3f} s, all finite {out['finite']}; test RMSE "
          f"{out['rmse']:.4f}, mixture NLPD {out['nlpd']:.4f} (JAX {ref['rmse']:.4f}, "
          f"{ref['nlpd']:.4f})")
    assert out["finite"], "sghmc-exp at 100k rows: non-finite samples"
    assert out["rmse"] <= SGHMC_EXP_GATES["rmse"], out["rmse"]
    assert out["nlpd"] <= SGHMC_EXP_GATES["nlpd"], out["nlpd"]
    hold_to_reference("sghmc-exp", {"draws_mean_log_hypers": hyper_means(out["samples"]),
                                    "warm_loss": out["warm_loss"],
                                    "warm_log_hypers": warm_log_hypers(out["warm_params"])},
                      ref)
    return dict(_build.LAUNCHES)


def sghmc_paths(big):
    """The big-N SGHMC main paths by name."""
    return {"sghmc-1m": lambda: phase_sghmc_1m(big), "sghmc-exp": phase_sghmc_exp}


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
    only = argv[0] if argv[:1] in (["co2"], ["reg-large"], ["gpr"], ["joint-large"],
                                    ["sweep"]) else None
    if only == "sweep":
        phase_sgpmc_sweep(X, y, Zd, new_res())
        return
    res = new_res()
    if only is None:
        phase_parity(X, y, Zd, res)
        phase_parity_mc(X, y, Zd, res)
        phase_parity_sgpmc(X, y, Zd, res)
        phase_sgpmc_sweep(X, y, Zd, res)
    if only in (None, "gpr"):
        phase_parity_gpr(X, y, res)
    if only is None:
        phase_parity_svi(X, y, Zd, res)
        big = big_data()
        phase_parity_stats(big[0], big[1], res)
    if only in (None, "reg-large"):
        phase_parity_large(res)
    if only in (None, "joint-large"):
        phase_parity_joint_large(res)
    if only in (None, "co2"):
        phase_parity_co2(X, y, Zd, res)
    print(f"parity done at {time.perf_counter() - T_START:.1f} s")
    subset = {"co2": CO2_KERNELS, "reg-large": REG_KERNELS, "gpr": GPR_KERNELS,
              "joint-large": JOINT_KERNELS}.get(only, KERNELS)
    names = [k for k in KERNELS if k in subset]
    launches = {k: 0 for k in names}
    paths = [] if only else [
        *flagship_paths(X, y, Z).values(),
        *joint_paths(X, y, Z, Xte, yte).values(),
        *gpr_paths(X, y, Xte, yte).values(),
        *svi_paths(X, y, Xte, yte).values(),
        *sghmc_paths(big).values()]
    if only == "gpr":
        paths += list(gpr_paths(X, y, Xte, yte).values())
    if only in (None, "reg-large"):
        paths.append(phase_reg_large)
    if only in (None, "joint-large"):
        paths += list(joint_large_paths().values())
    if only in (None, "co2"):
        paths += list(co2_paths().values())
    for run in paths:
        got = run()
        for k in launches:
            launches[k] += sum(got[c] for c in LAUNCH_SUMS.get(k, (k,)) if c in got)
        print(f"main paths at {time.perf_counter() - T_START:.1f} s")
    if only is None:
        phase_scaling(X, y, Z)
    if only in (None, "gpr"):
        phase_gpr_parts(X, y)
    assert all(v > 0 for v in launches.values()), launches
    out = []
    for name in names:
        src, site, also = KERNELS[name]
        r = res[name]
        bound_ms, bound_by = r["bound"]
        item = {"name": name, "route": "cuda", "source": src, "replaces": site,
                "launches": launches[name], "max_abs_err": r["abs32"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": r["library_ms"],
                "max_rel_err_f64": r["rel"].get("f64"), "max_rel_err_f32": r["rel"].get("f32"),
                **r["extra"]}
        if also:
            item["also_replaces"] = list(also) if isinstance(also, tuple) else also
        out.append(item)
    print(f"total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
