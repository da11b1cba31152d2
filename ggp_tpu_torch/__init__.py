"""ggp_tpu_torch — the PyTorch/CUDA port of ggp_tpu for NVIDIA Hopper.

It carries three models. BayesianSparseGPR_HMC: ML-II warm start, NUTS
or HMC over the hyperparameters under the collapsed Titsias bound (one
chain or C), Adam on the inducing locations between rounds, and the
mixture predictive. SGPMC ("JointHMC"): Adam warm start of (hypers,
whitened inducing values, Z), then NUTS or HMC jointly over the hypers and
the whitened inducing values, and the 50-component mixture predictive.
GPR_HMC: NUTS (one chain or C) over the hyperparameters of the exact GP
under its dense marginal likelihood, and the full mixture predictive.
StochasticVariationalGP (Gaussian, Bernoulli-probit, Poisson or softmax
likelihood) and BayesianStochasticVariationalGP: minibatch SVI, whole
epochs of Adam steps per kernel launch, and their predictives. SparseGPR:
ML-II Adam on (hypers, Z) under the collapsed bound, chunks of steps per
launch, and its predictive. ``inference.sghmc.run_sghmc``: SGHMC with C
chains over the collapsed bound from minibatch statistics
(``models.sgpr.vfe_stats``), as the 1M-row experiment
``experiments.large_scale_regression_sghmc`` runs it.
BayesianSparseGPR_HMC also takes the Mauna Loa CO2 composite
(``kernels.co2_kernel``), sampled by one launch per NUTS transition as
``experiments.co2_bayesian_sgpr_hmc`` runs it. ``experiments.regression``
is the regression benchmark driver over the port's models. The
hand-written CUDA kernels (``csrc/``) are built at first use on a machine
with ``nvcc``; CPU tensors run each kernel's plain PyTorch version.
"""

from . import config  # noqa: F401  (sets the TF32 policy)
from .config import BASE_SEED, default_jitter
from .models import (GPR_HMC, SGPMC, BayesianSparseGPR_HMC, BayesianStochasticVariationalGP,
                     SparseGPR, StochasticVariationalGP, gp_marginal_loglik, gp_predict)

__all__ = ["BayesianSparseGPR_HMC", "BayesianStochasticVariationalGP", "GPR_HMC", "SGPMC",
           "SparseGPR", "StochasticVariationalGP", "gp_marginal_loglik", "gp_predict", "BASE_SEED",
           "default_jitter"]
