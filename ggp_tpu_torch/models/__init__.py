from .bayesian_sgpr_hmc import BayesianSparseGPR_HMC
from .sgpmc import SGPMC, predict_sgpmc, train_sgp_hmc

__all__ = ["BayesianSparseGPR_HMC", "SGPMC", "train_sgp_hmc", "predict_sgpmc"]
