from .bayesian_sgpr_hmc import BayesianSparseGPR_HMC
from .gpr_hmc import GPR_HMC, gp_marginal_loglik, gp_predict
from .sgpmc import SGPMC, predict_sgpmc, train_sgp_hmc

__all__ = ["BayesianSparseGPR_HMC", "GPR_HMC", "SGPMC", "gp_marginal_loglik",
           "gp_predict", "train_sgp_hmc", "predict_sgpmc"]
