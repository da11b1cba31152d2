from .bayesian_sgpr_hmc import BayesianSparseGPR_HMC
from .bayesian_svgp import BayesianStochasticVariationalGP
from .gpr_hmc import GPR_HMC, gp_marginal_loglik, gp_predict
from .sgpmc import SGPMC, predict_sgpmc, train_sgp_hmc
from .svgp import StochasticVariationalGP, svgp_elbo, svgp_predict_f

__all__ = ["BayesianSparseGPR_HMC", "BayesianStochasticVariationalGP", "GPR_HMC", "SGPMC",
           "StochasticVariationalGP", "gp_marginal_loglik", "gp_predict", "train_sgp_hmc",
           "predict_sgpmc", "svgp_elbo", "svgp_predict_f"]
