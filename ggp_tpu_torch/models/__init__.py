from .bayesian_sgpr_hmc import BayesianSparseGPR_HMC

__all__ = ["BayesianSparseGPR_HMC"]
