"""ggp_tpu_torch — the PyTorch/CUDA port of ggp_tpu for NVIDIA Hopper.

The first slice carries the flagship BayesianSparseGPR_HMC path: ML-II warm
start, single-chain NUTS rounds over the hyperparameters under the
collapsed Titsias bound, Adam on the inducing locations between rounds,
and the mixture predictive. Its four hand-written CUDA kernels
(``csrc/``) are built at first use on a machine with ``nvcc``; CPU tensors
run each kernel's plain PyTorch version.
"""

from . import config  # noqa: F401  (sets the TF32 policy)
from .config import BASE_SEED, default_jitter
from .models import BayesianSparseGPR_HMC

__all__ = ["BayesianSparseGPR_HMC", "BASE_SEED", "default_jitter"]
