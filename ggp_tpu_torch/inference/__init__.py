from .diagnostics import effective_sample_size, split_rhat
from .hmc import NUTSConfig
from .sghmc import SGHMCConfig, run_sghmc

__all__ = ["NUTSConfig", "SGHMCConfig", "effective_sample_size", "run_sghmc", "split_rhat"]
