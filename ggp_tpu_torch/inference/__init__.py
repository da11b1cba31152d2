from .diagnostics import effective_sample_size, split_rhat
from .hmc import NUTSConfig

__all__ = ["NUTSConfig", "effective_sample_size", "split_rhat"]
