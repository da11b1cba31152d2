from .base import RBF, Kernel, Scale, sq_dist
from .composite import default_rbf

__all__ = ["Kernel", "RBF", "Scale", "sq_dist", "default_rbf"]
