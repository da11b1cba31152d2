from .base import RBF, Kernel, Scale, is_scale_rbf, sq_dist
from .composite import default_rbf

__all__ = ["Kernel", "RBF", "Scale", "is_scale_rbf", "sq_dist", "default_rbf"]
