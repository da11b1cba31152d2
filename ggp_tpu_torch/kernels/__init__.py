from .base import (RBF, Kernel, Matern32, Periodic, Product, RationalQuadratic, Scale, Sum,
                   dist, is_scale_rbf, sq_dist)
from .composite import co2_kernel, default_rbf

__all__ = ["Kernel", "RBF", "Matern32", "RationalQuadratic", "Periodic", "Scale", "Sum",
           "Product", "is_scale_rbf", "sq_dist", "dist", "co2_kernel", "default_rbf"]
