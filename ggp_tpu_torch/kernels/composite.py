"""Prebuilt kernels (counterpart of ``ggp_tpu/kernels/composite.py``)."""

from __future__ import annotations

from .base import RBF, Kernel, Matern32, Periodic, RationalQuadratic, Scale, Sum


def co2_kernel(noise_component: str = "rbf") -> Kernel:
    """The Mauna Loa CO2 composite: seasonal Scale(Periodic(period 1) x
    RBF), long-term trend Scale(RBF), medium-term Scale(RationalQuadratic)
    and a short-scale noise component, Scale(RBF) or, with
    ``noise_component="matern32"``, Scale(Matern32); all one-dimensional,
    summed."""
    seasonal = Scale(Periodic(fixed_period=1.0) * RBF(ard=False))
    trend = Scale(RBF(ard=False))
    medium = Scale(RationalQuadratic(ard=False))
    if noise_component == "matern32":
        noise = Scale(Matern32(ard=False))
    else:
        noise = Scale(RBF(ard=False))
    return Sum((seasonal, trend, medium, noise))


def default_rbf(ard: bool = True) -> Kernel:
    """Scale(RBF(ard)), the default model kernel."""
    return Scale(RBF(ard=ard))
