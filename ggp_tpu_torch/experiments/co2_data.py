"""Mauna Loa CO2 data (counterpart of ``experiments/co2_data.py``).

Reads ``data/co2/mauna.txt`` of the checkout (decimal year, ppm) where it
exists; otherwise it makes the labelled synthetic stand-in with the same
structure (quadratic trend, seasonal cycle, short-term noise, monthly
1958-2015) from a seeded numpy generator, so its arrays equal the JAX
package's.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["load_co2_dataset", "MAUNA_PATH", "DEFAULT_SPLIT_YEAR"]

MAUNA_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "co2", "mauna.txt")
DEFAULT_SPLIT_YEAR = 2003


def _synthetic_mauna(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(1958.0, 2015.0, 1.0 / 12.0)
    dt = t - 1958.0
    ppm = (315.0 + 0.8 * dt + 0.0125 * dt ** 2
           + 2.8 * np.sin(2 * np.pi * t + 0.4)
           + 0.6 * np.sin(4 * np.pi * t + 1.3)
           + 0.25 * rng.normal(size=t.shape))
    return np.stack([t, ppm], axis=1)


def load_co2_dataset(year_split: int = DEFAULT_SPLIT_YEAR, normalize: bool = True):
    """(X_train (N, 1), y_train, X_test, y_test, y_mean, y_std, is_synthetic):
    X is the decimal year centred on the series mean (one unit is one year,
    so the seasonal period stays 1), y the ppm z-scored with ``normalize``;
    the rows before ``year_split`` train, the rest test the extrapolation."""
    if os.path.exists(MAUNA_PATH):
        raw = np.loadtxt(MAUNA_PATH)
        is_synthetic = False
    else:
        raw = _synthetic_mauna()
        is_synthetic = True
    t, ppm = raw[:, 0], raw[:, 1]
    keep = ppm > 0            # mauna.txt marks missing months with negative values
    t, ppm = t[keep], ppm[keep]
    if normalize:
        y_mean, y_std = float(ppm.mean()), float(ppm.std())
    else:
        y_mean, y_std = 0.0, 1.0
    y = (ppm - y_mean) / y_std
    x = t - t.mean()
    tr = t < year_split
    return x[tr, None], y[tr], x[~tr, None], y[~tr], y_mean, y_std, is_synthetic
