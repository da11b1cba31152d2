"""Regression data sets with seeded splits (counterpart of
``ggp_tpu/utils/datasets.py``).

The split semantics are the JAX package's: X and y are z-scored over the
whole array, the rows are permuted by ``RandomState(BASE_SEED + split)``
and the first ``prop`` of them are the training rows. The synthetic data
sets are drawn from numpy generators seeded by the CRC-32 of their names,
so their arrays equal the JAX package's. The UCI data sets need files that
are not in the repository and that the port does not download, so their
names raise :class:`DataNotInRepository`.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..config import BASE_SEED

__all__ = ["normalize", "Dataset", "SyntheticSmall", "SyntheticMid", "SyntheticLarge",
           "regression_datasets", "get_regression_data", "DataNotInRepository", "UCI_REGRESSION"]

# the JAX package's UCI regression data sets (ggp_tpu/utils/datasets.py)
UCI_REGRESSION = ("boston", "concrete", "energy", "kin8nm", "naval", "power", "protein",
                  "winered", "winewhite", "yacht")


class DataNotInRepository(NotImplementedError, ValueError):
    """A data set of the JAX package whose files the repository does not hold
    (ROADMAP queue 1 item 14: the file readers)."""


def normalize(A: np.ndarray):
    """Z-score by column; returns (normalized, mean, std)."""
    mean = A.mean(axis=0, keepdims=True)
    std = A.std(axis=0, keepdims=True) + 1e-6
    return (A - mean) / std, mean, std


class Dataset:
    """Base: subclasses define ``name`` and ``read_data() -> (X, Y)`` raw
    arrays; ``__init__(split, prop)`` normalises and splits them."""

    name: str = ""
    normalize_x = True
    normalize_y = True

    def __init__(self, split: int = 0, prop: float = 0.8):
        self.split = split
        self.prop = prop
        X_raw, Y_raw = self.read_data()
        X_raw = np.asarray(X_raw, np.float64)
        Y_raw = np.asarray(Y_raw, np.float64).reshape(-1)
        self.N, self.D = X_raw.shape
        if self.normalize_x:
            X, self.X_mean, self.X_std = normalize(X_raw)
        else:
            X, self.X_mean, self.X_std = X_raw, np.zeros((1, self.D)), np.ones((1, self.D))
        if self.normalize_y:
            Yn, Ym, Ys = normalize(Y_raw[:, None])
            self.Y_mean, self.Y_std = float(Ym.item()), float(Ys.item())
            Y = Yn[:, 0]
        else:
            Y, self.Y_mean, self.Y_std = Y_raw, 0.0, 1.0
        perm = np.random.RandomState(BASE_SEED + split).permutation(self.N)
        n_train = int(self.N * prop)
        tr, te = perm[:n_train], perm[n_train:]
        self.X_train, self.Y_train = X[tr], Y[tr]
        self.X_test, self.Y_test = X[te], Y[te]

    def read_data(self):
        raise NotImplementedError


class _SyntheticRegression(Dataset):
    """A sum of eight random cosines of the inputs plus noise, with a
    UCI-like shape; deterministic per name."""

    n_rows = 500
    n_dims = 4
    noise = 0.1

    def read_data(self):
        rng = np.random.RandomState(zlib.crc32(self.name.encode()) % (2 ** 31))
        X = rng.uniform(-3, 3, size=(self.n_rows, self.n_dims))
        w = rng.normal(size=(self.n_dims, 8))
        phase = rng.uniform(0, 2 * np.pi, size=8)
        f = np.cos(X @ w + phase).sum(axis=1)
        return X, f + self.noise * rng.normal(size=self.n_rows)


class SyntheticSmall(_SyntheticRegression):
    name = "synthetic-small"
    n_rows = 400
    n_dims = 13          # Boston-like


class SyntheticMid(_SyntheticRegression):
    name = "synthetic-mid"
    n_rows = 1030
    n_dims = 8           # Concrete-like


class SyntheticLarge(_SyntheticRegression):
    name = "synthetic-large"
    n_rows = 16599
    n_dims = 18          # Elevator-like


regression_datasets = {c.name: c for c in (SyntheticSmall, SyntheticMid, SyntheticLarge)}


def get_regression_data(name: str, split: int = 0, prop: float = 0.8) -> Dataset:
    """The named synthetic data set, split ``split``."""
    if name in UCI_REGRESSION:
        raise DataNotInRepository(f"{name!r} needs files that are not in the repository; the "
                                  "port's file readers are ROADMAP queue 1 item 14")
    if name not in regression_datasets:
        raise ValueError(f"{name!r} is not a synthetic data set of the port "
                         f"({', '.join(regression_datasets)}); the UCI data sets need "
                         "files that are not in the repository")
    return regression_datasets[name](split=split, prop=prop)
