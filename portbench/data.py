"""The cells' data, made on the host in numpy from the configuration's seeds.

Copies of the repository's generators, so that the benchmark reads nothing
of the program to make its inputs:

* ``bench_cosines``: bench.py ``_make_data`` as chip_smoke.py's ``make_data``
  rewrites it in numpy (boston-shaped: 506 rows of 13 inputs, the first 80 %
  kept for training, y a sum of eight random cosines plus noise);
* ``synthetic_regression``: ``ggp_tpu_torch/utils/datasets.py``
  ``_SyntheticRegression`` with the ``Dataset`` split (Elevator-shaped as
  ``SyntheticLarge``: 16,599 rows of 18 inputs), and the regression driver's
  Z_init draw (``experiments/regression.py`` ``run_data``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["normalize", "bench_cosines", "synthetic_regression", "z_rows", "make_inputs"]


def normalize(A: np.ndarray):
    """Z-score by column; returns (normalized, mean, std)."""
    mean = A.mean(axis=0, keepdims=True)
    std = A.std(axis=0, keepdims=True) + 1e-6
    return (A - mean) / std, mean, std


def bench_cosines(N: int, D: int, seed: int, prop: float = 0.8, M: int = 100):
    """(X, y, Z) float64 of bench.py's synthetic draw: the training rows
    rounded to float32 as bench.py stores them, and Z the M training rows that
    the same generator draws next."""
    rng = np.random.default_rng(seed)
    X_raw = rng.normal(size=(N, D))
    w = rng.normal(size=(D, 8)) / np.sqrt(D)
    f = np.cos(X_raw @ w + rng.uniform(0, 2 * np.pi, 8)).sum(1)
    y_raw = f + 0.3 * rng.normal(size=N)
    Xn, _, _ = normalize(X_raw)
    yn, _, _ = normalize(y_raw[:, None])
    n_train = int(prop * N)
    X = Xn[:n_train].astype(np.float32).astype(np.float64)
    y = yn[:n_train, 0].astype(np.float32).astype(np.float64)
    Z = X[rng.integers(0, n_train, M)]
    return X, y, Z


def synthetic_regression(N: int, D: int, seed: int, split_seed: int, noise: float = 0.1,
                         prop: float = 0.8):
    """(X_train, y_train) float64 of ``_SyntheticRegression`` drawn with
    ``RandomState(seed)``, z-scored and split by ``RandomState(split_seed)``."""
    rng = np.random.RandomState(seed)
    X_raw = rng.uniform(-3, 3, size=(N, D))
    w = rng.normal(size=(D, 8))
    phase = rng.uniform(0, 2 * np.pi, size=8)
    f = np.cos(X_raw @ w + phase).sum(axis=1)
    y_raw = f + noise * rng.normal(size=N)
    X, _, _ = normalize(np.asarray(X_raw, np.float64))
    Yn, _, _ = normalize(np.asarray(y_raw, np.float64).reshape(-1)[:, None])
    perm = np.random.RandomState(split_seed).permutation(N)
    tr = perm[:int(N * prop)]
    return X[tr], Yn[:, 0][tr]


def z_rows(X: np.ndarray, M: int, seed: int) -> np.ndarray:
    """M training rows drawn with replacement by ``RandomState(seed).randint``
    (the regression driver's Z_init)."""
    n = X.shape[0]
    return X[np.random.RandomState(seed).randint(0, n, min(M, n))]


def make_inputs(cfg: dict):
    """(X, y, Z_init) float64 of configuration ``cfg``: its data set (drawn
    with ``data_seed``) and Z_init (drawn with ``z_seed``)."""
    data = cfg["data"]
    N, D, M = cfg["N"], cfg["D"], cfg["M"]
    if data == "bench_cosines":
        X, y, _ = bench_cosines(N, D, cfg["data_seed"], cfg["prop"], M)
    elif data == "synthetic_regression":
        X, y = synthetic_regression(N, D, cfg["data_seed"], cfg["split_seed"],
                                    cfg["noise"], cfg["prop"])
    else:
        raise ValueError(f"unknown data generator {data!r}")
    return X, y, z_rows(X, M, cfg["z_seed"])
