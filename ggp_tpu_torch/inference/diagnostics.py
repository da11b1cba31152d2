"""Sampler diagnostics in numpy: effective sample size and split-R-hat
(copied from ``ggp_tpu/inference/diagnostics.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["effective_sample_size", "split_rhat"]


def _autocov_fft(x: np.ndarray) -> np.ndarray:
    """Autocovariance per chain via FFT. x: (chains, draws)."""
    n = x.shape[1]
    xc = x - x.mean(axis=1, keepdims=True)
    m = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), m, axis=1)[:, :n].real
    return acov / n


def effective_sample_size(x: np.ndarray) -> float:
    """Stan-style bulk ESS with Geyer's initial monotone positive sequence.
    x: (chains, draws) scalar chain values."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    c, n = x.shape
    if n < 4:
        return float(c * n)
    acov = _autocov_fft(x)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return float(c * n)
    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0
    max_pairs = (n - 1) // 2
    prev = np.inf
    s = 0.0
    for k in range(max_pairs):
        pair = rho[2 * k] + rho[2 * k + 1]
        if pair < 0:
            break
        pair = min(pair, prev)
        prev = pair
        s += pair
    tau = max(2.0 * s - 1.0, 1.0 / n)
    return float(c * n / tau)


def split_rhat(x: np.ndarray) -> float:
    """Split-R-hat (Gelman). x: (chains, draws)."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    c, n = x.shape
    half = n // 2
    if half < 2:
        return float("nan")
    halves = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    hn = halves.shape[1]
    W = halves.var(axis=1, ddof=1).mean()
    B = hn * halves.mean(axis=1).var(ddof=1)
    if W <= 0:
        return float("nan")
    return float(np.sqrt(((hn - 1.0) / hn * W + B / hn) / W))
