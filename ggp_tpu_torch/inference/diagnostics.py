"""Sampler diagnostics in numpy: effective sample size, split-R-hat and the
per-parameter summary table (copied from ``ggp_tpu/inference/diagnostics.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["effective_sample_size", "split_rhat", "summary", "trace_to_named_dict",
           "summary_to_csv"]


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


def summary(samples_dict: dict, stats: dict | None = None) -> dict:
    """Per-parameter mean, sd, ESS and split-R-hat of ``{name: (chains,
    draws, ...) array}`` (a 1-D array is one chain); a name with several
    entries gets one row per entry, ``name[(i, ...)]``. With ``stats``, the
    number of divergent transitions as ``_diverging``."""
    out = {}
    for name, arr in samples_dict.items():
        a = np.asarray(arr)
        if a.ndim == 1:
            a = a[None, :]
        flatdims = a.shape[2:]
        a2 = a.reshape(a.shape[0], a.shape[1], -1)
        for j in range(a2.shape[-1]):
            key = name if a2.shape[-1] == 1 else f"{name}[{np.unravel_index(j, flatdims)}]"
            x = a2[..., j]
            out[key] = {"mean": float(x.mean()), "sd": float(x.std()),
                        "ess": effective_sample_size(x), "rhat": split_rhat(x)}
    if stats is not None and "diverging" in stats:
        out["_diverging"] = int(np.asarray(stats["diverging"]).sum())
    return out


def trace_to_named_dict(trace) -> dict:
    """``{dotted.path: array}`` of the leaves of a trace tree (nested dicts,
    tuples and lists whose leaves lead with the draw axis), in the JAX
    package's leaf order (dict keys sorted) and path names."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[".".join(path) or "param"] = np.asarray(
                node.detach().cpu() if hasattr(node, "detach") else node)

    walk(trace, ())
    return out


def summary_to_csv(summ: dict, path: str) -> str:
    """Write a :func:`summary` table as CSV (param, mean, sd, ess, rhat);
    ``_diverging`` goes in a row of its own."""
    with open(path, "w") as f:
        f.write("param,mean,sd,ess,rhat\n")
        for name, row in summ.items():
            if name == "_diverging":
                f.write(f"_diverging,{row},,,\n")
                continue
            f.write(f"\"{name}\",{row['mean']:.6g},{row['sd']:.6g},"
                    f"{row['ess']:.6g},{row['rhat']:.6g}\n")
    return path
