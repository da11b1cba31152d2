"""Mauna Loa CO2 with the composite kernel and NUTS over all 11 hypers
(counterpart of ``experiments/co2_bayesian_sgpr_hmc.py``).

``BayesianSparseGPR_HMC`` with ``co2_kernel("matern32")``, LogNormal(0, 3)
on every log-hyper, jitter 1e-4 and M inducing points (every
max(1, N // M)-th training row); the hypers seeded as the ML-II baseline
seeds them, then the autograd warm start of (hypers, Z). With ``fixed_z``
(the default) one NUTS run at fixed Z through the chunked driver
(``train_fixed_model(chunk_size=...)``: the co2 potential kernel for the
initial state and the step-size search, one transition kernel launch per
transition); otherwise the alternating trainer (``train_model``: the co2
NUTS chunk kernel in the rounds, autograd Adam on Z between them). Then the
mixture predictive on the years after ``year_split``, its extrapolation
RMSE (ppm) and mixture NLPD.

    python -m ggp_tpu_torch.experiments.co2_bayesian_sgpr_hmc [--alternating]
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from ..config import resolve_device
from ..kernels import co2_kernel
from ..models import BayesianSparseGPR_HMC
from ..priors import LogNormal
from ..utils.metrics import nlpd_mixture, rmse
from ..utils.tree import tree_map
from .co2_data import load_co2_dataset

__all__ = ["main", "co2_model", "co2_prior_tree", "extrapolation", "init_co2_params"]


def co2_prior_tree(kernel, input_dim=1, sigma=3.0):
    """LogNormal(0, sigma) on every kernel log-parameter and the noise."""
    kp = kernel.init_params(input_dim, dtype=torch.float64, device="cpu")
    return {"kernel": tree_map(lambda _: LogNormal(0.0, sigma), kp),
            "log_noise": LogNormal(0.0, sigma)}


def init_co2_params(*, dtype=torch.float64, device="cpu"):
    """Starting hypers of the CO2 decomposition (``experiments/co2_baseline.py``
    ``init_co2_params``): seasonal scale 1, periodic lengthscale 1.3, decay
    90 years; trend scale 4, lengthscale 40; medium-term RQ scale 0.5,
    lengthscale 1.2, alpha 0.8; short-scale component scale 0.05,
    lengthscale 0.15; noise 0.01."""
    def lg(v):
        return torch.tensor(math.log(v), dtype=dtype, device=device)

    terms = ({"log_outputscale": lg(1.0),
              "base": {"terms": ({"log_lengthscale": lg(1.3)}, {"log_lengthscale": lg(90.0)})}},
             {"log_outputscale": lg(4.0), "base": {"log_lengthscale": lg(40.0)}},
             {"log_outputscale": lg(0.5),
              "base": {"log_lengthscale": lg(1.2), "log_alpha": lg(0.8)}},
             {"log_outputscale": lg(0.05), "base": {"log_lengthscale": lg(0.15)}})
    return {"kernel": {"terms": terms}, "log_noise": lg(0.01)}


def co2_model(X, y, M=480):
    """The experiment's model on the training rows: the composite kernel,
    LogNormal(0, 3) priors, jitter 1e-4, Z every max(1, N // M)-th row of X,
    and the hypers seeded by :func:`init_co2_params`."""
    kern = co2_kernel("matern32")
    kw = dict(dtype=X.dtype, device=X.device)
    model = BayesianSparseGPR_HMC(X, y, Z_init=X[::max(1, X.shape[0] // M)][:M], kernel=kern,
                                  prior_tree=co2_prior_tree(kern), jitter=1e-4, **kw)
    model.hypers = init_co2_params(**kw)
    return model


def extrapolation(model, Xt, yt, y_std):
    """The mixture predictive on the test years: (means, vars, RMSE in ppm,
    mixture NLPD)."""
    means, vars_ = model.mixture_posterior_predictive(Xt)
    return (means, vars_, float(rmse(means.mean(0), yt, y_std)),
            float(nlpd_mixture(means, vars_, yt, y_std)))


def main(M=480, max_iters=2000, tune=500, n_samples=100, year_split=2003, fixed_z=True,
         dtype=torch.float32, device=None):
    """The JAX experiment's protocol; returns a dict of its results and
    times (seconds on the host clock after a device synchronisation)."""
    device = resolve_device("co2_bayesian_sgpr_hmc", device)
    kw = dict(dtype=dtype, device=device)
    Xtr, ytr, Xte, yte, y_mean, y_std, synth = load_co2_dataset(year_split)
    if synth:
        print("NOTE: mauna.txt not found - using synthetic CO2 stand-in")
    X, y = torch.tensor(Xtr, **kw), torch.tensor(ytr, **kw)
    Xt, yt = torch.tensor(Xte, **kw), torch.tensor(yte, **kw)

    def sync():
        if X.device.type == "cuda":
            torch.cuda.synchronize()

    model = co2_model(X, y, M)
    gen = torch.Generator(device=device).manual_seed(0)
    sync()
    t0 = time.perf_counter()
    warm = model.warm_start(num_steps=1500, lr=0.01)
    sync()
    t1 = time.perf_counter()
    if fixed_z:
        model.train_fixed_model(num_warmup=tune, num_samples=n_samples, generator=gen,
                                chunk_size=100)
    else:
        model.train_model(max_steps=max_iters, hmc_scheduler=[max_iters // 2, max_iters],
                          generator=gen)
    sync()
    t2 = time.perf_counter()
    st = model.stats
    leaps = int(st["n_leapfrog"].sum()) + int(st["warmup_n_leapfrog"].sum())
    print(f"warm start {t1 - t0:.3f} s, sampling {t2 - t1:.3f} s ({leaps} leapfrogs in the "
          f"last run), mean accept {float(st['accept_prob'].float().mean()):.3f}, "
          f"divergence fraction {float(st['diverging'].float().mean()):.3f}")
    means, vars_, r, nl = extrapolation(model, Xt, yt, y_std)
    print(f"extrapolation rmse={r:.3f} ppm  mixture nlpd={nl:.3f}  "
          f"({means.shape[0]} components)")
    return {"model": model, "warm_losses": warm, "warm_seconds": t1 - t0,
            "sample_seconds": t2 - t1, "rmse": r, "nlpd": nl, "means": means,
            "vars": vars_, "n_train": X.shape[0], "n_test": Xt.shape[0]}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--M", type=int, default=480)
    p.add_argument("--tune", type=int, default=500)
    p.add_argument("--n_samples", type=int, default=100)
    p.add_argument("--year_split", type=int, default=2003)
    p.add_argument("--alternating", action="store_true")
    p.add_argument("--float64", action="store_true", help="default: float32, as the JAX run")
    p.add_argument("--device", default=None, help="default: the card")
    a = p.parse_args()
    main(M=a.M, tune=a.tune, n_samples=a.n_samples, year_split=a.year_split,
         fixed_z=not a.alternating, dtype=torch.float64 if a.float64 else torch.float32,
         device=a.device)
