"""The regression benchmark driver (counterpart of ``experiments/regression.py``).

Trains one model family over data sets x splits, computes the test RMSE and
NLPD (the mixture NLPD for the Bayesian models) in the data's units, and
logs one JSON of metrics per run (``utils.experiment_tools``), with the
sampler's summary table (mean, sd, ESS, split-R-hat per hyper) for the
sampled models and its CSV beside it.

The data, the inducing rows (``RandomState(seed).randint``, with
replacement) and the protocols are the JAX driver's; a ``torch.Generator``
seeded with ``seed + split`` takes the place of its PRNG key. Models run on
the card unless ``device="cpu"``.

    python -m ggp_tpu_torch.experiments.regression -m BayesianSGPR_HMC \\
        -d synthetic-large --n_splits 1
    python -m ggp_tpu_torch.experiments.regression -m SGPR -d synthetic-small \\
        --device cpu --max_iters 100
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import resolve_device
from ..inference.diagnostics import summary, summary_to_csv, trace_to_named_dict
from ..models import (GPR_HMC, BayesianSparseGPR_HMC, BayesianStochasticVariationalGP,
                      SparseGPR, StochasticVariationalGP, train_sgp_hmc)
from ..models.bayesian_sgpr_hmc import theta_to_hypers
from ..utils.datasets import get_regression_data
from ..utils.experiment_tools import dump_experiment_json, experiment_name
from ..utils.metrics import nlpd, nlpd_mixture, rmse

__all__ = ["single_run", "run_data", "main", "DATASETS", "MODELS"]

DATASETS = ["boston", "concrete", "energy", "winered", "yacht"]
MODELS = ["SGPR", "SVGP", "BayesianSVGP", "BayesianSGPR_HMC",
          "BayesianSGPR_HMC_FixedZ", "GPR_HMC", "AllInHMC", "JointHMC"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_data(dataset_name, split=0, prop=0.8, M=100, seed=45):
    """(data set split, Z_init): the split's training rows drawn M times with
    replacement by ``RandomState(seed).randint``, as the JAX driver does."""
    data = get_regression_data(dataset_name, split=split, prop=prop)
    n = data.X_train.shape[0]
    return data, data.X_train[np.random.RandomState(seed).randint(0, n, min(M, n))]


def single_run(dataset_name: str, split: int, model_name: str, M: int = 100,
               max_iters: int = 2000, num_epochs: int = 200, batch_size: int = 200,
               tune: int = 500, num_samples: int = 100, num_chains: int = 2,
               prop: float = 0.8, seed: int = 45, save_losses: bool = False,
               verbose: bool = True, dtype=torch.float32, device=None) -> dict:
    """Train and evaluate one (data set, split, model) cell; returns its
    metrics (also written to the run's JSON log)."""
    if model_name == "AllInHMC":
        raise NotImplementedError("AllInHMC needs the generic sampler and models/all_in_hmc.py "
                                  "(ROADMAP queue 1 item 12)")
    if model_name not in MODELS:
        raise ValueError(f"unknown model {model_name}")
    device = resolve_device("regression.single_run", device)
    data, Z_init = run_data(dataset_name, split, prop, M, seed)
    X, y, Xt = data.X_train, data.Y_train, data.X_test
    yt = torch.as_tensor(data.Y_test, dtype=dtype, device=device)
    y_std = data.Y_std
    gen = torch.Generator(device=device).manual_seed(seed + split)
    kw = dict(dtype=dtype, device=device)

    t0 = time.perf_counter()
    sampling_seconds = 0.0
    mixture = losses = model = None
    if model_name == "SGPR":
        model = SparseGPR(X, y, Z_init=Z_init, **kw)
        losses = model.train_model(max_steps=max_iters, verbose=False)
        mean, var = model.posterior_predictive(Xt, full_cov=False)
    elif model_name == "SVGP":
        model = StochasticVariationalGP(X, y, Z_init=Z_init, **kw)
        losses = model.train_model(num_epochs=num_epochs, batch_size=batch_size, generator=gen)
        mean, var = model.posterior_predictive(Xt)
    elif model_name == "BayesianSVGP":
        model = BayesianStochasticVariationalGP(X, y, Z_init=Z_init, prior_var=1.0, **kw)
        model.train_model(num_epochs=num_epochs, batch_size=batch_size, generator=gen)
        mixture = model.mixture_posterior_predictive(Xt, num_samples=100, generator=gen)
    else:
        ts = time.perf_counter()
        if model_name.startswith("BayesianSGPR_HMC"):
            model = BayesianSparseGPR_HMC(X, y, Z_init=Z_init, **kw)
            if model_name.endswith("FixedZ"):
                model.train_fixed_model(num_warmup=tune, num_samples=num_samples,
                                        num_chains=num_chains, generator=gen)
            else:
                sched = [max_iters // 4, max_iters // 2, 3 * max_iters // 4]
                model.train_model(max_steps=max_iters, hmc_scheduler=sched,
                                  num_chains=num_chains, generator=gen)
        elif model_name == "GPR_HMC":
            model = GPR_HMC(X, y, **kw)
            model.train_model(num_warmup=tune, num_samples=num_samples,
                              num_chains=num_chains, generator=gen)
        else:                                                   # JointHMC
            model = train_sgp_hmc((X, y), Z_init=Z_init, num_warmup=tune,
                                  num_samples=num_samples, generator=gen, **kw)
        _sync(device)
        sampling_seconds = time.perf_counter() - ts
        if model_name == "GPR_HMC":
            mixture = model.full_mixture_posterior_predictive(Xt)
        elif model_name == "JointHMC":
            mixture = model.mixture_posterior_predictive_y(Xt, num_components=50)
        else:
            mixture = model.mixture_posterior_predictive(Xt)
    _sync(device)
    wall_clock = time.perf_counter() - t0

    # the sampler's summary table: hypers in the JSON, every leaf in the CSV
    trace_summary = full_summary = None
    if getattr(model, "trace", None) is not None:
        tree = (model.trace_tree if model_name == "JointHMC"
                else theta_to_hypers(model.trace))
        # a singleton chain axis: the trace pools the chains
        named = {k: v[None] for k, v in trace_to_named_dict(tree).items()}
        stats = {k: np.asarray(v.detach().cpu()) for k, v in model.stats.items()}
        small = {k: v for k, v in named.items() if int(np.prod(v.shape[2:]) or 1) <= 64}
        trace_summary = summary(small, stats)
        full_summary = (trace_summary if small.keys() == named.keys()
                        else summary(named, stats))

    if mixture is not None:
        means, vars_ = mixture
        test_rmse = float(rmse(means.mean(0), yt, y_std))
        test_nlpd = float(nlpd_mixture(means, vars_, yt, y_std))
    else:
        test_rmse = float(rmse(mean, yt, y_std))
        test_nlpd = float(nlpd(mean, var, yt, y_std))

    metrics = {"dataset": dataset_name, "split": split, "model": model_name,
               "M": int(Z_init.shape[0]), "test_rmse": test_rmse, "test_nlpd": test_nlpd,
               "wall_clock_s": wall_clock, "sampling_s": sampling_seconds}
    if trace_summary is not None:
        metrics["trace_summary"] = trace_summary
    name = experiment_name(model_name, dataset_name, split, M=M, seed=seed)
    path = dump_experiment_json(name, metrics)
    if full_summary is not None:
        summary_to_csv(full_summary, os.path.join(os.path.dirname(path), f"{name}_trace.csv"))
    if save_losses and losses is not None:
        np.savetxt(os.path.join(os.path.dirname(path), f"{name}_losses.csv"),
                   losses.detach().cpu().numpy(), delimiter=",")
    if verbose:
        print(f"[{model_name}|{dataset_name}|split {split}] rmse={test_rmse:.4f} "
              f"nlpd={test_nlpd:.4f} wall={wall_clock:.1f}s sampling={sampling_seconds:.1f}s "
              f"-> {path}")
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model", default="SGPR", choices=MODELS)
    p.add_argument("-d", "--datasets", nargs="+", default=DATASETS)
    p.add_argument("--n_splits", type=int, default=10)
    p.add_argument("--M", type=int, default=100)
    p.add_argument("--max_iters", type=int, default=2000)
    p.add_argument("--num_epochs", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=200)
    p.add_argument("--tune", type=int, default=500)
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--num_chains", type=int, default=2)
    p.add_argument("--prop", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=45)
    p.add_argument("--float64", action="store_true")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    results = []
    for ds in args.datasets:
        for split in range(args.n_splits):
            results.append(single_run(
                ds, split, args.model, M=args.M, max_iters=args.max_iters,
                num_epochs=args.num_epochs, batch_size=args.batch_size, tune=args.tune,
                num_samples=args.num_samples, num_chains=args.num_chains, prop=args.prop,
                seed=args.seed, dtype=torch.float64 if args.float64 else torch.float32,
                device=args.device))
    for ds in args.datasets:
        r = [x for x in results if x["dataset"] == ds]
        nl = np.array([x["test_nlpd"] for x in r])
        rm = np.array([x["test_rmse"] for x in r])
        print(f"{ds}: NLPD {nl.mean():.3f}±{nl.std() / max(np.sqrt(len(nl)), 1):.3f} "
              f"RMSE {rm.mean():.3f}±{rm.std() / max(np.sqrt(len(rm)), 1):.3f}")
    return results


if __name__ == "__main__":
    main()
