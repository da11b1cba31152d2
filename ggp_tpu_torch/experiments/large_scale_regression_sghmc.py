"""Large-scale Bayesian sparse GP regression with SGHMC over the collapsed
bound (counterpart of ``experiments/large_scale_regression_sghmc.py``).

An ML-II warm start of (hypers, Z) by ``SparseGPR`` on a 4096-row
subsample, then C chains of SGHMC over the hypers (and Z with
``sample_z``) on minibatch VFE statistics scaled to the full data set
(``models.sgpr.vfe_stats``: kernels 10 and 11 on the card, every chain's
minibatch gathered in the kernel), with the SVRG anchor gradient under
``control_variate``; then the 30-component mixture predictive on the test
split, its RMSE and mixture NLPD.

    python -m ggp_tpu_torch.experiments.large_scale_regression_sghmc \\
        --n_rows 1000000 --control_variate --step_size 2e-5 --final_step_size 1e-5
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import resolve_device
from ..inference.sghmc import SGHMCConfig, ravel_tree, run_sghmc
from ..kernels import default_rbf
from ..models.sgpr import SparseGPR, sgpr_elbo_from_stats, sgpr_predict, vfe_stats
from ..priors import Normal, log_prior, prior_tree_rbf
from ..utils.datasets import get_regression_data
from ..utils.metrics import nlpd_mixture, rmse
from ..utils.tree import tree_map

__all__ = ["main", "tiled_data"]


def tiled_data(dataset="synthetic-large", split=0, n_rows=None):
    """(data, X, y) float64 numpy; X and y tiled up to ``n_rows`` rows."""
    data = get_regression_data(dataset, split=split)
    X, y = data.X_train, data.Y_train
    if n_rows is not None and n_rows > X.shape[0]:
        reps = -(-n_rows // X.shape[0])
        X = np.tile(X, (reps, 1))[:n_rows]
        y = np.tile(y, reps)[:n_rows]
    return data, X, y


def main(dataset="synthetic-large", split=0, M=100, warm_iters=1000, num_steps=3000,
         batch_size=2048, step_size=2e-4, final_step_size=None, sample_z=False,
         num_chains=2, n_rows=None, control_variate=False, device=None, seed=0):
    """The JAX experiment's protocol; returns a dict of its results and times."""
    device = resolve_device("large_scale_regression_sghmc", device)
    f32 = dict(dtype=torch.float32, device=device)
    data, Xn, yn = tiled_data(dataset, split, n_rows)
    X, y = torch.tensor(Xn, **f32), torch.tensor(yn, **f32)
    Xt, yt = torch.tensor(data.X_test, **f32), torch.tensor(data.Y_test, **f32)
    N, D = X.shape
    print(f"{dataset}: N={N} D={D} M={M}")

    rng = np.random.RandomState(45)
    Z_init = X[torch.as_tensor(rng.randint(0, N, M), device=device)]
    kern = default_rbf(ard=True)

    # ML-II warm start for hypers + Z on a subsample
    sub = torch.as_tensor(rng.randint(0, N, min(N, 4096)), device=device)
    t0 = time.perf_counter()
    warm = SparseGPR(X[sub], y[sub], Z_init=Z_init, device=device)
    warm_losses = warm.train_model(max_steps=warm_iters, lr=0.02, verbose=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    Z = warm.params["Z"]
    hypers = {"kernel": warm.params["kernel"], "log_noise": warm.params["log_noise"]}
    prior = prior_tree_rbf()
    if sample_z:
        prior = {**prior, "Z": Normal(0.0, 1.0)}
        init = {**hypers, "Z": Z}
    else:
        init = hypers

    def logpost(state, idx):
        Z_ = state["Z"] if sample_z else Z
        stats = vfe_stats(kern, state["kernel"], Z_, X, y, idx)
        scale = N / idx.shape[1]
        stats = {k: v * scale for k, v in stats.items()}
        ll = sgpr_elbo_from_stats(kern, {**state, "Z": Z_}, stats, N, 1e-5)
        return ll.sum() + log_prior(prior, state)

    def logpost_full(state):
        Z_ = state["Z"] if sample_z else Z
        stats = vfe_stats(kern, state["kernel"], Z_, X, y)
        ll = sgpr_elbo_from_stats(kern, {**state, "Z": Z_}, stats, N, 1e-5)
        return ll.sum() + log_prior(prior, state)

    cfg = SGHMCConfig(step_size=step_size, final_step_size=final_step_size or step_size / 2,
                      friction=0.05, num_steps=num_steps, batch_size=batch_size,
                      num_warmup=num_steps // 3, thin=10, control_variate=control_variate)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    samples, stats = run_sghmc(logpost, init, gen, N, cfg, num_chains=num_chains,
                               full_logpost_fn=logpost_full if control_variate else None)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    kept = stats["num_kept"] * num_chains
    print(f"SGHMC: {num_steps * num_chains} steps in {dt:.1f}s "
          f"({num_steps * num_chains / dt:.0f} steps/s), kept {kept}")
    finite = bool(torch.isfinite(ravel_tree(samples)[0]).all())
    if not finite:
        print(f"WARNING: non-finite SGHMC samples - the gradient scale grows "
              f"with N={N}; reduce --step_size (e.g. {2.0 / N:.1e})")

    # mixture predictive over a thinned sample set
    flat = tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), samples)
    S = flat["log_noise"].shape[0]
    k = max(1, S // 30)
    sub_tr = tree_map(lambda a: a[::k][:30], flat)
    means, vars_ = [], []
    for s in range(sub_tr["log_noise"].shape[0]):
        state = tree_map(lambda a: a[s], sub_tr)
        p = {"kernel": state["kernel"], "log_noise": state["log_noise"],
             "Z": state["Z"] if sample_z else Z}
        mu, var = sgpr_predict(kern, p, X[sub], y[sub], Xt, 1e-5, full_cov=False)
        means.append(mu)
        vars_.append(var)
    means, vars_ = torch.stack(means), torch.stack(vars_)
    r = float(rmse(means.mean(0), yt, data.Y_std))
    nl = float(nlpd_mixture(means, vars_, yt, data.Y_std))
    print(f"test rmse={r:.4f}  mixture nlpd={nl:.4f}")
    return {"N": N, "warm_seconds": t_warm, "warm_loss": float(warm_losses[-1]),
            "warm_params": warm.params, "sghmc_seconds": dt,
            "steps_per_s": num_steps * num_chains / dt, "finite": finite, "rmse": r,
            "nlpd": nl, "samples": samples, "stats": stats,
            "components": means.shape[0]}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--dataset", default="synthetic-large")
    p.add_argument("--M", type=int, default=100)
    p.add_argument("--num_steps", type=int, default=3000)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--step_size", type=float, default=2e-4)
    p.add_argument("--final_step_size", type=float, default=None)
    p.add_argument("--sample_z", action="store_true")
    p.add_argument("--num_chains", type=int, default=2)
    p.add_argument("--n_rows", type=int, default=None,
                   help="tile data up to this many rows (stress test)")
    p.add_argument("--control_variate", action="store_true",
                   help="SVRG anchor gradients (full-data gradient every "
                        "anchor_refresh_every steps)")
    p.add_argument("--device", default=None, help="default: the card")
    a = p.parse_args()
    main(dataset=a.dataset, M=a.M, num_steps=a.num_steps, batch_size=a.batch_size,
         step_size=a.step_size, final_step_size=a.final_step_size, sample_z=a.sample_z,
         num_chains=a.num_chains, n_rows=a.n_rows, control_variate=a.control_variate,
         device=a.device)
