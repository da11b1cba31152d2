"""The JAX package's own run of chip_smoke.py's co2 path, on the CPU, in float64.

    JAX_PLATFORMS=cpu python3 co2_reference.py

The Mauna Loa CO2 experiment's fixed-Z protocol
(``experiments/co2_bayesian_sgpr_hmc.py``) at full width (N=541, M=480,
the 11-hyper composite, LogNormal(0, 3) priors, jitter 1e-4, the 1500-step
warm start) with the transitions chip_smoke's ``CO2_PROTOCOL["co2"]``
cuts it to, through the JAX package's ``BayesianSparseGPR_HMC`` and its
chunked sampler. On the CPU the JAX package samples with its XLA potential
(autodiff of the collapsed bound), the same posterior as its fused co2
kernel. The warm start is deterministic and runs once; NUTS runs from it
with eight keys, in four processes on a quarter of the CPUs each. Prints
the warm start's final loss and -ELBO at its end, each seed's
extrapolation RMSE (ppm), mixture NLPD and per-lane posterior means, and
then the JSON that chip_smoke.py's ``CO2_REF`` holds: the warm start's
final loss and -ELBO at its end and, over the seeds, the mean of each
metric and its standard deviation (``*_sd``).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "experiments"))

from chip_smoke import CO2_PROTOCOL  # noqa: E402
from co2_baseline import init_co2_params  # noqa: E402
from co2_bayesian_sgpr_hmc import co2_prior_tree  # noqa: E402
from co2_data import load_co2_dataset  # noqa: E402
from ggp_tpu.kernels import co2_kernel  # noqa: E402
from ggp_tpu.models import BayesianSparseGPR_HMC  # noqa: E402
from ggp_tpu.ops.fused_bound import co2_fused_spec, make_co2_vfe_potential  # noqa: E402
from ggp_tpu.priors import log_prior  # noqa: E402
from ggp_tpu.utils.metrics import nlpd_mixture, rmse  # noqa: E402


def _data():
    Xtr, ytr, Xte, yte, _, y_std, _ = load_co2_dataset(2003)
    return (*(jnp.asarray(a, jnp.float64) for a in (Xtr, ytr, Xte, yte)), y_std)


def _model(X, y, M=480):
    kern = co2_kernel("matern32")
    return BayesianSparseGPR_HMC(X, y, Z_init=X[::max(1, X.shape[0] // M)][:M],
                                 kernel=kern, prior_tree=co2_prior_tree(kern), jitter=1e-4)


def warm(M=480):
    """The seeded hypers and the protocol's warm start: (hypers, Z, final
    loss, -ELBO at its end: the co2 target's potential there, through
    ``make_co2_vfe_potential``, less its log prior)."""
    X, y, *_ = _data()
    model = _model(X, y, M)
    kern = model.kernel
    seeded = init_co2_params(type("S", (), {"params": {
        "kernel": kern.init_params(1), "log_noise": jnp.zeros(())}})())
    model.hypers = {"kernel": seeded["kernel"], "log_noise": seeded["log_noise"]}
    losses = model.warm_start(num_steps=CO2_PROTOCOL["co2"]["warm"], lr=0.01)
    noise_comp, spec = co2_fused_spec(kern, model.likelihood, model.prior_tree)
    U, _ = make_co2_vfe_potential(X, y, 1e-4, noise_comp=noise_comp, prior_spec=spec)(
        ravel_pytree(model.hypers)[0], model.Z)
    return model.hypers, model.Z, float(losses[-1]), float(U + log_prior(model.prior_tree,
                                                                         model.hypers))


def _pin(cpu_sets):
    os.sched_setaffinity(0, cpu_sets.get())


def run_seed(seed, hypers, Z, M=480):
    """One NUTS run from the warm state with PRNGKey(seed)."""
    proto = CO2_PROTOCOL["co2"]
    t0 = time.time()
    X, y, Xt, yt, y_std = _data()
    model = _model(X, y, M)
    model.hypers, model.Z = jax.tree_util.tree_map(jnp.asarray, hypers), jnp.asarray(Z)
    model.train_fixed_model(num_warmup=proto["tune"], num_samples=proto["n_samples"],
                            key=jax.random.PRNGKey(seed), chunk_size=proto["chunk_size"])
    means, vars_ = model.mixture_posterior_predictive(Xt)
    flat = jax.vmap(lambda t: ravel_pytree(t)[0])(model.trace)
    run = {"rmse": float(rmse(jnp.mean(means, 0), yt, y_std)),
           "nlpd": float(nlpd_mixture(means, vars_, yt, y_std)),
           "lane_means": np.asarray(flat.mean(0)).tolist(),
           "accept": float(model.stats["accept_prob"].mean()),
           "diverging": float(model.stats["diverging"].mean())}
    print(f"seed {seed} (JAX package, CPU, float64): {time.time() - t0:.1f} s; "
          f"{json.dumps(run)}", flush=True)
    return run


def main(seeds=range(8), workers=4):
    t0 = time.time()
    hypers, Z, warm_loss, warm_neg_elbo = warm()
    hypers = jax.tree_util.tree_map(np.asarray, hypers)
    print(f"warm start (JAX package, CPU, float64): {time.time() - t0:.1f} s, final loss "
          f"{warm_loss!r}, -ELBO at its end {warm_neg_elbo!r}", flush=True)
    cpus = sorted(os.sched_getaffinity(0))
    per = max(1, len(cpus) // workers)
    ctx = mp.get_context("spawn")
    cpu_sets = ctx.Queue()
    for i in range(workers):
        cpu_sets.put(cpus[i * per:(i + 1) * per] or cpus)
    with ctx.Pool(workers, initializer=_pin, initargs=(cpu_sets,)) as pool:
        runs = pool.starmap(run_seed, [(s, hypers, np.asarray(Z)) for s in seeds])
    ref = {"warm_loss": warm_loss, "warm_neg_elbo": warm_neg_elbo, "seeds": len(runs)}
    for k in ("rmse", "nlpd", "lane_means"):
        v = np.array([r[k] for r in runs])
        mean, sd = v.mean(0), v.std(0, ddof=1)
        ref[k] = np.round(mean, 6).tolist()
        ref[k.replace("_means", "") + "_sd"] = np.round(sd, 6).tolist()
    print(json.dumps(ref))


if __name__ == "__main__":
    main()
