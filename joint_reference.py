"""The JAX package's own run of chip_smoke.py's joint-large path, on the CPU, in float64.

    JAX_PLATFORMS=cpu python3 joint_reference.py

The regression driver's JointHMC protocol (``experiments/regression.py``
``single_run("synthetic-large", 0, "JointHMC")``: 13,279 train rows, D=18,
M=100 inducing rows drawn by ``RandomState(45).randint``, ``train_sgp_hmc``
with its 100-step warm start, one chain of NUTS, the 50-component
observation-space mixture predictive) through the JAX package's ``SGPMC``,
its sampler cut from the regression driver's 500 warmup + 100 draws to ``TUNE`` +
``DRAWS`` (chip_smoke.py's joint-large path reads the cut from the file
this script writes). On the CPU the JAX package runs its XLA paths: the
autodiff warm start (optax zero_nans, clip 10, Adam) and the XLA NUTS
sampler on the autodiff potential, the functions of its fused kernels.

It records what chip_smoke.py holds:

1. the warm start's final loss (deterministic; run once), and the state and
   Z it ends at;
2. from that state, for each of ``len(KEYS)`` PRNG keys (parallel
   processes): the test RMSE and mixture NLPD (data units), the mean of
   each of the d + 2 hyper lanes [log_lengthscale (d), log_outputscale,
   log_noise] over the draws, the mean accept, the divergence fraction and
   the mean leapfrogs a draw; and over the keys the means and standard
   deviations of the metrics and of the lane means. Eight keys: one run of
   the port is held within 4 of these SDs (a Student t of 7 degrees of
   freedom lands beyond 4 by chance 0.5 % of the time a lane; with three
   keys, 2 degrees of freedom, 5.7 % a lane, and across the 20 lanes most
   runs). The lengthscale lanes are prior-dominated here (the fit is
   noise) and move ~1 log unit from the warm state over the cut, so their
   chain means spread ~0.1-0.3 from key to key.

Writes ``joint_reference.json`` beside this file and prints its scalars.
A key takes ~25 min on two cores (~0.18 s an evaluation of the potential),
four at a time on 8 cores: ~50 min in all; nothing else should run beside
it.
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

sys.path.insert(0, str(Path(__file__).resolve().parent))

from ggp_tpu.models import SGPMC  # noqa: E402
from ggp_tpu.utils.datasets import get_regression_data  # noqa: E402
from ggp_tpu.utils.metrics import nlpd_mixture, rmse  # noqa: E402

OUT = Path(__file__).resolve().parent / "joint_reference.json"
DATASET, SPLIT, M, SEED = "synthetic-large", 0, 100, 45
WARM_STEPS, COMPONENTS = 100, 50
KEYS = tuple(SEED + SPLIT + 1000 * k for k in range(8))
# The sampler's cut, from the regression driver's 500 warmup + 100 draws (joint-nuts'
# depth on bench.py's shape): why, in chip_smoke.py beside JOINT_REF_FILE.
TUNE, DRAWS = 50, 25


def _data():
    data = get_regression_data(DATASET, split=SPLIT, prop=0.8)
    Z_init = data.X_train[np.random.RandomState(SEED).randint(
        0, data.X_train.shape[0], min(M, data.X_train.shape[0]))]
    return data, Z_init


def _model(data, Z):
    return SGPMC(jnp.asarray(data.X_train), jnp.asarray(data.Y_train), Z_init=jnp.asarray(Z))


def warm():
    """``train_sgp_hmc``'s warm start: 100 Adam steps on (state, Z)."""
    data, Z_init = _data()
    model = _model(data, Z_init)
    t0 = time.time()
    losses = model.warm_start(num_steps=WARM_STEPS)
    flat, _ = ravel_pytree(model.state)
    print(f"warm start (JAX package, CPU, float64): {time.time() - t0:.1f} s, loss "
          f"{float(losses[0])!r} -> {float(losses[-1])!r}", flush=True)
    return {"warm_loss": float(losses[-1]), "warm_first_loss": float(losses[0]),
            "warm_state": np.asarray(flat).tolist(), "warm_Z": np.asarray(model.Z).tolist()}


def _pin(cpu_sets):
    os.sched_setaffinity(0, cpu_sets.get())


def run_key(seed, warm_state, warm_Z):
    """``train_model`` from the warm state with PRNGKey(seed), then the
    regression driver's predictive and metrics."""
    t0 = time.time()
    data, _ = _data()
    model = _model(data, warm_Z)
    _, unravel = ravel_pytree(model.state)
    model.state = unravel(jnp.asarray(warm_state))
    model.train_model(num_warmup=TUNE, num_samples=DRAWS, key=jax.random.PRNGKey(seed))
    flat = jax.vmap(lambda s: ravel_pytree(s)[0])(model.trace)
    d = data.X_train.shape[1]
    means, vars_ = model.mixture_posterior_predictive_y(jnp.asarray(data.X_test), COMPONENTS)
    yt = jnp.asarray(data.Y_test)
    st = model.stats
    run = {"rmse": float(rmse(jnp.mean(means, 0), yt, data.Y_std)),
           "nlpd": float(nlpd_mixture(means, vars_, yt, data.Y_std)),
           "components": int(means.shape[0]),
           "lane_means": np.asarray(jnp.mean(flat[:, :d + 2], 0)).tolist(),
           "accept": float(jnp.mean(st["accept_prob"])),
           "diverging": float(jnp.mean(st["diverging"])),
           "leapfrogs": float(jnp.mean(st["n_leapfrog"]))}
    print(f"key {seed} (JAX package, CPU, float64): {time.time() - t0:.1f} s; "
          f"{json.dumps(run)}", flush=True)
    return run


def main(workers=4):
    ref = warm()
    cpus = sorted(os.sched_getaffinity(0))
    per = max(1, len(cpus) // workers)
    ctx = mp.get_context("spawn")
    cpu_sets = ctx.Queue()
    for i in range(workers):
        cpu_sets.put(cpus[i * per:(i + 1) * per] or cpus)
    with ctx.Pool(workers, initializer=_pin, initargs=(cpu_sets,)) as pool:
        runs = pool.starmap(run_key, [(k, ref["warm_state"], ref["warm_Z"]) for k in KEYS])
    ref.update(dataset=DATASET, split=SPLIT, warm_steps=WARM_STEPS, tune=TUNE, draws=DRAWS,
               keys=list(KEYS), runs=runs)
    for k in ("rmse", "nlpd"):
        v = np.array([r[k] for r in runs])
        ref[k] = float(v.mean())
        ref[k + "_sd"] = float(v.std(ddof=1))
    lanes = np.array([r["lane_means"] for r in runs])
    ref["lane_means"] = lanes.mean(0).tolist()
    ref["lane_sd"] = lanes.std(0, ddof=1).tolist()
    with open(OUT, "w") as f:
        json.dump(ref, f)
    print(json.dumps({k: v for k, v in ref.items()
                      if k not in ("warm_state", "warm_Z", "runs")}))


if __name__ == "__main__":
    main()
