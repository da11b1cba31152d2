"""The JAX package's own run of chip_smoke.py's reg-large path, on the CPU, in float64.

    JAX_PLATFORMS=cpu python3 regression_reference.py

The regression driver's BayesianSGPR_HMC protocol (``experiments/regression.py``
``single_run("synthetic-large", 0, "BayesianSGPR_HMC")``: 13,279 train rows,
D=18, M=100 inducing rows drawn by ``RandomState(45).randint``, the 500-step
warm start, three NUTS rounds of 2 chains with 500 Z steps after each)
through the JAX package's ``BayesianSparseGPR_HMC``, its rounds cut to
``ROUNDS`` (the driver's (100, 20), (25, 10), (100, 20) to (10, 10),
(10, 5), (10, 10); chip_smoke.py's reg-large path reads them from the
file this script writes). On the
CPU the JAX package runs its XLA paths: the autodiff warm start
(``_adam_all``), the vmapped XLA sampler and ``_adam_Z``, the same functions
as its fused kernels.

It records three things, which chip_smoke.py holds:

1. the warm start's final loss (deterministic; run once);
2. 20 Z-Adam steps from the warm start's Z over a fixed 40-row trace drawn
   with numpy around the warm start's hypers (``ZSTEP_SEED``,
   ``ZSTEP_SPREAD``): the losses and the final Z. They run the function of
   the JAX package's Z-Adam chunk (``ops/fused_sgpr.py``
   ``_zadam_chunk_body``): the mean over the rows of ``sgpr_loss_vg`` (its
   fused core with the trainers' pivot floor, 1e-6 max(sf2, 1) on Kmm) and
   ``_adam_update``, here through XLA. ``_adam_Z`` (the CPU path's
   autodiff, no floor) is run too and printed: at these hypers Kmm's
   smallest pivot lies below the floor, where the two differ by design;
3. the protocol's test RMSE and mixture NLPD (data units) from
   ``len(KEYS)`` PRNG keys, run from the warm state in parallel processes,
   and their means and standard deviations. On synthetic-large the fit is
   little better than noise, so this is a sanity gate.

Writes ``regression_reference.json`` beside this file (the rounds, the warm
start's hypers and Z, the trace's seed and spread, the Z steps' losses and
final Z, and the metrics) and prints its scalars.
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
import optax  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from ggp_tpu.models import BayesianSparseGPR_HMC  # noqa: E402
from ggp_tpu.models.bayesian_sgpr_hmc import _adam_Z  # noqa: E402
from ggp_tpu.ops.fused_sgpr import sgpr_loss_vg  # noqa: E402
from ggp_tpu.ops.fused_svi import _adam_update  # noqa: E402
from ggp_tpu.utils.datasets import get_regression_data  # noqa: E402
from ggp_tpu.utils.metrics import nlpd_mixture, rmse  # noqa: E402

OUT = Path(__file__).resolve().parent / "regression_reference.json"
DATASET, SPLIT, M, SEED = "synthetic-large", 0, 100, 45
MAX_ITERS, CHAINS, LR = 2000, 2, 0.01
ZSTEP_SEED, ZSTEP_ROWS, ZSTEP_SPREAD, ZSTEP_STEPS = 8, 40, 0.05, 20
KEYS = (SEED + SPLIT, SEED + SPLIT + 1000, SEED + SPLIT + 2000)
# The NUTS rounds' (tune, draws), cut from the driver's (100, 20), (25, 10),
# (100, 20): why, in chip_smoke.py beside REGRESSION_REF_FILE.
ROUNDS = ((10, 10), (10, 5), (10, 10))


def _data():
    data = get_regression_data(DATASET, split=SPLIT, prop=0.8)
    Z_init = data.X_train[np.random.RandomState(SEED).randint(
        0, data.X_train.shape[0], min(M, data.X_train.shape[0]))]
    return data, Z_init


def _model(data, Z):
    return BayesianSparseGPR_HMC(jnp.asarray(data.X_train), jnp.asarray(data.Y_train),
                                 Z_init=jnp.asarray(Z))


def zstep_trace(theta, rows=ZSTEP_ROWS, spread=ZSTEP_SPREAD, seed=ZSTEP_SEED):
    """The fixed trace of item 2: ``theta + spread * N(0, 1)`` per row, drawn
    by ``RandomState(seed)`` (chip_smoke.py draws the same rows)."""
    theta = np.asarray(theta, np.float64)
    return theta + spread * np.random.RandomState(seed).randn(rows, theta.shape[0])


def fused_zsteps(X, y, Z, thetas, jitter, steps=ZSTEP_STEPS, lr=LR):
    """``steps`` Adam steps on Z of the mean over the rows of ``thetas`` of
    the fused core's -ELBO (``_zadam_chunk_body``'s step, in XLA on the
    padded layout). Returns (Z, losses)."""
    n, d = X.shape
    m = Z.shape[0]
    Mp = max(128, -(-m // 128) * 128)
    f64 = jnp.float64
    Xp = jnp.zeros((n, 128), f64).at[:, :d].set(X)
    yp = jnp.asarray(y, f64)[:, None]
    th = jnp.zeros((thetas.shape[0], 1, 128), f64).at[:, 0, :d + 2].set(thetas)
    Zp = jnp.zeros((Mp, 128), f64).at[:m, :d].set(Z)

    @jax.jit
    def step(Zp, mz, vz, t):
        def one(acc, th_s):
            loss, _, gZ = sgpr_loss_vg(th_s, Xp, yp, Zp, n, m, d, jitter)
            return (acc[0] + loss / thetas.shape[0], acc[1] + gZ / thetas.shape[0]), None
        (loss, gZ), _ = jax.lax.scan(one, (jnp.zeros((), f64), jnp.zeros_like(Zp)), th)
        Zp, mz, vz = _adam_update(Zp, gZ, mz, vz, t + 1.0, lr)
        return Zp, mz, vz, loss

    mz = vz = jnp.zeros_like(Zp)
    losses = []
    for t in range(steps):
        Zp, mz, vz, loss = step(Zp, mz, vz, jnp.asarray(t, f64))
        losses.append(float(loss))
    return np.asarray(Zp[:m, :d]), np.asarray(losses)


def warm_and_zsteps():
    data, Z_init = _data()
    model = _model(data, Z_init)
    t0 = time.time()
    losses = model.warm_start(num_steps=MAX_ITERS // 4, lr=LR)
    theta, unravel = ravel_pytree(model.hypers)
    print(f"warm start (JAX package, CPU, float64): {time.time() - t0:.1f} s, "
          f"final loss {float(losses[-1])!r}", flush=True)
    t0 = time.time()
    thetas = zstep_trace(theta)
    Z1, zl = fused_zsteps(model.train_x, model.train_y, model.Z, thetas, model.jitter)
    print(f"{ZSTEP_STEPS} Z steps (fused core): {time.time() - t0:.1f} s, losses "
          f"{float(zl[0])!r} .. {float(zl[-1])!r}", flush=True)
    trace = jax.vmap(unravel)(jnp.asarray(thetas))
    opt = optax.chain(optax.zero_nans(), optax.adam(LR))
    Z2, zl2 = _adam_Z(model.kernel, model.train_x, model.train_y, model.jitter, model.Z,
                      trace, opt, ZSTEP_STEPS)
    print(f"{ZSTEP_STEPS} Z steps (_adam_Z, no pivot floor): losses {float(zl2[0])!r} .. "
          f"{float(zl2[-1])!r}; final Z max |difference| from the fused core's "
          f"{float(np.abs(np.asarray(Z2) - Z1).max()):.3e}", flush=True)
    return {"warm_loss": float(losses[-1]), "warm_theta": np.asarray(theta).tolist(),
            "warm_Z": np.asarray(model.Z).tolist(), "zstep_seed": ZSTEP_SEED,
            "zstep_rows": ZSTEP_ROWS, "zstep_spread": ZSTEP_SPREAD,
            "zstep_losses": np.asarray(zl).tolist(), "zstep_Z": np.asarray(Z1).tolist()}


def _pin(cpu_sets):
    os.sched_setaffinity(0, cpu_sets.get())


def run_key(seed, warm_theta, warm_Z):
    """The protocol's rounds from the warm state with PRNGKey(seed): the
    loop of ``train_model`` after its warm start, with ROUNDS' rounds."""
    t0 = time.time()
    data, _ = _data()
    model = _model(data, warm_Z)
    _, unravel = ravel_pytree(model.hypers)
    model.hypers = unravel(jnp.asarray(warm_theta))
    sched = [MAX_ITERS // 4, MAX_ITERS // 2, 3 * MAX_ITERS // 4]
    bounds = sched + [MAX_ITERS]
    key = jax.random.PRNGKey(seed)
    rounds = []
    for i, (tune, n) in enumerate(ROUNDS):
        key, sub = jax.random.split(key)
        model.sample_hypers(tune, n, CHAINS, key=sub)
        rounds.append({"accept": float(jnp.mean(model.stats["accept_prob"])),
                       "diverging": float(jnp.mean(model.stats["diverging"]))})
        model.optimize_Z(num_steps=bounds[i + 1] - bounds[i], lr=LR)
    means, vars_ = model.mixture_posterior_predictive(jnp.asarray(data.X_test))
    yt = jnp.asarray(data.Y_test)
    run = {"rmse": float(rmse(jnp.mean(means, 0), yt, data.Y_std)),
           "nlpd": float(nlpd_mixture(means, vars_, yt, data.Y_std)),
           "components": int(means.shape[0]), "rounds": rounds}
    print(f"key {seed} (JAX package, CPU, float64): {time.time() - t0:.1f} s; "
          f"{json.dumps(run)}", flush=True)
    return run


def main(workers=len(KEYS)):
    ref = warm_and_zsteps()
    cpus = sorted(os.sched_getaffinity(0))
    per = max(1, len(cpus) // workers)
    ctx = mp.get_context("spawn")
    cpu_sets = ctx.Queue()
    for i in range(workers):
        cpu_sets.put(cpus[i * per:(i + 1) * per] or cpus)
    with ctx.Pool(workers, initializer=_pin, initargs=(cpu_sets,)) as pool:
        runs = pool.starmap(run_key, [(k, ref["warm_theta"], ref["warm_Z"]) for k in KEYS])
    ref["rounds"] = [list(r) for r in ROUNDS]
    ref["keys"] = list(KEYS)
    ref["runs"] = runs
    for k in ("rmse", "nlpd"):
        v = np.array([r[k] for r in runs])
        ref[k] = float(v.mean())
        ref[k + "_sd"] = float(v.std(ddof=1))
    with open(OUT, "w") as f:
        json.dump(ref, f)
    print(json.dumps({k: v for k, v in ref.items()
                      if k not in ("warm_theta", "warm_Z", "zstep_Z", "runs")}))


if __name__ == "__main__":
    main()
