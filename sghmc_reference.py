"""The JAX package's own runs of chip_smoke.py's SGHMC protocols, on the CPU.

    JAX_PLATFORMS=cpu python3 sghmc_reference.py [n_rows ...]

For each ``n_rows`` (default 100000: a host CPU run at the card's 1,000,000
rows would hold several (2, 100, 1e6) float32 grams at once), on
synthetic-large tiled up to ``n_rows`` rows, M=100, 2 chains of SGHMC with
the SVRG anchor, step size 2e-5 decaying to 1e-5 over 2000 steps, batch 2048:

- ``sghmc-exp``: ``experiments/large_scale_regression_sghmc.py`` ``main()``
  (the SparseGPR warm start on 4096 rows, SGHMC from it, the 30-component
  mixture predictive). The JAX package trains the warm start on its XLA
  path (optax Adam) here.
- ``sghmc-1m``: bench.py ``cell_sghmc_1m``'s protocol at ``n_rows`` rows
  (hypers from ``init_params`` with log-noise log 0.05, Z rows by
  RandomState(45), ``prior_tree_rbf``), without its untimed first run.

Each protocol prints one JSON line: what the run moves (the warm start's
final loss and log-hypers, the kept draws' mean log-hypers, pooled and per
chain, in the order [log_lengthscale (18), log_outputscale, log_noise])
and the experiment's RMSE and mixture NLPD. chip_smoke.py holds the port's
runs of the same protocols at the same ``n_rows`` against these numbers
(``SGHMC_REF``).
"""

from __future__ import annotations

import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import experiments.large_scale_regression_sghmc as exp  # noqa: E402
from ggp_tpu.inference.sghmc import SGHMCConfig, run_sghmc  # noqa: E402
from ggp_tpu.kernels import default_rbf  # noqa: E402
from ggp_tpu.models.sgpr import sgpr_elbo_from_stats, vfe_stats  # noqa: E402
from ggp_tpu.priors import log_prior, prior_tree_rbf  # noqa: E402
from ggp_tpu.utils.datasets import get_regression_data  # noqa: E402


def log_hypers(tree):
    """[log_lengthscale (d), log_outputscale, log_noise] along the last axis."""
    k = tree["kernel"]
    return jnp.concatenate([k["base"]["log_lengthscale"],
                            k["log_outputscale"][..., None], tree["log_noise"][..., None]],
                           axis=-1)


def draw_means(samples):
    """The kept draws' mean log-hypers: pooled, and per chain."""
    lh = np.asarray(log_hypers(samples), np.float64)          # (C, S, d + 2)
    return {"draws_mean_log_hypers": lh.mean((0, 1)).tolist(),
            "chain_mean_log_hypers": lh.mean(1).tolist()}


def run_experiment(n_rows):
    """``main()`` with the warm start's model and the SGHMC draws captured."""
    seen = {}

    class Warm(exp.SparseGPR):
        def train_model(self, *a, **kw):
            losses = super().train_model(*a, **kw)
            seen["warm_loss"] = float(losses[-1])
            seen["warm_log_hypers"] = np.asarray(log_hypers(self.params)).tolist()
            return losses

    def sghmc(*a, **kw):
        out = run_sghmc(*a, **kw)
        seen.update(draw_means(out[0]))
        return out

    exp.SparseGPR, exp.run_sghmc = Warm, sghmc
    exp.main(n_rows=n_rows, control_variate=True, step_size=2e-5, final_step_size=1e-5,
             num_steps=2000, num_chains=2)
    return seen


def run_bench_protocol(n_rows):
    """bench.py ``cell_sghmc_1m`` (bench.py:287-350) at ``n_rows`` rows."""
    data = get_regression_data("synthetic-large", split=0)
    X = jnp.asarray(data.X_train, jnp.float32)
    y = jnp.asarray(data.Y_train, jnp.float32)
    reps = -(-n_rows // X.shape[0])
    X = jnp.tile(X, (reps, 1))[:n_rows]
    y = jnp.tile(y, reps)[:n_rows]
    N, D = X.shape
    rng = np.random.RandomState(45)
    Z = X[jnp.asarray(rng.randint(0, N, 100))]
    kern = default_rbf(ard=True)
    hypers = {"kernel": kern.init_params(D),
              "log_noise": jnp.asarray(np.log(0.05), jnp.float32)}
    prior = prior_tree_rbf()

    def logpost(state, idx):
        stats = vfe_stats(kern, state["kernel"], Z, X[idx], y[idx])
        stats = jax.tree_util.tree_map(lambda s: s * (N / idx.shape[0]), stats)
        return sgpr_elbo_from_stats(kern, {**state, "Z": Z}, stats, N, 1e-5) \
            + log_prior(prior, state)

    def logpost_full(state):
        stats = vfe_stats(kern, state["kernel"], Z, X, y)
        return sgpr_elbo_from_stats(kern, {**state, "Z": Z}, stats, N, 1e-5) \
            + log_prior(prior, state)

    cfg = SGHMCConfig(step_size=2e-5, final_step_size=1e-5, friction=0.05, num_steps=2000,
                      batch_size=2048, num_warmup=2000 // 3, thin=10, control_variate=True)
    samples, _ = run_sghmc(logpost, hypers, jax.random.PRNGKey(0), N, cfg, num_chains=2,
                           full_logpost_fn=logpost_full)
    return draw_means(samples)


def run(n_rows):
    import os
    # as the experiment and bench.py do: the multi-chain scan takes the XLA stats
    os.environ.setdefault("GGP_DISABLE_PALLAS", "1")
    for name, fn in (("sghmc-exp", run_experiment), ("sghmc-1m", run_bench_protocol)):
        t0 = time.time()
        print(f"== {name} at n_rows={n_rows} (JAX package, CPU, float32)", flush=True)
        out = fn(n_rows)
        print(json.dumps({"protocol": name, "n_rows": n_rows, **out}), flush=True)
        print(f"== {name} at n_rows={n_rows}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    for n in [int(a) for a in sys.argv[1:]] or [100_000]:
        run(n)
