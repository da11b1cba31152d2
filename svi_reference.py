"""The JAX package's own run of chip_smoke.py's five SVI protocols, on the CPU.

    JAX_PLATFORMS=cpu python3 svi_reference.py

Same data (chip_smoke's numpy builders), same models, epochs, batch sizes,
learning rates and inducing points, in float32 as chip_smoke runs them;
the JAX package trains on its XLA path (optax Adam) here. Prints one line
per path: first and last epoch loss and the path's metric. chip_smoke.py's
metric gates are set from these numbers with a margin (PERF.md §6).
"""

from __future__ import annotations

import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import (make_banana, make_classes, make_counts, make_data,  # noqa: E402
                        svi_inducing)
from ggp_tpu.likelihoods import BernoulliProbit, PoissonLogCox, Softmax  # noqa: E402
from ggp_tpu.models import StochasticVariationalGP  # noqa: E402
from ggp_tpu.models.bayesian_svgp import BayesianStochasticVariationalGP  # noqa: E402
from ggp_tpu.utils.datasets import get_classification_data  # noqa: E402
from ggp_tpu.utils.metrics import nlpd, nlpd_mixture, rmse  # noqa: E402


def f32(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def report(label, t0, losses, metric):
    losses = np.asarray(losses)
    print(f"{label} (JAX package, CPU, float32): {time.time() - t0:.1f} s; epoch loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {metric}", flush=True)


def main():
    X, y, _, Xt, yt = make_data()
    Z = svi_inducing(X)
    Xj, yj, Zj, Xtj, ytj = f32(X, y, Z, Xt, yt)

    t0 = time.time()
    m = StochasticVariationalGP(Xj, yj, Z_init=Zj)
    losses = m.train_model(num_epochs=200, batch_size=200, lr=0.01, key=jax.random.PRNGKey(45))
    mean, var = m.posterior_predictive(Xtj)
    report("svgp", t0, losses, f"held-out RMSE {float(rmse(mean, ytj)):.4f}, NLPD "
           f"{float(nlpd(mean, var, ytj)):.4f}")

    Xb, yb, Xbt, ybt = make_banana()
    d = get_classification_data("synthetic-banana")
    assert np.array_equal(d.X_train, Xb) and np.array_equal(d.Y_test, ybt)
    Xbj, ybj, Xbtj = f32(Xb, yb, Xbt)
    t0 = time.time()
    Z0 = Xbj[np.random.RandomState(0).randint(0, Xb.shape[0], 32)]
    m = StochasticVariationalGP(Xbj, ybj, likelihood=BernoulliProbit(), Z_init=Z0)
    losses = m.train_model(num_epochs=800, batch_size=256, lr=0.03, key=jax.random.PRNGKey(0))
    p, _ = m.posterior_predictive(Xbtj)
    report("svgp-probit", t0, losses,
           f"test accuracy {float(((np.asarray(p) > 0.5) == ybt).mean()):.4f}")

    yc, _, rate_t = make_counts(X, Xt)
    t0 = time.time()
    m = StochasticVariationalGP(Xj, jnp.asarray(yc, jnp.float32), likelihood=PoissonLogCox(),
                                Z_init=Zj)
    losses = m.train_model(num_epochs=200, batch_size=200, lr=0.01, key=jax.random.PRNGKey(45))
    r, _ = m.posterior_predictive(Xtj)
    report("svgp-poisson", t0, losses,
           f"held-out rate MAE {float(np.abs(np.asarray(r) - rate_t).mean()):.4f}")

    ycl = make_classes(y)
    t0 = time.time()
    m = StochasticVariationalGP(Xj, jnp.asarray(ycl, jnp.int32), likelihood=Softmax(3),
                                Z_init=Xj[::6])
    losses = m.train_model(num_epochs=500, batch_size=200, lr=0.05, key=jax.random.PRNGKey(2))
    p, _ = m.posterior_predictive(Xj)
    report("svgp-softmax", t0, losses,
           f"train accuracy {float((np.asarray(p).argmax(-1) == ycl).mean()):.4f}")

    t0 = time.time()
    m = BayesianStochasticVariationalGP(Xj, yj, Z_init=Zj, prior_var=1.0)
    losses = m.train_model(num_epochs=200, batch_size=200, lr=0.01, key=jax.random.PRNGKey(45))
    means, vars_ = m.mixture_posterior_predictive(Xtj, num_samples=100)
    report("bsvgp", t0, losses, f"mixture ({means.shape[0]} components) held-out RMSE "
           f"{float(rmse(means.mean(0), ytj)):.4f}, NLPD "
           f"{float(nlpd_mixture(means, vars_, ytj)):.4f}")


if __name__ == "__main__":
    main()
