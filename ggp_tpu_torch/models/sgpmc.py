"""SGPMC / "JointHMC": HMC jointly over the whitened inducing values and
the hyperparameters (counterpart of ``ggp_tpu/models/sgpmc.py``).

The state is one flat row ``[log_lengthscale (d), log_outputscale,
log_noise, v (m)]`` (the ravel order of the JAX state ``{"kernel", "lik",
"mean": {}, "v"}``), with u = chol(Kuu) v the inducing values and v ~ N(0,
I). The target is the sum over the data of E_{p(f_i | u)}[log p(y_i | f_i)]
plus log N(v | 0, I) plus Gamma(2, 1) priors on the positive hypers. Every
phase runs through one of the port's kernels on the card:

* ``warm_start``   -> ``ops.sgpmc_warm.sgpmc_warm_chunk`` (Adam on (state,
  Z), clip 10, one launch for all steps);
* ``train_model``  -> one chain: ``ops.vfe_bound.vfe_potential`` (initial
  U/g, step-size search) and ``ops.nuts_chunk.nuts_chunk`` or
  ``ops.multichain.hmc_chunk``; C chains: ``ops.multichain.mc_potential``
  and ``mc_nuts_chunk`` or ``mc_hmc_chunk``; all with ``core="sgpmc"``.

On the card every one of these runs on the grouped sgpmc core
``"sgpmc_group"`` (``csrc/sgpmc_group.cuh``: G blocks per chain in one
cooperative launch, ``ops.vfe_group.route`` and ``geometry``), at every n:
the card then holds at most its resident blocks' worth of chains (264 at
f32 for the potential, fewer for the chunks), and more chains raise.

The port carries the configuration the JAX package fuses: Scale(RBF-ARD)
kernel, Gaussian likelihood, zero mean, Gamma(2, 1) priors, and a state row
d + 2 + m <= 128. Anything else raises ``NotImplementedError``. The model's
tensors live on the card (``"cuda"``) unless the caller passes
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch

from ..config import default_jitter, resolve_device
from ..inference.hmc import NUTSConfig, multichain_fused, single_chain_fused
from ..kernels import RBF, Scale, default_rbf
from ..likelihoods import GaussianLikelihood
from ..means import Zero
from ..ops.linalg import safe_cholesky, tri_solve
from ..ops.multichain import make_multichain
from ..ops.sgpmc_warm import sgpmc_warm_chunk
from ..ops.vfe_bound import vfe_potential
from ..priors import Gamma

__all__ = ["SGPMC", "train_sgp_hmc", "predict_sgpmc", "state_to_tree"]

_DIM_MAX = 128               # state row of the kernels (csrc kMaxDim)


def _whitened_conditional(kernel, kp, Z, v, X, jitter):
    """q(f | u = L v): mean = Ksm L^-T v, var = Kss_diag - ||L^-1 Kms||^2
    (clamped at 1e-12)."""
    L = safe_cholesky(kernel.gram(kp, Z, Z), jitter, relative=True)
    A = tri_solve(L, kernel.gram(kp, Z, X))                # (M, N)
    var = kernel.diag(kp, X) - (A * A).sum(0)
    return A.T @ v, torch.clamp(var, min=1e-12)


def state_to_tree(flat: torch.Tensor, d: int) -> dict:
    """The JAX package's nested-dict view of flat (..., d+2+m) state rows."""
    return {"kernel": {"base": {"log_lengthscale": flat[..., :d]},
                       "log_outputscale": flat[..., d]},
            "lik": {"log_noise": flat[..., d + 1]},
            "mean": {}, "v": flat[..., d + 2:]}


def _gamma21_only(tree) -> bool:
    if isinstance(tree, dict):
        return all(_gamma21_only(t) for t in tree.values())
    return tree == Gamma(2.0, 1.0)


class SGPMC:
    """``(train_x, train_y, likelihood, Z_init, kernel, hyper_prior_tree,
    jitter, mesh, mean_fn, mean_prior_tree)`` constructor (the JAX package's
    order), ``warm_start``, ``train_model``, ``mixture_posterior_predictive``
    and ``_y``."""

    def __init__(self, train_x, train_y, likelihood=None, Z_init=None,
                 kernel=None, hyper_prior_tree=None, jitter: float | None = None,
                 mesh=None, mean_fn=None, mean_prior_tree=None, *, dtype=None,
                 device=None):
        unsupported = []
        if likelihood is not None and type(likelihood) is not GaussianLikelihood:
            unsupported.append("non-Gaussian likelihoods")
        if kernel is not None and not (isinstance(kernel, Scale)
                                       and type(kernel.base) is RBF and kernel.base.ard):
            unsupported.append("kernels other than Scale(RBF-ARD)")
        if mean_fn is not None and type(mean_fn) is not Zero:
            unsupported.append("Constant/Linear means")
        if hyper_prior_tree is not None and not _gamma21_only(hyper_prior_tree):
            unsupported.append("hyperpriors other than Gamma(2, 1)")
        if mean_prior_tree is not None:
            unsupported.append("mean-function priors (ROADMAP queue 1 item 12)")
        if mesh is not None:
            unsupported.append("a device mesh (ROADMAP queue 1 item 13)")
        if unsupported:
            raise NotImplementedError(
                "SGPMC in the port takes Scale(RBF-ARD) x Gaussian x Zero mean "
                "x Gamma(2, 1); still to port (ROADMAP queue 1, JointHMC "
                "follow-ups): " + ", ".join(unsupported))
        dtype = dtype or torch.as_tensor(train_x).dtype
        device = resolve_device("SGPMC", device)
        self.train_x = torch.as_tensor(train_x, dtype=dtype, device=device).contiguous()
        self.train_y = torch.as_tensor(train_y, dtype=dtype, device=device).contiguous()
        n, d = self.train_x.shape
        Z = self.train_x[:100] if Z_init is None else Z_init
        self.Z = torch.as_tensor(Z, dtype=dtype, device=device).clone().contiguous()
        m = self.Z.shape[0]
        if d + 2 + m > _DIM_MAX:
            raise NotImplementedError(
                f"SGPMC in the port takes a state row d + 2 + m <= {_DIM_MAX} "
                f"(got {d + 2 + m}); larger m is still to port (ROADMAP queue 1)")
        self.kernel = default_rbf(ard=True) if kernel is None else kernel
        self.likelihood = GaussianLikelihood()
        self.mean_fn = Zero()
        self.jitter = default_jitter(dtype) if jitter is None else float(jitter)
        self.flat = torch.zeros(d + 2 + m, dtype=dtype, device=device)
        self.flat[d] = self.kernel.init_log_outputscale
        self.trace = None           # (S, d+2+m) draws, C chains pooled chain-major
        self.stats = None

    @property
    def state(self) -> dict:
        return state_to_tree(self.flat, self.train_x.shape[1])

    @property
    def trace_tree(self) -> dict:
        """The trace in the JAX package's pytree layout, (S, ...) leaves."""
        assert self.trace is not None, "train first"
        return state_to_tree(self.trace, self.train_x.shape[1])

    def warm_start(self, num_steps: int = 100, lr: float = 0.01):
        """Adam on (state, Z) of -(loglik + log N(v | 0, I)), no hyperprior:
        masked gradient, clip by global norm 10. Z is then frozen for the
        sampler. Returns the per-step losses."""
        zs, zz = torch.zeros_like(self.flat), torch.zeros_like(self.Z)
        self.flat, self.Z, *_, losses = sgpmc_warm_chunk(
            self.flat, self.Z, zs, zs, zz, zz, self.train_x, self.train_y,
            self.jitter, t0=0, num_steps=num_steps, lr=lr)
        return losses

    def train_model(self, num_warmup: int = 500, num_samples: int = 500,
                    num_chains: int = 1, generator: torch.Generator | None = None,
                    algorithm: str = "nuts", num_leapfrog: int = 10):
        """Sample (hypers, v) at the current Z with NUTS or fixed-leapfrog
        HMC (``algorithm="hmc"``, ``num_leapfrog`` steps). Each chain
        starts at the current state + 0.1 N(0, 1), drawn first from
        ``generator``. One chain runs the single-chain sampler, C >= 2 the
        C-chain sampler (m <= 128). Returns the trace (C*S, d+2+m), chains
        pooled chain-major."""
        if algorithm not in ("nuts", "hmc"):
            raise ValueError(f"algorithm must be 'nuts' or 'hmc', got {algorithm!r}")
        if generator is None:
            generator = torch.Generator(device=self.flat.device).manual_seed(0)
        cfg = NUTSConfig(num_warmup=num_warmup, num_samples=num_samples,
                         algorithm=algorithm, num_leapfrog=num_leapfrog)
        X, y, Z, jit = self.train_x, self.train_y, self.Z, self.jitter
        kw = dict(generator=generator, dtype=self.flat.dtype, device=self.flat.device)
        if num_chains == 1:
            def potential(z):
                return vfe_potential(z, X, y, Z, jit, core="sgpmc")

            z0 = self.flat + 0.1 * torch.randn(self.flat.shape, **kw)
            self.trace, self.stats = single_chain_fused(
                potential, X, y, Z, jit, z0, generator, cfg, core="sgpmc")
        else:
            mk = make_multichain(X, y, Z, jit, num_chains=num_chains,
                                 algo=algorithm, num_leapfrog=num_leapfrog,
                                 max_depth=cfg.max_depth,
                                 target_accept=cfg.target_accept,
                                 adapt_mass=cfg.adapt_mass, core="sgpmc")
            z0s = self.flat + 0.1 * torch.randn((num_chains,) + self.flat.shape, **kw)
            zs, self.stats = multichain_fused(mk, z0s, generator, cfg)
            self.trace = zs.reshape(-1, zs.shape[-1])
        return self.trace

    def _thinned_mixture(self, test_x, num_components):
        """(thinned trace, means, vars, finite mask) with aligned rows."""
        assert self.trace is not None, "train first"
        test_x = torch.as_tensor(test_x, dtype=self.train_x.dtype,
                                 device=self.train_x.device)
        k = max(1, self.trace.shape[0] // num_components)
        sub = self.trace[::k][:num_components]
        tree = state_to_tree(sub, self.train_x.shape[1])
        kp = tree["kernel"]
        means, vars_ = [], []
        for s in range(sub.shape[0]):
            kps = {"log_outputscale": kp["log_outputscale"][s],
                   "base": {"log_lengthscale": kp["base"]["log_lengthscale"][s]}}
            mu, var = _whitened_conditional(self.kernel, kps, self.Z, tree["v"][s],
                                            test_x, self.jitter)
            means.append(mu + self.mean_fn({}, test_x))
            vars_.append(var)
        means, vars_ = torch.stack(means), torch.stack(vars_)
        ok = torch.isfinite(means).all(-1) & torch.isfinite(vars_).all(-1)
        return sub, means, vars_, ok

    def mixture_posterior_predictive(self, test_x, num_components: int = 50):
        """Latent-f mixture over up to ``num_components`` thinned draws
        (thinning k = max(1, S // num_components)); components with a
        non-finite moment are masked out. Returns (means, vars) (S', Nt)."""
        _, means, vars_, ok = self._thinned_mixture(test_x, num_components)
        return means[ok], vars_[ok]

    def mixture_posterior_predictive_y(self, test_x, num_components: int = 50):
        """Observation-space mixture: the latent moments plus each
        component's own noise, masked as the latent mixture."""
        sub, means, vars_, ok = self._thinned_mixture(test_x, num_components)
        noise = torch.exp(sub[:, self.train_x.shape[1] + 1])
        return means[ok], (vars_ + noise[:, None])[ok]


def train_sgp_hmc(data, Z_init, num_warmup=500, num_samples=500,
                  warm_start_iters=100, generator=None, **kw):
    """Functional API: ``data = (X, y)``; warm start, then ``train_model``.
    Constructor options (``device``, ``dtype``, ``jitter``, ...) and
    ``train_model`` options (``algorithm``, ``num_chains``, ...) pass
    through ``kw``. Returns the trained model."""
    ctor = {k: kw.pop(k) for k in ("likelihood", "kernel", "mean_fn", "mesh",
                                   "mean_prior_tree", "hyper_prior_tree", "jitter", "dtype",
                                   "device") if k in kw}
    X, y = data
    model = SGPMC(X, y, Z_init=Z_init, **ctor)
    model.warm_start(num_steps=warm_start_iters)
    model.train_model(num_warmup=num_warmup, num_samples=num_samples,
                      generator=generator, **kw)
    return model


def predict_sgpmc(model: SGPMC, test_x, num_components: int = 50):
    """Mixture predictive from up to ``num_components`` posterior draws."""
    return model.mixture_posterior_predictive(test_x, num_components)
