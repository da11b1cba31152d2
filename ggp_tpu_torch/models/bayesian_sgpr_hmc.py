"""BayesianSGPR_HMC, the doubly collapsed model (counterpart of
``ggp_tpu/models/bayesian_sgpr_hmc.py``).

Hyperparameters (log-lengthscales, log-outputscale, log-noise) are sampled
by NUTS from the collapsed VFE marginal at fixed inducing locations Z; Z is
trained by Adam on the average of the collapsed ELBO over the current
hyper trace; an ML-II warm start of (hypers, Z) comes first. Every phase
runs through one of the port's kernels on the card:

* ``warm_start``   -> ``ops.sgpr_adam.sgpr_adam_chunk`` (clip 10);
* ``sample_hypers`` -> one chain of NUTS: ``ops.vfe_bound.vfe_potential``
  (initial U/g, step size search) and ``ops.nuts_chunk.nuts_chunk``
  (warmup and sampling); C chains, or HMC: ``ops.multichain.mc_potential``
  and ``mc_nuts_chunk`` or ``mc_hmc_chunk``;
* ``optimize_Z``   -> ``ops.sgpr_adam.z_adam_chunk``.

Parameters are a flat ``theta`` (d+2,) in ravel order ``[log_lengthscale
(d), log_outputscale, log_noise]`` and ``Z`` (m, d); ``hypers`` gives the
JAX package's nested-dict view. The model's tensors live on the card
(``"cuda"``) unless the caller passes ``device="cpu"``, which runs every
kernel's plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import default_jitter, resolve_device
from ..inference.hmc import NUTSConfig, multichain_fused, single_chain_fused
from ..kernels import default_rbf
from ..likelihoods import GaussianLikelihood
from ..ops.multichain import make_multichain
from ..ops.sgpr_adam import sgpr_adam_chunk, z_adam_chunk
from ..ops.vfe_bound import prior_spec_of_tree, vfe_potential
from ..priors import prior_tree_rbf
from .sgpr import sgpr_predict
from .svgp import check_rbf_ard

__all__ = ["BayesianSparseGPR_HMC", "theta_to_hypers"]


def theta_to_hypers(theta: torch.Tensor) -> dict:
    """Nested-dict view of a flat (..., d+2) hyper vector."""
    d = theta.shape[-1] - 2
    return {"kernel": {"base": {"log_lengthscale": theta[..., :d]},
                       "log_outputscale": theta[..., d]},
            "log_noise": theta[..., d + 1]}


class BayesianSparseGPR_HMC:
    """``(train_x, train_y, likelihood, Z_init, kernel, prior_tree, jitter,
    mesh)`` constructor (the JAX package's order), ``warm_start``,
    ``sample_hypers``, ``optimize_Z``, ``train_model``,
    ``mixture_posterior_predictive``, ``posterior_predictive``."""

    def __init__(self, train_x, train_y, likelihood=None, Z_init=None, kernel=None,
                 prior_tree=None, jitter: float | None = None, mesh=None, *,
                 dtype=None, device=None):
        unsupported = []
        if likelihood is not None and type(likelihood) is not GaussianLikelihood:
            unsupported.append("non-Gaussian likelihoods (ROADMAP queue 1 item 4)")
        if not check_rbf_ard(kernel):
            unsupported.append("kernels other than Scale(RBF-ARD) (queue 1 items 4, 12)")
        prior_tree = prior_tree if prior_tree is not None else prior_tree_rbf()
        prior_spec = prior_spec_of_tree(prior_tree)
        if prior_spec is None:
            unsupported.append("prior trees without closed-form leaves of the "
                               "Scale(RBF) x Gaussian structure (queue 1 item 4)")
        if mesh is not None:
            unsupported.append("a device mesh (queue 1 item 13)")
        if unsupported:
            raise NotImplementedError(
                "BayesianSparseGPR_HMC in the port takes Scale(RBF-ARD) x Gaussian with a "
                "closed-form prior tree and no mesh; still to port: " + ", ".join(unsupported))
        dtype = dtype or torch.as_tensor(train_x).dtype
        device = resolve_device("BayesianSparseGPR_HMC", device)
        self.train_x = torch.as_tensor(train_x, dtype=dtype, device=device).contiguous()
        self.train_y = torch.as_tensor(train_y, dtype=dtype, device=device).contiguous()
        n, d = self.train_x.shape
        self.kernel = default_rbf(ard=True) if kernel is None else kernel
        self.likelihood = GaussianLikelihood()
        self.jitter = default_jitter(dtype) if jitter is None else float(jitter)
        self.prior_tree = prior_tree
        self.prior_spec = prior_spec
        Z = self.train_x[:128] if Z_init is None else Z_init
        self.Z = torch.as_tensor(Z, dtype=dtype, device=device).clone().contiguous()
        self.theta = torch.zeros(d + 2, dtype=dtype, device=device)
        self.theta[d] = self.kernel.init_log_outputscale
        self.trace = None           # (S, d+2) draws, C chains pooled chain-major
        self.stats = None

    @property
    def hypers(self) -> dict:
        return theta_to_hypers(self.theta)

    def _params(self, theta):
        return {**theta_to_hypers(theta), "Z": self.Z}

    # -- phase A: joint ML-II warm start -----------------------------------
    def warm_start(self, num_steps: int = 500, lr: float = 0.01):
        """Adam on (theta, Z) of -ELBO: masked gradient, clip-by-global-norm
        10, +-15 box on the log-hypers, noise floor 1e-4. Returns losses."""
        zt = torch.zeros_like(self.theta)
        zz = torch.zeros_like(self.Z)
        self.theta, self.Z, *_, losses = sgpr_adam_chunk(
            self.theta, self.Z, zt, zt, zz, zz, self.train_x, self.train_y,
            self.jitter, t0=0, num_steps=num_steps, lr=lr, clip_norm=10.0,
            min_noise=1e-4)
        return losses

    # -- HMC over the hypers at fixed Z ------------------------------------
    def sample_hypers(self, num_warmup: int, num_samples: int,
                      generator: torch.Generator | None = None, *,
                      num_chains: int = 1, algorithm: str = "nuts",
                      num_leapfrog: int = 10):
        """Draw a fresh hyper trace at the current Z; theta moves to the
        trace mean. Each chain starts at theta + 0.1 N(0, 1), drawn first
        from ``generator`` ((num_chains, d+2) at once for C chains).

        One chain of NUTS runs the single-chain sampler. ``num_chains > 1``
        or ``algorithm="hmc"`` (fixed ``num_leapfrog`` steps) runs the
        C-chain sampler, and the trace pools the chains chain-major to
        (C*S, d+2)."""
        if algorithm not in ("nuts", "hmc"):
            raise ValueError(f"algorithm must be 'nuts' or 'hmc', got {algorithm!r}")
        if generator is None:
            generator = torch.Generator(device=self.theta.device).manual_seed(0)
        cfg = NUTSConfig(num_warmup=num_warmup, num_samples=num_samples,
                         algorithm=algorithm, num_leapfrog=num_leapfrog)
        X, y, Z = self.train_x, self.train_y, self.Z
        kw = dict(generator=generator, dtype=self.theta.dtype,
                  device=self.theta.device)
        if num_chains == 1 and algorithm == "nuts":
            def potential(z):
                return vfe_potential(z, X, y, Z, self.jitter,
                                     prior_spec=self.prior_spec)

            z0 = self.theta + 0.1 * torch.randn(self.theta.shape, **kw)
            self.trace, self.stats = single_chain_fused(
                potential, X, y, Z, self.jitter, z0, generator, cfg,
                prior_spec=self.prior_spec)
        else:
            mk = make_multichain(X, y, Z, self.jitter, num_chains=num_chains,
                                 algo=algorithm, num_leapfrog=num_leapfrog,
                                 max_depth=cfg.max_depth,
                                 target_accept=cfg.target_accept,
                                 adapt_mass=cfg.adapt_mass,
                                 prior_spec=self.prior_spec)
            z0s = self.theta + 0.1 * torch.randn((num_chains,) + self.theta.shape, **kw)
            zs, self.stats = multichain_fused(mk, z0s, generator, cfg)
            self.trace = zs.reshape(-1, zs.shape[-1])
        self.theta = self.trace.mean(0)
        return self.trace

    # -- phase B: Adam on Z under the trace-averaged ELBO -------------------
    def optimize_Z(self, num_steps: int = 200, lr: float = 0.01):
        """Adam on Z (fresh moments each call) of the mean over the trace of
        -ELBO(theta_s, Z). Returns losses."""
        assert self.trace is not None, "sample_hypers first"
        zz = torch.zeros_like(self.Z)
        self.Z, _, _, losses = z_adam_chunk(
            self.Z, zz, zz, self.trace.contiguous(), self.train_x,
            self.train_y, self.jitter, t0=0, num_steps=num_steps, lr=lr)
        return losses

    # -- orchestration -----------------------------------------------------
    def train_model(self, max_steps: int = 2000,
                    hmc_scheduler: Optional[Sequence[int]] = None,
                    lr: float = 0.01, generator: torch.Generator | None = None,
                    num_chains: int = 1):
        """Alternating trainer: warm start for ``hmc_scheduler[0]`` steps,
        then at each scheduler entry a NUTS round of ``num_chains`` chains
        ((100, 20) for the first and last rounds, (25, 10) between)
        followed by Z steps up to the next entry. Returns the concatenated
        losses."""
        if generator is None:
            generator = torch.Generator(device=self.theta.device).manual_seed(0)
        if hmc_scheduler is None:
            hmc_scheduler = list(range(max_steps // 4, max_steps + 1,
                                       max(max_steps // 4, 1)))
        hmc_scheduler = list(hmc_scheduler)
        losses = [self.warm_start(num_steps=hmc_scheduler[0], lr=lr)]
        bounds = hmc_scheduler + [max_steps]
        for i in range(len(hmc_scheduler)):
            first_or_last = i == 0 or i == len(hmc_scheduler) - 1
            tune, n = (100, 20) if first_or_last else (25, 10)
            self.sample_hypers(tune, n, generator, num_chains=num_chains)
            n_z = bounds[i + 1] - bounds[i]
            if n_z > 0:
                losses.append(self.optimize_Z(num_steps=n_z, lr=lr))
        return torch.cat(losses)

    # -- prediction --------------------------------------------------------
    def mixture_posterior_predictive(self, test_x, include_noise: bool = True):
        """Per-trace-row SGPR predictives (S', Nt); components with a
        non-finite or non-positive moment are masked out."""
        assert self.trace is not None, "train first"
        test_x = torch.as_tensor(test_x, dtype=self.train_x.dtype,
                                 device=self.train_x.device)
        means, vars_ = [], []
        for theta in self.trace:
            mu, var = sgpr_predict(self.kernel, self._params(theta),
                                   self.train_x, self.train_y, test_x,
                                   self.jitter, include_noise=include_noise)
            means.append(mu)
            vars_.append(var)
        means, vars_ = torch.stack(means), torch.stack(vars_)
        ok = (torch.isfinite(means).all(-1) & torch.isfinite(vars_).all(-1)
              & (vars_ > 0).all(-1))
        return means[ok], vars_[ok]

    def posterior_predictive(self, test_x, include_noise: bool = True):
        """Predictive at the current (posterior-mean) hypers."""
        test_x = torch.as_tensor(test_x, dtype=self.train_x.dtype,
                                 device=self.train_x.device)
        return sgpr_predict(self.kernel, self._params(self.theta),
                            self.train_x, self.train_y, test_x, self.jitter,
                            include_noise=include_noise)
