"""GPR_HMC: the exact (dense) GP with NUTS over its hyperparameters
(counterpart of ``ggp_tpu/models/gpr_hmc.py``).

The target is the dense marginal log N(y | 0, K + s2 I) with the model's
absolute jitter, plus the hyper-priors (Gamma(2, 1) on the lengthscales,
HalfCauchy(1) on the outputscale and noise std by default). Sampling runs
on the ``"gpr"`` core of the port's kernels (``csrc/gpr_bound.cuh``):

* one chain  -> ``ops.gpr_bound.make_gpr_potential``, i.e.
  ``ops.vfe_bound.vfe_potential`` (initial U/g, step-size search), and
  ``ops.nuts_chunk.nuts_chunk`` (warmup and sampling);
* C chains   -> ``ops.multichain.mc_potential`` and ``mc_nuts_chunk``,
  one thread block per chain. The JAX package samples C chains of GPR with
  its vmapped XLA sampler, which has no lengthscale cap and draws other
  random numbers; both run C independent NUTS chains with their own Stan
  adaptation, so the two compare by marginals, not draw for draw.

Parameters are a flat ``params`` (d+2,) in ravel order ``[log_lengthscale
(d), log_outputscale, log_noise]`` (``hypers`` gives the JAX package's
nested-dict view; ``interop.params_from_jax`` converts). The mixture
predictive runs at PyTorch level (``torch.linalg``), as the JAX package runs
it at XLA level outside any kernel. The model carries what the fused JAX
path takes: Scale(RBF-ARD) x Gaussian with a prior tree of closed-form
leaves, d + 2 <= 128, no mesh; anything else raises
``NotImplementedError``. Its tensors live on the card (``"cuda"``) unless
the caller passes ``device="cpu"``, which runs every kernel's plain PyTorch
version. Unlike the JAX package's fused path (N <= 512) there is no row
cap: the kernels' scratch is 3 N^2 values per chain in device memory.
"""

from __future__ import annotations

import torch

from ..config import default_jitter, resolve_device
from ..inference.hmc import NUTSConfig, multichain_fused, single_chain_fused
from ..kernels import RBF, Kernel, Scale, default_rbf
from ..likelihoods import GaussianLikelihood
from ..ops.gpr_bound import _DIM_MAX, make_gpr_potential
from ..ops.linalg import mvn_logpdf_chol, safe_cholesky, tri_solve
from ..ops.multichain import make_multichain
from ..ops.vfe_bound import prior_spec_of_tree
from ..priors import prior_tree_rbf
from .bayesian_sgpr_hmc import theta_to_hypers

__all__ = ["GPR_HMC", "gp_marginal_loglik", "gp_predict"]


def gp_marginal_loglik(kernel: Kernel, params: dict, X: torch.Tensor,
                       y: torch.Tensor, jitter: float | None = None):
    """Dense log marginal likelihood log N(y | 0, K + sig_n^2 I), jitter
    absolute (the dtype's default when None)."""
    jitter = default_jitter(X.dtype) if jitter is None else jitter
    s2 = torch.exp(params["log_noise"])
    K = kernel.gram(params["kernel"], X, X) + s2 * torch.eye(
        X.shape[0], dtype=X.dtype, device=X.device)
    return mvn_logpdf_chol(y, torch.zeros_like(y), safe_cholesky(K, jitter))


def gp_predict(kernel: Kernel, params: dict, X: torch.Tensor, y: torch.Tensor,
               X_test: torch.Tensor, jitter: float | None = None,
               include_noise: bool = True):
    """Exact GP predictive marginals (mean, var) at ``X_test``."""
    jitter = default_jitter(X.dtype) if jitter is None else jitter
    s2 = torch.exp(params["log_noise"])
    K = kernel.gram(params["kernel"], X, X) + s2 * torch.eye(
        X.shape[0], dtype=X.dtype, device=X.device)
    L = safe_cholesky(K, jitter)
    alpha = tri_solve(L, y)
    v = tri_solve(L, kernel.gram(params["kernel"], X, X_test))
    mean = v.T @ alpha
    var = torch.clamp(kernel.diag(params["kernel"], X_test) - (v * v).sum(0), min=1e-12)
    return mean, (var + s2 if include_noise else var)


class GPR_HMC:
    """``(train_x, train_y, likelihood)`` constructor, ``train_model`` and
    ``full_mixture_posterior_predictive``."""

    def __init__(self, train_x, train_y, likelihood=None, kernel=None,
                 prior_tree=None, jitter: float | None = None, mesh=None, *,
                 dtype=None, device=None):
        unsupported = []
        if likelihood is not None and type(likelihood) is not GaussianLikelihood:
            unsupported.append("non-Gaussian likelihoods (ROADMAP queue 1 item 10)")
        if kernel is not None and not (isinstance(kernel, Scale)
                                       and type(kernel.base) is RBF and kernel.base.ard):
            unsupported.append("kernels other than Scale(RBF-ARD) (queue 1 items 4, 12)")
        prior_tree = prior_tree if prior_tree is not None else prior_tree_rbf()
        prior_spec = prior_spec_of_tree(prior_tree)
        if prior_spec is None:
            unsupported.append("prior trees without closed-form leaves of the "
                               "Scale(RBF) x Gaussian structure (queue 1 item 4)")
        if mesh is not None:
            unsupported.append("a device mesh (queue 1 item 13)")
        d = torch.as_tensor(train_x).shape[-1]
        if d + 2 > _DIM_MAX:
            unsupported.append(f"d + 2 > {_DIM_MAX} (queue 1 item 4)")
        if unsupported:
            raise NotImplementedError(
                "GPR_HMC in the port takes Scale(RBF-ARD) x Gaussian with a "
                "closed-form prior tree, d + 2 <= 128, no mesh; still to port: "
                + ", ".join(unsupported))
        dtype = dtype or torch.as_tensor(train_x).dtype
        device = resolve_device("GPR_HMC", device)
        self.train_x = torch.as_tensor(train_x, dtype=dtype, device=device).contiguous()
        self.train_y = torch.as_tensor(train_y, dtype=dtype, device=device).contiguous()
        self.kernel = default_rbf(ard=True)
        self.likelihood = GaussianLikelihood()
        self.prior_tree = prior_tree
        self.prior_spec = prior_spec
        self.jitter = default_jitter(dtype) if jitter is None else float(jitter)
        self.params = torch.zeros(d + 2, dtype=dtype, device=device)
        self._Z = self.train_x.new_empty((0, d))   # the gpr core reads no Z
        self.trace = None           # (S, d+2) draws, C chains pooled chain-major
        self.stats = None

    @property
    def hypers(self) -> dict:
        return theta_to_hypers(self.params)

    def train_model(self, num_warmup: int = 50, num_samples: int = 10,
                    num_chains: int = 1, generator: torch.Generator | None = None,
                    max_depth: int = 8):
        """NUTS over (log ls, log sig_f^2, log sig_n^2) with Stan warmup.
        Each chain starts at ``params`` + 0.1 N(0, 1), drawn first from
        ``generator`` ((num_chains, d+2) at once for C chains). Returns the
        trace (C*S, d+2), chains pooled chain-major."""
        if generator is None:
            generator = torch.Generator(device=self.params.device).manual_seed(0)
        cfg = NUTSConfig(num_warmup=num_warmup, num_samples=num_samples,
                         max_depth=max_depth)
        X, y, Z, jit, spec = self.train_x, self.train_y, self._Z, self.jitter, self.prior_spec
        kw = dict(generator=generator, dtype=self.params.dtype, device=self.params.device)
        if num_chains == 1:
            z0 = self.params + 0.1 * torch.randn(self.params.shape, **kw)
            self.trace, self.stats = single_chain_fused(
                make_gpr_potential(X, y, jit, spec), X, y, Z, jit, z0, generator,
                cfg, prior_spec=spec, core="gpr")
        else:
            mk = make_multichain(X, y, Z, jit, num_chains=num_chains, algo="nuts",
                                 max_depth=max_depth, target_accept=cfg.target_accept,
                                 adapt_mass=cfg.adapt_mass, prior_spec=spec, core="gpr")
            z0s = self.params + 0.1 * torch.randn((num_chains,) + self.params.shape, **kw)
            zs, self.stats = multichain_fused(mk, z0s, generator, cfg)
            self.trace = zs.reshape(-1, zs.shape[-1])
        return self.trace

    def full_mixture_posterior_predictive(self, test_x, noise_floor: bool = True):
        """Exact-GP predictive of every trace row; with ``noise_floor`` a
        sampled noise variance below 1e-4 becomes 0.01. Components with a
        non-finite moment are masked out. Returns (means, vars) (S', Nt)."""
        assert self.trace is not None, "train first"
        test_x = torch.as_tensor(test_x, dtype=self.train_x.dtype,
                                 device=self.train_x.device)
        means, vars_ = [], []
        for row in self.trace:
            hypers = theta_to_hypers(row)
            if noise_floor:
                s2 = torch.exp(hypers["log_noise"])
                s2 = torch.where(s2 < 1e-4, torch.full_like(s2, 0.01), s2)
                hypers["log_noise"] = torch.log(s2)
            mu, var = gp_predict(self.kernel, hypers, self.train_x, self.train_y,
                                 test_x, self.jitter)
            means.append(mu)
            vars_.append(var)
        means, vars_ = torch.stack(means), torch.stack(vars_)
        ok = torch.isfinite(means).all(-1) & torch.isfinite(vars_).all(-1)
        return means[ok], vars_[ok]
