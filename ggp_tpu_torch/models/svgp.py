"""SVGP: the uncollapsed variational sparse GP trained by SVI (counterpart
of ``ggp_tpu/models/svgp.py``).

Whitened q(v) = N(q_mu, q_L q_L^T) per latent with u = Lk v, a free
Cholesky factor (``q_sqrt_raw``: lower triangle direct, diagonal through
exp), learnable inducing locations, and the minibatch ELBO
(N / nb) sum_batch E_q[log p(y_i | f_i)] - KL with a Gaussian,
Bernoulli-probit, Poisson or C-class softmax likelihood.

``svgp_elbo`` and ``svgp_predict_f`` are plain PyTorch, differentiable by
autograd; the tests take them as ground truth. ``train_model`` runs on the
port's kernels: each launch of ``ops.svi.svi_chunk`` (Gaussian, probit,
Poisson) or ``ops.svi.svi_softmax_chunk`` (softmax) takes whole epochs of
minibatch Adam steps, with one permutation of the rows per epoch, drawn
from an explicit ``torch.Generator`` (and for the softmax term the
antithetic normal draws of every step). The model carries the
configuration the JAX package fuses: the Scale(RBF-ARD) kernel, one of the
four likelihoods (softmax with 2 <= C <= 16 classes and an even
``num_mc``), d + 2 <= 128, the built-in Adam. Anything else raises
``NotImplementedError``. The tensors live on the card (``"cuda"``) unless
the caller passes ``device="cpu"``, which runs the kernels' plain versions.
"""

from __future__ import annotations

import torch

from ..config import default_jitter, resolve_device
from ..kernels import RBF, Scale, default_rbf
from ..likelihoods import BernoulliProbit, GaussianLikelihood, PoissonLogCox, Softmax
from ..ops.linalg import safe_cholesky, tri_solve
from ..ops.svi import svi_chunk, svi_softmax_chunk

__all__ = ["StochasticVariationalGP", "svgp_elbo", "svgp_predict_f", "pack_svgp",
           "unpack_svgp", "lik_tag", "check_rbf_ard", "epoch_chunks",
           "STEPS_PER_LAUNCH"]

_TAGS = {GaussianLikelihood: "gauss", BernoulliProbit: "bernoulli_probit",
         PoissonLogCox: "poisson", Softmax: "softmax"}
# Adam steps per kernel launch, rounded down to whole epochs (at least one):
# bounds the index and eps arrays a launch holds
STEPS_PER_LAUNCH = 64


def _build_L(q_sqrt_raw: torch.Tensor) -> torch.Tensor:
    """(..., M, M) raw -> lower triangular with exp diagonal."""
    return (torch.tril(q_sqrt_raw, -1)
            + torch.diag_embed(torch.exp(torch.diagonal(q_sqrt_raw, dim1=-2, dim2=-1))))


def _whitened_q_f(kernel, kp, Z, q_mu, q_L, X, jitter, full_cov=False):
    """q(f(X)) moments under u = Lk v, q(v) = N(q_mu, q_L q_L^T); q_mu (M,
    C), q_L (C, M, M). Returns mean (Nb, C) and var (Nb, C), or the full
    covariance (C, Nb, Nb)."""
    Lk = safe_cholesky(kernel.gram(kp, Z, Z), jitter, relative=True)
    A = tri_solve(Lk, kernel.gram(kp, Z, X))                    # (M, Nb)
    mean = A.T @ q_mu
    SA = q_L.transpose(-1, -2) @ A                              # (C, M, Nb)
    if full_cov:
        cov = kernel.gram(kp, X, X)[None] - (A.T @ A)[None] + SA.transpose(-1, -2) @ SA
        return mean, cov
    var = kernel.diag(kp, X)[None] - (A * A).sum(0)[None] + (SA * SA).sum(1)
    return mean, torch.clamp(var.T, min=1e-12)


def _kl_whitened(q_mu, q_L):
    """KL(N(q_mu, q_L q_L^T) || N(0, I)), summed over the latents."""
    logdet = 2.0 * torch.log(torch.diagonal(q_L, dim1=-2, dim2=-1)).sum()
    return 0.5 * ((q_L * q_L).sum() + (q_mu * q_mu).sum() - q_mu.numel() - logdet)


def svgp_elbo(kernel, likelihood, params: dict, X_batch, y_batch, num_data: int,
              jitter: float | None = None, eps=None, generator=None):
    """Minibatch ELBO (N / b) sum_batch E_q[log p(y_i | f_i)] - KL. The
    softmax term takes its antithetic draws ``eps`` (num_mc // 2, b, C), or
    draws them from ``generator``."""
    jitter = default_jitter(X_batch.dtype) if jitter is None else jitter
    q_L = _build_L(params["q_sqrt_raw"])
    mean, var = _whitened_q_f(kernel, params["kernel"], params["Z"], params["q_mu"], q_L,
                              X_batch, jitter)
    lik_p = params.get("lik", {})
    if isinstance(likelihood, Softmax):
        ve = likelihood.variational_expectation(lik_p, mean, var, y_batch, eps=eps,
                                                generator=generator)
    else:
        ve = likelihood.variational_expectation(lik_p, mean[:, 0], var[:, 0], y_batch)
    return num_data / X_batch.shape[0] * ve.sum() - _kl_whitened(params["q_mu"], q_L)


def svgp_predict_f(kernel, params: dict, X_test, jitter: float | None = None,
                   full_cov: bool = False):
    jitter = default_jitter(X_test.dtype) if jitter is None else jitter
    return _whitened_q_f(kernel, params["kernel"], params["Z"], params["q_mu"],
                         _build_L(params["q_sqrt_raw"]), X_test, jitter, full_cov)


def lik_tag(likelihood) -> str | None:
    """The kernels' data term of ``likelihood``, or None for a custom one."""
    return _TAGS.get(type(likelihood))


def pack_svgp(params: dict, tag: str) -> dict:
    """The model's params -> the kernels' ``{"hyp", "Z", "q_mu", "q_raw"}``
    (``hyp`` = [log_ls (d), log_os(, log_noise)])."""
    k = params["kernel"]
    hyp = [k["base"]["log_lengthscale"], k["log_outputscale"][None]]
    if tag == "gauss":
        hyp.append(params["lik"]["log_noise"][None])
    return {"hyp": torch.cat(hyp).contiguous(), "Z": params["Z"].contiguous(),
            "q_mu": params["q_mu"].contiguous(), "q_raw": params["q_sqrt_raw"].contiguous()}


def unpack_svgp(flat: dict, params: dict, tag: str) -> dict:
    """The inverse of :func:`pack_svgp`, onto a copy of ``params``."""
    d = flat["Z"].shape[1]
    hyp = flat["hyp"]
    out = dict(params, Z=flat["Z"], q_mu=flat["q_mu"], q_sqrt_raw=flat["q_raw"],
               kernel={"base": {"log_lengthscale": hyp[:d]}, "log_outputscale": hyp[d]})
    if tag == "gauss":
        out["lik"] = {"log_noise": hyp[d + 1]}
    return out


def check_rbf_ard(kernel) -> bool:
    return kernel is None or (isinstance(kernel, Scale) and type(kernel.base) is RBF
                              and kernel.base.ard)


def epoch_chunks(N, batch_size, num_epochs, generator, device):
    """Yield (epochs, idx (epochs * steps, nb)) per launch: one permutation
    of the N rows per epoch, its first steps * nb entries in steps rows, and
    as many whole epochs per launch as :data:`STEPS_PER_LAUNCH` holds (at
    least one)."""
    nb = min(batch_size, N)
    steps = N // nb
    per = max(1, STEPS_PER_LAUNCH // steps)
    for e0 in range(0, num_epochs, per):
        ne = min(per, num_epochs - e0)
        perms = [torch.randperm(N, generator=generator, device=device)[:steps * nb]
                 for _ in range(ne)]
        yield ne, torch.stack(perms).reshape(ne * steps, nb)


class StochasticVariationalGP:
    """``(train_x, train_y, likelihood, Z_init)`` constructor,
    ``train_model``, ``posterior_predictive``, ``loss_fn`` and ``Z``."""

    def __init__(self, train_x, train_y, likelihood=None, Z_init=None, kernel=None,
                 jitter: float | None = None, *, dtype=None, device=None):
        likelihood = GaussianLikelihood() if likelihood is None else likelihood
        unsupported = []
        if not check_rbf_ard(kernel):
            unsupported.append("kernels other than Scale(RBF-ARD)")
        tag = lik_tag(likelihood)
        if tag is None:
            unsupported.append("custom likelihoods")
        elif tag == "softmax" and not (2 <= likelihood.num_classes <= 16
                                       and likelihood.num_mc % 2 == 0):
            unsupported.append("Softmax outside 2 <= num_classes <= 16 with an even num_mc")
        dtype = dtype or torch.as_tensor(train_x).dtype
        device = resolve_device("StochasticVariationalGP", device)
        self.train_x = torch.as_tensor(train_x, dtype=dtype, device=device).contiguous()
        self.train_y = torch.as_tensor(train_y, dtype=dtype, device=device).contiguous()
        d = self.train_x.shape[1]
        if d + 2 > 128:
            unsupported.append(f"d + 2 > 128 (got {d + 2})")
        if unsupported:
            raise NotImplementedError(
                "StochasticVariationalGP in the port takes Scale(RBF-ARD) x {Gaussian, "
                "BernoulliProbit, PoissonLogCox, Softmax}; still to port (ROADMAP queue 1 "
                "item 10): " + ", ".join(unsupported))
        self.kernel = default_rbf(ard=True)
        self.likelihood = likelihood
        self.tag = tag
        self.jitter = default_jitter(dtype) if jitter is None else float(jitter)
        Z = self.train_x[:128] if Z_init is None else Z_init
        Z = torch.as_tensor(Z, dtype=dtype, device=device).clone().contiguous()
        M = Z.shape[0]
        C = likelihood.num_classes if tag == "softmax" else 1
        self.num_latents = C
        kw = dict(dtype=dtype, device=device)
        self.params = {"kernel": self.kernel.init_params(d, **kw),
                       "lik": likelihood.init_params(**kw), "Z": Z,
                       "q_mu": torch.zeros((M, C), **kw),
                       "q_sqrt_raw": torch.zeros((C, M, M), **kw)}

    def loss_fn(self, params, X_batch, y_batch, eps=None, generator=None):
        return -svgp_elbo(self.kernel, self.likelihood, params, X_batch, y_batch,
                          self.train_x.shape[0], self.jitter, eps=eps, generator=generator)

    def train_model(self, optimizer=None, num_epochs: int = 100, batch_size: int = 200,
                    lr: float = 0.01, generator: torch.Generator | None = None):
        """Minibatch Adam (optax defaults) over ``num_epochs`` epochs, each a
        fresh permutation of the rows in N // batch_size steps; whole epochs
        run per kernel launch. Returns the per-epoch mean losses."""
        if optimizer is not None:
            raise NotImplementedError("a custom optimizer is still to port (ROADMAP "
                                      "queue 1 item 10): the kernels carry Adam")
        X, y = self.train_x, self.train_y
        dev, dt = X.device, X.dtype
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        p = pack_svgp(self.params, self.tag)
        mm = {k: torch.zeros_like(v) for k, v in p.items()}
        vv = {k: torch.zeros_like(v) for k, v in p.items()}
        t0, out = 0, []
        for ne, idx in epoch_chunks(X.shape[0], batch_size, num_epochs, generator, dev):
            K, nb = idx.shape
            if self.tag == "softmax":
                lik = self.likelihood
                eps = torch.randn((K, lik.num_mc // 2, nb, lik.num_classes),
                                  generator=generator, dtype=dt, device=dev)
                p, mm, vv, losses = svi_softmax_chunk(p, mm, vv, X, y, idx, eps,
                                                      self.jitter, t0=t0, lr=lr)
            else:
                p, mm, vv, losses = svi_chunk(p, mm, vv, X, y, idx, self.jitter,
                                              likelihood=self.tag, t0=t0, lr=lr)
            out.append(losses.reshape(ne, -1).mean(1))
            t0 += K
        self.params = unpack_svgp(p, self.params, self.tag)
        return torch.cat(out)

    def posterior_predictive(self, test_x, full_cov: bool = False,
                             include_likelihood: bool = True, eps=None, generator=None):
        """q(f*) or the y-predictive. The softmax class probabilities average
        over ``num_mc`` draws ``eps`` (num_mc, Nt, C), drawn from
        ``generator`` (seed 0 when None) if not given."""
        test_x = torch.as_tensor(test_x, dtype=self.train_x.dtype, device=self.train_x.device)
        mean, var = svgp_predict_f(self.kernel, self.params, test_x, self.jitter, full_cov)
        single = self.num_latents == 1
        if full_cov:
            if include_likelihood and self.tag == "gauss":
                var = var + self.likelihood.noise(self.params["lik"]) * torch.eye(
                    test_x.shape[0], dtype=var.dtype, device=var.device)
            return (mean[:, 0], var[0]) if single else (mean, var)
        if not include_likelihood:
            return (mean[:, 0], var[:, 0]) if single else (mean, var)
        if self.tag == "softmax":
            if eps is None and generator is None:
                generator = torch.Generator(device=test_x.device).manual_seed(0)
            return self.likelihood.predictive(self.params["lik"], mean, var, eps=eps,
                                              generator=generator)
        return self.likelihood.predictive(self.params["lik"], mean[:, 0], var[:, 0])

    @property
    def Z(self):
        return self.params["Z"]
