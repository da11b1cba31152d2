"""The random slabs a ``sample_hypers`` call read from its generator, drawn
again from a fresh generator of the same seed.

The program reads a ``torch.Generator`` in a documented order
(``BayesianSparseGPR_HMC.sample_hypers``, ``inference/hmc.py``,
``ops/nuts_chunk.py`` ``draw_slabs``, ``ops/multichain.py``
``draw_mc_slabs``): the chains' start jitter, the step-size search's momenta,
then per chunk of K transitions (16 for one chain of NUTS, 8 for C chains)
the momenta and either the Metropolis uniforms (HMC) or the tree and leaf
uniforms (NUTS), warmup chunks first. The check reads those inputs by
drawing the same sequence; the program's own draws are never read.
"""

from __future__ import annotations

import torch

__all__ = ["sampling_slabs"]

SINGLE_CHUNK = 16
MULTI_CHUNK = 8


def sampling_slabs(seed: int, *, chains: int, dim: int, warmup: int, samples: int,
                   algorithm: str, max_depth: int, dtype, device):
    """The slabs of the sampling transitions, (samples, C, ...) each: ``mom``
    and ``mh`` (HMC) or ``treeu`` and ``leafu`` (NUTS)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, dtype=dtype, device=device)
    single = chains == 1 and algorithm == "nuts"
    K = SINGLE_CHUNK if single else MULTI_CHUNK
    shape = (dim,) if single else (chains, dim)
    torch.randn(shape, **kw)                   # start jitter
    torch.randn(shape, **kw)                   # step-size search
    C = 1 if single else chains

    def chunk():
        mom = torch.randn((K, C, dim) if not single else (K, dim), **kw).reshape(K, C, dim)
        if algorithm == "hmc":
            return {"mom": mom, "mh": torch.rand((K, C), **kw)}
        if single:
            treeu = torch.rand((K, max_depth, 2), **kw)[:, None]
            leafu = torch.rand((K, 1 << max_depth), **kw)[:, None]
        else:
            treeu = torch.rand((K, C, max_depth, 2), **kw)
            leafu = torch.rand((K, C, 1 << max_depth), **kw)
        return {"mom": mom, "treeu": treeu, "leafu": leafu}

    for _ in range(-(-warmup // K)):
        chunk()
    parts = [chunk() for _ in range(-(-samples // K))]
    return {k: torch.cat([p[k] for p in parts])[:samples] for k in parts[0]}
