"""Global configuration of the PyTorch port.

Counterpart of ``ggp_tpu/config.py``: the canonical seed, the jitter
policy and the experiments' log directory. Importing this module turns TF32 off for matrix products and
convolutions — the counterpart of the JAX package's
``jax_default_matmul_precision="highest"``: Gram matrices formed in TF32
lose positive-definiteness.
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BASE_SEED = 173          # split / data seed of the reference (utils/config.py:14)
# the experiment drivers' JSON and CSV logs: logs/ of the checkout
LOG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "logs")


def default_jitter(dtype: torch.dtype) -> float:
    """Diagonal jitter added before every factorisation: 1e-8 in float64,
    1e-5 in float32 (``ggp_tpu/config.py`` ``default_jitter``). The sparse
    models scale it by max(sf2, 1) before each Kmm factorisation (relative);
    GPR_HMC adds it to K + s2 I as it is (absolute)."""
    return 1e-8 if dtype == torch.float64 else 1e-5


def resolve_device(name: str, device) -> torch.device:
    """The device of model ``name``: the card unless ``device`` says
    otherwise. The card without CUDA raises; nothing falls back to the CPU
    quietly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name} runs on the card by default and no CUDA device is "
                           "available; pass device='cpu' for the plain CPU versions")
    return device
