"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``build/ggp_tpu_torch/`` of the checkout, under a
name keyed by a hash of the sources, so an edited source is never served
by a stale library. A failed build raises.

Every wrapper that launches a kernel adds one to its entry of
:data:`LAUNCHES` right where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

__all__ = ["LAUNCHES", "reset_launches", "build", "kernel_fn", "cfg_array",
           "check", "stream_ptr", "scratch", "ptr", "require_cuda", "CFG"]

LAUNCHES = {"vfe_potential": 0, "nuts_chunk": 0, "sgpr_adam_chunk": 0,
            "z_adam_chunk": 0, "mc_potential": 0, "mc_hmc_chunk": 0,
            "mc_nuts_chunk": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# indices of the cfg double array (csrc/vfe_bound.cuh, enum CfgIndex)
CFG = dict(N=0, M=1, D=2, JITTER=3, FLOOR=4, WANT_PRIOR=5, WANT_ZGRAD=6,
           PRIOR=7, DIM=19, MAX_DEPTH=20, K=21, ADAPT=22, TARGET=23,
           ADAPT_MASS=24, LR=25, CLIP=26, MIN_NOISE=27, T0=28, S_ACT=29,
           EPS=30, CHAINS=31, LEAPFROG=32, LEN=33)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "ggp_tpu_torch")
_LIB = None

_P = ctypes.c_void_p
_SIGS = {
    "ggp_vfe_potential": [_P] * 9,
    "ggp_nuts_chunk": [_P] * 18,
    "ggp_sgpr_adam": [_P] * 12,
    "ggp_z_adam": [_P] * 10,
    "ggp_mc_potential": [_P] * 9,
    "ggp_mc_hmc_chunk": [_P] * 17,
    "ggp_mc_nuts_chunk": [_P] * 18,
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out = os.path.join(_BUILD, f"libggp_tpu_torch_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(_BUILD, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
        objs, procs = [], []
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = os.path.join(_BUILD, f"{os.path.basename(src)[:-3]}.{tag}.o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [_nvcc(), *arch, "-c", "-Xcompiler", "-fPIC", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [(p.args[-1], p.communicate()[0], p.returncode) for p in procs]
        failed = [f"{src}:\n{log}" for src, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = out + f".tmp{os.getpid()}"
        res = subprocess.run([_nvcc(), *arch, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        for obj in objs:
            os.remove(obj)
    _LIB = _load(out)
    return _LIB


def _load(path: str) -> ctypes.CDLL:
    lib_ = ctypes.CDLL(path)
    for base, argtypes in _SIGS.items():
        for suf in ("f32", "f64"):
            fn = getattr(lib_, f"{base}_{suf}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib_.ggp_scratch_elems.argtypes = [ctypes.c_int] * 3
    lib_.ggp_scratch_elems.restype = ctypes.c_long
    return lib_


def kernel_fn(base: str, dtype: torch.dtype):
    return getattr(build(), f"{base}_{'f64' if dtype == torch.float64 else 'f32'}")


def cfg_array(**kv) -> ctypes.Array:
    """The kernels' ``cfg`` double array from named entries of :data:`CFG`;
    ``PRIOR`` takes the 12 prior-leaf doubles."""
    a = (ctypes.c_double * CFG["LEN"])()
    for k, v in kv.items():
        if k == "PRIOR":
            for i, x in enumerate(v):
                a[CFG["PRIOR"] + i] = float(x)
        else:
            a[CFG[k]] = float(v)
    return a


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def scratch(n: int, m: int, d: int, extra: int, like: torch.Tensor,
            chains: int = 1) -> torch.Tensor:
    """Global-memory work space of one bound evaluation per chain plus
    ``extra``. The chain count has no cap of its own: where the card cannot
    hold the C areas, the allocation raises ``torch.OutOfMemoryError``."""
    elems = chains * int(build().ggp_scratch_elems(n, m, d)) + extra
    return torch.empty(elems, dtype=like.dtype, device=like.device)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def require_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype`` on
    one device. The kernels take float32 and float64."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} is not float32 or float64")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
