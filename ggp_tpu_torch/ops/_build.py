"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``build/ggp_tpu_torch/`` of the checkout, under a
name keyed by a hash of the sources, so an edited source is never served
by a stale library. A failed build raises.

Every wrapper that launches a kernel adds one to its entry of
:data:`LAUNCHES` right where it launches, and nowhere else. The sampler
kernels take the potential core as a template parameter and have one entry
per core and dtype (``ggp_{kind}_{core}_{f32,f64}``) for the kinds each core
carries (:data:`CORE_KINDS`: the gpr core has no HMC chunk, which no model
runs; the co2 cores a potential, a NUTS chunk and a transition, as the JAX
package runs them); their counters name the core (:func:`launch_key`). The
``"vfe_group"`` entries are the vfe core spread over a group of blocks per
chain (``csrc/vfe_group.cuh``, ``ops/vfe_group.py``), which the vfe wrappers
route to at large n and launch cooperatively; the ``"gpr"`` entries run the
dense core on a group of blocks per chain at every n (``csrc/gpr_bound.cuh``);
the ``"sgpmc_group"`` entries the whitened JointHMC core on a group of blocks
per chain (``csrc/sgpmc_group.cuh``, built in ``csrc/sgpmc_group.cu``), which
the sgpmc wrappers route to at every n: the ``"sgpmc"`` core has no kernel of
its own (:data:`GROUP_ONLY`).
The grouped trainer ``ggp_sgpr_adam_group`` runs the warm start's Adam steps
on the grouped vfe core (``csrc/sgpr_adam.cu``), ``ggp_sgpmc_warm_group``
the JointHMC warm start's on the grouped sgpmc core (``csrc/sgpmc_warm.cu``).
Each source is compiled with ``-Xptxas -v``;
the compiler's report of registers, shared memory and spills, and the
seconds each source took to compile, are kept beside the library
(:func:`ptxas_report`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

__all__ = ["LAUNCHES", "reset_launches", "launch_key", "build", "kernel_fn",
           "cfg_array", "check", "stream_ptr", "scratch", "ptr",
           "require_cuda", "require_kind", "ptxas_report", "CFG", "CORE_KINDS", "GROUPED",
           "GROUP_ONLY"]

# what a sampler wrapper launches, per core: one row or chain, or C of them
_SAMPLER_KINDS = ("potential", "nuts_chunk", "hmc_chunk", "mc_potential",
                  "mc_nuts_chunk", "mc_hmc_chunk")
_CO2_KINDS = ("potential", "nuts_chunk", "nuts_transition")
_NUTS_KINDS = ("potential", "nuts_chunk", "mc_potential", "mc_nuts_chunk")
CORE_KINDS = {"vfe": _SAMPLER_KINDS + ("nuts_transition",),
              "gpr": _NUTS_KINDS, "co2_m32": _CO2_KINDS, "co2_rbf": _CO2_KINDS,
              "vfe_group": _SAMPLER_KINDS, "sgpmc_group": _SAMPLER_KINDS}
# the cores whose kernels are those of their group at every n
GROUP_ONLY = {"sgpmc": "sgpmc_group"}
# csrc vfe_potential.cu ggp_scratch_elems (the one-block cores)
_CORE_ID = {"vfe": 0, "co2_m32": 3, "co2_rbf": 4}
# the cores that run a chain on a group of blocks, launched cooperatively
GROUPED = ("vfe_group", "sgpmc_group", "gpr")
# the grouped kernels' occupancy queries, ggp_{kind}_{core}_occupancy
_OCCUPANCY_KINDS = ("potential", "nuts_chunk", "hmc_chunk")


def launch_key(core: str, kind: str) -> str:
    """The :data:`LAUNCHES` key of a sampler wrapper of ``core``; the vfe
    core keeps the names of the first slices, and the two co2 cores (noise
    component Matern32 or RBF) share their counters."""
    fam = "co2" if core.startswith("co2") else core
    if kind == "nuts_transition":
        return f"{kind}_{fam}"
    if core == "vfe":
        return "vfe_potential" if kind == "potential" else kind
    return f"{fam}_{kind}"


LAUNCHES = {**{launch_key(c, k): 0 for c, kinds in CORE_KINDS.items() for k in kinds},
            "sgpr_adam_chunk": 0, "sgpr_adam_group": 0, "z_adam_stream": 0,
            "sgpmc_warm_group": 0,
            "svi_chunk": 0, "bsvgp_chunk": 0, "svi_softmax_chunk": 0,
            "vfe_stats_fwd": 0, "vfe_stats_bwd": 0}


def require_kind(core: str, kind: str) -> None:
    """Raise unless the kernels carry sampler ``kind`` for ``core`` (for a
    core of :data:`GROUP_ONLY`, its group's)."""
    if kind not in CORE_KINDS.get(GROUP_ONLY.get(core, core), ()):
        raise ValueError(f"no {kind} kernel for the {core!r} core")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# indices of the cfg double array (csrc/vfe_bound.cuh, enum CfgIndex); PRIOR
# holds 12 doubles, QUAD the 20 Gauss-Hermite nodes and then their 20
# weights, LANE_PRIOR the co2 core's 11 prior leaves (44 doubles)
CFG = dict(N=0, M=1, D=2, JITTER=3, FLOOR=4, WANT_PRIOR=5, WANT_ZGRAD=6,
           PRIOR=7, DIM=19, MAX_DEPTH=20, K=21, ADAPT=22, TARGET=23,
           ADAPT_MASS=24, LR=25, CLIP=26, MIN_NOISE=27, T0=28, S_ACT=29,
           EPS=30, CHAINS=31, LEAPFROG=32, STAGES=33, NB=34, NUM_DATA=35,
           LIK=36, LATENTS=37, NHALF=38, PRIOR_VAR=39, QUAD=40, LANE_PRIOR=80,
           GROUP=124, LEN=125)
_LIST_ENTRIES = ("PRIOR", "QUAD", "LANE_PRIOR")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "ggp_tpu_torch")
_LIB = None

_P = ctypes.c_void_p
# the sampler entries ggp_{kind}_{core}, each serving one row or chain and
# C of them (kinds "mc_*"), and their argument counts
_NARGS = {"potential": 9, "nuts_chunk": 18, "hmc_chunk": 17, "nuts_transition": 16}
_SIGS = {
    **{f"ggp_{k}_{c}": [_P] * n for c, kinds in CORE_KINDS.items()
       for k, n in _NARGS.items() if k in kinds},
    "ggp_sgpr_adam": [_P] * 12,
    "ggp_sgpr_adam_group": [_P] * 12,
    "ggp_z_adam_stream": [_P] * 11,
    "ggp_sgpmc_warm_group": [_P] * 12,
    "ggp_svi_chunk": [_P] * 19,
    "ggp_svi_softmax_chunk": [_P] * 20,
    "ggp_bsvgp_chunk": [_P] * 23,
    "ggp_vfe_stats_fwd": [_P] * 11,
    "ggp_vfe_stats_bwd": [_P] * 14,
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
        t0 = time.perf_counter()
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = os.path.join(_BUILD, f"{os.path.basename(src)[:-3]}.{tag}.o")
            objs.append(obj)
            with open(obj + ".log", "w") as log:    # a file, not a pipe: nothing waits on a reader
                procs.append((src, obj, subprocess.Popen(
                    [_nvcc(), *arch, "-Xptxas", "-v", "-c", "-Xcompiler", "-fPIC",
                     "-o", obj, src], stdout=log, stderr=subprocess.STDOUT)))
        secs = {}
        while len(secs) < len(procs):
            for src, _, p in procs:
                if src not in secs and p.poll() is not None:
                    secs[src] = time.perf_counter() - t0
            time.sleep(0.05)
        logs = []
        for src, obj, p in procs:
            with open(obj + ".log") as f:
                logs.append((src, f.read(), p.returncode))
            os.remove(obj + ".log")
        failed = [f"{src}:\n{log}" for src, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        with open(out[:-3] + ".ptxas.txt", "w") as f:
            f.writelines(f"== {os.path.basename(src)} ({secs[src]:.1f} s)\n{log}"
                         for src, log, _ in logs)
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
    lib_.ggp_scratch_elems.argtypes = [ctypes.c_int] * 4
    lib_.ggp_scratch_elems.restype = ctypes.c_long
    lib_.ggp_svi_scratch_elems.argtypes = [ctypes.c_int] * 4
    lib_.ggp_svi_scratch_elems.restype = ctypes.c_long
    lib_.ggp_z_adam_stream_elems.argtypes = [ctypes.c_int] * 6
    lib_.ggp_z_adam_stream_elems.restype = ctypes.c_long
    for name in ("ggp_group_scratch_elems", "ggp_sgpmc_group_scratch_elems"):
        getattr(lib_, name).argtypes = [ctypes.c_int] * 6
        getattr(lib_, name).restype = ctypes.c_long
    lib_.ggp_gpr_scratch_elems.argtypes = [ctypes.c_int] * 5
    lib_.ggp_gpr_scratch_elems.restype = ctypes.c_long
    for name in ("ggp_sgpr_adam_group_elems", "ggp_sgpmc_warm_group_elems"):
        getattr(lib_, name).argtypes = [ctypes.c_int] * 5
        getattr(lib_, name).restype = ctypes.c_long
    for name in [f"ggp_{kind}_{core}_occupancy" for core in GROUPED
                 for kind in _OCCUPANCY_KINDS if kind in CORE_KINDS[core]] \
            + ["ggp_sgpr_adam_vfe_group_occupancy", "ggp_sgpmc_warm_sgpmc_group_occupancy"]:
        fn = getattr(lib_, name)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib_


def ptxas_report() -> str:
    """What ``-Xptxas -v`` printed when the loaded library was built:
    registers, shared memory and spills of every kernel instantiation."""
    with open(build()._name[:-3] + ".ptxas.txt") as f:
        return f.read()


def kernel_fn(base: str, dtype: torch.dtype):
    return getattr(build(), f"{base}_{'f64' if dtype == torch.float64 else 'f32'}")


def cfg_array(**kv) -> ctypes.Array:
    """The kernels' ``cfg`` double array from named entries of :data:`CFG`;
    ``PRIOR`` takes the 12 prior-leaf doubles, ``QUAD`` the 40 quadrature
    doubles, ``LANE_PRIOR`` the co2 core's 44."""
    a = (ctypes.c_double * CFG["LEN"])()
    for k, v in kv.items():
        for i, x in enumerate(v if k in _LIST_ENTRIES else [v]):
            a[CFG[k] + i] = float(x)
    return a


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def scratch(n: int, m: int, d: int, extra: int, like: torch.Tensor,
            chains: int = 1, core: str = "vfe") -> torch.Tensor:
    """Global-memory work space of one evaluation of ``core`` per chain plus
    ``extra``. The chain count has no cap of its own: where the card cannot
    hold the C areas, the allocation raises ``torch.OutOfMemoryError``."""
    elems = chains * int(build().ggp_scratch_elems(_CORE_ID[core], n, m, d)) + extra
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
