"""Hopper Viterbi kernel (``viterbi_cuda.cu``) behind a JAX FFI call.

One warp decodes one trellis lane: 64 path metrics, two per thread,
exchanged by shuffles; decisions packed by ballots into shared memory;
traceback in the same kernel. The arithmetic is the plain scan's
(``fec.conv._trellis_scan``), so both give the same bits.

The CUDA source is compiled with ``nvcc`` into ``ops/_build/`` (ignored by
git) the first time a GPU trace needs it; the file name carries a hash of
the source, so an edited kernel is rebuilt. The kernel has no CPU form: on
other backends ``trellis_impl`` picks the scan.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "viterbi_cuda.cu")
_BUILD = os.path.join(_HERE, "_build")
_TARGET = "orion_viterbi"

# one warp's decision words (8 bytes per step) must fit one block's shared
# memory (232448 bytes on Hopper)
MAX_KERNEL_STEPS = 232448 // 8
MAX_KERNEL_K = 7

_registered = False


def trellis_impl(n_steps: int, K: int) -> str:
    """Which implementation decodes a trellis of ``n_steps`` steps and
    constraint length ``K``: ``"cuda"`` (this kernel) on a GPU when the
    trellis fits its shared memory and register layout, else ``"scan"``."""
    if (jax.default_backend() == "gpu" and 0 < n_steps <= MAX_KERNEL_STEPS
            and K <= MAX_KERNEL_K):
        return "cuda"
    return "scan"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library() -> str:
    """Compile the kernel for sm_90a (once per source version); returns
    the shared library's path."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(_BUILD, f"viterbi_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def _register() -> None:
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(build_library())
    jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.OrionViterbi),
                                platform="CUDA")
    _registered = True


def trellis_cuda(l0, l1, pm0, K: int, g0: int, g1: int, terminated: bool):
    """(L, T) LLR planes and (L, 2^(K-1)) initial metrics → (L, T) uint8
    decoded bits, on the GPU. Same contract as ``fec.conv._trellis_scan``."""
    _register()
    l0 = jnp.asarray(l0, jnp.float32)
    L, T = l0.shape
    if L == 0:
        return jnp.zeros((0, T), jnp.uint8)
    call = jax.ffi.ffi_call(_TARGET, jax.ShapeDtypeStruct((L, T), jnp.uint8))
    return call(l0, jnp.asarray(l1, jnp.float32),
                jnp.asarray(pm0, jnp.float32),
                K=np.int32(K), g0=np.int32(g0), g1=np.int32(g1),
                terminated=np.int32(bool(terminated)))
