"""GPU commitment MSM: the bucket Pippenger of native/msm_gpu.cu, called as
the XLA custom call "mira_msm_gpu" through jax.ffi.

The library is built from the repo's sources by nvcc (sm_90a) into build/
at first use, or ahead of time with `python -m mira_tpu.ops.cuda_msm`.  A
failed build raises: nothing falls back to another route.  The same
algorithm also builds for the host (native/msm_gpu_host.cpp), which is how
the CPU tests check it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache

import numpy as np

from ..fields.limbs import NUM_LIMBS

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE = os.path.join(_ROOT, "native")
_BUILD = os.path.join(_ROOT, "build")
_SOURCES = ("msm_gpu.cu", "msm_gpu.cuh")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_CURVE_ID = {"bn254": 0, "grumpkin": 1}
_lock = threading.Lock()


def window_bits(n: int) -> int:
    """Pippenger window c for an n-point MSM: 12 at 2^17, 16 at 2^21."""
    return max(4, min(16, n.bit_length() - 6))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("building the CUDA MSM needs nvcc (CUDA toolkit)")


def build_library() -> str:
    """Compile native/msm_gpu.cu (once per source version); returns the .so."""
    import jax.ffi

    h = hashlib.sha1(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_NATIVE, name), "rb") as f:
            h.update(f.read())
    so = os.path.join(_BUILD, f"libmiramsm_gpu-{h.hexdigest()[:12]}.so")
    with _lock:
        if os.path.exists(so):
            return so
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-I", jax.ffi.include_dir(),
               "-I", _NATIVE, os.path.join(_NATIVE, "msm_gpu.cu"), "-o", tmp]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                "building the CUDA MSM failed:\n" + r.stderr[-6000:])
        os.replace(tmp, so)
    return so


@lru_cache(maxsize=1)
def _library():
    import jax.ffi

    lib = ctypes.CDLL(build_library())
    lib.mira_msm_gpu_scratch_bytes.argtypes = [ctypes.c_uint64, ctypes.c_uint32]
    lib.mira_msm_gpu_scratch_bytes.restype = ctypes.c_uint64
    jax.ffi.register_ffi_target(
        "mira_msm_gpu", jax.ffi.pycapsule(lib.MiraMsmGpu), platform="CUDA")
    return lib


@lru_cache(maxsize=None)
def _msm_jit(curve_name: str, n: int):
    import jax
    import jax.numpy as jnp

    c = window_bits(n)
    scratch = int(_library().mira_msm_gpu_scratch_bytes(n, c))
    call = jax.ffi.ffi_call(
        "mira_msm_gpu",
        (jax.ShapeDtypeStruct((3, NUM_LIMBS), jnp.uint32),
         jax.ShapeDtypeStruct((scratch,), jnp.uint8)),
    )

    def run(scalars, X, Y, Z):
        out, _ = call(scalars, X, Y, Z, curve=np.int32(_CURVE_ID[curve_name]),
                      window=np.int32(c))
        return out[0], out[1], out[2]

    return jax.jit(run)


def msm_cuda(scalars, points, curve):
    """scalars: (n, 16) plain limbs; points: (X, Y, Z) Montgomery limb arrays
    of affine points (Z = 1) or identities (Z = 0).  Returns the Jacobian
    triple of (16,) Montgomery limb arrays, like ops/msm.msm."""
    X, Y, Z = points
    return _msm_jit(curve.name, int(scalars.shape[0]))(scalars, X, Y, Z)


# -- host build of the same algorithm (CPU tests) ---------------------------

_HOST_SRC = os.path.join(_NATIVE, "msm_gpu_host.cpp")
_HOST_SO = os.path.join(_NATIVE, "libmiramsm_gpu_host.so")


@lru_cache(maxsize=1)
def _host_library():
    with _lock:
        newest = max(os.path.getmtime(os.path.join(_NATIVE, f))
                     for f in ("msm_gpu_host.cpp", "msm_gpu.cuh"))
        if not os.path.exists(_HOST_SO) or os.path.getmtime(_HOST_SO) < newest:
            tmp = f"{_HOST_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _HOST_SRC,
                 "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, _HOST_SO)
    lib = ctypes.CDLL(_HOST_SO)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mira_msm_gpu_emulate.argtypes = [
        u32p, u32p, u32p, u32p, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_uint32, u32p,
    ]
    lib.mira_msm_gpu_emulate.restype = ctypes.c_int
    lib.mira_msm_gpu_digits.argtypes = [
        u32p, u32p, ctypes.c_uint64, ctypes.c_uint32, u32p, u32p,
    ]
    lib.mira_msm_gpu_digits.restype = None
    return lib


def _u32(a):
    a = np.ascontiguousarray(np.asarray(a), dtype=np.uint32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def msm_emulated(scalars, points, curve, window: int | None = None):
    """Run the GPU algorithm serially on the host; same operands and result
    layout as msm_cuda, returned as numpy arrays."""
    X, Y, Z = points
    n = int(np.asarray(scalars).shape[0])
    c = window or window_bits(n)
    keep = [_u32(a) for a in (scalars, X, Y, Z)]
    out = np.zeros((3, NUM_LIMBS), np.uint32)
    rc = _host_library().mira_msm_gpu_emulate(
        *(p for _, p in keep), n, _CURVE_ID[curve.name], c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc:
        raise ValueError(f"mira_msm_gpu_emulate failed ({rc})")
    return out[0], out[1], out[2]


def digits_emulated(scalars, window: int, identity=None):
    """The kernel's digit pass on the host: (keys, vals), each (W, n).
    key = w * B + |d| - 1 (or W * B for a zero digit or an identity point);
    vals carry the point index and the digit's sign in bit 31."""
    sc, sc_p = _u32(scalars)
    n = sc.shape[0]
    z = np.ones((n, NUM_LIMBS), np.uint32)
    if identity is not None:
        z[np.asarray(identity, bool)] = 0
    z, z_p = _u32(z)
    W = -(-255 // window)
    keys = np.zeros(W * n, np.uint32)
    vals = np.zeros(W * n, np.uint32)
    _host_library().mira_msm_gpu_digits(
        sc_p, z_p, n, window,
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return keys.reshape(W, n), vals.reshape(W, n)


if __name__ == "__main__":
    print(build_library())
