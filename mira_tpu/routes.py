"""One route table: (operation, platform) -> implementation.

Every choice of implementation that depends on the backend reads this table,
so the routes of a platform can be read in one place:

- ``msm``: commitment MSMs.  ``native`` is the C++ host Pippenger
  (native/msm.cpp); ``cuda`` the bucket Pippenger of native/msm_gpu.cu
  through jax.ffi; ``xla`` the lane double-and-add of ops/msm.py.
- ``fold_eval``: cross-term (fold) and decider gate evaluation.  ``native``
  is the C++ row VM (polynomial/native_evaluator.py); ``jnp`` the device
  loop over the same op list (polynomial/fold_evaluator.py), which also
  serves every mesh.
- ``ntt``: ``xla``, the reshape-stage NTT of ops/ntt.py.
- ``sponge``: batched Poseidon hashes; ``xla`` is ops/poseidon_device.py.
- ``encode``: Montgomery encode/decode of large batches.  ``native`` is the
  4x64 host kernel (fields/native64.py); ``device`` the 16-bit CIOS on the
  device.
- ``witness``: tape replay of the step circuit.  ``packed`` keeps the
  witness on the host (table/packed.PackedWitness); ``device`` keeps it on
  the device and commits by deltas (table/packed.DeviceWitness).

A platform that is not in the table is an error, never a default.
"""

from __future__ import annotations

import contextlib

ROUTES = {
    "msm": {"cpu": "native", "gpu": "cuda"},
    "fold_eval": {"cpu": "native", "gpu": "jnp"},
    "ntt": {"cpu": "xla", "gpu": "xla"},
    "sponge": {"cpu": "xla", "gpu": "xla"},
    "encode": {"cpu": "native", "gpu": "device"},
    "witness": {"cpu": "packed", "gpu": "device"},
}

# every implementation an operation has, routed or not (for `forced`)
IMPLS = {
    "msm": ("native", "cuda", "xla"),
    "fold_eval": ("native", "jnp"),
    "ntt": ("xla",),
    "sponge": ("xla",),
    "encode": ("native", "device"),
    "witness": ("packed", "device"),
}

_forced: dict = {}


def platform() -> str:
    import jax

    return jax.default_backend()


def route(op: str, platform_name: str | None = None) -> str:
    """The implementation of `op` on `platform_name` (default: JAX's
    default backend)."""
    if op not in ROUTES:
        raise ValueError(f"unknown operation {op!r}")
    if op in _forced:
        return _forced[op]
    plat = platform_name or platform()
    try:
        return ROUTES[op][plat]
    except KeyError:
        raise ValueError(
            f"no route for {op!r} on platform {plat!r}; known platforms: "
            f"{sorted(ROUTES[op])}"
        ) from None


@contextlib.contextmanager
def forced(op: str, impl: str):
    """Run a block with `op` on `impl` whatever the platform: for measuring
    one route against another, and for tests."""
    if impl not in IMPLS.get(op, ()):
        raise ValueError(f"unknown route {op}={impl}")
    old = _forced.get(op)
    _forced[op] = impl
    try:
        yield
    finally:
        if old is None:
            _forced.pop(op, None)
        else:
            _forced[op] = old


def table(platform_name: str | None = None) -> dict:
    """{op: implementation} for one platform (what chip_smoke.py prints)."""
    return {op: route(op, platform_name) for op in ROUTES}
