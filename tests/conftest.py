"""Test configuration: a virtual 8-device CPU mesh, so multi-device
sharding paths run without accelerators.

Tests that need a GPU carry the `gpu` marker and the `gpu` fixture; they
skip on the CPU.  On a GPU host run them with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os
import sys

if os.environ.get("JAX_PLATFORMS") != "cuda":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_max_isa" not in flags:
    # The VM live-migrates between physical hosts MID-PROCESS; /proc/cpuinfo
    # reflects the boot host while LLVM re-detects via CPUID, so host-tuned
    # XLA:CPU code (and persisted AOT cache entries) can hit a different
    # micro-architecture and crash (observed: segfaults in cache
    # read/write/compile paths of long suite runs; "machine type ...
    # doesn't match" AOT loader warnings).  Cap codegen at AVX2 — portable
    # across the fleet.
    flags = (flags + " --xla_cpu_max_isa=AVX2").strip()
os.environ["XLA_FLAGS"] = flags

# persistent compile cache: the big limb-arithmetic graphs (MSM bodies) take
# minutes to compile on XLA:CPU; pay once per machine
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from mira_tpu.utils.compile_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

os.environ.setdefault("MIRA_NATIVE_ENCODE_MIN", "1")

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a GPU host)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    A single long pytest process accumulates hundreds of live XLA:CPU
    executables; past a cumulative threshold, the NEXT big
    compile/serialize/deserialize segfaults inside XLA (observed repeatedly
    at the same suite position regardless of which test lands there; every
    test passes standalone).  Dropping the jit caches per module keeps the
    live-executable volume bounded; the persistent disk cache makes the
    recompiles cheap."""
    yield
    try:
        import jax

        jax.clear_caches()
    except Exception:
        pass
