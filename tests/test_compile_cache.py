"""Persistent compile cache placement (utils/compile_cache.py).

JAX_COMPILATION_CACHE_DIR, when set, is used exactly; otherwise the fixed
.jax_cache/ of the checkout, per host CPU on the CPU backend (cross-machine
XLA:CPU AOT cache loads SIGILL: the cache key omits host CPU features).
"""

import json
import os
import subprocess
import sys

from mira_tpu.utils.compile_cache import (
    DEFAULT_DIR,
    machine_cache_dir,
    machine_fingerprint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, os, sys
sys.path.insert(0, {root!r})
import jax, jax.numpy as jnp
from mira_tpu.utils.compile_cache import enable_persistent_cache
d = enable_persistent_cache()
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(8.0)).block_until_ready()
print(json.dumps({{"returned": d, "config": jax.config.jax_compilation_cache_dir}}))
"""


def _probe(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=ROOT)],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_fingerprint_stable_and_hexlike():
    a, b = machine_fingerprint(), machine_fingerprint()
    assert a == b
    assert a == "unknown" or (len(a) == 12 and int(a, 16) >= 0)


def test_cache_dir_created_under_fingerprint(tmp_path):
    d = machine_cache_dir(str(tmp_path / "cache"))
    assert os.path.isdir(d)
    assert os.path.basename(d) == machine_fingerprint()


def test_env_dir_used_exactly(tmp_path):
    """With the variable set, entries land in that directory itself (no
    sub-directory) and the default directory is never configured."""
    d = str(tmp_path / "jaxcache")
    out = _probe({
        "JAX_COMPILATION_CACHE_DIR": d,
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0",
    })
    assert out == {"returned": d, "config": d}
    entries = os.listdir(d)
    assert entries, "no compiled entry was written"
    assert all(os.path.isfile(os.path.join(d, e)) for e in entries)


def test_default_dir_without_env():
    out = _probe({})
    want = os.path.join(DEFAULT_DIR, machine_fingerprint())
    assert out == {"returned": want, "config": want}
    assert DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
