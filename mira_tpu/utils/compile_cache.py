"""Where JAX keeps its persistent compile cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and the cache
lives exactly there: nothing here overrides it.  Otherwise the cache is the
fixed `.jax_cache/` of the checkout (a fixed path, because the path is part
of what makes an entry hit).

On the CPU backend the directory gets one sub-directory per host CPU:
JAX's cache key does NOT include the host CPU's feature set, but XLA:CPU
emits AOT code tuned to it, and loading another machine's entry fails with
"Machine type used for XLA:CPU compilation doesn't match the machine type
for execution ... SIGILL".  The sub-directory is a digest of /proc/cpuinfo.
"""

from __future__ import annotations

import hashlib
import os
import re

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def machine_fingerprint() -> str:
    """Digest of CPU flags AND family/model/stepping/name.

    Flags alone are not enough: two hosts can expose identical flag lists
    but different model numbers, and LLVM's -mcpu tuning (e.g.
    prefer-no-gather) differs — the AOT result still mismatches."""
    try:
        with open("/proc/cpuinfo") as f:
            txt = f.read()
        keys = ("flags", "model name", "cpu family", "model", "stepping",
                "vendor_id")
        parts = []
        for key in keys:
            vals = sorted(set(re.findall(
                rf"^{re.escape(key)}\s*:\s*(.*)$", txt, re.M)))
            parts.append(f"{key}={';'.join(vals)}")
        if not any(parts):
            return "unknown"
        return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:12]
    except OSError:  # pragma: no cover
        return "unknown"


def machine_cache_dir(base: str) -> str:
    path = os.path.join(os.path.abspath(base), machine_fingerprint())
    os.makedirs(path, exist_ok=True)
    return path


def enable_persistent_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = DEFAULT_DIR
    if jax.default_backend() == "cpu":
        path = machine_cache_dir(DEFAULT_DIR)
    else:
        os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
