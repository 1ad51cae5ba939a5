"""Span tracing / profiling — the native analog of the reference's pervasive
`tracing` spans plus its span-tree profiling pipeline
(/root/reference/src/... `#[instrument]` everywhere;
/root/reference/.scripts/build_profiling.py reconstructs per-span busy time).

Usage:
    from mira_tpu.utils.tracing import span, instrument, report

    with span("fold_step"):
        with span("commit"):
            ...

    @instrument
    def prove(...): ...

    print(report(min_runtime=0.1))   # span tree with busy/total times

Env: MIRA_TRACE=json emits one JSON line per span CLOSE (enter/close events,
like the reference's FmtSpan::ENTER|CLOSE JSON logs); MIRA_TRACE=off disables
collection.  When running under jit the span also opens a
`jax.profiler.TraceAnnotation`-style named scope if jax is importable, so
device profiles line up with host spans.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import threading
import time
from typing import List, Optional


class _Span:
    __slots__ = ("name", "start", "end", "children", "parent")

    def __init__(self, name: str, parent: Optional["_Span"]):
        self.name = name
        self.start = time.perf_counter()
        self.end: Optional[float] = None
        self.children: List[_Span] = []
        self.parent = parent

    @property
    def total(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    @property
    def busy(self) -> float:
        return self.total - sum(c.total for c in self.children)


class _Collector(threading.local):
    def __init__(self):
        self.roots: List[_Span] = []
        self.current: Optional[_Span] = None


_state = _Collector()


def _mode() -> str:
    return os.environ.get("MIRA_TRACE", "collect")


@contextlib.contextmanager
def span(name: str):
    if _mode() == "off":
        yield
        return
    s = _Span(name, _state.current)
    if _state.current is None:
        _state.roots.append(s)
    else:
        _state.current.children.append(s)
    _state.current = s
    try:
        import jax

        scope = jax.named_scope(name)
    except Exception:  # pragma: no cover
        scope = contextlib.nullcontext()
    try:
        with scope:
            yield s
    finally:
        s.end = time.perf_counter()
        _state.current = s.parent
        if _mode() == "json":
            print(
                json.dumps(
                    {
                        "span": name,
                        "enter": s.start,
                        "close": s.end,
                        "busy_s": round(s.busy, 6),
                        "total_s": round(s.total, 6),
                    }
                ),
                file=sys.stderr,
            )


def instrument(fn):
    """Decorator analog of the reference's #[instrument]."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


def reset():
    _state.roots = []
    _state.current = None


def report(min_runtime: float = 0.0) -> str:
    """Render the collected span tree (per-span busy/total), dropping spans
    faster than min_runtime — the build_profiling.py --min-runtime filter."""
    lines: List[str] = []

    def walk(s: _Span, depth: int):
        if s.total < min_runtime:
            return
        lines.append(
            f"{'  ' * depth}{s.name}: total {s.total:.3f}s busy {s.busy:.3f}s"
        )
        for c in s.children:
            walk(c, depth + 1)

    for r in _state.roots:
        walk(r, 0)
    return "\n".join(lines)


def aggregate(min_runtime: float = 0.0) -> str:
    """Per-span-name aggregation (count, total busy, total wall) — the
    analog of the reference's .scripts/analyze_profiling.py, which sums
    busy time per span name across the tree."""
    stats = {}

    def walk(s: _Span):
        if s.total >= min_runtime:
            c, b, t = stats.get(s.name, (0, 0.0, 0.0))
            stats[s.name] = (c + 1, b + s.busy, t + s.total)
        for ch in s.children:
            walk(ch)

    for r in _state.roots:
        walk(r)
    lines = [
        f"{name}: n={c} busy {b:.3f}s total {t:.3f}s"
        for name, (c, b, t) in sorted(
            stats.items(), key=lambda kv: -kv[1][1]
        )
    ]
    return "\n".join(lines)


def memory_report() -> str:
    """Host peak RSS + per-device memory stats — the analog of the
    reference's dhat heap profiling feature (examples/groth16/main.rs:1-3,
    Cargo.toml dhat-heap); device memory stats come from the PJRT
    allocator."""
    import resource

    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    lines = [f"host peak RSS: {peak_kb / 1048576:.2f} GB"]
    try:
        import jax

        for d in jax.local_devices():
            stats = d.memory_stats() or {}
            used = stats.get("bytes_in_use", 0)
            peak = stats.get("peak_bytes_in_use", 0)
            limit = stats.get("bytes_limit", 0)
            lines.append(
                f"{d.platform}:{d.id} in_use {used / 1048576:.1f} MB "
                f"peak {peak / 1048576:.1f} MB limit {limit / 1048576:.1f} MB"
            )
    except Exception:  # pragma: no cover
        pass
    return "\n".join(lines)
