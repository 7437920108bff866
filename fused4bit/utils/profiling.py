"""Profiling / tracing hooks.

SURVEY.md §5: the reference's only observability is CUDA-event timing plus a
hand-rolled roofline. Here: keep the roofline (`fused4bit.utils.roofline`)
and add `jax.profiler` trace capture for xprof/tensorboard analysis, gated
so it degrades gracefully where the backend can't trace.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator

import jax

__all__ = ["trace", "annotate", "Stopwatch"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace into `log_dir` (view with tensorboard).

    No-ops with a warning if the backend refuses to trace.
    """
    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception as exc:  # pragma: no cover - backend dependent
        print(f"[profiling] trace unavailable: {exc}")
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def annotate(name: str):
    """Named region that shows up in profiler traces (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


class Stopwatch:
    """Cheap wall-clock section timer with a report, for harness scripts."""

    def __init__(self) -> None:
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        lines = [
            f"{name:<30} {secs:8.3f}s {100*secs/total:5.1f}%"
            for name, secs in sorted(
                self.sections.items(), key=lambda kv: -kv[1]
            )
        ]
        out = "\n".join(lines)
        print(out)
        return out
