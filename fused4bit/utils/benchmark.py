"""Benchmark timing utilities.

Counterpart of the reference's harness plumbing
(`benchmark/moe_grouped_gemm/utils.py:11-60` — BenchmarkResult
dataclass + warmup/sync `timer_ms`). Two timing modes:

* :func:`time_fn` — wall-clock over repeated dispatches with warmup and a
  final ``block_until_ready`` (the `torch.cuda.Event` analogue,
  `benchmark/run_benchmark.py:93-104`).
* :func:`time_fn_scan` — wraps the op in an on-device ``lax.scan`` loop inside
  a single jit call, so per-call host dispatch overhead is amortized away.

For per-kernel time, prefer :mod:`fused4bit.utils.device_profile`
(profiler-exported device durations): wall-clock protocols include host
dispatch. The wall-clock timers remain the right tool for measuring what a
HOST-DRIVEN serving step pays end to end.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "BenchmarkResult", "time_fn", "time_fn_scan", "time_fn_slope",
    "time_chain_slope", "print_table",
]


@dataclasses.dataclass
class BenchmarkResult:
    """One benchmark measurement (reference `utils.py:11-27`)."""

    name: str
    mean_ms: float
    std_ms: float = 0.0
    num_tokens: int = 0
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def tokens_per_second(self) -> float:
        if self.num_tokens == 0 or self.mean_ms == 0:
            return 0.0
        return self.num_tokens / (self.mean_ms / 1e3)


def time_fn(fn: Callable[[], jax.Array], *, warmup: int = 5, iters: int = 50) -> float:
    """Mean wall-clock seconds per call (includes dispatch overhead)."""
    for _ in range(warmup):
        out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def time_fn_scan(
    fn: Callable[..., jax.Array],
    x: jax.Array,
    *,
    consts=(),
    iters: int = 50,
    warmup: int = 2,
    repeats: int = 5,
) -> float:
    """Mean device seconds per application of ``fn`` measured inside one jit.

    Chains ``iters`` applications with a data dependence (each step consumes a
    scalar derived from the previous output) so XLA cannot elide or overlap
    them away, then divides total wall time of the single dispatch by
    ``iters``.

    ``consts``: extra pytrees passed through the jit boundary to
    ``fn(x, *consts)``. Pass big weight arrays HERE rather than closing over
    them — a jit-captured device array is lowered as a literal HLO constant,
    which on remote-compile platforms ships the whole tensor in the compile
    request (a 940 MB bf16 weight = HTTP 413 and minutes-long uploads).
    """

    @jax.jit
    def loop(x0, *cs):
        def body(carry, _):
            # Real (but numerically negligible) data dependence: XLA cannot
            # hoist fn out of the loop or fold the carry away. The multiplier
            # MUST be representable (nonzero) in the carrier dtype: 1e-30
            # rounds to exactly 0 in bf16 at trace time, and a *0 dependence
            # lets XLA fold integer compute chains to nothing (floats survive
            # only because x*0 isn't foldable under possible NaNs).
            # Nonlinear input mix: for a LINEAR fn, (x0 + eps) @ W
            # distributes into loop-invariant dots + scalar combos and XLA
            # hoists the whole weight stream out of the loop (observed: a
            # 90 MB bf16 dot "measuring" 0.0 ms). sin(x0 + eps) (XOR for
            # integer carriers) cannot be factored out.
            if jnp.issubdtype(jnp.result_type(x0), jnp.integer):
                xi = x0 ^ carry.astype(x0.dtype)
            else:
                xi = jnp.sin(x0 + carry)
            y = fn(xi, *cs)
            # The dependence must cover the WHOLE output NON-LINEARLY:
            # depending on a single element lets XLA strength-reduce a dot to
            # the one row/column that element needs, and a plain sum(dot)
            # rewrites to dot-of-sums (both observed: a 470 MB matmul
            # "measured" at 0.003 ms). abs() blocks the algebraic rewrite;
            # the reduction's cost (one pass over the output) is part of any
            # honest number anyway.
            y0 = jnp.sum(jnp.abs(jnp.real(y)))
            if jnp.issubdtype(jnp.result_type(x0), jnp.integer):
                # integer carrier: parity (0/1) — any float epsilon would
                # round to 0 in the cast and re-open the fold
                dep = (y0.astype(jnp.int32) % 2).astype(x0.dtype)
            else:
                dep = (jnp.tanh(y0) * jnp.asarray(1e-6, jnp.float32)).astype(
                    x0.dtype
                )
            return dep, None

        c, _ = jax.lax.scan(body, jnp.zeros((), x0.dtype), None, length=iters)
        return c

    import numpy as _np

    # Warmup ends in a HOST FETCH, draining any queued work:
    # block_until_ready can return before execution completes for XLA-only
    # programs on this backend (observed: 0.1 ms "wait" hiding 129 s of
    # queued compute); fetching the tiny carry scalar is a true barrier.
    for _ in range(warmup):
        _np.asarray(loop(x, *consts))
    times = []
    for r in range(repeats):
        # fresh input per repeat — identical repeated requests can be served
        # anomalously fast on shared/virtualized backends
        xr = x + jnp.asarray(1 + (r % 2), x.dtype)
        t0 = time.perf_counter()
        _np.asarray(loop(xr, *consts))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] / iters


def time_fn_slope(
    fn: Callable[..., jax.Array],
    x: jax.Array,
    *,
    consts=(),
    iters: int = 8,
    repeats: int = 5,
    warmup: int = 1,
    chain: int = 8,
) -> float:
    """TRUE per-op seconds via the two-point slope method.

    This platform charges a large FIXED cost per scan iteration (~2.7-3.6 ms
    measured — virtualized-runtime bookkeeping), so `time_fn_scan` numbers
    are op_time + overhead. Chaining `chain` dependency-linked applications
    of ``fn`` inside each scan step amortizes that overhead; the slope
    between 1-op and `chain`-op steps isolates the op:

        per_op = (t_step(chain) - t_step(1)) / (chain - 1)

    Measured example: a 64 MB Pallas stream reads 3.77 ms/step at chain=1
    but slopes at ~0.15 ms/op — ~430 GB/s true rate vs the ~17 GB/s the
    naive number implies.
    """
    import numpy as _np

    def step_time(reps):
        @jax.jit
        def loop(x0, *cs):
            def body(carry, _):
                dep = carry
                for _r in range(reps):
                    if jnp.issubdtype(jnp.result_type(x0), jnp.integer):
                        xi = x0 ^ dep.astype(x0.dtype)
                    else:
                        xi = jnp.sin(x0 + dep)  # nonlinear mix, see above
                    y = fn(xi, *cs)
                    y0 = jnp.sum(jnp.abs(jnp.real(y)))
                    if jnp.issubdtype(jnp.result_type(x0), jnp.integer):
                        dep = (y0.astype(jnp.int32) % 2).astype(x0.dtype)
                    else:
                        dep = (
                            jnp.tanh(y0) * jnp.asarray(1e-6, jnp.float32)
                        ).astype(x0.dtype)
                return dep, None

            c, _ = jax.lax.scan(
                body, jnp.zeros((), x0.dtype), None, length=iters
            )
            return c

        for _ in range(warmup):
            _np.asarray(loop(x, *consts))
        times = []
        for r in range(repeats):
            xr = x + jnp.asarray(1 + (r % 2), x.dtype)
            t0 = time.perf_counter()
            _np.asarray(loop(xr, *consts))
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2] / iters

    t1 = step_time(1)
    tc = step_time(chain)
    return max((tc - t1) / (chain - 1), 1e-9)


def time_chain_slope(
    step_fn: Callable,
    x: jax.Array,
    weight_sets,
    *,
    p_small: int = 1,
    p_large: Optional[int] = None,
    iters: int = 16,
    repeats: int = 5,
    warmup: int = 1,
) -> float:
    """Per-application seconds of ``step_fn`` via DISTINCT-weights chaining.

    The `time_fn_slope` chain re-applies one op to its own output, which
    leaves ops under ~0.5 ms inside this platform's dispatch jitter and —
    for weight-streaming ops — lets the runtime serve the SAME weight
    stream repeatedly (suspiciously-fast slopes observed: an int8 matmul
    "measuring" 4.4 TB/s). This variant chains ``step_fn(y, weight_sets[i])``
    across *distinct* weight pytrees — a real multi-layer network — so
    every link streams different bytes:

        per_layer = (t_step(p_large) - t_step(p_small)) / (p_large - p_small)

    ``step_fn(y, ws) -> y'`` must preserve y's shape (e.g. an up-proj/
    down-proj pair). A nonlinearity is applied to y between links (and the
    scan carry is mixed in nonlinearly) so XLA cannot compose adjacent
    linear links or hoist any of them.
    """
    import numpy as _np

    p_large = p_large if p_large is not None else len(weight_sets)
    if p_large > len(weight_sets):
        raise ValueError(f"p_large={p_large} > {len(weight_sets)} weight sets")

    def step_time(p):
        sets = tuple(weight_sets[:p])

        @jax.jit
        def loop(x0, *ws):
            def body(carry, _):
                y = jnp.sin(x0 + carry)
                for w in ws:
                    y = step_fn(y, w)
                    # nonlinear inter-link mix: adjacent linear links must
                    # not be composable into one matmul
                    y = jnp.sin(y)
                y0 = jnp.sum(jnp.abs(y))
                dep = (jnp.tanh(y0) * jnp.asarray(1e-6, jnp.float32)).astype(
                    x0.dtype
                )
                return dep, None

            c, _ = jax.lax.scan(body, jnp.zeros((), x0.dtype), None, length=iters)
            return c

        for _ in range(warmup):
            _np.asarray(loop(x, *sets))
        times = []
        for r in range(repeats):
            xr = x + jnp.asarray(1 + (r % 2), x.dtype)
            t0 = time.perf_counter()
            _np.asarray(loop(xr, *sets))
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2] / iters

    ts = step_time(p_small)
    tl = step_time(p_large)
    return max((tl - ts) / (p_large - p_small), 1e-9)


def print_table(results: List[BenchmarkResult], baseline: Optional[str] = None) -> str:
    """Render results as a table (reference `utils.py:143-162`)."""
    base = None
    if baseline is not None:
        for r in results:
            if r.name == baseline:
                base = r.mean_ms
    lines = [
        f"{'implementation':<28} {'mean ms':>10} {'tokens/s':>12} {'speedup':>8}",
        "-" * 62,
    ]
    for r in results:
        sp = f"{base / r.mean_ms:.2f}x" if base else "-"
        lines.append(
            f"{r.name:<28} {r.mean_ms:>10.3f} {r.tokens_per_second:>12.0f} {sp:>8}"
        )
    out = "\n".join(lines)
    print(out)
    return out
