"""Benchmark plumbing smoke tests (reference tests/test_benchmark.py parity).

The reference smoke-tests its benchmark path: forward shapes, no NaNs, and
the memory-reduction claim (>= 7.5x, `tests/test_benchmark.py:55-76`). Here:
timer sanity, roofline math, result table, and the same memory assertions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused4bit.quant import quantize
from fused4bit.utils.benchmark import BenchmarkResult, print_table, time_fn, time_fn_scan
from fused4bit.utils.roofline import chip_spec, linear_roofline

H100 = chip_spec("NVIDIA H100 80GB HBM3")


class TestTimers:
    def test_time_fn_positive(self):
        x = jnp.ones((128, 128))
        f = jax.jit(lambda: x @ x)
        t = time_fn(f, warmup=1, iters=3)
        assert t > 0

    def test_time_fn_scan_positive_and_scales(self):
        x = jnp.ones((64, 64))
        t = time_fn_scan(lambda v: v @ v, x, iters=8, warmup=1, repeats=2)
        assert t > 0


class TestRoofline:
    def test_memory_bound_decode(self):
        rep = linear_roofline(1, 4096, 11008, chip=H100)
        assert rep.bound == "memory"
        # bytes: x 4096*2 + packed 11008*2048 + scales/zp 8*11008 + out 11008*2
        assert rep.bytes_moved == 4096 * 2 + 11008 * 2048 + 8 * 11008 + 11008 * 2
        assert rep.flops == 2 * 4096 * 11008

    def test_compute_bound_prefill(self):
        rep = linear_roofline(8192, 4096, 11008, chip=H100)
        assert rep.bound == "compute"

    def test_measured_fields(self):
        rep = linear_roofline(1, 4096, 11008, chip=H100, measured_s=100e-6)
        assert rep.achieved_gbps is not None
        assert 0 < rep.pct_of_sol <= 100 or rep.pct_of_sol > 0

    def test_sol_latency_sane(self):
        rep = linear_roofline(1, 4096, 11008, chip=H100)
        # ~22.6MB at 3350 GB/s ≈ 6.7us
        assert 5 < rep.sol_latency_us < 9

    def test_unknown_device_is_an_error(self):
        with pytest.raises(KeyError, match="no peak rates"):
            chip_spec("Some Other Accelerator")
        with pytest.raises(KeyError):
            linear_roofline(1, 64, 64)     # this CPU is not in the table


class TestResults:
    def test_table_and_speedup(self, capsys):
        rows = [
            BenchmarkResult("base", 2.0, num_tokens=100),
            BenchmarkResult("fast", 1.0, num_tokens=100),
        ]
        out = print_table(rows, baseline="base")
        assert "2.00x" in out
        assert rows[1].tokens_per_second == pytest.approx(100 / 1e-3)

    def test_memory_reduction_claim(self, rng):
        # the reference's headline memory assertion (>=7.5x vs fp32)
        w = jnp.asarray(rng.standard_normal((4096, 4096)), jnp.float32)
        qt = quantize(w)
        assert qt.memory_reduction_vs(jnp.float32) >= 7.5
        assert qt.memory_reduction_vs(jnp.bfloat16) >= 3.75

    def test_forward_no_nan_sweep(self, rng):
        # reference test_benchmark.py:33-53: shapes + no-NaN across sizes
        from fused4bit.ops.int4_matmul import int4_matmul

        for n, k in [(256, 512), (512, 1024)]:
            qt = quantize(jnp.asarray(rng.standard_normal((n, k)), jnp.float32))
            for m in (1, 4):
                x = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
                y = int4_matmul(x, qt)
                assert y.shape == (m, n)
                assert not bool(jnp.any(jnp.isnan(y)))


class TestProfiling:
    def test_stopwatch(self):
        import time as _t
        from fused4bit.utils.profiling import Stopwatch

        sw = Stopwatch()
        with sw.section("a"):
            _t.sleep(0.01)
        with sw.section("b"):
            _t.sleep(0.005)
        rep = sw.report()
        assert "a" in rep and "b" in rep
        assert sw.sections["a"] >= 0.01

    def test_trace_degrades_gracefully(self, tmp_path):
        from fused4bit.utils.profiling import trace

        with trace(str(tmp_path / "prof")):
            _ = jnp.ones((8, 8)) @ jnp.ones((8, 8))

    def test_annotate(self):
        from fused4bit.utils.profiling import annotate

        with annotate("region"):
            _ = jnp.ones((4,)) + 1
