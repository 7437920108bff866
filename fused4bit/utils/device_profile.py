"""Trace-based device timing: per-kernel durations from the profiler.

``jax.profiler.trace`` records every kernel the GPU runs, with its start and
duration on the device's clock, beside the host's events. Summing those
durations gives kernel time that host dispatch cannot blur; the device
clock around the kernel is what the reference reads with
`torch.cuda.Event` (`benchmark/run_benchmark.py:93-104`).

In the exported trace, the GPU is a process named ``/device:GPU:<n>`` whose
threads are CUDA streams (``Stream #<id>(Compute)``); each kernel is one
complete event, named after the kernel (a Pallas call's ``name``, an XLA
fusion's name), with ``hlo_module`` (the jitted program) and ``hlo_op`` in
its arguments and its duration in microseconds.

Usage::

    from fused4bit.utils.device_profile import device_op_times

    prof = device_op_times(lambda: jax.block_until_ready(f(x, w)))
    prof.total_ms              # sum of all kernel durations
    prof.by_op                 # {kernel name: OpTime(total_ms, count)}
    prof.matching_ms("int4")   # sum over kernels whose name contains "int4"
"""
from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import tempfile
from typing import Callable, Dict, Optional

import jax

__all__ = ["OpTime", "DeviceProfile", "device_op_times"]


@dataclasses.dataclass
class OpTime:
    total_ms: float
    count: int

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


@dataclasses.dataclass
class DeviceProfile:
    """Per-op device durations from one traced run."""

    by_op: Dict[str, OpTime]
    #: kernel time per jitted program (``hlo_module``): the device's busy
    #: time for that program, without the gaps between its kernels.
    by_module: Dict[str, OpTime]

    @property
    def total_ms(self) -> float:
        return sum(t.total_ms for t in self.by_op.values())

    def matching_ms(self, *substrings: str) -> float:
        """Total device ms over ops whose name contains any substring."""
        return sum(
            t.total_ms
            for name, t in self.by_op.items()
            if any(s in name for s in substrings)
        )

    def matching_count(self, *substrings: str) -> int:
        return sum(
            t.count
            for name, t in self.by_op.items()
            if any(s in name for s in substrings)
        )

    def main_module_ms(self, name_substring: Optional[str] = None) -> float:
        """Kernel ms of the main jitted program in this trace.

        A traced run can hold auxiliary programs besides the jit under test
        (donation copies, helper jits). With ``name_substring`` the program
        is selected by name (e.g. ``"jit_loop"``); otherwise the one with the
        most kernel time is taken.
        """
        if not self.by_module:
            raise RuntimeError("trace contains no device kernels")
        if name_substring is not None:
            hits = {
                k: v for k, v in self.by_module.items() if name_substring in k
            }
            if not hits:
                raise KeyError(
                    f"no program matching {name_substring!r}; "
                    f"have {sorted(self.by_module)}"
                )
            return max(v.total_ms for v in hits.values())
        return max(v.total_ms for v in self.by_module.values())


def _base_name(name: str) -> str:
    """Collapse the ``.N``/``_N`` suffixes XLA gives copies of one op."""
    for sep in (".", "_"):
        head, _, tail = name.rpartition(sep)
        if head and tail.isdigit():
            return head
    return name


def _parse_trace(trace_dir: str) -> DeviceProfile:
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.trace.json.gz"))
    )
    if not paths:
        raise RuntimeError(f"no trace produced under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        tr = json.load(f)
    evs = tr.get("traceEvents", [])
    device_pids = {
        e["pid"] for e in evs
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and "/device:" in e.get("args", {}).get("name", "")
    }
    by_op: Dict[str, OpTime] = {}
    by_module: Dict[str, OpTime] = {}
    for e in evs:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        dur_ms = float(e["dur"]) / 1e3          # trace durations are in us
        module = e.get("args", {}).get("hlo_module", "")
        for bucket, key in ((by_op, _base_name(e["name"])), (by_module, module)):
            t = bucket.setdefault(key, OpTime(0.0, 0))
            t.total_ms += dur_ms
            t.count += 1
    if not by_op:
        raise RuntimeError(f"trace under {trace_dir} holds no device kernels")
    return DeviceProfile(by_op=by_op, by_module=by_module)


def device_op_times(
    run: Callable[[], object],
    *,
    trace_dir: Optional[str] = None,
) -> DeviceProfile:
    """Run ``run()`` under the profiler and return per-op device durations.

    ``run`` must block until the device work is done (end in
    ``jax.block_until_ready``/``np.asarray`` of a result); compile outside
    (call once before) so the trace holds only execution.
    """
    d = trace_dir or tempfile.mkdtemp(prefix="f4b_trace_")
    with jax.profiler.trace(d):
        run()
    return _parse_trace(d)
