"""Tests for the trace-based device timing utility (utils/device_profile).

The reduction runs on a small trace recorded on an NVIDIA H100 80GB HBM3
(`tests/fixtures/gpu_trace`: two INT4 matmul kernels with their split-K
reductions, one jitted program, plus one host event), and on synthetic
traces of the same shape.
"""
import gzip
import json
import os
import pathlib

import pytest

from fused4bit.utils.device_profile import _base_name, _parse_trace

RECORDED = pathlib.Path(__file__).parent / "fixtures" / "gpu_trace"


def _write_trace(tmp_path, events):
    d = os.path.join(tmp_path, "plugins", "profile", "2026_01_01_00_00_00")
    os.makedirs(d)
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _gpu_meta(pid=1, tid=7):
    return [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": f"/device:GPU:{pid - 1}"}},
        {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
         "args": {"name": f"Stream #{tid}(Compute)"}},
        {"ph": "M", "pid": 701, "name": "process_name",
         "args": {"name": "/host:CPU"}},
    ]


def _kernel(name, dur_us, module="jit_f", pid=1, tid=7, ts=0.0):
    return {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur_us,
            "name": name, "args": {"hlo_module": module}}


def test_recorded_h100_trace():
    prof = _parse_trace(str(RECORDED))
    assert prof.by_op["int4_matmul"].count == 2
    assert prof.by_op["int4_matmul"].total_ms == pytest.approx(0.058944)
    # loop_reduce_fusion_1 and loop_reduce_fusion aggregate
    assert prof.by_op["loop_reduce_fusion"].count == 2
    assert prof.total_ms == pytest.approx(0.061984)
    assert prof.main_module_ms() == pytest.approx(0.061984)
    assert prof.main_module_ms("jit__lambda") == prof.main_module_ms()


def test_host_events_are_ignored(tmp_path):
    events = _gpu_meta() + [
        _kernel("fusion_3", 100.0),
        {"ph": "X", "pid": 701, "tid": 1, "ts": 0.0, "dur": 9999.0,
         "name": "PjitFunction(f)"},
    ]
    prof = _parse_trace(_write_trace(tmp_path, events))
    assert set(prof.by_op) == {"fusion"}
    assert prof.total_ms == pytest.approx(0.1)


def test_modules_and_matching(tmp_path):
    events = _gpu_meta() + [
        _kernel("int4_matmul", 200.0, "jit_loop"),
        _kernel("int4_matmul", 300.0, "jit_loop", ts=300.0),
        _kernel("copy.2", 10.0, "jit__copy", ts=700.0),
    ]
    prof = _parse_trace(_write_trace(tmp_path, events))
    assert prof.by_op["int4_matmul"].mean_ms == pytest.approx(0.25)
    assert prof.matching_ms("int4") == pytest.approx(0.5)
    assert prof.matching_count("int4", "copy") == 3
    # the main program, not the cheap auxiliary copy
    assert prof.main_module_ms() == pytest.approx(0.5)
    with pytest.raises(KeyError):
        prof.main_module_ms("jit_nonexistent")


def test_every_stream_and_device_counts(tmp_path):
    events = _gpu_meta(1, 7) + _gpu_meta(2, 9) + [
        _kernel("a", 1.0, pid=1, tid=7), _kernel("a", 2.0, pid=2, tid=9),
    ]
    assert _parse_trace(_write_trace(tmp_path, events)).by_op["a"].count == 2


def test_base_name():
    assert _base_name("loop_reduce_fusion_1") == "loop_reduce_fusion"
    assert _base_name("fusion.12") == "fusion"
    assert _base_name("int4_matmul") == "int4_matmul"


def test_parse_raises_without_trace(tmp_path):
    with pytest.raises(RuntimeError):
        _parse_trace(str(tmp_path))


def test_parse_raises_without_device_kernels(tmp_path):
    with pytest.raises(RuntimeError, match="no device kernels"):
        _parse_trace(_write_trace(tmp_path, _gpu_meta()))
