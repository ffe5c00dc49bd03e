"""The trace reader and the per-layer metrics on a synthetic Chrome trace."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import pytest  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.devtrace import WINDOW_SPAN, DeviceTrace, is_glue  # noqa: E402


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    """A 1000 us window: a hand kernel 100-400, a cuDNN kernel 300-500
    overlapping it, glue 600-650, a copy 700-800, a kernel outside."""
    return [
        _ev(WINDOW_SPAN, "user_annotation", 0.0, 1000.0),
        _ev("xla_block_kernel<0>", "kernel", 100.0, 300.0),
        _ev("sm90_xmma_fprop_implicit_gemm", "kernel", 300.0, 200.0),
        _ev("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor>", "kernel", 600.0, 50.0),
        _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 700.0, 100.0),
        _ev("xla_block_kernel<1>", "kernel", 1500.0, 100.0),
        _ev("aten::copy_", "cpu_op", 800.0, 200.0),
        {"ph": "i", "name": "marker", "ts": 10.0},
    ]


def test_union_glue_and_gaps():
    t = DeviceTrace(_trace())
    assert t.window_s == pytest.approx(1e-3)
    assert t.n_device == 4
    assert t.busy_s == pytest.approx(550e-6)  # 100-500, 600-650, 700-800
    assert t.total_s == pytest.approx(650e-6)  # the overlap counts twice in the sum
    assert t.glue_s == pytest.approx(150e-6)
    assert t.compute_s == pytest.approx(500e-6)
    labels = dict(t.idle_gaps)
    assert labels["aten::copy_"] == pytest.approx(200e-6)  # 800-1000
    assert sum(labels.values()) == pytest.approx(450e-6)


def test_glue_list_names_pytorch_kernels_only():
    assert is_glue("void at::native::reduce_kernel<512, 1>", "kernel")
    assert is_glue("void at_cuda_detail::cub::DeviceReduceKernel", "kernel")
    assert is_glue("Memset (Device)", "gpu_memset")
    for name in ("conv3_kernel<2, false, 128>", "iek_renamed_kernel", "cudnn::implicit_gemm", "nchwToNhwcKernel"):
        assert not is_glue(name, "kernel")


def _read_all(tr, work=None, window_s=1e-3):
    cell = harness.load_cell("didbl-int8-fast512")
    run = harness._Run(tr, work or {"ops_s": 2e-4, "bound_s": 3e-4}, window_s)
    return {m["name"]: harness.metric_reader(cell, m["name"]).read(run) for m in cell.per_layer}


def test_metrics_on_synthetic_trace():
    v = _read_all(DeviceTrace(_trace()))
    assert v["device_idle_share"] == pytest.approx(45.0)
    assert v["glue_device_share"] == pytest.approx(100 * 150 / 650)
    assert v["kernel_roofline"] == pytest.approx(60.0)
    assert v["model_mfu"] == pytest.approx(20.0)


def test_no_device_events_reads_nothing(tmp_path):
    events = [e for e in _trace() if e.get("cat") not in ("kernel", "gpu_memcpy")]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    t = DeviceTrace.from_file(str(p))
    assert t.n_device == 0
    assert all(v is None for v in _read_all(t).values())
    assert all(v is None for v in _read_all(None).values())


def test_missing_window_span_raises():
    with pytest.raises(ValueError):
        DeviceTrace([e for e in _trace() if e["name"] != WINDOW_SPAN])
