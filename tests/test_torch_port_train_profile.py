"""`chip_train_profile.py`'s reading of a profiler trace, on the CPU: the
busy time as the union of kernel intervals, the idle share of the
device span, the kernel classes, and a trace with no kernel refused."""

import json

import pytest

pytest.importorskip("torch")

from chip_train_profile import busy_union, kernel_class, trace_summary  # noqa: E402


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),                 # overlapping
    ([(0, 10), (2, 3), (4, 5)], 10.0),       # nested
    ([(5, 6), (0, 1), (2, 4)], 4.0),         # disjoint, unsorted
    ([(0, 2), (2, 4)], 4.0),                 # touching
])
def test_busy_union(intervals, want):
    assert busy_union(intervals) == want


@pytest.mark.parametrize("name,want", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv/gemm"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "copy"),
    ("void cudnn::cnn::wgrad_alg0_engine<float, 128, 6>", "conv/gemm"),
    ("cutlass3x_sm90_tensorop_gemm_bf16", "conv/gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduction"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>",
     "copy"),
    ("void at::native::index_elementwise_kernel<128, 4, ...>", "elementwise"),
    ("void at::native::scatter_gather_kernel<...>", "other"),
])
def test_kernel_class(name, want):
    assert kernel_class(name) == want


def test_trace_summary(tmp_path):
    path = tmp_path / "trace.json"
    events = [
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm", "ts": 0,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel",
         "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30,
         "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 100},
    ]
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace_summary(str(path))
    assert got["kernels"] == 3
    assert got["span_us"] == 35.0 and got["busy_us"] == 20.0
    assert got["idle"] == pytest.approx(15 / 35)
    assert got["by_class_us"] == {"conv/gemm": 10.0, "elementwise": 10.0,
                                  "reduction": 0.0, "copy": 5.0,
                                  "other": 0.0}
    path.write_text(json.dumps({"traceEvents": events[-1:]}))
    with pytest.raises(AssertionError, match="no kernel"):
        trace_summary(str(path))
