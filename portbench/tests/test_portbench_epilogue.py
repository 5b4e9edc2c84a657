"""`metrics/epilogue_roofline.py`: the convs it counts on the reference,
its bound by hand, and its reading of a trace."""

import importlib.util

import pytest

from portbench import cells, yardstick

SPEC = importlib.util.spec_from_file_location(
    "epilogue_roofline", cells.ROOT / "metrics" / "epilogue_roofline.py")
METRIC = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(METRIC)


@pytest.mark.parametrize("family,size,calls,elements,residual", [
    # Darknet-53 + the YOLOv3 head at 416: 72 conv-BN-leaky + 3 outputs,
    # 23 residual blocks; ResNet-50 at 608 outside the six fused blocks
    ("yolov3", 416, 75, 39_193_635, 14_536_704),
    ("fcos", 608, 34, 36_042_240, 14_047_232),
])
def test_counts_the_convs_the_kernel_takes(family, size, calls, elements,
                                           residual):
    convs = METRIC.epilogue_convs(cells.family(family), 80, 1, size)
    assert len(convs) == calls
    assert sum(n for n, _ in convs) == elements
    assert sum(n for n, joins in convs if joins) == residual


def test_bound_by_hand():
    # 100 elements alone and 10 with a residual, bf16: (200 + 30) · 2 bytes
    assert METRIC.bound_ms([(100, False), (10, True)], 2) == \
        pytest.approx(460 / yardstick.HBM_BYTES_PER_S * 1e3)


def test_reads_the_kernel_time_a_forward():
    yolov3 = cells.family("yolov3")
    convs = METRIC.epilogue_convs(yolov3, 80, 2, 64)
    cfg = {"family": "yolov3", "num_classes": 80, "input_size": 64,
           "dtype": "bfloat16"}
    ctx = {"config": cfg, "family": yolov3, "batch": 2, "trace": {"kernels": {
        "void (anonymous namespace)::conv_epilogue_kernel<...>":
            (0.003, 2 * len(convs)),
        "void at::native::vectorized_elementwise_kernel": (1.0, 10)}}}
    want = 100 * METRIC.bound_ms(convs, 2) / 1.5
    assert METRIC.read(ctx) == pytest.approx(want)
    ctx["trace"]["kernels"].pop(next(iter(ctx["trace"]["kernels"])))
    assert METRIC.read(ctx) is None
    assert METRIC.read({"config": cfg, "family": yolov3, "batch": 2}) is None
