"""The port on the card: the CUDA NMS kernel against its plain version,
and the CUDA Detector against the CPU one. Every test skips on a host
without a GPU. This file imports no JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX for the other files.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import golden_image, nms_cases, padded_canvas  # noqa: E402
from mydetection_tpu_torch import Detector  # noqa: E402
from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain  # noqa: E402

THR = 0.45
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1024, 200, 2500])
def test_kernel_matches_plain(cuda, k):
    """K = 200 ends in a partial tile; K = 2500 needs more than 48 KB of
    shared memory."""
    boxes, valid = nms_cases(np.random.RandomState(k), 12, k)
    b = torch.from_numpy(boxes).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    before = nms_keep.launches
    got = nms_keep(b, v, THR)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  nms_keep_plain(b, v, THR).cpu().numpy())


def test_kernel_rejects_bad_inputs(cuda):
    b = torch.zeros(2, 8, 4, device=cuda)
    v = torch.ones(2, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        nms_keep(b.double(), v, THR)
    with pytest.raises(ValueError, match="contiguous"):
        nms_keep(b.transpose(0, 1), v.t(), THR)
    with pytest.raises(ValueError, match="valid"):
        nms_keep(b, v.cpu(), THR)
    with pytest.raises(ValueError, match="shared memory"):
        nms_keep(torch.zeros(1, 20000, 4, device=cuda),
                 torch.ones(1, 20000, dtype=torch.bool, device=cuda), THR)


def test_cuda_detector_matches_cpu(cuda):
    """Same seeded weights, float32 with TF32 off: the golden gates."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        canvas, info = padded_canvas(golden_image(), 416, 8, 58)
        kw = dict(input_size=416, compute_dtype=torch.float32, rng_seed=1)
        before = nms_keep.launches
        gpu = Detector("yolov3", device=cuda, **kw).detect_prepared(
            canvas[None], [info], conf_thres=0.25)[0]
        assert nms_keep.launches == before + 1
        cpu = Detector("yolov3", device="cpu", **kw).detect_prepared(
            canvas[None], [info], conf_thres=0.25)[0]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert len(gpu) == len(cpu) > 0
    np.testing.assert_array_equal(gpu.classes, cpu.classes)
    np.testing.assert_allclose(gpu.scores, cpu.scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gpu.boxes_xyxy, cpu.boxes_xyxy, rtol=0,
                               atol=1e-2)
