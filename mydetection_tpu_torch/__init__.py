"""mydetection_tpu_torch — the PyTorch/CUDA port of mydetection_tpu.

The YOLOv3, FCOS and RAPiD (rotated boxes) detect paths and FCOS
training in PyTorch for an NVIDIA H100, with the JAX package's Pallas
NMS, fused bias+GroupNorm+ReLU (forward, forward with statistics, fused
backward) and rotated-NMS suppress kernels rewritten as hand-written
CUDA kernels (`kernels/csrc/nms.cu`, `kernels/csrc/gn.cu`,
`kernels/csrc/rotated_nms.cu`, built with nvcc at their first launch).
It imports nothing of JAX or of `mydetection_tpu`.

Public surface:
    Detector(model_name=..., weights_path=..., device=...)
    Detector.detect_one / detect_batch / detect_imgSeq / detect_prepared
    get_model(name) / list_models()
    training.make_train_step(model, input_size=...) / burn_in_lr
"""

from mydetection_tpu_torch.api import Detections, Detector
from mydetection_tpu_torch.registry import get_model, list_models

__all__ = ["Detections", "Detector", "get_model", "list_models"]
