"""mydetection_tpu_torch — the PyTorch/CUDA port of mydetection_tpu.

The YOLOv3, FCOS, RetinaNet and RAPiD (rotated boxes) detect and train
paths, int8 post-training quantization, the data layer, COCO and rotated
evaluation and the train / evaluate CLIs in PyTorch for an NVIDIA H100, with the JAX package's
eight Pallas kernels rewritten as hand-written CUDA kernels
(`kernels/csrc/*.cu`, built with nvcc at their first launch). It imports
nothing of JAX or of `mydetection_tpu`.

Public surface:
    Detector(model_name=..., weights_path=..., device=...,
             quantized=False | True | "<artifact>.npz", calib_images=...)
    Detector.detect_one / detect_batch / detect_imgSeq / detect_prepared
    get_model(name) / list_models()
    training.make_train_step(model, input_size=...) / burn_in_lr
    data.coco.CocoDataset / data.loader.StreamingPipeline, TrainLoader
    eval.evaluator.evaluate_detector / eval.rotated_eval.evaluate_rotated
    python -m mydetection_tpu_torch.train | .evaluate | .anchors
"""

from mydetection_tpu_torch.api import Detections, Detector
from mydetection_tpu_torch.registry import get_model, list_models

__all__ = ["Detections", "Detector", "get_model", "list_models"]
