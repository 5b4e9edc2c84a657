"""mydetection_tpu_torch — the PyTorch/CUDA port of mydetection_tpu.

The YOLOv3, FCOS, RetinaNet and RAPiD (rotated boxes) detectors in
PyTorch for an NVIDIA H100, with the JAX package's eight Pallas kernels
rewritten as hand-written CUDA kernels (`kernels/csrc/*.cu`, built with
nvcc at their first launch). It imports nothing of JAX or of
`mydetection_tpu`. Every entry point runs on the card unless asked for
the CPU (`device="cpu"`, `--device cpu`).

Public surface (the JAX package's top-level names, less `Model`: JAX's
`Model` bundles a config with pure `init` / `apply` functions, and the
port's models are `nn.Module`s built by `get_model`, the config on their
`config` attribute):
    Detector(model_name=..., weights_path=..., device=...,
             quantized=False | True | "<artifact>.npz", calib_images=...,
             data_parallel=...)  — build-by-name
    Detector.detect_one / detect_batch / detect_imgSeq / detect_prepared
    get_model(name) / list_models() / ModelConfig
    evaluate_coco(detector, ann_file, img_dir, ...)  — COCO box-mAP
    export_detector / load_exported / ExportedDetector  — torch.export
        artifacts that launch the kernels as `mydet::` custom ops
    DetectionServer  — the HTTP serving daemon (batched, bucketed)

Below it: `training.make_train_step` (one device, or data-parallel over a
`parallel.mesh.make_mesh()`), `data.coco`, `data.loader`,
`eval.rotated_eval`, `quant` / `quant_resnet` (int8 post-training
quantization), `weight_import` / `checkpoint` (darknet, torchvision and
`.npz` weights). The CLIs:
    python -m mydetection_tpu_torch.train [--data-parallel] | .evaluate
        [--quantized] | .anchors | .export | .serve | .summary | .demo
"""

from mydetection_tpu_torch.api import Detections, Detector
from mydetection_tpu_torch.registry import ModelConfig, get_model, list_models


def evaluate_coco(detector, ann_file, img_dir, **kw):
    """COCO box-mAP evaluation of a Detector (lazy import)."""
    from mydetection_tpu_torch.eval.evaluator import evaluate_detector

    return evaluate_detector(detector, ann_file, img_dir, **kw)


def __getattr__(name):
    # the artifact and serving surface, bound on first access (export
    # pulls in torch.export)
    if name in ("export_detector", "load_exported", "ExportedDetector"):
        from mydetection_tpu_torch import export as _export

        return getattr(_export, name)
    if name == "DetectionServer":
        from mydetection_tpu_torch.serve import DetectionServer

        return DetectionServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DetectionServer",
    "Detections",
    "Detector",
    "ExportedDetector",
    "ModelConfig",
    "evaluate_coco",
    "export_detector",
    "get_model",
    "list_models",
    "load_exported",
]

__version__ = "0.1.0"
