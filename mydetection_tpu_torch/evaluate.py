"""COCO evaluation CLI of the PyTorch port — the JAX package's
`evaluate.py` on the card.

Example:
    python -m mydetection_tpu_torch.evaluate --model yolov3 \\
        --weights weights/yolov3.npz --ann data/instances_val2017.json \\
        --img-dir data/val2017 --input-size 416 --batch-size 32

`--device` defaults to cuda (an error when no GPU is visible); pass
`--device cpu` to evaluate on the CPU. `--rotated` scores a rotated
model (rapid) with rotated-IoU matching (AP50, AP75). `--quantized`
evaluates the int8 path, calibrated on the first `--calib-images`
images of `--img-dir` (sorted by path). `--exported ARTIFACT` evaluates
an export artifact (`mydetection_tpu_torch.export`) instead of building
a model, on `--device` (an artifact runs only where it was exported,
unless it was exported with use_pallas=False); `--data-parallel` splits
each batch over every local CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib

import torch


@contextlib.contextmanager
def tf32_off(device: str):
    """cuDNN and matmul TF32 off on the card for the duration (float32
    runs), restored after."""
    if torch.device(device).type != "cuda":
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="yolov3")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--ann", required=True, help="COCO annotation JSON")
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--conf-thres", type=float, default=0.005)
    ap.add_argument("--nms-iou", type=float, default=0.45)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--num-threads", type=int, default=4)
    ap.add_argument("--out", default=None, help="write results JSON here")
    ap.add_argument("--float32", action="store_true",
                    help="float32 compute, TF32 off on the card "
                         "(bit-consistency runs; default bf16)")
    ap.add_argument("--exact-topk", action="store_true",
                    help="accepted for the JAX CLI's sake and ignored: "
                         "the port's pre-NMS top-k is always exact")
    ap.add_argument("--rotated", action="store_true",
                    help="rotated-box evaluation (fisheye datasets, "
                         "AP50/AP75 with rotated-IoU matching)")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 static-scale PTQ serving path; calibrates "
                         "on --calib-images images from --img-dir, then "
                         "evaluates the quantized pipeline (diff against "
                         "a float run to measure the PTQ mAP cost)")
    ap.add_argument("--calib-images", type=int, default=32,
                    help="calibration images for --quantized")
    ap.add_argument("--data-parallel", action="store_true",
                    help="split each batch over every local CUDA device")
    ap.add_argument("--exported", default=None, metavar="ARTIFACT",
                    help="evaluate an export artifact "
                         "(mydetection_tpu_torch.export) instead of "
                         "building a model — --model/--weights and all "
                         "model overrides are ignored; nms_iou and the "
                         "input size are the artifact's baked values")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def calibration_paths(img_dir: str, n: int) -> list[str]:
    """The first `n` images of `img_dir` (by IMAGE_EXTS, sorted by
    path), as the JAX CLI picks them; SystemExit when there are none."""
    import glob
    import os

    from mydetection_tpu_torch.utils.image_ops import IMAGE_EXTS

    paths = sorted(p for p in glob.glob(os.path.join(img_dir, "*"))
                   if os.path.splitext(p)[1].lower() in IMAGE_EXTS)
    if not paths:
        raise SystemExit(f"--quantized: no images in {img_dir} to "
                         "calibrate on")
    return paths[:n]


def _evaluate_exported(args) -> dict:
    """`--exported`: the artifact decides whether it is rotated (a
    contradicting `--rotated` is an error), its nms_iou and its input
    size; it runs on `--device`, which `load_exported` checks against
    the device it was exported for."""
    from mydetection_tpu_torch.export import load_exported, read_meta

    meta = read_meta(args.exported)
    if args.rotated and not meta["rotated"]:
        raise SystemExit(f"--rotated passed but {args.exported} is an "
                         f"axis-aligned {meta['model']!r} artifact")
    served = load_exported(args.exported, device=args.device)
    common = dict(conf_thres=args.conf_thres, nms_iou=meta["nms_iou"],
                  batch_size=args.batch_size, max_images=args.max_images,
                  num_threads=args.num_threads, results_path=args.out)
    if meta["rotated"]:
        from mydetection_tpu_torch.eval.rotated_eval import (
            evaluate_rotated_detector,
        )
        stats = evaluate_rotated_detector(served, args.ann, args.img_dir,
                                          **common)
    else:
        from mydetection_tpu_torch.eval.evaluator import evaluate_detector

        stats = evaluate_detector(served, args.ann, args.img_dir, **common)
    print({k: round(v, 4) for k, v in stats.items()})
    return stats


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI on `argv` (None: sys.argv); prints and returns the
    stats dict."""
    args = build_parser().parse_args(argv)
    if args.exported:
        return _evaluate_exported(args)

    from mydetection_tpu_torch import Detector

    overrides = {}
    if args.data_parallel:
        overrides["data_parallel"] = True
    if args.input_size:
        overrides["input_size"] = args.input_size
    if args.float32:
        overrides["compute_dtype"] = torch.float32
    if args.quantized:
        overrides["quantized"] = True
        overrides["calib_images"] = calibration_paths(args.img_dir,
                                                      args.calib_images)
    common = dict(conf_thres=args.conf_thres, nms_iou=args.nms_iou,
                  batch_size=args.batch_size, input_size=args.input_size,
                  max_images=args.max_images, num_threads=args.num_threads,
                  results_path=args.out)
    with tf32_off(args.device) if args.float32 else contextlib.nullcontext():
        if args.rotated:
            from mydetection_tpu_torch.eval.rotated_eval import (
                evaluate_rotated_detector,
            )
            det = Detector(model_name=args.model, weights_path=args.weights,
                           device=args.device, **overrides)
            stats = evaluate_rotated_detector(det, args.ann, args.img_dir,
                                              **common)
        else:
            from mydetection_tpu_torch.eval.cocoeval import COCOGt
            from mydetection_tpu_torch.eval.evaluator import evaluate_detector

            # the head's class count must match the GT category set
            gt = COCOGt(args.ann)
            if gt.cat_ids:
                overrides["num_classes"] = len(gt.cat_ids)
            det = Detector(model_name=args.model, weights_path=args.weights,
                           device=args.device, **overrides)
            stats = evaluate_detector(det, gt, args.img_dir, **common)
    print({k: round(v, 4) for k, v in stats.items()})
    return stats


if __name__ == "__main__":
    main()
