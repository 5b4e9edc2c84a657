"""Detection demo CLI: run a model on images or video and save renders.

The port of the top-level `demo.py`:

    python -m mydetection_tpu_torch.demo --model yolov3 \\
        --weights weights/yolov3.npz --input dog.jpg --out-dir demo_out
    python -m mydetection_tpu_torch.demo --model rapid --input fisheye_dir/

Images (a file, or every image and video in a directory) go one at a
time through `Detector.detect_one(save_path=...)`; videos are decoded
with cv2 and detected in padded batches of 16, then written as an
annotated MJPG `.avi`. Without cv2 the renders are unmarked copies of
the images (`utils.visualization`), and video input exits with a
message. `--device` defaults to cuda, as the other CLIs do.
"""

from __future__ import annotations

import argparse
import os
import time

from mydetection_tpu_torch.utils.image_ops import IMAGE_EXTS

VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm"}


def run_video(det, path: str, out_dir: str, *, conf_thres: float,
              nms_iou: float, batch_size: int = 16) -> str:
    """Decode `path` with cv2, detect in batches of `batch_size` (the
    tail padded to a full batch, so every batch has one shape), draw,
    and write `<name>_det.avi` to `out_dir`. Returns the output path."""
    import cv2
    import numpy as np

    from mydetection_tpu_torch.utils.visualization import draw_detections

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    name = os.path.splitext(os.path.basename(path))[0]
    out_path = os.path.join(out_dir, f"{name}_det.avi")
    writer = None
    names = det.cfg.class_names
    n_frames = 0
    t0 = time.perf_counter()
    try:
        while True:
            frames = []
            while len(frames) < batch_size:
                ok, bgr = cap.read()
                if not ok:
                    break
                frames.append(np.ascontiguousarray(bgr[:, :, ::-1]))  # RGB
            if not frames:
                break
            real = len(frames)
            padded = frames + [frames[-1]] * (batch_size - real)
            for rgb, dets in zip(frames, det.detect_batch(
                    padded, conf_thres=conf_thres, nms_iou=nms_iou)[:real]):
                vis = draw_detections(rgb, dets, class_names=names)
                if writer is None:
                    h, w = vis.shape[:2]
                    writer = cv2.VideoWriter(
                        out_path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
                writer.write(np.ascontiguousarray(vis[:, :, ::-1]))
                n_frames += 1
            if real < batch_size:
                break
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if writer is None:
        raise SystemExit(f"no frames decoded from {path}")
    dt = time.perf_counter() - t0
    print(f"{path}: {n_frames} frames in {dt:.1f} s "
          f"({n_frames / dt:.1f} fps incl. host decode) -> {out_path}")
    return out_path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="yolov3")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--input", required=True,
                    help="image or video file, or a directory")
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--conf-thres", type=float, default=0.3)
    ap.add_argument("--nms-iou", type=float, default=0.45)
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--float32", action="store_true",
                    help="float32 compute (default bf16)")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 static-scale PTQ serving path, calibrated "
                         "on the input images themselves")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _video_frames(path: str, n: int) -> list:
    """Up to `n` RGB frames of a video, for calibration."""
    import cv2
    import numpy as np

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while len(frames) < n:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(np.ascontiguousarray(bgr[:, :, ::-1]))
    finally:
        cap.release()
    return frames


def main(argv: list[str] | None = None) -> list[str]:
    """Run the CLI on `argv` (None: sys.argv); returns the written
    paths."""
    args = build_parser().parse_args(argv)

    import torch

    from mydetection_tpu_torch import Detector
    from mydetection_tpu_torch.utils.visualization import has_cv2

    if os.path.isdir(args.input):
        paths = sorted(
            os.path.join(args.input, f) for f in os.listdir(args.input)
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS | VIDEO_EXTS)
    else:
        paths = [args.input]
    videos = [p for p in paths
              if os.path.splitext(p)[1].lower() in VIDEO_EXTS]
    paths = [p for p in paths if p not in videos]
    if videos and not has_cv2():
        raise SystemExit(f"video input ({videos[0]}) needs cv2 (opencv), "
                         "which is not installed; pass images instead")

    overrides = {}
    if args.input_size:
        overrides["input_size"] = args.input_size
    if args.float32:
        overrides["compute_dtype"] = torch.float32
    if args.quantized:
        # calibrate on the user's own data: the images, else the
        # first frames of the first video
        calib = paths[:32] or (_video_frames(videos[0], 8) if videos else [])
        overrides["quantized"] = True
        overrides["calib_images"] = calib or None
    det = Detector(model_name=args.model, weights_path=args.weights,
                   device=args.device, **overrides)
    os.makedirs(args.out_dir, exist_ok=True)
    print("drawing: " + ("cv2" if has_cv2() else
                         "none (cv2 is not installed: the renders are "
                         "unmarked copies)"))
    written = [run_video(det, path, args.out_dir, conf_thres=args.conf_thres,
                         nms_iou=args.nms_iou) for path in videos]
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.out_dir, f"{name}_det.png")
        t0 = time.perf_counter()
        dets = det.detect_one(img_path=path, conf_thres=args.conf_thres,
                              nms_iou=args.nms_iou, save_path=out_path)
        dt = (time.perf_counter() - t0) * 1000
        print(f"{path}: {len(dets)} detections in {dt:.0f} ms -> {out_path}")
        for row in dets.as_array()[:10]:
            print("   ", [round(float(v), 1) for v in row])
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
