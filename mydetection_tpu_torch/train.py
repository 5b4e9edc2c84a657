"""Training CLI of the PyTorch port — the JAX package's `train.py` on
the card: SGD with momentum and weight decay, darknet burn-in LR
warmup, an iteration-based loop, multi-scale input sizes, periodic
checkpoints and validation AP, and `--resume` from a checkpoint of
either package.

One `TrainStep` per input-size bucket, all on one model and one
velocity; batches come from `TrainLoader` (threaded decode and
augmentation, a pinned non-blocking copy to the card). Metrics go to
stdout and a JSONL file, and with `--tensorboard-dir` to TensorBoard
event files (`utils/tb_writer.py`). The validation Detector is built
once; each validation copies the training model's state into it, so
validation runs the eval-mode detect path with its kernels.

Example:
    python -m mydetection_tpu_torch.train --model yolov3 \\
        --ann data/train.json --img-dir data/train2017 \\
        --batch-size 16 --iterations 5000

`--device` defaults to cuda (an error when no GPU is visible); pass
`--device cpu` to train on the CPU. `--data-parallel` splits each batch
over every device of `parallel.mesh.make_mesh()` when there is more
than one, as the JAX CLI's flag does over `jax.devices()`: one global
step (`training.DataParallelTrainStep`), checkpoints and validation
from the first replica; with one device it is the single-device run. Weights start from
`init_weights(model, --seed)`, which draws other values than the JAX
package's `fast_init` of the same seed: start both packages from one
file (`--resume`, `--pretrained-backbone`) to compare them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="yolov3")
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--iterations", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--burn-in", type=int, default=1000)
    ap.add_argument("--milestones", type=int, nargs="*", default=[])
    ap.add_argument("--sizes", type=int, nargs="*", default=None,
                    help="multi-scale bucket list (default: model size ±96)")
    ap.add_argument("--rescale-every", type=int, default=10)
    ap.add_argument("--rotate-prob", type=float, default=None,
                    help="arbitrary-rotation augmentation probability "
                         "(default: 0.5 for rotated models, 0 otherwise)")
    ap.add_argument("--max-gt", type=int, default=100)
    ap.add_argument("--num-threads", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="weights")
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--resume", default=None,
                    help="checkpoint path to resume from (either package's)")
    ap.add_argument("--pretrained-backbone", default=None,
                    help="darknet53.conv.74-style backbone-only weights "
                         "to initialize from (yolov3/rapid)")
    ap.add_argument("--tensorboard-dir", default=None,
                    help="also write TensorBoard event files here")
    ap.add_argument("--val-ann", default=None)
    ap.add_argument("--val-img-dir", default=None)
    ap.add_argument("--val-every", type=int, default=0)
    ap.add_argument("--val-max-images", type=int, default=500)
    ap.add_argument("--data-parallel", action="store_true",
                    help="split each batch over every local device "
                         "(one global step; no-op with one device)")
    ap.add_argument("--float32", action="store_true",
                    help="float32 compute, TF32 off on the card "
                         "(default bf16)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> int:
    """Run the CLI on `argv` (None: sys.argv); returns the last
    iteration."""
    args = build_parser().parse_args(argv)

    from mydetection_tpu_torch.evaluate import tf32_off

    with tf32_off(args.device) if args.float32 else contextlib.nullcontext():
        return _train(args)


def _train(args) -> int:
    from mydetection_tpu_torch import checkpoint as ckpt_lib
    from mydetection_tpu_torch.convert import from_jax_params, model_tree
    from mydetection_tpu_torch.data.coco import CocoDataset
    from mydetection_tpu_torch.data.loader import TrainLoader
    from mydetection_tpu_torch.models.layers import init_weights
    from mydetection_tpu_torch.parallel.mesh import make_mesh
    from mydetection_tpu_torch.registry import default_config, get_model
    from mydetection_tpu_torch.training import burn_in_lr, make_train_step

    # the registered config, not the literal name: any rotated
    # registration gets the rotated parser
    rotated = default_config(args.model).rotated
    ds = CocoDataset(args.ann, args.img_dir, rotated=rotated, skip_empty=True)
    overrides = {}
    if args.float32:
        overrides["compute_dtype"] = torch.float32
    model = get_model(args.model,
                      num_classes=max(ds.num_classes, 1) if not rotated else 1,
                      **overrides)
    cfg = model.config
    sizes = args.sizes or sorted({max(cfg.input_size - 96, 128),
                                  cfg.input_size,
                                  cfg.input_size + 96})
    device = torch.device(args.device)
    mesh = make_mesh() if args.data_parallel else []
    if len(mesh) > 1:
        if device.type != mesh[0].type:
            raise SystemExit(f"--data-parallel runs on the local devices "
                             f"{[str(d) for d in mesh]}, not --device "
                             f"{args.device}")
        device = mesh[0]
    else:
        mesh = None
    print(f"model={cfg.name} classes={cfg.num_classes} sizes={sizes} "
          f"dataset={len(ds)} imgs device={device}")

    init_weights(model, args.seed)
    if args.pretrained_backbone:
        if cfg.family not in ("yolov3", "rapid"):
            raise SystemExit("--pretrained-backbone is darknet-format "
                             "(yolov3/rapid families only)")
        from mydetection_tpu_torch.weight_import import (
            load_darknet_backbone_weights,
        )
        params = load_darknet_backbone_weights(model_tree(model),
                                               args.pretrained_backbone)
        model.load_state_dict(from_jax_params(ckpt_lib.flatten_tree(params)),
                              strict=True)
        print(f"backbone initialized from {args.pretrained_backbone}")

    # one step per size bucket, sharing the model (or the replicas) and
    # one velocity
    step0 = make_train_step(model, input_size=sizes[0],
                            momentum=args.momentum,
                            weight_decay=args.weight_decay, device=device,
                            mesh=mesh)
    steps = {s: step0.at_size(s) for s in sizes}
    if mesh:
        print(f"data-parallel over {len(mesh)} devices")
    start_iter = 0
    if args.resume:
        start_iter = step0.resume(args.resume)["step"] or 0
        print(f"resumed from {args.resume} at iteration {start_iter}")

    # the loader restarts at epoch 0 on resume, as the JAX CLI's does
    loader = TrainLoader(ds, batch_size=args.batch_size, sizes=sizes,
                         max_gt=args.max_gt, num_threads=args.num_threads,
                         rotated=rotated, rotate_prob=args.rotate_prob,
                         rescale_every=args.rescale_every, seed=args.seed,
                         device=device)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    metrics_path = os.path.join(args.ckpt_dir, f"{cfg.name}_metrics.jsonl")
    from mydetection_tpu_torch.utils.tb_writer import TBWriter

    it = start_iter
    val_det = None
    t_log = time.perf_counter()
    with open(metrics_path, "a") as metrics_fh, \
            (TBWriter(args.tensorboard_dir) if args.tensorboard_dir
             else contextlib.nullcontext()) as tb:
        def record(row: dict, scalars: dict) -> None:
            print(row, flush=True)
            metrics_fh.write(json.dumps(row) + "\n")
            metrics_fh.flush()
            if tb is not None:
                tb.add_scalars(scalars, step=it)
                tb.flush()

        for images, gt_boxes, gt_classes, gt_valid, size in loader:
            if it >= args.iterations:
                break
            lr = burn_in_lr(it, base_lr=args.lr, burn_in=args.burn_in,
                            milestones=tuple(args.milestones))
            m = steps[size](images, gt_boxes, gt_classes, gt_valid, lr)
            it += 1

            if it % args.log_every == 0:
                m = {k: float(v) for k, v in m.items()}
                dt = time.perf_counter() - t_log
                t_log = time.perf_counter()
                rate = args.log_every * args.batch_size / dt
                record({"iter": it, "lr": float(lr), "size": size,
                        "img_per_sec": round(rate, 2),
                        **{k: round(v, 5) for k, v in m.items()}},
                       {"train/lr": float(lr), "train/img_per_sec": rate,
                        **{f"loss/{k}": v for k, v in m.items()}})

            if it % args.ckpt_every == 0 or it == args.iterations:
                path = os.path.join(args.ckpt_dir, f"{cfg.name}_{it}.npz")
                step0.save(path, step=it)
                print(f"checkpoint -> {path}", flush=True)

            if args.val_every and it % args.val_every == 0 and args.val_ann:
                # built once; each validation copies the training state
                # into its eval-mode model (channels_last on the card,
                # the kernels routed)
                if val_det is None:
                    from mydetection_tpu_torch import Detector
                    val_det = Detector(model_name=args.model, device=device,
                                       num_classes=cfg.num_classes,
                                       **overrides)
                val_det.model.load_state_dict(model.state_dict())
                stats = _validate(val_det, args, rotated)
                record({"iter": it, "val_AP": stats.get("AP", stats.get("AP50")),
                        "val_AP50": stats["AP50"]},
                       {"val/AP": stats.get("AP", stats.get("AP50")) or 0.0,
                        "val/AP50": stats["AP50"]})

    print(f"done at iteration {it}")
    return it


def _validate(det, args, rotated: bool) -> dict:
    img_dir = args.val_img_dir or args.img_dir
    if rotated:
        # rotated models score with rotated-IoU matching, not
        # enclosing-box COCO AP
        from mydetection_tpu_torch.eval.rotated_eval import (
            evaluate_rotated_detector,
        )
        return evaluate_rotated_detector(det, args.val_ann, img_dir,
                                         max_images=args.val_max_images,
                                         verbose=False)
    from mydetection_tpu_torch.eval.evaluator import evaluate_detector
    return evaluate_detector(det, args.val_ann, img_dir,
                             max_images=args.val_max_images, verbose=False)


if __name__ == "__main__":
    main()
