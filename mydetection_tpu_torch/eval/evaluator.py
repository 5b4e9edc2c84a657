"""End-to-end COCO evaluation of a Detector (the reference's
`evaluate.py` core) with streaming batched inference.

A port of `mydetection_tpu/eval/evaluator.py`. Flow: annotation JSON →
image paths → StreamingPipeline (threaded decode + letterbox + a
pinned, non-blocking copy to the detector's device) →
Detector.detect_prepared → COCO result rows → the pure-numpy
COCOEvaluator (protocol-compatible with pycocotools).
"""

from __future__ import annotations

import json
import os
import time

from mydetection_tpu_torch.data.loader import StreamingPipeline
from mydetection_tpu_torch.eval.cocoeval import COCOEvaluator, COCOGt


def evaluate_detector(detector, ann_file: str | dict, img_dir: str, *,
                      conf_thres: float = 0.005, nms_iou: float = 0.45,
                      batch_size: int = 32, input_size: int | None = None,
                      max_images: int | None = None, num_threads: int = 4,
                      results_path: str | None = None,
                      verbose: bool = True) -> dict:
    """Run COCO-val evaluation; returns the stats dict (AP, AP50, ...).
    Batches go to `detector.device`."""
    gt = ann_file if isinstance(ann_file, COCOGt) else COCOGt(ann_file)
    size = input_size or detector.cfg.input_size

    img_ids = gt.img_ids[:max_images] if max_images else gt.img_ids
    paths, ids = [], []
    for img_id in img_ids:
        info = gt.imgs[img_id]
        paths.append(os.path.join(img_dir, info.get("file_name", f"{img_id}.jpg")))
        ids.append(img_id)

    # contiguous class id -> original COCO category id, from THIS
    # annotation file's sorted category list (the same mapping
    # CocoDataset derives at train time — a model is only evaluable
    # against an annotation file with a compatible category set)
    contig_to_cat = {i: c for i, c in enumerate(sorted(gt.cats))}
    if gt.cats and detector.cfg.num_classes != len(gt.cats):
        raise ValueError(
            f"model {detector.cfg.name!r} predicts "
            f"{detector.cfg.num_classes} classes but the annotation "
            f"file defines {len(gt.cats)} categories — class ids would "
            f"map to wrong (or missing) category_ids. Build the "
            f"Detector with num_classes={len(gt.cats)} (the evaluate "
            f"CLI does this automatically) or evaluate against the "
            f"dataset the model was trained on")

    results: list[dict] = []
    t0 = time.perf_counter()
    pos = 0
    pipe = StreamingPipeline(paths, input_size=size, batch_size=batch_size,
                             num_threads=num_threads, device=detector.device)
    for canvases, infos, _ in pipe:
        dets = detector.detect_prepared(canvases, infos,
                                        conf_thres=conf_thres,
                                        nms_iou=nms_iou)
        for d in dets:
            results.extend(d.to_coco(ids[pos], category_map=contig_to_cat))
            pos += 1
    dt = time.perf_counter() - t0
    if verbose:
        print(f"inference: {len(paths)} images in {dt:.3f}s "
              f"({len(paths) / max(dt, 1e-9):.1f} img/s), "
              f"{len(results)} detections")

    if results_path:
        with open(results_path, "w") as fh:
            json.dump(results, fh)

    if gt.img_ids and max_images:
        # restrict GT to the evaluated subset so AP is consistent
        ids_set = set(ids)
        subset = {
            "images": [gt.imgs[i] for i in ids],
            "categories": list(gt.cats.values()),
            "annotations": [a for key, anns in gt.anns_by_img_cat.items()
                            if key[0] in ids_set for a in anns],
        }
        evaluator = COCOEvaluator(subset)
    else:
        evaluator = COCOEvaluator(gt)
    t0 = time.perf_counter()
    stats = evaluator.evaluate(results, verbose=verbose)
    if verbose:
        print(f"scoring: {time.perf_counter() - t0:.3f}s")
    return stats
