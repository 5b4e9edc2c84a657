"""COCO-JSON dataset + fisheye (rotated-box) datasets.

Reference parity: `datasets.py` in duanzhiihao/myDetection [recalled;
SURVEY.md §2.11] — COCO-JSON loader indexed by image with per-image
annotation lists and a category-id remap to contiguous ids, plus the
fisheye datasets (CEPDOF / MW-R / HABBOF) whose annotations carry
rotated person boxes [cx, cy, w, h, degrees].

A copy of `mydetection_tpu/data/coco.py`. Host-side only (numpy/PIL);
feeds the threaded prefetch loader (`mydetection_tpu_torch.data.loader`). Labels are returned in ORIGINAL image
pixels as cxcywh(+θ rad); letterboxing to network coords happens at
batch-assembly time so multi-scale training can re-letterbox cheaply.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np
from PIL import Image


class CocoDataset:
    """Detection dataset over a COCO-style annotation JSON.

    rotated=False: boxes (N, 4) cxcywh; categories remapped to
    contiguous [0, C). rotated=True: boxes (N, 5) cxcywhθ, θ radians
    (annotation degrees converted); single or multi class.
    """

    def __init__(self, ann_file: str | dict, img_dir: str, *,
                 rotated: bool = False, skip_empty: bool = False):
        if isinstance(ann_file, str):
            with open(ann_file) as fh:
                gt = json.load(fh)
        else:
            gt = ann_file
        self.img_dir = img_dir
        self.rotated = rotated
        self.imgs = {im["id"]: im for im in gt["images"]}
        cats = sorted(c["id"] for c in gt.get("categories", [])) or [1]
        self.cat_to_contig = {c: i for i, c in enumerate(cats)}
        self.contig_to_cat = {i: c for c, i in self.cat_to_contig.items()}
        self.num_classes = len(cats)

        anns_by_img: dict[int, list] = defaultdict(list)
        for ann in gt.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            anns_by_img[ann["image_id"]].append(ann)
        self.ids = [i for i in sorted(self.imgs)
                    if not skip_empty or anns_by_img.get(i)]
        self._anns = anns_by_img

    def __len__(self) -> int:
        return len(self.ids)

    def load_image(self, img_id: int) -> np.ndarray:
        info = self.imgs[img_id]
        path = os.path.join(self.img_dir, info.get("file_name", f"{img_id}.jpg"))
        return np.asarray(Image.open(path).convert("RGB"))

    def load_labels(self, img_id: int) -> tuple[np.ndarray, np.ndarray]:
        """(boxes cxcywh(θ), contiguous class ids) in original pixels."""
        anns = self._anns.get(img_id, [])
        dim = 5 if self.rotated else 4
        boxes = np.zeros((len(anns), dim), np.float32)
        classes = np.zeros((len(anns),), np.int32)
        for i, ann in enumerate(anns):
            bb = ann["bbox"]
            if self.rotated and len(bb) >= 5:
                boxes[i] = [bb[0], bb[1], bb[2], bb[3], np.radians(bb[4])]
            elif self.rotated:
                boxes[i] = [bb[0] + bb[2] / 2, bb[1] + bb[3] / 2, bb[2], bb[3], 0.0]
            else:
                # COCO bbox is top-left xywh
                boxes[i] = [bb[0] + bb[2] / 2, bb[1] + bb[3] / 2, bb[2], bb[3]]
            cat = ann["category_id"]
            if cat not in self.cat_to_contig:
                raise ValueError(
                    f"annotation {ann.get('id', '?')} (image {img_id}) "
                    f"has category_id={cat}, absent from the dataset's "
                    f"categories {sorted(self.cat_to_contig)} — refusing "
                    f"to silently relabel it as class 0")
            classes[i] = self.cat_to_contig[cat]
        return boxes, classes

    def __getitem__(self, index: int) -> dict:
        img_id = self.ids[index]
        image = self.load_image(img_id)
        boxes, classes = self.load_labels(img_id)
        return {"image": image, "boxes": boxes, "classes": classes,
                "image_id": img_id}


def letterbox_labels(boxes: np.ndarray, ratio: float, pad_x: float,
                     pad_y: float) -> np.ndarray:
    """Map cxcywh(θ) labels from original pixels to network pixels."""
    out = boxes.copy()
    if len(out):
        out[:, 0] = out[:, 0] * ratio + pad_x
        out[:, 1] = out[:, 1] * ratio + pad_y
        out[:, 2:4] *= ratio
    return out
