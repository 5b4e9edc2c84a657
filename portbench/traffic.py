"""The one traffic generator: a mix file of parameters → a pool of
batches made from `--seed`.

A mix (`traffic/<name>.json`) has a `kind`:

  * "detect": `pool` batches of `batch` letterboxed uint8 canvases
    (B, S, S, 3), already on the device, as the evaluator's loader
    hands them over, with each image's letterbox geometry. Each image
    takes one of `source_sizes` (w, h) — the same multiset for every
    seed, in the seed's order — is scaled to fit S and centred on a
    `pad_value` canvas; its pixels are uniform noise.
  * "train": `pool` batches of `batch` uint8 images (B, S, S, 3) in
    pinned host memory, uploaded by the train step as its loader's are,
    and GT padded to `max_gt` rows: `min_boxes` to `max_boxes` boxes an
    image (the same multiset of counts for every seed, in the seed's
    order), centres uniform on the canvas, sides uniform in
    [S/32, S/2], classes uniform.

S is the configuration's input size. Large tensors are drawn on the
device in one call; the few per-image numbers on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import seeds


@dataclasses.dataclass(frozen=True)
class Letterbox:
    """Where an original image of ori_w x ori_h sits on the canvas."""

    ori_w: int
    ori_h: int
    ratio: float
    pad_x: float
    pad_y: float
    input_size: int


def letterbox_geometry(w: int, h: int, size: int) -> tuple[Letterbox, int, int]:
    ratio = size / max(w, h)
    new_w = max(1, int(round(w * ratio)))
    new_h = max(1, int(round(h * ratio)))
    x0, y0 = (size - new_w) // 2, (size - new_h) // 2
    return Letterbox(w, h, ratio, float(x0), float(y0), size), new_w, new_h


def _spread(values: list, n: int, rng: np.random.Generator) -> list:
    """n picks cycling through `values`, in an order drawn from rng."""
    picks = [values[i % len(values)] for i in range(n)]
    return [picks[i] for i in rng.permutation(n)]


def detect_pool(mix: dict, size: int, seed: int, device) -> list[dict]:
    """[{"canvases": uint8 (B, S, S, 3) on device, "infos": [Letterbox]}]."""
    pool, batch = int(mix["pool"]), int(mix["batch"])
    n = pool * batch
    rng = seeds.numpy_rng(seed, "traffic")
    sizes = _spread([tuple(s) for s in mix["source_sizes"]], n, rng)
    geo = [letterbox_geometry(w, h, size) for w, h in sizes]
    x0 = torch.tensor([int(g.pad_x) for g, _, _ in geo], device=device)
    y0 = torch.tensor([int(g.pad_y) for g, _, _ in geo], device=device)
    nw = torch.tensor([w for _, w, _ in geo], device=device)
    nh = torch.tensor([h for _, _, h in geo], device=device)
    gen = seeds.torch_gen(seed, "canvases", device)
    noise = torch.randint(0, 256, (n, size, size, 3), generator=gen,
                          device=device, dtype=torch.uint8)
    ar = torch.arange(size, device=device)
    inside = (((ar[None, :] >= y0[:, None]) & (ar[None, :] < (y0 + nh)[:, None]))
              [:, :, None]
              & ((ar[None, :] >= x0[:, None]) & (ar[None, :] < (x0 + nw)[:, None]))
              [:, None, :])
    canvases = torch.where(inside[..., None], noise,
                           torch.tensor(int(mix["pad_value"]), device=device,
                                        dtype=torch.uint8))
    return [{"canvases": canvases[i * batch:(i + 1) * batch].contiguous(),
             "infos": [g for g, _, _ in geo[i * batch:(i + 1) * batch]]}
            for i in range(pool)]


def train_pool(mix: dict, size: int, num_classes: int, seed: int,
               device) -> list[dict]:
    """[{"images": uint8 (B, S, S, 3) pinned host tensor (a plain one on
    a CPU run), "boxes": (B, M, 4) cxcywh, "classes": (B, M) int64,
    "valid": (B, M) bool}], the GT as host tensors."""
    pool, batch, max_gt = int(mix["pool"]), int(mix["batch"]), int(mix["max_gt"])
    n = pool * batch
    rng = seeds.numpy_rng(seed, "traffic")
    counts = _spread(list(range(int(mix["min_boxes"]),
                                int(mix["max_boxes"]) + 1)), n, rng)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    classes = np.zeros((n, max_gt), np.int64)
    valid = np.zeros((n, max_gt), bool)
    for i, k in enumerate(counts):
        centre = rng.uniform(0, size, (k, 2))
        wh = rng.uniform(size / 32, size / 2, (k, 2))
        boxes[i, :k] = np.concatenate([centre, wh], 1)
        classes[i, :k] = rng.integers(0, num_classes, k)
        valid[i, :k] = True
    gen = seeds.torch_gen(seed, "images", device)
    images = torch.randint(0, 256, (n, size, size, 3), generator=gen,
                           device=device, dtype=torch.uint8).cpu()
    if torch.device(device).type == "cuda":
        images = images.pin_memory()
    out = []
    for i in range(pool):
        s = slice(i * batch, (i + 1) * batch)
        out.append({"images": images[s], "boxes": torch.from_numpy(boxes[s]),
                    "classes": torch.from_numpy(classes[s]),
                    "valid": torch.from_numpy(valid[s])})
    return out
