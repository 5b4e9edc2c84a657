"""Host-pipelined data loading: threaded decode + device prefetch.

A port of `mydetection_tpu/data/loader.py`. A host THREAD pool (PIL,
numpy and the native decoder release the GIL for the heavy parts)
feeds a bounded reorder buffer, and each batch is stacked into a fresh
pinned host buffer and copied to the card with `non_blocking=True`, so
decode and the copy overlap the consumer's device work.

Two front-ends:
  * `StreamingPipeline` — inference: image paths → ready device batches
    (letterboxed uint8 canvases + LetterboxInfo list).
  * `TrainLoader` — training: dataset → (images, gt_boxes, gt_classes,
    gt_valid, size) batches with augmentation + multi-scale size
    buckets; images on the device, the GT as numpy.

The device is explicit, as in `Detector`: `device=None` means "cuda"
and raises when no GPU is visible; pass `device="cpu"`, or
`device_put=False` for numpy batches.

Determinism: each item's augmentation RNG is seeded by (seed, epoch,
index), so results are independent of thread scheduling, and equal to
the JAX package's loader for the same dataset and seed.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from mydetection_tpu_torch.data.coco import letterbox_labels
from mydetection_tpu_torch.data.transforms import random_augment
from mydetection_tpu_torch.utils.image_ops import LetterboxInfo, letterbox_np

_STOP = object()


def resolve_device(device, device_put: bool, who: str) -> torch.device | None:
    """The device batches go to: None when `device_put` is off (numpy
    batches), else `device` (None: "cuda", an error when no GPU is
    visible)."""
    if not device_put:
        return None
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} puts batches on CUDA by default and no "
                           "GPU is visible; pass device='cpu' (or "
                           "device_put=False for numpy batches)")
    return device


def stack_to(arrays: list[np.ndarray], device: torch.device | None):
    """Stack equal-shape uint8 arrays into one batch on `device` (None:
    a numpy array). For the card the batch is stacked straight into a
    fresh pinned host buffer and copied with `non_blocking=True`: the
    buffer is never refilled, and PyTorch's pinned-memory allocator
    does not hand its block out again until the copy has finished."""
    if device is None:
        return np.stack(arrays)
    if device.type == "cuda":
        host = torch.empty((len(arrays), *arrays[0].shape),
                           dtype=torch.uint8, pin_memory=True)
        np.stack(arrays, out=host.numpy())
        return host.to(device, non_blocking=True)
    return torch.from_numpy(np.stack(arrays)).to(device)


class _ThreadPool:
    """Ordered map over an index stream with N worker threads.

    Workers pull indices, compute `fn(index)`, and results are yielded
    IN ORDER (a reorder buffer keeps the output deterministic while
    decode parallelism stays unordered underneath).
    """

    def __init__(self, fn: Callable[[int], object], indices: Iterable[int],
                 num_threads: int, prefetch: int):
        self._fn = fn
        self._in: queue.Queue = queue.Queue()
        self._done: dict[int, object] = {}
        self._done_lock = threading.Condition()
        self._indices = list(indices)
        self._max_ahead = max(prefetch, num_threads) * 2
        self._next_emit = 0
        self._closed = False
        self._errors: list[BaseException] = []
        for pos, idx in enumerate(self._indices):
            self._in.put((pos, idx))
        for _ in range(num_threads):
            self._in.put(_STOP)
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            item = self._in.get()
            if item is _STOP:
                return
            pos, idx = item
            # backpressure: don't run far ahead of the consumer
            with self._done_lock:
                while (pos - self._next_emit > self._max_ahead
                       and not self._errors and not self._closed):
                    self._done_lock.wait(timeout=0.5)
                if self._errors or self._closed:
                    # another worker failed (the consumer is about to
                    # raise) or the consumer abandoned the stream: stop
                    # instead of waiting forever with the buffer pinned
                    return
            try:
                result = self._fn(idx)
            except BaseException as e:  # re-raised on the consumer side
                with self._done_lock:
                    self._errors.append(e)
                    self._done_lock.notify_all()
                return
            with self._done_lock:
                self._done[pos] = result
                self._done_lock.notify_all()

    def close(self):
        """Release the workers. Called when the iterator finishes OR is
        abandoned (generator finally): a consumer breaking out
        mid-stream (the train CLI's iteration cap, a partially-read
        StreamingPipeline) would otherwise leave every worker waiting
        in the backpressure loop with the reorder buffer pinned."""
        with self._done_lock:
            self._closed = True
            self._done_lock.notify_all()

    def __iter__(self):
        try:
            for pos in range(len(self._indices)):
                with self._done_lock:
                    while pos not in self._done and not self._errors:
                        self._done_lock.wait()
                    if self._errors:
                        raise self._errors[0]
                    result = self._done.pop(pos)
                    self._next_emit = pos + 1
                    self._done_lock.notify_all()
                yield result
        finally:
            self.close()


class StreamingPipeline:
    """Paths → device-ready letterboxed batches, decode overlapped.

    Usage:
        pipe = StreamingPipeline(paths, input_size=416, batch_size=64)
        for canvases, infos, paths_batch in pipe:
            dets = detector.detect_prepared(canvases, infos)
    Batches are padded to `batch_size` by repeating the last image
    (one shape for every batch); `infos` carries the true count.
    `canvases` is a uint8 (B, S, S, 3) tensor on `device`, or numpy
    with `device_put=False`.
    """

    def __init__(self, paths: Sequence[str], *, input_size: int,
                 batch_size: int = 64, num_threads: int = 4,
                 device_put: bool = True, native: str | bool = "auto",
                 load_fn: Callable[[str], tuple] | None = None,
                 pack_s2d2: bool = False,
                 device: str | torch.device | None = None):
        if pack_s2d2:
            raise ValueError("pack_s2d2 is the TPU darknet stem's "
                             "space-to-depth input layout; the PyTorch "
                             "port runs the standard stem on (B, S, S, 3) "
                             "canvases and does not implement it")
        self.paths = list(paths)
        self.input_size = input_size
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.device_put = device_put
        self.device = resolve_device(device, device_put, "StreamingPipeline")
        # load_fn(path) -> (canvas u8 (S,S,3), LetterboxInfo) overrides
        # the decoder (benchmarks bound the overlap with a synthetic
        # decode independent of the host's CPU)
        self.load_fn = load_fn
        # the native C++ decode+letterbox (mydetection_tpu_torch.native):
        # "auto" uses it when the library builds, falling back per image
        # on non-JPEG inputs; False forces the PIL path
        if native == "auto":
            from mydetection_tpu_torch import native as native_mod

            self._native = native_mod if native_mod.available() else None
        elif native:
            from mydetection_tpu_torch import native as native_mod

            self._native = native_mod
        else:
            self._native = None

    @property
    def decoder(self) -> str:
        """Which decoder `_load` uses: "load_fn", "native" or "pil"."""
        if self.load_fn is not None:
            return "load_fn"
        return "native" if self._native is not None else "pil"

    def _load(self, i: int):
        if self.load_fn is not None:
            return self.load_fn(self.paths[i])
        if self._native is not None:
            try:
                return self._native.decode_letterbox_file(
                    self.paths[i], self.input_size)
            except (ValueError, RuntimeError):
                pass  # non-JPEG or decode failure: PIL fallback
        from PIL import Image

        img = Image.open(self.paths[i]).convert("RGB")
        canvas, info = letterbox_np(np.asarray(img), self.input_size)
        return canvas, info

    def __iter__(self):
        pool = _ThreadPool(self._load, range(len(self.paths)),
                           self.num_threads, prefetch=2 * self.batch_size)
        it = iter(pool)
        pending = None  # double buffer: one device batch in flight
        batch_canvases: list[np.ndarray] = []
        batch_infos: list[LetterboxInfo] = []
        batch_paths: list[str] = []
        pos = 0

        def flush():
            nonlocal batch_canvases, batch_infos, batch_paths
            real = len(batch_canvases)
            if real == 0:
                return None
            while len(batch_canvases) < self.batch_size:
                batch_canvases.append(batch_canvases[-1])
            out = (stack_to(batch_canvases, self.device), batch_infos,
                   batch_paths)
            batch_canvases, batch_infos, batch_paths = [], [], []
            return out

        try:
            for canvas, info in it:
                batch_canvases.append(canvas)
                batch_infos.append(info)
                batch_paths.append(self.paths[pos])
                pos += 1
                if len(batch_canvases) == self.batch_size:
                    ready = flush()
                    if pending is not None:
                        yield pending
                    pending = ready
            tail = flush()
            if pending is not None:
                yield pending
            if tail is not None:
                yield tail
        finally:
            pool.close()  # consumer may abandon the stream mid-batch


class TrainLoader:
    """Dataset → augmented, letterboxed, padded label batches.

    Iterates epochs indefinitely; `sizes` is the multi-scale bucket
    list — a new size is drawn every `rescale_every` batches. Images
    come as uint8 (B, S, S, 3) on `device` (numpy with
    `device_put=False`), the GT as numpy, as `TrainStep.batch` takes
    them.
    """

    def __init__(self, dataset, *, batch_size: int, sizes: Sequence[int],
                 max_gt: int = 100, num_threads: int = 4, augment: bool = True,
                 rotated: bool = False, rotate_prob: float | None = None,
                 rescale_every: int = 10, seed: int = 0,
                 device_put: bool = True,
                 device: str | torch.device | None = None):
        if len(dataset) == 0:
            raise ValueError(
                "TrainLoader: dataset is empty — every epoch would "
                "yield zero batches and the training loop would spin "
                "forever (check the annotation file / skip_empty)")
        self.ds = dataset
        self.batch_size = batch_size
        self.sizes = list(sizes)
        self.max_gt = max_gt
        self.num_threads = num_threads
        self.augment = augment
        self.rotated = rotated
        # arbitrary rotation is the key symmetry of overhead-fisheye
        # rotated boxes: on by default for rotated datasets, off for
        # axis-aligned ones (the enclosing box would degrade labels)
        self.rotate_prob = (0.5 if rotated else 0.0) \
            if rotate_prob is None else float(rotate_prob)
        self.rescale_every = rescale_every
        self.seed = seed
        self.device_put = device_put
        self.device = resolve_device(device, device_put, "TrainLoader")

    def _load(self, work: tuple[int, int, int]):
        epoch, index, size = work
        item = self.ds[index]
        image, boxes, classes = item["image"], item["boxes"], item["classes"]
        if self.augment:
            rng = np.random.RandomState(
                (self.seed * 9_999_991 + epoch * 1_000_003 + index) % (2 ** 31))
            image, boxes, classes = random_augment(
                image, boxes, rng, rotated=self.rotated,
                rotate_prob=self.rotate_prob, classes=classes)
        canvas, info = letterbox_np(image, size)
        boxes = letterbox_labels(boxes, info.ratio, info.pad_x, info.pad_y)
        return canvas, boxes, classes

    def epoch(self, epoch_idx: int):
        """One epoch of batches: (images u8, gt_boxes, gt_classes, gt_valid, size)."""
        rng = np.random.RandomState(self.seed + epoch_idx)
        order = rng.permutation(len(self.ds))
        # every index is visited every epoch: the tail `len % batch`
        # images form a final batch padded (to the batch shape) by
        # cycling the permutation — real images with real labels, never
        # dropped; np.resize cycles as often as needed, so a dataset
        # SMALLER than one batch still yields a full batch
        total = len(order) + (-len(order)) % self.batch_size
        if total != len(order) and len(order):
            order = np.resize(order, total)
        nb = len(order) // self.batch_size
        sizes = []
        size = self.sizes[0]
        for bi in range(nb):
            if bi % self.rescale_every == 0:
                size = self.sizes[int(rng.randint(len(self.sizes)))]
            sizes.append(size)
        work = [(epoch_idx, int(order[bi * self.batch_size + j]), sizes[bi])
                for bi in range(nb) for j in range(self.batch_size)]
        pool = _ThreadPool(lambda w: self._load(work[w]), range(len(work)),
                           self.num_threads, prefetch=2 * self.batch_size)
        it = iter(pool)

        dim = 5 if self.rotated else 4
        try:
            yield from self._batches(it, sizes, nb, dim)
        finally:
            pool.close()  # train loops break out at an iteration cap

    def _batches(self, it, sizes, nb, dim):
        for bi in range(nb):
            canvases, all_boxes, all_classes = [], [], []
            for _ in range(self.batch_size):
                c, b, cl = next(it)
                canvases.append(c)
                all_boxes.append(b)
                all_classes.append(cl)
            gt_boxes = np.zeros((self.batch_size, self.max_gt, dim), np.float32)
            gt_classes = np.zeros((self.batch_size, self.max_gt), np.int32)
            gt_valid = np.zeros((self.batch_size, self.max_gt), bool)
            for j, (b, cl) in enumerate(zip(all_boxes, all_classes)):
                k = min(len(b), self.max_gt)
                if k:
                    gt_boxes[j, :k] = b[:k]
                    gt_classes[j, :k] = cl[:k]
                    gt_valid[j, :k] = True
            images = stack_to(canvases, self.device)
            yield images, gt_boxes, gt_classes, gt_valid, sizes[bi]

    def __iter__(self):
        epoch_idx = 0
        while True:
            yield from self.epoch(epoch_idx)
            epoch_idx += 1
