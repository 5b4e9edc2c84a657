"""Export: the detect pipeline as `torch.export` programs in one artifact.

The port of `mydetection_tpu/export.py`. Where the JAX package
serializes its jitted pipeline as StableHLO, the port traces the
Detector's dense forward and postprocess (the same `_forward_dense` and
`make_post` the live Detector runs) with `torch.export` into one
program per (input size × batch) bucket:

    fn(param_leaves, images_u8 (B, S, S, 3), conf_thres (B,)) → padded dets

The parameters are inputs of every program, so all buckets share one
copy of the weights in the artifact: the model's state-dict tensors,
or, for an int8 Detector, the modules' tensors and the quantized tree's
leaves flattened in a fixed order and rebuilt inside `fn` (as the JAX
module closes over its `treedef`). On the card the programs call the
hand-written kernels as the `mydet::` custom ops of `kernels.ops`, so a
served program launches exactly the live Detector's kernels; a
`use_pallas=False` Detector exports the plain versions and its
artifact calls no custom op.

The artifact is one `.npz`: `__meta__` (JSON: the JAX module's keys
where their meaning holds, plus `use_pallas`, `torch_version`,
`custom_ops` and each leaf's dtype and strides), `params/<i>` (the
leaves) and `__pt2__<size>x<b>` (each program's `torch.export.save`
bytes).
`load_exported` serves it without building a model: it imports
`kernels.ops` so that the programs' ops resolve, and nothing of
`registry`. `nms_iou` is baked in at export; `conf_thres` stays an input.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

from mydetection_tpu_torch.checkpoint import SEP

_FORMAT = "mydetection-torch-export"
_VERSION = 1
# the JAX package's artifacts: StableHLO that this package cannot run
_JAX_FORMAT = "mydetection-tpu-export"
_BLOB = "__pt2__"


class _Pipeline(nn.Module):
    """The Detector's dense forward and postprocess over `parts` (the
    float model, or the int8 tree's modules) and `tree` (the int8 tree's
    other fields, whose tensor leaves come in as arguments)."""

    def __init__(self, det):
        super().__init__()
        from mydetection_tpu_torch.api import make_post

        self.cfg = det.cfg
        self.post = make_post(det.cfg)
        self.nms_iou = float(det.cfg.nms_iou)
        self.q = det._q
        if det._q is None:
            self.parts = nn.ModuleDict({"model": det.model})
            tree = {}
        else:
            fields = {f.name: getattr(det._q, f.name)
                      for f in dataclasses.fields(det._q)}
            self.parts = nn.ModuleDict({k: v for k, v in fields.items()
                                        if isinstance(v, nn.Module)})
            tree = {k: v for k, v in fields.items() if k not in self.parts}
        leaves, self.spec = pytree.tree_flatten(tree)
        self.tensor_at = [i for i, v in enumerate(leaves) if torch.is_tensor(v)]
        self.leaves = leaves            # the non-tensor leaves stay as they are
        self.tree_tensors = [leaves[i] for i in self.tensor_at]

    def forward(self, tree_tensors, images, conf):
        leaves = list(self.leaves)
        for i, t in zip(self.tensor_at, tree_tensors):
            leaves[i] = t
        if self.q is None:
            from mydetection_tpu_torch.registry import forward_dense

            dense = forward_dense(self.parts["model"], images)
        else:
            from mydetection_tpu_torch import quant

            qp = dataclasses.replace(
                self.q, **dict(self.parts.items()),
                **pytree.tree_unflatten(leaves, self.spec))
            dense = quant.forward_dense_quantized(qp, images, self.cfg)
        return self.post(dense, conf, self.nms_iou)


class _Program(nn.Module):
    """fn(param_leaves, images, conf) with no state of its own: the
    first leaves replace `pipeline`'s module tensors (by
    `torch.func.functional_call`), the rest are the int8 tree's."""

    def __init__(self, pipeline: _Pipeline):
        super().__init__()
        # kept off the module tree, so export lifts none of its tensors
        object.__setattr__(self, "_pipeline", pipeline)
        self.names = list(pipeline.state_dict(keep_vars=True))

    def leaves(self) -> list[torch.Tensor]:
        state = self._pipeline.state_dict(keep_vars=True)
        return [state[n].detach() for n in self.names] \
            + list(self._pipeline.tree_tensors)

    def forward(self, param_leaves, images, conf):
        n = len(self.names)
        state = dict(zip(self.names, param_leaves[:n]))
        return torch.func.functional_call(
            self._pipeline, state, (list(param_leaves[n:]), images, conf))


def _sizes(value, name: str) -> list[int]:
    out = sorted({int(v) for v in ((value,) if isinstance(value, int)
                                   else value)})
    if not out or out[0] < 1:
        raise ValueError(f"{name} must be one or more positive ints, got "
                         f"{value!r}")
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:       # numpy has no bfloat16: its bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str, stride, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if dtype == "torch.bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    out = torch.empty_strided(t.shape, stride, dtype=t.dtype, device=device)
    return out.copy_(t)


def _drop_metadata_asserts(ep) -> None:
    """Erase the `aten._assert_tensor_metadata` nodes that a non-strict
    export records beside each `.to()`: checks of the traced dtype and
    device that change no value but cost one host operator each a call,
    hundreds a batch on fcos, whose batch is partly host-bound on the
    card. `_Call` checks the weights' shapes and dtypes once at load
    instead."""
    target = getattr(torch.ops.aten, "_assert_tensor_metadata", None)
    if target is None:
        return
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and node.target == target.default:
            graph.erase_node(node)
    ep.graph_module.recompile()


def export_detector(det, path: str, *, batch_size: int | Sequence[int] = 1,
                    input_size: int | Sequence[int] | None = None,
                    platforms: Sequence[str] | None = None) -> dict:
    """Export `det`'s detect pipeline at a (size × batch) bucket grid
    to `path`; returns the artifact's metadata.

    batch_size: one int or several (e.g. (1, 32): a latency bucket next
    to a throughput one). input_size: one square size or several (None:
    the model's). Every (size, batch) pair becomes one program; all
    share one copy of the weights. platforms: the device type the
    programs run on, which is the Detector's ("cuda" or "cpu"); the
    programs are traced on that device, so no other can be named.
    """
    from mydetection_tpu_torch.kernels import ops, plain_versions
    from mydetection_tpu_torch.registry import check_input_size

    cfg = det.cfg
    sizes = _sizes(cfg.input_size if input_size is None else input_size,
                   "input_size")
    for s in sizes:
        check_input_size(s)
    batch_sizes = _sizes(batch_size, "batch_size")
    device = det.device
    if platforms is not None and list(platforms) != [device.type]:
        raise ValueError(f"a torch.export program runs on the device it was "
                         f"traced on: this Detector exports for "
                         f"['{device.type}'], not {list(platforms)}")
    if getattr(det, "_replicas", None):
        raise ValueError("export a single-device Detector (data_parallel "
                         "holds one model a device)")

    program = _Program(_Pipeline(det))
    leaves = program.leaves()
    blobs, custom = {}, set()
    with torch.no_grad(), plain_versions(not det.use_pallas):
        for size in sizes:
            for b in batch_sizes:
                images = torch.zeros((b, size, size, 3), dtype=torch.uint8,
                                     device=device)
                conf = torch.full((b,), float(cfg.conf_thres),
                                  device=device)
                ep = torch.export.export(program, (leaves, images, conf),
                                         strict=False)
                _drop_metadata_asserts(ep)
                custom.update(ops.ops_in(ep))
                if getattr(ep, "example_inputs", None) is not None:
                    ep.example_inputs = None   # save would store the weights
                buf = io.BytesIO()
                torch.export.save(ep, buf)
                blobs[(size, b)] = buf.getvalue()

    meta = {
        "format": _FORMAT,
        "version": _VERSION,
        "model": cfg.name,
        "input_size": (cfg.input_size if cfg.input_size in sizes
                       else sizes[0]),
        "input_sizes": sizes,
        "batch_size": batch_sizes[-1],
        "batch_sizes": batch_sizes,
        "rotated": bool(cfg.rotated),
        "num_classes": int(cfg.num_classes),
        "class_names": list(cfg.class_names) if cfg.class_names else None,
        "conf_thres": float(cfg.conf_thres),
        "nms_iou": float(cfg.nms_iou),
        "max_dets": int(cfg.max_dets),
        "quantized": det._q is not None,
        "conf_vector": True,
        "pack_input": False,
        "use_pallas": bool(det.use_pallas),
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "custom_ops": sorted(custom),
        "param_dtypes": [str(t.dtype) for t in leaves],
        "param_strides": [list(t.stride()) for t in leaves],
    }
    flat = {f"params{SEP}{i:06d}": _to_numpy(t) for i, t in enumerate(leaves)}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                     dtype=np.uint8)
    for (size, b), blob in blobs.items():
        flat[f"{_BLOB}{size}x{b}"] = np.frombuffer(blob, dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **flat)
    return meta


@dataclasses.dataclass
class ExportedDetector:
    """Serve an `export_detector` artifact; no model-building code runs.

    detect_one / detect_batch / detect_imgSeq / detect_prepared mirror
    `Detector`'s host pipeline (letterbox → exported program → strip
    and inverse letterbox); batches are cut over the exported batch
    buckets, each chunk padded to its bucket.
    """

    meta: dict
    params: list | None
    _calls: dict  # (input_size, batch_size) -> the program's `_Call`
    device: torch.device = torch.device("cpu")

    @property
    def batch_sizes(self) -> list[int]:
        return sorted({b for _, b in self._calls})

    @property
    def input_sizes(self) -> list[int]:
        return sorted({s for s, _ in self._calls})

    def _resolve_size(self, input_size: int | None) -> int:
        size = input_size or self.meta["input_size"]
        if size not in self.input_sizes:
            raise ValueError(
                f"input_size={size} is not in this artifact's exported "
                f"buckets {self.input_sizes} — re-export with "
                f"input_size=(…, {size})")
        return size

    @property
    def cfg(self):
        """A config view over the metadata: what the evaluators and the
        serving daemon read (name, input_size, num_classes, conf_thres,
        nms_iou, rotated, max_dets, class_names)."""
        from types import SimpleNamespace

        m = self.meta
        return SimpleNamespace(
            name=m["model"], input_size=m["input_size"],
            num_classes=m.get("num_classes"), conf_thres=m["conf_thres"],
            nms_iou=m["nms_iou"], rotated=m["rotated"],
            max_dets=m["max_dets"], class_names=m["class_names"])

    @property
    def supports_conf_vector(self) -> bool:
        """The programs take one conf_thres per image, so the serving
        daemon coalesces mixed-threshold requests."""
        return bool(self.meta.get("conf_vector"))

    def warmup(self) -> None:
        """Run every (size, batch) program once, so the first request
        pays neither cuDNN's algorithm choice nor the kernels' builds."""
        for size, b in self._calls:
            self._run(torch.zeros((b, size, size, 3), dtype=torch.uint8),
                      self.meta["conf_thres"])

    def _run(self, canvases, conf) -> dict:
        """conf: one float, or one per leading row (padding rows reuse
        the last value). Returns the padded outputs as numpy."""
        images = torch.as_tensor(canvases).to(self.device)
        b, size = int(images.shape[0]), int(images.shape[1])
        call = self._calls[(size, b)]
        if np.ndim(conf) == 0:
            cv = np.full((b,), conf, np.float32)
        else:
            cv = np.asarray(conf, np.float32)
            cv = np.concatenate([cv, np.repeat(cv[-1:], b - len(cv))])
        with torch.inference_mode():
            out = call(self.params, images,
                       torch.from_numpy(cv).to(self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _chunks(self, n: int) -> list[tuple[int, int]]:
        """(rows_taken, bucket) plan covering n images.

        Fill the largest bucket while it fits; for the remainder, one
        padded call with the smallest bucket that covers it beats a pile
        of small-bucket calls unless the remainder is tiny: pad when the
        remainder fills more than half the covering bucket, or when
        greedy small-bucket filling would need > 4 calls."""
        bs = self.batch_sizes
        plan, rem = [], n
        while rem > 0:
            if rem >= bs[-1]:
                plan.append((bs[-1], bs[-1]))
                rem -= bs[-1]
                continue
            covering = [b for b in bs if b >= rem]  # non-empty: rem < bs[-1]
            b_hi = min(covering)
            filled = [b for b in bs if b <= rem]
            if not filled or rem > b_hi // 2 or rem // max(filled) > 4:
                plan.append((rem, b_hi))  # one padded call finishes
                return plan
            b = max(filled)
            plan.append((b, b))
            rem -= b
        return plan

    def _check_nms_iou(self, nms_iou: float | None) -> None:
        """`nms_iou` is baked in at export; accepting (and checking) the
        argument keeps `Detector`'s surface instead of a TypeError."""
        if nms_iou is not None and abs(nms_iou - self.meta["nms_iou"]) > 1e-9:
            raise ValueError(
                f"nms_iou is static in an exported artifact (baked at "
                f"{self.meta['nms_iou']}); re-export to change it")

    def detect_one(self, *, img_path=None, pil_img=None, np_img=None,
                   conf_thres: float | None = None,
                   nms_iou: float | None = None,
                   input_size: int | None = None, visualize: bool = False,
                   save_path: str | None = None):
        from mydetection_tpu_torch.api import (
            finalize_visualize,
            load_image_any,
            strip_detections,
        )
        from mydetection_tpu_torch.utils.image_ops import letterbox_pil

        self._check_nms_iou(nms_iou)
        img = load_image_any(img_path, pil_img, np_img)
        conf = conf_thres if conf_thres is not None else self.meta["conf_thres"]
        canvas, info = letterbox_pil(img, self._resolve_size(input_size))
        bsz = self.batch_sizes[0]  # smallest bucket: lowest latency
        out = self._run(np.repeat(canvas[None], bsz, axis=0), conf)
        dets = strip_detections(out, 0, info, rotated=self.meta["rotated"])
        return finalize_visualize(dets, img, self.meta["class_names"],
                                  visualize, save_path)

    def detect_batch(self, images, *, conf_thres: float | None = None,
                     nms_iou: float | None = None,
                     input_size: int | None = None) -> list:
        from mydetection_tpu_torch.api import load_image_any, strip_detections
        from mydetection_tpu_torch.utils.image_ops import letterbox_pil

        self._check_nms_iou(nms_iou)
        conf = conf_thres if conf_thres is not None else self.meta["conf_thres"]
        size = self._resolve_size(input_size)
        canvases, infos = [], []
        for im in images:
            canvas, info = letterbox_pil(load_image_any(im), size)
            canvases.append(canvas)
            infos.append(info)
        dets, start = [], 0
        for n, bsz in self._chunks(len(canvases)):
            chunk = canvases[start:start + n]
            chunk = chunk + [chunk[-1]] * (bsz - len(chunk))  # pad the tail
            out = self._run(np.stack(chunk), conf)
            dets += [strip_detections(out, i, infos[start + i],
                                      rotated=self.meta["rotated"])
                     for i in range(n)]
            start += n
        return dets

    # reference-name alias, matching Detector.detect_imgSeq
    def detect_imgSeq(self, img_paths: Sequence[str], **kw) -> list:
        return self.detect_batch(list(img_paths), **kw)

    def detect_prepared(self, canvases, infos, *, conf_thres=None,
                        nms_iou: float | None = None) -> list:
        """Detect on already-letterboxed uint8 canvases (B, S, S, 3),
        numpy or a tensor already on the device: the evaluator and
        serving fast path. Only the first len(infos) rows are real.
        `nms_iou` is baked into the artifact; another value is an error.
        `conf_thres` may be one float or one per image."""
        from mydetection_tpu_torch.api import strip_detections

        self._check_nms_iou(nms_iou)
        conf = conf_thres if conf_thres is not None else self.meta["conf_thres"]
        if np.ndim(conf) != 0 and len(np.asarray(conf)) != len(infos):
            raise ValueError(
                f"per-image conf_thres has {len(np.asarray(conf))} "
                f"entries for {len(infos)} images")
        if canvases.shape[-1] not in (3, 12):
            raise ValueError(
                f"detect_prepared expects (B, S, S, 3) RGB or "
                f"(B, S/2, S/2, 12) S2D-2 packed canvases, got shape "
                f"{tuple(canvases.shape)}")
        if canvases.shape[-1] == 12:
            raise ValueError(
                "S2D-2 packed canvases staged against an artifact "
                "exported without pack_input — stage unpacked "
                "(B, S, S, 3) canvases (StreamingPipeline(pack_s2d2="
                "False))")
        size = int(canvases.shape[1])
        if size not in self.input_sizes or canvases.shape[1] != canvases.shape[2]:
            raise ValueError(
                f"canvases are letterboxed to {tuple(canvases.shape[1:3])} "
                f"but the artifact is baked at input_size(s) "
                f"{self.input_sizes} — re-letterbox or re-export")
        rotated = self.meta["rotated"]
        n = len(infos)
        if (size, int(canvases.shape[0])) in self._calls:
            # the staged batch (real rows and the pipeline's padding)
            # matches a bucket: run it as it is
            out = self._run(canvases, conf)
            return [strip_detections(out, i, infos[i], rotated=rotated)
                    for i in range(n)]
        canvases = torch.as_tensor(canvases)
        dets, start = [], 0
        for take, bsz in self._chunks(n):
            chunk = canvases[start:start + take]
            if len(chunk) < bsz:
                pad = chunk[-1:].expand(bsz - len(chunk), -1, -1, -1)
                chunk = torch.cat([chunk, pad])
            c = (conf if np.ndim(conf) == 0
                 else np.asarray(conf)[start:start + take])
            out = self._run(chunk, c)
            dets += [strip_detections(out, i, infos[start + i],
                                      rotated=rotated)
                     for i in range(take)]
            start += take
        return dets


class _Call:
    """One exported program as `call(param_leaves, images, conf)`: its
    graph module on the flat inputs and the lifted constants, in
    placeholder order. This skips what `ep.module()` does on every call
    (flatten the inputs with their key paths, check each against the
    program's guards): the leaves are checked against the program's
    inputs once, at load, and the images and conf are built for their
    bucket. On the card that per-call work was host time beside a
    batch's kernels."""

    def __init__(self, ep, params: list):
        from torch.export.graph_signature import InputKind

        self.gm = ep.graph_module
        self.out_spec = ep.call_spec.out_spec
        lifted = {InputKind.CONSTANT_TENSOR: ep.constants,
                  InputKind.PARAMETER: ep.state_dict,
                  InputKind.BUFFER: ep.state_dict}
        self.slots = []    # a lifted tensor, or None for the next input
        for spec in ep.graph_signature.input_specs:
            if spec.kind == InputKind.USER_INPUT:
                self.slots.append(None)
            elif spec.kind in lifted:
                self.slots.append(lifted[spec.kind][spec.target])
            else:
                raise ValueError(f"an exported program with a {spec.kind} "
                                 f"input is not served here")
        wants = [n.meta["val"] for n, slot in zip(
            (n for n in self.gm.graph.nodes if n.op == "placeholder"),
            self.slots) if slot is None][:len(params)]
        for i, (t, want) in enumerate(zip(params, wants)):
            if t.shape != want.shape or t.dtype != want.dtype:
                raise ValueError(f"params/{i:06d} is {tuple(t.shape)} "
                                 f"{t.dtype}; the program takes "
                                 f"{tuple(want.shape)} {want.dtype}")

    def __call__(self, params: list, images: torch.Tensor,
                 conf: torch.Tensor) -> dict:
        flat = iter([*params, images, conf])
        args = [next(flat) if slot is None else slot for slot in self.slots]
        return pytree.tree_unflatten(list(self.gm(*args)), self.out_spec)


def _checked_meta(path: str, z) -> dict:
    if "__meta__" not in z.files:
        raise ValueError(f"{path} is not a {_FORMAT} artifact")
    meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    if meta.get("format") == _JAX_FORMAT:
        raise ValueError(
            f"{path} is a JAX export ({_JAX_FORMAT}): its programs are "
            f"StableHLO, which the PyTorch port cannot serve — re-export "
            f"with python -m mydetection_tpu_torch.export")
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a {_FORMAT} artifact")
    if meta.get("version", 0) > _VERSION:
        raise ValueError(
            f"artifact version {meta['version']} is newer than this "
            f"library supports ({_VERSION}) — upgrade mydetection_tpu_torch")
    return meta


def _open(path: str):
    try:
        z = np.load(path, allow_pickle=False)
    except Exception as e:  # not an npz at all (jpeg, pickle, garbage)
        raise ValueError(f"{path} is not a {_FORMAT} artifact: {e}") from e
    if not isinstance(z, np.lib.npyio.NpzFile):   # a bare .npy array
        raise ValueError(f"{path} is not a {_FORMAT} artifact")
    return z


def read_meta(path: str) -> dict:
    """An artifact's metadata, checked, without reading its weights or
    programs: raises a readable ValueError for a file that is not an
    artifact, a JAX artifact, or a newer version."""
    with _open(path) as z:
        return _checked_meta(path, z)


def load_exported(path: str, device: str | torch.device | None = None
                  ) -> ExportedDetector:
    """Load an `export_detector` artifact for serving on `device` (None:
    the device it was exported for). Only an artifact exported with
    use_pallas=False (the CLI's --oracle-nms) may be moved to another
    device: its programs run every kernel's plain version by the
    caller's choice. Any other artifact runs where it was traced, since
    a CPU trace holds the plain versions only because CPU tensors take
    them, and moving it to the card would serve without the card's
    kernels."""
    from mydetection_tpu_torch.kernels import ops  # registers mydet::

    with _open(path) as z:
        meta = _checked_meta(path, z)
        device = torch.device(meta["platforms"][0] if device is None
                              else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise ValueError(
                f"the artifact is to run on '{device}' but this process "
                f"has no GPU (it was exported for {meta['platforms']}) — "
                f"load a CPU artifact with device='cpu' (--device cpu), "
                f"or export on the serving device")
        moved = device.type not in meta["platforms"]
        if moved and meta["custom_ops"]:
            raise ValueError(
                f"artifact was exported for {meta['platforms']} and calls "
                f"the card's kernels ({', '.join(meta['custom_ops'])}); it "
                f"cannot run on '{device.type}' — re-export there")
        if moved and meta.get("use_pallas", True):
            raise ValueError(
                f"artifact was exported for {meta['platforms']} without "
                f"use_pallas=False: it runs the plain versions only "
                f"because it was traced there, and on '{device.type}' it "
                f"would serve without the hand-written kernels — re-export "
                f"on '{device.type}', or export with --oracle-nms to move "
                f"it by choice")
        prefix = f"params{SEP}"
        keys = sorted(k for k in z.files if k.startswith(prefix))
        params = [_from_numpy(z[k], dt, st, device) for k, dt, st in zip(
            keys, meta["param_dtypes"], meta["param_strides"])]
        blobs = {k: z[k] for k in z.files if k.startswith(_BLOB)}
    calls = {}
    for key, blob in blobs.items():
        size, b = (int(v) for v in key[len(_BLOB):].split("x"))
        ep = torch.export.load(io.BytesIO(blob.tobytes()))
        if moved:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, device)
            for m in ep.graph_module.modules():  # the pass edits nodes only
                if isinstance(m, torch.fx.GraphModule):
                    m.recompile()
        if ops.ops_in(ep) != meta["custom_ops"]:
            raise ValueError(f"{path}: program {size}x{b} calls "
                             f"{ops.ops_in(ep)}, the metadata says "
                             f"{meta['custom_ops']}")
        calls[(size, b)] = _Call(ep, params)
    return ExportedDetector(meta=meta, params=params, _calls=calls,
                            device=device)


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        description="Export a detector's detect pipeline to one serving "
                    "artifact (torch.export programs + weights).")
    ap.add_argument("--model", required=True, help="registered model name")
    ap.add_argument("--out", required=True, help="output artifact path")
    ap.add_argument("--weights", default=None,
                    help=".npz / .pt / .weights checkpoint (default: "
                         "random init — useful only for smoke tests)")
    ap.add_argument("--quantized", default=None, metavar="INT8_NPZ",
                    help="saved save_quantized() artifact to export the "
                         "int8 serving path instead of float")
    ap.add_argument("--batch-size", default="1",
                    help="batch bucket(s), comma-separated — e.g. 1,32 "
                         "for a latency bucket next to a throughput one")
    ap.add_argument("--input-size", default=None,
                    help="square input bucket(s), comma-separated — "
                         "e.g. 416,608 (default: model config)")
    ap.add_argument("--num-classes", type=int, default=None)
    ap.add_argument("--oracle-nms", action="store_true",
                    help="export every kernel's plain version instead of "
                         "the card's kernels (no custom ops: the artifact "
                         "may be loaded on another device)")
    ap.add_argument("--platforms", default=None,
                    help="the device type the programs run on; must be "
                         "--device's (default: --device's)")
    ap.add_argument("--float32", action="store_true",
                    help="float32 compute (default bf16)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """CLI: `python -m mydetection_tpu_torch.export --model yolov3 …`;
    prints one JSON line and returns it as a dict."""
    args = build_parser().parse_args(argv)

    from mydetection_tpu_torch import Detector

    overrides = {}
    if args.num_classes is not None:
        overrides["num_classes"] = args.num_classes
    if args.float32:
        overrides["compute_dtype"] = torch.float32
    sizes = None
    if args.input_size is not None:
        sizes = [int(x) for x in str(args.input_size).split(",")]
        overrides["input_size"] = sizes[0]
    det = Detector(model_name=args.model, weights_path=args.weights,
                   quantized=args.quantized or False, device=args.device,
                   use_pallas=False if args.oracle_nms else None, **overrides)
    platforms = args.platforms.split(",") if args.platforms else None
    meta = export_detector(
        det, args.out,
        batch_size=[int(x) for x in str(args.batch_size).split(",")],
        input_size=sizes, platforms=platforms)
    line = {"out": args.out, **{k: meta[k] for k in (
        "model", "input_sizes", "batch_sizes", "platforms", "quantized",
        "custom_ops")}}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
