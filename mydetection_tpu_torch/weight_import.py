"""Weight importers: darknet binary `.weights` and torch state dicts.

A numpy copy of `mydetection_tpu/weight_import.py`. Every importer
works on the JAX-named parameter tree (nested dicts of numpy arrays,
HWIO conv weights): `convert.model_tree(model)` is the template an
importer fills, and `convert.from_jax_params(checkpoint.flatten_tree(
tree))` loads the result into the model. So the importers need no
port-specific names, and the files they read and write are those of
the JAX package.

Darknet format (github.com/pjreddie/darknet, parser semantics):
  header: 3×int32 (major, minor, revision) then the seen counter
  (int64 if major*10+minor ≥ 2 else int32); then a flat float32
  stream. Per conv layer with BN: [β, γ, μ, σ²] each (out,), then the
  conv weights (out, in, k, k). Per conv without BN: [bias (out,)],
  then the weights. Layers in the cfg file's order, top to bottom.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mydetection_tpu_torch.checkpoint import flatten_tree, unflatten_tree
from mydetection_tpu_torch.models.darknet import STAGE_BLOCKS

Params = Any


def numpy_tree(tree: Params) -> Params:
    """A deep copy of a nested-dict tree with numpy leaves."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


# ---------------------------------------------------------------------------
# darknet binary
# ---------------------------------------------------------------------------

def _darknet53_conv_sequence(backbone: Params) -> list[tuple[Params, bool]]:
    """(conv param node, has_bn) for the 52 backbone convs in
    darknet cfg file order (= the content of darknet53.conv.74)."""
    seq: list[tuple[Params, bool]] = []

    def add_cbl(node):  # conv_bn_leaky node
        seq.append((node, True))

    add_cbl(backbone["stem"])
    for si, nblocks in enumerate(STAGE_BLOCKS):
        stage = backbone[f"stage{si}"]
        add_cbl(stage["down"])
        for bi in range(nblocks):
            add_cbl(stage[f"res{bi}"]["conv1"])
            add_cbl(stage[f"res{bi}"]["conv2"])
    return seq


def _yolov3_conv_sequence(params: Params) -> list[tuple[Params, bool]]:
    """(conv param node, has_bn) in yolov3.cfg file order."""
    seq = _darknet53_conv_sequence(params["backbone"])

    def add_cbl(node):  # conv_bn_leaky node
        seq.append((node, True))

    head = params["head"]
    for block, head_name, lateral in (("block5", "head5", "lateral4"),
                                      ("block4", "head4", "lateral3"),
                                      ("block3", "head3", None)):
        for ci in range(5):
            add_cbl(head[block][f"c{ci}"])
        add_cbl(head[head_name]["conv"])
        seq.append((head[head_name]["out"], False))
        if lateral is not None:
            add_cbl(head[lateral])
    return seq


def _read_darknet_stream(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        major, minor, _rev = np.fromfile(fh, np.int32, 3)
        if major * 10 + minor >= 2:
            np.fromfile(fh, np.int64, 1)
        else:
            np.fromfile(fh, np.int32, 1)
        return np.fromfile(fh, np.float32)


def _fill_from_stream(seq, stream: np.ndarray, *, what: str) -> None:
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(stream):
            raise ValueError(
                f"darknet {what} exhausted at {pos}+{n} > {len(stream)}")
        out = stream[pos: pos + n]
        pos += n
        return out

    for node, has_bn in seq:
        if has_bn:
            w = node["conv"]["w"]
            kh, kw, c_in, c_out = w.shape
            node["bn"]["bias"] = take(c_out).copy()
            node["bn"]["scale"] = take(c_out).copy()
            node["bn"]["mean"] = take(c_out).copy()
            node["bn"]["var"] = take(c_out).copy()
            oihw = take(c_out * c_in * kh * kw).reshape(c_out, c_in, kh, kw)
            node["conv"]["w"] = np.transpose(oihw, (2, 3, 1, 0)).copy()
        else:
            w = node["w"]
            kh, kw, c_in, c_out = w.shape
            node["b"] = take(c_out).copy()
            oihw = take(c_out * c_in * kh * kw).reshape(c_out, c_in, kh, kw)
            node["w"] = np.transpose(oihw, (2, 3, 1, 0)).copy()

    if pos != len(stream):
        raise ValueError(
            f"darknet {what} length mismatch: used {pos} of {len(stream)}")


def load_darknet_weights(params: Params, path: str) -> Params:
    """Load official darknet yolov3.weights into a yolov3 param tree.

    Returns a NEW tree (float32 numpy leaves); raises if the stream
    length does not exactly match the parameter count.
    """
    params = numpy_tree(params)
    _fill_from_stream(_yolov3_conv_sequence(params),
                      _read_darknet_stream(path), what="weights")
    return params


def load_darknet_backbone_weights(params: Params, path: str) -> Params:
    """Load a backbone-only darknet file (darknet53.conv.74 — the
    ImageNet-pretrained init the reference trains from [recalled;
    SURVEY.md §3.4]) into the `backbone` of a yolov3/rapid param tree.

    The head keeps its random init. Returns a NEW tree; raises if the
    stream is not exactly the 52 backbone convs (e.g. a full
    yolov3.weights file — use load_darknet_weights for those)."""
    params = numpy_tree(params)
    _fill_from_stream(_darknet53_conv_sequence(params["backbone"]),
                      _read_darknet_stream(path), what="backbone weights")
    return params


def save_darknet_weights(params: Params, path: str, *,
                         backbone_only: bool = False) -> None:
    """Inverse of load (round-trip tests and interop). With
    `backbone_only`, writes a darknet53.conv.74-format file (the 52
    backbone convs) readable by load_darknet_backbone_weights."""
    chunks = [np.asarray([0, 2, 0], np.int32).tobytes(),
              np.asarray([0], np.int64).tobytes()]
    out: list[np.ndarray] = []
    tree = numpy_tree(params)
    seq = (_darknet53_conv_sequence(tree["backbone"]) if backbone_only
           else _yolov3_conv_sequence(tree))
    for node, has_bn in seq:
        if has_bn:
            out += [node["bn"]["bias"], node["bn"]["scale"],
                    node["bn"]["mean"], node["bn"]["var"],
                    np.transpose(node["conv"]["w"], (3, 2, 0, 1)).ravel()]
        else:
            out += [node["b"], np.transpose(node["w"], (3, 2, 0, 1)).ravel()]
    stream = np.concatenate([np.asarray(a, np.float32).ravel() for a in out])
    with open(path, "wb") as fh:
        fh.write(b"".join(chunks))
        stream.tofile(fh)


# ---------------------------------------------------------------------------
# torch state dicts
# ---------------------------------------------------------------------------

def _to_numpy(t):
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_torch_checkpoint(path: str, *, key: str | None = "model") -> dict:
    """torch.load a checkpoint and return a flat name → numpy dict. The
    reference saves {'model': state_dict, ...}; bare state_dicts also
    work (key=None or missing). Unlike the JAX package's loader, which
    unpickles anything, this one loads tensors and plain containers
    only (`weights_only=True`): a `.pt` file comes from outside the
    program, and a whole pickled module is refused."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ck, dict) and key and key in ck:
        ck = ck[key]
    return {k: _to_numpy(v) for k, v in ck.items()}


def import_torch_conv(w_oihw: np.ndarray) -> np.ndarray:
    return np.transpose(w_oihw, (2, 3, 1, 0))


def import_resnet_state_dict(params_backbone: Params, state: dict) -> Params:
    """torchvision ResNet state_dict → our resnet param tree.

    Name map: conv1/bn1 → stem; layerL.B.convN/bnN → stageL-1.blockB.convN;
    layerL.B.downsample.{0,1} → stageL-1.blockB.down.
    """
    out = numpy_tree(params_backbone)

    def put_conv_bn(node, conv_key, bn_key):
        node["conv"]["w"] = import_torch_conv(state[conv_key + ".weight"])
        node["bn"]["scale"] = state[bn_key + ".weight"]
        node["bn"]["bias"] = state[bn_key + ".bias"]
        node["bn"]["mean"] = state[bn_key + ".running_mean"]
        node["bn"]["var"] = state[bn_key + ".running_var"]

    put_conv_bn(out["stem"], "conv1", "bn1")
    for si in range(4):
        stage = out[f"stage{si}"]
        bi = 0
        while f"block{bi}" in stage:
            prefix = f"layer{si + 1}.{bi}"
            block = stage[f"block{bi}"]
            for ci in (1, 2, 3):
                put_conv_bn(block[f"conv{ci}"], f"{prefix}.conv{ci}",
                            f"{prefix}.bn{ci}")
            if "down" in block:
                put_conv_bn(block["down"], f"{prefix}.downsample.0",
                            f"{prefix}.downsample.1")
            bi += 1
    return out


def import_state_dict(params: Params, state: dict,
                      mapping: dict[str, str]) -> tuple[Params, list[str]]:
    """Generic importer: `mapping` maps OUR flat '/'-joined leaf paths →
    torch state_dict keys. Conv weights (4-D) are OIHW→HWIO transposed.
    Returns (new params, list of unmapped torch keys)."""
    flat = flatten_tree(numpy_tree(params))
    used = set()
    for our_key, torch_key in mapping.items():
        if our_key not in flat:
            raise KeyError(f"unknown param path {our_key}")
        val = state[torch_key]
        if val.ndim == 4:
            val = import_torch_conv(val)
        if val.shape != flat[our_key].shape:
            raise ValueError(
                f"{our_key}: shape {flat[our_key].shape} vs {val.shape}")
        flat[our_key] = val.astype(np.float32)
        used.add(torch_key)
    unmapped = [k for k in state if k not in used]
    return unflatten_tree(flat), unmapped


# ---------------------------------------------------------------------------
# torchvision detection-model head importers
# ---------------------------------------------------------------------------

def _get(state: dict, *candidates: str) -> np.ndarray:
    """First present key among torchvision naming variants.

    torchvision ≥0.12 wraps head convs in Conv2dNormActivation
    ('conv.0.0.weight'); older releases used flat Sequentials
    ('conv.0.weight' with ReLUs at odd indices). FPN inner/layer blocks
    have the same two spellings.
    """
    for k in candidates:
        if k in state:
            return state[k]
    raise KeyError(f"none of {candidates} in state dict")


def _put_conv(node: Params, state: dict, *weight_keys: str,
              allow_missing_bias: bool = False) -> None:
    w = import_torch_conv(_get(state, *weight_keys))
    if w.shape != node["w"].shape:
        # catch class-count / channel mismatches HERE with a readable
        # message instead of an opaque XLA shape error at first forward
        # (e.g. a 91-class COCO checkpoint into an 80-class model)
        raise ValueError(
            f"checkpoint tensor {weight_keys[0]} has HWIO shape {w.shape} "
            f"but the model expects {node['w'].shape} — was the model "
            "built with the checkpoint's num_classes?")
    node["w"] = w
    try:
        node["b"] = _get(state, *(k.replace(".weight", ".bias")
                                  for k in weight_keys))
    except KeyError:
        if not allow_missing_bias:
            # loud by default: a missing bias on a layer that should
            # have one means the key candidates are wrong (renamed
            # upstream), not that the conv is bias-less — zero-filling
            # would import subtly wrong weights.
            raise
        # genuinely bias-less torch conv (e.g. FCOS tower
        # Conv2dNormActivation with GroupNorm sets bias=False): our
        # conv keeps a zero bias.
        node["b"] = np.zeros(node["w"].shape[-1], np.float32)


def _import_fpn(fpn_params: Params, state: dict,
                prefix: str = "backbone.fpn.") -> Params:
    """torchvision BackboneWithFPN fpn block → our fpn tree.

    inner_blocks.{0,1,2} = 1x1 laterals on C3/C4/C5; layer_blocks = 3x3
    smoothing; extra_blocks.p6/p7 = the RetinaNet LastLevelP6P7 convs.
    """
    out = numpy_tree(fpn_params)
    for i, lvl in enumerate((3, 4, 5)):
        _put_conv(out[f"lateral{lvl}"], state,
                  f"{prefix}inner_blocks.{i}.0.weight",
                  f"{prefix}inner_blocks.{i}.weight")
        _put_conv(out[f"smooth{lvl}"], state,
                  f"{prefix}layer_blocks.{i}.0.weight",
                  f"{prefix}layer_blocks.{i}.weight")
    _put_conv(out["p6"], state, f"{prefix}extra_blocks.p6.weight")
    _put_conv(out["p7"], state, f"{prefix}extra_blocks.p7.weight")
    return out


def _strip_prefix(state: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def import_retinanet_state_dict(params: Params, state: dict) -> Params:
    """torchvision `retinanet_resnet50_fpn` state_dict → our param tree.

    Anchor-order note: our head reshape (B,H,W,A*C)→(N,C) and
    torchvision's both flatten level-major, cell row-major, anchor
    fastest, with anchors ratio-major/scale-minor — verified by
    tests/test_weight_import.py::test_retinanet_anchor_order. Anchor
    GEOMETRY is torchvision-exact too (int-truncated sizes, rounded
    half-extents, centers at grid*stride — models/retinanet.anchor_wh),
    so imported checkpoints decode against the anchors they were
    trained with.
    """
    # Fail fast on retinanet_resnet50_fpn_v2 checkpoints: their head
    # conv blocks are Conv2dNormActivation with a GroupNorm at
    # `conv.{i}.1` that our (v1-parity, norm-free) RetinaNet head has
    # no slot for — importing the convs alone would produce
    # un-normalized garbage activations with no diagnostic.
    for tv in ("classification_head", "regression_head"):
        for i in range(4):
            if f"head.{tv}.conv.{i}.1.weight" in state:
                raise ValueError(
                    "retinanet_resnet50_fpn_v2 checkpoint detected "
                    f"(GroupNorm key head.{tv}.conv.{i}.1.weight): the "
                    "v2 head uses GN towers our v1-parity RetinaNet "
                    "head does not model — import a v1 "
                    "retinanet_resnet50_fpn checkpoint instead")

    out = numpy_tree(params)
    out["backbone"] = import_resnet_state_dict(
        out["backbone"], _strip_prefix(state, "backbone.body."))
    out["fpn"] = _import_fpn(out["fpn"], state)
    for our, tv in (("cls", "classification_head"),
                    ("box", "regression_head")):
        sub = out["head"][our]
        for i in range(4):
            # `.0.weight` is a norm-free Conv2dNormActivation spelling;
            # `.{2i}.weight` the classic biased conv (v2's GN layout is
            # rejected above)
            _put_conv(sub[f"conv{i}"], state,
                      f"head.{tv}.conv.{i}.0.weight",
                      f"head.{tv}.conv.{2 * i}.weight",
                      allow_missing_bias=True)
        final = "cls_logits" if our == "cls" else "bbox_reg"
        _put_conv(sub["out"], state, f"head.{tv}.{final}.weight")
    return out


def import_fcos_state_dict(params: Params, state: dict) -> Params:
    """torchvision `fcos_resnet50_fpn` state_dict → our param tree.

    torchvision's FCOS head conv blocks are Conv2dNormActivation
    (conv at .0, GroupNorm at .1); centerness rides the regression
    tower (bbox_ctrness), matching our ctr_out placement. torchvision
    FCOS has no learnable per-level scales — ours stay at their init
    (1.0) and the importer leaves them untouched.
    """
    out = numpy_tree(params)
    out["backbone"] = import_resnet_state_dict(
        out["backbone"], _strip_prefix(state, "backbone.body."))
    out["fpn"] = _import_fpn(out["fpn"], state)
    head = out["head"]
    for tower_key, tv in (("cls_tower", "classification_head"),
                          ("box_tower", "regression_head")):
        tower = head[tower_key]
        for i in range(4):
            # FCOS tower Conv2dNormActivation sets bias=False (GN follows)
            _put_conv(tower[f"conv{i}"], state,
                      f"head.{tv}.conv.{i}.0.weight",
                      allow_missing_bias=True)
            tower[f"gn{i}"]["scale"] = state[f"head.{tv}.conv.{i}.1.weight"]
            tower[f"gn{i}"]["bias"] = state[f"head.{tv}.conv.{i}.1.bias"]
    _put_conv(head["cls_out"], state,
              "head.classification_head.cls_logits.weight")
    _put_conv(head["box_out"], state, "head.regression_head.bbox_reg.weight")
    _put_conv(head["ctr_out"], state,
              "head.regression_head.bbox_ctrness.weight")
    return out
