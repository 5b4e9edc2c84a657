"""Static-scale int8 post-training quantization for the ResNet-FPN
families (retinanet, retinanet_r101, fcos).

A port of `mydetection_tpu/quant_resnet.py`, the sibling of `quant.py`
(see its docstring for the scheme and the int8 conv): the bottleneck
stages (BN folded), the FPN and the head towers run as int8 convs;
everything between a conv's int32 output and the next requantization
is float32 elementwise work.

What stays float: the prologue (`models/resnet.prepare_input`, the 7x7
stem, the max pool), the head output convs (in the compute dtype), the
residual adds and FPN top-down sums (float32) and the decode. FCOS's
GroupNorm has batch statistics, so it cannot fold into weights: each
FCOS tower conv's float32 value less its bias goes to
`kernels.gn.bias_gn_relu` (the CUDA kernel on the card, its plain
version on the CPU) with the bias, which adds it in float32 as the JAX
epilogue does, 8 launches a level, 40 a forward, at float32.

The walk is written once over a small value algebra that the backends
implement — `toq(key, y)` (a requantization point: calibration records
the range, int8 quantizes), `conv(leaf, x)` (the conv, its dequant and
bias), `conv_gn_relu` (FCOS's tower layer), `deq(x)`, `out(p, x)` —
so calibration and the int8 forward cannot disagree on which
activations carry scales. The towers are shared across levels but get
per-level activation scales. Each stage's blocks after the first are
stored stacked (`scan_stacked`) with their scales stacked (n − 1, 3, 2)
[c1, c2, add], the JAX layout; the port walks them in a loop.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch
from torch import nn

from mydetection_tpu_torch.kernels.gn import bias_gn_relu, bias_gn_relu_plain
from mydetection_tpu_torch.kernels.route import pick
from mydetection_tpu_torch.models import fcos as fcos_mod
from mydetection_tpu_torch.models.layers import ConvBN, conv2d, max_pool
from mydetection_tpu_torch.models.resnet import prepare_input
from mydetection_tpu_torch.quant import (
    CALIB_PERCENTILE,
    _conv_i8,
    _deq,
    _device_of,
    _epilogue,
    _fq,
    _index,
    _merge_stats,
    _module_of,
    _nhwc,
    _out_conv,
    _out_leaf,
    _qleaf,
    _quant,
    _range_stat,
    _sm_of,
    _stack,
    _upsample2x,
    _zero_point,
    fold_cbl,
)

RESNET_QUANT_FAMILIES = ("retinanet", "fcos")
FPN_CONVS = ("lateral3", "lateral4", "lateral5", "smooth3", "smooth4",
             "smooth5", "p6", "p7")


def _stage_nblocks(tree: dict) -> int:
    return sum(1 for k in tree if k.startswith("block"))


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class _CalibBE:
    """Folded-float walk in the compute dtype; `toq` records the signed
    (min, max) (or percentiles, as `quant._CalibBE`) and passes the
    activation through."""

    def __init__(self, compute_dtype, percentile: float = CALIB_PERCENTILE):
        self.dt = compute_dtype
        self.percentile = float(percentile)
        self.stats: dict[str, torch.Tensor] = {}

    def toq(self, key: str, y):
        self.stats[key] = _range_stat(y, self.percentile)
        return y

    def conv(self, f: dict, x, *, stride: int = 1):
        y = conv2d(x.to(self.dt), f["wf"], stride=stride)
        return y + f["bias"].to(y.dtype)[:, None, None]

    def conv_gn_relu(self, f: dict, gn: dict, x):
        """FCOS's tower layer as the float model runs it: the conv, then
        bias + GroupNorm + ReLU in one `bias_gn_relu`."""
        return pick(bias_gn_relu, bias_gn_relu_plain)(
            conv2d(x.to(self.dt), f["wf"]), f["bias"], gn["scale"],
            gn["bias"], groups=fcos_mod.GN_GROUPS)

    def deq(self, x):
        return x

    def out(self, p: dict, x):
        return _out_conv(p, x, self.dt)

    def stage(self, key: str, t: dict, xr, stride: int):
        xr = _bottleneck(self, f"{key}/b0", t["block0"], xr, stride)
        for bi in range(1, _stage_nblocks(t)):
            xr = _bottleneck(self, f"{key}/b{bi}", t[f"block{bi}"], xr, 1)
        return xr


class _FakeQuantBE(_CalibBE):
    """Float walk with per-key simulated activation quantization, gated
    by 0/1 scalars (the counterpart of `quant._FakeQuantBE`); weights
    are simulated by `quant.blend_weight_tree` over the folded trees."""

    def __init__(self, compute_dtype, scales: dict, gates: dict):
        super().__init__(compute_dtype)
        self.scales = scales
        self.gates = gates

    def toq(self, key: str, y):
        return torch.where(torch.as_tensor(self.gates[key]) > 0.5,
                           _fq(y, self.scales[key]).to(y.dtype), y)


class _QuantBE:
    """int8 walk; an activation is (xq int8 NCHW channels_last, sm (2,)
    [s, m0]), dequantized as s·xq + m0."""

    def __init__(self, scales: dict, compute_dtype):
        self.s = scales
        self.dt = compute_dtype

    def toq(self, key: str, y):
        sm = self.s[key]
        return _quant(y, sm), sm

    def conv(self, q: dict, xr, *, stride: int = 1, bias: bool = True):
        xq, sm = xr
        acc = _conv_i8(xq, q["wq"], stride=stride, pad_val=_zero_point(sm))
        return _epilogue(acc, sm, q, bias=bias)

    def conv_gn_relu(self, q: dict, gn: dict, xr):
        """(acc·s·wscale + m0·wscale·wsum) + bias, GroupNorm, ReLU: the
        epilogue without its bias, then `bias_gn_relu` at float32."""
        return pick(bias_gn_relu, bias_gn_relu_plain)(
            self.conv(q, xr, bias=False), q["bias"], gn["scale"],
            gn["bias"], groups=fcos_mod.GN_GROUPS)

    def deq(self, xr):
        return _deq(xr)

    def out(self, p: dict, xr):
        return _out_conv(p, _deq(xr) if isinstance(xr, tuple) else xr,
                         self.dt)

    def stage(self, key: str, t: dict, xr, stride: int):
        xr = _bottleneck(self, f"{key}/b0", t["block0"], xr, stride)
        if "scan_stacked" not in t:
            return xr
        scales = self.s[key + "/scan"]  # (n - 1, 3, 2) [c1, c2, add]
        for bi in range(scales.shape[0]):
            xr = _bottleneck(_SliceBE(self, scales[bi]), "",
                             _index(t["scan_stacked"], bi), xr, 1)
        return xr


class _SliceBE:
    """The int8 backend for one stacked block: `toq` takes the block's
    (3, 2) scales in order (c1, c2, add), whatever the key."""

    def __init__(self, parent: _QuantBE, svec: torch.Tensor):
        self.p = parent
        self.svec = svec
        self.i = 0

    def toq(self, key: str, y):
        s = self.svec[self.i]
        self.i += 1
        return _quant(y, s), s

    def conv(self, q, xr, *, stride: int = 1):
        return self.p.conv(q, xr, stride=stride)

    def deq(self, xr):
        return self.p.deq(xr)


def _bottleneck(be, key: str, t: dict, xr, stride: int):
    """torchvision's v1.5 bottleneck (the stride on the 3x3, a
    projection shortcut where 'down' is present) over any backend."""
    y = be.toq(f"{key}/c1", torch.relu(be.conv(t["c1"], xr)))
    y = be.toq(f"{key}/c2", torch.relu(be.conv(t["c2"], y, stride=stride)))
    y3 = be.conv(t["c3"], y)
    sc = (be.conv(t["down"], xr, stride=stride) if "down" in t
          else be.deq(xr))
    return be.toq(f"{key}/add", torch.relu(y3 + sc))


# ---------------------------------------------------------------------------
# the shared walk: stages 0-3 -> FPN -> head towers
# ---------------------------------------------------------------------------

def _flat(y: torch.Tensor, per_cell: int) -> torch.Tensor:
    """NCHW head output → (B, H·W·(C / per_cell), per_cell), cells
    row-major."""
    b = y.shape[0]
    return _nhwc(y).reshape(b, -1, per_cell)


def _region(be, qb: dict, qf: dict, qh: dict, y, *, cfg):
    """`y` = the float post-maxpool stem activation (B, 64, S/4, S/4).
    Returns the family's raw tuple, as the float model returns it."""
    xr = be.toq("entry", y)
    feats = []
    for si in range(4):
        xr = be.stage(f"stage{si}", qb[f"stage{si}"], xr,
                      stride=1 if si == 0 else 2)
        if si >= 1:
            feats.append(xr)
    c3, c4, c5 = feats

    # FPN (models/fpn.py): laterals and sums in float, requantized at
    # the smoothing convs' and the head's inputs
    l5 = be.conv(qf["lateral5"], c5)
    l4 = be.conv(qf["lateral4"], c4) + _upsample2x(l5)
    l3 = be.conv(qf["lateral3"], c3) + _upsample2x(l4)
    p3 = be.conv(qf["smooth3"], be.toq("fpn/l3", l3))
    p4 = be.conv(qf["smooth4"], be.toq("fpn/l4", l4))
    p5 = be.conv(qf["smooth5"], be.toq("fpn/l5", l5))
    q5 = be.toq("fpn/p5", p5)
    p6 = be.conv(qf["p6"], q5, stride=2)
    p7 = be.conv(qf["p7"], be.toq("fpn/p6r", torch.relu(p6)), stride=2)
    levels = [be.toq("fpn/p3", p3), be.toq("fpn/p4", p4), q5,
              be.toq("fpn/p6", p6), be.toq("fpn/p7", p7)]

    def tower(branch: str, li: int, xr):
        t = qh[branch]
        for i in range(4):
            if f"gn{i}" in t:  # FCOS: bias + GN + ReLU after the conv
                y = be.conv_gn_relu(t[f"conv{i}"], t[f"gn{i}"], xr)
            else:
                y = torch.relu(be.conv(t[f"conv{i}"], xr))
            if i == 3:
                # its only consumers are the float output convs: it is
                # not requantized and has no scale
                return y
            xr = be.toq(f"{branch}/l{li}/c{i}", y)
        return xr

    nc = cfg.num_classes
    if cfg.family == "retinanet":
        cls_f, box_f, gate_f = [], [], []
        for li, q in enumerate(levels):
            cl = _flat(be.out(qh["cls"]["out"], tower("cls", li, q)), nc)
            bx = _flat(be.out(qh["box"]["out"], tower("box", li, q)), 4)
            cls_f.append(cl)
            if cfg.multi_label:
                gate_f.append(torch.amax(cl, dim=-1))
            box_f.append(bx.float())
        out = (torch.cat(cls_f, 1), torch.cat(box_f, 1))
        return out + (torch.cat(gate_f, 1),) if cfg.multi_label else out

    # fcos (models/fcos.py's head, its ltrb conventions included)
    cls_f, box_f, ctr_f, gate_f = [], [], [], []
    for li, q in enumerate(levels):
        ct = tower("cls_tower", li, q)
        bt = tower("box_tower", li, q)
        cl = _flat(be.out(qh["cls_out"], ct), nc)
        raw_box = _flat(be.out(qh["box_out"], bt), 4).float()
        ctr = _flat(be.out(qh["ctr_out"], bt), 1).float()
        if cfg.ltrb_decode == "exp":
            ltrb = torch.exp(torch.clamp(raw_box * qh["scales"][li],
                                         -10.0, 10.0))
        else:
            ltrb = torch.relu(raw_box)
        cls_f.append(cl)
        if cfg.multi_label:
            gate_f.append(torch.amax(cl, dim=-1))
        box_f.append(ltrb * float(fcos_mod.STRIDES[li]))
        ctr_f.append(ctr[..., 0])
    out = (torch.cat(cls_f, 1), torch.cat(box_f, 1), torch.cat(ctr_f, 1))
    return out + (torch.cat(gate_f, 1),) if cfg.multi_label else out


# ---------------------------------------------------------------------------
# the float prologue
# ---------------------------------------------------------------------------

class _Prologue(nn.Module):
    """The stem `_prologue` runs (`models/resnet.py`'s), named as the
    JAX prologue tree (`backbone_float`)."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, 2)


def _prologue(backbone: nn.Module, images: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """uint8 (or float) NHWC batch → the post-maxpool stem activation,
    through `models/resnet.prepare_input` and `backbone.stem` (a ResNet
    or a `_Prologue`), as the float forward computes it."""
    x = prepare_input(images.permute(0, 3, 1, 2), compute_dtype)
    return max_pool(backbone.stem(x), 3, 2)


# ---------------------------------------------------------------------------
# tree preparation
# ---------------------------------------------------------------------------

def _fold_only(bb: nn.Module) -> dict:
    """The folded-float backbone tree for the calibration walk: each
    block's {'c1', 'c2', 'c3'[, 'down']} of {'wf', 'bias'} leaves."""
    qb: dict = {}
    for si in range(4):
        st = getattr(bb, f"stage{si}")

        def fblock(b) -> dict:
            f = {"c1": fold_cbl(b.conv1), "c2": fold_cbl(b.conv2),
                 "c3": fold_cbl(b.conv3)}
            if b.down is not None:
                f["down"] = fold_cbl(b.down)
            return f

        qb[f"stage{si}"] = {f"block{bi}": fblock(b)
                            for bi, b in enumerate(st.children())}
    return qb


def _as_f(conv: nn.Conv2d) -> dict:
    return {"wf": conv.weight, "bias": conv.bias}


def _fold_fpn_float(fpn: nn.Module) -> dict:
    return {k: _as_f(getattr(fpn, k)) for k in FPN_CONVS}


def _fold_head_float(hd: nn.Module, family: str) -> dict:
    """The head as float leaves: tower convs {'wf', 'bias'}, output
    convs {'w', 'b'}, FCOS's GN {'scale', 'bias'} and level scales."""
    if family == "retinanet":
        out: dict = {}
        for branch in ("cls", "box"):
            sub = getattr(hd, branch)
            t = {f"conv{i}": _as_f(getattr(sub, f"conv{i}"))
                 for i in range(4)}
            t["out"] = _out_leaf(sub.out)
            out[branch] = t
        return out
    out = {}
    for branch in ("cls_tower", "box_tower"):
        tw = getattr(hd, branch)
        t: dict = {}
        for i in range(4):
            gn = getattr(tw, f"gn{i}")
            t[f"conv{i}"] = _as_f(getattr(tw, f"conv{i}"))
            t[f"gn{i}"] = {"scale": gn.scale.clone(), "bias": gn.bias.clone()}
        out[branch] = t
    for k in ("cls_out", "box_out", "ctr_out"):
        out[k] = _out_leaf(getattr(hd, k))
    out["scales"] = hd.scales.clone()
    return out


def _prep_backbone(ft: dict) -> dict:
    """Folded backbone → int8 tree: block0 alone, the others stacked
    under 'scan_stacked'."""
    qb: dict = {}
    for si in range(4):
        st = ft[f"stage{si}"]
        n = _stage_nblocks(st)

        def qblock(b: dict) -> dict:
            return {k: _qleaf(v) for k, v in b.items()}

        qst: dict = {"block0": qblock(st["block0"])}
        if n > 1:
            qst["scan_stacked"] = _stack([qblock(st[f"block{bi}"])
                                          for bi in range(1, n)])
        qb[f"stage{si}"] = qst
    return qb


def _prep_fpn(ff: dict) -> dict:
    return {k: _qleaf(v) for k, v in ff.items()}


def _prep_head(fh: dict, family: str) -> dict:
    """Folded head → int8 tower convs; output convs, GN and level
    scales pass through as float."""
    def conv_or_float(k, v):
        return _qleaf(v) if k.startswith("conv") else v

    branches = (("cls", "box") if family == "retinanet"
                else ("cls_tower", "box_tower"))
    return {k: {kk: conv_or_float(kk, vv) for kk, vv in v.items()}
            if k in branches else v for k, v in fh.items()}


def _stack_scales(ranges: dict[str, tuple], qb: dict, scheme: str,
                  device) -> dict[str, torch.Tensor]:
    """(lo, hi) ranges → [s, m0] tensors on `device`; each stage's
    stacked blocks' scales as one (n − 1, 3, 2) 'stage{i}/scan' stack."""
    scales = {k: _sm_of(lo, hi, scheme) for k, (lo, hi) in ranges.items()}
    out: dict[str, np.ndarray] = {}
    for si in range(4):
        st = qb[f"stage{si}"]
        if "scan_stacked" not in st:
            continue
        n1 = st["scan_stacked"]["c1"]["wq"].shape[0]
        arr = np.zeros((n1, 3, 2), np.float32)
        for bi in range(n1):
            for ci, part in enumerate(("c1", "c2", "add")):
                arr[bi, ci] = scales.pop(f"stage{si}/b{bi + 1}/{part}")
        out[f"stage{si}/scan"] = arr
    out.update(scales)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantizedResnetParams:
    """What the ResNet-FPN int8 forward needs, on one device."""

    backbone_float: nn.Module  # `_Prologue`: the stem
    qb: dict
    qf: dict
    qh: dict
    scales: dict[str, torch.Tensor]


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[np.ndarray], *,
              _folded=None,
              percentile: float = CALIB_PERCENTILE) -> dict[str, tuple]:
    """The folded-float walk over calibration batches on the model's
    device, in its compute dtype → the per-key signed (lo, hi) ranges.
    `_folded`: (backbone, fpn, head) trees already folded."""
    cfg = model.config
    if _folded is not None:
        qb, qf, qh = _folded
    else:
        qb = _fold_only(model.backbone)
        qf = _fold_fpn_float(model.fpn)
        qh = _fold_head_float(model.head, cfg.family)
    device = _device_of(model)
    ranges: dict[str, tuple] = {}
    for b in batches:
        be = _CalibBE(cfg.compute_dtype, percentile)
        y = _prologue(model.backbone, torch.as_tensor(b).to(device),
                      cfg.compute_dtype)
        _region(be, qb, qf, qh, y, cfg=cfg)
        _merge_stats(ranges, be.stats)
    if not ranges:
        raise ValueError("calibrate() needs at least one batch")
    return ranges


@torch.no_grad()
def quantize_model(model: nn.Module, calib_batches: Iterable[np.ndarray],
                   *, percentile: float = CALIB_PERCENTILE,
                   act_scheme: str = "asym") -> QuantizedResnetParams:
    """Fold, calibrate and quantize a retinanet / fcos model on its
    device."""
    cfg = model.config
    if cfg.family not in RESNET_QUANT_FAMILIES:
        raise ValueError(f"quant_resnet supports {RESNET_QUANT_FAMILIES}, "
                         f"got family '{cfg.family}'")
    device = _device_of(model)
    ft = _fold_only(model.backbone)
    ff = _fold_fpn_float(model.fpn)
    fh = _fold_head_float(model.head, cfg.family)
    ranges = calibrate(model, calib_batches, _folded=(ft, ff, fh),
                       percentile=percentile)
    qb = _prep_backbone(ft)
    return QuantizedResnetParams(
        backbone_float=_module_of(_Prologue, model.backbone.state_dict(),
                                  device),
        qb=qb, qf=_prep_fpn(ff), qh=_prep_head(fh, cfg.family),
        scales=_stack_scales(ranges, qb, act_scheme, device))


def forward_raw(qp: QuantizedResnetParams, images: torch.Tensor, *, cfg):
    """Quantized inference → the family's raw tuple, as the float model
    returns it (decode via `registry.dense_from_raw`)."""
    y = _prologue(qp.backbone_float, images, cfg.compute_dtype)
    return _region(_QuantBE(qp.scales, cfg.compute_dtype), qp.qb, qp.qf,
                   qp.qh, y, cfg=cfg)
