"""Static-scale int8 post-training quantization for the darknet families.

A port of `mydetection_tpu/quant.py`: the same scheme, the same walk
and the same artifact format, over PyTorch tensors on an explicit
device.

Scheme (standard post-training quantization):
  * BN folded into the conv weights and bias (the exact inference
    fold) — `fold_cbl`.
  * Weights: per-output-channel symmetric int8, `max|w|/127 + 1e-12`,
    clipped to ±127 — `quantize_weight`.
  * Activations: per-layer static affine int8 (x ≈ s·xq + m0, the
    default "asym"): calibration records each requantization point's
    signed (min, max) and the range maps onto the 256 levels
    −128..127 (`_sm_of`); `act_scheme="sym"` keeps the symmetric
    scheme (m0 = 0).
  * The int8 conv (`_conv_i8`) pads its input with the zero point
    (the int8 value of float 0), builds the im2col matrix in
    (kh, kw, cin) column order and multiplies it with `torch._int_mm`
    (int8 × int8 → int32, exact) on the CPU and on the card alike. The
    weight is kept OHWI: its (Cout, kh·kw·Cin) rows, transposed, are
    the column-major right operand cuBLASLt's int8 GEMM takes at every
    row count (a row-major one is refused at some, 17 rows on an
    H100). The JAX tree's HWIO `wq` is converted at quantize and load
    time and back at save. The (B·Ho·Wo, Cout) result is already NHWC,
    the channels_last memory of the NCHW activations around it.
  * The epilogue keeps the JAX association: acc·(s·wscale) +
    m0·wscale·wsum + bias, then LeakyReLU(0.1) and the requantization
    `round((y − m0)/s)` clipped to −128..127 (`_quant`; `torch.round`
    rounds half to even as `jnp.round` does). Residual adds and the
    neck's concats run on dequantized float32 values.

What stays float: the prologue (stem → stage0 → stage1.down of
`models/darknet.py`, in the compute dtype), the head output 1x1 convs
(in the compute dtype) and the decode and NMS. The int8 region is
Darknet-53 stages 1–4 and the whole YOLOv3 neck, in channels_last
memory from the prologue's exit to the output convs.

`_CalibBE` (folded float walk, records ranges), `_QuantBE` (int8) and
`_FakeQuantBE` (float walk with gated simulated quantization) walk the
same `_region`, so the scales one records are the scales the other
consumes. `QuantizedParams` holds the prologue module and trees of
tensors named as the JAX tree; `save_quantized` / `load_quantized`
read and write the JAX `.npz` artifact (HWIO `wq`, `quant_kind`), so
an artifact written by either package loads in the other.

Entry points: `quantize_model(model, calib_batches)` (both darknet
families here, the ResNet-FPN families through `quant_resnet`),
`forward_dense_quantized`, and `Detector(..., quantized=True | path)`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable

import numpy as np
import torch
from torch import nn

from mydetection_tpu_torch import checkpoint as ck
from mydetection_tpu_torch.convert import from_jax_params, to_jax_params
from mydetection_tpu_torch.models.darknet import STAGE_BLOCKS, Stage
from mydetection_tpu_torch.models.layers import (
    ConvBNLeaky,
    bn_fold,
    conv2d,
    leaky_relu,
    normalize_input,
)

QUANT_FAMILIES = ("yolov3", "rapid")
# the calibration statistic: the q-th percentile of the activation at
# each requantization point; 100 records the plain (min, max), the
# default, as in the JAX package
CALIB_PERCENTILE = 100.0
# the CUDA torch._int_mm takes more than 16 rows and K, N multiples of 8
_MIN_ROWS = 17
_MULTIPLE = 8


# ---------------------------------------------------------------------------
# layout helpers: NCHW activations in channels_last memory
# ---------------------------------------------------------------------------

def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → its NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """NHWC → its NCHW view (channels_last when y is contiguous)."""
    return y.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


def _ohwi(wq: torch.Tensor) -> torch.Tensor:
    """An HWIO int8 weight (or a stack of them) → contiguous OHWI, the
    port's `wq` layout."""
    return wq.movedim(-1, -4).contiguous()


def _wq_hwio(wq: torch.Tensor) -> torch.Tensor:
    """The port's OHWI `wq` (or a stack) → HWIO, the artifact's."""
    return wq.movedim(-4, -1)


def _map_wq(tree, fn):
    """`tree` with fn applied to every 'wq' leaf."""
    return {k: _map_wq(v, fn) if isinstance(v, dict)
            else fn(v) if k == "wq" else v for k, v in tree.items()}


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NCHW map of any dtype, returned in
    channels_last memory."""
    b, c, h, w = x.shape
    y = _nhwc(x)[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return _nchw(y.reshape(b, 2 * h, 2 * w, c))


def _concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel concat in channels_last memory."""
    return _nchw(torch.cat([_nhwc(a), _nhwc(b)], dim=-1))


def _index(tree: dict, i: int) -> dict:
    """Row i of every leaf of a stacked tree."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# folding, weight quantization and the int8 conv
# ---------------------------------------------------------------------------

def fold_cbl(m: nn.Module) -> dict:
    """A conv + BN module (`ConvBNLeaky` or `ConvBN`) at inference →
    {'wf' OIHW, 'bias' (Cout,)} float32. Exact: BN(conv(x, w)) =
    conv(x, w·s) + (β − μ·s), s = γ·rsqrt(σ² + ε)."""
    s, shift = bn_fold(m.bn.scale, m.bn.bias, m.bn.mean, m.bn.var)
    return {"wf": m.conv.weight * s[:, None, None, None], "bias": shift}


def quantize_weight(wf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an HWIO weight: (wq int8
    HWIO, wscale float32 (Cout,))."""
    ws = wf.abs().amax(dim=(0, 1, 2)) / 127.0 + 1e-12
    wq = torch.clamp(torch.round(wf / ws), -127, 127).to(torch.int8)
    return wq, ws.float()


def _int_mm(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """int8 a (M, K) × int8 bt (N, K) transposed → int32 (M, N), exact,
    by `torch._int_mm` with bt.t() (column-major) as the right operand:
    rows padded to _MIN_ROWS and K, N to multiples of _MULTIPLE with
    zeros (which add nothing) where the CUDA op needs it; the CPU runs
    the same padded call."""
    m, k = a.shape
    n = bt.shape[0]
    pk, pn, pm = -k % _MULTIPLE, -n % _MULTIPLE, max(0, _MIN_ROWS - m)
    if pk or pm:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        bt = torch.nn.functional.pad(bt, (0, pk, 0, pn))
    out = torch._int_mm(a, bt.t())
    return out[:m, :n] if pm or pn else out


def _conv_i8(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
             pad_val: torch.Tensor | None = None) -> torch.Tensor:
    """int8 NCHW x × int8 OHWI w → int32 NCHW (channels_last memory),
    symmetric (k−1)//2 padding (layers.conv2d's convention, stride-2
    parity included).

    pad_val: the border fill in the int8 domain, a 0-d int8 tensor (the
    zero point, so the epilogue's m0·wscale·wsum term stays exact at the
    borders); None pads with 0. The padded NHWC input is read as a
    (B, Ho, Wo, kh, kw, Cin) window view and copied once into the
    (B·Ho·Wo, kh·kw·Cin) im2col matrix; a stride-1 1x1 conv multiplies
    the input itself."""
    cout, kh, kw, cin = w.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xh = _nhwc(x).contiguous()
    b, h, wd, _ = xh.shape
    if ph or pw:
        xp = xh.new_empty((b, h + 2 * ph, wd + 2 * pw, cin))
        if pad_val is None:
            xp.zero_()
        else:
            xp.fill_(pad_val)
        xp[:, ph:ph + h, pw:pw + wd] = xh
    else:
        xp = xh
    ho = (xp.shape[1] - kh) // stride + 1
    wo = (xp.shape[2] - kw) // stride + 1
    if kh == kw == 1 and stride == 1:
        cols = xp.reshape(b * ho * wo, cin)
    else:
        sb, sh, sw, sc = xp.stride()
        cols = xp.as_strided((b, ho, wo, kh, kw, cin),
                             (sb, sh * stride, sw * stride, sh, sw, sc))
        cols = cols.reshape(b * ho * wo, kh * kw * cin)
    acc = _int_mm(cols, w.reshape(cout, kh * kw * cin))
    return _nchw(acc.reshape(b, ho, wo, cout))


def _quant(y: torch.Tensor, sm: torch.Tensor) -> torch.Tensor:
    """Float → int8 under x ≈ s·xq + m0, sm = [s, m0]: round((y −
    m0)/s) (a true division) clipped to −128..127."""
    s, m0 = sm[..., 0], sm[..., 1]
    return torch.clamp(torch.round((y.float() - m0) / s), -128,
                       127).to(torch.int8)


def _zero_point(sm: torch.Tensor) -> torch.Tensor:
    """The int8 value of float zero under sm (the pad value)."""
    s, m0 = sm[..., 0], sm[..., 1]
    return torch.clamp(torch.round(-m0 / s), -128, 127).to(torch.int8)


def _sm_of(lo, hi, scheme: str) -> np.ndarray:
    """A calibrated (lo, hi) → [scale, m0] float32 under the scheme:
    "asym" maps the full signed range onto 256 levels, m0 = lo + 128·s;
    "sym" is abs-max / 127 with m0 = 0."""
    lo, hi = float(lo), float(hi)
    if scheme == "asym":
        s = (hi - lo) / 255.0 + 1e-12
        return np.asarray([s, lo + 128.0 * s], np.float32)
    if scheme == "sym":
        return np.asarray([max(abs(lo), abs(hi)) / 127.0 + 1e-12, 0.0],
                          np.float32)
    raise ValueError(f"act_scheme must be 'asym' or 'sym', got {scheme!r}")


def _epilogue(acc: torch.Tensor, sm: torch.Tensor, q: dict, *,
              bias: bool = True) -> torch.Tensor:
    """An int8 conv's int32 NCHW output → float32, in the JAX order:
    acc·(s·wscale) + m0·wscale·wsum (+ bias). Computed on the NHWC view,
    where the per-channel vectors broadcast along the last axis; the
    result is channels_last."""
    s, m0 = sm[..., 0], sm[..., 1]
    y = _nhwc(acc).to(torch.float32)
    y.mul_(s * q["wscale"])
    y.add_(m0 * q["wscale"] * q["wsum"])
    if bias:
        y.add_(q["bias"])
    return _nchw(y)


def _deq(xr: tuple) -> torch.Tensor:
    xq, sm = xr
    return xq.to(torch.float32) * sm[..., 0] + sm[..., 1]


def _out_conv(p: dict, x: torch.Tensor, dt) -> torch.Tensor:
    """A float head output conv ({'w' HWIO, 'b'}) in the compute dtype."""
    y = conv2d(x.to(dt), _oihw(p["w"]))
    return y + p["b"].to(y.dtype)[:, None, None]


# ---------------------------------------------------------------------------
# the shared walk: calibration, int8 and simulated backends
# ---------------------------------------------------------------------------

def _range_stat(y: torch.Tensor, percentile: float) -> torch.Tensor:
    """An activation's signed (min, max) or, below percentile 100, its
    (100 − p, p) percentiles (`torch.quantile`'s linear method, as
    `jnp.percentile`'s) over a strided subsample of its NHWC ravel,
    the elements the JAX walk picks; (2,) float32."""
    yf = _nhwc(y).float().reshape(-1)
    if percentile >= 100.0:
        return torch.stack([yf.min(), yf.max()])
    # a strided subsample caps the sort near 1M elements
    sub = yf[::max(1, yf.numel() // (1 << 20))]
    q = torch.tensor([100.0 - percentile, percentile], dtype=torch.float32,
                     device=yf.device) / 100.0
    return torch.quantile(sub, q)


class _CalibBE:
    """Folded-float walk that records each requantization point's range
    (`_range_stat`) and passes the activation through."""

    def __init__(self, compute_dtype, percentile: float = CALIB_PERCENTILE):
        self.dt = compute_dtype
        self.percentile = float(percentile)
        self.stats: dict[str, torch.Tensor] = {}

    def _rec(self, key: str, y: torch.Tensor) -> torch.Tensor:
        self.stats[key] = _range_stat(y, self.percentile)
        return y

    def _conv(self, f: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
        y = conv2d(x.to(self.dt), f["wf"], stride=stride)
        return leaky_relu(y + f["bias"].to(y.dtype)[:, None, None])

    def entry(self, key, y):
        return self._rec(key, y)

    def cbl(self, key, f, x, *, stride: int = 1):
        return self._rec(key, self._conv(f, x, stride))

    def cbl_out(self, key, f, x, *, stride: int = 1):
        """The head conv: its only consumer is the float `out` conv, so
        it is not requantized and records no scale."""
        return self._conv(f, x, stride)

    def res_block(self, key, f, x):
        r = self.cbl(key + "/c1", f["c1"], x)
        return self._rec(key + "/add", x + self._conv(f["c2"], r, 1))

    def res_stage(self, key, f, x, nblocks: int):
        for bi in range(nblocks):
            x = self.res_block(f"{key}/res{bi}", f[f"res{bi}"], x)
        return x

    def up(self, x):
        return _upsample2x(x)

    def concat(self, key, a, b):
        return self._rec(key, _concat(a, b))

    def out(self, p, x):
        return _out_conv(p, x, self.dt).permute(0, 2, 3, 1)


def _fq(y: torch.Tensor, s) -> torch.Tensor:
    """Simulated symmetric requantization dequant(quant(y, s)), float32."""
    return torch.clamp(torch.round(y.float() / s), -127, 127) * s


class _FakeQuantBE(_CalibBE):
    """Float walk with per-key simulated activation quantization, each
    key gated by a 0/1 scalar (`where(g > 0.5, fq(y), y)`): the
    per-layer sensitivity sweep's backend. Weights are simulated by
    `blend_weight_tree` over the folded trees."""

    def __init__(self, compute_dtype, scales: dict, gates: dict):
        super().__init__(compute_dtype)
        self.scales = scales  # key → scalar scale (abs-max / 127)
        self.gates = gates    # key → 0/1 scalar (1 = quantize)

    def _rec(self, key, y):
        return torch.where(torch.as_tensor(self.gates[key]) > 0.5,
                           _fq(y, self.scales[key]).to(y.dtype), y)


def blend_weight_tree(ft: dict, gate_of) -> dict:
    """A folded-float tree with each conv leaf's 'wf' replaced by
    where(gate, dequant(per-channel int8 wf), wf); `gate_of(path)` (a
    '/'-joined leaf path) gives the 0/1 gate. Leaves without 'wf' (the
    float output convs, GN parameters) pass through."""

    def walk(node, path):
        if isinstance(node, dict) and "wf" in node:
            wq, ws = quantize_weight(_hwio(node["wf"]))
            wfq = _oihw(wq.to(torch.float32) * ws).to(node["wf"].dtype)
            g = torch.as_tensor(gate_of(path))
            return {**node, "wf": torch.where(g > 0.5, wfq, node["wf"])}
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        return node

    return walk(ft, "")


class _QuantBE:
    """int8 walk; an activation is (xq int8 NCHW channels_last, sm (2,)
    [s, m0])."""

    def __init__(self, scales: dict, compute_dtype):
        self.s = scales
        self.dt = compute_dtype

    def entry(self, key, y):
        sm = self.s[key]
        return _quant(y, sm), sm

    def _deq_conv(self, q, xr, *, stride: int = 1):
        xq, sm = xr
        acc = _conv_i8(xq, q["wq"], stride=stride, pad_val=_zero_point(sm))
        return leaky_relu(_epilogue(acc, sm, q))

    def cbl(self, key, q, xr, *, stride: int = 1):
        sm = self.s[key]
        return _quant(self._deq_conv(q, xr, stride=stride), sm), sm

    def cbl_out(self, key, q, xr, *, stride: int = 1):
        return self._deq_conv(q, xr, stride=stride)

    def _res_block_body(self, q, xr, out_scales):
        """out_scales: (2, 2) rows [conv1_out, post_add] of [s, m0]."""
        rsm = out_scales[0]
        rq = _quant(self._deq_conv(q["c1"], xr), rsm)
        y = self._deq_conv(q["c2"], (rq, rsm)) + _deq(xr)
        return _quant(y, out_scales[1]), out_scales[1]

    def res_stage(self, key, q, xr, nblocks: int):
        scales = self.s[key + "/res"]  # (n, 2, 2)
        for bi in range(nblocks):
            xr = self._res_block_body(_index(q["res_stacked"], bi), xr,
                                      scales[bi])
        return xr

    def up(self, xr):
        xq, sm = xr
        return _upsample2x(xq), sm

    def concat(self, key, ar, br):
        sm = self.s[key]
        return _quant(_concat(_deq(ar), _deq(br)), sm), sm

    def out(self, p, xr):
        x = _deq(xr) if isinstance(xr, tuple) else xr
        return _out_conv(p, x, self.dt).permute(0, 2, 3, 1)


def _region(be, bt: dict, ht: dict, y: torch.Tensor) -> list:
    """Darknet stages 1–4 and the YOLOv3 neck and heads over either
    backend; `y` is the float stage1.down activation. Mirrors
    `models/darknet.py` and `models/yolov3.py`; returns the raw
    [P5, P4, P3], each NHWC (B, H, W, A·no)."""
    x = be.entry("entry", y)
    feats = []
    for si in (1, 2, 3, 4):
        st = bt[f"stage{si}"]
        if si > 1:
            x = be.cbl(f"stage{si}/down", st["down"], x, stride=2)
        x = be.res_stage(f"stage{si}", st, x, STAGE_BLOCKS[si])
        if si >= 2:
            feats.append(x)
    c3, c4, c5 = feats

    def conv5(key, p, x):
        for name in ("c0", "c1", "c2", "c3", "c4"):
            x = be.cbl(f"{key}/{name}", p[name], x)
        return x

    x5 = conv5("block5", ht["block5"], c5)
    out5 = be.out(ht["head5"]["out"],
                  be.cbl_out("head5/conv", ht["head5"]["conv"], x5))
    lat = be.cbl("lateral4", ht["lateral4"], x5)
    x4 = conv5("block4", ht["block4"], be.concat("cat4", be.up(lat), c4))
    out4 = be.out(ht["head4"]["out"],
                  be.cbl_out("head4/conv", ht["head4"]["conv"], x4))
    lat = be.cbl("lateral3", ht["lateral3"], x4)
    x3 = conv5("block3", ht["block3"], be.concat("cat3", be.up(lat), c3))
    out3 = be.out(ht["head3"]["out"],
                  be.cbl_out("head3/conv", ht["head3"]["conv"], x3))
    return [out5, out4, out3]


# ---------------------------------------------------------------------------
# the float prologue
# ---------------------------------------------------------------------------

class _Prologue(nn.Module):
    """The modules `_prologue` runs — stem, stage 0 and stage 1's
    downsample of `models/darknet.py` — named as the JAX prologue tree
    (`backbone_float`), without the float res blocks of stages 1–4."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBNLeaky(3, 32, 3)
        self.stage0 = Stage(32, 64, STAGE_BLOCKS[0])
        self.stage1 = nn.Module()
        self.stage1.down = ConvBNLeaky(64, 128, 3, stride=2)


def _prologue(backbone: nn.Module, images: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """uint8 (or float) NHWC batch → the stage1.down activation (B, 128,
    H/4, W/4) in the compute dtype, through `backbone`'s stem, stage0
    and stage1.down (a Darknet53 or a `_Prologue`)."""
    x = images.permute(0, 3, 1, 2)
    if x.dtype == torch.uint8:
        x = normalize_input(x, compute_dtype)
    else:
        x = x.to(compute_dtype)
    return backbone.stage1.down(backbone.stage0(backbone.stem(x)))


def _module_of(cls, state: dict, device) -> nn.Module:
    """A `cls()` holding `state`'s tensors, eval mode, no gradients, on
    `device` (channels_last on the card)."""
    m = cls()
    own = m.state_dict()
    m.load_state_dict({k: state[k] for k in own}, strict=True)
    m = m.eval().requires_grad_(False).to(device)
    if torch.device(device).type == "cuda":
        m = m.to(memory_format=torch.channels_last)
    return m


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


# ---------------------------------------------------------------------------
# tree preparation
# ---------------------------------------------------------------------------

def _out_leaf(conv: nn.Conv2d) -> dict:
    """A float output conv as the JAX leaf {'w' HWIO, 'b'}."""
    return {"w": _hwio(conv.weight).contiguous(), "b": conv.bias.clone()}


def _fold_region(model: nn.Module) -> tuple[dict, dict]:
    """BN folded for every conv of the int8 region: (backbone, head)
    trees of {'wf', 'bias'} leaves; the head output convs stay
    {'w', 'b'}."""
    bb, hd = model.backbone, model.head
    bt: dict = {}
    for si in (1, 2, 3, 4):
        st = getattr(bb, f"stage{si}")
        fst: dict = {} if si == 1 else {"down": fold_cbl(st.down)}
        for bi in range(STAGE_BLOCKS[si]):
            res = getattr(st, f"res{bi}")
            fst[f"res{bi}"] = {"c1": fold_cbl(res.conv1),
                               "c2": fold_cbl(res.conv2)}
        bt[f"stage{si}"] = fst
    ht: dict = {}
    for key in ("block5", "block4", "block3"):
        blk = getattr(hd, key)
        ht[key] = {name: fold_cbl(getattr(blk, name))
                   for name in ("c0", "c1", "c2", "c3", "c4")}
    for key in ("lateral4", "lateral3"):
        ht[key] = fold_cbl(getattr(hd, key))
    for key in ("head5", "head4", "head3"):
        br = getattr(hd, key)
        ht[key] = {"conv": fold_cbl(br.conv), "out": _out_leaf(br.out)}
    return bt, ht


def _qleaf(f: dict) -> dict:
    """A folded leaf {'wf' OIHW, 'bias'} → the int8 leaf {'wq' OHWI,
    'wscale', 'wsum', 'bias'}; wsum = Σ wq over taps and input channels
    (exact in float32: |wsum| ≤ 9·1024·127 < 2²⁴)."""
    wq, ws = quantize_weight(_hwio(f["wf"]))
    return {"wq": _ohwi(wq), "wscale": ws,
            "wsum": wq.to(torch.float32).sum(dim=(0, 1, 2)),
            "bias": f["bias"].to(torch.float32)}


def _stack(trees: list[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def _quantize_folded(bt: dict, ht: dict) -> tuple[dict, dict]:
    """Folded trees → int8 trees; each stage's res blocks stacked
    (leaf 'res_stacked', as the JAX tree stores them)."""
    qb: dict = {}
    for si in (1, 2, 3, 4):
        st = bt[f"stage{si}"]
        qst: dict = {} if si == 1 else {"down": _qleaf(st["down"])}
        qst["res_stacked"] = _stack([
            {"c1": _qleaf(st[f"res{bi}"]["c1"]),
             "c2": _qleaf(st[f"res{bi}"]["c2"])}
            for bi in range(STAGE_BLOCKS[si])])
        qb[f"stage{si}"] = qst
    qh: dict = {}
    for key in ("block5", "block4", "block3"):
        qh[key] = {name: _qleaf(ht[key][name])
                   for name in ("c0", "c1", "c2", "c3", "c4")}
    for key in ("lateral4", "lateral3"):
        qh[key] = _qleaf(ht[key])
    for key in ("head5", "head4", "head3"):
        qh[key] = {"conv": _qleaf(ht[key]["conv"]), "out": ht[key]["out"]}
    return qb, qh


def _stack_scales(ranges: dict[str, tuple], scheme: str,
                  device) -> dict[str, torch.Tensor]:
    """(lo, hi) ranges → [s, m0] tensors on `device`; each res stage's
    stacked to (n, 2, 2) rows [conv1_out, post_add]."""
    scales = {k: _sm_of(lo, hi, scheme) for k, (lo, hi) in ranges.items()}
    out: dict[str, np.ndarray] = {}
    for si in (1, 2, 3, 4):
        n = STAGE_BLOCKS[si]
        arr = np.zeros((n, 2, 2), np.float32)
        for bi in range(n):
            arr[bi, 0] = scales.pop(f"stage{si}/res{bi}/c1")
            arr[bi, 1] = scales.pop(f"stage{si}/res{bi}/add")
        out[f"stage{si}/res"] = arr
    out.update(scales)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _merge_stats(ranges: dict, stats: dict[str, torch.Tensor]) -> None:
    """Widen `ranges` by one batch's (lo, hi) per key (one copy to the
    host)."""
    keys = list(stats)
    vals = torch.stack([stats[k] for k in keys]).cpu().numpy()
    for k, (lo, hi) in zip(keys, vals.astype(np.float64)):
        if k in ranges:
            lo, hi = min(lo, ranges[k][0]), max(hi, ranges[k][1])
        ranges[k] = (float(lo), float(hi))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantizedParams:
    """What the darknet int8 forward needs, on one device."""

    backbone_float: nn.Module  # `_Prologue`: stem, stage0, stage1.down
    qb: dict                   # int8 stages 1-4
    qh: dict                   # int8 neck and heads (+ float out convs)
    scales: dict[str, torch.Tensor]


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[np.ndarray], *,
              _folded=None,
              percentile: float = CALIB_PERCENTILE) -> dict[str, tuple]:
    """The folded-float walk over calibration batches (uint8 NHWC at the
    serving size, on the model's device and in its compute dtype) → the
    per-key signed (lo, hi) ranges. `_folded`: (bt, ht) already folded."""
    bt, ht = _folded if _folded is not None else _fold_region(model)
    dt = model.config.compute_dtype
    device = _device_of(model)
    ranges: dict[str, tuple] = {}
    for b in batches:
        be = _CalibBE(dt, percentile)
        x = torch.as_tensor(b).to(device)
        _region(be, bt, ht, _prologue(model.backbone, x, dt))
        _merge_stats(ranges, be.stats)
    if not ranges:
        raise ValueError("calibrate() needs at least one batch")
    return ranges


@torch.no_grad()
def quantize_model(model: nn.Module, calib_batches: Iterable[np.ndarray],
                   *, percentile: float = CALIB_PERCENTILE,
                   act_scheme: str = "asym"):
    """Fold, calibrate and quantize a float model (its `config` names
    the family) on its device. Darknet families here, the ResNet-FPN
    families through `quant_resnet`. Returns the family's quantized
    params. act_scheme: "asym" (affine, the default) or "sym"."""
    cfg = model.config
    if cfg.family not in QUANT_FAMILIES:
        from mydetection_tpu_torch import quant_resnet

        if cfg.family in quant_resnet.RESNET_QUANT_FAMILIES:
            return quant_resnet.quantize_model(model, calib_batches,
                                               percentile=percentile,
                                               act_scheme=act_scheme)
        raise ValueError(
            f"int8 quantization supports families "
            f"{QUANT_FAMILIES + quant_resnet.RESNET_QUANT_FAMILIES}; "
            f"'{cfg.name}' has family '{cfg.family}'")
    device = _device_of(model)
    bt, ht = _fold_region(model)
    ranges = calibrate(model, calib_batches, _folded=(bt, ht),
                       percentile=percentile)
    qb, qh = _quantize_folded(bt, ht)
    return QuantizedParams(
        backbone_float=_module_of(_Prologue, model.backbone.state_dict(),
                                  device),
        qb=qb, qh=qh, scales=_stack_scales(ranges, act_scheme, device))


def forward_raw(qp: QuantizedParams, images: torch.Tensor, *,
                compute_dtype=None) -> list:
    """Quantized inference → the raw [P5, P4, P3] the float model
    returns (None: float32)."""
    dt = compute_dtype or torch.float32
    y = _prologue(qp.backbone_float, images, dt)
    return _region(_QuantBE(qp.scales, dt), qp.qb, qp.qh, y)


def forward_dense_quantized(qp, images: torch.Tensor, cfg) -> dict:
    """The family's quantized forward → the dense dict the postprocess
    takes (the decode is `registry.dense_from_raw`, the float path's)."""
    from mydetection_tpu_torch.registry import dense_from_raw

    if isinstance(qp, QuantizedParams):
        raw = forward_raw(qp, images, compute_dtype=cfg.compute_dtype)
    else:
        from mydetection_tpu_torch import quant_resnet

        raw = quant_resnet.forward_raw(qp, images, cfg=cfg)
    return dense_from_raw(raw, cfg, int(images.shape[1]))


# ---------------------------------------------------------------------------
# artifacts: the JAX package's .npz format
# ---------------------------------------------------------------------------

def _fields(qp) -> list[str]:
    return [f.name for f in dataclasses.fields(qp)]


def save_quantized(path: str, qp, cfg=None) -> None:
    """Write a QuantizedParams / QuantizedResnetParams as the JAX
    package's `.npz` artifact (atomic; int8 kept): the prologue as its
    JAX tree, the scales nested by their '/' paths. With `cfg`, stamp
    family, num_classes and input_size for `load_quantized`'s check."""
    from mydetection_tpu_torch import quant_resnet

    if isinstance(qp, QuantizedParams):
        kind = "darknet"
    elif isinstance(qp, quant_resnet.QuantizedResnetParams):
        kind = "resnet"
    else:
        raise TypeError(f"not a quantized-params object: {type(qp)}")
    extra = {"quant_kind": kind}
    if cfg is not None:
        extra.update(family=cfg.family, num_classes=cfg.num_classes,
                     input_size=cfg.input_size)

    def host(t):
        return t.detach().cpu().numpy()

    tree = {f: _tree_map(host, _map_wq(getattr(qp, f), _wq_hwio))
            for f in _fields(qp) if f != "backbone_float"}
    tree["backbone_float"] = ck.unflatten_tree(
        to_jax_params(qp.backbone_float.state_dict()))
    tree["scales"] = _nest(tree["scales"])
    ck.save_checkpoint(path, tree, extra=extra)


def _nest(flat: dict) -> dict:
    """'/'-joined flat dict → nested dict (inverse of `_reflatten`),
    loud on leaf/subtree key collisions."""
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = out
        for p in parts[:-1]:
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):
                raise ValueError(f"scale key {k!r} collides with the "
                                 f"leaf key {p!r}")
            node = nxt
        if isinstance(node.get(parts[-1]), dict):
            raise ValueError(f"scale key {k!r} collides with an "
                             "existing subtree of the same name")
        node[parts[-1]] = v
    return out


def _reflatten(d: dict, prefix: str = "") -> dict:
    """Nested dict → '/'-joined flat dict (inverse of `_nest`)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_reflatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _upgrade(v: np.ndarray) -> np.ndarray:
    """A scale of an artifact written before the affine scheme (a
    symmetric scalar, or an (n, k) stack) → [s, 0] pairs: m0 = 0 is the
    old symmetric dequant."""
    v = np.asarray(v)
    if v.ndim == 0:
        return np.stack([v, np.zeros((), v.dtype)])
    if v.ndim == 2:
        return np.stack([v, np.zeros_like(v)], axis=-1)
    return v


def _add_wsum(node):
    """Give every int8 leaf lacking it its wsum (older artifacts): Σ wq
    over the kh, kw and Cin axes, also of a stacked leaf."""
    if not isinstance(node, dict):
        return node
    if "wq" in node and "wsum" not in node:
        wq = np.asarray(node["wq"])
        return {**node, "wsum": wq.astype(np.float32).sum(axis=(-4, -3, -2))}
    return {k: _add_wsum(v) for k, v in node.items()}


def load_quantized(path: str, cfg=None, *, device=None):
    """A `save_quantized` artifact (of either package) → the family's
    quantized params on `device` (None: cuda). With `cfg`, checks the
    stamped family and num_classes first and warns on another
    input_size."""
    from mydetection_tpu_torch import quant_resnet

    device = torch.device("cuda" if device is None else device)
    ckpt = ck.load_checkpoint(path)
    extra = ckpt["extra"]
    kind = str(extra.get("quant_kind", ""))
    tree = ckpt["params"]
    if not kind or tree is None:
        raise ValueError(f"{path} is not a quantized-params artifact "
                         "(missing quant_kind/params)")
    if cfg is not None and "family" in extra:
        saved = (str(extra["family"]), int(extra["num_classes"]))
        want = (cfg.family, cfg.num_classes)
        if saved != want:
            raise ValueError(
                f"quantized artifact {path} was saved for family="
                f"{saved[0]!r} num_classes={saved[1]}, but this Detector "
                f"is family={want[0]!r} num_classes={want[1]} — "
                "recalibrate with quantized=True")
        if "input_size" in extra \
                and int(extra["input_size"]) != cfg.input_size:
            warnings.warn(
                f"quantized artifact {path} was calibrated at input_size="
                f"{int(extra['input_size'])} but this Detector serves "
                f"{cfg.input_size}; static activation scales are "
                "size-sensitive — expect some accuracy cost, or "
                "recalibrate at the serving size", stacklevel=2)
    scales = _reflatten(tree["scales"])
    if any(np.ndim(v) == 0 for v in scales.values()):
        scales = {k: _upgrade(v) for k, v in scales.items()}
    if kind == "darknet":
        cls, prologue = QuantizedParams, _Prologue
    elif kind == "resnet":
        cls, prologue = (quant_resnet.QuantizedResnetParams,
                         quant_resnet._Prologue)
    else:
        raise ValueError(f"unknown quant_kind {kind!r} in {path}")

    def dev(a):
        return torch.from_numpy(np.array(a)).to(device)

    fields = {f: _map_wq(_tree_map(dev, _add_wsum(tree[f])), _ohwi)
              for f in _fields(cls) if f not in ("backbone_float", "scales")}
    state = from_jax_params(ck.flatten_tree(tree["backbone_float"]))
    return cls(backbone_float=_module_of(prologue, state, device),
               scales={k: dev(v) for k, v in scales.items()}, **fields)
