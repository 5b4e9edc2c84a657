"""Port parity of int8 post-training quantization for the darknet
families (`mydetection_tpu_torch/quant.py` against
`mydetection_tpu/quant.py`), on the CPU in float32 at 64².

One JAX `get_model(...).init(PRNGKey(0))` tree a family (yolov3 with 4
classes, rapid), every conv kernel scaled by 0.7 so the seeded heads
do not saturate (`test_torch_port_eval.scaled_init`), calibrated on the
Detector's noise batches (RandomState(0), two batches of 2) in a
module fixture. Gates, each with the floor measured on this file's
inputs:

  * `quantize_weight`, `_quant`, `_zero_point` and `_sm_of` bit-equal to
    JAX's, .5 ties and both clip ends included; `fold_cbl` within 1e-6
    relative (measured 1.2e-7: `torch.rsqrt` and XLA's rsqrt differ
    by an ulp);
  * `_conv_i8` (int32) bit-equal to JAX's `_conv_i8` and to a float64
    conv (exact: |acc| < 2²⁴ here) at kernels 1 and 3, strides 1 and 2,
    zero and zero-point padding, on 7x11 maps and on maps of 16 rows
    or fewer;
  * the int8 region alone: JAX's quantized params (through a JAX-saved
    artifact) and JAX's own prologue output fed to both `_region`s,
    JAX eager: every one of the 67 requantized int8 activations
    bit-equal (measured: all equal), the raw heads within 1e-5 of
    their largest |value| (measured 6.1e-7: the float output convs);
  * `calibrate`'s (lo, hi) within 2e-5 relative of JAX's at percentile
    100 and 99.9 (measured 4.0e-6 and 2.8e-6: float32 convs in another
    order, through 50 layers);
  * the port's own `quantize_model` forward against JAX's (each from
    its own calibration): cosine ≥ 0.999 and relative RMS ≤ 0.05 per
    head (`tests/test_quant.py`'s 0.99 / 0.15 tightened; measured
    0.99963 and 0.027: scales 4e-6 apart move a few int8 values by one
    step, and the random net carries the steps to the heads);
  * artifacts both ways, leaf for leaf bit-equal; the old-format
    upgrade, `act_scheme="sym"`, the family check and the input_size
    warning;
  * `_FakeQuantBE`: gates off bit-equal to the calibration walk, gates
    on within `tests/test_quant.py`'s cosine 0.99 / relative RMS 0.15
    of the real int8 forward;
  * `Detector(quantized=True)` and `Detector(quantized=path)` on the
    CPU against JAX's quantized Detector, matched one to one
    (tie-aware): class equal, score within 0.02, boxes within 2 px, on
    at least MATCHED_GATE of the detections (measured shares in the
    test's docstring: the int8 chain steps where float32 differs at a
    rounding tie); no module of the quantized path imports JAX.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mydetection_tpu import quant as jq  # noqa: E402
from mydetection_tpu.api import Detector as JDetector  # noqa: E402
from mydetection_tpu.checkpoint import flatten_tree, unflatten_tree  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu_torch import Detector  # noqa: E402
from mydetection_tpu_torch import checkpoint as pck  # noqa: E402
from mydetection_tpu_torch import quant as tq  # noqa: E402
from mydetection_tpu_torch.convert import from_jax_params, to_jax_params  # noqa: E402
from mydetection_tpu_torch.models.layers import ConvBNLeaky  # noqa: E402
from mydetection_tpu_torch.registry import get_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
SCALE = 0.7
NOISE = np.random.RandomState(0)
BATCHES = [NOISE.randint(0, 256, (2, SIZE, SIZE, 3), np.uint8)
           for _ in range(2)]   # Detector._quantize's noise calibration
CLASSES = {"yolov3": 4, "rapid": 1}
CONF = {"yolov3": 0.3, "rapid": 0.3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's torch work: in the Tier-1 run
    six workers share the host's cores and torch's per-op thread pools
    spin against each other (six processes on 8 cores took a 0.13 s
    calibration to 26 s; with one thread each, 0.29 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scaled_flat(name, num_classes):
    flat = flatten_tree(jget_model(name, input_size=SIZE,
                                   num_classes=num_classes).init(
        jax.random.PRNGKey(0)))
    return {k: np.asarray(v) * np.float32(SCALE) if v.ndim == 4
            else np.asarray(v) for k, v in flat.items()}


def jax_quantize(cfg, params, batches, percentile=100.0):
    """`jq.quantize_model`'s body, keeping the ranges it calibrates."""
    bt, ht = jq._fold_region(params)
    ranges = jq.calibrate(params, batches, compute_dtype=jnp.float32,
                          _folded=(bt, ht), percentile=percentile)
    qb, qh = jq._quantize_folded(bt, ht)
    bb = params["backbone"]
    prologue = {"stem": bb["stem"], "stage0": bb["stage0"],
                "stage1": {"down": bb["stage1"]["down"]}}
    return ranges, jq.QuantizedParams(backbone_float=prologue, qb=qb, qh=qh,
                                      scales=jq._stack_scales(ranges, "asym"))


def record_quant(module, fn, nhwc):
    """Run fn() with `module._quant` recording every int8 output, in
    call order (NHWC numpy)."""
    seen, orig = [], module._quant

    def rec(y, sm):
        out = orig(y, sm)
        seen.append(nhwc(out))
        return out

    module._quant = rec
    try:
        return fn(), seen
    finally:
        module._quant = orig


def close_heads(got, ref):
    """(min cosine, max relative RMS) over paired heads."""
    cos, rel = 1.0, 0.0
    for a, b in zip(got, ref):
        a = np.asarray(a, np.float64).ravel()
        b = np.asarray(b, np.float64).ravel()
        cos = min(cos, a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        rel = max(rel, np.linalg.norm(a - b) / np.linalg.norm(b))
    return cos, rel


def port_model(name, flat):
    model = get_model(name, input_size=SIZE, num_classes=CLASSES[name],
                      compute_dtype=torch.float32)
    model.load_state_dict(from_jax_params(flat), strict=True)
    return model.eval().requires_grad_(False)


def family(name, tmp_path_factory):
    flat = scaled_flat(name, CLASSES[name])
    jm = jget_model(name, input_size=SIZE, num_classes=CLASSES[name],
                    compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    ranges, jqp = jax_quantize(jm.config, params, BATCHES)
    path = str(tmp_path_factory.mktemp(name) / "jax.npz")
    jq.save_quantized(path, jqp, jm.config)
    return dict(name=name, flat=flat, jm=jm, params=params, ranges=ranges,
                jqp=jqp, path=path, model=port_model(name, flat))


@pytest.fixture(scope="module")
def yolo(tmp_path_factory):
    f = family("yolov3", tmp_path_factory)
    x = jnp.asarray(BATCHES[0])
    y = jq._prologue(f["jqp"].backbone_float, x, jnp.float32)
    # JAX eager: one op at a time, no fused epilogue
    f["y"] = y
    f["raw_j"], f["seen_j"] = record_quant(
        jq, lambda: jq._region(jq._QuantBE(f["jqp"].scales, jnp.float32),
                               f["jqp"].qb, f["jqp"].qh, y), np.asarray)
    return f


@pytest.fixture(scope="module")
def rapid(tmp_path_factory):
    return family("rapid", tmp_path_factory)


def jax_region(jqp, y):
    return jq._region(jq._QuantBE(jqp.scales, jnp.float32), jqp.qb, jqp.qh, y)


def to_nchw(y):
    return torch.from_numpy(np.array(y)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_quantize_weight_matches_jax():
    rng = np.random.RandomState(1)
    w = rng.standard_normal((3, 3, 16, 8)).astype(np.float32) * 0.1
    # a channel of half-integers up to ±127 (scale 1: every value a .5
    # tie) and a channel of zeros (scale 1e-12)
    w[..., 0] = rng.randint(-254, 255, (3, 3, 16)) / np.float32(2)
    w[0, 0, 0, 0] = 127.0
    w[..., 1] = 0.0
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32


def test_quant_and_zero_point_match_jax():
    """.5 ties (both parities), values past both clip ends, a bf16 input
    and zero points at and past both ends."""
    k = np.arange(-140, 140, dtype=np.float32)
    for s, m0 in ((0.5, 0.25), (0.03125, -1.5), (2.0, 3.0)):
        sm = np.asarray([s, m0], np.float32)
        y = np.concatenate([m0 + s * (k + np.float32(0.5)), m0 + s * k,
                            np.float32([1e9, -1e9])]).astype(np.float32)
        got = tq._quant(torch.from_numpy(y), torch.from_numpy(sm))
        want = jq._quant(jnp.asarray(y), jnp.asarray(sm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        yb = jnp.asarray(y, jnp.bfloat16)
        got = tq._quant(torch.from_numpy(np.array(yb.astype(jnp.float32)))
                        .to(torch.bfloat16), torch.from_numpy(sm))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jq._quant(yb, sm)))
    for s, m0 in ((0.5, -0.25), (0.5, 0.25), (0.5, -0.75), (0.01, 5.0),
                  (0.01, -5.0), (1.0, 0.0)):
        sm = np.asarray([s, m0], np.float32)
        assert int(tq._zero_point(torch.from_numpy(sm))) == \
            int(jq._zero_point(jnp.asarray(sm)))


@pytest.mark.parametrize("scheme", ["asym", "sym"])
def test_sm_of_matches_jax(scheme):
    for lo, hi in ((-1.0, 3.0), (0.0, 0.0), (-7.25, -0.5), (0.1, 1e4)):
        np.testing.assert_array_equal(tq._sm_of(lo, hi, scheme),
                                      jq._sm_of(lo, hi, scheme))
    with pytest.raises(ValueError, match="act_scheme"):
        tq._sm_of(0.0, 1.0, "mystery")


def test_fold_cbl_matches_jax():
    rng = np.random.RandomState(3)
    tree = {"conv": {"w": rng.standard_normal((3, 3, 32, 64)).astype(
        np.float32) * 0.05},
            "bn": {"scale": 1 + 0.3 * rng.standard_normal(64),
                   "bias": rng.standard_normal(64),
                   "mean": rng.standard_normal(64),
                   "var": np.exp(rng.standard_normal(64))}}
    tree["bn"] = {k: v.astype(np.float32) for k, v in tree["bn"].items()}
    m = ConvBNLeaky(32, 64, 3)
    m.load_state_dict(from_jax_params(flatten_tree(tree)))
    with torch.no_grad():
        got = tq.fold_cbl(m)
    want = jq.fold_cbl(jax.tree_util.tree_map(jnp.asarray, tree))
    for g, w in ((tq._hwio(got["wf"]).numpy(), want["wf"]),
                 (got["bias"].numpy(), want["bias"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


CONV_CASES = [(k, s, p) for k in (1, 3) for s in (1, 2) for p in (None, -37)]


@pytest.mark.parametrize("ksize,stride,pad", CONV_CASES)
@pytest.mark.parametrize("hw", [(2, 7, 11), (1, 3, 5), (1, 1, 1)])
def test_conv_i8_matches_jax_and_float64(ksize, stride, pad, hw):
    """(1, 3, 5) gives 15 or 6 output rows, (1, 1, 1) one: fewer than the
    17 the CUDA GEMM takes, padded with zero rows."""
    rng = np.random.RandomState(ksize * 10 + stride)
    b, h, w = hw
    x = rng.randint(-128, 128, (b, h, w, 24)).astype(np.int8)
    wt = rng.randint(-127, 128, (ksize, ksize, 24, 16)).astype(np.int8)
    want = np.asarray(jq._conv_i8(
        jnp.asarray(x), jnp.asarray(wt), stride=stride,
        pad_val=None if pad is None else jnp.int8(pad)))
    got = tq._conv_i8(torch.from_numpy(x).permute(0, 3, 1, 2),
                      tq._ohwi(torch.from_numpy(wt)), stride=stride,
                      pad_val=None if pad is None
                      else torch.tensor(pad, dtype=torch.int8))
    assert got.dtype == torch.int32
    got = tq._nhwc(got).numpy()
    np.testing.assert_array_equal(got, want)
    ph = (ksize - 1) // 2
    xp = np.pad(x.astype(np.float64), ((0, 0), (ph, ph), (ph, ph), (0, 0)),
                constant_values=0 if pad is None else pad)
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(xp).permute(0, 3, 1, 2),
        torch.from_numpy(wt.astype(np.float64)).permute(3, 2, 0, 1),
        stride=stride).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


# ---------------------------------------------------------------------------
# the int8 region and calibration against JAX
# ---------------------------------------------------------------------------

def test_region_int8_matches_jax_key_for_key(yolo):
    qp = tq.load_quantized(yolo["path"], device="cpu")
    with torch.no_grad():
        raw_t, seen_t = record_quant(
            tq, lambda: tq._region(tq._QuantBE(qp.scales, torch.float32),
                                   qp.qb, qp.qh, to_nchw(yolo["y"])),
            lambda t: tq._nhwc(t).numpy())
    seen_j = yolo["seen_j"]
    assert len(seen_t) == len(seen_j) == 67
    differ = [i for i, (a, b) in enumerate(zip(seen_t, seen_j))
              if not np.array_equal(a, b)]
    assert not differ, f"int8 activations differ at requant calls {differ}"
    for a, b in zip(raw_t, yolo["raw_j"]):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def range_error(got, want):
    assert sorted(got) == sorted(want)
    return max(abs(np.asarray(got[k]) - np.asarray(want[k])).max()
               / max(abs(np.asarray(want[k])).max(), 1e-30) for k in want)


@pytest.mark.parametrize("percentile", [100.0, 99.9])
def test_calibrate_ranges_match_jax(yolo, percentile):
    want = (yolo["ranges"] if percentile == 100.0 else jq.calibrate(
        yolo["params"], BATCHES, compute_dtype=jnp.float32,
        percentile=percentile))
    got = tq.calibrate(yolo["model"], BATCHES, percentile=percentile)
    err = range_error(got, want)
    assert err <= 2e-5, err


def test_quantize_model_forward_close_to_jax(yolo):
    qp = tq.quantize_model(yolo["model"], BATCHES)
    assert sorted(qp.scales) == sorted(yolo["jqp"].scales)
    with torch.no_grad():
        raw = tq.forward_raw(qp, torch.from_numpy(BATCHES[0]))
    cos, rel = close_heads([r.numpy() for r in raw], yolo["raw_j"])
    assert cos >= 0.999 and rel <= 0.05, (cos, rel)


def test_quantize_dispatch_and_unknown_family(yolo):
    import dataclasses

    model = yolo["model"]
    model.config = dataclasses.replace(model.config, family="mystery")
    try:
        with pytest.raises(ValueError, match="family 'mystery'"):
            tq.quantize_model(model, BATCHES)
    finally:
        model.config = dataclasses.replace(model.config, family="yolov3")


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def leaves(qp_fields: dict) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(qp_fields).items()}


def port_leaves(qp) -> dict:
    """The port's params as the JAX tree: wq back to HWIO, the prologue
    through `to_jax_params`."""
    out = {f: jax.tree_util.tree_map(
        lambda t: t.numpy(), tq._map_wq(getattr(qp, f), tq._wq_hwio))
        for f in ("qb", "qh")}
    out["scales"] = {k: v.numpy() for k, v in qp.scales.items()}
    out["backbone_float"] = unflatten_tree(
        to_jax_params(qp.backbone_float.state_dict()))
    return out


def jax_leaves(jqp) -> dict:
    return {f: jax.device_get(getattr(jqp, f))
            for f in ("qb", "qh", "scales", "backbone_float")}


def assert_same_leaves(a: dict, b: dict):
    a = {k: v for k, v in flatten_tree({**a, "scales": tq._nest(
        a["scales"])}).items()}
    b = {k: v for k, v in flatten_tree({**b, "scales": tq._nest(
        b["scales"])}).items()}
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_jax_artifact_loads_leaf_for_leaf(yolo):
    qp = tq.load_quantized(yolo["path"], yolo["model"].config, device="cpu")
    assert isinstance(qp, tq.QuantizedParams)
    assert_same_leaves(port_leaves(qp), jax_leaves(yolo["jqp"]))


def test_port_artifact_loads_in_jax(yolo, tmp_path):
    """JAX's params through the port (load, save) come back to JAX bit
    for bit, and JAX's forward on them is its forward on its own; the
    port's own calibration saved loads in JAX too and JAX's forward on
    it tracks the port's."""
    cfg = yolo["model"].config
    qp = tq.load_quantized(yolo["path"], cfg, device="cpu")
    path = str(tmp_path / "port.npz")
    tq.save_quantized(path, qp, cfg)
    back = jq.load_quantized(path, yolo["jm"].config)
    assert_same_leaves(jax_leaves(back), jax_leaves(yolo["jqp"]))
    for a, b in zip(jax_region(back, yolo["y"]), yolo["raw_j"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    own = tq.quantize_model(yolo["model"], BATCHES)
    tq.save_quantized(path, own, cfg)
    jown = jq.load_quantized(path, yolo["jm"].config)
    assert_same_leaves(jax_leaves(jown), port_leaves(own))
    with torch.no_grad():
        raw = tq._region(tq._QuantBE(own.scales, torch.float32), own.qb,
                         own.qh, to_nchw(yolo["y"]))
    got = jax_region(jown, yolo["y"])
    for a, b in zip(got, raw):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(b.numpy()).max())


def test_old_artifact_upgrade_and_sym(yolo, tmp_path):
    """act_scheme="sym" gives m0 = 0 everywhere; that params written in
    the format before the affine scheme (scalar scales, (n, 2) res
    stacks, no wsum) load through the upgrade and give the sym forward
    bit for bit; asym differs from sym."""
    model = yolo["model"]
    sym = tq.quantize_model(model, BATCHES, act_scheme="sym")
    assert all(float(v[..., 1].abs().max()) == 0.0
               for v in sym.scales.values())
    tree = port_leaves(sym)

    def strip(node):
        return {k: strip(v) if isinstance(v, dict) else v
                for k, v in node.items() if k != "wsum"}

    tree = {**tree, "qb": strip(tree["qb"]), "qh": strip(tree["qh"]),
            "scales": tq._nest({k: v[..., 0]
                                for k, v in tree["scales"].items()})}
    path = str(tmp_path / "old.npz")
    pck.save_checkpoint(path, tree, extra={"quant_kind": "darknet"})
    old = tq.load_quantized(path, device="cpu")
    x = torch.from_numpy(BATCHES[1])
    with torch.no_grad():
        a = tq.forward_raw(sym, x)
        b = tq.forward_raw(old, x)
        c = tq.forward_raw(tq.quantize_model(model, BATCHES), x)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    assert any(not torch.equal(u, v) for u, v in zip(a, c))


def test_artifact_family_check_and_size_warning(yolo, rapid):
    rcfg = rapid["model"].config
    with pytest.raises(ValueError, match="family='yolov3'"):
        tq.load_quantized(yolo["path"], rcfg, device="cpu")
    import dataclasses

    cfg = dataclasses.replace(yolo["model"].config, input_size=96)
    with pytest.warns(UserWarning, match="input_size=64"):
        tq.load_quantized(yolo["path"], cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tq.load_quantized(yolo["path"], yolo["model"].config, device="cpu")
    with pytest.raises(TypeError, match="not a quantized"):
        tq.save_quantized(yolo["path"] + ".x", {"qb": {}})


# ---------------------------------------------------------------------------
# the simulated-quantization backend
# ---------------------------------------------------------------------------

def test_fakequant_gates_off_is_float_and_on_is_int8(yolo):
    model = yolo["model"]
    x = torch.from_numpy(BATCHES[0])
    with torch.no_grad():
        bt, ht = tq._fold_region(model)
        ranges = tq.calibrate(model, BATCHES, _folded=(bt, ht))
        scales = {k: np.float32(max(abs(lo), abs(hi)) / 127.0 + 1e-12)
                  for k, (lo, hi) in ranges.items()}
        y = tq._prologue(model.backbone, x, torch.float32)

        def run(g):
            be = tq._FakeQuantBE(torch.float32, scales,
                                 {k: g for k in scales})
            return tq._region(be, tq.blend_weight_tree(bt, lambda p: g),
                              tq.blend_weight_tree(ht, lambda p: g), y)

        off = run(0.0)
        ref = tq._region(tq._CalibBE(torch.float32), bt, ht, y)
        for a, b in zip(off, ref):
            assert torch.equal(a, b)
        on = run(1.0)
        real = tq.forward_raw(tq.quantize_model(model, BATCHES,
                                                act_scheme="sym"), x)
    cos, rel = close_heads([t.numpy() for t in on],
                           [t.numpy() for t in real])
    assert cos >= 0.99 and rel <= 0.15, (cos, rel)
    assert any(not torch.equal(a, b) for a, b in zip(on, off))


# ---------------------------------------------------------------------------
# the Detector
# ---------------------------------------------------------------------------

def matched(got, want, score_tol=0.02, box_tol=2.0):
    """One-to-one greedy match of two images' detections: class equal,
    score within score_tol, boxes within box_tol px (rotated: cx, cy
    within box_tol, w, h within box_tol plus 2%, θ within 0.05 rad);
    tied neighbours may swap. Returns the number matched."""
    rot = got.boxes_rot is not None
    gb = got.boxes_rot if rot else got.boxes_xyxy
    wb = want.boxes_rot if rot else want.boxes_xyxy
    used = np.zeros(len(want), bool)
    for box, score, cls in zip(gb, got.scores, got.classes):
        d = np.abs(wb - box[None])
        if rot:
            ok = ((d[:, :2] <= box_tol).all(1) & (d[:, 4] <= 0.05)
                  & (d[:, 2:4] <= box_tol + 0.02 * np.abs(wb[:, 2:4])).all(1))
        else:
            ok = (d <= box_tol).all(1)
        cand = (~used & (want.classes == cls) & ok
                & (np.abs(want.scores - score) <= score_tol))
        if cand.any():
            used[int(np.argmin(np.where(cand, d.max(axis=1), np.inf)))] = True
    return int(used.sum())


# the matched share's gates: the measured shares less 0.1
MATCHED_GATE = {"yolov3": 0.8, "rapid": 0.65}


def test_detectors_match_jax(yolo, rapid):
    """Three noise images a family through JAX's Detector (from its
    artifact; jitted, so XLA fuses the epilogue with FMAs) and the
    port's, calibrated and loaded. The int8 chain turns float32
    differences of an ulp into steps of one quantum where a value sits
    at a rounding tie, so detections match within score 0.02 and 2 px,
    not bit for bit; shares measured (torch's default threads): yolov3
    0.955 calibrated, 0.909 loaded; rapid 0.770 and 0.836 (its
    saturated seeded boxes reach widths of 1e3 px)."""
    imgs = [np.random.RandomState(s).randint(0, 256, (90, 70, 3), np.uint8)
            for s in (4, 5, 6)]
    for f in (yolo, rapid):
        name, nc = f["name"], CLASSES[f["name"]]
        kw = dict(input_size=SIZE, num_classes=nc)
        jd = JDetector(name, params=f["params"], quantized=f["path"],
                       compute_dtype=jnp.float32, use_pallas=False, **kw)
        want = jd.detect_batch(imgs, conf_thres=CONF[name])
        calibrated = Detector(name, params=f["flat"], quantized=True,
                              device="cpu", compute_dtype=torch.float32, **kw)
        loaded = Detector(name, quantized=f["path"], device="cpu",
                          compute_dtype=torch.float32, **kw)
        assert next(loaded.model.parameters()).is_meta
        for det in (calibrated, loaded):
            got = det.detect_batch(imgs, conf_thres=CONF[name])
            n = sum(matched(g, w) for g, w in zip(got, want))
            total = sum(max(len(g), len(w)) for g, w in zip(got, want))
            assert total > 30 and n / total >= MATCHED_GATE[name], \
                (name, n, total)


def test_detector_quantized_surface(yolo, tmp_path):
    kw = dict(input_size=SIZE, num_classes=4, device="cpu",
              compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="calib_images is empty"):
        Detector("yolov3", params=yolo["flat"], quantized=True,
                 calib_images=[], **kw)
    with pytest.raises(ValueError, match="not quantized"):
        Detector("yolov3", params=yolo["flat"], **kw).save_quantized(
            str(tmp_path / "x.npz"))
    imgs = [np.random.RandomState(i).randint(0, 256, (50, 80, 3), np.uint8)
            for i in range(3)]
    det = Detector("yolov3", params=yolo["flat"], quantized=True,
                   calib_images=imgs, **kw)
    path = str(tmp_path / "q.npz")
    det.save_quantized(path)
    again = Detector("yolov3", quantized=path, **kw)
    a = det.detect_batch(imgs, conf_thres=0.3)
    b = again.detect_batch(imgs, conf_thres=0.3)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.as_array(), v.as_array())


def test_port_modules_import_no_jax():
    """A fresh interpreter imports the quantized path without jax."""
    code = ("import sys, mydetection_tpu_torch.quant, "
            "mydetection_tpu_torch.quant_resnet, mydetection_tpu_torch.api, "
            "mydetection_tpu_torch.evaluate; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mydetection_tpu.')) or "
            "m == 'mydetection_tpu']; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
