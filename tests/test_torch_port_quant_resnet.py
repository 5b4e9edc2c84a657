"""Port parity of int8 post-training quantization for the ResNet-FPN
families (`mydetection_tpu_torch/quant_resnet.py` against
`mydetection_tpu/quant_resnet.py`), on the CPU in float32 at 64².

One JAX init a family (retinanet and fcos, 4 classes, PRNGKey(0),
every conv kernel scaled by 0.7 as in `test_torch_port_quant.py`),
calibrated on the Detector's noise batches in a module fixture; the
JAX region runs eagerly. Gates, each with its measured floor:

  * the int8 region alone, JAX's quantized params (through a JAX-saved
    artifact) and JAX's own prologue output into both `_region`s:
    retinanet's 88 requantized int8 activations bit-equal (measured:
    all), its raw heads within 1e-5 of their largest |value| (measured
    1.1e-6: the float output convs); fcos: the share of int8 values
    that differ after each GroupNorm at most 1e-3 — the port's GN sums
    E[x²] − E[x]² where JAX's takes the two-pass variance — (measured:
    one value of 32768 at box_tower/l0/c2, 0 at the other 29 tower
    keys), every other key bit-equal, the raw heads within 1e-3
    (measured 2.6e-4, the centerness behind that step);
  * `calibrate`'s (lo, hi) within 2e-5 relative of JAX's at percentile
    100 (measured 2.7e-6; the 99.9 path is the shared
    `quant._range_stat`, held in `test_torch_port_quant.py`);
  * the port's own `quantize_model` forward against JAX's: cosine ≥
    0.999, relative RMS ≤ 0.05 per output (`tests/test_quant_resnet.py`'s
    0.99 / 0.15 tightened; measured in the message);
  * artifacts both ways leaf for leaf (the GN and level-scale
    passthroughs included), JAX's forward bit for bit on the round trip;
  * `_FakeQuantBE` gates off bit-equal to the calibration walk, gates on
    within 0.99 / 0.15 of the real int8 forward;
  * the scale keys in lockstep with JAX's (per-level tower keys for
    convs 0-2, none for conv 3) and ResNet-101's stage-2 stack read
    from the stacked leaves, without a forward;
  * `Detector(quantized=True | path)` against JAX's quantized Detector,
    matched one to one on at least MATCHED_GATE of the detections
    (measured with torch's default threads: retinanet 0.767 calibrated,
    0.820 loaded — its seeded scores are near-ties at the focal prior,
    1.00e-2 ± 3e-5, so one int8 step reorders the top 100 —; fcos 0.950
    both).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mydetection_tpu import quant as jq  # noqa: E402
from mydetection_tpu import quant_resnet as jqr  # noqa: E402
from mydetection_tpu.api import Detector as JDetector  # noqa: E402
from mydetection_tpu.checkpoint import unflatten_tree  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu_torch import Detector  # noqa: E402
from mydetection_tpu_torch import quant as tq  # noqa: E402
from mydetection_tpu_torch import quant_resnet as tqr  # noqa: E402
from mydetection_tpu_torch.convert import from_jax_params, to_jax_params  # noqa: E402
from mydetection_tpu_torch.registry import get_model  # noqa: E402
from test_torch_port_quant import (  # noqa: E402
    BATCHES,
    SIZE,
    assert_same_leaves,
    close_heads,
    matched,
    range_error,
    record_quant,
    scaled_flat,
    to_nchw,
)

NUM_CLASSES = 4
CONF = 0.005
MATCHED_GATE = {"retinanet": 0.65, "fcos": 0.85}
# the region's raw heads against JAX's, max-scaled: retinanet's differ
# in the float output convs only; one int8 step after an fcos GN moves
# the box tower's outputs
RAW_GATE = {"retinanet": 1e-5, "fcos": 1e-3}


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


def jax_quantize(cfg, params):
    """`jqr.quantize_model`'s body, keeping the ranges it calibrates."""
    ft = jqr._fold_only(params["backbone"])
    ff = jqr._fold_fpn_float(params["fpn"])
    fh = jqr._fold_head_float(params["head"], cfg.family)
    ranges = jqr.calibrate(cfg, params, BATCHES, _folded=(ft, ff, fh))
    qb = jqr._prep_backbone(ft)
    return ranges, jqr.QuantizedResnetParams(
        backbone_float={"stem": params["backbone"]["stem"]}, qb=qb,
        qf=jqr._prep_fpn(params["fpn"]),
        qh=jqr._prep_head(params["head"], cfg.family),
        scales=jqr._stack_scales(ranges, qb, "asym"))


def jax_region(jqp, y, cfg):
    return jqr._region(jqr._QuantBE(jqp.scales, jnp.float32,
                                    scan_blocks=False),
                       jqp.qb, jqp.qf, jqp.qh, y, cfg=cfg)


def family(name, tmp_path_factory):
    flat = scaled_flat(name, NUM_CLASSES)
    jm = jget_model(name, input_size=SIZE, num_classes=NUM_CLASSES,
                    compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    ranges, jqp = jax_quantize(jm.config, params)
    path = str(tmp_path_factory.mktemp(name) / "jax.npz")
    jq.save_quantized(path, jqp, jm.config)
    model = get_model(name, input_size=SIZE, num_classes=NUM_CLASSES,
                      compute_dtype=torch.float32)
    model.load_state_dict(from_jax_params(flat), strict=True)
    model.eval().requires_grad_(False)
    y = jqr._prologue(jqp.backbone_float, jnp.asarray(BATCHES[0]),
                      jnp.float32)
    raw_j, seen_j = record_quant(jqr, lambda: jax_region(jqp, y, jm.config),
                                 np.asarray)
    return dict(name=name, flat=flat, jm=jm, params=params, ranges=ranges,
                jqp=jqp, path=path, model=model, y=y, raw_j=raw_j,
                seen_j=seen_j)


@pytest.fixture(scope="module")
def retina(tmp_path_factory):
    return family("retinanet", tmp_path_factory)


@pytest.fixture(scope="module")
def fcos(tmp_path_factory):
    return family("fcos", tmp_path_factory)


@pytest.fixture(params=["retinanet", "fcos"])
def fam(request):
    return request.getfixturevalue({"retinanet": "retina",
                                    "fcos": "fcos"}[request.param])


def port_region(qp, f):
    with torch.no_grad():
        return record_quant(
            tqr, lambda: tqr._region(tqr._QuantBE(qp.scales, torch.float32),
                                     qp.qb, qp.qf, qp.qh, to_nchw(f["y"]),
                                     cfg=f["model"].config),
            lambda t: tq._nhwc(t).numpy())


def requant_keys(f) -> list[str]:
    """The requantization points in call order: the keys of the
    calibration walk (the int8 walk quantizes at the same points, the
    stacked blocks' positionally)."""
    with torch.no_grad():
        be = tqr._CalibBE(torch.float32)
        y = tqr._prologue(f["model"].backbone, torch.from_numpy(BATCHES[0]),
                          torch.float32)
        tqr._region(be, tqr._fold_only(f["model"].backbone),
                    tqr._fold_fpn_float(f["model"].fpn),
                    tqr._fold_head_float(f["model"].head, f["name"]), y,
                    cfg=f["model"].config)
    return list(be.stats)


def test_region_int8_matches_jax_key_for_key(fam):
    qp = tq.load_quantized(fam["path"], device="cpu")
    raw_t, seen_t = port_region(qp, fam)
    keys = requant_keys(fam)
    assert len(seen_t) == len(fam["seen_j"]) == len(keys) == 88
    share = {k: float((a != b).mean())
             for k, a, b in zip(keys, seen_t, fam["seen_j"])}
    after_gn = {k for k in keys if "_tower/" in k}
    assert all(share[k] == 0.0 for k in keys if k not in after_gn), \
        {k: v for k, v in share.items() if v}
    assert all(share[k] <= 1e-3 for k in after_gn), \
        {k: share[k] for k in after_gn if share[k]}
    assert len(raw_t) == len(fam["raw_j"])
    gate = RAW_GATE[fam["name"]]
    for a, b in zip(raw_t, fam["raw_j"]):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=gate * np.abs(b).max())


def test_calibrate_ranges_match_jax(fam):
    got = tqr.calibrate(fam["model"], BATCHES)
    err = range_error(got, fam["ranges"])
    assert err <= 2e-5, err


def test_quantize_model_forward_close_to_jax(fam):
    qp = tq.quantize_model(fam["model"], BATCHES)
    assert isinstance(qp, tqr.QuantizedResnetParams)
    assert sorted(qp.scales) == sorted(fam["jqp"].scales)
    with torch.no_grad():
        raw = tqr.forward_raw(qp, torch.from_numpy(BATCHES[0]),
                              cfg=fam["model"].config)
    cos, rel = close_heads([r.numpy() for r in raw], fam["raw_j"])
    assert cos >= 0.999 and rel <= 0.05, (cos, rel)


def port_leaves(qp) -> dict:
    out = {f: jax.tree_util.tree_map(
        lambda t: t.numpy(), tq._map_wq(getattr(qp, f), tq._wq_hwio))
        for f in ("qb", "qf", "qh")}
    out["scales"] = {k: v.numpy() for k, v in qp.scales.items()}
    out["backbone_float"] = unflatten_tree(
        to_jax_params(qp.backbone_float.state_dict()))
    return out


def jax_leaves(jqp) -> dict:
    return {f: jax.device_get(getattr(jqp, f))
            for f in ("qb", "qf", "qh", "scales", "backbone_float")}


def test_artifacts_both_ways(fam, tmp_path):
    cfg = fam["model"].config
    qp = tq.load_quantized(fam["path"], cfg, device="cpu")
    assert_same_leaves(port_leaves(qp), jax_leaves(fam["jqp"]))
    path = str(tmp_path / "port.npz")
    tq.save_quantized(path, qp, cfg)
    back = jq.load_quantized(path, fam["jm"].config)
    assert isinstance(back, jqr.QuantizedResnetParams)
    assert_same_leaves(jax_leaves(back), jax_leaves(fam["jqp"]))
    for a, b in zip(jax_region(back, fam["y"], fam["jm"].config),
                    fam["raw_j"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    own = tq.quantize_model(fam["model"], BATCHES)
    tq.save_quantized(path, own, cfg)
    assert_same_leaves(jax_leaves(jq.load_quantized(path, fam["jm"].config)),
                       port_leaves(own))


def test_fakequant_gates_off_is_float_and_on_is_int8(retina):
    model, cfg = retina["model"], retina["model"].config
    x = torch.from_numpy(BATCHES[0])
    with torch.no_grad():
        folded = (tqr._fold_only(model.backbone),
                  tqr._fold_fpn_float(model.fpn),
                  tqr._fold_head_float(model.head, "retinanet"))
        ranges = tqr.calibrate(model, BATCHES, _folded=folded)
        scales = {k: np.float32(max(abs(lo), abs(hi)) / 127.0 + 1e-12)
                  for k, (lo, hi) in ranges.items()}
        y = tqr._prologue(model.backbone, x, torch.float32)

        def run(g):
            be = tqr._FakeQuantBE(torch.float32, scales,
                                  {k: g for k in scales})
            trees = [tq.blend_weight_tree(t, lambda p: g) for t in folded]
            return tqr._region(be, *trees, y, cfg=cfg)

        off = run(0.0)
        ref = tqr._region(tqr._CalibBE(torch.float32), *folded, y, cfg=cfg)
        for a, b in zip(off, ref):
            assert torch.equal(a, b)
        on = run(1.0)
        real = tqr.forward_raw(tq.quantize_model(model, BATCHES,
                                                 act_scheme="sym"), x,
                               cfg=cfg)
    cos, rel = close_heads([t.numpy() for t in on],
                           [t.numpy() for t in real])
    assert cos >= 0.99 and rel <= 0.15, (cos, rel)
    assert any(not torch.equal(a, b) for a, b in zip(on, off))


def test_scale_keys_lockstep(retina):
    qp = tq.load_quantized(retina["path"], device="cpu")
    assert sorted(qp.scales) == sorted(retina["jqp"].scales)
    for branch in ("cls", "box"):
        for li in range(5):
            for ci in range(3):
                assert qp.scales[f"{branch}/l{li}/c{ci}"].shape == (2,)
            assert f"{branch}/l{li}/c3" not in qp.scales
    for si, n in enumerate((3, 4, 6, 3)):
        assert qp.scales[f"stage{si}/scan"].shape == (n - 1, 3, 2)
        assert f"stage{si}/b0/add" in qp.scales


def test_r101_depth_from_the_stacked_leaves():
    """ResNet-101's 23-block stage 2 stacks 22 blocks' scales, read from
    the stacked leaves' length (the config carries no depth); no
    forward runs."""
    model = get_model("retinanet_r101", input_size=SIZE,
                      num_classes=NUM_CLASSES, compute_dtype=torch.float32)
    with torch.no_grad():
        qb = tqr._prep_backbone(tqr._fold_only(model.backbone))
    ranges = {f"stage{si}/b{bi}/{part}": (-1.0, float(bi))
              for si, n in enumerate((3, 4, 23, 3)) for bi in range(n)
              for part in ("c1", "c2", "add")}
    scales = tqr._stack_scales(ranges, qb, "asym", "cpu")
    assert qb["stage2"]["scan_stacked"]["c1"]["wq"].shape[0] == 22
    for si, n in enumerate((3, 4, 23, 3)):
        assert scales[f"stage{si}/scan"].shape == (n - 1, 3, 2)
    np.testing.assert_array_equal(scales["stage2/scan"][21, 2].numpy(),
                                  tq._sm_of(-1.0, 22.0, "asym"))
    assert sorted(k for k in scales if "/b0/" in k) == sorted(
        f"stage{si}/b0/{p}" for si in range(4) for p in ("c1", "c2", "add"))


def test_detectors_match_jax(retina, fcos):
    imgs = [np.random.RandomState(s).randint(0, 256, (90, 70, 3), np.uint8)
            for s in (4, 5, 6)]
    for f in (retina, fcos):
        name = f["name"]
        kw = dict(input_size=SIZE, num_classes=NUM_CLASSES)
        jd = JDetector(name, params=f["params"], quantized=f["path"],
                       compute_dtype=jnp.float32, use_pallas=False, **kw)
        want = jd.detect_batch(imgs, conf_thres=CONF)
        for det in (Detector(name, params=f["flat"], quantized=True,
                             device="cpu", compute_dtype=torch.float32, **kw),
                    Detector(name, quantized=f["path"], device="cpu",
                             compute_dtype=torch.float32, **kw)):
            got = det.detect_batch(imgs, conf_thres=CONF)
            n = sum(matched(g, w) for g, w in zip(got, want))
            total = sum(max(len(g), len(w)) for g, w in zip(got, want))
            assert total == 300 and n / total >= MATCHED_GATE[name], \
                (name, n, total)
